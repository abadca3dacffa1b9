"""The one traffic generator: reads a mix's parameters from
traffic/<name>.json and drives the program with it from the seed.

Two kinds of mix:

- ``layered``: a circuit of ``batch`` gates a layer, one batched gate call a
  layer (the gate drawn per layer from ``gates``), whose two inputs are two
  seeded permutations of the previous layer's outputs; the first layer
  takes fresh encryptions made in set-up. Closed loop, one client, no host
  synchronise between layers except that the host runs at most
  ``lookahead`` layers ahead of the device. Of every layer
  ``checked_per_layer`` gates, drawn from the seed, are kept (inputs and
  output) for the comparison; the plaintext of every gate is tracked too.
- ``circuit``: a closed loop of one client sending one ``circuit``
  (``less_than``) at a time on ``batch`` pairs of ``width``-bit words of at
  most ``operand_bits`` bits, drawn from the seed and encrypted in set-up
  (a pool of ``pool`` requests, used in turn); a request ends when its
  result word is on the host.

Every seed gets the same sizes and the same amount of work per unit; the
seed changes the keys, the plaintexts, the gate order and the
permutations.
"""

from __future__ import annotations

import collections
import json
import os
import time

import numpy as np
import torch

from . import keys as K

OPS = {"and": np.logical_and, "or": np.logical_or, "xor": np.logical_xor,
       "nand": lambda x, y: ~np.logical_and(x, y)}
POOL = 16  # seeded permutations (and check samples) a layer draws from


def load(root: str, name: str) -> dict:
    with open(os.path.join(root, "perfbench", "traffic", f"{name}.json")) as fh:
        mix = json.load(fh)
    if mix.get("kind") not in KINDS:
        raise ValueError(f"traffic {name}: kind {mix.get('kind')!r} is none of {sorted(KINDS)}")
    return mix


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Layered:
    """A layered circuit of one batched gate call a layer."""

    def __init__(self, mix: dict, cfg: dict, keys, prog, rng: np.random.Generator,
                 gen: torch.Generator, device):
        self.mix, self.prog, self.rng, self.device = mix, prog, rng, device
        B, G = mix["batch"], mix["checked_per_layer"]
        self.gates = list(mix["gates"])
        self.perms = torch.stack([torch.randperm(B, generator=gen, device=device)
                                  for _ in range(POOL)])
        self.picks = torch.stack([torch.randperm(B, generator=gen, device=device)[:G]
                                  for _ in range(POOL)])
        self.bits0 = rng.integers(0, 2, B).astype(bool)
        a, b = K.encrypt(gen, keys, torch.from_numpy(self.bits0).to(device),
                         cfg["params"]["lwe_noise_stddev"])
        self.x0 = prog.wrap(a, b)

    def _draw(self) -> tuple:
        """(gate, first permutation, second permutation, checked rows) of the
        next layer, drawn from the seed."""
        g, p1, p2, s = self.rng.integers(0, [len(self.gates), POOL, POOL, POOL])
        return self.gates[g], int(p1), int(p2), int(s)

    def _layer(self, prev, plan, record):
        kind, p1, p2, s = plan
        take = lambda w, i: type(w)(w.a.index_select(0, self.perms[i]),
                                    w.b.index_select(0, self.perms[i]))
        x, y = take(prev, p1), take(prev, p2)
        out = self.prog.gate(kind, x, y)
        if record is not None:
            rows = self.picks[s]
            record.append(tuple(t.index_select(0, rows) for t in (x.a, x.b, y.a, y.b, out.a, out.b)))
        return out

    def warmup(self) -> None:
        """Every gate of the mix once at the layer's shape, the recording
        included."""
        for kind in self.gates:
            self._layer(self.x0, (kind, 0, 1, 0), [])
        sync(self.device)

    def window(self, seconds: float) -> dict:
        plans, record, pending = [], [], collections.deque()
        cur = self.x0
        t0 = time.perf_counter()
        while True:
            plans.append(self._draw())
            cur = self._layer(cur, plans[-1], record)
            if self.device.type == "cuda":
                ev = torch.cuda.Event()
                ev.record()
                pending.append(ev)
                if len(pending) > self.mix["lookahead"]:
                    pending.popleft().synchronize()
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        window_s = time.perf_counter() - t0
        self.plans, self.record, self.last = plans, record, cur
        return {"window_s": window_s, "units": len(plans), "gates": len(plans) * self.mix["batch"]}

    def check(self, ref, keys, judged=None) -> dict:
        """Every kept gate against the reference ``ref``, word for word, from
        its own input words; the last layer's decryptions against the
        plaintext circuit replayed from the seed. ``judged``: a reference put
        in the program's place (the control), whose outputs on the same
        input words are compared instead of the program's."""
        perms, picks = self.perms.cpu().numpy(), self.picks.cpu().numpy()
        bits = self.bits0
        for kind, p1, p2, _ in self.plans:
            bits = OPS[kind](bits[perms[p1]], bits[perms[p2]])
        got = K.decrypt(keys, self.last.a.to(torch.int64), self.last.b.to(torch.int64))
        bits_wrong = int((got.cpu().numpy() != bits).sum())
        kinds = [kind for kind, *_ in self.plans for _ in range(picks.shape[1])]
        cols = [torch.cat([r[i] for r in self.record]).to(torch.int64) for i in range(6)]
        oa, ob = judged.gates(kinds, *cols[:4]) if judged else cols[4:]
        ra, rb = ref.gates(kinds, *cols[:4])
        differ = (ra != oa).reshape(len(kinds), -1).sum(-1) + (rb != ob)
        wrong = int((differ > 0).sum())
        return {"gates_compared": len(kinds), "words_compared": int(ra.numel() + rb.numel()),
                "words_differing": int(differ.sum()), "units_wrong": wrong,
                "bits_checked": int(bits.size), "bits_wrong": bits_wrong,
                "failed": wrong + bits_wrong}


class Circuit:
    """A closed loop of one client sending one circuit at a time."""

    def __init__(self, mix: dict, cfg: dict, keys, prog, rng: np.random.Generator,
                 gen: torch.Generator, device):
        if mix["circuit"] != "less_than":
            raise ValueError(f"circuit {mix['circuit']!r}: this generator sends less_than")
        self.mix, self.prog, self.device = mix, prog, device
        W, B, pool = mix["width"], mix["batch"], mix["pool"]
        self.values = rng.integers(0, 1 << mix["operand_bits"], (2, pool, B))
        bits = (self.values[..., None] >> np.arange(W)) & 1  # (2, pool, B, W)
        bits = torch.from_numpy(np.moveaxis(bits, -1, 1) == 1).to(device)  # (2, W, pool, B)
        a, b = K.encrypt(gen, keys, bits, cfg["params"]["lwe_noise_stddev"])
        self.words = [[prog.wrap(a[o, :, r], b[o, :, r]) for r in range(pool)] for o in range(2)]

    def _request(self, r: int):
        out = self.prog.less_than(self.words[0][r], self.words[1][r], self.mix["width"])
        return out.a.cpu(), out.b.cpu()

    def warmup(self) -> None:
        self._request(0)

    def window(self, seconds: float) -> dict:
        pool = self.mix["pool"]
        lat, outs = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            t = time.perf_counter()
            outs.append(self._request(len(outs) % pool))
            lat.append(time.perf_counter() - t)
        window_s = time.perf_counter() - t0
        self.outs = outs
        return {"window_s": window_s, "units": len(outs), "latencies_s": lat,
                "gates": 0}

    def check(self, ref, keys, judged=None) -> dict:
        """Every request's result word against the reference ``ref``'s
        circuit from the same operand words, and its decryption against
        a < b. ``judged``: a reference put in the program's place (the
        control), whose circuit outputs are compared instead."""
        pool, n, B = self.mix["pool"], len(self.outs), self.mix["batch"]
        reqs = [r % pool for r in range(n)]
        firsts = sorted(set(reqs))  # each pooled request is worked out once
        at = {r: i for i, r in enumerate(firsts)}

        def circuit(side):
            words = [(torch.stack([self.words[o][r].a for r in firsts], 1).flatten(1, 2),
                      torch.stack([self.words[o][r].b for r in firsts], 1).flatten(1, 2))
                     for o in range(2)]
            words = [(a.to(torch.int64), b.to(torch.int64)) for a, b in words]
            a, b = side.less_than(words[0], words[1], self.mix["width"])
            return a.reshape((len(firsts), B) + a.shape[1:]), b.reshape(len(firsts), B)

        ra, rb = circuit(ref)
        idx = torch.tensor([at[r] for r in reqs], device=ra.device)
        ra, rb = ra[idx], rb[idx]
        if judged:
            oa, ob = (t[idx] for t in circuit(judged))
        else:
            oa = torch.stack([o[0] for o in self.outs]).to(ra.device, torch.int64)
            ob = torch.stack([o[1] for o in self.outs]).to(rb.device, torch.int64)
        differ = (oa != ra).reshape(n, -1).sum(-1) + (ob != rb).reshape(n, -1).sum(-1)
        want = torch.from_numpy(self.values[0, reqs] < self.values[1, reqs]).to(ra.device)
        wrong = (K.decrypt(keys, oa, ob) != want).reshape(n, -1).sum(-1)
        return {"gates_compared": n * B, "words_compared": int(ra.numel() + rb.numel()),
                "words_differing": int(differ.sum()), "units_wrong": int((differ > 0).sum()),
                "bits_checked": n * B, "bits_wrong": int(wrong.sum()),
                "failed": int(((differ > 0) | (wrong > 0)).sum())}


KINDS = {"layered": Layered, "circuit": Circuit}


def make(mix: dict, cfg: dict, keys, prog, rng, gen, device):
    return KINDS[mix["kind"]](mix, cfg, keys, prog, rng, gen, device)

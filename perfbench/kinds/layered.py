"""``layered``: a circuit of ``batch`` gates a layer, one batched gate call a
layer (the gate drawn per layer from ``gates``), whose two inputs are two
seeded permutations of the previous layer's outputs; the first layer takes
fresh encryptions made in set-up. Closed loop, one client, no host
synchronise between layers except that the host runs at most ``lookahead``
layers ahead of the device. Of every layer ``checked_per_layer`` gates,
drawn from the seed, are kept (inputs and output) for the comparison; the
plaintext of every gate is tracked too.

No gate takes one ciphertext twice: the POOL permutations a layer draws two
of are order[(spread[i] + shift_k) % batch] with distinct shifts, so two of
them differ at every index, and a layer's second draw is never its first.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from .. import keys as K
from ..traffic import sync

OPS = {"and": np.logical_and, "or": np.logical_or, "xor": np.logical_xor,
       "nand": lambda x, y: ~np.logical_and(x, y)}
POOL = 16  # seeded permutations (and check samples) a layer draws from


class Layered:
    """A layered circuit of one batched gate call a layer."""

    def __init__(self, mix: dict, cfg: dict, keys, prog, rng: np.random.Generator,
                 gen: torch.Generator, device):
        self.mix, self.prog, self.rng, self.device = mix, prog, rng, device
        B, G = mix["batch"], mix["checked_per_layer"]
        if B < POOL:
            raise ValueError(f"a layered mix needs a batch of at least {POOL} gates, not {B}")
        self.gates = list(mix["gates"])
        order, spread = (torch.randperm(B, generator=gen, device=device) for _ in range(2))
        shifts = torch.randperm(B, generator=gen, device=device)[:POOL]
        self.perms = order[(spread[None, :] + shifts[:, None]) % B]
        self.picks = torch.stack([torch.randperm(B, generator=gen, device=device)[:G]
                                  for _ in range(POOL)])
        self.bits0 = rng.integers(0, 2, B).astype(bool)
        a, b = K.encrypt(gen, keys, torch.from_numpy(self.bits0).to(device),
                         cfg["params"]["lwe_noise_stddev"])
        self.x0 = prog.wrap(a, b)

    def _draw(self) -> tuple:
        """(gate, first permutation, second permutation, checked rows) of the
        next layer, drawn from the seed; the second is one of the POOL - 1
        others."""
        g, p1, r, s = self.rng.integers(0, [len(self.gates), POOL, POOL - 1, POOL])
        return self.gates[g], int(p1), int((p1 + 1 + r) % POOL), int(s)

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


Traffic = Layered

"""``circuit``: a closed loop of one client sending one ``circuit``
(perfbench/circuits/<circuit>.py on the reference's side, the program's own
function of that name on the program's) at a time on ``batch`` circuits of
``width``-bit words. The circuit file draws the operands of a pool of
``pool`` requests from the seed; they are encrypted in set-up and used in
turn. A request ends when its result is on the host."""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import keys as K
from ..reference import CIRCUITS


class Circuit:
    """A closed loop of one client sending one circuit at a time."""

    def __init__(self, mix: dict, cfg: dict, keys, prog, rng: np.random.Generator,
                 gen: torch.Generator, device):
        self.mix, self.prog, self.device = mix, prog, device
        self.spec = CIRCUITS[mix["circuit"]]
        prog.circuit(mix["circuit"])  # the program has it, or set-up fails here
        pool = mix["pool"]
        self.values, groups = self.spec.draw(rng, mix)
        self.operands = [[] for _ in range(pool)]  # a request's words and bits, in order
        for bits in groups:
            a, b = K.encrypt(gen, keys, torch.from_numpy(bits).to(device),
                             cfg["params"]["lwe_noise_stddev"])
            axis = bits.ndim - 3  # the pool axis of one operand
            for o in range(bits.shape[0]):
                for r in range(pool):
                    self.operands[r].append(prog.wrap(a[o].select(axis, r), b[o].select(axis, r)))

    def _request(self, r: int):
        out = self.prog.circuit(self.mix["circuit"])(*self.operands[r], self.mix["width"])
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
        """Every request's result words against the reference ``ref``'s
        circuit from the same operand words, and their decryptions against
        the circuit file's plaintext result. ``judged``: a reference put in
        the program's place (the control), whose circuit outputs are
        compared instead."""
        pool, n, B = self.mix["pool"], len(self.outs), self.mix["batch"]
        reqs = [r % pool for r in range(n)]
        firsts = sorted(set(reqs))  # each pooled request is worked out once
        at = {r: i for i, r in enumerate(firsts)}

        def circuit(side):
            """(a, b) of the ``firsts`` requests: (requests, bits, B, ...)."""
            words = []
            for o in range(len(self.operands[0])):
                got = [self.operands[r][o] for r in firsts]
                d = got[0].b.dim() - 1  # the batch axis, after a word's bit axis
                words.append(tuple(torch.stack([getattr(w, f) for w in got], d).flatten(d, d + 1)
                                   .to(torch.int64) for f in ("a", "b")))
            a, b = side.circuit(self.mix["circuit"])(*words, self.mix["width"])
            lead = (-1, len(firsts), B)
            return (a.reshape(lead + a.shape[b.dim():]).transpose(0, 1),
                    b.reshape(lead).transpose(0, 1))

        ra, rb = circuit(ref)
        idx = torch.tensor([at[r] for r in reqs], device=ra.device)
        ra, rb = ra[idx], rb[idx]
        if judged:
            oa, ob = (t[idx] for t in circuit(judged))
        else:
            oa = torch.stack([o[0].reshape(ra.shape[1:]) for o in self.outs]).to(ra.device,
                                                                                 torch.int64)
            ob = torch.stack([o[1].reshape(rb.shape[1:]) for o in self.outs]).to(rb.device,
                                                                                 torch.int64)
        differ = (oa != ra).reshape(n, -1).sum(-1) + (ob != rb).reshape(n, -1).sum(-1)
        want = torch.from_numpy(self.spec.want(self.values, self.mix)[reqs]).to(ra.device)
        wrong = (K.decrypt(keys, oa, ob) != want).reshape(n, -1).sum(-1)
        return {"gates_compared": n * B, "words_compared": int(ra.numel() + rb.numel()),
                "words_differing": int(differ.sum()), "units_wrong": int((differ > 0).sum()),
                "bits_checked": int(want.numel()), "bits_wrong": int(wrong.sum()),
                "failed": int(((differ > 0) | (wrong > 0)).sum())}


Traffic = Circuit

"""The 3rd-gen multikey scheme (``scheme`` "3gen"): the AKO multikey TFHE
of the 3-gen-mk-tfhe reference, on the 64-bit ring torus, at the sets whose
digits allow the hi-word key (l lb <= 31, lb <= 8).

Key material: the AKO pipeline. The gate bootstrap: the 64-bit key rounded
to its high word (``hi_round``), then the 32-bit chain over parties * n
steps, party major, extract, and every party's keyswitch table applied to
the one mask. A set of wider digits needs the exact 64-bit chain, another
scheme's file.
"""

from __future__ import annotations

import torch

from ..keys import Keys, binary, gaussian, keyswitch_table, negacyclic_product, uniform
from ..reference import MU, Gates, blind_rotate, extract, keyswitch_deltas, mod_switch, wrap32

NEGATIVE_BINARY_WEIGHT = 0.113546097609674  # P(-1) = P(+1) of the 3gen ring keys


def negative_binary(gen: torch.Generator, shape) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=gen, device=gen.device, dtype=torch.float64)
    w = NEGATIVE_BINARY_WEIGHT
    return (u >= 1.0 - w).to(torch.int64) - (u < w).to(torch.int64)


def hi_round(x64: torch.Tensor) -> torch.Tensor:
    """A 64-bit torus word rounded to the nearest multiple of 2^32, as its
    high 32-bit word (signed, in int64)."""
    return (x64 + (1 << 31)) >> 32


def make_keys(gen: torch.Generator, cfg: dict) -> Keys:
    """The AKO pipeline on the 64-bit ring torus: a common random polynomial
    a (one, repeated for the l levels), each party's public key b_p = s_p *
    a + e, the common key b = sum_p b_p, and per key bit m of each party the
    uni-encryption rows (level i): part1 = r1*b + e + m g_i, part2 = r2*b +
    e, part3 = r2*a + e + m g_i, part4 = r1*a + e, with r1, r2 ternary, laid
    out as TGSW samples [i, 0, 0] = part3, [i, 0, 1] = part2, [i, 1, 0] =
    part4, [i, 1, 1] = part1. Each party's keyswitch table goes from its
    extracted ring key to its LWE key."""
    p, parties = cfg["params"], cfg["parties"]
    n, N, l, lb = p["lwe_size"], p["rlwe_polynomial_degree"], p["gsw_decomp_length"], \
        p["gsw_log2_base"]
    sigma = p["gsw_noise_stddev"]
    if p["rlwe_mask_size"] != 1 or p["rlwe_bits"] != 64:
        raise ValueError("the 3gen reference takes k = 1 on the 64-bit ring torus")
    s_lwe = binary(gen, (parties, n))
    s_rlwe = negative_binary(gen, (parties, N))
    a = uniform(gen, (N,), 64)
    b = sum(negacyclic_product(s_rlwe[q].expand(l, N), a, 64) + gaussian(gen, sigma, (l, N), 64)
            for q in range(parties))  # (l, N)
    M = parties * n
    r1, r2 = negative_binary(gen, (M, l, N)), negative_binary(gen, (M, l, N))
    errs = gaussian(gen, sigma, (4, M, l, N), 64)
    bk = torch.empty((M, l, 2, 2, N), dtype=torch.int64, device=a.device)
    for i in range(l):
        bump = s_lwe.reshape(-1) * (1 << (64 - (i + 1) * lb))
        bk[:, i, 1, 1] = negacyclic_product(r1[:, i], b[i], 64) + errs[0, :, i]
        bk[:, i, 0, 1] = negacyclic_product(r2[:, i], b[i], 64) + errs[1, :, i]
        bk[:, i, 0, 0] = negacyclic_product(r2[:, i], a, 64) + errs[2, :, i]
        bk[:, i, 1, 0] = negacyclic_product(r1[:, i], a, 64) + errs[3, :, i]
        bk[:, i, 1, 1, 0] += bump
        bk[:, i, 0, 0, 0] += bump
    ks = torch.cat([keyswitch_table(gen, s_rlwe[q], s_lwe[q], p["ks_decomp_length"],
                                    p["ks_log2_base"], p["ks_noise_stddev"])
                    for q in range(parties)], dim=-1)
    return Keys(s_lwe, s_rlwe[:, None], bk, ks)


class Reference(Gates):
    """The plain multikey gate bootstrap over the hi-word key: a (S,
    parties, n), b (S,) in, the switched sample a (S, parties, n), b (S,)
    out."""

    def __init__(self, cfg: dict, keys: Keys, digits_dropped: int = 0):
        p = cfg["params"]
        self.parties, self.N, self.n = cfg["parties"], p["rlwe_polynomial_degree"], p["lwe_size"]
        self.l, self.lb = p["gsw_decomp_length"], p["gsw_log2_base"]
        if self.l * self.lb > 31 or self.lb > 8:
            raise ValueError(f"l={self.l}, lb={self.lb}: the hi-word reference takes l lb <= 31 "
                             "and lb <= 8")
        self.t, self.ks_lb = p["ks_decomp_length"], p["ks_log2_base"]
        self.key = hi_round(keys.bk)
        self.table = keys.ks.reshape(-1, keys.ks.shape[-1]).to(torch.float64)
        self.digits_dropped = digits_dropped

    def _bootstrap(self, a, b):
        S = b.shape[0]
        acc = blind_rotate(mod_switch(a.reshape(S, -1), self.N), mod_switch(b, self.N), MU,
                           self.key, self.l, self.lb, self.digits_dropped)
        ea, eb = extract(acc)
        deltas = keyswitch_deltas(ea, self.table, self.t, self.ks_lb)
        deltas = deltas.reshape(S, self.parties, self.n + 1)
        return wrap32(-deltas[..., :self.n]), wrap32(eb - deltas[..., self.n].sum(-1))

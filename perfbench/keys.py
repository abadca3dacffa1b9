"""The inputs that the benchmark makes from the seed and hands to both the
program and the reference: key material and fresh encryptions.

Made on the tensors' device (the card in a run) from one torch.Generator,
in a few large calls, as the TFHE library and the 3-gen-mk-tfhe reference
define them. The key material is raw: TGSW samples as torus words, the
keyswitch table as LWE samples. The program builds its own key forms from
it (program.py); the reference reads it as it is (reference.py). Plain
PyTorch, nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .reference import negacyclic_matrix, wrap32

NEGATIVE_BINARY_WEIGHT = 0.113546097609674  # P(-1) = P(+1) of the 3gen ring keys


class Keys(NamedTuple):
    """lwe: (parties, n) bits; rlwe: (parties, k, N) key polynomials;
    bk: (steps, l, C, C, N) TGSW samples (32-bit words; 64-bit at 3gen),
    steps = parties * n, party major; ks: (n_in, t, 2^lb - 1, cols) LWE
    samples (32-bit words), cols = parties * (n + 1), party major."""

    lwe: torch.Tensor
    rlwe: torch.Tensor
    bk: torch.Tensor
    ks: torch.Tensor


def uniform(gen: torch.Generator, shape, bits: int = 32) -> torch.Tensor:
    dev = gen.device
    lo = torch.randint(-2**31, 2**31, tuple(shape), generator=gen, device=dev, dtype=torch.int64)
    if bits == 32:
        return lo
    hi = torch.randint(-2**31, 2**31, tuple(shape), generator=gen, device=dev, dtype=torch.int64)
    return (hi << 32) | (lo & 0xFFFFFFFF)


def gaussian(gen: torch.Generator, sigma: float, shape, bits: int = 32) -> torch.Tensor:
    """Torus noise of standard deviation ``sigma`` (a fraction of the torus)."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float64)
    return torch.round(x * (sigma * 2.0 ** bits)).to(torch.int64)


def binary(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randint(0, 2, tuple(shape), generator=gen, device=gen.device, dtype=torch.int64)


def negative_binary(gen: torch.Generator, shape) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=gen, device=gen.device, dtype=torch.float64)
    w = NEGATIVE_BINARY_WEIGHT
    return (u >= 1.0 - w).to(torch.int64) - (u < w).to(torch.int64)


def negacyclic_product(r: torch.Tensor, k: torch.Tensor, bits: int = 32) -> torch.Tensor:
    """r (..., N) small integers (key or ternary) times k (N,) torus words,
    negacyclic, exact mod 2^bits. A 64-bit k goes in two 32-bit halves."""
    if bits == 32:
        return wrap32(torch.round(r.to(torch.float64) @ negacyclic_matrix(k)).to(torch.int64))
    lo, hi = k & 0xFFFFFFFF, k >> 32
    plo = torch.round(r.to(torch.float64) @ negacyclic_matrix(lo)).to(torch.int64)
    phi = torch.round(r.to(torch.float64) @ negacyclic_matrix(hi)).to(torch.int64)
    return (phi << 32) + plo


def keyswitch_table(gen: torch.Generator, s_in: torch.Tensor, s_out: torch.Tensor,
                    t: int, lb: int, sigma: float) -> torch.Tensor:
    """ks[i, j, h] = LWE_{s_out}((s_in[i] * h) * 2^(32 - (j+1) lb)): (n_in,
    t, 2^lb - 1, n_out + 1) 32-bit words."""
    n_in, n_out, base = s_in.shape[0], s_out.shape[0], 1 << lb
    a = uniform(gen, (n_in, t, base - 1, n_out))
    h = torch.arange(1, base, device=s_in.device)
    shift = 32 - lb * torch.arange(1, t + 1, device=s_in.device)
    msg = (s_in[:, None, None] * h[None, None, :]) << shift[None, :, None]
    dot = torch.round(a.to(torch.float64) @ s_out.to(torch.float64)).to(torch.int64)
    b = wrap32(msg + gaussian(gen, sigma, a.shape[:-1]) + dot)
    return torch.cat([a, b[..., None]], dim=-1)


def single_keys(gen: torch.Generator, p: dict) -> Keys:
    """A single-key set (configs ``scheme`` "single"): TGSW encryptions of the
    LWE key bits under the RLWE key (rows (level, polynomial): a zero
    encryption with bit * 2^(32 - (level+1) lb) on polynomial j, coefficient
    0), and the keyswitch table from the extracted RLWE key to the LWE key."""
    n, N, k = p["lwe_size"], p["rlwe_polynomial_degree"], p["rlwe_mask_size"]
    l, lb, C = p["bs_decomp_length"], p["bs_log2_base"], k + 1
    if p.get("bk_drop_limbs", 0) or p["rlwe_bits"] != 32:
        raise ValueError("the single-key reference takes a 32-bit set with no rounded body")
    s_lwe, s_rlwe = binary(gen, (n,)), binary(gen, (k, N))
    mask = uniform(gen, (n, l, C, k, N))
    body = gaussian(gen, p["bs_noise_stddev"], (n, l, C, N))
    for j in range(k):
        body = body + negacyclic_product(mask[:, :, :, j], s_rlwe[j])
    bk = torch.cat([mask, wrap32(body)[:, :, :, None]], dim=3)  # (n, l, C, C, N)
    gadget = 1 << (32 - lb * torch.arange(1, l + 1, device=s_lwe.device))
    for j in range(C):
        bk[:, :, j, j, 0] += s_lwe[:, None] * gadget
    ks = keyswitch_table(gen, s_rlwe.reshape(-1), s_lwe, p["ks_decomp_length"],
                         p["ks_log2_base"], p["ks_noise_stddev"])
    return Keys(s_lwe[None], s_rlwe[None], wrap32(bk), ks)


def mk3gen_keys(gen: torch.Generator, p: dict, parties: int) -> Keys:
    """A 3rd-gen multikey set (``scheme`` "3gen"), the AKO pipeline on the
    64-bit ring torus: a common random polynomial a (one, repeated for the l
    levels), each party's public key b_p = s_p * a + e, the common key
    b = sum_p b_p, and per key bit m of each party the uni-encryption rows
    (level i): part1 = r1*b + e + m g_i, part2 = r2*b + e, part3 = r2*a + e +
    m g_i, part4 = r1*a + e, with r1, r2 ternary, laid out as TGSW samples
    [i, 0, 0] = part3, [i, 0, 1] = part2, [i, 1, 0] = part4, [i, 1, 1] = part1.
    Each party's keyswitch table goes from its extracted ring key to its LWE
    key."""
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


def make_keys(gen: torch.Generator, cfg: dict) -> Keys:
    if cfg["scheme"] == "single":
        return single_keys(gen, cfg["params"])
    if cfg["scheme"] == "3gen":
        return mk3gen_keys(gen, cfg["params"], cfg["parties"])
    raise ValueError(f"no key material for scheme {cfg['scheme']!r}")


def encrypt(gen: torch.Generator, keys: Keys, bits: torch.Tensor, sigma: float) -> tuple:
    """Fresh encryptions of booleans as +-1/8 under the LWE key(s): a
    (..., n) for one party, (..., parties, n) for several; b (...)."""
    parties, n = keys.lwe.shape
    shape = tuple(bits.shape) + ((n,) if parties == 1 else (parties, n))
    a = uniform(gen, shape)
    s = keys.lwe[0] if parties == 1 else keys.lwe
    dot = (a * s).reshape(bits.shape + (-1,)).sum(-1)
    mu = torch.where(bits.to(a.device), 1 << 29, -(1 << 29))
    return wrap32(a), wrap32(mu + gaussian(gen, sigma, bits.shape) + dot)


def phase(keys: Keys, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    parties, n = keys.lwe.shape
    s = keys.lwe[0] if parties == 1 else keys.lwe
    a = a.to(torch.int64)
    return wrap32(b.to(torch.int64) - (a * s).reshape(b.shape + (-1,)).sum(-1))


def decrypt(keys: Keys, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return phase(keys, a, b) > 0

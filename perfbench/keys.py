"""The inputs that the benchmark makes from the seed and hands to both the
program and the reference: key material and fresh encryptions.

Made on the tensors' device (the card in a run) from one torch.Generator,
in a few large calls. The key material is raw (TGSW samples as torus words,
the keyswitch table as LWE samples), made as its scheme defines it by
``make_keys`` of perfbench/schemes/<scheme>.py, which ``make_keys`` here
finds by the configuration's ``scheme``; the samplers below are what the
schemes share. The program builds its own key forms from the material
(perfbench/drive/<scheme>.py); the reference reads it as it is. Plain
PyTorch, nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .reference import SCHEMES, negacyclic_matrix, wrap32


class Keys(NamedTuple):
    """lwe: (parties, n) bits; rlwe: (parties, k, N) key polynomials;
    bk: (steps, l, C, C, N) TGSW samples (32-bit or 64-bit words, as the
    scheme has them), steps = parties * n, party major; ks: (n_in, t, 2^lb - 1, cols) LWE
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


def make_keys(gen: torch.Generator, cfg: dict) -> Keys:
    """The raw key material of a configuration, as its scheme
    (perfbench/schemes/<scheme>.py) makes it from ``gen``."""
    return SCHEMES[cfg["scheme"]].make_keys(gen, cfg)


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

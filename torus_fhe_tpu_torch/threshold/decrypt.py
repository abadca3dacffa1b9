"""Threshold (partial + final) decryption of ring-LWE ciphertexts.

Port of torus_fhe_tpu/threshold/decrypt.py. Each of the t parties computes
partial_i = Σ_j share_i[j] ⊛ a[j] + smudging_i; the combiner recovers
phase = b − partial_1 + partial_2 + ... + partial_t and decodes message bits
from the first coefficients (MSIZE = 2). Up to N = 4096, and on the 64-bit
torus, the products are exact negacyclic integer products wrapping mod
2^bits; above, the limb f64 FFT product (ops/poly.negacyclic_polymul_fft64, as the reference's own
partial decryption is an f64 FFT), whose rounding error lies orders below
every smudging sd.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core import rng
from ..core.torus import mod_switch_from_torus
from ..ops import poly
from ..rlwe import RLweSample
from .shares import ShareSet

MAX_EXACT_N = 4096  # the largest ring the schoolbook product serves


def party_products(shares: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Σ_j shares[i, j] ⊛ a[j] for each party i: shares (t, k, N) ints,
    a (k, N) torus. Returns (t, N) in a's dtype: exact up to N = 4096 and on
    the 64-bit torus, the limb FFT product (32-bit only) above."""
    if a.shape[-1] <= MAX_EXACT_N or a.dtype == torch.int64:
        prods = poly.negacyclic_polymul_ref(shares.to(torch.int64), a)
    else:
        prods = poly.negacyclic_polymul_fft64(shares, a.expand(shares.shape[:1] + a.shape))
    return torch.sum(prods, dim=-2, dtype=a.dtype)


def partial_decrypt(sample: RLweSample, shares, sd: float,
                    generator: torch.Generator) -> torch.Tensor:
    """Per-party partial decryptions with smudging noise of stddev ``sd``.

    sample.a: (k+1, N); shares: (t, k, N). Returns (t, N) torus."""
    a = sample.a[..., :-1, :]
    shares = torch.as_tensor(shares, device=a.device)
    partial = party_products(shares, a)
    return partial + rng.gaussian_torus(generator, 0, sd, tuple(partial.shape), a.dtype,
                                        device=a.device)


def final_decrypt(sample: RLweSample, partials: torch.Tensor) -> torch.Tensor:
    """b − p_1 + p_2 + ... + p_t: the plaintext polynomial."""
    b = sample.a[..., -1, :]
    signs = torch.ones(partials.shape[0], dtype=partials.dtype, device=partials.device)
    signs[0] = -1
    return b + torch.sum(signs[:, None] * partials, dim=0, dtype=partials.dtype)


def threshold_decrypt(sample: RLweSample, repo: ShareSet, parties: Sequence[int],
                      sd: float, generator: torch.Generator) -> torch.Tensor:
    """One-shot t-of-p threshold decryption: partials, then the combine."""
    partials = partial_decrypt(sample, repo.subset_shares(parties), sd, generator)
    return final_decrypt(sample, partials)


def decode_bits(plaintext_poly: torch.Tensor, n_bits: int = 32, msize: int = 2) -> int:
    """The integer in the first ``n_bits`` coefficients, bit i at X^i."""
    bits = mod_switch_from_torus(plaintext_poly[..., :n_bits], msize).cpu().numpy()
    weights = (1 << np.arange(n_bits)).astype(object)
    return int((bits.astype(object) * weights).sum(-1))


def encode_bits(value: int, N: int, n_bits: int = 32, msize: int = 2,
                dtype=torch.int32, device=None) -> torch.Tensor:
    """Bits 0..n_bits-1 of ``value`` at coefficients 0..n_bits-1 of an
    N-coefficient polynomial, each as bit·2^31 (half the 32-bit torus; the
    same word in an int64 polynomial, as the JAX package writes it)."""
    if msize != 2:
        raise ValueError(f"encode_bits writes msize 2, not {msize}")
    mu = np.zeros(N, np.int64)
    mu[:n_bits] = [((value >> i) & 1) << 31 for i in range(n_bits)]
    if dtype == torch.int32:
        mu = mu.astype(np.int32)
    return torch.from_numpy(mu).to(dtype=dtype, device=device)

"""Ring-LWE keys and samples over negacyclic polynomial rings.

Port of torus_fhe_tpu/rlwe.py. An RLWE sample is one tensor ``a`` of shape
(..., k+1, N): mask polynomials 0..k-1, body polynomial at index k.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .core import rng
from .core.params import RLweParams
from .core.torus import t64_to_t32
from .lwe import LweKey, LweSample
from .ops import hostmath, poly


class RLweKey(NamedTuple):
    key: torch.Tensor  # (k, N) int32 in {0, 1} (or {-1, 0, 1}: negative keys)
    bits: int  # torus width this key encrypts

    @property
    def mask_size(self) -> int:
        return self.key.shape[0]

    @property
    def polynomial_degree(self) -> int:
        return self.key.shape[-1]


class RLweSample(NamedTuple):
    a: torch.Tensor  # (..., k+1, N) torus; [..., :k, :] mask, [..., k, :] body

    def __add__(self, other):
        return RLweSample(self.a + other.a)

    def __sub__(self, other):
        return RLweSample(self.a - other.a)

    def __neg__(self):
        return RLweSample(-self.a)


def rlwe_keygen(generator: torch.Generator, params: RLweParams, negative: bool = False,
                device=None) -> RLweKey:
    """Uniform binary ring key, or with ``negative`` a ternary one
    (rng.negative_binary), as the 3gen multikey scheme uses."""
    sampler = rng.negative_binary if negative else rng.uniform_binary
    k = sampler(generator, (params.mask_size, params.polynomial_degree), device=device)
    return RLweKey(k, params.bits)


def extract_lwe_key(rlwe_key: RLweKey) -> LweKey:
    """Flatten the k ring-key polynomials into one LWE key of size k*N."""
    return LweKey(rlwe_key.key.reshape(-1).to(torch.int32))


def rlwe_encrypt_zero(generator: torch.Generator, alpha: float, rlwe_key: RLweKey,
                      params: RLweParams, shape=(), body_round_bits: int = 0,
                      device=None) -> RLweSample:
    """Homogeneous sample: mask uniform, body = sum_j s_j (*) a_j + noise.

    Keygen only: sampling on the generator's device, the exact polynomial
    products on the host (ops/hostmath). ``body_round_bits`` rounds the
    finished body to a multiple of 2^body_round_bits (extra body noise of
    stddev 2^body_round_bits/sqrt(12)); the F-block key then drops those
    zero low bytes of the body losslessly.
    """
    dtype = params.torus_dtype
    npdt = np.int32 if params.bits == 32 else np.int64
    shape = tuple(shape)
    k, N = params.mask_size, params.polynomial_degree
    a_mask = rng.uniform_torus(generator, shape + (k, N), dtype).cpu().numpy()
    noise = rng.gaussian_torus(generator, 0, alpha, shape + (N,), dtype).cpu().numpy()
    skey = rlwe_key.key.cpu().numpy()
    body = noise
    for j in range(k):
        body = body + hostmath.negacyclic_polymul_host(skey[j], a_mask[..., j, :], params.bits)
    if body_round_bits:
        with np.errstate(over="ignore"):
            body = ((body + npdt(1 << (body_round_bits - 1)))
                    >> body_round_bits) << body_round_bits
    out = np.concatenate([a_mask, body[..., None, :]], axis=-2)
    return RLweSample(torch.from_numpy(out).to(device))


def rlwe_encrypt(generator: torch.Generator, mu, alpha: float, rlwe_key: RLweKey,
                 params: RLweParams, shape=(), device=None) -> RLweSample:
    """Symmetric encryption of message polys ``mu`` (..., N): a zero
    encryption with mu added to the body (the threshold flow's sample)."""
    zero = rlwe_encrypt_zero(generator, alpha, rlwe_key, params, shape, device=device)
    shape = tuple(shape)
    mu = torch.as_tensor(mu, dtype=zero.a.dtype, device=zero.a.device)
    zero.a[..., -1, :] += mu.expand(shape + (params.polynomial_degree,))  # a fresh tensor
    return zero


def rlwe_noiseless_trivial(mu: torch.Tensor, params: RLweParams, shape=(),
                           device=None) -> RLweSample:
    """(0, ..., 0, mu). ``mu``: (..., N) torus polys."""
    shape = tuple(shape)
    dtype = params.torus_dtype
    N = params.polynomial_degree
    mu = torch.as_tensor(mu, dtype=dtype, device=device).expand(shape + (N,))
    zeros = torch.zeros(shape + (params.mask_size, N), dtype=dtype, device=mu.device)
    return RLweSample(torch.cat([zeros, mu[..., None, :]], dim=-2))


def rlwe_phase(sample: RLweSample, rlwe_key: RLweKey) -> torch.Tensor:
    """body - sum_j s_j (*) a_j, exact (small N: schoolbook oracle)."""
    k = rlwe_key.mask_size
    skey = rlwe_key.key.to(sample.a.dtype)
    acc = sample.a[..., k, :]
    for j in range(k):
        acc = acc - poly.negacyclic_polymul_ref(skey[j], sample.a[..., j, :])
    return acc


def rlwe_extract_sample(sample: RLweSample) -> LweSample:
    """Constant-coefficient LWE extraction.

    a_lwe[(j, i)] = reverse-polynomial coefficients of mask j
    [p0, -p_{N-1}, ..., -p_1]; b = body[0]. 64-bit samples are truncated to
    Torus32.
    """
    mask = sample.a[..., :-1, :]  # (..., k, N)
    body0 = sample.a[..., -1, 0]
    rev = torch.cat([mask[..., :1], -mask[..., 1:].flip(-1)], dim=-1)
    a = rev.reshape(rev.shape[:-2] + (-1,))
    if sample.a.dtype == torch.int64:
        return LweSample(t64_to_t32(a), t64_to_t32(body0))
    return LweSample(a, body0)


def mul_by_monomial(sample: RLweSample, shift) -> RLweSample:
    """All polys times X^shift; ``shift`` is an int or per-batch shifts."""
    return RLweSample(poly.mul_by_monomial(sample.a, shift))

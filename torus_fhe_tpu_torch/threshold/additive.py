"""Additive n-of-n key splitting with smudging: the TwoTwo / TlweTwoTwo / NN
experiments of the reference.

Port of torus_fhe_tpu/threshold/additive.py. The key is split as
s = s_1 + ... + s_p over the torus; party i publishes
partial_i = <a, s_i> + smudge_i, and the combiner decodes
b - sum_i partial_i. The party axis is a leading batch axis, so all partials
are one batched product; everything is exact wrapping integer arithmetic on
the sample's device, apart from the f64 FFT product of rings above N = 4096
(``ops/poly.negacyclic_polymul_fft64``), whose rounding error lies orders
below every smudging bound. Smudging draws from an explicit
``torch.Generator``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import rng
from ..lwe import LweKey, LweSample
from ..rlwe import RLweKey, RLweSample
from .decrypt import party_products


class AdditiveShares(NamedTuple):
    """p additive shares of a key: sum(shares, dim=0) == key (wrapping)."""

    shares: torch.Tensor  # (p, ...) torus ints


def split_additive(generator: torch.Generator, secret, parties: int,
                   dtype=torch.int32) -> AdditiveShares:
    """Split ``secret`` (small or torus ints, any shape) into ``parties``
    additive shares on its device: parties - 1 uniform torus shares and the
    wrapping remainder, so every proper subset is uniformly random."""
    secret = torch.as_tensor(secret).to(dtype)
    rand = rng.uniform_torus(generator, (parties - 1,) + tuple(secret.shape), dtype,
                             device=secret.device)
    last = secret - torch.sum(rand, dim=0, dtype=dtype)
    return AdditiveShares(torch.cat([rand, last[None]]))


def split_lwe_key(generator: torch.Generator, lwe_key: LweKey, parties: int) -> AdditiveShares:
    return split_additive(generator, lwe_key.key, parties)


def split_rlwe_key(generator: torch.Generator, rlwe_key: RLweKey,
                   parties: int) -> AdditiveShares:
    # the shares must sum to the key mod 2^bits of the torus the key
    # encrypts (rlwe_partial_decrypt multiplies mod 2^bits), not mod the
    # int32 of the key's storage
    dtype = torch.int32 if rlwe_key.bits == 32 else torch.int64
    return split_additive(generator, rlwe_key.key, parties, dtype)


def lwe_partial_decrypt(sample: LweSample, shares: AdditiveShares, bound: float,
                        generator: torch.Generator, sparse_coords: int | None = None):
    """Every party's partial <a, s_i> + smudge_i, smudging of stddev
    ``bound``. sample.a: (..., n); shares: (p, n). Returns (p, ...).

    An LWE partial is one torus scalar per ciphertext, so ``sparse_coords``
    = r smudges about r of the ciphertext batch (the last axis of sample.b)
    per party; an r above that axis's length is a ValueError (ring-coordinate
    sparsity is rlwe_partial_decrypt's).
    """
    dtype = sample.b.dtype
    s = torch.as_tensor(shares.shares, device=sample.a.device).to(dtype)
    p = s.shape[0]
    s = s.reshape((p,) + (1,) * (sample.a.ndim - 1) + s.shape[-1:])
    partial = torch.sum(sample.a.to(dtype) * s, dim=-1, dtype=dtype)  # (p, ...)
    shape = (p,) + tuple(sample.b.shape)
    err = rng.gaussian_torus(generator, 0, bound, shape, dtype, device=partial.device)
    if sparse_coords is not None:
        batch = sample.b.shape[-1] if sample.b.ndim else 1
        if sparse_coords > batch:
            raise ValueError(
                f"sparse_coords={sparse_coords} exceeds the LWE batch axis ({batch}); "
                "ring-coordinate sparsity only applies to rlwe_partial_decrypt")
        err = err * _sparse_mask(generator, shape, sparse_coords).to(err.device)
    return partial + err


def rlwe_partial_decrypt(sample: RLweSample, shares: AdditiveShares, bound: float,
                         generator: torch.Generator, sparse_coords: int | None = None):
    """Ring partials sum_j shares_i[j] (*) a[j] + smudge_i mod 2^bits.

    sample.a: (k+1, N); shares: (p, k, N). Returns (p, N). The product is
    decrypt.party_products': exact up to N = 4096 and on the 64-bit torus,
    the limb FFT product above.
    ``sparse_coords`` = r: only about r of the N coefficients of each
    party's smudging vector are nonzero.
    """
    a = sample.a[..., :-1, :]
    partial = party_products(torch.as_tensor(shares.shares, device=a.device), a)
    shape = tuple(partial.shape)
    err = rng.gaussian_torus(generator, 0, bound, shape, a.dtype, device=a.device)
    if sparse_coords is not None:
        err = err * _sparse_mask(generator, shape, sparse_coords).to(err.device)
    return partial + err


def _sparse_mask(generator: torch.Generator, shape, r: int) -> torch.Tensor:
    """0/1 int32 mask with about r of the last-axis positions set per row: a
    Bernoulli(r / N) per position, the expected density of the reference's
    r draws with replacement."""
    keep = torch.rand(tuple(shape), generator=generator, device=generator.device) < r / shape[-1]
    return keep.to(torch.int32)


def combine(sample, partials: torch.Tensor) -> torch.Tensor:
    """phase = b - sum_i partial_i, for LWE samples (b per ciphertext) and
    RLWE samples (b the last polynomial)."""
    b = sample.b if isinstance(sample, LweSample) else sample.a[..., -1, :]
    return b - torch.sum(partials, dim=0, dtype=partials.dtype)


def max_tolerable_bound(decrypt_ok, bounds) -> float:
    """The largest bound whose decryption stays correct: ``decrypt_ok`` is a
    callable bound -> bool; 0.0 if none passes."""
    best = 0.0
    for bnd in sorted(bounds):
        if decrypt_ok(float(bnd)):
            best = float(bnd)
    return best

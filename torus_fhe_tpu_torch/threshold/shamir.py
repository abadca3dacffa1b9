"""Shamir (t, n) secret sharing of LWE key files over Z_8191.

A copy of torus_fhe_tpu/threshold/shamir.py: it is numpy only, and importing
it through torus_fhe_tpu would load JAX. Each key coefficient becomes the
constant term of a random degree-(t-1) polynomial over the prime field
P = 8191; shards are evaluations at n distinct random points; any t shards
reconstruct by Lagrange interpolation at 0. Evaluation is one Vandermonde
product over the whole key. Given the same ``np.random.Generator`` seed, the
shards equal the JAX package's.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

P = 8191


def _inv_mod(x: int) -> int:
    return pow(x % P, P - 2, P)


class Shards(NamedTuple):
    t: int
    n: int
    xs: np.ndarray  # (n,) evaluation points
    fs: np.ndarray  # (n, ...) evaluations, one row per shard


def split_secret(secret, t: int, n: int, rng: np.random.Generator) -> Shards:
    """Shard an array of secrets: random coefficients 1..P-1 above the
    secret, n distinct nonzero points, the evaluations mod P."""
    secret = np.asarray(secret) % P
    coeffs = np.concatenate(
        [secret[None], rng.integers(1, P, (t - 1,) + secret.shape)], axis=0)
    xs = np.empty(0, np.int64)
    while len(xs) < n:
        xs = np.unique(rng.integers(1, P, n * 2))[:n]
    rng.shuffle(xs)
    xs = xs[:n]
    # Vandermonde evaluation mod P: fs[i] = sum_j coeffs[j] * xs[i]^j
    powers = np.ones((n, t), np.int64)
    for j in range(1, t):
        powers[:, j] = powers[:, j - 1] * xs % P
    fs = np.tensordot(powers, coeffs, axes=(1, 0)) % P
    return Shards(t, n, xs, fs)


def reconstruct_secret(shards: Shards, use: Sequence[int] | None = None) -> np.ndarray:
    """Lagrange interpolation at 0 over the first t shards of ``use``
    (default: shards 0..t-1)."""
    idx = list(use) if use is not None else list(range(shards.t))
    if len(idx) < shards.t:
        raise ValueError(f"need {shards.t} shards, got {len(idx)}")
    idx = idx[: shards.t]
    total = np.zeros(shards.fs.shape[1:], np.int64)
    for i in idx:
        lam = 1
        for j in idx:
            if i != j:
                lam = lam * (-int(shards.xs[j])) % P
                lam = lam * _inv_mod(int(shards.xs[i]) - int(shards.xs[j])) % P
        total = (total + shards.fs[i] * lam) % P
    return total % P


def split_key(key_bits: np.ndarray, t: int, n: int, seed: int = 0) -> Shards:
    """Shard a whole binary LWE key with ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return split_secret(np.asarray(key_bits), t, n, rng)


def reconstruct_key(shards: Shards, use: Sequence[int] | None = None) -> np.ndarray:
    """Inverse of split_key; values in {0, 1} come back exactly."""
    return reconstruct_secret(shards, use).astype(np.int32)

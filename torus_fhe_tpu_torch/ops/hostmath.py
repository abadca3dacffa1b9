"""Exact host-side (numpy) negacyclic arithmetic for keygen-scale work.

A copy of torus_fhe_tpu/ops/hostmath.py: it is numpy only, and importing it
through torus_fhe_tpu would load JAX.

Key generation is a one-time, host-friendly job whose outputs get packed into
the F-block key layout anyway (ops/fblock.build_fblocks), so its polynomial
products are computed here in numpy: each operand is split into 16-bit limbs
and convolved with f64 FFTs — every partial product stays far below the
53-bit mantissa (|limb_a * limb_b| * N <= 2^32 * 2^12 = 2^44), so rounding
recovers exact integers and the limb recombination wraps mod 2^bits.

This replaces the role of the reference's f64 FFT keygen path
(3-gen-mk-tfhe/src/polynomials.jl) without ever trusting float rounding:
the FFT here is exactness-checked by construction (bounded integer inputs).
"""

from __future__ import annotations

import numpy as np


def _limb16(x: np.ndarray, bits: int) -> np.ndarray:
    """Split to unsigned 16-bit limbs of the unsigned residue; shape (..., L)."""
    nl = (bits + 15) // 16
    v = x.astype(np.int64).astype(np.uint64)
    if bits < 64:
        v &= np.uint64((1 << bits) - 1)
    out = np.empty(x.shape + (nl,), np.float64)
    for m in range(nl):
        out[..., m] = ((v >> np.uint64(16 * m)) & np.uint64(0xFFFF)).astype(np.float64)
    return out


def negacyclic_polymul_host(a: np.ndarray, b: np.ndarray, bits: int) -> np.ndarray:
    """Exact negacyclic a (*) b mod 2^bits for int arrays (..., N), numpy.

    a: small-int polynomials (keys, digits); b: torus polynomials.
    Exactness condition: |a| < 2^16 (true for every key/randomness poly:
    binary, ternary and gadget digits).
    """
    a = np.asarray(a)
    b = np.asarray(b)
    N = a.shape[-1]
    assert b.shape[-1] == N
    assert np.abs(a.astype(np.int64)).max(initial=0) < (1 << 16), "split a too"

    # negacyclic convolution == first half of the 2N cyclic convolution of
    # [a, 0] with [b, -b]; do it with 2N-point real FFTs per 16-bit limb of b.
    nl = (bits + 15) // 16
    blimbs = _limb16(b, bits)  # (..., N, L) as float
    a_ext = np.concatenate([a.astype(np.float64), np.zeros_like(a, np.float64)], axis=-1)
    fa = np.fft.rfft(a_ext, axis=-1)  # (..., N+1)

    res = np.zeros(np.broadcast_shapes(a.shape, b.shape), np.uint64)
    mod_mask = np.uint64(0xFFFFFFFFFFFFFFFF) if bits == 64 else np.uint64((1 << bits) - 1)
    for m in range(nl):
        bl = blimbs[..., m]
        b_ext = np.concatenate([bl, -bl], axis=-1)
        fb = np.fft.rfft(b_ext, axis=-1)
        conv = np.fft.irfft(fa * fb, n=2 * N, axis=-1)[..., :N]
        ints = np.rint(conv)
        # wrap each limb contribution into uint64 before shifting
        vals = ints.astype(np.int64).astype(np.uint64) << np.uint64(16 * m)
        res = (res + vals) & mod_mask
    # back to signed torus ints
    if bits == 64:
        return res.astype(np.int64)
    half = np.uint64(1 << (bits - 1))
    signed = res.astype(np.int64)
    signed[res >= half] -= 1 << bits
    dt = np.int32 if bits == 32 else np.int64
    return signed.astype(dt)

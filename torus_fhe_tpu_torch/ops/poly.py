"""Negacyclic polynomial helpers: limb splits, monomial rotation, gadget
decomposition, an exact schoolbook oracle and the exact int8 matrix product.

Port of the parts of torus_fhe_tpu/ops/poly.py that the F-block blind rotate
(digits of any width, 32- and 64-bit torus) and the keyswitch use. torch has no uint32 arithmetic, so the limb split works
on the unsigned residue held in int64.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Limb splitting
# ---------------------------------------------------------------------------


def n_limbs_for(bits: int) -> int:
    return (bits + 7) // 8


def limb_split_signed_host(x: np.ndarray, bits: int) -> np.ndarray:
    """Split integers into balanced signed byte limbs, host-side (numpy).

    x == sum_m limbs[..., m] * 256**m  (mod 2**bits), each limb in [-128, 127].
    Appends the limb axis last.
    """
    nl = n_limbs_for(bits)
    v = np.asarray(x).astype(np.int64).astype(np.uint64)
    if bits < 64:
        v &= np.uint64((1 << bits) - 1)
    limbs = np.empty(np.shape(x) + (nl,), dtype=np.int8)
    for m in range(nl):
        l = ((v + np.uint64(128)) & np.uint64(255)).astype(np.int64) - 128
        limbs[..., m] = l.astype(np.int8)
        v = (v - l.astype(np.uint64)) >> np.uint64(8)
    return limbs


def limb_split_signed(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Balanced signed byte-limb split of a tensor; limb axis last, int8.

    For bits < 64 the unsigned residue x mod 2^bits is held in int64, where
    the subtraction of each limb stays non-negative and exact. For bits = 64
    the signed recursion gives the same limbs: it differs from the unsigned
    one by a multiple of 2^(64-8m) at limb m, which no kept limb sees.
    """
    v = x.to(torch.int64)
    if bits < 64:
        v = v & ((1 << bits) - 1)
    limbs = []
    for _ in range(n_limbs_for(bits)):
        l = ((v + 128) & 255) - 128  # in [-128, 127]
        limbs.append(l.to(torch.int8))
        v = (v - l) >> 8
    return torch.stack(limbs, dim=-1)


def limb_combine(parts: torch.Tensor, bits: int, dim: int = -1) -> torch.Tensor:
    """Inverse of the limb split for int32 partial results: sum(parts << 8m)
    mod 2^bits, in the torus dtype."""
    dtype = torch.int32 if bits <= 32 else torch.int64
    parts = parts.movedim(dim, -1)
    out = torch.zeros(parts.shape[:-1], dtype=dtype, device=parts.device)
    for m in range(parts.shape[-1]):
        out = out + (parts[..., m].to(dtype) << (8 * m))
    return out


# ---------------------------------------------------------------------------
# Exact schoolbook oracle
# ---------------------------------------------------------------------------


def negacyclic_polymul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact negacyclic product of int polys a (..., N) and torus polys
    b (..., N), wrapping mod 2^bits of b's dtype. Materialises an (..., N, N)
    int64 circulant: small N only (tests, decryption of RLWE samples)."""
    N = a.shape[-1]
    bext = torch.cat([b, -b], dim=-1).to(torch.int64)
    idx = torch.as_tensor((np.arange(N)[None, :] - np.arange(N)[:, None]) % (2 * N),
                          device=b.device)
    circ = bext[..., idx]  # (..., r, c) = bext[(c - r) mod 2N]
    res = (a.to(torch.int64)[..., :, None] * circ).sum(dim=-2)
    return res.to(b.dtype)


# ---------------------------------------------------------------------------
# Monomial multiplication
# ---------------------------------------------------------------------------


def mul_by_monomial(x: torch.Tensor, shift) -> torch.Tensor:
    """Multiply polynomials (..., N) by X^shift mod (X^N + 1).

    ``shift`` is a python int, or a tensor broadcastable over the leading
    axes of x (per-batch shifts, as in the blind rotate): out[t] =
    ext[(t - shift) mod 2N] with ext = [x, -x].
    """
    N = x.shape[-1]
    xext = torch.cat([x, -x], dim=-1)
    if isinstance(shift, (int, np.integer)):
        idx = (torch.arange(N, device=x.device) - int(shift)) % (2 * N)
        return xext[..., idx]
    s = torch.as_tensor(shift, device=x.device).to(torch.int64)
    s = s.reshape(s.shape + (1,) * (x.ndim - s.ndim))
    idx = (torch.arange(N, device=x.device) - s) % (2 * N)
    return torch.gather(xext, -1, idx.expand(x.shape))


# ---------------------------------------------------------------------------
# Gadget decomposition
# ---------------------------------------------------------------------------


def decompose(x: torch.Tensor, decomp_length: int, log2_base: int, bits: int,
              offset: int) -> torch.Tensor:
    """Signed gadget decomposition of torus polynomials.

    x: (..., N) torus ints. Returns (..., decomp_length, N) int32 digits in
    [-B/2, B/2): add the offset, take base-B digits from the high bits (the
    arithmetic shift is masked, so it equals a logical one), re-centre.
    """
    dtype = torch.int32 if bits <= 32 else torch.int64
    shifted = x.to(dtype) + offset
    mask = (1 << log2_base) - 1
    half = 1 << (log2_base - 1)
    digits = [(((shifted >> (bits - j * log2_base)) & mask) - half).to(torch.int32)
              for j in range(1, decomp_length + 1)]
    return torch.stack(digits, dim=-2)


_LIMB_BIAS = -0x7F7F7F80  # 0x80808080 as int32: +128 on every byte, carries included


def digits_to_i8_rows(digits: torch.Tensor, log2_base: int) -> list:
    """Decomposition digits as int8 row blocks, split into byte limbs when
    the base exceeds a byte.

    digits: (..., N) int32 in [-B/2, B/2). Returns a list of int8 blocks of
    the same shape with digits == sum_m blocks[m] << 8m exactly: one block at
    log2_base <= 8, else the first (log2_base + 8) // 8 balanced signed limbs
    of ``limb_split_signed(digits, 32)`` (a signed digit needs log2_base + 1
    bits), so that callers shift-combine the blocks' products.

    The balanced limbs of d are the bytes of d + 0x80808080, each less 128:
    the bias turns every limb's borrow into a plain carry. So the split is
    one add, one reinterpretation of the int32 words as bytes (little-endian,
    on x86 hosts and on the card alike) and one flip of each byte's top bit.
    """
    if log2_base <= 8:
        return [digits.to(torch.int8)]
    nl = (log2_base + 8) // 8
    biased = (digits.to(torch.int32) + _LIMB_BIAS).contiguous()
    limbs = biased.view(torch.int8).reshape(digits.shape + (4,)) ^ -128
    return [limbs[..., m] for m in range(nl)]


# ---------------------------------------------------------------------------
# Exact int8 matrix product
# ---------------------------------------------------------------------------


MIN_ROWS = 32  # rows _int_mm is given at least


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact (M, K) @ (K, N) int8 -> int32 through ``torch._int_mm``.

    On CUDA, _int_mm takes M > 16 and K, N multiples of 8, and on an H100
    (torch 2.11, CUDA 12.8) cuBLASLt also refused M = 17 and 24 at K = 64
    where M = 32 ran. So M is padded up to 32 here, on the CPU too, so that
    both devices run the same shapes; K and N must already be multiples of 8
    (callers pad their tables once). On CUDA a ``b`` whose reduction index
    is contiguous (the transpose of a contiguous matrix) is passed as it is:
    cuBLASLt reads it so. ``int8_matmul.calls`` counts the products, so that
    a run can say how many a route made.
    """
    int8_matmul.calls += 1
    M, K = a.shape
    if K % 8 or b.shape[1] % 8:
        raise ValueError(f"int8_matmul needs K and N multiples of 8, got {tuple(b.shape)}")
    if M < MIN_ROWS:
        a = torch.cat([a, a.new_zeros((MIN_ROWS - M, K))])
    if not (b.is_cuda and b.t().is_contiguous()):
        b = b.contiguous()
    return torch._int_mm(a.contiguous(), b)[:M]


int8_matmul.calls = 0

"""Negacyclic polynomial helpers: limb splits, monomial rotation, gadget
decomposition, an exact schoolbook oracle, the limb FFT product of huge
rings, the exact int8 matrix product and the packing contraction.

Port of torus_fhe_tpu/ops/poly.py. Its two XLA lowerings of the packed
product (the conv backend and the circulant matmul, chosen by
``set_backend``) become one exact int8 product here: the digit side's
Toeplitz rows against the packed kernels (``negacyclic_extern_product``),
which the TGSW external product of the scan route, LWE -> RLWE packing and
the CCS and KMS multikey products use. torch has no uint32 arithmetic, so
the limb split works on the unsigned residue held in int64.
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
# Limb-split f64 FFT product (huge rings, any N)
# ---------------------------------------------------------------------------


def _split16(x: torch.Tensor):
    """x == lo + 2^16 hi with lo in [-2^15, 2^15): both limbs small for the
    f64 FFT, as float64."""
    lo = ((x + (1 << 15)) & 0xFFFF) - (1 << 15)
    return lo.to(torch.float64), ((x - lo) >> 16).to(torch.float64)


def negacyclic_polymul_fft64(a: torch.Tensor, b: torch.Tensor, bits: int = 32) -> torch.Tensor:
    """Negacyclic product of int polys a (..., N) with 32-bit torus polys
    b (..., N) through 16-bit-limb complex128 FFTs, on b's device (cuFFT in
    double precision on the card), for any N: the huge rings of the
    threshold partial decryption (N above 4096, up to 2^20 and beyond).

    The twist by exp(-i pi k / N) turns the N-point cyclic FFT into the
    negacyclic one. With 16-bit limbs every convolution sum stays below
    N * 2^31 < 2^53, exact in f64 before rounding; the rounding error of the
    FFT is what remains (the JAX package's bound: < 2^-20 of the torus at
    N = 2^20). Torus wrap-around (mod 2^32) kills the limb product of scale
    2^32, so three products remain and the two of scale 2^16 share one
    inverse FFT. Returns int32.
    """
    if bits != 32:
        raise ValueError(f"the FFT product implements the 32-bit torus, not {bits} bits")
    a = a.to(device=b.device, dtype=torch.int64)
    b = b.to(torch.int64)
    N = a.shape[-1]
    angle = torch.arange(N, dtype=torch.float64, device=b.device) * (torch.pi / N)
    tw = torch.polar(torch.ones_like(angle), -angle)
    itw = torch.polar(torch.ones_like(angle), angle)
    a_lo, a_hi = _split16(a)
    b_lo, b_hi = _split16(b)
    fa_lo, fa_hi = torch.fft.fft(a_lo * tw), torch.fft.fft(a_hi * tw)
    fb_lo, fb_hi = torch.fft.fft(b_lo * tw), torch.fft.fft(b_hi * tw)

    def untwist_i32(f):
        # the int64 -> int32 narrowing is the mod-2^32 torus reduction
        return torch.round((torch.fft.ifft(f) * itw).real).to(torch.int64).to(torch.int32)

    lo_lo = untwist_i32(fa_lo * fb_lo)
    cross = untwist_i32(fa_lo * fb_hi + fa_hi * fb_lo)
    return lo_lo + (cross << 16)  # int32 wrap == mod 2^32


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


# ---------------------------------------------------------------------------
# Packed kernels and the exact negacyclic contraction against them
# ---------------------------------------------------------------------------


def pack_kernels_host(kernels: np.ndarray, bits: int, drop_limbs: int = 0) -> np.ndarray:
    """Torus kernels as int8 limbs, in the JAX package's layout.

    kernels: (..., R, C, N) torus ints (numpy). Returns int8 of shape
    (..., C * (n_limbs - drop_limbs), R, N) with the window axis FLIPPED: row
    c * L' + m holds limb drop_limbs + m of kernel[r, c] at position
    N - 1 - t. ``negacyclic_extern_product`` reads this layout (the flip lets
    it form the digit side's Toeplitz rows as windows of one padded
    sequence). ``drop_limbs`` drops the lowest limbs of every kernel (the
    product then takes ``limb_offset=drop_limbs``).
    """
    limbs = limb_split_signed_host(kernels, bits)[..., drop_limbs:]  # (..., R, C, N, L')
    limbs = np.moveaxis(limbs, -1, -2)[..., ::-1]  # (..., R, C, L, N), window flipped
    limbs = np.moveaxis(limbs, -4, -2)  # (..., C, L, R, N)
    shape = limbs.shape
    return np.ascontiguousarray(
        limbs.reshape(shape[:-4] + (shape[-4] * shape[-3], shape[-2], shape[-1])))


def unpack_kernels_host(packed: np.ndarray, bits: int, out_polys: int) -> np.ndarray:
    """The inverse of ``pack_kernels_host``: (..., C * L, R, N) int8 limbs
    with the window flipped -> (..., R, C, N) torus ints (int32 for 32 bits,
    int64 for 64), host numpy."""
    L = n_limbs_for(bits)
    p = np.asarray(packed)[..., ::-1].astype(np.int64)
    p = p.reshape(p.shape[:-3] + (out_polys, L) + p.shape[-2:])
    vals = np.zeros(p.shape[:-4] + (out_polys,) + p.shape[-2:], np.int64)
    with np.errstate(over="ignore"):
        for m in range(L):
            vals += p[..., m, :, :] << np.int64(8 * m)
    return np.moveaxis(vals.astype(np.int32 if bits <= 32 else np.int64), -3, -2)


def pack_kernels_traced(kernels: torch.Tensor, bits: int) -> torch.Tensor:
    """``pack_kernels_host`` of a tensor on its device: the layout of
    runtime kernels, such as the KMS TLev accumulator, whose key side of a
    negacyclic contraction is itself a ciphertext.

    kernels: (..., R, C, N) torus ints. Returns (..., C * L, R, N) int8,
    byte-equal to ``pack_kernels_host`` of the same values.
    """
    limbs = limb_split_signed(kernels, bits).movedim(-1, -2).flip(-1)  # (..., R, C, L, N)
    limbs = limbs.movedim(-4, -2)  # (..., C, L, R, N)
    s = limbs.shape
    return limbs.reshape(s[:-4] + (s[-4] * s[-3], s[-2], s[-1]))


INT32_TERMS = (2**31 - 1) // 2**14  # |digit * limb| <= 128 * 128: exact int32 sums of this many
TOEPLITZ_BYTES = 1 << 29  # the digit-side Toeplitz rows held at once


def _folded_products(digits: torch.Tensor, packed: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """The per-limb negacyclic products sum_r digits[b, r] (*) packed[cl, r]
    before the limb shifts: digits (B, R, N) int8 and packed (CL, R, N) int8
    (window flipped) give (B, CL, N) in ``dtype``.

    The circulant sits on the digit side, so the key side stays the compact
    (CL, R * N) limbs. With the window flipped, out[j] = sum_t
    (x_u[j + t] - x_w[j + t]) * packed[t] for x_u = [0 * (N - 1), d] (the
    terms t <= j) and x_w = [d[1:], 0 * N] (the wrapped ones, which carry the
    minus sign): both halves are windows of a padded sequence (``unfold``),
    stacked as rows of ONE ``int8_matmul`` whose sums are subtracted after,
    so no digit is negated (+128 does not fit in int8). The work runs in
    chunks of digit rows, each at most INT32_TERMS products a sum (the int32
    sums stay exact whatever the accumulator does on overflow), and of batch
    elements, so that a chunk holds at most TOEPLITZ_BYTES of Toeplitz rows
    whatever the batch. The row chunks add in ``dtype``: wrapping int32 is
    exact mod 2^32, and int64 keeps the carries past 2^32 that the 64-bit
    torus needs. The batch chunks change no sum.
    """
    B, R, N = digits.shape
    CL = packed.shape[0]
    if 2 * N * N > TOEPLITZ_BYTES:
        raise ValueError(f"N={N}: one Toeplitz row block is {2 * N * N} bytes, over "
                         f"TOEPLITZ_BYTES={TOEPLITZ_BYTES}")
    cols = -(-CL // 8) * 8  # int8_matmul's N: a multiple of 8
    key = torch.cat([packed.reshape(CL, R * N), packed.new_zeros((cols - CL, R * N))])
    rows = max(1, min(R, INT32_TERMS // N, TOEPLITZ_BYTES // (2 * N * N)))
    keys = [key[:, r0 * N:(r0 + rows) * N].contiguous().t() for r0 in range(0, R, rows)]
    per = max(1, min(B, TOEPLITZ_BYTES // (2 * rows * N * N)))
    out = []
    for b0 in range(0, B, per):
        d = digits[b0:b0 + per]
        b = d.shape[0]
        x = torch.stack([torch.cat([d.new_zeros((b, R, N - 1)), d], -1),
                         torch.cat([d[..., 1:], d.new_zeros((b, R, N))], -1)])
        acc = None
        for k, r0 in enumerate(range(0, R, rows)):
            r1 = min(R, r0 + rows)
            toeplitz = x[:, :, r0:r1].unfold(-1, N, 1)  # (2, b, r, j, t) = x[..., j + t]
            mat = toeplitz.permute(0, 1, 3, 2, 4).reshape(2 * b * N, (r1 - r0) * N)
            part = int8_matmul(mat, keys[k]).to(dtype)
            acc = part if acc is None else acc + part
        folded = acc.reshape(2, b, N, cols)[..., :CL]
        out.append((folded[0] - folded[1]).permute(0, 2, 1))
    return torch.cat(out)


def _combine_limbs(folded: torch.Tensor, out_polys: int, limb_offset: int) -> torch.Tensor:
    """Folded limb products (B, C * L', N) -> (B, C, N) torus ints: limb m
    shifted by 8 * (m + limb_offset), summed in the torus dtype."""
    B, _, N = folded.shape
    L = folded.shape[1] // out_polys
    folded = folded.reshape(B, out_polys, L, N)
    out = torch.zeros((B, out_polys, N), dtype=folded.dtype, device=folded.device)
    for m in range(L):
        out = out + (folded[:, :, m] << (8 * (m + limb_offset)))
    return out


def _check_packed(digits: torch.Tensor, packed: torch.Tensor, bits: int, out_polys: int,
                  limb_offset: int) -> None:
    R, N = digits.shape[-2:]
    L = n_limbs_for(bits) - limb_offset
    if packed.shape[-3] != out_polys * L or packed.shape[-2:] != (R, N) or N % 8:
        raise ValueError(f"packed {tuple(packed.shape)} against digits {tuple(digits.shape)}, "
                         f"{L} limbs: want ({out_polys} * {L}, {R}, {N}) and N a multiple of 8")


def negacyclic_extern_product(digits: torch.Tensor, packed: torch.Tensor, bits: int,
                              out_polys: int, limb_offset: int = 0) -> torch.Tensor:
    """out[b, c] = sum_r digits[b, r] (*) kernels[r, c], negacyclic and exact.

    digits: (B, R, N) int8; packed: (C * (n_limbs(bits) - limb_offset), R, N)
    int8 from ``pack_kernels_host`` (``limb_offset`` its ``drop_limbs``), on
    digits' device. Returns (B, C, N) torus ints (int32 for 32 bits, int64
    for 64): the limb products of ``_folded_products`` in the torus dtype,
    limb m shifted by 8 * (m + limb_offset).
    """
    _check_packed(digits, packed, bits, out_polys, limb_offset)
    dtype = torch.int32 if bits <= 32 else torch.int64
    return _combine_limbs(_folded_products(digits, packed, dtype), out_polys, limb_offset)


def negacyclic_extern_product_batched_kernels(digits: torch.Tensor, packed: torch.Tensor,
                                              bits: int, out_polys: int) -> torch.Tensor:
    """Per-element kernels: out[b, c] = sum_r digits[b, r] (*) k[b, r, c],
    exact. digits: (B, R, N) int8; packed: (B, C * L, R, N) int8 from
    ``pack_kernels_traced``. Returns (B, C, N) torus ints, the contract of
    ``negacyclic_extern_product`` with a kernel an element (one
    ``_folded_products`` each: ``torch._int_mm`` is 2-D only). The limb sums
    run in the torus dtype, as ``negacyclic_extern_product``'s do."""
    if packed.shape[0] != digits.shape[0]:
        raise ValueError(f"packed {tuple(packed.shape)} against digits {tuple(digits.shape)}")
    _check_packed(digits, packed, bits, out_polys, 0)
    dtype = torch.int32 if bits <= 32 else torch.int64
    folded = torch.cat([_folded_products(digits[b:b + 1], packed[b], dtype)
                        for b in range(digits.shape[0])])
    return _combine_limbs(folded, out_polys, 0)


def negacyclic_extern_product_batched_kernels_multirow(rows: torch.Tensor,
                                                       packed: torch.Tensor) -> torch.Tensor:
    """Per-element kernels, many digit-row groups an element: out[b, m, cl]
    = sum_r rows[b, m, r] (*) packed[b, cl, r], the limb products before any
    shift.

    rows: (B, M, R, N) int8, M groups that all contract against element b's
    kernel (the KMS TLev relinearisation: accumulator polys x digit limb
    blocks against one runtime TLev sample); packed: (B, C * L, R, N) int8
    from ``pack_kernels_traced``. Returns (B, M, C * L, N) int32, as the JAX
    package's product does: exact while a limb sum stays in int32 (R * N <=
    INT32_TERMS at every registry set), wrapping mod 2^32 past it. The limb
    and digit-block shifts are the caller's. Each element is one
    ``_folded_products`` with its own key side: ``torch._int_mm`` is 2-D
    only, so the elements take turns.
    """
    B, M, R, N = rows.shape
    if packed.shape[0] != B or packed.shape[2:] != (R, N) or N % 8:
        raise ValueError(f"packed {tuple(packed.shape)} against rows {tuple(rows.shape)}")
    return torch.stack([_folded_products(rows[b], packed[b], torch.int32) for b in range(B)])

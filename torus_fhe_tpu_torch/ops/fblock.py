"""Block-circulant ("F-block") bootstrapping-key layout and the plain
PyTorch blind rotate over it.

Port of torus_fhe_tpu/ops/fblock.py. The negacyclic product against a fixed
kernel polynomial k is a matmul by the N x N negacirculant M[u, t] =
ext[(t - u) mod 2N], ext = [k, -k]. Cut into bs x bs blocks, block (i, j)
depends only on delta = (j - i) mod D, D = 2N/bs, so per (row poly r, kept
byte-limb column) the key stores D blocks. The expanded key of one CMux step
is a (D*R*bs, ncols*bs) int8 matrix with the delta blocks in ``seq_perm``
order; its bytes are identical to the JAX package's ``build_fblocks``. The
CUDA kernel (ops/cuda_rotate.py, csrc/blind_rotate.cu) reads the same bytes
in the KERNEL LAYOUT (n, D, ncols*bs, R*bs): each delta block transposed, so
that the reduction index (row r, position p) is contiguous, as the int8
tensor-core instructions want both operands (``to_kernel_layout``). A key
holds one of the two: ``build_rotate_key`` makes the kernel layout on a CUDA
device and the ``build_fblocks`` layout elsewhere.

``blind_rotate_fblock`` is the plain version of that kernel: word-exact, a
Python loop over the n steps that runs on CPU and CUDA tensors alike, over
either layout. It also serves what the kernels refuse, on either device: the
64-bit torus (int64 accumulator, 16 limb columns) and gadget digits wider
than a byte, which split into int8 limb blocks (``apply_fblock``). The JAX
package runs those outside its Pallas kernel too (an XLA scan).
``blind_rotate_streamed`` runs the same chain from the compact lines
(``build_sel``), expanded chunk by chunk (``expand_fblock_chunk``): the plain
version of the compact-key kernel (ops/cuda_rotate.blind_rotate_sel_cuda,
csrc/blind_rotate_sel.cu). That kernel expands nothing: a GEMM tile's key
operand is a window of one reversed line, so it reads the lines in the COMPACT
KERNEL LAYOUT (steps, ncols, R, 2N), limb-major and each line reversed
(``to_sel_kernel_layout``), a byte-exact permutation of ``build_sel``'s
(steps, R, 2N, ncols) of the same size. ``build_sel_key`` makes the kernel
layout on a CUDA device and ``build_sel``'s elsewhere; the plain version
reads both.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import poly


class FBlockGeometry(NamedTuple):
    n: int        # number of CMux steps (LWE size)
    N: int        # ring degree
    bs: int       # block size (min(128, N))
    nb: int       # N // bs
    D: int        # 2N // bs distinct deltas
    C: int        # k+1 polys per RLWE sample
    R: int        # l * C reduction rows
    cols: Tuple[Tuple[int, int], ...]  # kernel limb columns: (out_poly, shift)
    bits: int     # torus width


def default_cols(mask_size: int, bits: int, drop_limbs: int) -> Tuple[Tuple[int, int], ...]:
    """Kernel limb columns: every limb of each mask poly, and the body's limbs
    from ``drop_limbs`` up (the body is rounded at keygen, so the dropped
    bytes are exactly zero)."""
    nl = poly.n_limbs_for(bits)
    cols = []
    for j in range(mask_size):
        cols += [(j, 8 * m) for m in range(nl)]
    cols += [(mask_size, 8 * m) for m in range(drop_limbs, nl)]
    return tuple(cols)


def fblock_geometry(n: int, N: int, mask_size: int, decomp_length: int,
                    bits: int, drop_limbs: int, block: int = 128) -> FBlockGeometry:
    bs = min(block, N)
    if N % bs:
        raise ValueError(f"N={N} is not a multiple of the block size {bs}")
    C = mask_size + 1
    return FBlockGeometry(
        n=n, N=N, bs=bs, nb=N // bs, D=2 * N // bs, C=C,
        R=decomp_length * C,
        cols=default_cols(mask_size, bits, drop_limbs),
        bits=bits)


def _delta_index(geom: FBlockGeometry) -> np.ndarray:
    """(D, bs, bs) gather index: idx[delta, p, q] = (bs*delta + q - p) mod 2N."""
    d = np.arange(geom.D)[:, None, None]
    p = np.arange(geom.bs)[None, :, None]
    q = np.arange(geom.bs)[None, None, :]
    return (geom.bs * d + q - p) % (2 * geom.N)


def seq_perm(D: int) -> np.ndarray:
    """Reverse-cyclic delta ordering: seq[m] = delta-block[(-m) mod D].

    In this order the key rows that output block j needs (delta = (j - i)
    mod D for digit blocks i = 0..nb-1) sit at consecutive positions
    m = (i - j) mod D.
    """
    return (-np.arange(D)) % D


def build_sel(samples: np.ndarray, geom: FBlockGeometry) -> np.ndarray:
    """The compact F-block form: per CMux step, the extended (negated-wrap)
    kernel lines split into the kept byte-limb columns.

    samples: (n, l, C, C, N) torus ints (numpy). Returns (n, R, 2N, ncols)
    int8. The lines are negated in the torus domain BEFORE the limb split:
    an int8 limb cannot hold +128, so negating limbs would be wrong.
    """
    limbs = _extended_line_limbs(samples, geom)
    sel = np.stack([limbs[:, :, p, :, s // 8] for p, s in geom.cols], axis=-1)
    return np.ascontiguousarray(sel)


def unbuild_sel(sel: np.ndarray, geom: FBlockGeometry) -> np.ndarray:
    """The raw samples (n, l, C, C, N) torus ints of compact lines in
    ``build_sel``'s layout (n, R, 2N, ncols): the inverse of ``build_sel``
    for a geometry that keeps every limb column (no dropped limb). The first
    N entries of each line are the kernel itself, limb column (p, s)
    holding limb s/8 of its output poly p."""
    sel = np.asarray(sel)
    n = sel.shape[0]
    nl = poly.n_limbs_for(geom.bits)
    if len(geom.cols) != geom.C * nl or sel.shape[1:] != (geom.R, 2 * geom.N, len(geom.cols)):
        raise ValueError(f"lines {sel.shape} of {geom}: want every limb column kept")
    kern = np.zeros((n, geom.R, geom.C, geom.N), np.int64)
    with np.errstate(over="ignore"):
        for ci, (p, s) in enumerate(geom.cols):
            kern[:, :, p] += sel[:, :, :geom.N, ci].astype(np.int64) << np.int64(s)
    kern = kern.astype(np.int32 if geom.bits <= 32 else np.int64)
    return kern.reshape(n, geom.R // geom.C, geom.C, geom.C, geom.N)


def _extended_line_limbs(samples: np.ndarray, geom: FBlockGeometry,
                         reverse: bool = False) -> np.ndarray:
    """The extended lines [k, -k] of raw samples (n, l, C, C, N), negated in
    the torus domain and then split into byte limbs: (n, R, C, 2N, nl) int8.
    ``reverse``: each line reversed, ext[(-g) mod 2N] at position g."""
    n, l, C, C2, N = samples.shape
    if (C, N, l * C) != (geom.C, geom.N, geom.R) or C != C2:
        raise ValueError(f"samples {samples.shape} do not match {geom}")
    kern = np.ascontiguousarray(samples.reshape(n, geom.R, C, N))
    with np.errstate(over="ignore"):
        ext = np.concatenate([kern, -kern], axis=-1)  # wraps mod 2^bits
    if reverse:  # position 0 stays, the rest runs backwards
        ext = np.concatenate([ext[..., :1], ext[..., :0:-1]], axis=-1)
    return poly.limb_split_signed_host(ext, geom.bits)


def build_sel_kernel_layout(samples: np.ndarray, geom: FBlockGeometry) -> np.ndarray:
    """``build_sel`` straight into the compact kernel layout (n, ncols, R, 2N)
    on the host: limb-major, each line reversed. Byte-equal to
    ``to_sel_kernel_layout(build_sel(samples))``."""
    limbs = _extended_line_limbs(samples, geom, reverse=True)
    return np.ascontiguousarray(
        np.stack([limbs[:, :, p, :, s // 8] for p, s in geom.cols], axis=1))


def expand_fblock_chunk(sel_chunk: torch.Tensor, geom: FBlockGeometry) -> torch.Tensor:
    """Expand compact lines into F-blocks on their device.

    sel_chunk: (cs, R, 2N, ncols) int8 (``build_sel`` rows). Returns
    (cs, D*R*bs, ncols*bs) int8: row m*R*bs + r*bs + p, column ci*bs + q
    holds limb column ci of line r at (bs*seq_perm(D)[m] + q - p) mod 2N,
    byte-equal to the same steps of ``build_fblocks``.
    """
    cs, R, two_n, ncols = sel_chunk.shape
    if (R, two_n, ncols) != (geom.R, 2 * geom.N, len(geom.cols)):
        raise ValueError(f"lines {tuple(sel_chunk.shape)} do not match {geom}")
    D, bs = geom.D, geom.bs
    idx = _step_plan(geom, sel_chunk.device).expand
    g = sel_chunk.index_select(2, idx).reshape(cs, R, D, bs, bs, ncols)
    g = g.permute(0, 2, 1, 3, 5, 4)  # (cs, m, R, p, ncols, q)
    return g.reshape(cs, D * R * bs, ncols * bs)


def build_fblocks(samples: np.ndarray, geom: FBlockGeometry, device=None,
                  chunk: int = 64) -> torch.Tensor:
    """Build the F-block key from raw TGSW samples on ``device``.

    samples: (n, l, C, C, N) torus ints (host numpy); samples[s, i, j, c] is
    output poly c of RLWE row (digit level i, poly j) of step s. Returns
    (n, D*R*bs, ncols*bs) int8 (layout: ``expand_fblock_chunk``). Only the
    compact lines cross to the device; the expansion runs there in chunks
    of ``chunk`` steps.
    """
    n = samples.shape[0]
    sel = build_sel(samples, geom)
    D, R, bs = geom.D, geom.R, geom.bs
    fb = torch.empty((n, D * R * bs, len(geom.cols) * bs), dtype=torch.int8, device=device)
    for s0 in range(0, n, chunk):
        fb[s0:s0 + chunk] = expand_fblock_chunk(
            torch.from_numpy(sel[s0:s0 + chunk]).to(device), geom)
    return fb


def kernel_layout_shape(geom: FBlockGeometry) -> tuple:
    """Shape of one step of the kernel layout: (D, ncols*bs, R*bs)."""
    return (geom.D, len(geom.cols) * geom.bs, geom.R * geom.bs)


def to_kernel_layout(fb: torch.Tensor, geom: FBlockGeometry, chunk: int = 64) -> torch.Tensor:
    """The expanded key (n, D*R*bs, ncols*bs) in the kernel layout
    (n, D, ncols*bs, R*bs): kernel[s, m, col, r*bs + p] =
    fb[s, m*R*bs + r*bs + p, col], a byte-exact permutation (each delta
    block transposed), ``chunk`` steps at a time."""
    n = fb.shape[0]
    D, cols, rbs = kernel_layout_shape(geom)
    if tuple(fb.shape[1:]) != (D * rbs, cols):
        raise ValueError(f"fb {tuple(fb.shape)} does not match {geom}")
    out = torch.empty((n, D, cols, rbs), dtype=fb.dtype, device=fb.device)
    for s0 in range(0, n, chunk):
        out[s0:s0 + chunk] = fb[s0:s0 + chunk].reshape(-1, D, rbs, cols).transpose(2, 3)
    return out


def from_kernel_layout(key: torch.Tensor, geom: FBlockGeometry) -> torch.Tensor:
    """The inverse of ``to_kernel_layout``: (n, D*R*bs, ncols*bs)."""
    D, cols, rbs = kernel_layout_shape(geom)
    if tuple(key.shape[1:]) != (D, cols, rbs):
        raise ValueError(f"key {tuple(key.shape)} does not match {geom}")
    return key.transpose(2, 3).reshape(key.shape[0], D * rbs, cols)


def expand_kernel_chunk(sel_chunk: torch.Tensor, geom: FBlockGeometry) -> torch.Tensor:
    """Expand compact lines straight into the kernel layout on their device:
    (cs, R, 2N, ncols) -> (cs, D, ncols*bs, R*bs), byte-equal to
    ``to_kernel_layout(expand_fblock_chunk(sel_chunk))``. The output is
    allocated once and each key block m is gathered into it on its own, so
    a chunk is alive once, beside one block's gather (1/D of it)."""
    cs, R, two_n, ncols = sel_chunk.shape
    if (R, two_n, ncols) != (geom.R, 2 * geom.N, len(geom.cols)):
        raise ValueError(f"lines {tuple(sel_chunk.shape)} do not match {geom}")
    D, bs = geom.D, geom.bs
    idx = _step_plan(geom, sel_chunk.device).expand.reshape(D, bs * bs)
    out = torch.empty((cs, D, ncols * bs, R * bs), dtype=sel_chunk.dtype, device=sel_chunk.device)
    for m in range(D):
        g = sel_chunk.index_select(2, idx[m]).reshape(cs, R, bs, bs, ncols)
        out[:, m].view(cs, ncols, bs, R, bs).copy_(g.permute(0, 4, 3, 1, 2))  # (cs, ncols, q, R, p)
    return out


def build_rotate_key(samples: np.ndarray, geom: FBlockGeometry, device,
                     chunk: int = 64) -> torch.Tensor:
    """The expanded key of raw TGSW samples (n, l, C, C, N) in the form the
    blind rotate of ``device`` reads: the kernel layout (n, D, ncols*bs, R*bs)
    on a CUDA device, where csrc/blind_rotate.cu runs, and the
    ``build_fblocks`` layout elsewhere. One copy of the key either way."""
    device = torch.device(device)
    if device.type != "cuda":
        return build_fblocks(samples, geom, device, chunk)
    n = samples.shape[0]
    sel = build_sel(samples, geom)
    key = torch.empty((n,) + kernel_layout_shape(geom), dtype=torch.int8, device=device)
    for s0 in range(0, n, chunk):
        key[s0:s0 + chunk] = expand_kernel_chunk(
            torch.from_numpy(sel[s0:s0 + chunk]).to(device), geom)
    return key


def sel_kernel_layout_shape(geom: FBlockGeometry) -> tuple:
    """Shape of one step of the compact kernel layout: (ncols, R, 2N)."""
    return (len(geom.cols), geom.R, 2 * geom.N)


def _reversed_line_index(geom: FBlockGeometry, device) -> torch.Tensor:
    """g -> (-g) mod 2N, an involution."""
    return torch.as_tensor((-np.arange(2 * geom.N)) % (2 * geom.N), device=device)


def to_sel_kernel_layout(sel: torch.Tensor, geom: FBlockGeometry,
                         chunk: int = 64) -> torch.Tensor:
    """The compact lines (steps, R, 2N, ncols) in the compact kernel layout
    (steps, ncols, R, 2N): kernel[s, ci, r, g] = sel[s, r, (-g) mod 2N, ci],
    a byte-exact permutation (limb-major, each line reversed), ``chunk``
    steps at a time. Both halves of a line are carried over as they are: the
    second is the torus negation of the first, which no byte negation gives."""
    steps = sel.shape[0]
    ncols, R, two_n = sel_kernel_layout_shape(geom)
    if tuple(sel.shape[1:]) != (R, two_n, ncols):
        raise ValueError(f"lines {tuple(sel.shape)} do not match {geom}")
    idx = _reversed_line_index(geom, sel.device)
    out = torch.empty((steps, ncols, R, two_n), dtype=sel.dtype, device=sel.device)
    for s0 in range(0, steps, chunk):
        out[s0:s0 + chunk] = sel[s0:s0 + chunk].index_select(2, idx).permute(0, 3, 1, 2)
    return out


def from_sel_kernel_layout(key: torch.Tensor, geom: FBlockGeometry) -> torch.Tensor:
    """The inverse of ``to_sel_kernel_layout``: (steps, R, 2N, ncols)."""
    if tuple(key.shape[1:]) != sel_kernel_layout_shape(geom):
        raise ValueError(f"key {tuple(key.shape)} does not match {geom}")
    idx = _reversed_line_index(geom, key.device)
    return key.index_select(3, idx).permute(0, 2, 3, 1).contiguous()


def build_sel_key(samples: np.ndarray, geom: FBlockGeometry, device) -> torch.Tensor:
    """The compact key of raw TGSW samples (n, l, C, C, N) in the form the
    compact blind rotate of ``device`` reads: the compact kernel layout
    (n, ncols, R, 2N) on a CUDA device, where csrc/blind_rotate_sel.cu runs,
    and ``build_sel``'s (n, R, 2N, ncols) elsewhere. One copy of the key
    either way, laid out on the host, so the card holds nothing besides it."""
    device = torch.device(device)
    build = build_sel_kernel_layout if device.type == "cuda" else build_sel
    return torch.from_numpy(build(samples, geom)).to(device)


class _StepPlan(NamedTuple):
    """The index tensors of one geometry's step, on one device."""

    expand: torch.Tensor     # (D*bs*bs,) line positions of the delta blocks, seq_perm order
    gather: torch.Tensor     # (nb, D) digit block of (output block j, key block m); nb: none
    col_poly: torch.Tensor   # (ncols,) output poly of each limb column
    col_shift: torch.Tensor  # (ncols, 1) its shift


@functools.lru_cache(maxsize=None)
def _cached_plan(geom: FBlockGeometry, device: torch.device) -> _StepPlan:
    nb, D = geom.nb, geom.D
    # output block j pulls digit block i = (j - delta) mod D for each delta,
    # valid only when i < nb; key block m of a step holds delta = seq_perm[m]
    ji = (np.arange(nb)[:, None] - seq_perm(D)[None, :]) % D
    dtype = torch.int32 if geom.bits <= 32 else torch.int64
    return _StepPlan(
        torch.as_tensor(_delta_index(geom)[seq_perm(D)].reshape(-1), device=device),
        torch.as_tensor(np.where(ji < nb, ji, nb), device=device),
        torch.tensor([p for p, _ in geom.cols], device=device),
        torch.tensor([[s] for _, s in geom.cols], dtype=dtype, device=device))


def _step_plan(geom: FBlockGeometry, device) -> _StepPlan:
    """Built once per (geometry, device): a rotate of thousands of steps
    must not copy its indices from the host at every step."""
    return _cached_plan(geom._replace(n=0), torch.device(device))


@functools.lru_cache(maxsize=None)
def _limb_shifts(nl: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(nl, 1, 1, 1) shifts 8m of the digit limb blocks."""
    return 8 * torch.arange(nl, dtype=dtype, device=device).reshape(nl, 1, 1, 1)


def contract_rows_fblock(d8: torch.Tensor, fstep: torch.Tensor, geom: FBlockGeometry,
                         dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """Contract int8 digit rows against one expanded F-block step.

    d8: (B, R, N) int8 rows (row r = digit level x poly); fstep:
    (D*R*bs, ncols*bs) int8 in seq_perm order, which the product reads as it
    lies, or the same step in the kernel layout (D, ncols*bs, R*bs), read
    through a transposed copy. Returns (B, C, N) ``dtype`` (the accumulator's:
    int32, or int64 on the 64-bit torus, where the shifts of up to 56 wrap):
    out[c] = sum_r rows_r (*) K_{r,c}, as one exact int8 matmul whose limb
    columns are shifted and summed onto their polys.
    """
    B = d8.shape[0]
    nb, D, bs, R, C = geom.nb, geom.D, geom.bs, geom.R, geom.C
    ncols = len(geom.cols)
    plan = _step_plan(geom, d8.device)
    # the digit blocks are gathered and laid out as 8-byte words: byte by byte
    # the gather alone took 0.27 ms a step at the 16-party shapes on an H100
    word = 8 if bs % 8 == 0 else 1
    if not d8.is_contiguous() or d8.storage_offset() % word:
        d8 = d8.clone(memory_format=torch.contiguous_format)
    blocks = d8.reshape(B, R, nb, bs)
    if word == 8:
        blocks = blocks.view(torch.int64)
    blocks = torch.nn.functional.pad(blocks, (0, 0, 0, 1))  # block nb: zeros
    g = blocks[:, :, plan.gather]  # (B, R, j, m, bs / word)
    dexp = g.permute(0, 2, 3, 1, 4).reshape(B * nb, D * R * bs // word).view(torch.int8)
    if fstep.dim() == 3:  # kernel layout: (ncols*bs, D*R*bs) is fmat transposed
        fmat = fstep.permute(1, 0, 2).reshape(ncols * bs, D * R * bs).t()
    else:
        fmat = fstep
    prod = poly.int8_matmul(dexp, fmat).reshape(B, nb, ncols, bs)
    comb = torch.zeros((B, nb, C, bs), dtype=dtype, device=d8.device)
    # the shifts are of ``dtype``: an int64 one promotes the int32 products as it shifts them
    comb.index_add_(2, plan.col_poly, prod << plan.col_shift.to(dtype))
    return comb.movedim(1, 2).reshape(B, C, geom.N)


def stack_blocks(blocks: list) -> torch.Tensor:
    """The int8 limb blocks of ``poly.digits_to_i8_rows`` as one (nl, ...)
    tensor (a view when there is one block)."""
    return torch.stack(blocks) if len(blocks) > 1 else blocks[0][None]


def contract_blocks_fblock(blocks: torch.Tensor, fstep: torch.Tensor, geom: FBlockGeometry,
                           dtype: torch.dtype) -> torch.Tensor:
    """Contract the int8 limb blocks of digit rows against one expanded
    F-block step: blocks (nl, B, R, N), block m the byte limb m of each digit
    (``stack_blocks``). Returns (B, C, N) ``dtype``: sum_m (the block's
    contraction) << 8m. The blocks are stacked along the batch, so this is
    one matmul whatever the digit width; integer sums, so the words are
    those of one contraction per block."""
    nl, B, _, N = blocks.shape
    delta = contract_rows_fblock(blocks.reshape(nl * B, geom.R, N), fstep, geom, dtype)
    if nl == 1:
        return delta
    delta = delta.reshape(nl, B, geom.C, N)
    # an int32 sum is taken in int64, then wraps
    return (delta << _limb_shifts(nl, dtype, blocks.device)).sum(0).to(dtype)


def apply_fblock(t: torch.Tensor, fstep: torch.Tensor, geom: FBlockGeometry,
                 decomp_length: int, log2_base: int, offset: int) -> torch.Tensor:
    """delta[c] = sum_r g(t)_r (*) K_{r,c}: gadget-decompose a (B, C, N)
    input and contract against one expanded F-block step, in t's dtype.

    Digits wider than a byte split into int8 limb blocks
    (``poly.digits_to_i8_rows``) whose products are shifted by 8m and summed
    (``contract_blocks_fblock``)."""
    B, C, N = t.shape
    digits = poly.decompose(t, decomp_length, log2_base, geom.bits, offset)
    rows = digits.transpose(-3, -2).reshape(B, geom.R, N)  # rows r = (level, poly)
    return contract_blocks_fblock(stack_blocks(poly.digits_to_i8_rows(rows, log2_base)), fstep,
                                  geom, t.dtype)


def stepvec_acc0(mu: int, barb: torch.Tensor, geom: FBlockGeometry) -> torch.Tensor:
    """The gate test vector X^-barb * (0, ..., 0, [mu..mu]) as a (B, C, N)
    accumulator in the torus dtype of ``geom`` (int32, or int64 at 64 bits):
    mask polys zero, the body the rotated constant."""
    B = barb.shape[0]
    dtype = torch.int32 if geom.bits <= 32 else torch.int64
    tv = torch.full((B, geom.N), int(mu), dtype=dtype, device=barb.device)
    acc = torch.zeros((B, geom.C, geom.N), dtype=dtype, device=barb.device)
    acc[:, geom.C - 1] = poly.mul_by_monomial(tv, -barb.to(torch.int64))
    return acc


def blind_rotate_fblock(acc_a, fb: torch.Tensor, bara: torch.Tensor,
                        geom: FBlockGeometry, decomp_length: int, log2_base: int,
                        offset: int, stepvec=None) -> torch.Tensor:
    """The CMux chain over the F-block key, one Python step at a time.

    acc_a: (B, C, N) in the torus dtype of ``geom`` (int32, or int64 at 64
    bits), or None with ``stepvec=(mu, barb)`` (barb (B,) int32) to start
    from the gate test vector; fb: (n, D*R*bs, ncols*bs) int8, or the kernel
    layout (n, D, ncols*bs, R*bs); bara: (B, n) int32. Per step: acc +=
    F-block product of the decomposed (X^bara - 1) * acc, with digits of any
    width (``apply_fblock``). Returns (B, C, N) in the same dtype.
    """
    acc = stepvec_acc0(stepvec[0], stepvec[1], geom) if acc_a is None else acc_a
    for s in range(fb.shape[0]):
        rot = poly.mul_by_monomial(acc, bara[:, s])
        acc = acc + apply_fblock(rot - acc, fb[s], geom, decomp_length,
                                 log2_base, offset)
    return acc


def blind_rotate_streamed(acc_a, sel: torch.Tensor, bara: torch.Tensor,
                          geom: FBlockGeometry, decomp_length: int, log2_base: int,
                          offset: int, *, chunk: int = 64, stepvec=None) -> torch.Tensor:
    """The CMux chain over the COMPACT key, expanding F-blocks chunk by
    chunk: the plain version of the compact-key kernel
    (ops/cuda_rotate.blind_rotate_sel_cuda), and the route of the 64-bit
    torus and of digits wider than a byte, which no kernel takes.

    sel: (steps, R, 2N, ncols) int8 (``build_sel``), or the compact kernel
    layout (steps, ncols, R, 2N), which is turned back chunk by chunk; bara:
    (B, steps) int32; acc_a: (B, C, N) in the torus dtype of ``geom``, or
    None with ``stepvec=(mu, barb)``. Each chunk of at most ``chunk`` steps is
    expanded and goes through ``blind_rotate_fblock`` (the JAX package pads
    the steps to whole chunks with identity steps for its scan; a Python loop
    needs none, and the words are the same); one expanded chunk is
    alive at a time. On a CUDA device a chunk is expanded into the kernel
    layout, whose steps give ``torch._int_mm`` the key side with its
    reduction index contiguous: cuBLASLt has its tensor-core int8 kernels
    for that form only (a row-major key side ran at 6% of the card's int8
    peak on an H100). Returns (B, C, N), word-equal to
    ``blind_rotate_fblock`` over the expanded key.
    """
    steps = sel.shape[0]
    acc = stepvec_acc0(stepvec[0], stepvec[1], geom) if acc_a is None else acc_a
    kernel_layout = tuple(sel.shape[1:]) == sel_kernel_layout_shape(geom)
    for s0 in range(0, steps, chunk):
        lines, bara_k = sel[s0:s0 + chunk], bara[:, s0:s0 + chunk]
        expand = expand_kernel_chunk if lines.is_cuda else expand_fblock_chunk
        fb_k = expand(from_sel_kernel_layout(lines, geom) if kernel_layout else lines, geom)
        acc = blind_rotate_fblock(acc, fb_k, bara_k, geom, decomp_length, log2_base, offset)
        del fb_k
    return acc

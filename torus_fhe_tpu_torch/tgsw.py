"""TGSW (gadget) samples and the external product.

Port of torus_fhe_tpu/tgsw.py. A TGSW sample is the array of (l, k+1) RLWE
rows; its packed form is the int8 limb kernels of the exact product
ops/poly.negacyclic_extern_product (the digit side's Toeplitz rows against
the kernels), which the scan route of the blind rotate reads
(boot/bootstrap.mux_rotate). The F-block form of the same samples is
ops/fblock's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .core.params import RLweParams, TGswParams
from .ops import poly
from .rlwe import RLweKey, RLweSample, rlwe_encrypt_zero


class TGswSample(NamedTuple):
    """Raw TGSW: samples[..., i, j, :, :] is RLWE row (i in l, j in k+1)."""

    samples: torch.Tensor  # (..., l, k+1, k+1, N) torus


@dataclass
class PackedTGsw:
    """TGSW packed for ``poly.negacyclic_extern_product``.

    kernels: (..., (k+1) * (n_limbs - limb_offset), l*(k+1), N) int8:
    out-features first, reduction rows (i, j) second, flipped window last.
    ``limb_offset``: the low kernel limbs dropped (``pack_tgsw``'s
    ``drop_limbs``).
    """

    kernels: torch.Tensor
    bits: int = 32
    mask_size: int = 1
    limb_offset: int = 0


def tgsw_encrypt(generator: torch.Generator, messages: torch.Tensor, alpha: float,
                 rlwe_key: RLweKey, tgsw_params: TGswParams,
                 rlwe_params: RLweParams, body_round_bits: int = 0,
                 device=None) -> TGswSample:
    """Encrypt int messages (any leading shape) as TGSW samples: a zero
    encryption per row plus message * gadget on the block diagonal (constant
    coefficient only). Output gains (l, k+1, k+1, N) trailing dims."""
    shape = tuple(messages.shape)
    l = tgsw_params.decomp_length
    k = rlwe_params.mask_size
    a = rlwe_encrypt_zero(generator, alpha, rlwe_key, rlwe_params, shape + (l, k + 1),
                          body_round_bits=body_round_bits).a  # host
    dtype = a.dtype
    gadget = torch.tensor(tgsw_params.gadget_values, dtype=dtype)  # (l,)
    msg = messages.cpu().to(dtype)[..., None] * gadget  # (..., l)
    eye = torch.eye(k + 1, dtype=dtype)
    bump = msg[..., :, None, None] * eye  # (..., l, k+1, k+1)
    a[..., 0] += bump
    return TGswSample(a.to(device))


def pack_tgsw(sample: TGswSample, tgsw_params: TGswParams, drop_limbs: int = 0) -> PackedTGsw:
    """Pack TGSW samples into limb kernels, on the host, placed back on the
    samples' device: kernels[r=(i,j), c=poly] = samples[i, j, poly], the
    layout of ``poly.pack_kernels_host`` (``drop_limbs`` low limbs dropped)."""
    arr = sample.samples
    *lead, l, kp1, kp1_, N = arr.shape
    if kp1 != kp1_:
        raise ValueError(f"TGSW samples {tuple(arr.shape)}: want (..., l, k+1, k+1, N)")
    kern = arr.cpu().numpy().reshape(*lead, l * kp1, kp1, N)  # (..., R, C, N)
    packed = poly.pack_kernels_host(kern, tgsw_params.bits, drop_limbs)
    return PackedTGsw(torch.from_numpy(packed).to(arr.device), tgsw_params.bits, kp1 - 1,
                      drop_limbs)


def tgsw_decompose_rlwe(accum: RLweSample, tgsw_params: TGswParams) -> list:
    """Gadget-decompose the k+1 polys of a batch of RLWE samples into int8
    digit rows. accum.a: (B, k+1, N). Returns the digits' byte-limb blocks
    (one block for digits of at most a byte), each (B, l*(k+1), N) int8 with
    row index (i-th digit, j-th poly), ``pack_tgsw``'s reduction layout."""
    digits = poly.decompose(accum.a, tgsw_params.decomp_length, tgsw_params.log2_base,
                            tgsw_params.bits, tgsw_params.offset)  # (B, k+1, l, N)
    digits = digits.transpose(-3, -2)  # (B, l, k+1, N): rows (i, j)
    return [blk.reshape(blk.shape[:-3] + (-1, blk.shape[-1]))
            for blk in poly.digits_to_i8_rows(digits, tgsw_params.log2_base)]


def tgsw_extern_mul(accum: RLweSample, gsw: PackedTGsw, tgsw_params: TGswParams) -> RLweSample:
    """The external product gsw (*) accum, exact. accum.a: (B, k+1, N);
    gsw.kernels: ((k+1)*limbs, l*(k+1), N), on accum's device. Digit block m
    contributes its product shifted by 8m."""
    total = None
    for m, rows in enumerate(tgsw_decompose_rlwe(accum, tgsw_params)):
        prod = poly.negacyclic_extern_product(rows, gsw.kernels, gsw.bits, gsw.mask_size + 1,
                                              gsw.limb_offset)
        if m:
            prod = prod << (8 * m)
        total = prod if total is None else total + prod
    return RLweSample(total)

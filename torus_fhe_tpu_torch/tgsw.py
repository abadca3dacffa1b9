"""TGSW (gadget) samples.

Port of the encryption half of torus_fhe_tpu/tgsw.py. The external product
runs in the F-block form (ops/fblock.py), so no other packed form exists here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .core.params import RLweParams, TGswParams
from .rlwe import RLweKey, rlwe_encrypt_zero


class TGswSample(NamedTuple):
    """Raw TGSW: samples[..., i, j, :, :] is RLWE row (i in l, j in k+1)."""

    samples: torch.Tensor  # (..., l, k+1, k+1, N) torus


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

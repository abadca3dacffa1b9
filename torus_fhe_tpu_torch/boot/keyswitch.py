"""LWE key switching as a one-hot int8 matrix product.

Port of torus_fhe_tpu/boot/keyswitch.py: the reference's n_in x l digit
lookups into a table of LWE samples become one (B, K) @ (K, (n_out+1)*4) int8
product of a {0,1} one-hot matrix with the byte-limb-split table, exact in
int32 (torch._int_mm; the JAX package leaves this product to XLA, outside any
Pallas kernel). h = 0 digits select no row, as the reference skips them.
A keyswitch (this one, or mk/boot3gen's multikey one) runs inside an
``fhe.keyswitch`` span (utils/profiling.span).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import rng
from ..core.device import resolve_device
from ..core.params import KeyswitchParams
from ..core.torus import double_to_torus
from ..lwe import LweKey, LweSample
from ..ops import poly
from ..utils.profiling import spanned


@dataclass
class KeyswitchKey:
    # (n_in * l * (base-1), cols) int8 limb table; cols is (n_out + 1) * 4
    # rounded up to a multiple of 8 with zero columns (torch._int_mm on CUDA)
    mat: torch.Tensor
    n_in: int = 0
    n_out: int = 0


def pad_table(mat: torch.Tensor) -> torch.Tensor:
    """Zero columns up to a multiple of 8."""
    pad = (-mat.shape[1]) % 8
    return torch.cat([mat, mat.new_zeros((mat.shape[0], pad))], dim=1) if pad else mat


def keyswitch_keygen(generator: torch.Generator, alpha: float, params: KeyswitchParams,
                     out_key: LweKey, in_key: LweKey, device=None) -> KeyswitchKey:
    """ks[i, j, h] = LWE_out((s_in[i] * h) << (32 - j*log2_base)) with
    re-centred gaussian noise, split into byte limbs on the host; the table
    goes to ``device`` (None: the card, core/device.resolve_device)."""
    device = resolve_device(device)
    n_in, n_out = in_key.size, out_key.size
    l = params.decomp_length
    base = 1 << params.log2_base
    noise = rng.gaussian_float(generator, alpha, (n_in, l, base - 1))
    noise = noise - noise.mean()
    a = rng.uniform_torus(generator, (n_in, l, base - 1, n_out)).cpu()
    s_in = in_key.key.cpu().to(torch.int32)
    h = torch.arange(1, base, dtype=torch.int32)
    j = torch.arange(1, l + 1, dtype=torch.int32)
    msg = (s_in[:, None, None] * h[None, None, :]) << (32 - j[None, :, None] * params.log2_base)
    b = msg + double_to_torus(noise.cpu()) + torch.sum(a * out_key.key.cpu(), dim=-1,
                                                       dtype=torch.int32)
    table = torch.cat([a, b[..., None]], dim=-1).reshape(n_in * l * (base - 1), n_out + 1)
    mat = poly.limb_split_signed_host(table.numpy(), 32)  # (K, n_out+1, 4)
    mat = torch.from_numpy(np.ascontiguousarray(mat.reshape(mat.shape[0], -1)))
    return KeyswitchKey(pad_table(mat).to(device), n_in, n_out)


def digit_onehot(a: torch.Tensor, decomp_length: int, log2_base: int) -> torch.Tensor:
    """The one-hot int8 digit matrix of extracted masks ``a`` (..., n_in):
    (rows, n_in * l * (base-1)), one column a (coefficient, digit, value
    h = 1..base-1), the rows of a keyswitch table in the order they stand."""
    base = 1 << log2_base
    aibar = a + (1 << (32 - (1 + log2_base * decomp_length)))  # precision offset, wraps
    shifts = 32 - torch.arange(1, decomp_length + 1, dtype=torch.int32,
                               device=a.device) * log2_base
    digits = (aibar[..., None] >> shifts) & (base - 1)  # (..., n_in, l)
    h = torch.arange(1, base, dtype=torch.int32, device=a.device)
    return (digits[..., None] == h).to(torch.int8).reshape(
        -1, a.shape[-1] * decomp_length * (base - 1))


@spanned("fhe.keyswitch")
def keyswitch(ks: KeyswitchKey, params: KeyswitchParams, sample: LweSample) -> LweSample:
    """Batched keyswitch. sample.a: (..., n_in) over the extracted key."""
    lead = tuple(sample.b.shape)
    onehot = digit_onehot(sample.a, params.decomp_length, params.log2_base)
    deltas = poly.int8_matmul(onehot, ks.mat)[:, :(ks.n_out + 1) * 4]
    deltas = poly.limb_combine(deltas.reshape(lead + (ks.n_out + 1, 4)), 32)
    return LweSample(-deltas[..., :ks.n_out], sample.b - deltas[..., ks.n_out])

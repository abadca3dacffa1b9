"""LWE -> RLWE ciphertext packing (a packing keyswitch).

Port of torus_fhe_tpu/boot/pack.py. m <= N LWE ciphertexts {(a_i, b_i)}
under key s become ONE RLWE ciphertext whose phase polynomial carries
phase_i = b_i - <a_i, s> at coefficient i. The key publishes
KSK_{j,r} = RLWE_S(s_j * g_r) for every input key coefficient j and gadget
level r; with A_j(X) = sum_i a_{i,j} X^i and B(X) = sum_i b_i X^i,

    pack = (0, B) - sum_{j,r} g_r(A_j) (*) KSK_{j,r}

has phase sum_i phase_i X^i minus the packing noise. The double sum is one
exact int8 contraction with R = n*l rows (ops/poly.negacyclic_extern_product:
the digit-side Toeplitz rows against the compact key limbs, on the key's
device).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.params import RLweParams, TGswParams
from ..lwe import LweKey, LweSample
from ..ops import poly
from ..rlwe import RLweKey, RLweSample, rlwe_encrypt_zero


@dataclass
class PackingKey:
    """kernels: the int8 limbs of the n*l KSK rows, ((k+1)*limbs, n*l, N),
    from ops/poly.pack_kernels_host (the JAX package's layout)."""

    kernels: torch.Tensor
    n_in: int = 0
    decomp_length: int = 0
    log2_base: int = 0
    bits: int = 32
    mask_size: int = 1


def packing_keyswitch_keygen(generator: torch.Generator, alpha: float, lwe_key: LweKey,
                             rlwe_key: RLweKey, rlwe_params: RLweParams,
                             decomp_length: int = 3, log2_base: int = 8,
                             device=None) -> PackingKey:
    """Gadget encryptions of every input key coefficient under the ring key:
    sampling on the generator's device, the exact products on the host (like
    tgsw_encrypt); the packed key on ``device`` (None: the card,
    core/device.resolve_device)."""
    if log2_base > 8:
        raise ValueError(f"int8 digit rows need byte-sized gadget digits, not 2^{log2_base}")
    n = lwe_key.size
    tg = TGswParams(decomp_length, log2_base, rlwe_params.bits)
    zero = rlwe_encrypt_zero(generator, alpha, rlwe_key, rlwe_params, (n, decomp_length))
    a = zero.a.numpy()  # (n, l, k+1, N), a fresh array
    gadget = np.asarray(tg.gadget_values, a.dtype)
    s = lwe_key.key.cpu().numpy().astype(a.dtype)
    with np.errstate(over="ignore"):
        a[..., -1, 0] += s[:, None] * gadget[None, :]
    kern = a.reshape(n * decomp_length, a.shape[-2], a.shape[-1])  # (R, C, N)
    packed = poly.pack_kernels_host(kern, rlwe_params.bits)
    return PackingKey(torch.from_numpy(packed).to(resolve_device(device)), n, decomp_length,
                      log2_base, rlwe_params.bits, rlwe_params.mask_size)


def pack_lwes(pk: PackingKey, samples: LweSample, N: int) -> RLweSample:
    """Pack m <= N LWE samples into one degree-N RLWE sample.

    samples: a (..., m, n), b (..., m). Returns an RLweSample (..., k+1, N)
    whose phase coefficient i is the i-th input's phase (coefficients i >= m
    hold only packing noise).
    """
    tg = TGswParams(pk.decomp_length, pk.log2_base, pk.bits)
    dtype = torch.int32 if pk.bits == 32 else torch.int64
    a, b = samples.a.to(dtype), samples.b.to(dtype)
    *lead, m, n = a.shape
    if n != pk.n_in or m > N:
        raise ValueError(f"samples {tuple(a.shape)} for a key of {pk.n_in} inputs into N={N}")
    B = int(np.prod(lead)) if lead else 1
    A = torch.nn.functional.pad(a.reshape(B, m, n).transpose(-1, -2), (0, N - m))  # (B, n, N)
    digits = poly.decompose(A, tg.decomp_length, tg.log2_base, tg.bits, tg.offset)
    rows = digits.reshape(B, n * tg.decomp_length, N).to(torch.int8)
    delta = poly.negacyclic_extern_product(rows, pk.kernels, pk.bits, pk.mask_size + 1)
    out = -delta
    out[:, -1] += torch.nn.functional.pad(b.reshape(B, m), (0, N - m))
    return RLweSample(out.reshape(tuple(lead) + out.shape[1:]) if lead else out[0])

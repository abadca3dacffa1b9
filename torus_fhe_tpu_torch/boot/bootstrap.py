"""Gate bootstrapping: mod-switch, blind rotate, extract.

Port of torus_fhe_tpu/boot/bootstrap.py in its F-block form. The blind rotate
runs where the key lives: a bootstrapping key on a CUDA device goes through
the Hopper kernel (ops/cuda_rotate.py), one on the CPU through the plain
version (ops/fblock.blind_rotate_fblock). A set with gadget digits wider than
a byte (tfhe_80, Bg = 2^10) takes the torch-op scan on either device
(ops/cuda_rotate.takes_kernel_route). There is no backend switch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.device import resolve_device
from ..core.params import SchemeParams
from ..core.torus import decode_message
from ..lwe import LweKey, LweSample
from ..ops import fblock
from ..ops.cuda_rotate import rotate
from ..ops.poly import mul_by_monomial
from ..rlwe import RLweKey, RLweSample, rlwe_extract_sample, rlwe_noiseless_trivial
from ..tgsw import tgsw_encrypt
from .keyswitch import KeyswitchKey, keyswitch


class BootstrapKey(NamedTuple):
    """n TGSW encryptions of the LWE key bits.

    ``fb``: the expanded F-block key, int8, on the device the rotate runs on
    (5.45 GB at tfhe_128_tpu_fast), in the form that device's rotate reads
    (``fblock.build_rotate_key``): the kernel layout (n, D, ncols*bs, R*bs)
    on a CUDA device, (n, D*R*bs, ncols*bs) on the CPU. A set whose rotate is
    the torch-op scan (digits wider than a byte, as tfhe_80) holds the same:
    on the card the scan's int8 product wants the key side with its reduction
    index contiguous, which is a step of the kernel layout with its delta
    blocks brought together (one copy of the step, ops/fblock);
    ``samples``: the compact TGSW samples (n, l, k+1, k+1, N) int32, on the
    host, from which ``fb`` is built.
    """

    fb: torch.Tensor
    samples: torch.Tensor


def bk_geometry(params: SchemeParams) -> fblock.FBlockGeometry:
    return fblock.fblock_geometry(
        params.lwe_size, params.rlwe_polynomial_degree, params.rlwe_mask_size,
        params.bs_decomp_length, params.rlwe_bits, params.bk_drop_limbs)


def bootstrap_key_from_samples(samples: torch.Tensor, params: SchemeParams,
                               device=None) -> BootstrapKey:
    """Expand compact TGSW samples into the F-block key on ``device`` (None:
    the card, core/device.resolve_device; ``"cpu"``: the CPU)."""
    device = resolve_device(device)
    samples = samples.cpu()
    return BootstrapKey(fblock.build_rotate_key(samples.numpy(), bk_geometry(params), device),
                        samples)


def bootstrap_keygen(generator: torch.Generator, alpha: float, lwe_key: LweKey,
                     rlwe_key: RLweKey, params: SchemeParams, device=None) -> BootstrapKey:
    """TGSW-encrypt each LWE key bit under the RLWE key (sampling and exact
    products on the host), then build the F-block key on ``device`` (None:
    the card). The body is rounded to the dropped bytes' scale (``bk_drop_limbs``)."""
    if params.bk_mask_quantum_bits:
        raise ValueError("quantized-mask bootstrapping keys are insecure (key "
                         "recovery by rounding and linear algebra) and withdrawn")
    device = resolve_device(device)
    gsw = tgsw_encrypt(generator, lwe_key.key, alpha, rlwe_key, params.tgsw,
                       params.rlwe, body_round_bits=8 * params.bk_drop_limbs)
    return bootstrap_key_from_samples(gsw.samples, params, device)


def blind_rotate(accum: RLweSample, bk: BootstrapKey, bara: torch.Tensor,
                 params: SchemeParams) -> RLweSample:
    """Multiply accum (B, k+1, N) by X^{<bara, s>} via the CMux chain;
    bara: (B, n) int32."""
    tg = params.tgsw
    return RLweSample(rotate(accum.a, bk.fb, bara, bk_geometry(params),
                             tg.decomp_length, tg.log2_base, tg.offset))


def blind_rotate_and_extract(v: torch.Tensor, bk: BootstrapKey, barb: torch.Tensor,
                             bara: torch.Tensor, params: SchemeParams) -> LweSample:
    """LWE of v[phase]: v (N,) or (B, N) test polynomial, barb (B,),
    bara (B, n)."""
    B = bara.shape[0]
    v = torch.as_tensor(v, dtype=torch.int32, device=bara.device).expand(
        B, params.rlwe_polynomial_degree)
    accum = rlwe_noiseless_trivial(mul_by_monomial(v, -barb.to(torch.int64)),
                                   params.rlwe, (B,))
    return rlwe_extract_sample(blind_rotate(accum, bk, bara, params))


def bootstrap_wo_keyswitch(bk: BootstrapKey, mu: int, x: LweSample,
                           params: SchemeParams) -> LweSample:
    """Mod-switch to Z_2N, then blind-rotate the [mu..mu] test vector, built
    by the rotate itself from barb (stepvec mode), and extract. Any leading
    batch shape."""
    N = params.rlwe_polynomial_degree
    lead = tuple(x.b.shape)
    bara = decode_message(x.a, 2 * N).reshape(-1, x.a.shape[-1])
    barb = decode_message(x.b, 2 * N).reshape(-1)
    tg = params.tgsw
    acc = rotate(None, bk.fb, bara, bk_geometry(params), tg.decomp_length,
                 tg.log2_base, tg.offset, stepvec=(int(mu), barb))
    u = rlwe_extract_sample(RLweSample(acc))
    return LweSample(u.a.reshape(lead + u.a.shape[-1:]), u.b.reshape(lead))


def bootstrap(bk: BootstrapKey, ks: KeyswitchKey, mu: int, x: LweSample, params: SchemeParams) -> LweSample:
    """Full gate bootstrap: rotate-extract, then keyswitch."""
    return keyswitch(ks, params.ks, bootstrap_wo_keyswitch(bk, mu, x, params))

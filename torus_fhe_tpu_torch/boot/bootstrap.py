"""Gate bootstrapping: mod-switch, blind rotate, extract.

Port of torus_fhe_tpu/boot/bootstrap.py. The bootstrapping key holds one or
both of two forms, each built from the compact TGSW samples: the expanded
F-block key (``fblock``) and the packed TGSW kernels (``conv``, the JAX
package's default). The blind rotate runs one of three routes, picked by
``set_rotate_backend`` ("auto" by default, resolved by ``_resolve_backend``
as in the JAX package):

- ``"pallas"``: the Hopper kernel (ops/cuda_rotate.py) over the F-block key,
  the JAX package's Pallas kernel; on CPU tensors the kernel's plain version
  (ops/fblock.blind_rotate_fblock). A set with gadget digits wider than a
  byte (tfhe_80, Bg = 2^10) takes the torch-op F-block scan there on either
  device (ops/cuda_rotate.takes_kernel_route);
- ``"fblock"``: the plain F-block scan ``fblock.blind_rotate_fblock``, torch
  ops on the key's device;
- ``"scan"``: the CMux chain of ``mux_rotate`` over the packed kernels, one
  TGSW external product a step (tgsw.tgsw_extern_mul: the exact int8
  product of ops/poly, torch ops on the key's device; the JAX package's
  lax.scan of XLA convolutions, outside Pallas).

"auto" is "pallas" for an F-block key whose rotate the kernel takes (the
32-bit torus, digits of at most a byte), "fblock" for another F-block key,
and "scan" for a key that holds only the conv form. Every route gives the
same words. This package's keygens build the F-block form unless ``forms``
asks for ``conv``. Each route's CMux chain runs inside an ``fhe.rotate`` span
(utils/profiling.span).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.device import resolve_device
from ..core.params import SchemeParams
from ..core.torus import decode_message
from ..lwe import LweKey, LweSample
from ..ops import fblock
from ..ops.cuda_rotate import rotate, takes_kernel_route
from ..ops.poly import mul_by_monomial
from ..rlwe import RLweKey, RLweSample, rlwe_extract_sample, rlwe_noiseless_trivial
from ..tgsw import PackedTGsw, TGswSample, pack_tgsw, tgsw_encrypt, tgsw_extern_mul
from ..utils.profiling import span
from .keyswitch import KeyswitchKey, keyswitch

FORMS = ("conv", "fblock")
BACKENDS = ("auto", "scan", "fblock", "pallas")


class BootstrapKey(NamedTuple):
    """n TGSW encryptions of the LWE key bits, in one or both forms.

    ``kernels``: the conv form, the packed TGSW kernels (n, (k+1)*limbs,
    l*(k+1), N) int8 (``tgsw.pack_tgsw``, full limbs), on the rotate's
    device (23.2 MB at tfhe_128_tpu_fast); ``fb``: the expanded F-block key,
    int8, on the rotate's device (5.45 GB at tfhe_128_tpu_fast), in the form
    that device's rotate reads (``fblock.build_rotate_key``): the kernel
    layout (n, D, ncols*bs, R*bs) on a CUDA device, (n, D*R*bs, ncols*bs) on
    the CPU. A set whose F-block rotate is the torch-op scan (digits wider
    than a byte, as tfhe_80) holds the same: on the card the scan's int8
    product wants the key side with its reduction index contiguous, which is
    a step of the kernel layout with its delta blocks brought together (one
    copy of the step, ops/fblock); ``samples``: the compact TGSW samples
    (n, l, k+1, k+1, N) int32, on the host, from which either form is built.
    """

    kernels: Optional[torch.Tensor] = None
    fb: Optional[torch.Tensor] = None
    samples: Optional[torch.Tensor] = None


_ROTATE_BACKEND = "auto"


def set_rotate_backend(name: str) -> None:
    """Select the blind-rotate route for every later bootstrap, the 3gen
    multikey one included: "auto", "scan", "fblock" or "pallas" (module
    docstring)."""
    global _ROTATE_BACKEND
    if name not in BACKENDS:
        raise ValueError(f"rotate backend {name!r}: one of {BACKENDS}")
    _ROTATE_BACKEND = name


def get_rotate_backend() -> str:
    return _ROTATE_BACKEND


def bk_geometry(params: SchemeParams) -> fblock.FBlockGeometry:
    return fblock.fblock_geometry(
        params.lwe_size, params.rlwe_polynomial_degree, params.rlwe_mask_size,
        params.bs_decomp_length, params.rlwe_bits, params.bk_drop_limbs)


def check_forms(forms) -> tuple:
    forms = tuple(forms)
    if not forms or set(forms) - set(FORMS):
        raise ValueError(f"forms {forms}: this package builds the bootstrapping key in {FORMS}")
    return forms


def rebuild_bk_forms(samples: torch.Tensor, params: SchemeParams, forms=("fblock",),
                     device=None) -> BootstrapKey:
    """Build ``forms`` of the bootstrapping key from compact TGSW samples,
    on ``device`` (None: the card, core/device.resolve_device; ``"cpu"``: the
    CPU): "conv" packs the kernels full-limb (the body's rounded low bytes
    are zero, so no limb is dropped), "fblock" expands the F-block key."""
    forms = check_forms(forms)
    device = resolve_device(device)
    samples = samples.cpu()
    kernels = fb = None
    if "conv" in forms:
        kernels = pack_tgsw(TGswSample(samples), params.tgsw, 0).kernels.to(device)
    if "fblock" in forms:
        fb = fblock.build_rotate_key(samples.numpy(), bk_geometry(params), device)
    return BootstrapKey(kernels, fb, samples)


def bootstrap_keygen(generator: torch.Generator, alpha: float, lwe_key: LweKey,
                     rlwe_key: RLweKey, params: SchemeParams, device=None,
                     forms=("fblock",)) -> BootstrapKey:
    """TGSW-encrypt each LWE key bit under the RLWE key (sampling and exact
    products on the host), then build ``forms`` on ``device`` (None: the
    card). The body is rounded to the dropped bytes' scale (``bk_drop_limbs``)."""
    if params.bk_mask_quantum_bits:
        raise ValueError("quantized-mask bootstrapping keys are insecure (key "
                         "recovery by rounding and linear algebra) and withdrawn")
    forms = check_forms(forms)
    device = resolve_device(device)
    gsw = tgsw_encrypt(generator, lwe_key.key, alpha, rlwe_key, params.tgsw,
                       params.rlwe, body_round_bits=8 * params.bk_drop_limbs)
    return rebuild_bk_forms(gsw.samples, params, forms, device)


def _resolve_backend(bk: BootstrapKey, params: SchemeParams) -> str:
    backend = _ROTATE_BACKEND
    if backend == "auto":
        if bk.fb is None:
            backend = "scan"
        elif takes_kernel_route(bk_geometry(params), params.bs_log2_base):
            backend = "pallas"
        else:
            backend = "fblock"
    return backend


def mux_rotate(accum: RLweSample, kernels_i: torch.Tensor, barai: torch.Tensor,
               params: SchemeParams) -> RLweSample:
    """One CMux step: accum += BK_i (*) [(X^bara_i - 1) * accum]. accum.a:
    (B, k+1, N); kernels_i: step i's conv kernels; barai: (B,). The kernels
    are packed full-limb, so the product drops no limb."""
    temp = RLweSample(mul_by_monomial(accum.a, barai) - accum.a)
    gsw = PackedTGsw(kernels_i, params.rlwe_bits, params.rlwe_mask_size, 0)
    return RLweSample(accum.a + tgsw_extern_mul(temp, gsw, params.tgsw).a)


def blind_rotate(accum: RLweSample, bk: BootstrapKey, bara: torch.Tensor,
                 params: SchemeParams) -> RLweSample:
    """Multiply accum (B, k+1, N) by X^{<bara, s>} via the CMux chain;
    bara: (B, n) int32. The route is the configured backend's."""
    backend = _resolve_backend(bk, params)
    if backend == "scan":
        if bk.kernels is None:
            raise ValueError("the scan backend needs the conv form of the bootstrapping key")
        with span("fhe.rotate"):
            for i in range(bk.kernels.shape[0]):
                accum = mux_rotate(accum, bk.kernels[i], bara[:, i], params)
        return accum
    if bk.fb is None:
        raise ValueError(f"the {backend} backend needs the fblock form of the bootstrapping key")
    tg = params.tgsw
    args = (accum.a, bk.fb, bara, bk_geometry(params), tg.decomp_length, tg.log2_base, tg.offset)
    if backend == "pallas":
        return RLweSample(rotate(*args))
    with span("fhe.rotate"):
        return RLweSample(fblock.blind_rotate_fblock(*args))


def blind_rotate_and_extract(v: torch.Tensor, bk: BootstrapKey, barb: torch.Tensor,
                             bara: torch.Tensor, params: SchemeParams) -> LweSample:
    """LWE of v[phase]: v (N,) or (B, N) test polynomial, barb (B,),
    bara (B, n)."""
    B = bara.shape[0]
    v = torch.as_tensor(v, dtype=params.rlwe.torus_dtype, device=bara.device).expand(
        B, params.rlwe_polynomial_degree)
    accum = rlwe_noiseless_trivial(mul_by_monomial(v, -barb.to(torch.int64)),
                                   params.rlwe, (B,))
    return rlwe_extract_sample(blind_rotate(accum, bk, bara, params))


def bootstrap_wo_keyswitch(bk: BootstrapKey, mu: int, x: LweSample,
                           params: SchemeParams) -> LweSample:
    """Mod-switch to Z_2N, then blind-rotate the [mu..mu] test vector and
    extract. Any leading batch shape. Where the route is the kernel's
    ("pallas"), the rotate builds the test vector itself from barb (stepvec
    mode), as the JAX package's Pallas route does; the other routes start
    from the explicit accumulator."""
    N = params.rlwe_polynomial_degree
    lead = tuple(x.b.shape)
    bara = decode_message(x.a, 2 * N).reshape(-1, x.a.shape[-1])
    barb = decode_message(x.b, 2 * N).reshape(-1)
    if _resolve_backend(bk, params) == "pallas" and bk.fb is not None:
        tg = params.tgsw
        acc = rotate(None, bk.fb, bara, bk_geometry(params), tg.decomp_length,
                     tg.log2_base, tg.offset, stepvec=(int(mu), barb))
        u = rlwe_extract_sample(RLweSample(acc))
    else:
        testvect = torch.full((N,), int(mu), dtype=params.rlwe.torus_dtype, device=bara.device)
        u = blind_rotate_and_extract(testvect, bk, barb, bara, params)
    return LweSample(u.a.reshape(lead + u.a.shape[-1:]), u.b.reshape(lead))


def bootstrap(bk: BootstrapKey, ks: KeyswitchKey, mu: int, x: LweSample, params: SchemeParams) -> LweSample:
    """Full gate bootstrap: rotate-extract, then keyswitch."""
    return keyswitch(ks, params.ks, bootstrap_wo_keyswitch(bk, mu, x, params))

"""3rd-generation (AKÖ) multikey TFHE key material.

Port of torus_fhe_tpu/mk/keys3gen.py. The keygen pipeline is

  CRP a  ->  per-party public key b_p = s_p (*) a + e  ->  common key b = sum_p b_p
         ->  per-party bootstrapping part: TGSW_3gen(LWE key bits) under (b, a)
         ->  per-party keyswitch key extract(s_p) -> lwe_p.

The AKÖ 4-part TGSW sample is packed as a standard TGSW kernel tensor
(l, 2, 2, N): samples[i, mask] = (part_3[i], part_2[i]), samples[i, body] =
(part_4[i], part_1[i]), so the 3gen external product is the single-key one
and the blind rotate is one chain of parties*n CMux steps, party-major.

At the sets with byte-sized digits (2 to 8 parties, ``mk_fb_supported``) the
64-bit key is rounded to its hi word (``hi_round_samples``) and runs as a
32-bit F-block key: ``fblock`` expands it (``bk_fb``, the Hopper kernel of
ops/cuda_rotate.blind_rotate_cuda), ``fbstream`` keeps the compact lines
(``bk_fb_sel``, 256x smaller; the compact-key kernel
ops/cuda_rotate.blind_rotate_sel_cuda). At the wide-digit sets (16 parties
and up: l = 1 or 2, Bg = 2^18 to 2^27) that rounding is noise-unsafe: every
product multiplies the +-2^-33 rounding of a key entry by a digit of up to
Bg/2. They take ``fbstream`` only, as the compact lines of the RAW 64-bit
samples under ``mk_fb64_geometry`` (16 limb columns), and their rotate is the
exact 64-bit torch-op scan (ops/fblock.blind_rotate_streamed). The same
exact key serves a hi-word set when it is asked for by name, ``"conv"``
(the JAX package's exact form): the compact lines of the raw 64-bit
samples, and the exact chain on the same scan, which the noise harness
(utils/noise.py, ``fast_form=False``) measures. Keygen products run on the
host in exact numpy (ops/hostmath) at 64 bits; the finished keys move to
``device`` (None: the card, core/device.resolve_device; ``"cpu"``: the
CPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..boot.keyswitch import keyswitch_keygen, pad_table
from ..core import rng
from ..core.device import resolve_device
from ..core.params import SchemeParams3Gen, TGswParams
from ..lwe import LweKey, lwe_keygen
from ..ops import fblock, hostmath
from ..rlwe import RLweKey, extract_lwe_key, rlwe_keygen

EXPANDED_KEY_LIMIT = 10 * 2**30  # largest expanded F-block key default_forms picks


class CRP(NamedTuple):
    """Common random polynomials: one uniform 64-bit torus poly, repeated l
    times (the JAX package's default, ``a_same=True``)."""

    a: torch.Tensor  # (l, N) int64


def gen_crp(generator: torch.Generator, params: SchemeParams3Gen) -> CRP:
    l, N = params.gsw_decomp_length, params.rlwe_polynomial_degree
    one = rng.uniform_torus(generator, (1, N), params.rlwe.torus_dtype)
    return CRP(one.expand(l, N).clone())


class PublicKeyPart(NamedTuple):
    """Party p's public key b_p[i] = s_p (*) a[i] + e."""

    b: torch.Tensor  # (l, N) int64


def public_keygen(generator: torch.Generator, rlwe_key: RLweKey, crp: CRP,
                  params: SchemeParams3Gen) -> PublicKeyPart:
    a = crp.a.cpu().numpy()
    s = rlwe_key.key[0].cpu().numpy()
    prod = hostmath.negacyclic_polymul_host(s, a, params.rlwe_bits)
    noise = rng.gaussian_torus(generator, 0, params.gsw_noise_stddev, a.shape,
                               params.rlwe.torus_dtype).cpu()
    return PublicKeyPart(torch.from_numpy(prod) + noise)


def common_public_key(pubkeys: Sequence[PublicKeyPart]) -> PublicKeyPart:
    """b = sum_p b_p (wrapping)."""
    total = pubkeys[0].b
    for pk in pubkeys[1:]:
        total = total + pk.b
    return PublicKeyPart(total)


def tgsw_encrypt_3gen(generator: torch.Generator, messages, common_b: torch.Tensor,
                      crp_a: torch.Tensor, params: SchemeParams3Gen) -> np.ndarray:
    """AKÖ uni-encryption of int messages under the common public key,
    vectorised over messages. Returns the standard-TGSW-layout kernel tensor
    (M, l, 2, 2, N) as host numpy, in the ring torus width."""
    msg = np.asarray(torch.as_tensor(messages).cpu(), np.int64)
    M = msg.shape[0]
    l, N, bits = params.gsw_decomp_length, params.rlwe_polynomial_degree, params.rlwe_bits
    npdt = np.int32 if bits == 32 else np.int64
    r1 = rng.negative_binary(generator, (M, l, N)).cpu().numpy()
    r2 = rng.negative_binary(generator, (M, l, N)).cpu().numpy()
    errs = rng.gaussian_torus(generator, 0, params.gsw_noise_stddev, (4, M, l, N),
                              params.rlwe.torus_dtype).cpu().numpy()
    b = common_b.cpu().numpy().astype(npdt)
    a = crp_a.cpu().numpy().astype(npdt)
    r1b = hostmath.negacyclic_polymul_host(r1, b, bits)
    r2b = hostmath.negacyclic_polymul_host(r2, b, bits)
    r1a = hostmath.negacyclic_polymul_host(r1, a, bits)
    r2a = hostmath.negacyclic_polymul_host(r2, a, bits)
    gadget = np.asarray(TGswParams(l, params.gsw_log2_base, bits).gadget_values, npdt)
    with np.errstate(over="ignore"):
        bump = msg.astype(npdt)[:, None] * gadget  # (M, l) onto coefficient 0
        part1 = r1b + errs[0]
        part1[..., 0] += bump
        part2 = r2b + errs[1]
        part3 = r2a + errs[2]
        part3[..., 0] += bump
        part4 = r1a + errs[3]
    # samples[i, j, c]: j=0 decomposes the mask, j=1 the body; c=0 mask
    # output, c=1 body output
    samples = np.empty((M, l, 2, 2, N), npdt)
    samples[:, :, 0, 0] = part3
    samples[:, :, 0, 1] = part2
    samples[:, :, 1, 0] = part4
    samples[:, :, 1, 1] = part1
    return samples


@dataclass
class MKCloudKey:
    """Assembled multikey cloud key: the parties*n-step bootstrapping key in
    one or both fast forms, and the party-concatenated keyswitch tables.

    ``bk_fb``: the hi-word rounded key as an expanded 32-bit F-block key,
    int8: the kernel layout (parties*n, D, 8*bs, R*bs) on a CUDA device,
    (parties*n, D*R*bs, 8*bs) on the CPU (``fblock.build_rotate_key``). ``bk_fb_sel``: the same rounded key as
    compact lines, int8 (``fblock.build_sel_key``): the compact kernel
    layout (parties*n, 8, R, 2N) on a CUDA device, which
    csrc/blind_rotate_sel.cu reads, ``fblock.build_sel``'s
    (parties*n, R, 2N, 8) on the CPU. At a wide-digit set ``bk_fb_sel``
    holds the lines of the raw 64-bit samples instead, in ``build_sel``'s
    layout (parties*n, R, 2N, 16) on every device: no kernel reads them, and
    it is the layout the scan's expansion gathers from, so the card holds
    the key once and turns nothing back; a ``"conv"`` key at a hi-word set
    holds the same raw lines. ``exact``: the lines are those of the raw
    samples (a wide-digit set, or the ``"conv"`` form), so the rotate runs the
    exact 64-bit chain and launches no kernel. ``bk_samples``: the raw 64-bit
    TGSW samples (parties*n, l, 2, 2, N) on the host, with ``keep_samples``.
    ``ks_mat``: (K, parties*(n+1)*4) int8 limb tables, zero columns up to a
    multiple of 8 (torch._int_mm).
    """

    ks_mat: torch.Tensor
    parties: int
    params: SchemeParams3Gen
    bk_fb: torch.Tensor | None = None
    bk_samples: torch.Tensor | None = None
    bk_fb_sel: torch.Tensor | None = None
    exact: bool = False


def mk_fb_supported(params: SchemeParams3Gen) -> bool:
    """The hi-word 32-bit F-block key needs every gadget value to be a
    multiple of 2^32 (l*log2B <= 31) and byte-sized digits (log2B <= 8)."""
    l, lb = params.gsw_decomp_length, params.gsw_log2_base
    return params.rlwe_bits == 64 and l * lb <= 31 and lb <= 8


def mk_fb_stream_supported(params: SchemeParams3Gen) -> bool:
    """The compact form serves every 3gen set: hi-word 32-bit lines when
    ``mk_fb_supported``, else the exact 64-bit lines."""
    return params.rlwe_bits == 64


def mk_fb_geometry(params: SchemeParams3Gen, parties: int) -> fblock.FBlockGeometry:
    """32-bit (hi-word) F-block geometry over the parties*n CMux steps:
    8 limb columns, none dropped."""
    return fblock.fblock_geometry(
        parties * params.lwe_size, params.rlwe_polynomial_degree,
        params.rlwe_mask_size, params.gsw_decomp_length, 32, 0)


def mk_fb64_geometry(params: SchemeParams3Gen, parties: int) -> fblock.FBlockGeometry:
    """Exact 64-bit F-block geometry (16 limb columns, none dropped): the
    compact form of the wide-digit sets, whose key is not rounded."""
    return fblock.fblock_geometry(
        parties * params.lwe_size, params.rlwe_polynomial_degree,
        params.rlwe_mask_size, params.gsw_decomp_length, 64, 0)


def hi_round_samples(samples: np.ndarray) -> np.ndarray:
    """Round Torus64 samples to the nearest multiple of 2^32 and keep the
    top word as Torus32. With l*log2B <= 31 the gadget, the decomposition
    offset and the test vector are multiples of 2^32, so the 64-bit blind
    rotate over the rounded key is exactly a 32-bit one in the hi word."""
    u = np.asarray(samples).astype(np.uint64)
    return ((u + (1 << 31)) >> np.uint64(32)).astype(np.uint32).view(np.int32)


def default_forms(params: SchemeParams3Gen, parties: int) -> tuple:
    """The fast form the JAX package picks (apps/mk_knn.py): the expanded
    key while it is at most 10 GiB, else the compact one; the compact one
    at every wide-digit set. Never ``"conv"``: the exact route is taken by
    name only."""
    if not mk_fb_stream_supported(params):
        raise ValueError("3gen keys need a 64-bit ring torus")
    if not mk_fb_supported(params):
        return ("fbstream",)
    g = mk_fb_geometry(params, parties)
    fb_bytes = g.n * g.D * g.R * g.bs * len(g.cols) * g.bs
    return ("fblock",) if fb_bytes <= EXPANDED_KEY_LIMIT else ("fbstream",)


class MKSecretKey(NamedTuple):
    """One party's secret material: LWE key bits and a ternary ring key."""

    lwe: LweKey
    rlwe: RLweKey


def mk_party_keygen(generator: torch.Generator, params: SchemeParams3Gen,
                    device=None) -> MKSecretKey:
    device = resolve_device(device)
    lwe = lwe_keygen(generator, params.lwe, device=device)
    return MKSecretKey(lwe, rlwe_keygen(generator, params.rlwe, negative=True, device=device))


def _check_forms(params: SchemeParams3Gen, forms) -> None:
    if not forms or set(forms) - {"fblock", "fbstream", "conv"}:
        raise ValueError(f"forms {forms}: the port builds 'fblock', 'fbstream' and 'conv' "
                         "(the exact lines of the raw samples)")
    if not mk_fb_stream_supported(params):
        raise ValueError("3gen keys need a 64-bit ring torus")
    if "fblock" in forms and not mk_fb_supported(params):
        raise ValueError("the fblock form needs l*log2(Bg) <= 31 and Bg <= 2^8: a wide-digit "
                         "set takes forms=('fbstream',)")
    if "conv" in forms and len(forms) > 1 and mk_fb_supported(params):
        raise ValueError(f"forms {forms}: at a hi-word set the exact 'conv' lines and the "
                         "rounded fast forms are separate keys; ask for one of them")


def cloud_key_from_samples(params: SchemeParams3Gen, samples: np.ndarray,
                           ks_mat: torch.Tensor, parties: int, forms=("fblock",),
                           device=None, keep_samples: bool = False) -> MKCloudKey:
    """Assemble the cloud key from the raw 64-bit samples (parties*n, l, 2,
    2, N) and the party-concatenated keyswitch tables (K, parties*(n+1)*4)
    int8: build ``forms`` and pad the tables, on ``device``. A hi-word set
    is rounded to the hi word first, unless ``forms`` is ``("conv",)``; a
    wide-digit set, and the conv form, keep the raw 64-bit samples' lines
    under ``mk_fb64_geometry``."""
    _check_forms(params, forms)
    device = resolve_device(device)
    fb = sel = None
    exact = "conv" in forms or not mk_fb_supported(params)
    if not exact:
        geom = mk_fb_geometry(params, parties)
        hi = hi_round_samples(samples)
        if "fblock" in forms:
            fb = fblock.build_rotate_key(hi, geom, device)
        if "fbstream" in forms:
            sel = fblock.build_sel_key(hi, geom, device)
    else:
        lines = fblock.build_sel(np.asarray(samples, np.int64), mk_fb64_geometry(params, parties))
        sel = torch.from_numpy(lines).to(device)
    return MKCloudKey(pad_table(ks_mat).to(device), parties, params, bk_fb=fb,
                      bk_samples=torch.from_numpy(samples) if keep_samples else None,
                      bk_fb_sel=sel, exact=exact)


def mk_cloud_keygen(generator: torch.Generator, secret_keys: Sequence[MKSecretKey],
                    params: SchemeParams3Gen, device=None, forms=("fblock",),
                    keep_samples: bool = False) -> MKCloudKey:
    """The AKÖ cloud-key pipeline: CRP, public keys, common public key,
    per-party bootstrapping parts, keyswitch keys.

    ``forms``: "fblock" builds the expanded key, "fbstream" the compact
    lines, on ``device`` (``default_forms`` picks one by size; a wide-digit
    set takes "fbstream" only); "conv", the JAX package's exact form, the
    compact lines of the raw 64-bit samples, whose rotate is the exact
    64-bit chain. Sampling and the exact products run on the host."""
    parties = len(secret_keys)
    if parties > params.max_parties:
        raise ValueError(f"{parties} parties, the set serves {params.max_parties}")
    _check_forms(params, forms)
    device = resolve_device(device)
    crp = gen_crp(generator, params)
    common = common_public_key([public_keygen(generator, sk.rlwe, crp, params)
                                for sk in secret_keys])
    samples = np.concatenate([tgsw_encrypt_3gen(generator, sk.lwe.key, common.b, crp.a, params)
                              for sk in secret_keys])  # (parties*n, l, 2, 2, N), party-major
    cols = (params.lwe_size + 1) * 4
    mats = [keyswitch_keygen(generator, params.ks_noise_stddev, params.ks, sk.lwe,
                             extract_lwe_key(sk.rlwe), device=device).mat[:, :cols]
            for sk in secret_keys]
    return cloud_key_from_samples(params, samples, torch.cat(mats, dim=1), parties, forms,
                                  device, keep_samples)

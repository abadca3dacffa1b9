"""2nd-gen (KMS, Kwak-Min-Song) multikey TFHE.

Port of torus_fhe_tpu/mk/kms.py in its F-block form. Each party ships (a)
single-key TGSW encryptions of its LWE key bits under a throwaway ring key
z_p, and (b) one uni-encryption of z_p under its real ring key (d1, f0, f1
against the shared key a), with its public key b_p = s_p (*) a + e.
Bootstrapping runs, party by party, a single-key blind rotate in the TLev
domain (the accumulator TLev(1), its l_lev RLWE rows folded into the batch)
and relinearises it into the (P+1)-poly multikey accumulator: the TLev
external product ``tlev_extern_mul`` against the runtime TLev sample, then
``uni_product_new``. ``fast_boot`` (the default) lets party 0 rotate the
test vector as a plain RLWE sample instead and enter the accumulator through
one uni-product.

The torus is 64 bits throughout the ring (N = 2048, digits up to 2^13),
so the rotates are exact 64-bit torch-op scans, as the JAX package runs
them outside Pallas, over one of two forms of the TGSW samples (``forms``):
``"fb"``, this package's default, their compact lines
(ops/fblock.blind_rotate_streamed, 16 limb columns, digits split into int8
limb blocks); ``"conv"``, the JAX package's default, their packed kernels
``gsw_kern``, a step at a time through boot/bootstrap.mux_rotate (the TGSW
external product). The rotates take the lines when the key has them.
The uni-products contract gadget digits against the packed kernels of the
uni-encryption, the public keys and the shared key through the exact
digit-side Toeplitz product (ops/poly.negacyclic_extern_product); the TLev
product contracts them against the TLev sample itself, a runtime kernel
(ops/poly.pack_kernels_traced, negacyclic_extern_product_batched_kernels_multirow).
Keygen products run on the host in exact numpy; the key moves to ``device``
(None: the card; ``"cpu"``: the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..boot.bootstrap import mux_rotate
from ..boot.keyswitch import keyswitch_keygen, pad_table
from ..core import rng
from ..core.device import resolve_device
from ..core.params import SchemeParamsKMS, TGswParams
from ..lwe import LweKey, lwe_keygen
from ..ops import fblock, hostmath, poly
from ..rlwe import RLweKey, RLweSample, extract_lwe_key, rlwe_keygen
from ..tgsw import TGswSample, pack_tgsw, tgsw_encrypt
from .ccs import (MU, check_forms, gadget_contract, k_major, mk_keyswitch,
                  mk_rlwe_extract_sample, pack_l_to_1, rotate_input)
from .samples import MKLweSample, mk_lwe_noiseless_trivial

MU64 = 1 << 61  # encode_message(1, 8) on the 64-bit torus


class KMSSecretKey(NamedTuple):
    """One party's secret material: LWE key bits and a binary ring key."""

    lwe: LweKey
    rlwe: RLweKey


def kms_party_keygen(generator: torch.Generator, params: SchemeParamsKMS,
                     device=None) -> KMSSecretKey:
    device = resolve_device(device)
    return KMSSecretKey(lwe_keygen(generator, params.lwe, device=device),
                        rlwe_keygen(generator, params.rlwe, negative=False, device=device))


def uni_encrypt_poly(generator: torch.Generator, message_poly, alpha: float,
                     rlwe_key: RLweKey, shared_a: np.ndarray, gp: TGswParams):
    """Uni-encryption of a small-integer polynomial (the throwaway key z_p):
    d1 = r (*) a + e + m*g, f0 = s (*) f1 + e + r*g, (l, N) host numpy
    each."""
    bits = gp.bits
    npdt = np.int32 if bits == 32 else np.int64
    dtype = torch.int32 if bits == 32 else torch.int64
    a = np.asarray(shared_a)
    l, N = gp.decomp_length, a.shape[-1]
    r = rng.uniform_binary(generator, (1, N)).cpu().numpy()
    errs = rng.gaussian_torus(generator, 0, alpha, (2, l, N), dtype).cpu().numpy()
    f1 = rng.uniform_torus(generator, (l, N), dtype).cpu().numpy()
    gadget = np.asarray(gp.gadget_values, np.int64)[:, None]  # (l, 1)
    m = np.asarray(torch.as_tensor(message_poly).cpu(), np.int64)
    s = rlwe_key.key[0].cpu().numpy()
    with np.errstate(over="ignore"):
        d1 = (hostmath.negacyclic_polymul_host(r, a, bits).astype(np.int64) + errs[0]
              + m[None, :] * gadget).astype(npdt)
        f0 = (hostmath.negacyclic_polymul_host(s, f1, bits).astype(np.int64) + errs[1]
              + r.astype(np.int64) * gadget).astype(npdt)
    return d1, f0, f1


@dataclass
class KMSCloudKey:
    """The KMS cloud key, field names as the JAX package's ``KMSCloudKey``.

    ``gsw_sel`` (the fb form): (P*n, 2*l_gsw, 2N, 16) int8, the compact
    lines of each party's TGSW encryptions of its LWE key bits under z_p,
    party-major (``fblock.build_sel`` layout on every device; the scan
    expands a chunk at a time). ``gsw_kern`` (the conv form): (P*n, 16,
    2*l_gsw, N) int8, the same samples packed (``tgsw.pack_tgsw``).
    ``d_kern``, ``f0_kern``, ``f1_kern``: (P, 8, l_uni, N) int8,
    the packed uni-encryption of each z_p; ``pk_kern`` (P, 8, l_uni, N) and
    ``sk_kern`` (8, l_uni, N): the packed public keys and shared key
    (``poly.pack_kernels_host``; their rows are K-contiguous as they lie).
    ``ks_mats``: (P, K, cols) int8 keyswitch tables, cols = (n+1)*4 padded to
    a multiple of 8, K-contiguous on a CUDA device.
    """

    d_kern: torch.Tensor
    f0_kern: torch.Tensor
    f1_kern: torch.Tensor
    pk_kern: torch.Tensor
    sk_kern: torch.Tensor
    ks_mats: torch.Tensor
    parties: int
    params: SchemeParamsKMS
    gsw_sel: torch.Tensor | None = None
    gsw_kern: torch.Tensor | None = None


def kms_fb_geometry(params: SchemeParamsKMS, n_steps: int) -> fblock.FBlockGeometry:
    """64-bit F-block geometry of one TGSW CMux chain of ``n_steps`` steps
    (C = 2, R = 2*l_gsw, 16 limb columns)."""
    return fblock.fblock_geometry(n_steps, params.rlwe_polynomial_degree, params.rlwe_mask_size,
                                  params.gsw_decomp_length, params.rlwe_bits, 0)


def _cloud_key(params: SchemeParamsKMS, parties: int, gsw_sel, gsw_kern, kerns,
               ks_mats: np.ndarray, device) -> KMSCloudKey:
    """Place the key on ``device``: ``gsw_sel`` the TGSW lines (fb form) and
    ``gsw_kern`` their packed kernels (conv form), either None without its
    form; ``kerns`` the packed d, f0, f1, pk, sk kernels; ``ks_mats``
    (P, K, (n+1)*4) int8."""
    on = lambda a: None if a is None else torch.tensor(np.asarray(a, np.int8), device=device)
    mats = pad_table(torch.tensor(np.asarray(ks_mats, np.int8)).flatten(0, 1))
    return KMSCloudKey(*(on(k) for k in kerns),
                       k_major(mats.reshape(parties, -1, mats.shape[1]).to(device)),
                       parties, params, on(gsw_sel), on(gsw_kern))


def kms_cloud_keygen(generator: torch.Generator, secret_keys: Sequence[KMSSecretKey],
                     params: SchemeParamsKMS, device=None, forms=("fb",)) -> KMSCloudKey:
    """The KMS cloud-key pipeline: shared key, then per party a throwaway
    key z_p, the TGSW of the LWE key bits under it, the public key, the
    uni-encryption of z_p, and the keyswitch key. ``forms``: "fb" (the
    default) and/or "conv", both from the one keygen."""
    parties = len(secret_keys)
    if parties > params.max_parties:
        raise ValueError(f"{parties} parties, the set serves {params.max_parties}")
    forms = check_forms(forms)
    device = resolve_device(device)
    bits, uni = params.rlwe_bits, params.uni
    dtype = params.rlwe.torus_dtype
    geom = kms_fb_geometry(params, params.lwe_size)
    shared = rng.uniform_torus(generator, (uni.decomp_length, params.rlwe_polynomial_degree),
                               dtype).cpu().numpy()
    cols = (params.lwe_size + 1) * 4
    gsw, unis, pubs, mats = [], [], [], []  # gsw: the raw samples (n, l, 2, 2, N) a party
    for sk in secret_keys:
        z = rlwe_keygen(generator, params.rlwe, negative=False)
        samples = tgsw_encrypt(generator, sk.lwe.key, params.gsw_noise_stddev, z, params.tgsw,
                               params.rlwe).samples
        gsw.append(samples.numpy())
        noise = rng.gaussian_torus(generator, 0, params.uni_noise_stddev, shared.shape, dtype)
        with np.errstate(over="ignore"):
            pubs.append(hostmath.negacyclic_polymul_host(sk.rlwe.key[0].cpu().numpy(), shared,
                                                         bits) + noise.cpu().numpy())
        unis.append(uni_encrypt_poly(generator, z.key[0], params.uni_noise_stddev, sk.rlwe,
                                     shared, uni))
        mats.append(keyswitch_keygen(generator, params.ks_noise_stddev, params.ks, sk.lwe,
                                     extract_lwe_key(sk.rlwe), device="cpu").mat[:, :cols].numpy())
    kerns = [pack_l_to_1(np.stack([u[i] for u in unis]), bits) for i in range(3)]
    kerns += [pack_l_to_1(np.stack(pubs), bits), pack_l_to_1(shared, bits)]
    samples = np.concatenate(gsw)
    return _cloud_key(params, parties, fblock.build_sel(samples, geom) if "fb" in forms else None,
                      _pack_gsw(samples, params) if "conv" in forms else None, kerns,
                      np.stack(mats), device)


def _pack_gsw(samples: np.ndarray, params: SchemeParamsKMS) -> np.ndarray:
    """The conv form of raw TGSW samples (M, l, 2, 2, N): (M, 16, 2*l, N)."""
    return pack_tgsw(TGswSample(torch.from_numpy(samples)), params.tgsw).kernels.numpy()


def cloud_key_from_fields(params: SchemeParamsKMS, parties: int, fields: dict,
                          device=None, forms=("fb",)) -> KMSCloudKey:
    """The cloud key in ``forms`` from the JAX package's ``KMSCloudKey``
    fields as numpy arrays (a key file's, or ``np.asarray`` of each field):
    ``gsw_sel`` (fb) and ``gsw_kern`` (conv) taken as they are where the
    key holds them, else built from the raw samples of the other (the
    packed kernels unflipped and their limbs combined, or the lines' first
    halves, ``fblock.unbuild_sel``); the packed uni, public and shared
    kernels and ``ks_mats`` as they are."""
    forms = check_forms(forms)
    geom = kms_fb_geometry(params, params.lwe_size)
    l, N, C = params.gsw_decomp_length, params.rlwe_polynomial_degree, params.rlwe_mask_size + 1

    def samples():
        if fields.get("gsw_kern") is not None:
            raw = poly.unpack_kernels_host(fields["gsw_kern"], params.rlwe_bits, C)
            return raw.reshape(-1, l, C, C, N)
        if fields.get("gsw_sel") is not None:
            return fblock.unbuild_sel(fields["gsw_sel"], geom)
        raise ValueError("the key has neither gsw_sel nor gsw_kern")

    sel = kern = None
    if "fb" in forms:
        sel = fields.get("gsw_sel")
        sel = fblock.build_sel(samples(), geom) if sel is None else sel
    if "conv" in forms:
        kern = fields.get("gsw_kern")
        kern = _pack_gsw(samples(), params) if kern is None else kern
    kerns = [fields[f"{name}_kern"] for name in ("d", "f0", "f1", "pk", "sk")]
    return _cloud_key(params, parties, sel, kern, kerns, fields["ks_mats"],
                      resolve_device(device))


# ---------------------------------------------------------------------------
# TLev accumulator ops and the hybrid product
# ---------------------------------------------------------------------------


def tlev_trivial_one(B: int, params: SchemeParamsKMS, device=None) -> torch.Tensor:
    """TLev encryption of the integer 1: the gadget values on the bodies'
    constant coefficients. (B, l_lev, 2, N)."""
    lev = params.tlev
    dtype = params.rlwe.torus_dtype
    acc = torch.zeros((B, lev.decomp_length, 2, params.rlwe_polynomial_degree), dtype=dtype,
                      device=device)
    acc[:, :, 1, 0] = torch.tensor(lev.gadget_values, dtype=dtype, device=device)
    return acc


def tlev_extern_mul(c: torch.Tensor, lev: torch.Tensor, params: SchemeParamsKMS) -> torch.Tensor:
    """RLWE(m_lev * c) = <g_lev(c), lev>, exact. c: (B, S, N) torus polys;
    lev: (B, l_lev, 2, N) runtime TLev samples, one an element, shared by
    its S polys. Returns (B, S, 2, N).

    The S polys x the digit limb blocks of an element are the row groups of
    one runtime-kernel product against its packed TLev sample. A term is
    shifted by 8 * (digit block + kernel limb); one of 64 bits or more is
    0 mod 2^64 and is dropped (XLA's shift gives 0 there; a device's need
    not), which happens only for lev digits wider than a byte."""
    levp = params.tlev
    B, S, N = c.shape
    digits = poly.decompose(c, levp.decomp_length, levp.log2_base, levp.bits, levp.offset)
    blocks = poly.digits_to_i8_rows(digits, levp.log2_base)  # Lb x (B, S, l, N)
    Lb, L = len(blocks), poly.n_limbs_for(levp.bits)
    rows = torch.stack(blocks, dim=1).reshape(B, Lb * S, levp.decomp_length, N)
    packed = poly.pack_kernels_traced(lev, levp.bits)  # (B, 2*L, l, N)
    folded = poly.negacyclic_extern_product_batched_kernels_multirow(rows, packed)
    folded = folded.reshape(B, Lb, S, 2, L, N)
    dtype = c.dtype
    total = torch.zeros((B, S, 2, N), dtype=dtype, device=c.device)
    for m in range(Lb):
        for j in range(L):
            if 8 * (m + j) < levp.bits:
                total = total + (folded[:, m, :, :, j].to(dtype) << (8 * (m + j)))
    return total


def uni_product_new(x: torch.Tensor, ck: KMSCloudKey, party: int) -> torch.Tensor:
    """The relinearisation's hybrid product on a (B, P+1, N) operand for
    party ``party``'s uni-encryption:

        u = <g(x_i), d1>,  v = sum_{i<P} <g(x_i), b_i> - <g(x_P), a>
        w0, w1 = <g(v), f0>, <g(v), f1>
        out = u; out[party] += w1; out[P] += w0

    d1, the public keys and the shared key sit side by side against the
    digits of x (one product), f0 and f1 against those of v."""
    uni, P = ck.params.uni, ck.parties
    kern = torch.cat([ck.d_kern[party], ck.pk_kern.flatten(0, 1), ck.sk_kern])
    c = gadget_contract(x, kern, uni, P + 2)  # (B, P+1, P+2, N)
    u = c[:, :, 0]
    v = -c[:, P, P + 1]
    for p in range(P):
        v = v + c[:, p, p + 1]
    w = gadget_contract(v, torch.cat([ck.f0_kern[party], ck.f1_kern[party]]), uni, 2)
    u[:, party] += w[:, 1]
    u[:, P] += w[:, 0]
    return u


def _gsw_rotate(acc: torch.Tensor, ck: KMSCloudKey, party: int, bara_p: torch.Tensor,
                chunk: int) -> torch.Tensor:
    """The single-key CMux chain of party ``party``'s n TGSW steps on RLWE
    rows acc (rows, 2, N), bara_p (rows, n): over the lines when the key has
    them (the streamed F-block scan, ``chunk`` steps expanded at a time),
    else over the packed kernels a step at a time (``mux_rotate``)."""
    params, n = ck.params, ck.params.lwe_size
    if ck.gsw_sel is not None:
        gp = params.tgsw
        return fblock.blind_rotate_streamed(acc, ck.gsw_sel[party * n:(party + 1) * n], bara_p,
                                            kms_fb_geometry(params, n), gp.decomp_length,
                                            gp.log2_base, gp.offset, chunk=chunk)
    if ck.gsw_kern is None:
        raise ValueError("the cloud key holds neither the fb nor the conv form")
    rows = RLweSample(acc)
    for i in range(n):
        rows = mux_rotate(rows, ck.gsw_kern[party * n + i], bara_p[:, i], params)
    return rows.a


def _lev_blind_rotate(ck: KMSCloudKey, party: int, bara_p: torch.Tensor,
                      chunk: int) -> torch.Tensor:
    """Party ``party``'s TLev blind rotate: the single-key CMux chain over its
    n TGSW steps from TLev(1), the l_lev RLWE rows of a TLev sample folded
    into the batch (B * l_lev). bara_p: (B, n). Returns (B, l_lev, 2, N)."""
    params, n = ck.params, ck.params.lwe_size
    B, llev, N = bara_p.shape[0], params.lev_decomp_length, params.rlwe_polynomial_degree
    lev = tlev_trivial_one(B, params, bara_p.device).reshape(B * llev, 2, N)
    acc = _gsw_rotate(lev, ck, party, bara_p[:, None].expand(B, llev, n).reshape(B * llev, n),
                      chunk)
    return acc.reshape(B, llev, 2, N)


def _lev_rlwe_mul(acc: torch.Tensor, lev: torch.Tensor, ck: KMSCloudKey,
                  party: int) -> torch.Tensor:
    """Fold party ``party``'s TLev rotate into the multikey accumulator:
    (e, f) = lev (x) acc, then f - UniProduct(e). Polys of parties not yet
    processed are zero and decompose to zero digits, so every poly goes
    through branch-free, as in the JAX package."""
    ef = tlev_extern_mul(acc, lev, ck.params)  # (B, P+1, 2, N)
    return ef[..., 1, :] - uni_product_new(ef[..., 0, :], ck, party)


def kms_blind_rotate(acc: torch.Tensor, ck: KMSCloudKey, bara: torch.Tensor,
                     fast_boot: bool = True, chunk: int = 64) -> torch.Tensor:
    """The party-sequential KMS blind rotate. acc: (B, P+1, N) int64, the
    test vector in the body; bara: (B, P, n) int32. ``fast_boot``: party 0
    rotates the test vector as a single-key RLWE sample under its TGSW key
    and enters through one uni-product (no TLev phase for it)."""
    P = ck.parties
    start = 0
    if fast_boot:
        sacc = torch.stack([torch.zeros_like(acc[:, P]), acc[:, P]], dim=1)
        sacc = _gsw_rotate(sacc, ck, 0, bara[:, 0], chunk)
        e, f = torch.zeros_like(acc), torch.zeros_like(acc)
        e[:, P], f[:, P] = sacc[:, 0], sacc[:, 1]
        acc = f - uni_product_new(e, ck, 0)
        start = 1
    for p in range(start, P):
        acc = _lev_rlwe_mul(acc, _lev_blind_rotate(ck, p, bara[:, p], chunk), ck, p)
    return acc


# ---------------------------------------------------------------------------
# Bootstrap and gates
# ---------------------------------------------------------------------------


def mk_bootstrap_wo_keyswitch(ck: KMSCloudKey, mu: int, x: MKLweSample, fast_boot: bool = True,
                              chunk: int = 64) -> MKLweSample:
    """Mod-switch and the KMS blind rotate of the [mu..mu] test vector (mu a
    64-bit torus phase), then extract to the 32-bit LWE torus."""
    lead = tuple(x.b.shape)
    acc, bara = rotate_input(mu, x, ck.params.rlwe_polynomial_degree, ck.parties,
                             ck.params.rlwe.torus_dtype)
    u = mk_rlwe_extract_sample(kms_blind_rotate(acc, ck, bara, fast_boot, chunk))
    return MKLweSample(u.a.reshape(lead + u.a.shape[-2:]), u.b.reshape(lead))


def mk_bootstrap(ck: KMSCloudKey, mu: int, x: MKLweSample, fast_boot: bool = True,
                 chunk: int = 64) -> MKLweSample:
    """The full KMS multikey bootstrap: rotate-extract, then the per-party
    keyswitch."""
    u = mk_bootstrap_wo_keyswitch(ck, mu, x, fast_boot, chunk)
    return mk_keyswitch(ck.ks_mats, ck.params.ks, ck.params.lwe_size, u)


def mk_gate_nand(ck: KMSCloudKey, x: MKLweSample, y: MKLweSample,
                 fast_boot: bool = True) -> MKLweSample:
    """KMS multikey NAND: bootstrap (0, 1/8) - x - y with the 64-bit 1/8."""
    temp = mk_lwe_noiseless_trivial(MU, ck.params.lwe, ck.parties, x.b.shape,
                                    device=x.b.device) - x - y
    return mk_bootstrap(ck, MU64, temp, fast_boot)

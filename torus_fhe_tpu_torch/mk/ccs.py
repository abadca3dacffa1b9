"""1st-gen (CCS, Chen-Chillotti-Song) multikey TFHE.

Port of torus_fhe_tpu/mk/ccs.py in its F-block form. Keys: a shared
key a (l common random polys), per-party public keys b_p = s_p (*) a + e,
and per (party, LWE key bit) the uni-encryption components d1, f0, f1
(``uni_encrypt_bits``). The accumulator is a (P+1)-poly multikey RLWE
sample, batched as (B, P+1, N), and the blind rotate is one chain of P*n
CMux steps, party-major: ACC += UniProduct((X^bara - 1) * ACC). Every
polynomial product of UniProduct is a gadget contraction against a fixed
kernel line, run as an exact int8 F-block matmul (ops/fblock.py): one
output poly (C = 1), l digit rows, the 4 byte-limb columns of the 32-bit
torus. Digits wider than a byte (Bg = 2^9 at 2 parties) split into int8
limb blocks. Keygen products run on the host in exact numpy
(ops/hostmath); the finished key moves to ``device`` (None: the card,
core/device.resolve_device; ``"cpu"``: the CPU).

The key holds one or both of the JAX package's forms (``forms``): ``"fb"``,
this package's default, the compact lines of the per-step d1/f0/f1
(expanded chunk by chunk at rotate time) and the pre-expanded public-key and
shared-key blocks, whose products are F-block matmuls; ``"conv"``, the JAX
package's default, the packed per-step kernels (``pack_l_to_1``), whose
products are the exact digit-side Toeplitz product of ops/poly
(``gadget_contract``; JAX's XLA conv scan). The bootstrap takes the fb route
when the key has its lines, else the conv route (``ccs_blind_rotate``); both
give the same words.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..boot.keyswitch import keyswitch_keygen, pad_table
from ..core import rng
from ..core.device import resolve_device
from ..core.params import SchemeParamsCCS, TGswParams
from ..core.torus import decode_message, t64_to_t32
from ..lwe import LweKey, lwe_keygen
from ..ops import fblock, hostmath, poly
from ..rlwe import RLweKey, extract_lwe_key, rlwe_keygen
from .samples import MKLweSample, mk_lwe_noiseless_trivial

MU = 1 << 29  # encode_message(1, 8): the gate test vector


class CCSSecretKey(NamedTuple):
    """One party's secret material: LWE key bits and a binary ring key."""

    lwe: LweKey
    rlwe: RLweKey


def ccs_party_keygen(generator: torch.Generator, params: SchemeParamsCCS,
                     device=None) -> CCSSecretKey:
    device = resolve_device(device)
    return CCSSecretKey(lwe_keygen(generator, params.lwe, device=device),
                        rlwe_keygen(generator, params.rlwe, negative=False, device=device))


def gen_shared_key(generator: torch.Generator, params: SchemeParamsCCS) -> torch.Tensor:
    """The l common random polynomials a[i], (l, N), on the generator's device."""
    return rng.uniform_torus(generator, (params.bs_decomp_length, params.rlwe_polynomial_degree),
                             params.rlwe.torus_dtype)


def ccs_public_keygen(generator: torch.Generator, rlwe_key: RLweKey, shared_a: np.ndarray,
                      params: SchemeParamsCCS) -> np.ndarray:
    """b_p[i] = s_p (*) a[i] + e, (l, N) host numpy."""
    a = np.asarray(shared_a)
    prod = hostmath.negacyclic_polymul_host(rlwe_key.key[0].cpu().numpy(), a, params.rlwe_bits)
    noise = rng.gaussian_torus(generator, 0, params.bs_noise_stddev, a.shape,
                               params.rlwe.torus_dtype).cpu().numpy()
    with np.errstate(over="ignore"):
        return prod + noise


def uni_encrypt_bits(generator: torch.Generator, messages, alpha: float, rlwe_key: RLweKey,
                     shared_a: np.ndarray, gp: TGswParams):
    """CCS uni-encryption of M integer messages, vectorised over messages:
    the three components the blind rotate reads, (M, l, N) host numpy each.
    d1 = r (*) a + e + m*g encrypts m under the shared randomness r (a
    binary poly), f0 = s (*) f1 + e + r*g encrypts r under the party key.
    The other components of the reference's uni-encryption are not used by
    the hybrid product and are not made (as in the JAX package)."""
    bits = gp.bits
    npdt = np.int32 if bits == 32 else np.int64
    dtype = torch.int32 if bits == 32 else torch.int64
    msg = np.asarray(torch.as_tensor(messages).cpu(), np.int64).astype(npdt)
    a = np.asarray(shared_a)
    M, l, N = msg.shape[0], gp.decomp_length, a.shape[-1]
    r = rng.uniform_binary(generator, (M, 1, N)).cpu().numpy()
    errs = rng.gaussian_torus(generator, 0, alpha, (2, M, l, N), dtype).cpu().numpy()
    f1 = rng.uniform_torus(generator, (M, l, N), dtype).cpu().numpy()
    gadget = np.asarray(gp.gadget_values, npdt)  # (l,)
    s = rlwe_key.key[0].cpu().numpy()
    with np.errstate(over="ignore"):
        d1 = hostmath.negacyclic_polymul_host(r, a[None], bits) + errs[0]
        d1[..., 0] += msg[:, None] * gadget
        f0 = hostmath.negacyclic_polymul_host(s, f1, bits) + errs[1]
        f0 = (f0.astype(np.int64) + r.astype(np.int64) * gadget.astype(np.int64)[None, :, None]
              ).astype(npdt)
    return d1, f0, f1


@dataclass
class CCSCloudKey:
    """The CCS cloud key, field names as the JAX package's ``CCSCloudKey``.

    The fb form: ``d_sel``, ``f0_sel``, ``f1_sel``: (P*n, l, 2N, 4) int8,
    the compact lines of d1, f0, f1 of each (party, key bit), party-major
    (``fblock.build_sel`` layout on every device); ``pk_fb``: (P, D*l*bs,
    4*bs) int8, the expanded blocks of the party public keys, ``sk_fb``:
    (D*l*bs, 4*bs), the shared key's; on a CUDA device both are stored with
    the reduction index contiguous (transposed strides), the form cuBLASLt's
    tensor-core int8 kernels take. The conv form: ``d_kern``, ``f0_kern``,
    ``f1_kern``: (P*n, 4, l, N) int8, the same d1, f0, f1 packed
    (``pack_l_to_1``). Both forms: ``pk_kern`` (P, 4, l, N) and ``sk_kern``
    (4, l, N), the public and shared keys packed, which the key files carry
    and the conv route reads; ``ks_mats``: (P, K, cols) int8 per-party
    keyswitch tables, cols = (n+1)*4 padded to a multiple of 8, K-contiguous
    on a CUDA device.
    """

    pk_kern: torch.Tensor
    sk_kern: torch.Tensor
    ks_mats: torch.Tensor
    parties: int
    params: SchemeParamsCCS
    d_sel: torch.Tensor | None = None
    f0_sel: torch.Tensor | None = None
    f1_sel: torch.Tensor | None = None
    pk_fb: torch.Tensor | None = None
    sk_fb: torch.Tensor | None = None
    d_kern: torch.Tensor | None = None
    f0_kern: torch.Tensor | None = None
    f1_kern: torch.Tensor | None = None


def ccs_fb_geometry(params: SchemeParamsCCS, parties: int) -> fblock.FBlockGeometry:
    """F-block geometry of one gadget contraction line over the P*n CMux
    steps: one output poly (C = 1), l digit rows, 4 limb columns."""
    return fblock.fblock_geometry(parties * params.lwe_size, params.rlwe_polynomial_degree, 0,
                                  params.bs_decomp_length, params.rlwe_bits, 0)


def _pair_geometry(geom: fblock.FBlockGeometry) -> fblock.FBlockGeometry:
    """The same digit rows against two kernel lines side by side (f0 and f1,
    both read by the decomposed v): output poly 0 from the first line's limb
    columns, poly 1 from the second's."""
    return geom._replace(C=2, cols=geom.cols + tuple((1, s) for _, s in geom.cols))


def k_major(mat: torch.Tensor) -> torch.Tensor:
    """mat (..., K, cols) with K contiguous in memory on a CUDA device (the
    key side ``torch._int_mm`` runs fast with, ops/poly.int8_matmul); as it
    is elsewhere. Same values and shape."""
    return mat.transpose(-1, -2).contiguous().transpose(-1, -2) if mat.is_cuda else mat


def check_forms(forms) -> tuple:
    forms = tuple(forms)
    if not forms or set(forms) - {"fb", "conv"}:
        raise ValueError(f"forms {forms}: the key is built in 'fb' and/or 'conv'")
    return forms


def pack_l_to_1(polys: np.ndarray, bits: int) -> np.ndarray:
    """(..., l, N) torus kernels contracting l digit rows into one output
    poly, packed (``poly.pack_kernels_host``): (..., L, l, N) int8."""
    return poly.pack_kernels_host(np.asarray(polys)[..., None, :], bits)


def _lines(polys: np.ndarray, geom: fblock.FBlockGeometry) -> np.ndarray:
    """(M, l, N) torus kernel lines -> compact F-block lines (M, l, 2N, 4)."""
    return fblock.build_sel(np.asarray(polys).reshape(-1, geom.R, 1, 1, geom.N), geom)


def _cloud_key(params: SchemeParamsCCS, parties: int, sels, kerns, pub: np.ndarray,
               shared: np.ndarray, ks_mats: np.ndarray, device) -> CCSCloudKey:
    """Place the key on ``device``: ``sels`` the d1/f0/f1 lines (P*n, l, 2N,
    4) int8 of the fb form (None without it), ``kerns`` their packed kernels
    (P*n, 4, l, N) int8 of the conv form (None without it), ``pub`` (P, l, N)
    and ``shared`` (l, N) torus, ``ks_mats`` (P, K, (n+1)*4) int8."""
    geom = ccs_fb_geometry(params, parties)
    bits = params.rlwe_bits
    on = lambda a: torch.tensor(np.asarray(a, np.int8), device=device)
    sel = kern = (None, None, None)
    pk_fb = sk_fb = None
    if sels is not None:
        sel = tuple(on(x) for x in sels)
        keys = torch.from_numpy(_lines(np.concatenate([pub, shared[None]]), geom)).to(device)
        fb = k_major(fblock.expand_fblock_chunk(keys, geom))  # (P+1, D*l*bs, 4*bs)
        pk_fb, sk_fb = fb[:parties], fb[parties]
    if kerns is not None:
        kern = tuple(on(x) for x in kerns)
    mats = pad_table(torch.tensor(np.asarray(ks_mats, np.int8)).flatten(0, 1))
    return CCSCloudKey(
        on(pack_l_to_1(pub, bits)), on(pack_l_to_1(shared, bits)),
        k_major(mats.reshape(parties, -1, mats.shape[1]).to(device)), parties, params,
        *sel, pk_fb, sk_fb, *kern)


def ccs_cloud_keygen(generator: torch.Generator, secret_keys: Sequence[CCSSecretKey],
                     params: SchemeParamsCCS, device=None, forms=("fb",)) -> CCSCloudKey:
    """The CCS cloud-key pipeline: shared key, public keys, per-party
    uni-encryptions of the LWE key bits, keyswitch keys. ``forms``: "fb"
    (the default) and/or "conv", both from the one keygen."""
    parties = len(secret_keys)
    if parties > params.max_parties:
        raise ValueError(f"{parties} parties, the set serves {params.max_parties}")
    forms = check_forms(forms)
    device = resolve_device(device)
    geom = ccs_fb_geometry(params, parties)
    shared = gen_shared_key(generator, params).cpu().numpy()
    pubs = np.stack([ccs_public_keygen(generator, sk.rlwe, shared, params) for sk in secret_keys])
    parts = [uni_encrypt_bits(generator, sk.lwe.key, params.bs_noise_stddev, sk.rlwe, shared,
                              params.tgsw) for sk in secret_keys]
    polys = [np.concatenate([p[i] for p in parts]) for i in range(3)]  # d1, f0, f1 (P*n, l, N)
    cols = (params.lwe_size + 1) * 4
    mats = np.stack([keyswitch_keygen(generator, params.ks_noise_stddev, params.ks, sk.lwe,
                                      extract_lwe_key(sk.rlwe), device="cpu").mat[:, :cols].numpy()
                     for sk in secret_keys])
    sels = [_lines(x, geom) for x in polys] if "fb" in forms else None
    kerns = [pack_l_to_1(x, params.rlwe_bits) for x in polys] if "conv" in forms else None
    return _cloud_key(params, parties, sels, kerns, pubs, shared, mats, device)


def cloud_key_from_fields(params: SchemeParamsCCS, parties: int, fields: dict,
                          device=None, forms=("fb",)) -> CCSCloudKey:
    """The cloud key in ``forms`` from the JAX package's ``CCSCloudKey``
    fields as numpy arrays (a key file's, or ``np.asarray`` of each field).
    Each form's fields are taken as they are where the key holds them
    (``d_sel``/``f0_sel``/``f1_sel`` for fb, ``d_kern``/``f0_kern``/
    ``f1_kern`` for conv), else built from the other form's torus values
    (the packed kernels unflipped and their limbs combined, or the lines'
    first halves, ``fblock.unbuild_sel``); the public and shared keys come
    from ``pk_kern``/``sk_kern``, the tables from ``ks_mats``."""
    forms = check_forms(forms)
    geom = ccs_fb_geometry(params, parties)
    bits = params.rlwe_bits
    unpack = lambda k: poly.unpack_kernels_host(k, bits, 1)[..., 0, :]  # (..., l, N)

    def torus(name):
        if fields.get(f"{name}_kern") is not None:
            return unpack(fields[f"{name}_kern"])
        if fields.get(f"{name}_sel") is not None:
            return fblock.unbuild_sel(fields[f"{name}_sel"], geom)[:, :, 0, 0]
        raise ValueError(f"the key has neither {name}_sel nor {name}_kern")

    def form(suffix, build):
        return [fields[f"{name}_{suffix}"] if fields.get(f"{name}_{suffix}") is not None
                else build(torus(name)) for name in ("d", "f0", "f1")]

    sels = form("sel", lambda t: _lines(t, geom)) if "fb" in forms else None
    kerns = form("kern", lambda t: pack_l_to_1(t, bits)) if "conv" in forms else None
    return _cloud_key(params, parties, sels, kerns, unpack(fields["pk_kern"]),
                      unpack(fields["sk_kern"]), fields["ks_mats"], resolve_device(device))


# ---------------------------------------------------------------------------
# The hybrid product and the blind rotate
# ---------------------------------------------------------------------------


def _digit_blocks(x: torch.Tensor, gp: TGswParams) -> torch.Tensor:
    """Gadget digits of torus polys x (..., N) as int8 limb blocks
    (nl, ..., l, N)."""
    digits = poly.decompose(x, gp.decomp_length, gp.log2_base, gp.bits, gp.offset)
    return fblock.stack_blocks(poly.digits_to_i8_rows(digits, gp.log2_base))


def _contract(blocks: torch.Tensor, fstep: torch.Tensor, geom: fblock.FBlockGeometry,
              dtype: torch.dtype) -> torch.Tensor:
    """blocks (nl, ..., l, N) against one F-block step -> (..., C, N)."""
    lead = blocks.shape[1:-2]
    out = fblock.contract_blocks_fblock(blocks.reshape((blocks.shape[0], -1) + blocks.shape[-2:]),
                                        fstep, geom, dtype)
    return out.reshape(lead + out.shape[1:])


def gadget_contract(x: torch.Tensor, packed: torch.Tensor, gp: TGswParams,
                    out_polys: int) -> torch.Tensor:
    """sum_l g(x)_l (*) kern_{l,c} for each input poly: x (..., N) torus,
    packed (C * L, l, N) int8 (C kernels side by side) -> (..., C, N). The
    digit limb blocks are stacked along the batch of one product and their
    results shifted by 8m; kernels side by side share the digit side's
    Toeplitz rows. Integer sums: the words of one contraction per kernel
    and block (the JAX package's ``_gadget_contract`` of each)."""
    lead, N = x.shape[:-1], x.shape[-1]
    blocks = _digit_blocks(x, gp)
    nl = blocks.shape[0]
    prod = poly.negacyclic_extern_product(blocks.reshape(-1, gp.decomp_length, N), packed,
                                          gp.bits, out_polys)
    prod = prod.reshape((nl, -1, out_polys, N))
    total = prod[0]
    for m in range(1, nl):
        total = total + (prod[m] << (8 * m))
    return total.reshape(lead + (out_polys, N))


def uni_product(x: torch.Tensor, d_k: torch.Tensor, f0_k: torch.Tensor, f1_k: torch.Tensor,
                pk_kern: torch.Tensor, sk_kern: torch.Tensor, onehot: torch.Tensor,
                gp: TGswParams) -> torch.Tensor:
    """UniProduct on the conv form: a batched (B, P+1, N) accumulator delta
    x against one step's packed d1/f0/f1 kernels (L, l, N), the packed
    public keys (P, L, l, N) and shared key (L, l, N); ``onehot`` (P,) the
    owning party:

        u   = <g(x_i), d1>            every mask and the body
        v_i = <g(x_i), b_i>           party public keys, i < P
        v_P = -<g(x_P), a>            shared key
        w0, w1 = sum_j <g(v_j), f0>, <g(v_j), f1>
        out = u; out[party] += w1; out[P] += w0

    d1, the public keys and the shared key sit side by side against the
    digits of x (one product), f0 and f1 against those of v."""
    P = x.shape[1] - 1
    c = gadget_contract(x, torch.cat([d_k, pk_kern.flatten(0, 1), sk_kern]), gp, P + 2)
    u = c[:, :, 0]  # (B, P+1, N)
    v = torch.stack([c[:, p, p + 1] for p in range(P)] + [-c[:, P, P + 1]], dim=1)
    w = gadget_contract(v, torch.cat([f0_k, f1_k]), gp, 2).sum(1, dtype=x.dtype)  # (B, 2, N)
    u[:, :P] += onehot.to(device=x.device, dtype=x.dtype)[None, :, None] * w[:, None, 1]
    u[:, P] += w[:, 0]
    return u


def ccs_blind_rotate(acc: torch.Tensor, ck: CCSCloudKey, bara: torch.Tensor) -> torch.Tensor:
    """The party-sequential CMux chain over the conv form, a step at a time:
    ACC += UniProduct((X^bara - 1) * ACC) against step s's packed kernels.
    acc: (B, P+1, N) int32; bara: (B, P*n) int32, party-major."""
    gp = ck.params.tgsw
    n, P = ck.params.lwe_size, ck.parties
    onehots = torch.eye(P, dtype=acc.dtype, device=acc.device)
    for s in range(ck.d_kern.shape[0]):
        x = poly.mul_by_monomial(acc, bara[:, s]) - acc
        acc = acc + uni_product(x, ck.d_kern[s], ck.f0_kern[s], ck.f1_kern[s], ck.pk_kern,
                                ck.sk_kern, onehots[s // n], gp)
    return acc


def uni_product_fb(x: torch.Tensor, d_f: torch.Tensor, f_f: torch.Tensor, ck: CCSCloudKey,
                   party: int) -> torch.Tensor:
    """UniProduct on the fb form: a batched (B, P+1, N) accumulator delta x,
    against one step's expanded d1 block ``d_f`` and f0|f1 blocks ``f_f``
    (the pair geometry), for the key bit of ``party`` (``uni_product``'s
    terms):

        u   = <g(x_i), d1>            every mask and the body
        v_i = <g(x_i), b_i>           party public keys, i < P
        v_P = -<g(x_P), a>            shared key
        w0, w1 = sum_j <g(v_j), f0>, <g(v_j), f1>
        out = u; out[party] += w1; out[P] += w0
    """
    gp = ck.params.tgsw
    geom = ccs_fb_geometry(ck.params, ck.parties)
    P = ck.parties
    blocks = _digit_blocks(x, gp)  # (nl, B, P+1, l, N), shared by u and v
    u = _contract(blocks, d_f, geom, x.dtype)[..., 0, :]  # (B, P+1, N)
    v = torch.stack([_contract(blocks[:, :, p], ck.pk_fb[p], geom, x.dtype)[:, 0]
                     for p in range(P)]
                    + [-_contract(blocks[:, :, P], ck.sk_fb, geom, x.dtype)[:, 0]], dim=1)
    w = _contract(_digit_blocks(v, gp), f_f, _pair_geometry(geom), x.dtype)  # (B, P+1, 2, N)
    w = w.sum(1, dtype=x.dtype)
    u[:, party] += w[:, 1]
    u[:, P] += w[:, 0]
    return u


def ccs_blind_rotate_fb(acc: torch.Tensor, ck: CCSCloudKey, bara: torch.Tensor,
                        chunk: int = 64) -> torch.Tensor:
    """The party-sequential CMux chain over the F-block key: per chunk of at
    most ``chunk`` steps the d1 lines and the f0|f1 lines are expanded on
    their device (into the kernel layout on a CUDA device, whose steps give
    ``torch._int_mm`` the key side with the reduction index contiguous),
    then each step adds UniProduct((X^bara - 1) * acc). acc: (B, P+1, N)
    int32; bara: (B, P*n) int32, party-major. The JAX package pads the steps
    to whole chunks for its scan; a Python loop needs no padding, and the
    words are the same."""
    geom = ccs_fb_geometry(ck.params, ck.parties)
    pair = _pair_geometry(geom)
    n = ck.params.lwe_size
    steps = ck.d_sel.shape[0]
    expand = fblock.expand_kernel_chunk if ck.d_sel.is_cuda else fblock.expand_fblock_chunk
    for s0 in range(0, steps, chunk):
        d_c = expand(ck.d_sel[s0:s0 + chunk], geom)
        f_c = expand(torch.cat([ck.f0_sel[s0:s0 + chunk], ck.f1_sel[s0:s0 + chunk]], -1), pair)
        for i in range(d_c.shape[0]):
            s = s0 + i
            x = poly.mul_by_monomial(acc, bara[:, s]) - acc
            acc = acc + uni_product_fb(x, d_c[i], f_c[i], ck, s // n)
        del d_c, f_c
    return acc


def mk_rlwe_extract_sample(acc: torch.Tensor) -> MKLweSample:
    """Constant-coefficient extraction per party mask: acc (B, P+1, N) ->
    a (B, P, N), b (B,); a 64-bit accumulator is truncated to Torus32."""
    P = acc.shape[1] - 1
    mask = acc[:, :P]
    rev = torch.cat([mask[..., :1], -mask[..., 1:].flip(-1)], dim=-1)
    b = acc[:, P, 0]
    if acc.dtype == torch.int64:
        return MKLweSample(t64_to_t32(rev), t64_to_t32(b))
    return MKLweSample(rev, b)


def mk_keyswitch(ks_mats: torch.Tensor, ks_params, n_out: int, u: MKLweSample) -> MKLweSample:
    """Per-party keyswitch: party p's table against party p's extracted mask
    (one one-hot int8 product a party), the b parts summed. u.a: (..., P,
    N_in); ks_mats: (P, K, cols) int8 (``CCSCloudKey.ks_mats``)."""
    l, lb = ks_params.decomp_length, ks_params.log2_base
    base = 1 << lb
    lead = tuple(u.b.shape)
    P = u.a.shape[-2]
    dev = u.a.device
    aibar = u.a + (1 << (32 - (1 + lb * l)))  # precision offset, wraps
    shifts = 32 - torch.arange(1, l + 1, dtype=torch.int32, device=dev) * lb
    digits = (aibar[..., None] >> shifts) & (base - 1)  # (..., P, N_in, l)
    h = torch.arange(1, base, dtype=torch.int32, device=dev)
    onehot = (digits[..., None] == h).to(torch.int8).reshape(-1, P, ks_mats.shape[1])
    cols = (n_out + 1) * 4
    deltas = torch.stack([poly.int8_matmul(onehot[:, p], ks_mats[p])[:, :cols]
                          for p in range(P)], dim=1)
    deltas = poly.limb_combine(deltas.reshape(lead + (P, n_out + 1, 4)), 32)  # (..., P, n+1)
    b = u.b - torch.sum(deltas[..., n_out], dim=-1, dtype=torch.int32)
    return MKLweSample(-deltas[..., :n_out], b)


# ---------------------------------------------------------------------------
# Bootstrap and gates
# ---------------------------------------------------------------------------


def rotate_input(mu: int, x: MKLweSample, N: int, parties: int, dtype: torch.dtype):
    """Mod-switch a multikey batch to Z_2N: (acc, bara) with acc (B, P+1, N)
    the test vector X^-barb * [mu..mu] in the body, masks zero, and bara
    (B, P, n) int32."""
    B = x.b.numel()
    bara = decode_message(x.a, 2 * N).reshape(B, parties, -1)
    barb = decode_message(x.b, 2 * N).reshape(B)
    tv = torch.full((B, N), int(mu), dtype=dtype, device=x.b.device)
    acc = torch.zeros((B, parties + 1, N), dtype=dtype, device=x.b.device)
    acc[:, parties] = poly.mul_by_monomial(tv, -barb)
    return acc, bara


def mk_bootstrap_wo_keyswitch(ck: CCSCloudKey, mu: int, x: MKLweSample,
                              chunk: int = 64) -> MKLweSample:
    """Mod-switch and blind-rotate the [mu..mu] test vector through all
    parties' steps, then extract. Any leading batch shape. A key with the
    fb lines takes the fb route, else the conv route (``ccs_blind_rotate``),
    as in the JAX package."""
    lead = tuple(x.b.shape)
    acc, bara = rotate_input(mu, x, ck.params.rlwe_polynomial_degree, ck.parties,
                             ck.params.rlwe.torus_dtype)
    if ck.d_sel is not None:
        acc = ccs_blind_rotate_fb(acc, ck, bara.flatten(1), chunk)
    elif ck.d_kern is not None:
        acc = ccs_blind_rotate(acc, ck, bara.flatten(1))
    else:
        raise ValueError("the cloud key holds neither the fb nor the conv form")
    u = mk_rlwe_extract_sample(acc)
    return MKLweSample(u.a.reshape(lead + u.a.shape[-2:]), u.b.reshape(lead))


def mk_bootstrap(ck: CCSCloudKey, mu: int, x: MKLweSample, chunk: int = 64) -> MKLweSample:
    """The full CCS multikey bootstrap: rotate-extract, then the per-party
    keyswitch."""
    u = mk_bootstrap_wo_keyswitch(ck, mu, x, chunk)
    return mk_keyswitch(ck.ks_mats, ck.params.ks, ck.params.lwe_size, u)


def mk_gate_nand(ck: CCSCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    """CCS multikey NAND: bootstrap (0, 1/8) - x - y."""
    temp = mk_lwe_noiseless_trivial(MU, ck.params.lwe, ck.parties, x.b.shape,
                                    device=x.b.device) - x - y
    return mk_bootstrap(ck, MU, temp)

"""3rd-gen multikey gate bootstrapping.

Port of torus_fhe_tpu/mk/boot3gen.py (the F-block routes). The AKÖ
external product is packed as a standard TGSW kernel (keys3gen.py), so the
multikey blind rotate is one CMux chain of parties*n steps, party p's key
bits at steps [p*n, (p+1)*n), and the accumulator stays one 2-poly RLWE
sample whatever the party count. Over the hi-word rounded key that chain is
a 32-bit one: the expanded key (``bk_fb``) runs blind_rotate.cu, the compact
key (``bk_fb_sel``) blind_rotate_sel.cu, and CPU keys their plain versions
(ops/cuda_rotate ``rotate`` / ``rotate_streamed``). At the wide-digit sets
(16 parties and up), and over a ``"conv"`` key at any set (the exact route,
``MKCloudKey.exact``), the key is not rounded: the chain runs on the 64-bit
torus over the raw samples' lines, as the torch-op scan that
``rotate_streamed`` picks from the 64-bit geometry, and the extract truncates
the int64 accumulator to the 32-bit LWE sample the keyswitch reads.

The multikey keyswitch applies every party's table to the same extracted
mask: one one-hot digit matrix against the party-concatenated tables, one
int8 product, and the b parts summed over parties.
"""

from __future__ import annotations

import torch

from ..core.params import TGswParams
from ..core.torus import decode_message
from ..lwe import LweSample
from ..ops import poly
from ..ops.cuda_rotate import rotate, rotate_streamed
from ..rlwe import RLweSample, rlwe_extract_sample
from .keys3gen import MKCloudKey, mk_fb64_geometry, mk_fb_geometry, mk_fb_supported
from .samples import MKLweSample


def hi_word(mu: int) -> int:
    """The 32-bit test-vector value of a 64-bit torus mu (a multiple of
    2^32 at the hi-word sets). A 32-bit-magnitude mu is taken as the hi
    word already."""
    mu = int(mu)
    return mu >> 32 if abs(mu) >= 1 << 31 else mu


def mk_bootstrap_wo_keyswitch(ck: MKCloudKey, mu: int, x: MKLweSample) -> LweSample:
    """Mod-switch the (parties, n) mask to Z_2N and blind-rotate the
    [mu..mu] test vector through all parties' steps, then extract. Any
    leading batch shape."""
    N = ck.params.rlwe_polynomial_degree
    lead = tuple(x.b.shape)
    B = x.b.numel()
    bara = decode_message(x.a, 2 * N).reshape(B, -1)  # party-major steps
    barb = decode_message(x.b, 2 * N).reshape(B)
    u = _fast_rotate_extract(ck, mu, bara, barb, B)
    return LweSample(u.a.reshape(lead + u.a.shape[-1:]), u.b.reshape(lead))


def _fast_rotate_extract(ck: MKCloudKey, mu: int, bara: torch.Tensor, barb: torch.Tensor,
                         B: int) -> LweSample:
    """Blind rotate over the F-block key, stepvec init, and extract. The key
    picks the route: a key with exact lines (``ck.exact``: a wide-digit set,
    or the ``"conv"`` form) runs the exact 64-bit chain over the compact
    lines of its raw samples, with the full 64-bit ``mu``, on the wide route
    (no kernel launch, as the JAX package's conv scan runs outside Pallas);
    a rounded key runs the 32-bit hi-word chain (the expanded form when the
    key has it, else the compact one). bara: (B, parties*n) int32; barb:
    (B,) int32."""
    params = ck.params
    if not ck.exact and not mk_fb_supported(params):
        raise ValueError("a wide-digit cloud key holds the exact lines of its raw samples "
                         "(the fbstream form, exact=True)")
    if ck.exact:
        if ck.bk_fb_sel is None:
            raise ValueError("an exact cloud key needs its lines (the fbstream or conv form)")
        tg64 = TGswParams(params.gsw_decomp_length, params.gsw_log2_base, 64)
        acc = rotate_streamed(None, ck.bk_fb_sel, bara, mk_fb64_geometry(params, ck.parties),
                              tg64.decomp_length, tg64.log2_base, tg64.offset,
                              stepvec=(int(mu), barb))
        return rlwe_extract_sample(RLweSample(acc))
    geom = mk_fb_geometry(params, ck.parties)
    tg32 = TGswParams(params.gsw_decomp_length, params.gsw_log2_base, 32)
    args = (geom, tg32.decomp_length, tg32.log2_base, tg32.offset)
    stepvec = (hi_word(mu), barb)
    if ck.bk_fb is not None:
        acc = rotate(None, ck.bk_fb, bara, *args, stepvec=stepvec)
    elif ck.bk_fb_sel is not None:
        acc = rotate_streamed(None, ck.bk_fb_sel, bara, *args, stepvec=stepvec)
    else:
        raise ValueError("the cloud key has neither the fblock nor the fbstream form")
    return rlwe_extract_sample(RLweSample(acc))


def ks_onehot(ck: MKCloudKey, a: torch.Tensor) -> torch.Tensor:
    """The keyswitch's one-hot int8 digit matrix of extracted masks a
    (..., N): (rows, K), K the table's row count."""
    l, lb = ck.params.ks_decomp_length, ck.params.ks_log2_base
    base = 1 << lb
    aibar = a + (1 << (32 - (1 + lb * l)))  # precision offset, wraps
    shifts = 32 - torch.arange(1, l + 1, dtype=torch.int32, device=a.device) * lb
    digits = (aibar[..., None] >> shifts) & (base - 1)  # (..., N, l)
    h = torch.arange(1, base, dtype=torch.int32, device=a.device)
    return (digits[..., None] == h).to(torch.int8).reshape(-1, ck.ks_mat.shape[0])


def mk_keyswitch(ck: MKCloudKey, u: LweSample) -> MKLweSample:
    """Per-party keyswitch of the extracted sample u (a (..., N) over the
    summed extracted keys) with one shared one-hot int8 product."""
    n, P = ck.params.lwe_size, ck.parties
    lead = tuple(u.b.shape)
    deltas = poly.int8_matmul(ks_onehot(ck, u.a), ck.ks_mat)[:, :P * (n + 1) * 4]
    deltas = poly.limb_combine(deltas.reshape(lead + (P, n + 1, 4)), 32)  # (..., P, n+1)
    b = u.b - torch.sum(deltas[..., n], dim=-1, dtype=torch.int32)
    return MKLweSample(-deltas[..., :n], b)


def mk_bootstrap(ck: MKCloudKey, mu: int, x: MKLweSample) -> MKLweSample:
    """Full multikey bootstrap: rotate-extract, then the multikey keyswitch."""
    return mk_keyswitch(ck, mk_bootstrap_wo_keyswitch(ck, mu, x))

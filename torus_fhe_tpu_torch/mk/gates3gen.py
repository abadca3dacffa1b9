"""3rd-gen multikey bootstrapped gates and integer circuits, batch-first.

Port of torus_fhe_tpu/mk/gates3gen.py: each gate is one affine combination
of multikey ciphertext batches plus one multikey bootstrap; NOT is free; MUX
is two rotate-extracts and one keyswitch. The ``_wb`` variants are the affine
parts alone, without the bootstrap. The integer circuits (ripple adders,
comparators, shift-add multiplier, sort, conv2d) keep the bit-position loops
sequential and batch everything else. A word is one MKLweSample whose
LEADING axis is the bit position (width, ..., parties, n), LSB first. Every
bootstrapped gate runs inside an ``fhe.gate`` span (utils/profiling.span).
"""

from __future__ import annotations

import torch

from ..boot.gates import EIGHTH, QUARTER, gate_span
from ..lwe import LweSample
from .boot3gen import mk_bootstrap, mk_bootstrap_wo_keyswitch, mk_keyswitch
from .keys3gen import MKCloudKey
from .samples import MKLweSample, mk_lwe_noiseless_trivial

MU = 1 << 61  # encode_message(1, 8) on the 64-bit ring torus: the test vector


def _trivial_like(ck: MKCloudKey, x: MKLweSample, mu: int) -> MKLweSample:
    return mk_lwe_noiseless_trivial(mu, ck.params.lwe, ck.parties, x.b.shape,
                                    device=x.b.device)


def mk_gate_nand_wb(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    return _trivial_like(ck, x, EIGHTH[1]) - x - y


def mk_gate_or_wb(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    return _trivial_like(ck, x, EIGHTH[1]) + x + y


def mk_gate_and_wb(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    return _trivial_like(ck, x, EIGHTH[-1]) + x + y


def mk_gate_xor_wb(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    return _trivial_like(ck, x, QUARTER[1]) + (x + y).scale(2)


@gate_span
def mk_gate_nand(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    return mk_bootstrap(ck, MU, mk_gate_nand_wb(ck, x, y))


@gate_span
def mk_gate_or(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    return mk_bootstrap(ck, MU, mk_gate_or_wb(ck, x, y))


@gate_span
def mk_gate_and(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    return mk_bootstrap(ck, MU, mk_gate_and_wb(ck, x, y))


@gate_span
def mk_gate_xor(ck: MKCloudKey, x: MKLweSample, y: MKLweSample) -> MKLweSample:
    return mk_bootstrap(ck, MU, mk_gate_xor_wb(ck, x, y))


@gate_span
def mk_gate_3and(ck: MKCloudKey, x: MKLweSample, y: MKLweSample,
                 z: MKLweSample) -> MKLweSample:
    """3-input AND in one bootstrap."""
    return mk_bootstrap(ck, MU, _trivial_like(ck, x, QUARTER[-1]) + x + y + z)


def mk_gate_not(ck: MKCloudKey, x: MKLweSample) -> MKLweSample:
    return -x


@gate_span
def mk_gate_mux(ck: MKCloudKey, x: MKLweSample, y: MKLweSample,
                z: MKLweSample) -> MKLweSample:
    """MUX(x, y, z) = x ? y : z: two rotate-extracts, one keyswitch."""
    u1 = mk_bootstrap_wo_keyswitch(ck, MU, _trivial_like(ck, x, EIGHTH[-1]) + x + y)
    u2 = mk_bootstrap_wo_keyswitch(ck, MU, _trivial_like(ck, x, EIGHTH[-1]) - x + z)
    return mk_keyswitch(ck, LweSample(u1.a + u2.a, u1.b + u2.b + EIGHTH[1]))


def mk_gate_constant(ck: MKCloudKey, values, device=None) -> MKLweSample:
    """Noiseless trivial multikey encryptions of the booleans ``values``, on
    ``device`` (None: where the cloud key lives)."""
    if device is None:
        device = ck.ks_mat.device
    values = torch.as_tensor(values, dtype=torch.bool, device=device)
    mu = torch.where(values, EIGHTH[1], EIGHTH[-1]).to(torch.int32)
    return mk_lwe_noiseless_trivial(mu, ck.params.lwe, ck.parties, values.shape,
                                    device=values.device)


BINARY_GATES = {"nand": mk_gate_nand, "or": mk_gate_or, "and": mk_gate_and,
                "xor": mk_gate_xor}
BINARY_GATES_WB = {"nand": mk_gate_nand_wb, "or": mk_gate_or_wb,
                   "and": mk_gate_and_wb, "xor": mk_gate_xor_wb}


# ---------------------------------------------------------------------------
# Integer circuits (bit axis = leading axis, LSB first). None uses
# mk_gate_3and, whose three-false row wraps.
# ---------------------------------------------------------------------------


def _bit(x: MKLweSample, i: int) -> MKLweSample:
    return MKLweSample(x.a[i], x.b[i])


def _stack_bits(bits) -> MKLweSample:
    return MKLweSample(torch.stack([b.a for b in bits]), torch.stack([b.b for b in bits]))


def _expand(x: MKLweSample, like: MKLweSample) -> MKLweSample:
    """``x`` broadcast to the shape of ``like`` (a view)."""
    return MKLweSample(x.a.expand(like.a.shape), x.b.expand(like.b.shape))


def mk_add(ck: MKCloudKey, a: MKLweSample, b: MKLweSample, cin: MKLweSample,
           width: int, with_carry: bool = False) -> MKLweSample:
    """Ripple-carry adder (mk_add_3gen): five gate bootstraps a bit."""
    out = []
    carry = cin
    for i in range(width):
        ai, bi = _bit(a, i), _bit(b, i)
        tmp1 = mk_gate_xor(ck, ai, bi)
        tmp2 = mk_gate_and(ck, ai, bi)
        out.append(mk_gate_xor(ck, tmp1, carry))
        tmp3 = mk_gate_and(ck, tmp1, carry)
        carry = mk_gate_or(ck, tmp2, tmp3)
    if with_carry:
        out.append(carry)
    return _stack_bits(out)


def mk_inv(ck: MKCloudKey, a: MKLweSample, one: MKLweSample, width: int) -> MKLweSample:
    """Bitwise NOT as XOR with an encrypted 1 (mk_inv_3gen): all bits in ONE
    batched bootstrap."""
    return mk_gate_xor(ck, a, _expand(one, a))


def mk_sub(ck: MKCloudKey, a, b, one, width: int) -> MKLweSample:
    """a - b = a + ~b + 1 (mk_sub_3gen)."""
    return mk_add(ck, a, mk_inv(ck, b, one, width), one, width)


def mk_less(ck: MKCloudKey, a, b, one, width: int) -> MKLweSample:
    """a < b = sign(a - b) (mk_less_3gen)."""
    return _bit(mk_sub(ck, a, b, one, width), width - 1)


def mk_greater(ck: MKCloudKey, a, b, one, width: int) -> MKLweSample:
    return _bit(mk_sub(ck, b, a, one, width), width - 1)


def mk_leq(ck: MKCloudKey, a, b, one, width: int) -> MKLweSample:
    return mk_gate_xor(ck, mk_greater(ck, a, b, one, width), one)


def mk_geq(ck: MKCloudKey, a, b, one, width: int) -> MKLweSample:
    return mk_gate_xor(ck, mk_less(ck, a, b, one, width), one)


def mk_int_mul(ck: MKCloudKey, a, b, zero: MKLweSample, width: int) -> MKLweSample:
    """Shift-add multiplier, low ``width`` bits (mk_int_mul_3gen). The
    width x width partial products are one bootstrap.

    As in the JAX package, the last row added is row width-1: the reference's
    final accumulation reuses its loop counter and adds row width-2 twice, so
    here decrypt(mul(a, b)) == a*b mod 2^width where the reference is wrong.
    """
    if width == 1:
        return mk_gate_and(ck, a, b)
    # barr[i, j] = a_j AND b_i, all width*width gates in one bootstrap
    shape = (width,) + tuple(a.a.shape)
    aa = MKLweSample(a.a[None].expand(shape), a.b[None].expand(shape[:-2]))
    bb = MKLweSample(b.a[:, None].expand(shape), b.b[:, None].expand(shape[:-2]))
    barr = mk_gate_and(ck, aa, bb)  # (width_b, width_a, ...)

    def row(i):
        return _stack_bits([MKLweSample(barr.a[i, j], barr.b[i, j]) for j in range(width)])

    result = [MKLweSample(barr.a[0, 0], barr.b[0, 0])]
    tmp_in = [MKLweSample(barr.a[0, j + 1], barr.b[0, j + 1]) for j in range(width - 1)] + [zero]
    for i in range(1, width):
        tmp = mk_add(ck, _stack_bits(tmp_in), row(i), zero, width, with_carry=True)
        result.append(_bit(tmp, 0))
        tmp_in = [_bit(tmp, j + 1) for j in range(width)]
    return _stack_bits(result[:width])


def mk_word_constant(ck: MKCloudKey, word: MKLweSample, value: bool) -> MKLweSample:
    """A trivial constant BIT shaped like one bit of a bit-axis word (the
    trailing batch axes of ``word``)."""
    return mk_gate_constant(ck, torch.full(tuple(word.b.shape[1:]), value, dtype=torch.bool))


def mk_subtract(ck: MKCloudKey, a: MKLweSample, b: MKLweSample, width: int) -> MKLweSample:
    """a - b = a + ~b + 1 over bit-axis words, with a trivial 1 (the
    multikey twin of circuits/words.subtract). Bit width-1 is the sign."""
    one = mk_word_constant(ck, a, True)
    return mk_add(ck, a, mk_inv(ck, b, one, width), one, width)


def mk_mux_word(ck: MKCloudKey, sel: MKLweSample, a: MKLweSample,
                b: MKLweSample) -> MKLweSample:
    """Word-wide MUX: sel ? a : b, one batched double bootstrap across the
    whole word."""
    return mk_gate_mux(ck, _expand(sel, a), a, b)


def mk_compare_swap(ck: MKCloudKey, a: MKLweSample, b: MKLweSample, width: int):
    """(min, max) of two encrypted words via subtract + MUX."""
    a_less = _bit(mk_subtract(ck, a, b, width), width - 1)
    return mk_mux_word(ck, a_less, a, b), mk_mux_word(ck, a_less, b, a)


def mk_bubble_sort(ck: MKCloudKey, word_list, width: int, payloads=None):
    """Sort encrypted words ascending; optional payload word lists move with
    their keys (sort_with_distance over multikey ciphertexts)."""
    word_list = list(word_list)
    payloads = [list(p) for p in payloads] if payloads is not None else None
    m = len(word_list)
    for i in range(m - 1):
        for j in range(m - 1 - i):
            a_less = _bit(mk_subtract(ck, word_list[j], word_list[j + 1], width), width - 1)
            lo = mk_mux_word(ck, a_less, word_list[j], word_list[j + 1])
            hi = mk_mux_word(ck, a_less, word_list[j + 1], word_list[j])
            word_list[j], word_list[j + 1] = lo, hi
            if payloads is not None:
                for p in payloads:
                    plo = mk_mux_word(ck, a_less, p[j], p[j + 1])
                    phi = mk_mux_word(ck, a_less, p[j + 1], p[j])
                    p[j], p[j + 1] = plo, phi
    return (word_list, payloads) if payloads is not None else word_list


def mk_conv2d(ck: MKCloudKey, image: MKLweSample, kernels: MKLweSample, zero: MKLweSample,
              stride: int, width: int) -> MKLweSample:
    """Encrypted integer conv2d (enc_conv2d): image (H, W, width, parties, n)
    pixel words, kernels (C, KH, KW, width, ...). Every (channel, output
    pixel) product of a tap is one wide mk_int_mul; taps accumulate with
    ripple adds. Returns (C, OH, OW, width, parties, n)."""
    H, W = image.a.shape[:2]
    C, KH, KW = kernels.a.shape[:3]
    OH, OW = (H - KH) // stride + 1, (W - KW) // stride + 1
    pix = [(i * stride, j * stride) for i in range(OH) for j in range(OW)]

    def tap(m, nn):
        # the (C, OH*OW) batch of image and kernel words of one tap, the word
        # (bit) axis moved to the front for mk_int_mul
        def lay(px, kv):
            px = torch.stack([px[y + m, x + nn] for y, x in pix])[None]
            kv = kv[:, m, nn][:, None]
            shape = (C, OH * OW) + tuple(px.shape[2:])
            return px.expand(shape).movedim(2, 0), kv.expand(shape).movedim(2, 0)

        (pa, ka), (pb, kb) = lay(image.a, kernels.a), lay(image.b, kernels.b)
        return MKLweSample(pa, pb), MKLweSample(ka, kb)

    acc = None
    for m in range(KH):
        for nn in range(KW):
            px, kv = tap(m, nn)
            zero_bit = MKLweSample(zero.a.expand(px.a.shape[1:]), zero.b.expand(px.b.shape[1:]))
            prod = mk_int_mul(ck, px, kv, zero_bit, width)
            acc = prod if acc is None else mk_add(ck, acc, prod, zero_bit, width)
    # (width, C, OH*OW, ...) -> (C, OH, OW, width, ...)
    a = acc.a.movedim(0, 2).reshape((C, OH, OW) + tuple(acc.a.shape[:1]) + tuple(acc.a.shape[3:]))
    b = acc.b.movedim(0, 2).reshape((C, OH, OW) + tuple(acc.b.shape[:1]) + tuple(acc.b.shape[3:]))
    return MKLweSample(a, b)

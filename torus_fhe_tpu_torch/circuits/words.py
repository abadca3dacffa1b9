"""Homomorphic integer-word circuits over bootstrapped gates, batch-first.

Port of torus_fhe_tpu/circuits/words.py: the 32-bit building blocks of
src/bootstrap_modules.cpp (onesComp, FullAdder, difference, bubble_sort) and
the encrypted minimum of 3-gen-mk-tfhe/tutorial.jl.

Word layout: an encrypted integer is ONE batched LweSample whose leading axis
is the bit position (width, ..., n), LSB first. The carry chain is
sequential; each step's gates run as one batched bootstrap across every word
packed in the trailing batch axes. Every gate runs on the device of the cloud
key: on the card each bootstrap is one launch of the blind-rotate kernel.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..boot import gates
from ..boot.api import CloudKey, SecretKey, decrypt, encrypt
from ..lwe import LweSample


def int_encrypt(generator: torch.Generator, sk: SecretKey, value, width: int) -> LweSample:
    """Bitwise two's-complement encryption (BitwiseEncrypt). ``value``: int
    or int array; the bit axis is prepended."""
    value = torch.as_tensor(value, dtype=torch.int64)
    bits = torch.stack([(value >> i) & 1 for i in range(width)]) == 1
    return encrypt(generator, sk, bits)


def int_decrypt(sk: SecretKey, word: LweSample, width: int) -> np.ndarray:
    """Unsigned decode of a bit-axis word (directDecrypt), as int64 numpy."""
    bits = decrypt(sk, word).cpu().numpy()
    out = np.zeros(bits.shape[1:], np.int64)
    for i in range(width):
        out += bits[i].astype(np.int64) << i
    return out


def bit(word: LweSample, i: int) -> LweSample:
    return LweSample(word.a[i], word.b[i])


def stack_bits(bits: Sequence[LweSample]) -> LweSample:
    return LweSample(torch.stack([b.a for b in bits]), torch.stack([b.b for b in bits]))


def full_adder(ck: CloudKey, a: LweSample, b: LweSample, cin: LweSample):
    """One-bit full adder from two half adders (FullAdder): sum = a^b^c,
    carry = ab + (a^b)c."""
    axb = gates.gate_xor(ck, a, b)
    s = gates.gate_xor(ck, axb, cin)
    c1 = gates.gate_and(ck, a, b)
    c2 = gates.gate_and(ck, axb, cin)
    carry = gates.gate_or(ck, c1, c2)
    return s, carry


def add(ck: CloudKey, a: LweSample, b: LweSample, cin: LweSample, width: int,
        with_carry: bool = False) -> LweSample:
    """Ripple-carry addition over bit-axis words."""
    out = []
    carry = cin
    for i in range(width):
        s, carry = full_adder(ck, bit(a, i), bit(b, i), carry)
        out.append(s)
    if with_carry:
        out.append(carry)
    return stack_bits(out)


def ones_complement(ck: CloudKey, a: LweSample) -> LweSample:
    """Bitwise NOT of a whole word, free (onesComp)."""
    return gates.gate_not(ck, a)


def subtract(ck: CloudKey, a: LweSample, b: LweSample, width: int) -> LweSample:
    """a - b = a + ~b + 1 (difference). Bit width-1 of the result is the
    borrow/sign bit (a < b for unsigned operands within width-1 bits)."""
    one = gates.gate_constant(ck, torch.ones(a.b.shape[1:], dtype=torch.bool))
    return add(ck, a, ones_complement(ck, b), one, width)


def less_than(ck: CloudKey, a: LweSample, b: LweSample, width: int) -> LweSample:
    """Sign bit of a - b. Valid when both operands fit in width-1 bits."""
    return bit(subtract(ck, a, b, width), width - 1)


def mux_word(ck: CloudKey, sel: LweSample, a: LweSample, b: LweSample,
             width: int) -> LweSample:
    """Word-wide MUX: sel ? a : b, all bits in one batched double bootstrap."""
    sel_w = LweSample(sel.a.expand(a.a.shape), sel.b.expand(a.b.shape))
    return gates.gate_mux(ck, sel_w, a, b)


def compare_swap(ck: CloudKey, a: LweSample, b: LweSample, width: int):
    """(min, max) of two encrypted words via subtract + MUX: the
    compare-and-swap of the bubble-sort network."""
    a_less = less_than(ck, a, b, width)
    lo = mux_word(ck, a_less, a, b, width)
    hi = mux_word(ck, a_less, b, a, width)
    return lo, hi


def bubble_sort(ck: CloudKey, words: Sequence[LweSample], width: int,
                payloads: Sequence[Sequence[LweSample]] | None = None):
    """Sort encrypted words ascending; optional payload words move with their
    keys (sort_with_distance)."""
    words = list(words)
    payloads = [list(p) for p in payloads] if payloads is not None else None
    n = len(words)
    for i in range(n - 1):
        for j in range(n - 1 - i):
            a_less = less_than(ck, words[j], words[j + 1], width)
            lo = mux_word(ck, a_less, words[j], words[j + 1], width)
            hi = mux_word(ck, a_less, words[j + 1], words[j], width)
            words[j], words[j + 1] = lo, hi
            if payloads is not None:
                for p in payloads:
                    plo = mux_word(ck, a_less, p[j], p[j + 1], width)
                    phi = mux_word(ck, a_less, p[j + 1], p[j], width)
                    p[j], p[j + 1] = plo, phi
    return (words, payloads) if payloads is not None else words


def minimum(ck: CloudKey, a: LweSample, b: LweSample, width: int) -> LweSample:
    """Encrypted minimum (tutorial.jl)."""
    return compare_swap(ck, a, b, width)[0]

"""Encrypted volume matching (dark-pool order matching) over 3gen multikey TFHE.

Port of torus_fhe_tpu/apps/volume_matching.py (3-gen-mk-tfhe/VolumeMatching.jl):
buy and sell volumes arrive encrypted under the parties' multikey, and the
engine computes each order's matched volume without decrypting anything:

  1. exclusive prefix sums of buy and sell volumes (sequential carry chains),
  2. total matched volume = min(Σbuy, Σsell),
  3. per order: matched_i = order_i <= total − prefix_i ? order_i : total − prefix_i.

The order index is a batch axis, so step 3 is one batched circuit for every
order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mk import gates3gen as g
from ..mk.keys3gen import MKCloudKey
from ..mk.samples import MKLweSample


def _word(x: MKLweSample, i: int) -> MKLweSample:
    """Order i of a word batch (width, m, ...)."""
    return MKLweSample(x.a[:, i], x.b[:, i])


def prefix_sums(ck: MKCloudKey, orders: MKLweSample, zero: MKLweSample, width: int):
    """Exclusive prefix sums over the order axis, out[i] = Σ_{j<i} orders[j],
    and the total Σ orders. Returns (prefixes (width, m, ...), total)."""
    m = orders.b.shape[1]
    acc = MKLweSample(zero.a.expand(orders.a[:, 0].shape), zero.b.expand(orders.b[:, 0].shape))
    outs = [acc]
    for i in range(m - 1):
        acc = g.mk_add(ck, acc, _word(orders, i), zero, width)
        outs.append(acc)
    total = g.mk_add(ck, acc, _word(orders, m - 1), zero, width)
    return MKLweSample(torch.stack([w.a for w in outs], dim=1),
                       torch.stack([w.b for w in outs], dim=1)), total


def min_word(ck: MKCloudKey, a: MKLweSample, b: MKLweSample, one: MKLweSample,
             width: int) -> MKLweSample:
    """min(a, b) via greater + word MUX."""
    a_grt_b = g.mk_greater(ck, a, b, one, width)  # sign(b - a) = a > b
    return g.mk_gate_mux(ck, g._expand(a_grt_b, a), b, a)


def volume_match(ck: MKCloudKey, buys: MKLweSample, sells: MKLweSample,
                 zero: MKLweSample, one: MKLweSample, width: int):
    """Match encrypted buy volumes against sell volumes.

    buys/sells: (width, m, parties, n) word batches; zero, one: encrypted
    bits (parties, n). Returns (matched_buys, matched_sells), same shapes.
    """
    buy_prefix, buy_total = prefix_sums(ck, buys, zero, width)
    sell_prefix, sell_total = prefix_sums(ck, sells, zero, width)
    total = min_word(ck, buy_total, sell_total, one, width)

    def matched(orders, prefix):
        m = orders.b.shape[1]
        tot = MKLweSample(total.a[:, None].expand(orders.a.shape),
                          total.b[:, None].expand(orders.b.shape))
        one_m = MKLweSample(one.a.expand((m,) + tuple(one.a.shape)), one.b.expand((m,)))
        remaining = g.mk_sub(ck, tot, prefix, one_m, width)  # total − prefix_i, every order
        # orders beyond the total get the (possibly negative) remainder, as
        # in the reference
        leq = g.mk_leq(ck, orders, remaining, one_m, width)
        return g.mk_gate_mux(ck, g._expand(leq, orders), orders, remaining)

    return matched(buys, buy_prefix), matched(sells, sell_prefix)


def match_oracle(buys, sells, width: int):
    """Plaintext answer of ``volume_match``, words mod 2^width with the
    circuit's compares (the sign bit of a difference decides)."""
    mask = (1 << width) - 1

    def greater(a, b):  # sign bit of b - a
        return ((b - a) & mask) >> (width - 1) & 1

    def side(orders, total):
        out, prefix = [], 0
        for o in orders:
            rem = (total - prefix) & mask
            out.append(int(o) & mask if not greater(int(o), rem) else rem)
            prefix = (prefix + int(o)) & mask
        return np.asarray(out, np.int64)

    sb, ss = int(np.sum(buys)) & mask, int(np.sum(sells)) & mask
    total = ss if greater(sb, ss) else sb
    return side(buys, total), side(sells, total)

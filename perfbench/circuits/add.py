"""``add`` (mk/gates3gen.mk_add; circuits/words.add is the same ripple):
the sum of two words of ``width`` bits and an encrypted carry-in of 0,
without the carry out, five gates a bit in mk_add's order: t1 = a_i ^ b_i,
t2 = a_i & b_i, s_i = t1 ^ c, t3 = t1 & c, c = t2 | t3. The operands are
drawn over the full range below 2^operand_bits."""

from __future__ import annotations

import numpy as np
import torch


def draw(rng: np.random.Generator, mix: dict) -> tuple:
    """values (2, pool, batch); two groups: the two words (2, width, pool,
    batch) and the carry-in (1, pool, batch), 0."""
    W, B, pool = mix["width"], mix["batch"], mix["pool"]
    values = rng.integers(0, 1 << mix["operand_bits"], (2, pool, B))
    bits = (values[..., None] >> np.arange(W)) & 1  # (2, pool, B, W)
    return values, [np.moveaxis(bits, -1, 1) == 1, np.zeros((1, pool, B), dtype=bool)]


def want(values: np.ndarray, mix: dict) -> np.ndarray:
    W = mix["width"]
    total = (values[0] + values[1]) % (1 << W)  # (pool, B)
    return ((total[:, None, :] >> np.arange(W)[None, :, None]) & 1) == 1


def circuit(gates, wa, wb, cin, width: int) -> tuple:
    """The t1 and t2 of every bit in one batch, then s_i and t3 of a bit in
    one batch and its carry; the last bit's t3 and carry feed nothing and
    are not evaluated."""
    (aa, ab), (ba, bb) = wa, wb
    S = ab.shape[1]
    kinds = ["xor"] * (width * S) + ["and"] * (width * S)
    oa, ob = gates(kinds, torch.cat([aa, aa]).reshape((2 * width * S,) + aa.shape[2:]),
                   torch.cat([ab, ab]).reshape(-1),
                   torch.cat([ba, ba]).reshape((2 * width * S,) + ba.shape[2:]),
                   torch.cat([bb, bb]).reshape(-1))
    t1 = (oa[:width * S].reshape(aa.shape), ob[:width * S].reshape(ab.shape))
    t2 = (oa[width * S:].reshape(aa.shape), ob[width * S:].reshape(ab.shape))
    carry, sa, sb = cin, [], []
    for i in range(width):
        k = 1 if i == width - 1 else 2
        ga, gb = gates(["xor"] * S + ["and"] * ((k - 1) * S),
                       torch.cat([t1[0][i]] * k), torch.cat([t1[1][i]] * k),
                       torch.cat([carry[0]] * k), torch.cat([carry[1]] * k))
        sa.append(ga[:S])
        sb.append(gb[:S])
        if k == 2:
            carry = gates(["or"] * S, t2[0][i], t2[1][i], ga[S:], gb[S:])
    return torch.stack(sa), torch.stack(sb)

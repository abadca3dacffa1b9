"""``less_than`` (circuits/words.less_than): the sign bit of a - b = a + ~b
+ 1 over words of ``width`` bits, a ripple of full adders (axb = a^b, s =
axb^c, carry = (a&b) | (axb&c)), for two operands below 2^operand_bits
(operand_bits < width, so the sign bit is a < b)."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import EIGHTH, wrap32


def draw(rng: np.random.Generator, mix: dict) -> tuple:
    """values (2, pool, batch); one group, the two words (2, width, pool,
    batch)."""
    W, B, pool = mix["width"], mix["batch"], mix["pool"]
    values = rng.integers(0, 1 << mix["operand_bits"], (2, pool, B))
    bits = (values[..., None] >> np.arange(W)) & 1  # (2, pool, B, W)
    return values, [np.moveaxis(bits, -1, 1) == 1]


def want(values: np.ndarray, mix: dict) -> np.ndarray:
    return (values[0] < values[1])[:, None]


def circuit(gates, wa, wb, width: int) -> tuple:
    """Only the gates that bit width-1 depends on are evaluated: the sum
    bits below it feed nothing."""
    (aa, ab), (ba, bb) = wa, wb
    nba, nbb = wrap32(-ba), wrap32(-bb)  # NOT is free
    S = ab.shape[1]
    # every a_i ^ ~b_i and a_i & ~b_i in one batch
    kinds = ["xor"] * (width * S) + ["and"] * (width * S)
    xa = torch.cat([aa, aa]).reshape((2 * width * S,) + aa.shape[2:])
    xb = torch.cat([ab, ab]).reshape(-1)
    ya = torch.cat([nba, nba]).reshape(xa.shape)
    yb = torch.cat([nbb, nbb]).reshape(-1)
    oa, ob = gates(kinds, xa, xb, ya, yb)
    axb = (oa[:width * S].reshape(aa.shape), ob[:width * S].reshape(ab.shape))
    c1 = (oa[width * S:].reshape(aa.shape), ob[width * S:].reshape(ab.shape))
    carry = (torch.zeros_like(aa[0]), torch.full_like(ab[0], EIGHTH))  # the trivial 1
    for i in range(width - 1):
        c2 = gates(["and"] * S, axb[0][i], axb[1][i], *carry)
        carry = gates(["or"] * S, c1[0][i], c1[1][i], *c2)
    return gates(["xor"] * S, axb[0][width - 1], axb[1][width - 1], *carry)

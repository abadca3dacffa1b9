"""The plain reference of what the benchmark's cells compute: TFHE gate
bootstrapping (mod-switch, blind rotate, sample extract, keyswitch) and the
circuits built from it, for the single-key scheme and for the 3rd-gen
multikey scheme.

Plain PyTorch; it imports nothing of the program under test. It reads the
raw key material that the benchmark makes from the seed (keys.py) and works
out again everything the program derives from it. Torus words are held in
int64 tensors as signed 32-bit values (``wrap32`` after every step). A
negacyclic product is a float64 matrix product against the
negacirculant matrix of one side (``negacyclic_matrix``): every partial sum
is an integer of at most 2^50 in magnitude, so float64 holds it exactly, in
any order of summation.

The definitions follow the TFHE library and the 3-gen-mk-tfhe reference:

- gadget decomposition of a 32-bit word x into l signed digits of lb bits:
  u = x + offset mod 2^32, offset = sum_p (Bg/2) 2^(32 - p lb) plus half of
  the last digit's step; digit p = ((u >> (32 - p lb)) & (Bg - 1)) - Bg/2;
- blind rotate: acc = X^-barb (0, [mu, ..., mu]); per step i
  acc += TGSW_i (x) decompose((X^bara_i - 1) acc), the external product
  sum over digit level p and polynomial j of digit[p, j] * row[p, j];
- extract: a = (m0, -m_{N-1}, ..., -m_1) per mask polynomial, b = body[0];
- keyswitch: digits of (a_i + 2^(31 - lb t)) in base 2^lb, t of them, and
  (0, b) minus the table's samples that the non-zero digits select;
- a 3gen key is the 64-bit AKO uni-encryption, rounded to its high word
  (``hi_round``); its chain is the 32-bit one over parties*n steps, party
  major, and its keyswitch applies every party's table to the one mask.

``digits_dropped`` leaves out the last gadget digits of every external
product: the control, which computes below the precision the parameters
state, and which the comparison has to refuse.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
# the affine part of each two-input gate: pre = (0, c) + k * (x + y)
EIGHTH, QUARTER = 1 << 29, 1 << 30
AFFINE = {"and": (1, -EIGHTH), "nand": (-1, EIGHTH), "or": (1, EIGHTH), "xor": (2, QUARTER)}
MU = EIGHTH  # the gate test vector, 1/8 (the 3gen set's 2^61 on the 64-bit torus, high word)
CHUNK = 2048  # rows of one reference product: bounds its memory on the card


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to signed 32-bit words."""
    return ((x + (1 << 31)) & MASK32) - (1 << 31)


def hi_round(x64: torch.Tensor) -> torch.Tensor:
    """A 64-bit torus word rounded to the nearest multiple of 2^32, as its
    high 32-bit word (signed, in int64)."""
    return (x64 + (1 << 31)) >> 32


def negacyclic_matrix(k: torch.Tensor) -> torch.Tensor:
    """k (..., N) integers -> (..., N, N) float64 T with (d @ T)[m] the
    coefficient m of the negacyclic product d * k: T[j, m] = k[m - j] for
    m >= j, -k[m - j + N] below."""
    N = k.shape[-1]
    ext = torch.cat([-k, k], dim=-1).to(torch.float64)
    idx = torch.arange(N, device=k.device)[None, :] - torch.arange(N, device=k.device)[:, None]
    return ext[..., idx + N]


def exact_product(d: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """d @ T in float64, back to int64; every value is an integer."""
    return torch.round(d.to(torch.float64) @ T).to(torch.int64)


def mul_by_monomial(p: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """p (S, ..., N) times X^e (e (S,) integers) mod X^N + 1."""
    N = p.shape[-1]
    ext = torch.cat([p, -p], dim=-1)
    e = e.reshape(e.shape + (1,) * (p.dim() - 1))
    idx = (torch.arange(N, device=p.device) - e) % (2 * N)
    return torch.gather(ext, -1, idx.expand(p.shape))


def gadget_offset(l: int, lb: int) -> int:
    off = sum((1 << (lb - 1)) << (32 - p * lb) for p in range(1, l + 1))
    if 32 - l * lb > 0:
        off += 1 << (32 - l * lb - 1)
    return off & MASK32


def decompose(x: torch.Tensor, l: int, lb: int) -> torch.Tensor:
    """x (..., N) 32-bit words -> (..., l, N) signed digits in [-Bg/2, Bg/2)."""
    u = (x + gadget_offset(l, lb)) & MASK32
    half, mask = 1 << (lb - 1), (1 << lb) - 1
    return torch.stack([((u >> (32 - p * lb)) & mask) - half for p in range(1, l + 1)], dim=-2)


def mod_switch(v: torch.Tensor, N: int) -> torch.Tensor:
    """Nearest multiple of 1/2N of a torus word, as an integer in [-N, N)."""
    shift = 32 - (2 * N).bit_length() + 1
    return wrap32(v + (1 << (shift - 1))) >> shift


def blind_rotate(bara: torch.Tensor, barb: torch.Tensor, mu: int, key: torch.Tensor,
                 l: int, lb: int, digits_dropped: int = 0) -> torch.Tensor:
    """The CMux chain from the test vector X^-barb (0, [mu..mu]).

    bara (S, steps), barb (S,) integers; key (steps, l, C, C, N) 32-bit
    words, key[i, p, j, c] the polynomial c of TGSW row (p, j). Returns the
    accumulator (S, C, N)."""
    S, steps = bara.shape
    C, N = key.shape[2], key.shape[-1]
    acc = torch.zeros((S, C, N), dtype=torch.int64, device=bara.device)
    acc[:, C - 1] = mul_by_monomial(torch.full((S, N), mu, dtype=torch.int64,
                                               device=bara.device), -barb)
    keep = l - digits_dropped
    for i in range(steps):
        t = wrap32(mul_by_monomial(acc, bara[:, i]) - acc)
        d = decompose(t, l, lb)[:, :, :keep]  # (S, C, keep, N): polynomial j, level p
        d = d.transpose(1, 2).reshape(S, keep * C * N)  # rows (p, j, coefficient)
        T = negacyclic_matrix(key[i, :keep])  # (keep, C_j, C_c, N, N)
        T = T.permute(0, 1, 3, 2, 4).reshape(keep * C * N, C * N)
        acc = wrap32(acc + exact_product(d, T).reshape(S, C, N))
    return acc


def extract(acc: torch.Tensor) -> tuple:
    """The LWE sample of the constant coefficient: a (S, k*N), b (S,)."""
    mask = acc[:, :-1]
    a = torch.cat([mask[..., :1], -mask[..., 1:].flip(-1)], dim=-1)
    return wrap32(a.reshape(a.shape[0], -1)), acc[:, -1, 0]


def keyswitch_deltas(a: torch.Tensor, table: torch.Tensor, t: int, lb: int) -> torch.Tensor:
    """Sum of the table rows that the digits of a (S, n_in) select: table
    (n_in * t * (2^lb - 1), cols) float64. Returns (S, cols) 32-bit words."""
    base = 1 << lb
    abar = (a + (1 << (32 - (1 + lb * t)))) & MASK32
    digits = torch.stack([(abar >> (32 - j * lb)) & (base - 1) for j in range(1, t + 1)], dim=-1)
    h = torch.arange(1, base, device=a.device)
    onehot = (digits[..., None] == h).reshape(a.shape[0], -1)
    return wrap32(exact_product(onehot, table))


class Reference:
    """The plain gate bootstrap of one configuration (a configs/*.json),
    over the raw key material of keys.py."""

    def __init__(self, cfg: dict, keys, digits_dropped: int = 0):
        p = cfg["params"]
        self.scheme, self.parties = cfg["scheme"], cfg["parties"]
        self.N, self.n = p["rlwe_polynomial_degree"], p["lwe_size"]
        if self.scheme == "single":
            self.l, self.lb = p["bs_decomp_length"], p["bs_log2_base"]
            self.key = keys.bk
        else:
            self.l, self.lb = p["gsw_decomp_length"], p["gsw_log2_base"]
            self.key = hi_round(keys.bk)
        self.t, self.ks_lb = p["ks_decomp_length"], p["ks_log2_base"]
        self.table = keys.ks.reshape(-1, keys.ks.shape[-1]).to(torch.float64)
        self.digits_dropped = digits_dropped

    def bootstrap(self, a: torch.Tensor, b: torch.Tensor) -> tuple:
        """The gate bootstrap of pre-activation samples a (S, n) or
        (S, parties, n), b (S,), in chunks of CHUNK rows."""
        outs = [self._bootstrap(a[s:s + CHUNK], b[s:s + CHUNK]) for s in range(0, len(b), CHUNK)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    def _bootstrap(self, a, b):
        S = b.shape[0]
        bara = mod_switch(a.reshape(S, -1), self.N)
        barb = mod_switch(b, self.N)
        acc = blind_rotate(bara, barb, MU, self.key, self.l, self.lb, self.digits_dropped)
        ea, eb = extract(acc)
        deltas = keyswitch_deltas(ea, self.table, self.t, self.ks_lb)
        if self.scheme == "single":
            return wrap32(-deltas[:, :self.n]), wrap32(eb - deltas[:, self.n])
        deltas = deltas.reshape(S, self.parties, self.n + 1)
        return wrap32(-deltas[..., :self.n]), wrap32(eb - deltas[..., self.n].sum(-1))

    def gates(self, kinds, xa, xb, ya, yb) -> tuple:
        """Two-input gates, one kind a row (``kinds``: names of AFFINE)."""
        k = torch.tensor([AFFINE[g][0] for g in kinds], dtype=torch.int64, device=xb.device)
        c = torch.tensor([AFFINE[g][1] for g in kinds], dtype=torch.int64, device=xb.device)
        ka = k.reshape((-1,) + (1,) * (xa.dim() - 1))
        return self.bootstrap(wrap32(ka * (xa + ya)), wrap32(c + k * (xb + yb)))

    def less_than(self, wa, wb, width: int) -> tuple:
        """The sign bit of a - b = a + ~b + 1, as circuits/words.less_than
        computes it (a ripple of full adders: axb = a^b, s = axb^c,
        carry = (a&b) | (axb&c)), for words (width, S, ...) of S circuits.
        Only the gates that bit width-1 depends on are evaluated: the sum
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
        oa, ob = self.gates(kinds, xa, xb, ya, yb)
        axb = (oa[:width * S].reshape(aa.shape), ob[:width * S].reshape(ab.shape))
        c1 = (oa[width * S:].reshape(aa.shape), ob[width * S:].reshape(ab.shape))
        carry = (torch.zeros_like(aa[0]), torch.full_like(ab[0], EIGHTH))  # the trivial 1
        for i in range(width - 1):
            c2 = self.gates(["and"] * S, axb[0][i], axb[1][i], *carry)
            carry = self.gates(["or"] * S, c1[0][i], c1[1][i], *c2)
        return self.gates(["xor"] * S, axb[0][width - 1], axb[1][width - 1], *carry)

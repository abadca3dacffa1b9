"""The plain reference's library: TFHE gate bootstrapping (mod-switch,
blind rotate, sample extract, keyswitch) in plain PyTorch, which every
scheme's reference (perfbench/schemes/<scheme>.py) composes, and the
entry point ``Reference``, which finds a configuration's scheme by name.

Plain PyTorch; it imports nothing of the program under test. A scheme's
reference reads the raw key material that the benchmark makes from the seed
and works out again everything the program derives from it. Torus words are
held in int64 tensors as signed 32-bit values (``wrap32`` after every step).
A negacyclic product is a float64 matrix product against the negacirculant
matrix of one side (``negacyclic_matrix``): every partial sum is an integer
of at most 2^50 in magnitude, so float64 holds it exactly, in any order of
summation.

The definitions follow the TFHE library and the 3-gen-mk-tfhe reference:

- gadget decomposition of a 32-bit word x into l signed digits of lb bits:
  u = x + offset mod 2^32, offset = sum_p (Bg/2) 2^(32 - p lb) plus half of
  the last digit's step; digit p = ((u >> (32 - p lb)) & (Bg - 1)) - Bg/2;
- blind rotate: acc = X^-barb (0, [mu, ..., mu]); per step i
  acc += TGSW_i (x) decompose((X^bara_i - 1) acc), the external product
  sum over digit level p and polynomial j of digit[p, j] * row[p, j];
- extract: a = (m0, -m_{N-1}, ..., -m_1) per mask polynomial, b = body[0];
- keyswitch: digits of (a_i + 2^(31 - lb t)) in base 2^lb, t of them, and
  (0, b) minus the table's samples that the non-zero digits select.

``digits_dropped`` leaves out the last gadget digits of every external
product: the control, which computes below the precision the parameters
state, and which the comparison has to refuse.
"""

from __future__ import annotations

import functools

import torch

from .byname import ByName

MASK32 = 0xFFFFFFFF
# the affine part of each two-input gate: pre = (0, c) + k * (x + y)
EIGHTH, QUARTER = 1 << 29, 1 << 30
AFFINE = {"and": (1, -EIGHTH), "nand": (-1, EIGHTH), "or": (1, EIGHTH), "xor": (2, QUARTER)}
MU = EIGHTH  # the gate test vector, 1/8 (the 3gen set's 2^61 on the 64-bit torus, high word)
CHUNK = 2048  # rows of one reference product: bounds its memory on the card


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to signed 32-bit words."""
    return ((x + (1 << 31)) & MASK32) - (1 << 31)


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


SCHEMES = ByName("schemes", "scheme")
CIRCUITS = ByName("circuits", "circuit")


class Gates:
    """What every scheme's plain gate bootstrap shares: the bootstrap in
    chunks of CHUNK rows (a scheme gives ``_bootstrap`` of one chunk), the
    affine step of each two-input gate, and the circuits of
    perfbench/circuits/ over these gates, found by name
    (``ref.circuit("add")(*words, width)``)."""

    def bootstrap(self, a: torch.Tensor, b: torch.Tensor) -> tuple:
        """The gate bootstrap of pre-activation samples a (S, n) or
        (S, parties, n), b (S,), in chunks of CHUNK rows."""
        outs = [self._bootstrap(a[s:s + CHUNK], b[s:s + CHUNK]) for s in range(0, len(b), CHUNK)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])

    def _bootstrap(self, a: torch.Tensor, b: torch.Tensor) -> tuple:
        raise NotImplementedError

    def gates(self, kinds, xa, xb, ya, yb) -> tuple:
        """Two-input gates, one kind a row (``kinds``: names of AFFINE)."""
        k = torch.tensor([AFFINE[g][0] for g in kinds], dtype=torch.int64, device=xb.device)
        c = torch.tensor([AFFINE[g][1] for g in kinds], dtype=torch.int64, device=xb.device)
        ka = k.reshape((-1,) + (1,) * (xa.dim() - 1))
        return self.bootstrap(wrap32(ka * (xa + ya)), wrap32(c + k * (xb + yb)))

    def circuit(self, name: str):
        """The circuit perfbench/circuits/<name>.py over these gates:
        ``(*words, width) -> (a, b)``."""
        return functools.partial(CIRCUITS[name].circuit, self.gates)


def Reference(cfg: dict, keys, digits_dropped: int = 0) -> Gates:
    """The plain gate bootstrap of one configuration (a configs/*.json) over
    the raw key material of keys.py: the ``Reference`` of
    perfbench/schemes/<scheme>.py."""
    return SCHEMES[cfg["scheme"]].Reference(cfg, keys, digits_dropped)

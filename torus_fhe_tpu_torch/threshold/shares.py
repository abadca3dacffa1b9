"""Benaloh–Leichter (t, p)-threshold sharing of ring-LWE secret keys.

Port of torus_fhe_tpu/threshold/shares.py. The access structure is the OR
over all C(p, t) groups of the AND of the group's t parties; its distribution
matrix M is block-structured, and the shares are the integer product
S = M · ρ. ``share_secret`` builds M and ρ and takes the product;
``share_secret_streaming`` draws each group's random blocks and forms the
shares without M, through the host native runtime (ops/native.py) for
t > 1 where it is available, as the JAX package does.

Within a group (sorted party ids p_1 < ... < p_t), party p_1 holds
s + Σ_j r_j and party p_{i+1} holds r_{t-1-i}; the key reconstructs as
share_1 − share_2 − ... − share_t.

The random bits come from the caller's ``torch.Generator``; shares are small
host integers (numpy int32), as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..ops import native


def ncr(n: int, r: int) -> int:
    """C(n, r), 0 outside 0 <= r <= n."""
    if r > n or n < 0 or r < 0:
        return 0
    return math.comb(n, r)


def find_parties(gid: int, t: int, p: int) -> list[int]:
    """1-based rank -> the gid-th t-subset of {1..p} in lexicographic order."""
    out: list[int] = []
    mem = 0
    for i in range(1, p):
        tmp = ncr(p - i, t - mem - 1)
        if gid > tmp:
            gid -= tmp
        else:
            out.append(i)
            mem += 1
        if mem + (p - i) == t:
            out.extend(range(i + 1, p + 1))
            break
    return out


def find_group_id(parties: Sequence[int], t: int, p: int) -> int:
    """t-subset of {1..p} -> its 1-based lexicographic rank."""
    pset = set(parties)
    mem = 0
    group = 1
    for i in range(1, p + 1):
        if i in pset:
            mem += 1
        else:
            group += ncr(p - i, t - mem - 1)
        if mem == t:
            break
    return group


def and_share_matrix(t: int, k: int) -> np.ndarray:
    """Distribution matrix of the t-party AND clause: (kt, kt), row-block 0
    = [I I ... I], row-block r = I at column block t-r."""
    eye = np.eye(k, dtype=np.int32)
    M = np.zeros((k * t, k * t), np.int32)
    for r in range(t):
        for c in range(t):
            if r == 0 or c == t - r:
                M[r * k:(r + 1) * k, c * k:(c + 1) * k] = eye
    return M


def build_distribution_matrix(t: int, k: int, p: int) -> np.ndarray:
    """OR of the C(p, t) AND clauses: (C(p,t)·k·t, k + C(p,t)·k·(t-1)); the
    first k columns, shared by every group, multiply the secret rows of ρ."""
    groups = ncr(p, t)
    A = and_share_matrix(t, k)
    F, R = A[:, :k], A[:, k:]
    rows, rcols = A.shape[0], A.shape[1] - k
    M = np.zeros((groups * rows, k + groups * rcols), np.int32)
    for g in range(groups):
        M[g * rows:(g + 1) * rows, :k] = F
        M[g * rows:(g + 1) * rows, k + g * rcols:k + (g + 1) * rcols] = R
    return M


@dataclass
class ShareSet:
    """Repo of key shares: (party, group) -> (k, N) int32."""

    t: int
    p: int
    shares: Dict[Tuple[int, int], np.ndarray] = field(default_factory=dict)

    def get(self, party: int, group: int) -> np.ndarray:
        return self.shares[(party, group)]

    def party_shares(self, party: int) -> Dict[int, np.ndarray]:
        """All shares one party holds, keyed by group."""
        return {g: s for (q, g), s in self.shares.items() if q == party}

    def subset_shares(self, parties: Sequence[int]) -> np.ndarray:
        """Stacked (t, k, N) shares of a t-subset, ascending. Dedupes, needs
        at least t unique valid party ids, and uses the first t of them."""
        order = sorted({q for q in parties if 1 <= q <= self.p})
        if len(order) < self.t:
            raise ValueError(
                f"need at least {self.t} unique party ids in 1..{self.p} for "
                f"{self.t}-out-of-{self.p} threshold decryption, got {sorted(set(parties))}")
        order = order[: self.t]
        gid = find_group_id(order, self.t, self.p)
        return np.stack([self.get(q, gid) for q in order])


def _key_array(key) -> np.ndarray:
    return np.asarray(torch.as_tensor(key).cpu(), np.int32)


def _bits(generator: torch.Generator, shape) -> np.ndarray:
    """Uniform bits from the generator, as host int32."""
    return torch.randint(0, 2, tuple(shape), generator=generator, dtype=torch.int32,
                         device=generator.device).cpu().numpy()


def _distribute(S: np.ndarray, t: int, p: int, k: int) -> ShareSet:
    """Slice the share matrix into per-(party, group) key shares."""
    repo = ShareSet(t, p)
    G = S.shape[0] // (k * t)
    S = S.reshape(G, t, k, -1)
    for g in range(1, G + 1):
        for i, party in enumerate(find_parties(g, t, p)):
            repo.shares[(party, g)] = np.asarray(S[g - 1, i], np.int32)
    return repo


def share_secret(key, t: int, p: int, generator: torch.Generator) -> ShareSet:
    """Matrix-form sharing S = M · ρ. key: (k, N) ring key coefficients; ρ
    is the key over (e - k, N) uniform bits."""
    key = _key_array(key)
    k, N = key.shape
    M = build_distribution_matrix(t, k, p)
    rho = np.concatenate([key, _bits(generator, (M.shape[1] - k, N))])
    S = M.astype(np.int64) @ rho.astype(np.int64)  # small: at most k + t bits summed
    return _distribute(S.astype(np.int32), t, p, k)


def share_secret_streaming(key, t: int, p: int, generator: torch.Generator,
                           groups: Sequence[int] | None = None) -> ShareSet:
    """The sharing without M, group by group. ``groups``: the 1-based group
    ids to generate (default: all C(p, t))."""
    key = _key_array(key)
    k, N = key.shape
    groups = list(range(1, ncr(p, t) + 1) if groups is None else groups)
    blocks = _bits(generator, (len(groups), max(t - 1, 1), k, N))  # r_0..r_{t-2}
    repo = ShareSet(t, p)
    if t > 1 and native.available():
        shares = native.bl_shares_stream(key, blocks[:, :t - 1])  # (G, t, k, N)
        for idx, g in enumerate(groups):
            for i, party in enumerate(find_parties(g, t, p)):
                repo.shares[(party, g)] = shares[idx, i]
        return repo
    for idx, g in enumerate(groups):
        parties = find_parties(g, t, p)
        repo.shares[(parties[0], g)] = key + blocks[idx, :t - 1].sum(0, dtype=np.int32)
        for i in range(1, t):
            repo.shares[(parties[i], g)] = blocks[idx, t - 1 - i]
    return repo

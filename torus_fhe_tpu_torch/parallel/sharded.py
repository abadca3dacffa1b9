"""Party-axis sharded execution: each party slot of the mesh computes its
parties' contributions on its device, and the cross-party sum lands on one
device.

Port of torus_fhe_tpu/parallel/sharded.py, where each sum is a ``psum`` over
the mesh's party axis. Here a sum is a loop over this process's party slots
that adds each slot's part on one device; on a mesh across processes each
rank sums its own slots and ``mesh.party_sum`` adds the ranks' sums, so
every rank gets the whole sum. Sums wrap mod 2^bits, so their order does
not change a word: every function is word-equal to its single-device
counterpart.

* The multikey keyswitch applies every party's table to the same one-hot
  digits of the extracted sample and sums the b parts
  (``mk.boot3gen.mk_keyswitch``).
* Threshold decryption sums the parties' signed partial decryptions
  (``threshold.decrypt``).
"""

from __future__ import annotations

import torch

from ..core import rng
from ..lwe import LweSample
from ..mk.boot3gen import ks_onehot
from ..mk.keys3gen import MKCloudKey
from ..mk.samples import MKLweSample
from ..ops import poly
from ..threshold.decrypt import party_products
from .mesh import (PARTY_AXIS, Mesh, broadcast, gather_slots, pad_to_multiple, party_sum,
                   process_rank)


def pad_parties(arr: torch.Tensor, parties: int, mesh_parties: int, axis: int = 0):
    """Zero-pad a party axis of ``parties`` entries to a multiple of
    ``mesh_parties``; returns (array, padded count). Padded slots hold zero
    key material and add exactly zero to every sum below."""
    total = pad_to_multiple(parties, mesh_parties)
    if total == parties:
        return arr, total
    shape = list(arr.shape)
    shape[axis] = total - parties
    return torch.cat([arr, arr.new_zeros(shape)], dim=axis), total


def _slots(mesh: Mesh, total: int):
    """(party range, device, whether it is this process's) of each party
    slot of the mesh."""
    devs, me = mesh.party_devices(), process_rank()
    per = total // len(devs)
    return [(slice(j * per, (j + 1) * per), d, r == me)
            for j, (d, r) in enumerate(zip(devs, mesh.party_ranks()))]


def _block_width(ck: MKCloudKey) -> tuple[int, int]:
    """One party's keyswitch columns, (n+1)*4, and that rounded up to a
    multiple of 8 (``poly.int8_matmul``)."""
    w = (ck.params.lwe_size + 1) * 4
    return w, pad_to_multiple(w, 8)


def mk_ks_tables_sharded(ck: MKCloudKey, mesh: Mesh) -> list:
    """The party-concatenated keyswitch table (K, parties*(n+1)*4, plus
    zero columns) cut into party blocks, each widened with zero columns to a
    multiple of 8, and the parties zero-padded to a multiple of the mesh's
    party slots. Returns, per party slot, its parties' blocks side by side:
    (K, P_loc * W) int8 on the slot's device, None for a slot of another
    process. Do this once at setup."""
    K, P = ck.ks_mat.shape[0], ck.parties
    w, W = _block_width(ck)
    tables = ck.ks_mat[:, :P * w].reshape(K, P, w)
    tables = torch.cat([tables, tables.new_zeros((K, P, W - w))], dim=2)
    tables, total = pad_parties(tables, P, mesh.shape[PARTY_AXIS], axis=1)
    return [tables[:, rows].reshape(K, -1).to(d) if mine else None
            for rows, d, mine in _slots(mesh, total)]


def mk_keyswitch_sharded(ck: MKCloudKey, tables: list, u: LweSample,
                         mesh: Mesh) -> MKLweSample:
    """Party-sharded multikey keyswitch: every party slot applies its
    parties' tables (``mk_ks_tables_sharded``) to the same one-hot digits
    of u; the b parts are summed and the a rows gathered in party order on
    u's device (on every rank, across processes). Returns a
    (..., P_padded, n): slice [..., :ck.parties, :] for
    ``mk.boot3gen.mk_keyswitch``'s words."""
    n = ck.params.lwe_size
    w, W = _block_width(ck)
    lead = tuple(u.b.shape)
    home = u.a.device
    onehot = ks_onehot(ck, u.a)
    total = pad_to_multiple(ck.parties, mesh.shape[PARTY_AXIS])
    per = total // mesh.shape[PARTY_AXIS]  # parties a slot
    a_parts, b_sum = {}, torch.zeros(lead, dtype=torch.int32, device=home)
    for j, (table, (_, dev, mine)) in enumerate(zip(tables, _slots(mesh, total))):
        if not mine:
            continue
        deltas = poly.int8_matmul(onehot.to(dev), table).reshape(-1, per, W)[..., :w]
        # (..., P_loc, n+1)
        deltas = poly.limb_combine(deltas.reshape(lead + (per, n + 1, 4)), 32)
        a_parts[j] = (-deltas[..., :n]).to(home)
        b_sum = b_sum + torch.sum(deltas[..., n], dim=-1, dtype=torch.int32).to(home)
    if mesh.spans_processes:
        b_sum = party_sum(b_sum)
        a_rows = gather_slots(a_parts, mesh.party_ranks(), lead + (per, n), torch.int32, home)
    else:
        a_rows = [a_parts[j] for j in range(len(tables))]
    return MKLweSample(torch.cat(a_rows, dim=-2), u.b - b_sum)


def threshold_decrypt_sharded(sample_a: torch.Tensor, shares, signs, sd: float,
                              generator: torch.Generator, mesh: Mesh) -> torch.Tensor:
    """Party-sharded t-party threshold decryption of a ring sample.

    Each party slot computes its parties' partials Σ_j shares_i[j] ⊛ a[j] +
    smudge_i, and the signed combine b + Σ_i signs_i · partial_i is summed
    on sample_a's device. sample_a: (k+1, N) torus; shares: (t, k, N) small
    ints; signs: (t,) of ±1 (party 0 carries −1 in the repo's convention).
    Each party draws its smudging noise from a generator of its own, seeded
    from ``generator``; across processes rank 0 draws the seeds and
    broadcasts them, and every rank gets the sum. Returns the plaintext
    polynomial (N,)."""
    shares = torch.as_tensor(shares)
    signs = torch.as_tensor(signs, dtype=torch.int32)
    t = shares.shape[0]
    shares, total = pad_parties(shares, t, mesh.shape[PARTY_AXIS])
    signs, _ = pad_parties(signs, t, mesh.shape[PARTY_AXIS])
    seeds = None
    if not mesh.spans_processes or process_rank() == 0:
        seeds = torch.randint(0, 2**62, (total,), generator=generator, device=generator.device)
    if mesh.spans_processes:
        seeds = broadcast(seeds, 0, (total,), torch.int64, sample_a.device)
    gens = [torch.Generator().manual_seed(s) for s in seeds.tolist()]
    a, b = sample_a[..., :-1, :], sample_a[..., -1, :]
    N, dtype = b.shape[-1], b.dtype
    out = torch.zeros_like(b)
    for rows, dev, mine in _slots(mesh, total):
        if not mine:
            continue
        partial = party_products(shares[rows].to(dev), a.to(dev))
        err = torch.stack([rng.gaussian_torus(g, 0, sd, (N,), dtype, device=dev)
                           for g in gens[rows]])
        contrib = torch.sum(signs[rows].to(device=dev, dtype=dtype)[:, None] * (partial + err),
                            dim=0, dtype=dtype)
        out = out + contrib.to(b.device)
    return b + (party_sum(out) if mesh.spans_processes else out)

"""Party-pipelined multikey blind rotation over the device mesh.

Port of torus_fhe_tpu/parallel/mk_pipeline.py. The AKÖ multikey blind rotate
is one chain of parties*n CMux steps, party p's key bits at steps
[p*n, (p+1)*n). Its key is what does not fit: the expanded F-block key of an
8-party set is ~72 GB. So the key is sharded along the party axis, each
party's n steps on the party's device, and microbatches of accumulators pass
from one party to the next, GPipe-style: with M microbatches over P parties
the schedule has M+P-1 ticks, and at tick t party p rotates microbatch t-p
through its n steps.

Party 0 starts each microbatch from the gate test vector (the kernels'
stepvec mode); parties 1..P-1 continue the accumulator handed to them (the
explicit-accumulator mode). Each party's work runs on a CUDA stream of its
own, so parties that share a card overlap; a hand-off is an event wait, and
a copy where the next party is on another card. On a mesh across processes
(``mesh.init_distributed``) each rank runs only its own parties' stages and
holds only their key shards: a hand-off to a party of another rank is a
send of the (Bm, C, N) int32 accumulator (JAX's ``ppermute``), started
without waiting for the receive, and the last party's rank broadcasts the
finished accumulators (JAX's ``psum(outputs * is_last)``). The schedule is
static Python, so the bubble ticks are skipped instead of computed on zeros.
The step order is the single chain's (party-major, as MKLweSample's
(parties, n) mask), so the result is word-equal to the single-device rotate.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.params import TGswParams
from ..core.torus import decode_message
from ..lwe import LweSample
from ..mk.boot3gen import hi_word, mk_keyswitch
from ..mk.keys3gen import MKCloudKey, hi_round_samples, mk_fb_supported
from ..ops import fblock
from ..ops.cuda_rotate import rotate, rotate_streamed
from ..rlwe import RLweSample, rlwe_extract_sample
from .mesh import (PARTY_AXIS, Mesh, broadcast, join_stream, new_stream, process_rank, recv,
                   send, use_stream)

HI_WORD_ONLY = ("the pipelined rotate serves the hi-word sets only (l*log2(Bg) <= 31 and "
                "Bg <= 2^8), as in the JAX package: it rounds every key to its hi word, which "
                "is noise-unsafe with wide digits. A wide-digit set runs the single-device "
                "64-bit scan (mk.boot3gen)")


def _local_geom(params) -> fblock.FBlockGeometry:
    """32-bit F-block geometry of ONE party's n steps."""
    return fblock.fblock_geometry(params.lwe_size, params.rlwe_polynomial_degree,
                                  params.rlwe_mask_size, params.gsw_decomp_length, 32, 0)


def _check_mesh(mesh: Mesh, parties: int) -> None:
    if mesh.shape[PARTY_AXIS] != parties:
        raise ValueError(f"the mesh has {mesh.shape[PARTY_AXIS]} party slots, want one per "
                         f"party ({parties})")


def _local_hi_samples(ck_samples, params, parties: int, mesh: Mesh) -> list:
    """The raw (parties*n, l, 2, 2, N) 64-bit samples (tensor or numpy),
    split by party and hi-word rounded for this process's parties: (n, l,
    2, 2, N) int32 each, None for a party of another process."""
    _check_mesh(mesh, parties)
    samples = (ck_samples.cpu().numpy() if isinstance(ck_samples, torch.Tensor)
               else np.asarray(ck_samples))
    n = params.lwe_size
    if not mk_fb_supported(params):
        raise NotImplementedError(HI_WORD_ONLY)
    if samples.shape[0] != parties * n:
        raise ValueError(f"{samples.shape[0]} samples, want parties*n = {parties * n}")
    me = process_rank()
    return [hi_round_samples(samples[p * n:(p + 1) * n]) if r == me else None
            for p, r in enumerate(mesh.party_ranks())]


def build_sharded_mk_fb(ck_samples, params, parties: int, mesh: Mesh) -> list:
    """The party-sharded EXPANDED key: party p's n steps of F-blocks, int8,
    built on the mesh's party-p device in the form its rotate reads
    (``fblock.build_rotate_key``: the kernel layout (n, D, ncols*bs, R*bs) on
    a CUDA device, (n, D*R*bs, ncols*bs) on the CPU); None for a party of
    another process. The full key never exists on one device, unless the
    mesh repeats it."""
    hi = _local_hi_samples(ck_samples, params, parties, mesh)
    geom = _local_geom(params)
    return [None if h is None else fblock.build_rotate_key(h, geom, dev)
            for h, dev in zip(hi, mesh.party_devices())]


def build_sharded_mk_sel(ck_samples, params, parties: int, mesh: Mesh) -> list:
    """The party-sharded COMPACT key: party p's n steps of int8 lines, built
    on the mesh's party-p device in the form its rotate reads
    (``fblock.build_sel_key``: the compact kernel layout (n, ncols, R, 2N) on
    a CUDA device, (n, R, 2N, ncols) on the CPU); None for a party of
    another process."""
    hi = _local_hi_samples(ck_samples, params, parties, mesh)
    geom = _local_geom(params)
    return [None if h is None else fblock.build_sel_key(h, geom, dev)
            for h, dev in zip(hi, mesh.party_devices())]


def _hand_over(acc: torch.Tensor, src, dst, device: torch.device) -> torch.Tensor:
    """The accumulator of the party on stream ``src`` as input of the party
    on stream ``dst`` at ``device``. Called when ``src``'s last queued work
    is the launch that made ``acc``."""
    if src is None:  # the CPU: plain calls in program order
        return acc.to(device)
    if acc.device != device:
        # the copy runs on src after the launch; dst waits for the copy
        with torch.cuda.stream(src), torch.cuda.stream(dst):
            return acc.to(device)
    dst.wait_stream(src)
    acc.record_stream(dst)  # made on src: its memory stays out of reuse until dst is done
    return acc


def mk_blind_rotate_pipelined(shards, bara: torch.Tensor, barb: torch.Tensor, mu32: int,
                              params, parties: int, mesh: Mesh,
                              microbatches: int = 4) -> torch.Tensor:
    """The pipelined multikey blind rotate. Returns the final (B, C, N)
    int32 accumulators (hi-word torus) on ``mesh.home()``, party 0's device
    in one process; on a mesh across processes every rank returns them.

    shards: per party, the expanded key from ``build_sharded_mk_fb`` or the
    compact lines from ``build_sharded_mk_sel`` (None for a party of another
    process); bara: (B, parties, n) int32 mod-switched masks (party-major);
    barb: (B,) int32; mu32: the test vector's hi word. On CUDA tensors every
    rotate launches a kernel (blind_rotate.cu for the expanded key,
    blind_rotate_sel.cu for the compact one): P*M launches over the mesh, M
    for each party.
    """
    _check_mesh(mesh, parties)
    if not mk_fb_supported(params):
        raise NotImplementedError(HI_WORD_ONLY)
    if len(shards) != parties:
        raise ValueError(f"{len(shards)} key shards for {parties} parties")
    B, M, n = bara.shape[0], microbatches, params.lwe_size
    if M < 1 or B % M:
        raise ValueError(f"batch {B} does not split into {M} microbatches")
    if tuple(bara.shape) != (B, parties, n) or tuple(barb.shape) != (B,):
        raise ValueError(f"bara {tuple(bara.shape)} and barb {tuple(barb.shape)}, want "
                         f"({B}, {parties}, {n}) and ({B},)")
    devs, owners, me = mesh.party_devices(), mesh.party_ranks(), process_rank()
    mine = [r == me for r in owners]
    if any(m and s is None for m, s in zip(mine, shards)):
        raise ValueError("a key shard of this process's parties is missing")
    Bm = B // M
    geom = _local_geom(params)
    tg32 = TGswParams(params.gsw_decomp_length, params.gsw_log2_base, 32)
    args = (geom, tg32.decomp_length, tg32.log2_base, tg32.offset)
    key = next((s for s in shards if s is not None), None)
    compact = key is not None and tuple(key.shape[1:]) in (
        (geom.R, 2 * geom.N, len(geom.cols)), fblock.sel_kernel_layout_shape(geom))
    rot = rotate_streamed if compact else rotate
    bara_p = [bara[:, p].contiguous().to(devs[p]) if mine[p] else None for p in range(parties)]
    barb0 = barb.to(devs[0]) if mine[0] else None
    streams = [new_stream(d) if m else None for d, m in zip(devs, mine)]
    accs = [None] * M  # microbatch m's accumulator, from the last party here that rotated it
    sends = []
    for t in range(M + parties - 1):
        # the receiver before its sender: when party p takes microbatch t-p,
        # party p-1's last queued launch is the one that made it
        for p in reversed(range(parties)):
            m = t - p
            if not 0 <= m < M or not mine[p]:
                continue  # a bubble tick of this party, or another rank's party
            rows = slice(m * Bm, (m + 1) * Bm)
            tag = m * parties + p
            if p == 0:
                with use_stream(streams[0]):
                    accs[m] = rot(None, shards[0], bara_p[0][rows], *args,
                                  stepvec=(mu32, barb0[rows]))
            elif mine[p - 1]:
                acc = _hand_over(accs[m], streams[p - 1], streams[p], devs[p])
                with use_stream(streams[p]):
                    accs[m] = rot(acc, shards[p], bara_p[p][rows], *args)
            else:
                with use_stream(streams[p]):
                    acc = recv((Bm, geom.C, geom.N), torch.int32, owners[p - 1], tag - 1,
                               devs[p])
                    accs[m] = rot(acc, shards[p], bara_p[p][rows], *args)
            if p + 1 < parties and not mine[p + 1]:
                with use_stream(streams[p]):
                    sends.append(send(accs[m], owners[p + 1], tag))
    if not mesh.spans_processes:
        for stream in streams[:-1]:
            join_stream(stream, [])
        join_stream(streams[-1], accs)
        return torch.cat([a.to(devs[0]) for a in accs])
    for work, _ in sends:
        work.wait()
    for dev in {d for d, st in zip(devs, streams) if st is not None}:
        torch.cuda.synchronize(dev)  # every stage, hand-off and send of this rank is done
    home = mesh.home()
    out = torch.cat([a.to(home) for a in accs]) if mine[-1] else None
    return broadcast(out, owners[-1], (B, geom.C, geom.N), torch.int32, home)


def mk_bootstrap_pipelined(ck: MKCloudKey, shards, mu, x, mesh: Mesh,
                           microbatches: int = 4):
    """The pipelined multikey bootstrap: mod-switch, the pipelined rotate,
    extract, and the per-party keyswitch (``mk.boot3gen.mk_keyswitch``, on
    the key's device, which is party 0's). ``mu``: the test vector, an int
    (its hi word by ``boot3gen.hi_word``) or a tensor (an int32 one is the
    hi word already, an int64 one is shifted down)."""
    N = ck.params.rlwe_polynomial_degree
    lead = tuple(x.b.shape)
    B = x.b.numel()
    bara = decode_message(x.a, 2 * N).reshape(B, ck.parties, -1)
    barb = decode_message(x.b, 2 * N).reshape(B)
    if isinstance(mu, torch.Tensor):
        mu32 = int(mu) if mu.dtype == torch.int32 else int(mu) >> 32
    else:
        mu32 = hi_word(mu)
    acc = mk_blind_rotate_pipelined(shards, bara, barb, mu32, ck.params, ck.parties, mesh,
                                    microbatches)
    u = rlwe_extract_sample(RLweSample(acc))
    return mk_keyswitch(ck, LweSample(u.a.reshape(lead + u.a.shape[-1:]), u.b.reshape(lead)))

"""Shared by the tests of the blind-rotate kernels' surroundings
(tests/test_torch_rotate_plan.py, test_torch_rotate_emulate.py,
test_torch_sel_emulate.py): small geometries, a random key of a geometry in
both layouts with random inputs, and the numpy emulators of the two kernels.
pytest does not collect this module.

``emulate_kernel`` repeats in numpy what csrc/blind_rotate.cu does per step,
with the kernel's byte offsets into the flat key and digit buffers, its tile
decomposition (``cuda_rotate.rotate_plan``), its reduction order (BK-byte
chunks, block m = (i - j) mod D) and its epilogue (limbs combined per
coefficient, added into the accumulator in place); for the wgmma tile of
csrc/rotate_wgmma.cuh also its cluster pairs (gate tiles 2p, 2p + 1 of one
key box, dealt to the clusters round-robin; a pair past the last gate tile
reads zero rows and stores nothing), its TMA boxes (a 2-D view of the key as
rows of R*bs bytes) and its limb-major key operand. ``emulate_sel_kernel``
does the same for csrc/blind_rotate_sel.cu, whose key operand is made on the
SM: the window of 16-byte chunks of a reversed line (wrapped mod 2N), its
three byte-shifted copies (a funnel shift a word, ``window_stride`` words
apart), and the two words a thread reads per MMA fragment.
``emulate_sel_wgmma_kernel`` does it for the compact kernel's wgmma tile
(csrc/rotate_sel_wgmma.cuh): the same windows and copies, the four words of
each thread's register fragment of A (the key: coefficient rows, digit
columns), the TMA box of digit rows and its 128-byte swizzle as the MMA's B
operand reads it, the two warpgroups' limbs (2w, 2w + 1), each limb's
accumulator, and the join of the two warpgroups' folded words.
``emulate_latency_kernel`` does it for the latency tile of
csrc/rotate_latency.cuh (config 5), under the plan's own layout
(``plan.latency``, what the launcher gets): the key boxes a block owns (key
block m, polynomial, ``units`` x 8 coefficients, every limb), the ring of
box-steps (which slot holds which step's box, filled by 3-D TMA boxes with
the 128-byte swizzle), the digit rows each block builds for its pairs (i, j
= i - d), the wgmma operands as their descriptors read them, the items the two
warpgroups take, the limbs folded per coefficient, and the exact combination
of the partials (this step's and the last) into the ping-pong accumulators.
"""

import numpy as np
import torch

from torus_fhe_tpu_torch.boot.bootstrap import bk_geometry
from torus_fhe_tpu_torch.core.params import SchemeParams, TGswParams
from torus_fhe_tpu_torch.core.params import test_parameters as make_test_params
from torus_fhe_tpu_torch.ops import cuda_rotate, fblock


def twin(N=64):
    base = make_test_params(n=12, N=N)
    return SchemeParams(**{**base.__dict__, "bs_decomp_length": 2, "bs_log2_base": 8,
                           "rlwe_mask_size": 2, "bk_drop_limbs": 1})


def odd_rows():
    """k=2, l=1: R*bs = 192, which only the 64-byte-stage tile takes."""
    return SchemeParams(**{**twin().__dict__, "bs_decomp_length": 1})


def single(params):
    tg = params.tgsw
    return bk_geometry(params), tg.decomp_length, tg.log2_base, tg.offset


def multikey(N, steps=5):
    """The 8-column multikey geometry (32-bit hi word, nothing dropped)."""
    tg = TGswParams(2, 7, 32)
    return fblock.fblock_geometry(steps, N, 1, 2, 32, 0), 2, 7, tg.offset


GEOMETRIES = {"k1_N64": lambda: single(make_test_params(n=12, N=64)),
              "k1_N256": lambda: single(make_test_params(n=12, N=256)),
              "k2_rounded_N64": lambda: single(twin()),
              "k2_l1_N64": lambda: single(odd_rows()),
              "multikey_N256": lambda: multikey(256),
              "multikey_N512": lambda: multikey(512, steps=3)}


def world(name, B, seed):
    """A random key of the geometry (the rotate's arithmetic does not depend
    on the key being an encryption) in both layouts, and random inputs."""
    geom, l, lb, offset = GEOMETRIES[name]()
    rng = np.random.default_rng(seed)
    samples = rng.integers(-2**31, 2**31, (geom.n, l, geom.C, geom.C, geom.N),
                           dtype=np.int64).astype(np.int32)
    drop = 4 * geom.C - len(geom.cols)
    if drop:  # a rounded body: its dropped low bytes are zero
        samples[..., geom.C - 1, :] &= np.int32(-(1 << (8 * drop)))
    fb = fblock.build_fblocks(samples, geom)
    acc = torch.from_numpy(rng.integers(-2**31, 2**31, (B, geom.C, geom.N)).astype(np.int32))
    bara = torch.from_numpy(rng.integers(0, 2 * geom.N, (B, geom.n)).astype(np.int32))
    barb = torch.from_numpy(rng.integers(-geom.N, geom.N, B).astype(np.int32))
    return samples, fb, acc, bara, barb, (geom, l, lb, offset)


def mk_hi_word(parties, steps=2):
    """The hi-word chain of the 3gen set of ``parties`` at full width (N =
    1024, 8 limb columns) over its first ``steps`` steps."""
    from torus_fhe_tpu_torch.core import params as P
    from torus_fhe_tpu_torch.mk import keys3gen
    p = P.PARAMETER_REGISTRY[f"mk_{parties}party_3gen"]()
    tg = TGswParams(p.gsw_decomp_length, p.gsw_log2_base, 32)
    geom = keys3gen.mk_fb_geometry(p, parties)._replace(n=steps)
    return geom, tg.decomp_length, tg.log2_base, tg.offset


SEL_GEOMETRIES = {**GEOMETRIES, "k2_rounded_N256": lambda: single(twin(256)),
                  "mk8_N1024": lambda: mk_hi_word(8)}


def tile_order(plan, nb, C, QT):
    """(mt, j, poly, qt) of a step's tiles in the order the grid deals them:
    round-robin over blocks, gate tiles of one key box side by side; for the
    wgmma tile, pair tiles round-robin over the clusters of the plan's grid,
    each pair the gate tiles 2p and 2p + 1 (by cluster rank) of one key box."""
    MT = plan.m_tiles
    if not plan.tile.wgmma or plan.tile.compact:
        for tile in range(plan.tiles):
            mt, nt = tile % MT, tile // MT
            qt, nt = nt % QT, nt // QT
            yield mt, nt // C, nt % C, qt
        return
    cluster = cuda_rotate.WGMMA_CLUSTER
    MP, clusters = -(-MT // cluster), plan.blocks // cluster
    pairs = MP * nb * C * QT
    assert plan.blocks % cluster == 0 and 1 <= clusters <= pairs
    for cid in range(clusters):
        for pt in range(cid, pairs, clusters):
            nt = pt // MP
            qt, nt = nt % QT, nt // QT
            for rank in range(cluster):
                yield cluster * (pt % MP) + rank, nt // C, nt % C, qt


def emulate_frame(acc0, bara, geom, l, lb, offset, plan, key_rows=None, tile_words=None):
    """The frame both kernels share (csrc/rotate_gemm.cuh), step by step in
    numpy: uint32 accumulator words, int8 digit rows of padded_m x K, the
    plan's tiles in the kernel's order (``tile_order``). ``key_rows(s, j,
    col, q0)`` is the (wq, K) key operand of limb column ``col`` for output
    coefficients j*bs + q0 .. + wq, in the kernel's reduction order; the
    wgmma tile stacks the limbs' operands (limb-major rows) into one. Or
    ``tile_words(s, rows, j, poly, q0)`` gives a tile's (bm, wq) uint32 words
    (its limbs folded) from its (bm, K) digit rows."""
    B, n = bara.shape
    N, C, bs, nb, R = geom.N, geom.C, geom.bs, geom.nb, geom.R
    rbs, K = R * bs, nb * R * bs
    groups = cuda_rotate.poly_groups(geom)
    bm, wq = plan.tile.bm, plan.tile.wq
    MT, QT = plan.m_tiles, bs // wq
    assert plan.tiles == MT * nb * C * QT and plan.scratch_bytes == B * K
    acc = acc0.numpy().astype(np.uint32)
    bara = bara.numpy()
    t = np.arange(N)
    lmask, half = (1 << lb) - 1, 1 << (lb - 1)
    for s in range(n):
        # phase 1: rotate by index, difference, digits in K order
        a = bara[:, s] & (2 * N - 1)
        idx = t[None, :] - (a & (N - 1))[:, None]
        wrap = idx < 0
        rot = np.take_along_axis(acc, np.broadcast_to(np.where(wrap, idx + N, idx)[:, None, :],
                                                      acc.shape), axis=2)
        rot = np.where(wrap[:, None, :], np.uint32(0) - rot, rot)
        rot = np.where((a >= N)[:, None, None], np.uint32(0) - rot, rot)
        x = rot - acc + np.uint32(offset & 0xFFFFFFFF)
        dig = np.zeros((plan.padded_m, K), np.int8)  # rows past B: zeros
        for lev in range(l):
            d = (((x >> np.uint32(32 - (lev + 1) * lb)) & np.uint32(lmask)).astype(np.int64)
                 - half).astype(np.int8)
            for c in range(C):
                for i in range(nb):
                    k0 = i * rbs + (lev * C + c) * bs
                    dig[:B, k0:k0 + bs] = d[:, c, i * bs:(i + 1) * bs]
        # phase 2: one GEMM tile after the other, in the kernel's tile order
        seen = set()
        for mt, j, poly, qt in tile_order(plan, nb, C, QT):
            m0, q0 = mt * bm, qt * wq
            if m0 >= B:  # the second tile of a pair past the last: zero rows, no store
                assert plan.tile.wgmma and mt == MT
                continue
            seen.add((mt, j, poly, qt))
            col0, nl = groups[poly]
            if tile_words is not None:
                v = tile_words(s, dig[m0:m0 + bm], j, poly, q0)
                rows_in = min(bm, B - m0)
                acc[m0:m0 + rows_in, poly, j * bs + q0:j * bs + q0 + wq] += v[:rows_in]
                continue
            A = dig[m0:m0 + bm].astype(np.int64)
            v = np.zeros((bm, wq), np.uint32)
            if plan.tile.wgmma:  # one B operand, the limbs' 64-row boxes one after the other
                op = np.concatenate([key_rows(s, j, col0 + limb, q0) for limb in range(nl)])
                sums = np.split(A @ op.astype(np.int64).T, nl, axis=1)
            else:
                sums = [A @ key_rows(s, j, col0 + limb, q0).astype(np.int64).T
                        for limb in range(nl)]
            for limb in range(nl):
                assert np.abs(sums[limb]).max() < 2**31
                v += (sums[limb].astype(np.int32).view(np.uint32)
                      << np.uint32(geom.cols[col0 + limb][1]))
            rows_in = min(bm, B - m0)  # rows past B are never stored
            acc[m0:m0 + rows_in, poly, j * bs + q0:j * bs + q0 + wq] += v[:rows_in]
        assert len(seen) == plan.tiles  # every tile once
    return torch.from_numpy(acc.view(np.int32))


def emulate_kernel(acc0, key, bara, geom, l, lb, offset, plan):
    """blind_rotate.cu: the key as flat bytes of the kernel layout, a stage
    being BK bytes of block m = (i - j) mod D of every row; the wgmma tile's
    stages are TMA boxes of 64 rows x BK bytes of the key seen as rows of
    R*bs bytes, the box of limb column col at row ((s*D + m)*ncols + col)*bs
    + q0."""
    if plan.latency is not None:
        return emulate_latency_kernel(acc0, key, bara, geom, l, lb, offset, plan)
    BK = plan.tile.bk
    bs, nb, D = geom.bs, geom.nb, geom.D
    ncols, rbs = len(geom.cols), geom.R * geom.bs
    nk_i = rbs // BK
    flat = key.numpy().reshape(-1)
    step_bytes, mblock = D * ncols * bs * rbs, ncols * bs * rbs
    rows2d = flat.reshape(-1, rbs)  # the tensor map's view
    assert rows2d.shape[0] == geom.n * D * ncols * bs

    def box_rows(s, j, col, q0):
        boxes = []
        for kc in range(nb * nk_i):
            i, kk = kc // nk_i, (kc % nk_i) * BK
            m = i - j if i >= j else i - j + D
            row = ((s * D + m) * ncols + col) * bs + q0
            boxes.append(rows2d[row:row + plan.tile.wq, kk:kk + BK])
        return np.concatenate(boxes, axis=1)  # (wq, K)

    def key_rows(s, j, col, q0):
        rows = (col * bs + q0 + np.arange(plan.tile.wq)) * rbs
        chunks = []
        for kc in range(nb * nk_i):
            i, kk = kc // nk_i, (kc % nk_i) * BK
            m = i - j if i >= j else i - j + D
            off = s * step_bytes + m * mblock + kk
            chunks.append(flat[off + rows[:, None] + np.arange(BK)[None, :]])
        return np.concatenate(chunks, axis=1)  # (wq, K)

    return emulate_frame(acc0, bara, geom, l, lb, offset, plan,
                         box_rows if plan.tile.wgmma else key_rows)


def _swizzled(rows):
    """Byte offset of byte k of row r in ``rows`` rows of 128 bytes with the
    128-byte swizzle (TMA's SWIZZLE_128B from a 1024-aligned base, and
    rotate_gemm.cuh's tile_offset<128>): 16-byte chunk k/16 XOR r % 8."""
    r, k = np.meshgrid(np.arange(rows), np.arange(128), indexing="ij")
    return r * 128 + (((k >> 4) ^ (r & 7)) << 4) + (k & 15)


def latency_boxes(plan, geom):
    """Per block of the latency tile's grid: (m, d, i0, np, poly, q0), its
    key box and its pairs (digit block i0 + p into output block i0 + p - d)."""
    nb, D, C, width = geom.nb, geom.D, geom.C, plan.latency.units * 8
    per_group = geom.bs // width
    assert plan.blocks == (2 * nb - 1) * C * per_group == cuda_rotate.latency_blocks(
        geom, plan.latency.units)
    for b in range(plan.blocks):
        group = b // per_group
        mi, poly = group // C, group % C
        m = mi if mi < nb else mi + 1
        d = m if m < nb else m - D
        yield m, d, max(d, 0), nb - abs(d), poly, (b % per_group) * width


def emulate_latency_kernel(acc0, key, bara, geom, l, lb, offset, plan):
    """csrc/rotate_latency.cuh over the kernel layout, block by block and
    step by step. The producer fills slot s % slots with step s's box once
    step s - slots has left it: per chunk kc, A tile ct (32 coefficients)
    and limb pair h, four 3-D TMA boxes (2 key columns x 8 coefficients x
    128 bytes of the key seen as (n*D*ncols, bs, R*bs)), box w at 2048*w,
    column l of it at 1024*l, swizzled; a pair past the polynomial's limbs
    is not loaded, the odd limb of a pair brings the next column's bytes.
    Each block builds the digit rows of its pairs (row p*B + gate, byte
    (lev*C + c)*bs + q of chunk k/128, swizzled; rows past np*B are stale
    bytes), reads A (row 16w + 8l + c: coefficient 8w + c, limb 2h + l)
    and B (N digit rows from row n0) through the wgmma descriptors (8-row
    groups 1024 bytes apart), folds each coefficient's limbs, and add this
    step's partial and the last into the accumulator that step s does not
    read. Items are (A tile, N tile, part of the chunks): with fewer than
    two tiles the two warpgroups split the chunks, each adding its own
    partial."""
    cfg, lay = plan.tile, plan.latency
    B, n = bara.shape
    N, C, bs, nb, D = geom.N, geom.C, geom.bs, geom.nb, geom.D
    ncols, rbs = len(geom.cols), geom.R * geom.bs
    nkc, slots, mtp = rbs // cfg.bk, lay.slots, lay.rows
    a_tiles = lay.units * 8 // cfg.coefs
    assert (cfg.coefs, cfg.bk) == (32, 128) and 1 <= slots <= cfg.most_slots
    assert mtp >= nb * B and plan.scratch_bytes == B * C * N * 4 + 16
    groups = cuda_rotate.poly_groups(geom)
    key3 = key.numpy().reshape(n * D * ncols, bs, rbs)  # the tensor map's view
    box_bytes = nkc * a_tiles * 2 * 8192
    swz = _swizzled(8)  # (8, 128) within a 1024-byte group
    tile_at = (np.arange(64)[:, None] // 8) * 1024 + swz[np.arange(64) % 8]  # (64, 128)
    dig_at = _swizzled(mtp)
    boxes = list(latency_boxes(plan, geom))
    rng = np.random.default_rng(7)
    # step s reads P[s % 2] and adds into the other; the last lands in out
    P = [acc0.numpy().astype(np.uint32).copy() for _ in range(2)]
    ring = [np.zeros((slots, box_bytes), np.int8) for _ in boxes]
    held = [[None] * slots for _ in boxes]  # which step's box a slot holds
    prev = [{} for _ in boxes]  # item -> (32, N) partial words of the last step
    lmask, half = (1 << lb) - 1, 1 << (lb - 1)
    t_idx = np.arange(N)
    bara = bara.numpy()

    def fill(b, s):
        m, _, _, _, poly, q0 = boxes[b]
        col0, nl = groups[poly]
        st = s % slots
        assert held[b][st] is None, "a slot refilled before its step was consumed"
        for kc in range(nkc):
            for ct in range(a_tiles):
                for h in range((nl + 1) // 2):
                    for w in range(4):
                        col = (s * D + m) * ncols + col0 + 2 * h
                        q = q0 + 32 * ct + 8 * w
                        at = ((kc * a_tiles + ct) * 2 + h) * 8192 + w * 2048
                        for lc in range(2):  # past the tensor's last column: zeros
                            src = key3[col + lc, q:q + 8, kc * 128:(kc + 1) * 128] \
                                if col + lc < key3.shape[0] else 0
                            ring[b][st, at + lc * 1024 + swz] = src
        held[b][st] = s

    for b in range(len(boxes)):
        for s in range(min(slots, n)):
            fill(b, s)
    for s in range(n):
        cur, nxt = P[s % 2], P[(s + 1) % 2]
        a = bara[:, s] & (2 * N - 1)
        idx = t_idx[None, :] - (a & (N - 1))[:, None]
        wrap = idx < 0
        rot = np.take_along_axis(cur, np.broadcast_to(np.where(wrap, idx + N, idx)[:, None, :],
                                                      cur.shape), axis=2)
        rot = np.where(wrap[:, None, :], np.uint32(0) - rot, rot)
        rot = np.where((a >= N)[:, None, None], np.uint32(0) - rot, rot)
        x = rot - cur + np.uint32(offset & 0xFFFFFFFF)
        digits = np.stack([(((x >> np.uint32(32 - (lev + 1) * lb)) & np.uint32(lmask))
                            .astype(np.int64) - half).astype(np.int8) for lev in range(l)])
        k = np.arange(rbs)
        lev, c, q = k // (C * bs), (k // bs) % C, k % bs
        for b, (m, d, i0, npairs, poly, q0) in enumerate(boxes):
            col0, nl = groups[poly]
            M = npairs * B
            # the block's digit rows over stale bytes
            dig = rng.integers(-128, 128, nkc * mtp * 128).astype(np.int8)
            r = np.arange(M)
            gate, i = r % B, i0 + r // B
            dig[(k // 128)[None, :] * mtp * 128 + dig_at[r[:, None], (k % 128)[None, :]]] = \
                digits[lev[None, :], gate[:, None], c[None, :], (i[:, None] * bs + q[None, :])]
            st = s % slots
            assert held[b][st] == s, "a step read a slot that holds another step's box"
            slot = ring[b][st]
            nt = cuda_rotate.latency_n_tile(M)
            ntiles = -(-M // nt)
            assert ntiles * nt <= mtp
            kparts = min(2, nkc) if a_tiles * ntiles < 2 else 1
            for item in range(a_tiles * ntiles * kparts):
                ct, tile = item % a_tiles, (item // a_tiles) % ntiles
                part, n0 = item // (a_tiles * ntiles), (item // a_tiles) % ntiles * nt
                D_h = np.zeros((2, 64, nt), np.int64)
                for kc in range(part, nkc, kparts):
                    Bm = dig[kc * mtp * 128 + dig_at[n0:n0 + nt]].astype(np.int64)  # (nt, 128)
                    for h in range((nl + 1) // 2):
                        A = slot[((kc * a_tiles + ct) * 2 + h) * 8192 + tile_at].astype(np.int64)
                        D_h[h] += A @ Bm.T
                assert np.abs(D_h).max() < 2**31
                v = np.zeros((32, nt), np.uint32)  # coefficient 8w + c of the A tile
                rows = np.arange(64)
                for h in range(2):
                    for lc in range(2):
                        limb = 2 * h + lc
                        if limb < nl:
                            sel = rows[(rows // 8) % 2 == lc]  # 16w + 8*lc + c
                            v += D_h[h][sel].astype(np.int32).view(np.uint32) << np.uint32(
                                geom.cols[col0 + limb][1])
                last = prev[b].get(item, np.zeros((32, nt), np.uint32))
                for nn in range(nt):
                    r = n0 + nn
                    if r < M:
                        pp, g_ = divmod(r, B)
                        j = i0 + pp - d
                        assert 0 <= j < nb and 0 <= i0 + pp < nb and (i0 + pp - j) % D == m
                        at = j * bs + q0 + 32 * ct
                        nxt[g_, poly, at:at + 32] += v[:, nn] + last[:, nn]
                prev[b][item] = v
            held[b][st] = None  # released; the producer refills it
            if s + slots < n:
                fill(b, s + slots)
    return torch.from_numpy(P[n % 2].view(np.int32))


SEL_WNQ = 2  # coefficient groups of eight a warp holds, in every compact tile


def emulate_sel_kernel(acc0, key, bara, geom, l, lb, offset, plan):
    """blind_rotate_sel.cu: the key as flat bytes of the compact kernel
    layout (steps, ncols, R, 2N). Per stage (BK digits u0.. of line r) and
    limb: the window of whole 16-byte chunks that starts WQ bytes before
    (u0 - t0), each chunk wrapped mod 2N; copies 1..3 of it, shifted by a
    funnel shift a word, ``window_stride`` words apart (the last word of a
    shifted copy runs past the window: poisoned here, never read there); and
    per lane (coefficient n = lane / 4 of its group of eight, bytes
    4 * (lane % 4)..) the two words of each MMA fragment."""
    cfg = plan.tile
    BK, WQ = cfg.bk, cfg.wq
    N, bs, nb, R = geom.N, geom.bs, geom.nb, geom.R
    ncols, rbs, two_n = len(geom.cols), geom.R * geom.bs, 2 * geom.N
    assert bs % BK == 0 and WQ % 16 == 0 and bs % WQ == 0
    nk_i = rbs // BK
    wlen, W = BK + WQ, cuda_rotate.window_stride(BK + WQ)
    wwords = wlen // 4
    assert W >= wwords and W % 16 == 8
    assert cfg.smem_bytes == cfg.ksplit * cfg.stages * (cfg.bm * BK + 4 * 4 * W * 4)
    flat = key.numpy().reshape(-1)
    step_bytes = ncols * R * two_n
    # word (of the four copies) that holds bytes 4*kw..4*kw+3 of coefficient
    # tl's row: warp column wn, group qg, lane coefficient n, k32 step ks,
    # half h, lane bytes kq
    tl, kw = np.meshgrid(np.arange(WQ), np.arange(BK // 4), indexing="ij")
    wn, qg, lane_n = tl // (8 * SEL_WNQ), (tl // 8) % SEL_WNQ, tl % 8
    ks, h, kq = kw // 8, (kw // 4) % 2, kw % 4
    frag_a = WQ - wn * SEL_WNQ * 8 - lane_n + 4 * kq
    frag = (frag_a & 3) * W + (frag_a >> 2) + 8 * ks - 2 * qg + 4 * h
    chunk_x = 16 * np.arange(wlen // 16)

    def key_rows(s, j, col, q0):
        pieces = []
        for kc in range(nb * nk_i):
            i, kk = kc // nk_i, (kc % nk_i) * BK
            r = kk // bs
            u0 = i * bs + kk - r * bs
            base = u0 - j * bs - q0 - WQ
            src = ((base + chunk_x) & (two_n - 1))[:, None] + np.arange(16)[None, :]
            line = s * step_bytes + (col * R + r) * two_n
            words = np.ascontiguousarray(flat[line + src.reshape(-1)]).view("<u4")
            hi = np.append(words[1:], np.uint32(0))
            smem = np.full(4 * W, 0xDEADBEEF, np.uint32)
            smem[:wwords] = words
            for sft in (1, 2, 3):
                smem[sft * W:sft * W + wwords - 1] = (
                    (words >> np.uint32(8 * sft)) | (hi << np.uint32(32 - 8 * sft)))[:-1]
            pieces.append(np.ascontiguousarray(smem[frag].astype("<u4")).view(np.int8))
        return np.concatenate(pieces, axis=1)  # (WQ, K)

    return emulate_frame(acc0, bara, geom, l, lb, offset, plan, key_rows)


def emulate_sel_wgmma_kernel(acc0, key, bara, geom, l, lb, offset, plan):
    """csrc/rotate_sel_wgmma.cuh over the compact kernel layout. Per stage kc
    of a tile (BK digits u0.. of line r) and limb: the window and its three
    shifted copies as ``emulate_sel_kernel`` makes them; the register
    fragment of A of thread ``tid`` of a warpgroup, k32 step ks: wgmma rows
    16*(tid/32) + (tid%32)/4 (+8) are the tile's coefficients tl = 8*(tid/32)
    + (tid%32)/4 (+32), bytes 4*(tid%4) (+16) of the step: the words at 0 and
    +4 from word (a%4)*W + a/4 + 8*ks, a = WQ - tl + 4*(tid%4), loaded at
    step ks, and those of row tl + 32 (-8 and -4) loaded at step 0 and at
    later steps kept from the previous step's row tl;
    the digit box written by TMA with the 128-byte swizzle (16-byte chunk c of
    row r at r*128 + (c ^ r%8)*16) and read back through the same swizzle by
    the MMA's descriptor (chunks 2*ks, 2*ks + 1). Warpgroup w adds every
    stage's products into the accumulators of limbs 2w and 2w + 1; each
    folds its limbs (sum << shift), and warpgroup 0 adds warpgroup 1's
    words."""
    cfg = plan.tile
    BK, WQ, BM = cfg.bk, cfg.wq, cfg.bm
    assert cfg.wgmma and cfg.compact and (BM, WQ, BK) == (64, 64, 128)
    N, bs, nb, R = geom.N, geom.bs, geom.nb, geom.R
    ncols, rbs, two_n = len(geom.cols), geom.R * geom.bs, 2 * geom.N
    groups = cuda_rotate.poly_groups(geom)
    assert all(nl == cuda_rotate.MAX_LIMBS for _, nl in groups) and bs % BK == 0
    nk_i = rbs // BK
    nk = nb * nk_i
    wlen, W = BK + WQ, cuda_rotate.window_stride(BK + WQ)
    wwords = wlen // 4
    assert cfg.smem_bytes == cfg.stages * (BM * BK + 4 * 4 * W * 4) + 1024 + 16 * cfg.stages \
        + 4 * BM * WQ
    flat = key.numpy().reshape(-1)
    step_bytes = ncols * R * two_n
    # the A fragment: tid, register -> coefficient of the tile and the word
    # of the copies; a register of row tl + 32 at step ks > 0 is the one of
    # row tl loaded at step ks - 1 (8 words back)
    tid, reg = np.meshgrid(np.arange(128), np.arange(4), indexing="ij")
    tl = 8 * (tid // 32) + (tid % 32) // 4
    frag_a = WQ - tl + 4 * (tid % 4)
    loaded = (frag_a & 3) * W + (frag_a >> 2) + np.array([0, 0, 4, 4])[reg]  # row tl's
    row = tl + 32 * (reg % 2)
    kbyte = 4 * (tid % 4) + 16 * (reg // 2)
    kept = reg % 2 == 1  # row tl + 32: the previous step's row tl words
    word0 = np.where(kept, loaded - 8, loaded)
    # the digit box: where TMA puts byte b of chunk c of row r, and which
    # chunk the descriptor of k32 step ks reads for row n
    r_, c_, b_ = np.meshgrid(np.arange(BM), np.arange(BK // 16), np.arange(16), indexing="ij")
    swz = r_ * BK + ((c_ ^ (r_ % 8)) << 4) + b_
    chunk_x = 16 * np.arange(wlen // 16)
    kcs = np.arange(nk)
    i_, kk_ = kcs // nk_i, (kcs % nk_i) * BK
    r_line = kk_ // bs
    u0 = i_ * bs + kk_ - r_line * bs

    def stage_key(s, col, base):
        """(nk, WQ, BK) int8: each stage's key operand as the fragments hold it."""
        src = ((base[:, None] + chunk_x[None, :]) & (two_n - 1))[:, :, None] + np.arange(16)
        line = s * step_bytes + (col * R + r_line) * two_n
        words = np.ascontiguousarray(flat[line[:, None] + src.reshape(nk, -1)]).view("<u4")
        hi = np.concatenate([words[:, 1:], np.zeros((nk, 1), np.uint32)], axis=1)
        smem = np.full((nk, 4 * W), 0xDEADBEEF, np.uint32)
        smem[:, :wwords] = words
        for sft in (1, 2, 3):
            smem[:, sft * W:sft * W + wwords - 1] = (
                (words >> np.uint32(8 * sft)) | (hi << np.uint32(32 - 8 * sft)))[:, :-1]
        op = np.zeros((nk, WQ, BK), np.int8)
        prev = smem[:, loaded - 8]  # row tl + 32 at step 0: loaded then
        for ks in range(BK // 32):
            now = smem[:, loaded + 8 * ks]
            words = np.where(kept, prev, now)
            assert (words == smem[:, word0 + 8 * ks]).all()
            prev = now  # kept for the next step's row tl + 32
            got = np.ascontiguousarray(words).view(np.int8)  # (nk, 128, 16)
            got = got.reshape(nk, 128, 4, 4)
            for rg in range(4):
                for b in range(4):
                    op[:, row[:, rg], 32 * ks + kbyte[:, rg] + b] = got[:, :, rg, b]
        return op

    def tile_words(s, rows, j, poly, q0):
        col0, nl = groups[poly]
        box = np.zeros((nk, BM * BK), np.int8)  # TMA: rows past B arrive as zeros
        box[:, swz.reshape(-1)] = rows.reshape(BM, nk, BK).transpose(1, 0, 2).reshape(nk, -1)
        digits = np.zeros((nk, BM, BK), np.int8)  # as the MMA reads them
        for ks in range(BK // 32):
            for h in range(2):
                c = 2 * ks + h
                at = np.arange(BM)[:, None] * BK + ((c ^ (np.arange(BM) % 8)) << 4)[:, None] \
                    + np.arange(16)
                digits[:, :, 16 * c:16 * c + 16] = box[:, at]
        base = u0 - j * bs - q0 - WQ
        folded = []
        for wgi in range(2):  # warpgroup wgi: limbs 2*wgi, 2*wgi + 1, every stage
            v = np.zeros((WQ, BM), np.uint32)
            for limb in (2 * wgi, 2 * wgi + 1):
                op = stage_key(s, col0 + limb, base)
                d = sum(op[kc].astype(np.float64) @ digits[kc].astype(np.float64).T
                        for kc in range(nk))
                assert np.abs(d).max() < 2**31
                v += d.astype(np.int64).astype(np.int32).view(np.uint32) << np.uint32(
                    geom.cols[col0 + limb][1])
            folded.append(v)
        return (folded[0] + folded[1]).T  # the join; (gates, coefficients)

    return emulate_frame(acc0, bara, geom, l, lb, offset, plan, tile_words=tile_words)


def mk_set(parties):
    from torus_fhe_tpu_torch.core import params as P
    from torus_fhe_tpu_torch.mk import keys3gen
    p = {2: P.mktfhe_parameters_2party_3gen, 4: P.mktfhe_parameters_4party_3gen,
         8: P.mktfhe_parameters_8party_3gen}[parties]()
    return keys3gen.mk_fb_geometry(p, parties), p.gsw_decomp_length

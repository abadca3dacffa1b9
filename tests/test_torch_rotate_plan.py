"""What surrounds the tensor-core blind-rotate kernels (csrc/blind_rotate.cu
over the expanded key, csrc/blind_rotate_sel.cu over the compact lines) and
can be checked without a card: the kernel layouts of the two keys, the plain
versions over them, the launch plans, and the kernels' own indexing.

``emulate_kernel`` repeats in numpy what the kernel does per step, with the
kernel's byte offsets into the flat key and digit buffers, its tile
decomposition (``cuda_rotate.rotate_plan``), its reduction order (BK-byte
chunks, block m = (i - j) mod D) and its epilogue (limbs combined per
coefficient, added into the accumulator in place). It must be word-equal to
``fblock.blind_rotate_fblock`` (exact integer arithmetic), which the other
test files hold against the JAX package. ``emulate_sel_kernel`` does the same
for the compact kernel, whose key operand is made on the SM: the window of
16-byte chunks of a reversed line (wrapped mod 2N), its three byte-shifted
copies (a funnel shift a word, ``window_stride`` words apart), and the two
words a thread reads per MMA fragment. It must be word-equal to
``fblock.blind_rotate_streamed``. All inputs come from a numpy seed; the
tolerance is 0 (exact integers).
"""

import numpy as np
import pytest
import torch

from torus_fhe_tpu_torch.boot.bootstrap import bk_geometry
from torus_fhe_tpu_torch.core.params import SchemeParams, TGswParams
from torus_fhe_tpu_torch.core.params import test_parameters as make_test_params
from torus_fhe_tpu_torch.ops import cuda_rotate, fblock


def _twin(N=64):
    base = make_test_params(n=12, N=N)
    return SchemeParams(**{**base.__dict__, "bs_decomp_length": 2, "bs_log2_base": 8,
                           "rlwe_mask_size": 2, "bk_drop_limbs": 1})


def _odd_rows():
    """k=2, l=1: R*bs = 192, which only the 64-byte-stage tile takes."""
    return SchemeParams(**{**_twin().__dict__, "bs_decomp_length": 1})


def _single(params):
    tg = params.tgsw
    return bk_geometry(params), tg.decomp_length, tg.log2_base, tg.offset


def _multikey(N, steps=5):
    """The 8-column multikey geometry (32-bit hi word, nothing dropped)."""
    tg = TGswParams(2, 7, 32)
    return fblock.fblock_geometry(steps, N, 1, 2, 32, 0), 2, 7, tg.offset


GEOMETRIES = {"k1_N64": lambda: _single(make_test_params(n=12, N=64)),
              "k1_N256": lambda: _single(make_test_params(n=12, N=256)),
              "k2_rounded_N64": lambda: _single(_twin()),
              "k2_l1_N64": lambda: _single(_odd_rows()),
              "multikey_N256": lambda: _multikey(256),
              "multikey_N512": lambda: _multikey(512, steps=3)}


def _world(name, B, seed):
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


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_kernel_layout_is_a_permutation_of_fb(name):
    samples, fb, _, _, _, (geom, *_) = _world(name, 1, 0)
    key = fblock.to_kernel_layout(fb, geom, chunk=5)  # ragged last chunk
    D, cols, rbs = fblock.kernel_layout_shape(geom)
    assert key.shape == (geom.n, D, cols, rbs) and key.is_contiguous() and key.dtype == torch.int8
    assert (D, cols, rbs) == (geom.D, len(geom.cols) * geom.bs, geom.R * geom.bs)
    # byte for byte: kernel[s, m, col, k] = fb[s, m*R*bs + k, col]
    np.testing.assert_array_equal(
        key.numpy(), fb.numpy().reshape(geom.n, D, rbs, cols).transpose(0, 1, 3, 2))
    assert torch.equal(fblock.from_kernel_layout(key, geom), fb)
    sel = torch.from_numpy(fblock.build_sel(samples, geom))
    assert torch.equal(fblock.expand_kernel_chunk(sel, geom), key)
    # on the CPU a key keeps the build_fblocks layout
    assert torch.equal(fblock.build_rotate_key(samples, geom, "cpu"), fb)
    with pytest.raises(ValueError):
        fblock.to_kernel_layout(key, geom)
    with pytest.raises(ValueError):
        fblock.from_kernel_layout(fb, geom)


@pytest.mark.parametrize("name", ["k1_N256", "k2_rounded_N64", "multikey_N256"])
def test_plain_version_reads_both_layouts(name):
    _, fb, acc, bara, barb, args = _world(name, 3, 1)
    key = fblock.to_kernel_layout(fb, args[0])
    for a, sv in ((acc, None), (None, (-(1 << 29), barb))):
        want = fblock.blind_rotate_fblock(a, fb, bara, *args, stepvec=sv)
        assert torch.equal(fblock.blind_rotate_fblock(a, key, bara, *args, stepvec=sv), want)
        assert torch.equal(cuda_rotate.rotate(a, key, bara, *args, stepvec=sv), want)


def _emulate(acc0, bara, geom, l, lb, offset, plan, key_rows):
    """The frame both kernels share (csrc/rotate_gemm.cuh), step by step in
    numpy: uint32 accumulator words, int8 digit rows of padded_m x K, the
    plan's tiles in the kernel's order. ``key_rows(s, j, col, q0)`` is the
    (wq, K) key operand of limb column ``col`` for output coefficients
    j*bs + q0 .. + wq, in the kernel's reduction order."""
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
        for tile in range(plan.tiles):
            mt, nt = tile % MT, tile // MT
            qt, nt = nt % QT, nt // QT
            poly, j = nt % C, nt // C
            m0, q0 = mt * bm, qt * wq
            col0, nl = groups[poly]
            A = dig[m0:m0 + bm].astype(np.int64)
            v = np.zeros((bm, wq), np.uint32)
            for limb in range(nl):
                sums = A @ key_rows(s, j, col0 + limb, q0).astype(np.int64).T
                assert np.abs(sums).max() < 2**31
                v += sums.astype(np.int32).view(np.uint32) << np.uint32(geom.cols[col0 + limb][1])
            rows_in = min(bm, B - m0)  # rows past B are never stored
            acc[m0:m0 + rows_in, poly, j * bs + q0:j * bs + q0 + wq] += v[:rows_in]
    return torch.from_numpy(acc.view(np.int32))


def emulate_kernel(acc0, key, bara, geom, l, lb, offset, plan):
    """blind_rotate.cu: the key as flat bytes of the kernel layout, a stage
    being BK bytes of block m = (i - j) mod D of every row."""
    BK = plan.tile.bk
    bs, nb, D = geom.bs, geom.nb, geom.D
    ncols, rbs = len(geom.cols), geom.R * geom.bs
    nk_i = rbs // BK
    flat = key.numpy().reshape(-1)
    step_bytes, mblock = D * ncols * bs * rbs, ncols * bs * rbs

    def key_rows(s, j, col, q0):
        rows = (col * bs + q0 + np.arange(plan.tile.wq)) * rbs
        chunks = []
        for kc in range(nb * nk_i):
            i, kk = kc // nk_i, (kc % nk_i) * BK
            m = i - j if i >= j else i - j + D
            off = s * step_bytes + m * mblock + kk
            chunks.append(flat[off + rows[:, None] + np.arange(BK)[None, :]])
        return np.concatenate(chunks, axis=1)  # (wq, K)

    return _emulate(acc0, bara, geom, l, lb, offset, plan, key_rows)


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

    return _emulate(acc0, bara, geom, l, lb, offset, plan, key_rows)


# (B, SM count): 3 gates take the 16 x 8 tile, 20 gates the 64 x 16 one on a
# large card and the 128 x 32 one on a card of one SM, where 200 gates take
# the 256 x 32 one; 70 gates are ragged against 64. R*bs = 192 (k2_l1_N64)
# takes the 64 x 16 tile with 64-byte stages at every batch
@pytest.mark.parametrize("B, sms, tile", [(3, 132, (16, 8)), (20, 132, (64, 16)),
                                          (70, 132, (64, 16)), (20, 1, (128, 32)),
                                          (200, 1, (256, 32))])
@pytest.mark.parametrize("name", ["k1_N256", "k2_rounded_N64", "k2_l1_N64", "multikey_N512"])
def test_kernel_emulation_equals_plain_version(name, B, sms, tile):
    _, fb, acc, bara, barb, args = _world(name, B, 2)
    geom, l, lb, offset = args
    key = fblock.to_kernel_layout(fb, geom)
    plan = cuda_rotate.rotate_plan(B, geom, l, sms)
    narrow = name == "k2_l1_N64"
    assert (plan.tile.bm, plan.tile.wq) == ((64, 16) if narrow else tile)
    assert plan.tile.bk == (64 if narrow else 128)
    got = emulate_kernel(acc, key, bara, geom, l, lb, offset, plan)
    assert torch.equal(got, fblock.blind_rotate_fblock(acc, fb, bara, *args))
    mu = -(1 << 29)
    got = emulate_kernel(fblock.stepvec_acc0(mu, barb, geom), key, bara, geom, l, lb, offset, plan)
    assert torch.equal(got, fblock.blind_rotate_fblock(None, fb, bara, *args, stepvec=(mu, barb)))


SEL_GEOMETRIES = {**GEOMETRIES, "k2_rounded_N256": lambda: _single(_twin(256))}


@pytest.mark.parametrize("name", ["k1_N64", "k2_rounded_N64", "multikey_N256", "multikey_N512"])
def test_sel_kernel_layout_is_a_permutation_of_the_lines(name):
    samples, _, acc, bara, barb, args = _world(name, 3, 3)
    geom = args[0]
    lines = torch.from_numpy(fblock.build_sel(samples, geom))
    key = fblock.to_sel_kernel_layout(lines, geom, chunk=5)  # ragged last chunk
    ncols, R, two_n = fblock.sel_kernel_layout_shape(geom)
    assert (ncols, R, two_n) == (len(geom.cols), geom.R, 2 * geom.N)
    assert key.shape == (geom.n, ncols, R, two_n) and key.is_contiguous()
    assert key.dtype == torch.int8 and key.numel() == lines.numel()
    # byte for byte: kernel[s, ci, r, g] = lines[s, r, (-g) mod 2N, ci]
    rev = (-np.arange(two_n)) % two_n
    np.testing.assert_array_equal(key.numpy(), lines.numpy()[:, :, rev].transpose(0, 3, 1, 2))
    assert torch.equal(fblock.from_sel_kernel_layout(key, geom), lines)
    assert torch.equal(torch.from_numpy(fblock.build_sel_kernel_layout(samples, geom)), key)
    # on the CPU a key keeps build_sel's layout
    assert torch.equal(fblock.build_sel_key(samples, geom, "cpu"), lines)
    with pytest.raises(ValueError):
        fblock.to_sel_kernel_layout(key, geom)
    with pytest.raises(ValueError):
        fblock.from_sel_kernel_layout(lines, geom)
    # the plain version and the CPU dispatch read both layouts
    for a, sv in ((acc, None), (None, (-(1 << 29), barb))):
        want = fblock.blind_rotate_streamed(a, lines, bara, *args, stepvec=sv)
        assert torch.equal(fblock.blind_rotate_streamed(a, key, bara, *args, stepvec=sv), want)
        assert torch.equal(fblock.blind_rotate_streamed(a, key, bara, *args, stepvec=sv,
                                                        chunk=2), want)
        assert torch.equal(cuda_rotate.rotate_streamed(a, key, bara, *args, stepvec=sv), want)


# (B, SM count) -> tile at multikey_N256 (32, 16, 8 column tiles of 16, 32, 64
# coefficients): below, at and above one gate tile, every tile shape
SEL_CASES = {(3, 132): (16, 16), (16, 132): (16, 16), (20, 132): (64, 16), (64, 132): (64, 16),
             (70, 40): (64, 32), (70, 16): (64, 64), (130, 1): (128, 64)}


# every case at the 3gen N=256 twin and at N=64 (64-byte stages); the split
# tile, a ragged middle one and the widest at the N=512 and the 11-column twins
@pytest.mark.parametrize("name, B, sms", [
    (name, B, sms) for name in ("multikey_N256", "k2_rounded_N64") for B, sms in SEL_CASES] + [
    (name, B, sms) for name in ("multikey_N512", "k2_rounded_N256")
    for B, sms in ((3, 132), (70, 16), (130, 1))])
def test_sel_kernel_emulation_equals_plain_version(name, B, sms):
    geom, l, lb, offset = SEL_GEOMETRIES[name]()
    geom = geom._replace(n=2 if B > 20 else 3)  # a second step reads what the first wrote
    rng = np.random.default_rng(4)
    samples = rng.integers(-2**31, 2**31, (geom.n, l, geom.C, geom.C, geom.N),
                           dtype=np.int64).astype(np.int32)
    lines = torch.from_numpy(fblock.build_sel(samples, geom))
    key = fblock.to_sel_kernel_layout(lines, geom)
    acc = torch.from_numpy(rng.integers(-2**31, 2**31, (B, geom.C, geom.N)).astype(np.int32))
    bara = torch.from_numpy(rng.integers(0, 2 * geom.N, (B, geom.n)).astype(np.int32))
    barb = torch.from_numpy(rng.integers(-geom.N, geom.N, B).astype(np.int32))
    args = (geom, l, lb, offset)
    plan = cuda_rotate.sel_plan(B, geom, l, sms)
    assert plan.tile is cuda_rotate.SEL_CONFIGS[plan.config] and plan.tile.compact
    if geom.bs == 64:  # a stage stays inside one line: 64-byte stages
        assert (plan.tile.bm, plan.tile.wq, plan.tile.bk) == (64, 16, 64)
    else:
        assert plan.tile.bk == 128
        if name == "multikey_N256":
            assert (plan.tile.bm, plan.tile.wq) == SEL_CASES[B, sms]
    got = emulate_sel_kernel(acc, key, bara, *args, plan)
    assert torch.equal(got, fblock.blind_rotate_streamed(acc, lines, bara, *args))
    mu = -(1 << 29)
    got = emulate_sel_kernel(fblock.stepvec_acc0(mu, barb, geom), key, bara, *args, plan)
    assert torch.equal(got, fblock.blind_rotate_streamed(None, lines, bara, *args,
                                                         stepvec=(mu, barb)))


def _mk_set(parties):
    from torus_fhe_tpu_torch.core import params as P
    from torus_fhe_tpu_torch.mk import keys3gen
    p = {2: P.mktfhe_parameters_2party_3gen, 4: P.mktfhe_parameters_4party_3gen,
         8: P.mktfhe_parameters_8party_3gen}[parties]()
    return keys3gen.mk_fb_geometry(p, parties), p.gsw_decomp_length


# the 8-party set (N=1024, C=2, l=4: 128 / 64 / 32 column tiles of 16 / 32 /
# 64 coefficients) on the 132 SMs of an H100: (tile, tiles a step, grid asked
# for, shared memory a block, digit scratch)
@pytest.mark.parametrize("B, tile, tiles, blocks, smem, scratch", [
    (1, (16, 16), 128, 128, 8 * 4 * (16 * 128 + 2560), 8192),      # eight warps split K
    (64, (64, 16), 128, 128, 4 * 4 * (64 * 128 + 2560), 64 * 8192),  # four groups of four
    (256, (64, 64), 128, 128, 4 * (64 * 128 + 3584), 256 * 8192),
    (1024, (128, 64), 256, 132, 4 * (128 * 128 + 3584), 1024 * 8192)])
def test_sel_plan_at_the_8_party_set(B, tile, tiles, blocks, smem, scratch):
    geom, l = _mk_set(8)
    plan = cuda_rotate.sel_plan(B, geom, l, 132)
    assert (plan.tile.bm, plan.tile.wq) == tile and plan.tile.bk == 128
    assert (plan.tiles, plan.blocks, plan.smem_bytes, plan.scratch_bytes) == \
        (tiles, blocks, smem, scratch)
    assert plan.m_tiles == -(-B // tile[0]) and plan.padded_m == plan.m_tiles * tile[0]
    assert plan.waves == tiles / 132 and plan.fill == (tiles / 264 if tiles > 132 else 1.0)
    # every block of the grid is resident at once: shared memory, threads
    per_sm = -(-plan.blocks // 132)
    assert per_sm * (plan.smem_bytes + 1024) <= 228 * 1024
    assert per_sm * plan.tile.threads <= 2048 and per_sm <= plan.tile.resident


def test_sel_plan_takes_what_the_expanded_plan_takes():
    """Every registered geometry: the 3gen sets, the single-key sets (k = 2,
    11 columns), and the small test ones. A polynomial with five limb
    columns and an R that is not l*C are refused by both plans, bs = 32 (no
    64-byte stage fits a line) by the compact one."""
    from torus_fhe_tpu_torch.boot.bootstrap import bk_geometry
    from torus_fhe_tpu_torch.core import params as P
    for parties in (2, 4, 8):
        geom, l = _mk_set(parties)
        assert cuda_rotate.sel_plan(256, geom, l, 132).tile.wq == 64
    for name in ("tfhe_128_tpu_fast", "tfhe_128_tpu"):
        p = P.PARAMETER_REGISTRY[name]()
        plan = cuda_rotate.sel_plan(1024, bk_geometry(p), p.bs_decomp_length, 132)
        assert plan.tile.bk == 128 and plan.tile.wq == 64
    for name in SEL_GEOMETRIES:
        geom, l, _, _ = SEL_GEOMETRIES[name]()
        assert cuda_rotate.sel_plan(5, geom, l, 132).tile.bk == min(128, geom.bs)
    geom, l, _, _ = GEOMETRIES["k1_N64"]()
    for bad in (geom._replace(cols=((0, 0),) * 5 + geom.cols[4:]), geom._replace(R=geom.R + 1)):
        for plan in (cuda_rotate.sel_plan, cuda_rotate.rotate_plan):
            with pytest.raises(ValueError):
                plan(4, bad, l, 132)
    for B, g in ((4, geom._replace(N=32, bs=32, nb=1, D=2)), (0, geom)):
        with pytest.raises(ValueError):
            cuda_rotate.sel_plan(B, g, l, 132)

"""What surrounds the tensor-core blind-rotate kernel (csrc/blind_rotate.cu)
and can be checked without a card: the kernel layout of the expanded key, the
plain version over it, and the kernel's own indexing.

``emulate_kernel`` repeats in numpy what the kernel does per step, with the
kernel's byte offsets into the flat key and digit buffers, its tile
decomposition (``cuda_rotate.rotate_plan``), its reduction order (BK-byte
chunks, block m = (i - j) mod D) and its epilogue (limbs combined per
coefficient, added into the accumulator in place). It must be word-equal to
``fblock.blind_rotate_fblock`` (exact integer arithmetic), which the other
test files hold against the JAX package.
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


def emulate_kernel(acc0, key, bara, geom, l, lb, offset, plan):
    """blind_rotate.cu step by step in numpy: uint32 accumulator words, int8
    digit rows of padded_m x K, the key as flat bytes of the kernel layout."""
    BK = plan.tile.bk
    B, n = bara.shape
    N, C, bs, nb, D, R = geom.N, geom.C, geom.bs, geom.nb, geom.D, geom.R
    ncols = len(geom.cols)
    rbs, K = R * bs, nb * R * bs
    nk_i = rbs // BK
    flat = key.numpy().reshape(-1)
    step_bytes, mblock = D * ncols * bs * rbs, ncols * bs * rbs
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
                rows = ((col0 + limb) * bs + q0 + np.arange(wq)) * rbs
                chunks = []
                for kc in range(nb * nk_i):
                    i, kk = kc // nk_i, (kc % nk_i) * BK
                    m = i - j if i >= j else i - j + D
                    off = s * step_bytes + m * mblock + kk
                    chunks.append(flat[off + rows[:, None] + np.arange(BK)[None, :]])
                Bt = np.concatenate(chunks, axis=1).astype(np.int64)  # (wq, K)
                sums = A @ Bt.T
                assert np.abs(sums).max() < 2**31
                v += sums.astype(np.int32).view(np.uint32) << np.uint32(geom.cols[col0 + limb][1])
            rows_in = min(bm, B - m0)  # rows past B are never stored
            acc[m0:m0 + rows_in, poly, j * bs + q0:j * bs + q0 + wq] += v[:rows_in]
    return torch.from_numpy(acc.view(np.int32))


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

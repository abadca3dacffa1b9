"""What surrounds the tensor-core blind-rotate kernels (csrc/blind_rotate.cu
over the expanded key, csrc/blind_rotate_sel.cu over the compact lines) and
can be checked without a card: the kernel layouts of the two keys, the plain
versions over them, and the launch plans. The kernels' own indexing is
emulated in tests/test_torch_rotate_emulate.py (expanded key) and
tests/test_torch_sel_emulate.py (compact key); the three files share
tests/_torch_rotate_helpers.py. All inputs come from a numpy seed; the
tolerance is 0 (exact integers).
"""

import numpy as np
import pytest
import torch
from _torch_rotate_helpers import GEOMETRIES, SEL_GEOMETRIES, mk_set, world

from torus_fhe_tpu_torch.ops import cuda_rotate, fblock


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_kernel_layout_is_a_permutation_of_fb(name):
    samples, fb, _, _, _, (geom, *_) = world(name, 1, 0)
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
    _, fb, acc, bara, barb, args = world(name, 3, 1)
    key = fblock.to_kernel_layout(fb, args[0])
    for a, sv in ((acc, None), (None, (-(1 << 29), barb))):
        want = fblock.blind_rotate_fblock(a, fb, bara, *args, stepvec=sv)
        assert torch.equal(fblock.blind_rotate_fblock(a, key, bara, *args, stepvec=sv), want)
        assert torch.equal(cuda_rotate.rotate(a, key, bara, *args, stepvec=sv), want)


@pytest.mark.parametrize("name", ["k1_N64", "k2_rounded_N64", "multikey_N256", "multikey_N512"])
def test_sel_kernel_layout_is_a_permutation_of_the_lines(name):
    samples, _, acc, bara, barb, args = world(name, 3, 3)
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


# the wgmma tile's shared memory: per stage a digit box of 64 x 128 bytes and
# four limbs' windows (four copies of 56 words), 1 KiB to align the ring, a
# full and an empty mbarrier a stage, the join of 64 x 64 words
WGMMA_SMEM = 8 * (64 * 128 + 4 * 4 * 56 * 4) + 1024 + 8 * 16 + 64 * 64 * 4


# the 8-party set (N=1024, C=2, l=4: 128 / 64 / 32 column tiles of 16 / 32 /
# 64 coefficients) on the 132 SMs of an H100: (tile, wgmma, tiles a step,
# grid asked for, shared memory a block, digit scratch). Up to 64 gates the
# mma.sync tiles that split the reduction; above, the wgmma tile, at half the
# SMs (96 gates) as at four rounds of them (1024)
@pytest.mark.parametrize("B, tile, wgmma, tiles, blocks, smem, scratch", [
    (1, (16, 16), False, 128, 128, 8 * 4 * (16 * 128 + 2560), 8192),  # eight warps split K
    (64, (64, 16), False, 128, 128, 4 * 4 * (64 * 128 + 2560), 64 * 8192),  # four groups of four
    (96, (64, 64), True, 64, 64, WGMMA_SMEM, 96 * 8192),
    (256, (64, 64), True, 128, 128, WGMMA_SMEM, 256 * 8192),
    (1024, (64, 64), True, 512, 132, WGMMA_SMEM, 1024 * 8192)])
def test_sel_plan_at_the_8_party_set(B, tile, wgmma, tiles, blocks, smem, scratch):
    geom, l = mk_set(8)
    plan = cuda_rotate.sel_plan(B, geom, l, 132)
    assert (plan.tile.bm, plan.tile.wq) == tile and plan.tile.bk == 128
    assert plan.tile.wgmma == wgmma == (plan.config == cuda_rotate.SEL_WGMMA_CONFIG)
    assert (plan.tiles, plan.blocks, plan.smem_bytes, plan.scratch_bytes) == \
        (tiles, blocks, smem, scratch)
    assert plan.m_tiles == -(-B // tile[0]) and plan.padded_m == plan.m_tiles * tile[0]
    assert plan.waves == tiles / 132
    assert plan.fill == (tiles / (-(-tiles // 132) * 132) if tiles > 132 else 1.0)
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
        geom, l = mk_set(parties)
        assert cuda_rotate.sel_plan(256, geom, l, 132).tile.wq == 64
    for name in ("tfhe_128_tpu_fast", "tfhe_128_tpu"):
        p = P.PARAMETER_REGISTRY[name]()
        plan = cuda_rotate.sel_plan(1024, bk_geometry(p), p.bs_decomp_length, 132)
        assert plan.tile.bk == 128 and (plan.tile.bm, plan.tile.wq) == (64, 16)
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


def test_every_tile_is_reached():
    """Each tile of both kernels is the plan's pick for some registry set,
    with the key form the program builds for it (the expanded key at the
    single-key sets; ``keys3gen.default_forms``' at the 3gen sets, at their
    party count), at some B in 1..4,096 on the 132 SMs of an H100. The one
    exception is each kernel's tile of 64-byte stages, which no registry set
    needs: it is the only tile its plan takes, at every B, for a geometry
    whose 128-byte stages do not divide (bs = 64 on the compact kernel, R*bs
    an odd multiple of 64 on the expanded one). A tile that neither holds
    for is code that no launch runs."""
    from torus_fhe_tpu_torch.boot.bootstrap import bk_geometry
    from torus_fhe_tpu_torch.core import params as P
    from torus_fhe_tpu_torch.mk import keys3gen
    rotate_plan, sel_plan = cuda_rotate.rotate_plan, cuda_rotate.sel_plan
    reached = {rotate_plan: set(), sel_plan: set()}
    for make in P.PARAMETER_REGISTRY.values():
        p = make()
        if type(p) is P.SchemeParams:
            plan, geom = rotate_plan, bk_geometry(p)
            l, lb = p.bs_decomp_length, p.bs_log2_base
        elif isinstance(p, P.SchemeParams3Gen) and keys3gen.mk_fb_supported(p):
            compact = keys3gen.default_forms(p, p.max_parties) == ("fbstream",)
            plan = sel_plan if compact else rotate_plan
            geom = keys3gen.mk_fb_geometry(p, p.max_parties)
            l, lb = p.gsw_decomp_length, p.gsw_log2_base
        else:  # CCS, KMS and the wide-digit 3gen sets launch neither kernel
            continue
        if cuda_rotate.takes_kernel_route(geom, lb):
            reached[plan] |= {plan(B, geom, l, 132).config for B in range(1, 4097)}
    assert reached[rotate_plan] and reached[sel_plan]
    for plan, name, config in ((rotate_plan, "k2_l1_N64", cuda_rotate.NARROW_CONFIG),
                               (sel_plan, "k2_rounded_N64", cuda_rotate.SEL_NARROW_CONFIG)):
        geom, l, _, _ = SEL_GEOMETRIES[name]()
        assert (geom.R * geom.bs % 128 == 64) if plan is rotate_plan else geom.bs == 64
        assert {plan(B, geom, l, 132).config for B in range(1, 4097)} == {config}
        assert config not in reached[plan]
        reached[plan].add(config)
    assert reached[rotate_plan] == set(range(len(cuda_rotate.ROTATE_CONFIGS)))
    assert reached[sel_plan] == set(range(len(cuda_rotate.SEL_CONFIGS)))


def test_kernel_chunk_at_the_16_party_kms_geometry():
    """expand_kernel_chunk gathers block by block into one buffer: still
    byte-equal to the kernel layout of expand_fblock_chunk at the widest
    chunk the registry expands (mk_16party_kms: 64 bits, R = 10, 16 limb
    columns), on 2 steps of random lines."""
    from torus_fhe_tpu_torch.core.params import PARAMETER_REGISTRY
    from torus_fhe_tpu_torch.mk import kms

    params = PARAMETER_REGISTRY["mk_16party_kms"]()
    geom = kms.kms_fb_geometry(params, 2)
    assert geom.R == 10 and len(geom.cols) == 16
    lines = torch.from_numpy(np.random.default_rng(16).integers(
        -128, 128, (2, geom.R, 2 * geom.N, len(geom.cols)), dtype=np.int8))
    want = fblock.to_kernel_layout(fblock.expand_fblock_chunk(lines, geom), geom)
    assert torch.equal(fblock.expand_kernel_chunk(lines, geom), want)

"""The indexing of csrc/blind_rotate_sel.cu (the compact-key kernel),
emulated in numpy on the CPU: ``emulate_sel_kernel`` for its mma.sync tiles
and ``emulate_sel_wgmma_kernel`` for its wgmma tile (csrc/
rotate_sel_wgmma.cuh; tests/_torch_rotate_helpers.py) must be word-equal to
``fblock.blind_rotate_streamed`` (exact integer arithmetic). All inputs come
from a numpy seed; the tolerance is 0.
"""

import numpy as np
import pytest
import torch
from _torch_rotate_helpers import SEL_GEOMETRIES, emulate_sel_kernel, emulate_sel_wgmma_kernel

from torus_fhe_tpu_torch.ops import cuda_rotate, fblock


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are tiny: one intra-op thread, so that the
    workers of a parallel test run do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (B, SM count) -> tile at multikey_N256 (32, 16, 8 column tiles of 16, 32, 64
# coefficients, four limb columns a polynomial): below, at and above one gate
# tile; above one 64-gate tile the wgmma tile (64 x 64) on any card
SEL_CASES = {(3, 132): (16, 16), (16, 132): (16, 16), (20, 132): (64, 16), (64, 132): (64, 16),
             (70, 40): (64, 64), (70, 16): (64, 64), (130, 1): (64, 64)}


# every case at the 3gen N=256 twin and at N=64 (64-byte stages); the split
# tiles at the N=512 and the 11-column twins (a polynomial of three limb
# columns there, so 64 x 16 above 16 gates, with ragged last tiles at 70 and
# 130 gates); the wgmma tile at the 8-party chain's full width, with a ragged
# last gate tile
@pytest.mark.parametrize("name, B, sms", [
    (name, B, sms) for name in ("multikey_N256", "k2_rounded_N64") for B, sms in SEL_CASES] + [
    (name, B, sms) for name in ("multikey_N512", "k2_rounded_N256")
    for B, sms in ((3, 132), (70, 16), (130, 1))] + [
    ("k2_rounded_N256", 70, 20), ("k2_rounded_N256", 70, 40), ("mk8_N1024", 72, 8)])
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
    # the wgmma tile above one 64-gate tile where every polynomial has four
    # limb columns; else 64 x 16 above 16 gates
    four = all(nl == 4 for _, nl in cuda_rotate.poly_groups(geom))
    assert plan.tile.wgmma == (four and geom.bs % 128 == 0 and B > 64)
    if not four and geom.bs % 128 == 0 and B > 16:
        assert (plan.tile.bm, plan.tile.wq) == (64, 16)
    assert plan.tile.wgmma == (plan.config == cuda_rotate.SEL_WGMMA_CONFIG)
    emulate = emulate_sel_wgmma_kernel if plan.tile.wgmma else emulate_sel_kernel
    got = emulate(acc, key, bara, *args, plan)
    assert torch.equal(got, fblock.blind_rotate_streamed(acc, lines, bara, *args))
    mu = -(1 << 29)
    got = emulate(fblock.stepvec_acc0(mu, barb, geom), key, bara, *args, plan)
    assert torch.equal(got, fblock.blind_rotate_streamed(None, lines, bara, *args,
                                                         stepvec=(mu, barb)))

"""The indexing of csrc/blind_rotate.cu (the expanded-key kernel, with its
latency tile csrc/rotate_latency.cuh and its wgmma tile
csrc/rotate_wgmma.cuh), emulated in numpy on the CPU: ``emulate_kernel``
(tests/_torch_rotate_helpers.py) must be word-equal to
``fblock.blind_rotate_fblock`` (exact integer arithmetic), which the other
test files hold against the JAX package. All inputs come from a numpy seed;
the tolerance is 0.
"""

import pytest
import torch
from _torch_rotate_helpers import emulate_kernel, world

from torus_fhe_tpu_torch.ops import cuda_rotate, fblock


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are tiny: one intra-op thread, so that the
    workers of a parallel test run do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


LATENCY = ("latency",)  # the latency tile, which has no gate tile


# (B, SM count): 1 and 3 gates take the latency tile (key-stationary, wgmma
# tiles of 32 coefficients x 8 digit rows and up) on a large card, 16 gates
# the 16 x 8 tile, 20 gates the 64 x 16 one; 70 gates are ragged against
# 64. On a card of one SM the 128-gate tiles of 64 coefficients fill every
# SM, so the wgmma tile runs 20 gates (one gate tile and the pair's second
# past the last) and 200 (a pair, one cluster); on four SMs 150 gates
# (pairs dealt to two clusters); on a card of one SM more than those tiles
# ("over") 20 gates take the 128 x 32 tile. R*bs = 192 (k2_l1_N64) takes
# the 64 x 16 tile with 64-byte stages at every batch
@pytest.mark.parametrize("B, sms, tile", [(3, 132, LATENCY), (20, 132, (64, 16)),
                                          (70, 132, (64, 16)), (20, 1, (128, 64)),
                                          (200, 1, (128, 64)), (150, 4, (128, 64)),
                                          (20, "over", (128, 32)), (1, 132, LATENCY),
                                          (16, 132, (16, 8))])
@pytest.mark.parametrize("name", ["k1_N256", "k2_rounded_N64", "k2_l1_N64", "multikey_N512"])
def test_kernel_emulation_equals_plain_version(name, B, sms, tile):
    _, fb, acc, bara, barb, args = world(name, B, 2)
    geom, l, lb, offset = args
    key = fblock.to_kernel_layout(fb, geom)
    if sms == "over":
        wide = cuda_rotate.ROTATE_CONFIGS[cuda_rotate.WGMMA_CONFIG]
        sms = -(-B // wide.bm) * geom.nb * geom.C * (geom.bs // wide.wq) + 1
    plan = cuda_rotate.rotate_plan(B, geom, l, sms)
    narrow = name == "k2_l1_N64"
    latency = plan.config == cuda_rotate.LATENCY_CONFIG
    assert latency == (plan.latency is not None) == (tile == LATENCY and not narrow)
    assert plan.tile.bk == (64 if narrow else 128)
    if not latency:
        assert (plan.tile.bm, plan.tile.wq) == ((64, 16) if narrow else tile)
        assert plan.tile.wgmma == (plan.config == cuda_rotate.WGMMA_CONFIG) == (
            tile == (128, 64) and not narrow)
    got = emulate_kernel(acc, key, bara, geom, l, lb, offset, plan)
    assert torch.equal(got, fblock.blind_rotate_fblock(acc, fb, bara, *args))
    mu = -(1 << 29)
    got = emulate_kernel(fblock.stepvec_acc0(mu, barb, geom), key, bara, geom, l, lb, offset, plan)
    assert torch.equal(got, fblock.blind_rotate_fblock(None, fb, bara, *args, stepvec=(mu, barb)))

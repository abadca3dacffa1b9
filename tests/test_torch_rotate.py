"""Dispatch and argument checks of the blind-rotate kernel wrapper
(torus_fhe_tpu_torch/ops/cuda_rotate.py), and the kernel against its plain
version on the card.

On the CPU, ``rotate`` must take the plain version and never count a kernel
launch, whichever layout the key has. The launch plan of the kernel (tile
shape, padded batch, tiles per wave, scratch and shared memory) is checked at
the full-size sets. The kernel tests are marked ``cuda`` and skip without a
GPU; on one, the kernel must equal the plain version word for word (exact
integer arithmetic) in both init modes, at batches that are ragged against
every tile shape, and two launches on two streams must finish and agree.
"""

import numpy as np
import pytest
import torch

from torus_fhe_tpu_torch.boot import api
from torus_fhe_tpu_torch.boot.bootstrap import bk_geometry
from torus_fhe_tpu_torch.core import params as P
from torus_fhe_tpu_torch.core.params import SchemeParams, test_parameters as make_test_params
from torus_fhe_tpu_torch.mk import keys3gen
from torus_fhe_tpu_torch.ops import cuda_rotate, fblock


def _twin(N=64):
    base = make_test_params(n=12, N=N)
    return SchemeParams(**{**base.__dict__, "bs_decomp_length": 2, "bs_log2_base": 8,
                           "rlwe_mask_size": 2, "bk_drop_limbs": 1})


def _odd_rows(N=64):
    """k=2, l=1: R*bs = 192, which only the kernel's 64-byte-stage tile takes."""
    return SchemeParams(**{**_twin(N).__dict__, "bs_decomp_length": 1})


PARAMS = {"k1_N64": lambda: make_test_params(n=12, N=64),
          "k1_N256": lambda: make_test_params(n=12, N=256),
          "k2_rounded_N64": _twin, "k2_l1_N64": _odd_rows}


def _setup(params, B, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    _, ck = api.make_key_pair(g, params, device=device)
    rng = np.random.default_rng(seed)
    N, C, n = params.rlwe_polynomial_degree, params.rlwe_mask_size + 1, params.lwe_size
    acc = torch.from_numpy(rng.integers(-2**31, 2**31, (B, C, N)).astype(np.int32))
    bara = torch.from_numpy(rng.integers(0, 2 * N, (B, n)).astype(np.int32))
    barb = torch.from_numpy(rng.integers(-N, N, B).astype(np.int32))
    tg = params.tgsw
    args = (bk_geometry(params), tg.decomp_length, tg.log2_base, tg.offset)
    return ck.bootstrap_key.fb, acc.to(device), bara.to(device), barb.to(device), args


def test_cpu_tensors_take_the_plain_version():
    fb, acc, bara, barb, args = _setup(PARAMS["k1_N64"](), 3, 0)
    before = cuda_rotate.blind_rotate_cuda.launches
    got = cuda_rotate.rotate(acc, fb, bara, *args)
    np.testing.assert_array_equal(got.numpy(), fblock.blind_rotate_fblock(acc, fb, bara, *args).numpy())
    got = cuda_rotate.rotate(None, fb, bara, *args, stepvec=(1 << 29, barb))
    want = fblock.blind_rotate_fblock(None, fb, bara, *args, stepvec=(1 << 29, barb))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # the kernel layout on the CPU: the plain version reads it through a view
    got = cuda_rotate.rotate(acc, fblock.to_kernel_layout(fb, args[0]), bara, *args)
    np.testing.assert_array_equal(got.numpy(), fblock.blind_rotate_fblock(acc, fb, bara, *args).numpy())
    assert cuda_rotate.blind_rotate_cuda.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    fb, acc, bara, barb, (geom, l, lb, off) = _setup(PARAMS["k1_N64"](), 2, 1)
    before = cuda_rotate.blind_rotate_cuda.launches
    bad = [
        dict(fb=fb.to(torch.int32)),                       # key dtype
        dict(fb=fb[:, :-1]),                               # key shape
        dict(bara=bara.to(torch.int64)),                   # bara dtype
        dict(bara=bara[:, :-1]),                           # step count
        dict(acc=acc.to(torch.int64)),                     # acc dtype
        dict(acc=acc[:, :1]),                              # acc shape
        dict(stepvec=(5, barb)),                           # acc and stepvec both
    ]
    for case in bad:
        kw = dict(acc=acc, fb=fb, bara=bara, geom=geom, lb=lb, stepvec=None)
        kw.update(case)
        with pytest.raises(ValueError):
            cuda_rotate.rotate(kw["acc"], kw["fb"], kw["bara"], kw["geom"], l, kw["lb"],
                               off, stepvec=kw["stepvec"])
    # a 64-bit torus and digits wider than a byte: the kernel and its checks
    # refuse them, while ``rotate`` sends them to the torch-op scan
    for wide in (dict(geom=geom._replace(bits=64)), dict(lb=9)):
        kw = dict(geom=geom, lb=lb)
        kw.update(wide)
        assert not cuda_rotate.takes_kernel_route(kw["geom"], kw["lb"])
        with pytest.raises(ValueError):
            cuda_rotate.check_args(acc, fb, bara, kw["geom"], l, kw["lb"])
        with pytest.raises(ValueError):
            cuda_rotate.blind_rotate_cuda(acc, fb, bara, kw["geom"], l, kw["lb"], off)
    got = cuda_rotate.rotate(acc, fb, bara, geom, l, 9, off)
    np.testing.assert_array_equal(
        got.numpy(), fblock.blind_rotate_fblock(acc, fb, bara, geom, l, 9, off).numpy())
    with pytest.raises(ValueError):  # stepvec barb of the wrong shape
        cuda_rotate.rotate(None, fb, bara, geom, l, lb, off, stepvec=(5, barb[:1]))
    with pytest.raises(ValueError):  # the kernel itself takes CUDA tensors only
        cuda_rotate.blind_rotate_cuda(acc, fb, bara, geom, l, lb, off)
    assert cuda_rotate.blind_rotate_cuda.launches == before


def _full_size(name):
    if name == "mk_2party_3gen":
        p = P.mktfhe_parameters_2party_3gen()
        return keys3gen.mk_fb_geometry(p, 2), p.gsw_decomp_length
    p = P.PARAMETER_REGISTRY[name]()
    return bk_geometry(p), p.bs_decomp_length


# per set: GEMM tiles per step at the 128 x 32 tile (nb * C * bs/32), digit bytes
# per gate (R * N), and the tile of B=1024 on 132 SMs
FULL_SIZE = {"tfhe_128_tpu_fast": (48, 3072, 128), "tfhe_128_tpu": (64, 6144, 256),
             "mk_2party_3gen": (64, 4096, 256)}


@pytest.mark.parametrize("name", list(FULL_SIZE))
def test_launch_plan(name):
    """The launch plan of blind_rotate.cu on a 132-SM card. B=1024: one block
    per SM (its registers allow no more); the 128 x 32 tile at
    tfhe_128_tpu_fast (2.91 rounds of the card per step, 97% busy; the 256 x
    32 tile would leave 1.45 rounds, 73% busy), the 256 x 32 tile at the two
    N=1024 sets (1.94 rounds, as busy as 3.88 of the smaller tile). B=1: the
    16 x 8 tile, every tile a block of four warps that split its reduction,
    more blocks than SMs so that one gate's key stream comes through all of
    them. Ragged batches pad M up to the
    tile; scratch is the digit rows alone (the output is the accumulator)."""
    geom, l = _full_size(name)
    n_big, digit_bytes, bm = FULL_SIZE[name]
    plan = cuda_rotate.rotate_plan(1024, geom, l, 132)
    stages = {128: 4, 256: 3}[bm]
    assert plan.tile == cuda_rotate.TileConfig(bm, 32, stages, 256, 1, 128)
    assert plan.tile is cuda_rotate.ROTATE_CONFIGS[plan.config]
    assert (plan.m_tiles, plan.padded_m, plan.n_tiles) == (1024 // bm, 1024, n_big)
    assert plan.tiles == plan.m_tiles * n_big and plan.blocks == 132
    assert plan.waves == plan.tiles / 132
    assert plan.fill == plan.tiles / (-(-plan.tiles // 132) * 132) > 0.96
    assert plan.smem_bytes == stages * (bm + 4 * 32) * 128 <= 227 * 1024
    assert plan.scratch_bytes == 1024 * digit_bytes
    one = cuda_rotate.rotate_plan(1, geom, l, 132)
    assert one.tile == cuda_rotate.TileConfig(16, 8, 3, 128, 3, 128, ksplit=4)
    assert (one.m_tiles, one.padded_m, one.n_tiles) == (1, 16, 4 * n_big)
    assert one.blocks == one.tiles == 4 * n_big > 132
    assert one.smem_bytes == 4 * 3 * (16 + 4 * 8) * 128 and one.scratch_bytes == digit_bytes
    assert 3 * (one.smem_bytes + 1024) <= 228 * 1024  # three blocks an SM
    for B in (37, 130, 1100):  # ragged against every larger tile
        plan = cuda_rotate.rotate_plan(B, geom, l, 132)
        assert plan.padded_m == plan.m_tiles * plan.tile.bm >= B > plan.padded_m - plan.tile.bm
        assert plan.tiles == plan.m_tiles * plan.n_tiles
        assert plan.blocks == min(plan.tiles, 132 * plan.tile.resident) and plan.fill <= 1.0
        assert plan.smem_bytes <= 227 * 1024 and plan.scratch_bytes == B * digit_bytes
    # 1100 gates: the 256-gate tile would pad to 1280 where the 128-gate one pads to 1152
    assert cuda_rotate.rotate_plan(1100, geom, l, 132).tile.bm == 128
    assert cuda_rotate.rotate_plan(4096, geom, l, 132).tile.bm == 256


def test_plan_takes_short_stages_where_the_long_do_not_divide():
    """R*bs = 384 at k=2, l=2, N=64 is a multiple of the 128-byte stages; an
    odd R at bs=64 (R*bs = 192) is not, and takes the one tile with 64-byte
    stages whatever the batch."""
    p = _twin()
    geom = bk_geometry(p)
    assert geom.R * geom.bs == 384
    assert [cuda_rotate.rotate_plan(B, geom, p.bs_decomp_length, 1).tile.bk
            for B in (3, 40, 200)] == [128] * 3
    odd = geom._replace(R=3, C=3, cols=((0, 0), (1, 0), (2, 0)))
    plans = [cuda_rotate.rotate_plan(B, odd, 1, 1) for B in (3, 40, 200)]
    assert [pl.config for pl in plans] == [cuda_rotate.NARROW_CONFIG] * 3
    assert plans[0].tile == cuda_rotate.TileConfig(64, 16, 4, 128, 3, 64)
    assert [pl.padded_m for pl in plans] == [64, 64, 256]
    # the narrow tile is the only one with short stages
    assert [c.bk for c in cuda_rotate.ROTATE_CONFIGS] == [128] * 4 + [64]


def test_plan_rejects_what_the_tiles_do_not_take():
    geom, l = _full_size("tfhe_128_tpu_fast")
    with pytest.raises(ValueError, match="at least one gate"):
        cuda_rotate.rotate_plan(0, geom, l, 132)
    with pytest.raises(ValueError, match="multiple of 32"):
        cuda_rotate.rotate_plan(4, geom._replace(bs=16, nb=32, D=64), l, 132)
    scattered = geom._replace(cols=geom.cols[1:] + geom.cols[:1])  # poly 0 split in two runs
    with pytest.raises(ValueError, match="consecutive"):
        cuda_rotate.rotate_plan(4, scattered, l, 132)
    with pytest.raises(ValueError, match="without a limb column"):
        cuda_rotate.rotate_plan(4, geom._replace(cols=geom.cols[:8]), l, 132)
    assert cuda_rotate.poly_groups(geom) == [(0, 4), (4, 4), (8, 3)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the blind-rotate kernel is CUDA only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PARAMS))
@pytest.mark.parametrize("B", [1, 5, 40, 130])
def test_kernel_equals_plain_version(cuda_device, name, B):
    fb, acc, bara, barb, args = _setup(PARAMS[name](), B, 2, device=cuda_device)
    before = cuda_rotate.blind_rotate_cuda.launches
    got = cuda_rotate.blind_rotate_cuda(acc, fb, bara, *args)
    want = fblock.blind_rotate_fblock(acc, fb, bara, *args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    got = cuda_rotate.blind_rotate_cuda(None, fb, bara, *args, stepvec=(-(1 << 29), barb))
    want = fblock.blind_rotate_fblock(None, fb, bara, *args, stepvec=(-(1 << 29), barb))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert cuda_rotate.blind_rotate_cuda.launches == before + 2


@pytest.mark.cuda
def test_two_streams_at_once(cuda_device):
    """Two rotates queued on two streams of one card (as
    parallel/mesh.run_batch_sharded does) finish and give the one-stream
    words: the grid barrier of one launch cannot wait on the other's."""
    key, acc, bara, barb, args = _setup(PARAMS["k1_N256"](), 40, 3, device=cuda_device)
    want = cuda_rotate.blind_rotate_cuda(acc, key, bara, *args)
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in range(2)]
    outs = []
    for rep in range(3):
        for stream in streams:
            with torch.cuda.stream(stream):
                outs.append(cuda_rotate.blind_rotate_cuda(acc, key, bara, *args))
    torch.cuda.synchronize()
    assert all(torch.equal(out, want) for out in outs)

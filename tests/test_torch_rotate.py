"""Dispatch and argument checks of the blind-rotate kernel wrapper
(torus_fhe_tpu_torch/ops/cuda_rotate.py), and the kernel against its plain
version on the card.

On the CPU, ``rotate`` must take the plain version and never count a kernel
launch, whichever layout the key has. The launch plan of the kernel (tile
shape, padded batch, tiles per wave, scratch and shared memory) is checked at
the full-size sets. The kernel tests are marked ``cuda`` and skip without a
GPU; on one, the kernel must equal the plain version word for word (exact
integer arithmetic) in both init modes, at batches that are ragged against
every tile shape, with each tile at the real geometries, and two launches on
two streams must finish and agree.
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


# per set: GEMM tiles per step at the 128 x 32 tile (nb * C * bs/32) and
# digit bytes per gate (R * N)
FULL_SIZE = {"tfhe_128_tpu_fast": (48, 3072), "tfhe_128_tpu": (64, 6144),
             "mk_2party_3gen": (64, 4096), "tfhe_128": (64, 6144)}


@pytest.mark.parametrize("name", list(FULL_SIZE))
def test_launch_plan(name):
    """The launch plan of blind_rotate.cu on a 132-SM card. B=1024 and 4096:
    the wgmma tile (128 gates x 64 coefficients, 4 stages of 128 reduction
    bytes, two consumer warpgroups and a producer warp), one block an SM in
    66 clusters of two; its 128-gate tiles fill every SM (1.45 rounds of the
    card a step at tfhe_128_tpu_fast, 1.94 at the N=1024 sets). Below, the
    mma.sync tiles stay: B=16 the 16 x 8 tile, every tile a block of four
    warps that split its reduction, more blocks than SMs so that one gate's
    key stream comes through all of them; B=64 the 64 x 16 tile, B=200 that
    or 128 x 32. B=1 up to the latency tile's most: that tile, one block a
    key box (2*nb - 1 key blocks x C polynomials x boxes of 32 coefficients:
    120 blocks at the N=1024 sets, 84 at the fast set), one block an SM; its
    scratch is the second accumulator and a barrier word. Ragged batches pad M up to the
    tile; the other tiles' scratch is the digit rows alone (the output is
    the accumulator)."""
    geom, l = _full_size(name)
    n_big, digit_bytes = FULL_SIZE[name]
    wide = cuda_rotate.ROTATE_CONFIGS[cuda_rotate.WGMMA_CONFIG]
    assert wide == cuda_rotate.TileConfig(128, 64, 4, 288, 1, 128, wgmma=True)
    for B in (1024, 4096):
        plan = cuda_rotate.rotate_plan(B, geom, l, 132)
        assert plan.config == cuda_rotate.WGMMA_CONFIG and plan.tile is wide
        assert (plan.m_tiles, plan.padded_m, plan.n_tiles) == (B // 128, B, n_big // 2)
        assert plan.tiles == plan.m_tiles * plan.n_tiles >= 132 and plan.blocks == 132
        assert plan.waves == plan.tiles / 132
        # the ring, 1 KiB to align it, a full and an empty mbarrier a stage:
        # within the 227 KB a block may take, and one block an SM
        assert plan.smem_bytes == 4 * (128 + 4 * 64) * 128 + 1024 + 4 * 16 <= 227 * 1024
        assert 2 * (plan.smem_bytes + 1024) > 228 * 1024
        assert plan.scratch_bytes == B * digit_bytes
    for B in (16, 64, 200):
        plan = cuda_rotate.rotate_plan(B, geom, l, 132)
        assert plan.config in (0, 1, 2) and not plan.tile.wgmma
        assert (plan.tile.bm, plan.tile.wq) == {16: (16, 8), 64: (64, 16)}.get(
            B, (128, 32) if n_big == 64 else (64, 16))
    small = cuda_rotate.rotate_plan(16, geom, l, 132)
    assert small.tile == cuda_rotate.TileConfig(16, 8, 3, 128, 3, 128, ksplit=4)
    assert (small.m_tiles, small.padded_m, small.n_tiles) == (1, 16, 4 * n_big)
    assert small.blocks == small.tiles == 4 * n_big > 132
    assert small.smem_bytes == 4 * 3 * (16 + 4 * 8) * 128
    assert small.scratch_bytes == 16 * digit_bytes
    assert 3 * (small.smem_bytes + 1024) <= 228 * 1024  # three blocks an SM
    latency = cuda_rotate.ROTATE_CONFIGS[cuda_rotate.LATENCY_CONFIG]
    assert latency == cuda_rotate.LatencyTile(32, 128, 4, 288, latency.most_gates)
    boxes = (2 * geom.nb - 1) * geom.C * geom.bs // 32
    chunks = geom.R * geom.bs // 128
    # ring slots at one gate and at the most: as many box-steps as fit beside
    # the digit rows (a box is 96 KiB at R*bs = 768, 64 KiB at 512)
    for B in (1, latency.most_gates):
        slots = 3 if name == "mk_2party_3gen" else 2
        plan = cuda_rotate.rotate_plan(B, geom, l, 132)
        lay = plan.latency
        assert plan.config == cuda_rotate.LATENCY_CONFIG and plan.tile is latency
        assert (lay.units, lay.slots, plan.blocks) == (4, slots, boxes) and boxes <= 132
        assert (plan.m_tiles, plan.padded_m) == (1, B)
        # the largest pair set's digit rows (nb * B) in wgmma tiles of N = 8,
        # 16 or 32, two when they do not fit one of 8; each warpgroup's
        # partials (N words a thread, two items)
        nt = 8 if geom.nb * B <= 16 else 16 if geom.nb * B <= 32 else 32
        assert lay.n_tile == nt and lay.rows == -(-geom.nb * B // nt) * nt >= geom.nb * B
        # the ring of box-steps (R*bs/128 chunks x 2 limb pairs x 64 rows of
        # 128 bytes), the digit rows, the partials, the mbarriers (two a
        # slot), two rotations a gate, 1 KiB to align
        assert plan.smem_bytes == lay.smem == (
            1024 + slots * (chunks * 2 * 64 * 128 + 16) + chunks * lay.rows * 128
            + max(2, lay.rows // nt) * nt * 128 + 4 * 2 * latency.most_gates)
        assert plan.smem_bytes <= 227 * 1024 < 2 * (plan.smem_bytes + 1024)
        assert plan.scratch_bytes == B * geom.C * geom.N * 4 + 16
        # the producer's pause after an A tile: the grid's A tiles at half
        # the time 3.35 TB/s takes for them
        assert lay.pace_ns == int(8192 * boxes / 3350 / 2)
    for B in (37, 130, 1100):  # ragged against every larger tile
        plan = cuda_rotate.rotate_plan(B, geom, l, 132)
        assert plan.padded_m == plan.m_tiles * plan.tile.bm >= B > plan.padded_m - plan.tile.bm
        assert plan.tiles == plan.m_tiles * plan.n_tiles
        assert plan.blocks == min(plan.tiles, 132 * plan.tile.resident) and plan.fill <= 1.0
        assert plan.smem_bytes <= 227 * 1024 and plan.scratch_bytes == B * digit_bytes
    # 1100 gates: 9 gate tiles, the last a pair of its own with one past it
    assert cuda_rotate.rotate_plan(1100, geom, l, 132).tile is wide
    # one SM: the 128-gate tiles of 130 gates fill it, one cluster of two
    plan = cuda_rotate.rotate_plan(130, geom, l, 1)
    assert plan.tile is wide and plan.blocks == 2 and plan.m_tiles == 2


@pytest.mark.parametrize("name", list(FULL_SIZE))
def test_latency_tile_takes_small_batches(name):
    """B = 1 up to the tile's most take the latency tile at every set on
    its path (tfhe_128, tfhe_128_tpu, the fast set, the 2-party 3gen hi
    word), with the ring as deep as shared memory lets it be; above, up to
    16 gates, the 16 x 8 tile, which is faster there on an H100; from B = 17
    the plan is as before. On a card with fewer SMs than the step's key
    blocks x polynomials the tile does not fit, and small batches take the
    16 x 8 tile."""
    geom, l = _full_size(name)
    most = cuda_rotate.ROTATE_CONFIGS[cuda_rotate.LATENCY_CONFIG].most_gates
    for B in range(1, most + 1):
        plan = cuda_rotate.rotate_plan(B, geom, l, 132)
        lay = plan.latency
        assert plan.config == cuda_rotate.LATENCY_CONFIG
        assert 1 <= lay.slots <= plan.tile.most_slots and lay.units == 4
        assert plan.blocks == (2 * geom.nb - 1) * geom.C * geom.bs // (8 * lay.units) <= 132
        box = 4 * geom.R * geom.bs * 32  # four limbs' rows of 32 coefficients
        assert plan.smem_bytes <= cuda_rotate.BLOCK_SHARED_LIMIT
        assert lay.slots == plan.tile.most_slots or \
            plan.smem_bytes + box + 16 > cuda_rotate.BLOCK_SHARED_LIMIT
    assert {cuda_rotate.rotate_plan(B, geom, l, 132).config
            for B in range(most + 1, 17)} == {0}
    assert cuda_rotate.rotate_plan(17, geom, l, 132).config == 1
    assert all(cuda_rotate.rotate_plan(B, geom, l, 132).latency is None
               for B in range(most + 1, 4097, 13))
    small = (2 * geom.nb - 1) * geom.C - 1
    assert cuda_rotate.latency_layout(1, geom, small) is None
    assert cuda_rotate.rotate_plan(1, geom, l, small).config == 0


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
    assert [c.bk for c in cuda_rotate.ROTATE_CONFIGS] == [128, 128, 128, 64, 128, 128]


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
@pytest.mark.parametrize("case", ["mma_sync", "wgmma", "latency"])
def test_two_streams_at_once(cuda_device, case):
    """Two rotates queued on two streams of one card (as
    parallel/mesh.run_batch_sharded does) finish and give the one-stream
    words: the grid barrier of one launch cannot wait on the other's, for
    the mma.sync tiles (40 gates of a small set), for the wgmma tile's
    clusters (1,024 gates of tfhe_128, 16 steps) and for the latency tile,
    whose barrier counter is in each launch's own scratch (1 gate of
    tfhe_128, 16 steps)."""
    if case == "wgmma":
        key, acc, bara, barb, args = _wide_world("tfhe_128", 1024, cuda_device)
    elif case == "latency":
        key, acc, bara, barb, args = _wide_world("tfhe_128", 1, cuda_device)
        assert cuda_rotate.rotate_plan(1, args[0], args[1],
                                       cuda_rotate._sm_count(cuda_device)).latency
    else:
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


def _wide_world(name, B, device, steps=16):
    """The real geometry of ``name`` over its first ``steps`` steps, a random
    key in the kernel layout (the rotate's arithmetic does not depend on the
    key being an encryption) and random inputs, on ``device``."""
    geom, l = _full_size(name)
    if name == "mk_2party_3gen":
        tg = P.TGswParams(l, P.mktfhe_parameters_2party_3gen().gsw_log2_base, 32)
    else:
        tg = P.PARAMETER_REGISTRY[name]().tgsw
    geom = geom._replace(n=steps)
    g = torch.Generator(device=device).manual_seed(B)
    key = torch.empty((steps,) + fblock.kernel_layout_shape(geom), dtype=torch.int8,
                      device=device)
    for s0 in range(0, steps, 64):  # 64 steps at a time: the full key is 7.93 GB
        key[s0:s0 + 64] = torch.randint(-128, 128, key[s0:s0 + 64].shape, generator=g,
                                        dtype=torch.int8, device=device)
    acc = torch.randint(-2**31, 2**31 - 1, (B, geom.C, geom.N), generator=g, dtype=torch.int32,
                        device=device)
    bara = torch.randint(0, 2 * geom.N, (B, steps), generator=g, dtype=torch.int32, device=device)
    barb = torch.randint(-geom.N, geom.N, (B,), generator=g, dtype=torch.int32, device=device)
    return key, acc, bara, barb, (geom, l, tg.log2_base, tg.offset)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tfhe_128", "mk_2party_3gen"])
@pytest.mark.parametrize("B, sms", [(130, 1), (1000, None), (1024, None), (1030, None),
                                    (2048, None)])
def test_wgmma_tile_equals_plain_version(cuda_device, monkeypatch, name, B, sms):
    """The wgmma tile (csrc/rotate_wgmma.cuh) word for word against the plain
    version on the real geometries' first 16 steps, in both init modes:
    ragged last gate tiles (1000; 1030, an odd count of them, so the last
    cluster pair has a tile past the batch), a plan for a card of one SM (130
    gates: one cluster of two, the second tile ragged), and
    ``blind_rotate_cuda.by_config`` counting the launches."""
    if sms:
        monkeypatch.setattr(cuda_rotate, "_sm_count", lambda device: sms)
    key, acc, bara, barb, args = _wide_world(name, B, cuda_device)
    plan = cuda_rotate.rotate_plan(B, args[0], args[1], cuda_rotate._sm_count(cuda_device))
    assert plan.config == cuda_rotate.WGMMA_CONFIG
    before = cuda_rotate.blind_rotate_cuda.by_config.get(plan.config, 0)
    for acc_a, stepvec in ((acc, None), (None, (-(1 << 29), barb))):
        got = cuda_rotate.blind_rotate_cuda(acc_a, key, bara, *args, stepvec=stepvec)
        want = fblock.blind_rotate_fblock(acc_a, key, bara, *args, stepvec=stepvec)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        grid = cuda_rotate.blind_rotate_cuda.grid
        assert grid % 2 == 0 and 2 <= grid <= plan.blocks  # whole clusters, all resident
    assert cuda_rotate.blind_rotate_cuda.by_config[plan.config] == before + 2


@pytest.mark.cuda
def test_wide_rotate_leaves_one_rotate_record(cuda_device, tmp_path):
    """One wide launch (the wgmma tile) under torch.profiler leaves exactly
    one kernel record, which the benchmark's trace files as the expanded-key
    rotate: ``rotate_roofline.wide`` divides a whole rotate's bound by the
    mean time of such records."""
    from perfbench import tracing
    from torus_fhe_tpu_torch.utils import profiling

    key, acc, bara, barb, args = _wide_world("tfhe_128", 1024, cuda_device)
    assert cuda_rotate.rotate_plan(1024, args[0], args[1],
                                   cuda_rotate._sm_count(cuda_device)).tile.wgmma
    torch.cuda.synchronize()
    with profiling.device_trace(str(tmp_path), cuda_device):
        cuda_rotate.blind_rotate_cuda(None, key, bara, *args, stepvec=(1 << 29, barb))
    events = [ev for path in profiling._trace_files(str(tmp_path))
              for ev in profiling._load(path) if ev.get("ph") == "X"]
    guards = set().union(*profiling._guard_correlations(events).values())
    kernels = [ev for ev in events if ev.get("cat") == "kernel"
               and ev.get("args", {}).get("correlation") not in guards]
    assert len(kernels) == 1, [ev.get("name") for ev in kernels]
    assert tracing.category(kernels[0]["name"], kernels[0]["cat"]) == tracing.ROTATE


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tfhe_128", "mk_2party_3gen"])
@pytest.mark.parametrize("B", [1, 2, 3])
def test_latency_tile_equals_plain_version(cuda_device, name, B):
    """The latency tile (csrc/rotate_latency.cuh) word for word against the
    plain version on the real geometries' first 16 steps, in both init
    modes: one gate (N tiles of 8), 2 and 3 (at the N=1024 sets 16 rows in
    two N tiles of 8, and 24 rows in two of 16), with ``blind_rotate_cuda.by_config`` counting the launches under the
    tile's config."""
    key, acc, bara, barb, args = _wide_world(name, B, cuda_device)
    plan = cuda_rotate.rotate_plan(B, args[0], args[1], cuda_rotate._sm_count(cuda_device))
    assert plan.config == cuda_rotate.LATENCY_CONFIG and plan.latency
    before = cuda_rotate.blind_rotate_cuda.by_config.get(plan.config, 0)
    for acc_a, stepvec in ((acc, None), (None, (-(1 << 29), barb))):
        got = cuda_rotate.blind_rotate_cuda(acc_a, key, bara, *args, stepvec=stepvec)
        want = fblock.blind_rotate_fblock(acc_a, key, bara, *args, stepvec=stepvec)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert cuda_rotate.blind_rotate_cuda.grid == plan.blocks  # one block a key box
    assert cuda_rotate.blind_rotate_cuda.by_config[plan.config] == before + 2


@pytest.mark.cuda
def test_latency_tile_full_chain(cuda_device):
    """One gate through all 630 steps of tfhe_128 (a random 7.93 GB key in
    the kernel layout): the latency tile's ping-pong accumulators end in the
    output after an even step count, and its barrier counter reaches 120 x
    629 arrivals; word-equal to the plain version, one launch, on config 5."""
    key, acc, bara, barb, args = _wide_world("tfhe_128", 1, cuda_device, steps=630)
    before = dict(cuda_rotate.blind_rotate_cuda.by_config)
    got = cuda_rotate.blind_rotate_cuda(None, key, bara, *args, stepvec=(1 << 29, barb))
    want = fblock.blind_rotate_fblock(None, key, bara, *args, stepvec=(1 << 29, barb))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    after = cuda_rotate.blind_rotate_cuda.by_config
    assert {c: after[c] - before.get(c, 0) for c in after if after[c] != before.get(c, 0)} == \
        {cuda_rotate.LATENCY_CONFIG: 1}


@pytest.mark.cuda
def test_latency_rotate_leaves_one_rotate_record(cuda_device, tmp_path):
    """One launch of the latency tile (1 gate of tfhe_128, 16 steps) under
    torch.profiler leaves exactly one kernel record, which the benchmark's
    trace files as the expanded-key rotate (``rotate_ms_per_launch.circuit``
    reads such records): no memset or second kernel a rotate."""
    from perfbench import tracing
    from torus_fhe_tpu_torch.utils import profiling

    key, acc, bara, barb, args = _wide_world("tfhe_128", 1, cuda_device)
    assert cuda_rotate.rotate_plan(1, args[0], args[1],
                                   cuda_rotate._sm_count(cuda_device)).latency
    torch.cuda.synchronize()
    with profiling.device_trace(str(tmp_path), cuda_device):
        cuda_rotate.blind_rotate_cuda(None, key, bara, *args, stepvec=(1 << 29, barb))
    events = [ev for path in profiling._trace_files(str(tmp_path))
              for ev in profiling._load(path) if ev.get("ph") == "X"]
    guards = set().union(*profiling._guard_correlations(events).values())
    kernels = [ev for ev in events if ev.get("cat") == "kernel"
               and ev.get("args", {}).get("correlation") not in guards]
    assert len(kernels) == 1, [ev.get("name") for ev in kernels]
    assert kernels[0]["name"].startswith("blind_rotate_kernel")
    assert tracing.category(kernels[0]["name"], kernels[0]["cat"]) == tracing.ROTATE


def _sel_world(parties, B, device, steps=12):
    """The compact kernel's world at the real 3gen geometry of ``parties``
    over its first ``steps`` steps: random compact lines in the kernel layout
    (steps, ncols, R, 2N) and random inputs, on ``device``."""
    p = P.PARAMETER_REGISTRY[f"mk_{parties}party_3gen"]()
    tg = P.TGswParams(p.gsw_decomp_length, p.gsw_log2_base, 32)  # the hi-word chain's gadget
    geom = keys3gen.mk_fb_geometry(p, parties)._replace(n=steps)
    g = torch.Generator(device=device).manual_seed(1000 * parties + B)
    sel = torch.randint(-128, 128, (steps,) + fblock.sel_kernel_layout_shape(geom), generator=g,
                        dtype=torch.int8, device=device)
    acc = torch.randint(-2**31, 2**31 - 1, (B, geom.C, geom.N), generator=g, dtype=torch.int32,
                        device=device)
    bara = torch.randint(0, 2 * geom.N, (B, steps), generator=g, dtype=torch.int32, device=device)
    barb = torch.randint(-geom.N, geom.N, (B,), generator=g, dtype=torch.int32, device=device)
    return sel, acc, bara, barb, (geom, tg.decomp_length, tg.log2_base, tg.offset)


@pytest.mark.cuda
@pytest.mark.parametrize("parties, B, sms", [(8, 256, None), (8, 200, None), (4, 256, None),
                                             (8, 96, None), (8, 130, 1)])
def test_sel_wgmma_tile_equals_plain_version(cuda_device, monkeypatch, parties, B, sms):
    """The compact kernel's wgmma tile (csrc/rotate_sel_wgmma.cuh) word for
    word against the plain version on the real 3gen geometries' first 12
    steps, in both init modes, wherever ``sel_plan`` picks it: 8 parties at
    B=256 and at B=200 (a ragged last gate tile), 4 parties at B=256, 8 at
    B=96 (64 tiles: half the SMs), and a plan for a card of one SM (130
    gates: 96 tiles a step through one block, the last gate tile ragged); ``blind_rotate_sel_cuda.by_config`` counts
    the launches under the tile's config."""
    if sms:
        monkeypatch.setattr(cuda_rotate, "_sm_count", lambda device: sms)
    sel, acc, bara, barb, args = _sel_world(parties, B, cuda_device)
    plan = cuda_rotate.sel_plan(B, args[0], args[1], cuda_rotate._sm_count(cuda_device))
    assert plan.config == cuda_rotate.SEL_WGMMA_CONFIG and plan.tile.wgmma
    before = cuda_rotate.blind_rotate_sel_cuda.by_config.get(plan.config, 0)
    for acc_a, stepvec in ((acc, None), (None, (-(1 << 29), barb))):
        got = cuda_rotate.blind_rotate_sel_cuda(acc_a, sel, bara, *args, stepvec=stepvec)
        want = fblock.blind_rotate_streamed(acc_a, sel, bara, *args, stepvec=stepvec)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert 1 <= cuda_rotate.blind_rotate_sel_cuda.grid <= plan.blocks  # all resident
    assert cuda_rotate.blind_rotate_sel_cuda.by_config[plan.config] == before + 2


@pytest.mark.cuda
def test_sel_wgmma_rotate_leaves_one_compact_record(cuda_device, tmp_path):
    """One launch of the compact kernel's wgmma tile under torch.profiler
    leaves exactly one kernel record, which the benchmark's trace files as
    the compact-key rotate, and ``by_config`` counts it under the tile."""
    from perfbench import tracing
    from torus_fhe_tpu_torch.utils import profiling

    sel, acc, bara, barb, args = _sel_world(8, 256, cuda_device)
    assert cuda_rotate.sel_plan(256, args[0], args[1],
                                cuda_rotate._sm_count(cuda_device)).tile.wgmma
    before = cuda_rotate.blind_rotate_sel_cuda.by_config.get(cuda_rotate.SEL_WGMMA_CONFIG, 0)
    torch.cuda.synchronize()
    with profiling.device_trace(str(tmp_path), cuda_device):
        cuda_rotate.blind_rotate_sel_cuda(None, sel, bara, *args, stepvec=(1 << 29, barb))
    events = [ev for path in profiling._trace_files(str(tmp_path))
              for ev in profiling._load(path) if ev.get("ph") == "X"]
    guards = set().union(*profiling._guard_correlations(events).values())
    kernels = [ev for ev in events if ev.get("cat") == "kernel"
               and ev.get("args", {}).get("correlation") not in guards]
    assert len(kernels) == 1, [ev.get("name") for ev in kernels]
    assert tracing.category(kernels[0]["name"], kernels[0]["cat"]) == tracing.ROTATE_SEL
    assert tracing.ROTATE_SEL == "blind_rotate_sel (compact key)"
    assert cuda_rotate.blind_rotate_sel_cuda.by_config[cuda_rotate.SEL_WGMMA_CONFIG] == before + 1

"""The Hopper blind-rotate kernels (csrc/): build, bindings and device
dispatch.

``blind_rotate_cuda`` launches csrc/blind_rotate.cu over the expanded F-block
key in the kernel layout (ops/fblock.to_kernel_layout): it replaces the Pallas
TPU kernel torus_fhe_tpu/ops/pallas_rotate.py::blind_rotate_pallas, in both
init modes (explicit accumulator, or the stepvec gate test vector). Every CMux
step is an int8 tensor-core GEMM over the whole card; ``rotate_plan`` is its
launch plan (tile shape, padded batch, tiles per wave, scratch and shared
memory), computed here so that the CPU tests reach it.
``blind_rotate_sel_cuda`` launches csrc/blind_rotate_sel.cu over the compact
key lines in the compact kernel layout (ops/fblock.to_sel_kernel_layout): it
replaces the Pallas route of torus_fhe_tpu/ops/fblock.py::
blind_rotate_streamed (XLA expansion of 64-step chunks, then the Pallas
kernel), in the same two modes. It is the same chain of tensor-core GEMMs
(both sources include csrc/rotate_gemm.cuh) and expands nothing: a GEMM
tile's key operand is a window of one reversed line, BK + WQ bytes a limb,
from which the SM makes the MMA fragments itself. The int8 tensor-core rate
bounds it; ``sel_plan`` is its launch plan: at the 3gen sets' wide batches a
tile wide in coefficients, because each column tile reads every digit row
from L2 once, and below them tiles whose warps split the reduction.
``rotate`` and ``rotate_streamed`` are what the bootstraps call. They pick
the route from the parameters, before anything is launched
(``takes_kernel_route``): a 32-bit geometry with digits of at most a byte
sends CUDA tensors to the kernel and CPU tensors to the plain version
(ops/fblock ``blind_rotate_fblock`` and ``blind_rotate_streamed``); a 64-bit
geometry or wider digits (tfhe_80, the 3gen sets from 16 parties up) take the
torch-op scan of ops/fblock on either device, as the JAX package runs them as
an XLA scan outside Pallas. There is no fallback: on the kernel route a CUDA
tensor launches the kernel or raises, and a failed build raises. Both run
inside an ``fhe.rotate`` span (utils/profiling.span).

Each kernel source is compiled with nvcc at first use into ``_build/`` next to
this package (a shared library with a plain C interface, loaded with ctypes),
keyed by a hash of the sources and flags so that an edit rebuilds it. The
nvcc runs of all sources start together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Callable, NamedTuple

import torch

from ..utils.profiling import spanned
from . import fblock
from .fblock import FBlockGeometry

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = {"blind_rotate": os.path.join(CSRC, "blind_rotate.cu"),
           "blind_rotate_sel": os.path.join(CSRC, "blind_rotate_sel.cu")}
HEADERS = [os.path.join(CSRC, name)
           for name in ("rotate_gemm.cuh", "rotate_wgmma.cuh", "rotate_latency.cuh",
                        "rotate_sel_wgmma.cuh")]
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_COLS = 32
MAX_LIMBS = 4  # limb columns of one polynomial that a GEMM tile holds
# what an H100 SM holds at once (CUDA occupancy rules): shared memory (each
# block is charged 1 KiB on top of its own), threads, blocks
SM_SHARED_BYTES, BLOCK_SHARED_OVERHEAD = 228 * 1024, 1024
SM_MAX_THREADS, SM_MAX_BLOCKS = 2048, 32


def window_stride(nbytes: int) -> int:
    """Words between two byte-shifted copies of a compact window of
    ``nbytes`` bytes (rotate_gemm.cuh): room for the window, and 8 mod 16, so
    that the four copies start eight shared-memory banks apart."""
    w = nbytes // 4
    while w % 16 != 8:
        w += 1
    return w


class TileConfig(NamedTuple):
    """One instantiation of the kernel (rotate_gemm.cuh): a block computes
    ``bm`` gates x the limb columns of one polynomial for ``wq``
    coefficients, through ``stages`` cp.async stages of ``bk`` reduction
    bytes, on ``threads`` threads; at most ``resident`` blocks of the grid
    share an SM (the kernel's __launch_bounds__ give it the registers for
    that many). With ``ksplit`` > 1 the block's warps split the tile's
    reduction, each through a ring of its own. ``compact``: the key side of
    a stage is a window of the compact lines (blind_rotate_sel.cu), not rows
    of the expanded key (blind_rotate.cu). ``wgmma``: warpgroup MMAs fed by
    a TMA ring: over the expanded key the tile of csrc/rotate_wgmma.cuh, two
    blocks of a cluster sharing each key box (WGMMA_CLUSTER); over the
    compact key the tile of csrc/rotate_sel_wgmma.cuh, the key window as the
    MMAs' register operand, two warpgroups splitting the limbs and joining
    their folded words in shared memory."""

    bm: int
    wq: int
    stages: int
    threads: int
    resident: int
    bk: int
    ksplit: int = 1
    compact: bool = False
    wgmma: bool = False

    @property
    def smem_bytes(self) -> int:
        """The rings: per stage ``bk`` bytes of ``bm`` digit rows and, of the
        key, MAX_LIMBS * ``wq`` rows of ``bk`` bytes, or (compact) per limb
        four shifted copies of the ``bk + wq``-byte window; the wgmma tiles'
        ring also takes 1,024 bytes to align it and a full and an empty
        mbarrier a stage, and the compact one the words of a ``bm`` x ``wq``
        tile that one warpgroup hands the other."""
        key = (MAX_LIMBS * 4 * window_stride(self.bk + self.wq) * 4 if self.compact
               else MAX_LIMBS * self.wq * self.bk)
        ring = self.ksplit * self.stages * (self.bm * self.bk + key)
        if not self.wgmma:
            return ring
        return ring + 1024 + 16 * self.stages + (4 * self.bm * self.wq if self.compact else 0)


class LatencyTile(NamedTuple):
    """The latency tile of csrc/rotate_latency.cuh: key-stationary, a block
    a key box of the step (``latency_layout``), wgmma A tiles of ``coefs``
    coefficients x two limb columns, reduction chunks of ``bk`` bytes, a
    ring of at most ``most_slots`` box-steps, ``threads`` threads (two
    consumer warpgroups and a producer warp), at most ``most_gates`` gates
    (the kernel's MAX_B)."""

    coefs: int
    bk: int
    most_slots: int
    threads: int
    most_gates: int


class LatencyLayout(NamedTuple):
    """What ``latency_layout`` chooses for one launch of the latency tile.
    The first four are the kernel's ``layout`` argument: the launcher
    derives its shared-memory offsets from ``units`` and ``slots`` and
    refuses the launch unless they add up to ``smem``."""

    units: int    # units of 8 coefficients in a block's key box
    slots: int    # box-steps the ring holds
    smem: int     # dynamic shared memory a block
    pace_ns: int  # the producer's pause after each A tile it copies
    n_tile: int   # N of the wgmma tiles over the largest pair set's nb * B digit rows
    rows: int     # those rows, in whole N tiles


# indexed by the ``config`` argument of blind_rotate_launch: three mma.sync
# tile shapes with 128-byte pipeline stages, the one that takes a geometry
# whose R*bs is no multiple of 128 (an odd R at bs = 64), with 64-byte
# stages, the wgmma tile of wide batches (two consumer warpgroups and a
# producer warp), and the latency tile of the smallest
ROTATE_CONFIGS = (TileConfig(16, 8, 3, 128, 3, 128, 4), TileConfig(64, 16, 3, 128, 3, 128),
                  TileConfig(128, 32, 4, 256, 1, 128), TileConfig(64, 16, 4, 128, 3, 64),
                  TileConfig(128, 64, 4, 288, 1, 128, wgmma=True),
                  LatencyTile(32, 128, 4, 288, 3))
NARROW_CONFIG, WGMMA_CONFIG, LATENCY_CONFIG = 3, 4, 5
# the most dynamic shared memory a block may take on an H100
BLOCK_SHARED_LIMIT = 227 * 1024
WGMMA_CLUSTER = 2  # blocks of a cluster: gate tiles that share a key box
# indexed by the ``config`` argument of blind_rotate_sel_launch: the tiles of
# the compact kernel, wide in coefficients (the key side of a stage is a
# window of bk + wq bytes, so what a tile draws from L2 is its digit rows): two
# that split the reduction, the one with 64-byte stages for bs = 64 (a stage
# stays inside one line), and the wgmma tile above 64 gates (two consumer
# warpgroups and four producer warps, 8 stages)
SEL_CONFIGS = (TileConfig(16, 16, 4, 256, 1, 128, 8, True),
               TileConfig(64, 16, 4, 512, 1, 128, 4, True),
               TileConfig(64, 16, 4, 128, 3, 64, 1, True),
               TileConfig(64, 64, 8, 384, 1, 128, 1, True, True))
SEL_NARROW_CONFIG, SEL_WGMMA_CONFIG = 2, 3
# peak rates of an H100 SXM that the bounds are taken against: dense int8
# tensor-core operations, float64 outside the tensor cores (NVIDIA's data
# sheet), and device-memory bytes (which also pace the latency tile's key
# stream)
INT8_OPS_PER_S = 1979e12
FP64_OPS_PER_S = 34e12
BYTES_PER_S = 3.35e12


def bound_ms(ops: float, ops_per_s: float, nbytes: float) -> tuple:
    """(ms, what bounds it): the larger of ``ops`` over ``ops_per_s`` and
    ``nbytes`` over the device-memory rate."""
    ops_ms, bytes_ms = ops / ops_per_s * 1e3, nbytes / BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


class RotatePlan(NamedTuple):
    """Launch plan of one call of blind_rotate.cu (``rotate_plan``) or of
    blind_rotate_sel.cu (``sel_plan``)."""

    config: int        # index into ROTATE_CONFIGS or SEL_CONFIGS
    tile: TileConfig | LatencyTile
    m_tiles: int       # gate tiles: ceil(B / bm) (the latency tile: 1)
    padded_m: int      # m_tiles * bm (the latency tile: B); rows past B are zero-filled
    n_tiles: int       # per step: nb output blocks x C polynomials x bs / wq
    tiles: int         # m_tiles * n_tiles GEMM tiles per step
    blocks: int        # the persistent grid asked for (the C side cuts it to what is resident)
    waves: float       # tiles / SMs: rounds of the card per step
    fill: float        # tiles / (ceil(waves) * SMs): busy share of the rounds (1 below one)
    smem_bytes: int    # dynamic shared memory per block
    scratch_bytes: int  # the int8 digit rows, B * R * N; the latency tile: the second
    #                     accumulator, B * C * N words, and the barrier word
    latency: LatencyLayout | None = None  # the latency tile's layout


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked for {path})")
    return path


def _so_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (SOURCES[name], *HEADERS):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build() -> dict[str, tuple[str, str]]:
    """Compile every kernel library that is not built yet, one nvcc per
    source, all started together.

    Returns {name: (path of the .so, nvcc's report: ptxas registers and
    shared memory per kernel, empty when the library was already built)}."""
    out, procs = {}, {}
    for name, src in SOURCES.items():
        so = _so_path(name)
        if os.path.exists(so):
            out[name] = (so, "")
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        procs[name] = (so, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (so, tmp, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            failed.append(f"nvcc failed on {SOURCES[name]} with code {proc.returncode}:\n{report}")
            continue
        os.replace(tmp, so)
        out[name] = (so, report)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(build()[name][0])
    vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    ip = ctypes.POINTER(ctypes.c_int)
    launch = getattr(lib, f"{name}_launch")
    # the two launchers take the same arguments, and blind_rotate_launch the
    # latency tile's layout besides
    launch.argtypes = ([vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i, i, u, u, i, ip, ip]
                       + ([ip] if name == "blind_rotate" else []) + [vp, ip])
    launch.restype = ctypes.c_int
    return lib


def _col_arrays(geom: FBlockGeometry):
    ncols = len(geom.cols)
    return ((ctypes.c_int * ncols)(*[p for p, _ in geom.cols]),
            (ctypes.c_int * ncols)(*[s for _, s in geom.cols]))


def poly_groups(geom: FBlockGeometry) -> list:
    """Per polynomial c of the accumulator, (first limb column, number of
    limb columns). The kernels give one thread every limb of its
    coefficients, so a polynomial's columns must be consecutive and at most
    MAX_LIMBS, and every polynomial must have one."""
    groups = [[None, 0] for _ in range(geom.C)]
    for ci, (p, _) in enumerate(geom.cols):
        if not 0 <= p < geom.C:
            raise ValueError(f"limb column {ci} names polynomial {p} of {geom.C}")
        first, count = groups[p]
        if first is None:
            groups[p][0] = first = ci
        if first + count != ci or count == MAX_LIMBS:
            raise ValueError(f"the limb columns of polynomial {p} must be consecutive and at "
                             f"most {MAX_LIMBS}: {geom.cols}")
        groups[p][1] += 1
    if any(first is None for first, _ in groups):
        raise ValueError(f"a polynomial without a limb column: {geom.cols}")
    return [tuple(g) for g in groups]


def _check_geometry(geom: FBlockGeometry, decomp_length: int) -> None:
    if geom.R != decomp_length * geom.C or geom.bs % 16 or len(geom.cols) > MAX_COLS:
        raise ValueError(f"unsupported geometry {geom} for l={decomp_length}")


def _check_plan(B: int, geom: FBlockGeometry, decomp_length: int, source: str,
                bs_multiple: int, rbs_multiple: int) -> list:
    """The checks both plans share: ``source``'s stages take bs a multiple
    of ``bs_multiple`` and R*bs of ``rbs_multiple``. Returns ``poly_groups``."""
    if B < 1:
        raise ValueError(f"a launch needs at least one gate, got {B}")
    _check_geometry(geom, decomp_length)
    if geom.bs % bs_multiple or geom.R * geom.bs % rbs_multiple or geom.N % geom.bs:
        rows = f" and R*bs a multiple of {rbs_multiple}" if rbs_multiple > bs_multiple else ""
        raise ValueError(f"{source} takes bs a multiple of {bs_multiple}{rows}: {geom}")
    groups = poly_groups(geom)
    if B * geom.C * geom.N >= 2**31:
        raise ValueError(f"{B} gates of {geom.C}x{geom.N} words overflow the kernel's int index")
    return groups


def rotate_plan(B: int, geom: FBlockGeometry, decomp_length: int,
                sm_count: int) -> RotatePlan:
    """How blind_rotate.cu runs ``B`` gates on a card of ``sm_count`` SMs.

    The tile: up to ``most_gates`` gates the latency tile
    (``LATENCY_CONFIG``, ``latency_layout``) wherever the geometry's key
    boxes fit the card, one block an SM; up to 16 gates 16 x 8 (the key
    stream bounds it: many small tiles spread it over every SM; the latency
    tile, whose blocks each read their digit rows' accumulator words, is
    not faster there on an H100: at B = 4 5.96 against 5.50 ms at the fast
    set, 11.5 against 11.1 at mk_2party_3gen); else 128 x 32 when that still gives at least three quarters of the
    SMs a tile, else 64 x 16; and the wgmma tile (``WGMMA_CONFIG``, 128 x
    64) instead of 128 x 32 where its tiles fill every SM at least once
    (wide batches: 1.46-1.71x faster there on an H100). A geometry whose
    R*bs is no multiple of the 128-byte stages takes the one 64 x 16 tile
    with 64-byte stages at every B.

    The grid: every tile a block, up to what is resident at once (the
    tile's ``resident`` per SM, within shared memory, threads and the block
    limit): blocks that share an SM share its rounds, so more of them only
    hide latency; the wgmma tile's grid is whole clusters, a pair of gate
    tiles of one key box each. A ragged last round is left ragged: tiles are
    dealt round-robin, gate tiles of one key box side by side. The latency
    tile's grid is the step's key boxes."""
    _check_plan(B, geom, decomp_length, "blind_rotate.cu", 32, 64)
    small, mid, big = 0, 1, 2
    layout = latency_layout(B, geom, sm_count)
    if geom.R * geom.bs % ROTATE_CONFIGS[small].bk:
        config = NARROW_CONFIG
    elif layout is not None:
        blocks = latency_blocks(geom, layout.units)
        return RotatePlan(LATENCY_CONFIG, ROTATE_CONFIGS[LATENCY_CONFIG], 1, B, blocks, blocks,
                          blocks, blocks / sm_count, 1.0, layout.smem,
                          B * geom.C * geom.N * 4 + 16, layout)
    elif B <= ROTATE_CONFIGS[small].bm:  # also where the key boxes outnumber the SMs
        config = small
    else:
        m_big, n_big = _tile_counts(ROTATE_CONFIGS[big], B, geom)
        config = big if 4 * m_big * n_big >= 3 * sm_count else mid
        wide = ROTATE_CONFIGS[WGMMA_CONFIG]
        m_wide, n_wide = _tile_counts(wide, B, geom)
        if config == big and geom.bs % wide.wq == 0 and m_wide * n_wide >= sm_count:
            config = WGMMA_CONFIG
    return _plan(config, ROTATE_CONFIGS[config], B, geom, sm_count)


def latency_n_tile(rows: int) -> int:
    """N of the latency tile's wgmma tiles over ``rows`` digit rows (at
    most 64): the least of 8, 16, 32 that halves them (one tile a
    warpgroup)."""
    nt = 8
    while nt < 32 and 2 * nt < rows:
        nt *= 2
    return nt


def latency_blocks(geom: FBlockGeometry, units: int) -> int:
    """The latency tile's grid: a step's key boxes, key blocks m = (i - j)
    mod D of the 2*nb - 1 offsets i - j that pair a digit block i with an
    output block j, times the C polynomials, times the bs coefficients in
    boxes of ``units`` units of 8 (every limb column of the polynomial)."""
    return (2 * geom.nb - 1) * geom.C * (geom.bs // (8 * units))


@functools.lru_cache(maxsize=256)
def latency_layout(B: int, geom: FBlockGeometry, most: int) -> LatencyLayout | None:
    """The latency tile's layout for ``B`` gates within ``most`` blocks
    (``LatencyLayout``), or None where the tile does not take them.

    ``units`` is the least power of two from 4 (one A tile of 32
    coefficients) dividing bs/8 that leaves at most ``most`` key boxes
    (``latency_blocks``). Shared memory: the 1024-aligned ring of ``slots``
    box-steps (R*bs/128 chunks x units/4 A tiles x 2 limb pairs x 64 rows of
    128 bytes), the digit rows that the largest pair set's wgmma tiles read
    (``latency_n_tile`` of nb * B rows, at most 64, in whole tiles), each
    item's partial words (N words a thread of a warpgroup; two items at
    least), a full and an empty mbarrier a slot and two rotations a gate;
    as many slots as fit ``BLOCK_SHARED_LIMIT``, up to ``most_slots``. The
    producer paces its copies at the grid's share of the device-memory rate
    (``BYTES_PER_S``), at half the pause, since __nanosleep may sleep up to
    twice as long as asked."""
    tile = ROTATE_CONFIGS[LATENCY_CONFIG]
    rbs, rows = geom.R * geom.bs, geom.nb * B
    if rbs % tile.bk or geom.bs % tile.coefs or B > tile.most_gates or rows > 64:
        return None
    units = tile.coefs // 8
    while latency_blocks(geom, units) > most and geom.bs % (16 * units) == 0:
        units *= 2
    if latency_blocks(geom, units) > most:
        return None
    nt = latency_n_tile(rows)
    tiles = -(-rows // nt)
    a_tiles = units * 8 // tile.coefs
    box = rbs // tile.bk * a_tiles * 2 * 64 * tile.bk
    items = max(2, a_tiles * tiles)
    fixed = 1024 + rbs // tile.bk * tiles * nt * tile.bk + items * nt * 128 + 8 * tile.most_gates
    slots = min(tile.most_slots, (BLOCK_SHARED_LIMIT - fixed) // (box + 16))
    if slots < 1:
        return None
    pace_ns = int(64 * tile.bk * latency_blocks(geom, units) / (BYTES_PER_S / 1e9) / 2)
    return LatencyLayout(units, slots, fixed + slots * (box + 16), pace_ns, nt, tiles * nt)


def _tile_counts(cfg: TileConfig, B: int, geom: FBlockGeometry) -> tuple:
    """(gate tiles, column tiles a step) of ``B`` gates under ``cfg``."""
    return -(-B // cfg.bm), geom.nb * geom.C * (geom.bs // cfg.wq)


def _plan(config: int, cfg: TileConfig, B: int, geom: FBlockGeometry,
          sm_count: int) -> RotatePlan:
    m_tiles, n_tiles = _tile_counts(cfg, B, geom)
    tiles = m_tiles * n_tiles
    per_sm = min(SM_SHARED_BYTES // (cfg.smem_bytes + BLOCK_SHARED_OVERHEAD),
                 SM_MAX_THREADS // cfg.threads, SM_MAX_BLOCKS, cfg.resident)
    blocks = min(tiles, per_sm * sm_count)
    if cfg.wgmma:  # whole clusters, a pair of gate tiles each
        pairs = -(-m_tiles // WGMMA_CLUSTER) * n_tiles
        blocks = WGMMA_CLUSTER * min(pairs, max(1, per_sm * sm_count // WGMMA_CLUSTER))
    fill = tiles / (-(-tiles // sm_count) * sm_count) if tiles > sm_count else 1.0
    return RotatePlan(config, cfg, m_tiles, m_tiles * cfg.bm, n_tiles, tiles, blocks,
                      tiles / sm_count, fill, cfg.smem_bytes, B * geom.R * geom.N)


def sel_plan(B: int, geom: FBlockGeometry, decomp_length: int, sm_count: int) -> RotatePlan:
    """How blind_rotate_sel.cu runs ``B`` gates on a card of ``sm_count`` SMs.

    The key side of a tile is a few hundred bytes a stage, so what a tile
    draws from L2 is its digit rows, once per column tile. Up to 16 gates:
    16 x 16, eight warps splitting the reduction (one gate's columns spread
    over every SM). Above, where every polynomial has four limb columns (the
    3gen sets): the wgmma tile (``SEL_WGMMA_CONFIG``, 64 x 64) from two of
    its gate tiles up, since at 4 and 8 parties it beats the mma.sync tiles
    at every batch from 96 gates (at half the SMs: 138 against 224 ms at 8
    parties, B=96, on an H100). Otherwise 64 x 16 with four groups of four
    warps splitting the reduction (111 against 138 ms at B=64). A stage
    stays inside one line, so a geometry whose bs is no multiple of the
    128-byte stages (N = 64) takes the one 64 x 16 tile with 64-byte stages
    at every B. The grid is cut as in ``rotate_plan``."""
    groups = _check_plan(B, geom, decomp_length, "blind_rotate_sel.cu", 64, 64)
    small, mid = 0, 1
    if geom.bs % SEL_CONFIGS[small].bk:
        config = SEL_NARROW_CONFIG
    elif B <= SEL_CONFIGS[small].bm:
        config = small
    elif all(nl == MAX_LIMBS for _, nl in groups) and B > SEL_CONFIGS[SEL_WGMMA_CONFIG].bm:
        config = SEL_WGMMA_CONFIG
    else:
        config = mid
    return _plan(config, SEL_CONFIGS[config], B, geom, sm_count)


def rotate_bound_ms(B: int, geom: FBlockGeometry, key_bytes: int,
                    limb_blocks: int = 1) -> tuple:
    """(bound ms, what bounds it) of one blind rotate from its shapes: the
    int8 multiply-adds of n steps, two operations each, once for each of a
    digit's ``limb_blocks`` int8 limb blocks (one for digits of at most a
    byte), over the card's int8 peak, against the bytes read once (key,
    bara, an accumulator in) and written once (the accumulator out) over the
    device-memory rate."""
    macs = limb_blocks * geom.n * B * (geom.R * geom.N) * (len(geom.cols) * geom.N)
    moved = key_bytes + B * geom.n * 4 + 2 * B * geom.C * geom.N * 4
    return bound_ms(2 * macs, INT8_OPS_PER_S, moved)


def _check_chain(kernel: _Kernel, acc_a, key, bara, geom: FBlockGeometry, decomp_length: int,
                 log2_base: int, stepvec) -> bool:
    """The checks of ``kernel`` and its plain version; ``key`` must be int8
    (steps,) + one of its two layouts. Returns whether it is the kernel
    layout."""
    if geom.bits != 32:
        raise ValueError(f"the blind rotate implements the 32-bit torus, not {geom.bits}")
    if not 1 <= log2_base <= 8 or decomp_length * log2_base > 32:
        raise ValueError(f"digits must fit a byte: l={decomp_length}, log2_base={log2_base}")
    _check_geometry(geom, decomp_length)
    # every output sums R*N products of |digit| <= 2^(lb-1) and |limb| <= 128
    bound = geom.R * geom.N * (1 << (log2_base - 1)) * 128
    if bound >= 2**31:
        raise ValueError(f"R*N*2^(lb-1)*128 = {bound} is not below 2^31: the int32 "
                         f"sums of {geom} with log2_base={log2_base} are not exact")
    return _check_tensors(acc_a, key, bara, geom, stepvec,
                          (kernel.plain_layout(geom), kernel.kernel_layout(geom)),
                          kernel.key_name, torch.int32) == 1


def _check_tensors(acc_a, key, bara, geom: FBlockGeometry, stepvec, key_shapes: tuple,
                   what: str, dtype: torch.dtype) -> int:
    """The checks every route shares: ``key`` int8 (steps,) + one of
    ``key_shapes``, bara int32 (B, steps), an accumulator of ``dtype`` or a
    stepvec, all on one device. Returns the index of the key's shape."""
    step = tuple(key.shape[1:])
    if key.dtype != torch.int8 or step not in key_shapes:
        shapes = " or ".join(f"(steps, {', '.join(map(str, s))})" for s in key_shapes)
        raise ValueError(f"{what} must be int8 {shapes}, got {key.dtype} {tuple(key.shape)}")
    if bara.dtype != torch.int32 or bara.dim() != 2 or bara.shape[1] != key.shape[0]:
        raise ValueError(f"bara must be int32 (B, {key.shape[0]}), got "
                         f"{bara.dtype} {tuple(bara.shape)}")
    B = bara.shape[0]
    if stepvec is None:
        if acc_a is None or acc_a.dtype != dtype or tuple(acc_a.shape) != (B, geom.C, geom.N):
            raise ValueError(f"acc must be {dtype} ({B}, {geom.C}, {geom.N})")
        tensors = (acc_a, key, bara)
    else:
        if acc_a is not None:
            raise ValueError("pass either acc or stepvec, not both")
        barb = stepvec[1]
        if barb.dtype != torch.int32 or tuple(barb.shape) != (B,):
            raise ValueError(f"barb must be int32 ({B},)")
        tensors = (barb, key, bara)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all tensors must be on one device")
    return key_shapes.index(step)


def check_args(acc_a, fb, bara, geom: FBlockGeometry, decomp_length: int,
               log2_base: int, stepvec=None) -> None:
    """Raise ValueError on anything blind_rotate.cu and its plain version do
    not take: types, shapes, a torus other than 32 bits, digits wider than a
    byte, sums that could leave int32, mixed devices. ``fb`` is the expanded
    key in the ``build_fblocks`` layout or in the kernel layout."""
    _check_chain(_EXPANDED, acc_a, fb, bara, geom, decomp_length, log2_base, stepvec)


def check_sel_args(acc_a, sel, bara, geom: FBlockGeometry, decomp_length: int,
                   log2_base: int, stepvec=None) -> None:
    """The same for blind_rotate_sel.cu and its plain version, whose key is
    the compact lines, int8: (steps, R, 2N, ncols) as ``build_sel`` lays
    them out, or the compact kernel layout (steps, ncols, R, 2N)."""
    _check_chain(_COMPACT, acc_a, sel, bara, geom, decomp_length, log2_base, stepvec)


def _ptr(t):
    return None if t is None else t.data_ptr()


# While a caller holds a list here, every launch appends its (start, end) CUDA
# events, recorded on the launch's stream: the caller sums the kernels' time.
launch_events = None


def _launch(name: str, plan: RotatePlan, acc_a, key, bara, geom: FBlockGeometry,
            decomp_length: int, log2_base: int, offset: int, stepvec) -> tuple:
    """One cooperative launch of library ``name`` under ``plan`` on the
    current stream of the key's device. Allocates the output, which is the
    kernel's accumulator, and the digit scratch. Returns (out, grid used)."""
    B = bara.shape[0]
    out = torch.empty((B, geom.C, geom.N), dtype=torch.int32, device=key.device)
    # contiguous tensors, held here until the launch, and the init mode's mu
    key, bara = key.contiguous(), bara.contiguous()
    if stepvec is None:
        acc_a, barb, mu = acc_a.contiguous(), None, 0
    else:
        mu, barb = int(stepvec[0]) & 0xFFFFFFFF, stepvec[1].contiguous()
    grid = ctypes.c_int(0)
    # blind_rotate_launch's layout argument: the latency tile's plan, else NULL
    layout = () if name != "blind_rotate" else (
        None if plan.latency is None else (ctypes.c_int * 4)(*plan.latency[:4]),)
    events = None if launch_events is None else [torch.cuda.Event(enable_timing=True)
                                                 for _ in range(2)]
    with torch.cuda.device(key.device):
        dig = torch.empty(plan.scratch_bytes, dtype=torch.int8, device=key.device)
        if events:
            events[0].record()
        err = getattr(_library(name), f"{name}_launch")(
            out.data_ptr(), _ptr(acc_a), _ptr(barb), bara.data_ptr(), key.data_ptr(),
            dig.data_ptr(), B, plan.config, plan.blocks, key.shape[0], geom.N, geom.bs, geom.C,
            decomp_length, log2_base, offset & 0xFFFFFFFF, mu, len(geom.cols),
            *_col_arrays(geom), *layout, torch.cuda.current_stream(key.device).cuda_stream,
            ctypes.byref(grid))
        if events:
            events[1].record()
            launch_events.append(events)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out, grid.value


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


class _Kernel(NamedTuple):
    """What the two kernels differ in (``_blind_rotate``, ``_route``)."""

    name: str                # the library: csrc/<name>.cu, whose launcher is <name>_launch
    plan: Callable           # rotate_plan or sel_plan
    key_name: str            # the key's name in the argument check's errors
    plain_layout: Callable   # geom -> a step's shape in the plain version's layout
    kernel_layout: Callable  # geom -> a step's shape in the kernel layout
    layout_error: str        # the ValueError for a key on the card in the plain layout
    plain: Callable          # the plain version, which reads both layouts
    counters: Callable       # the public launcher, whose attributes count the launches


def _blind_rotate(kernel: _Kernel, acc_a, key, bara, geom: FBlockGeometry,
                  decomp_length: int, log2_base: int, offset: int, stepvec) -> torch.Tensor:
    """One launch of ``kernel``: the checks, the plan, the launch and the
    counters of ``kernel.counters``."""
    kernel_layout = _check_chain(kernel, acc_a, key, bara, geom, decomp_length, log2_base,
                                 stepvec)
    fn = kernel.counters
    if key.device.type != "cuda":
        raise ValueError(f"{fn.__name__} takes CUDA tensors, got {key.device}")
    if not kernel_layout:
        raise ValueError(kernel.layout_error)
    B = bara.shape[0]
    if B == 0:
        return torch.empty((0, geom.C, geom.N), dtype=torch.int32, device=key.device)
    plan = kernel.plan(B, geom, decomp_length, _sm_count(key.device))
    out, fn.grid = _launch(kernel.name, plan, acc_a, key, bara, geom, decomp_length, log2_base,
                           offset, stepvec)
    fn.launches += 1
    fn.rows += B
    fn.by_config[plan.config] = fn.by_config.get(plan.config, 0) + 1
    return out


def blind_rotate_cuda(acc_a, key: torch.Tensor, bara: torch.Tensor,
                      geom: FBlockGeometry, decomp_length: int, log2_base: int,
                      offset: int, stepvec=None) -> torch.Tensor:
    """The n-step CMux chain over the expanded key on the card: one
    cooperative launch, whose persistent grid runs every step as a
    tensor-core GEMM (``rotate_plan``).

    acc_a: (B, C, N) int32, or None with ``stepvec=(mu, barb)`` (int mu,
    barb (B,) int32); key: the kernel layout (n, D, ncols*bs, R*bs) int8
    (``fblock.build_rotate_key`` / ``to_kernel_layout``); bara: (B, n) int32.
    All CUDA tensors. Returns (B, C, N) int32; the output, which is the
    kernel's accumulator, and the digit scratch are allocated here, and the
    launch goes on the current stream. ``blind_rotate_cuda.launches`` counts
    the launches, ``blind_rotate_cuda.rows`` the ciphertexts they rotated,
    ``blind_rotate_cuda.by_config`` the launches per tile config (a dict),
    ``blind_rotate_cuda.grid`` is the last launch's grid.
    """
    return _blind_rotate(_EXPANDED, acc_a, key, bara, geom, decomp_length, log2_base, offset,
                         stepvec)


def blind_rotate_sel_cuda(acc_a, sel: torch.Tensor, bara: torch.Tensor,
                          geom: FBlockGeometry, decomp_length: int, log2_base: int,
                          offset: int, stepvec=None) -> torch.Tensor:
    """The whole CMux chain over the compact key on the card: one
    cooperative launch, whose persistent grid runs every step as a
    tensor-core GEMM with the key operand made on the SM from the lines
    (``sel_plan``). No expanded key is allocated.

    sel: the compact kernel layout (steps, ncols, R, 2N) int8
    (``fblock.build_sel_key`` / ``to_sel_kernel_layout``); acc_a, stepvec,
    bara as for ``blind_rotate_cuda``, over ``steps``. All CUDA tensors.
    Returns (B, C, N) int32, word-equal to ``fblock.blind_rotate_streamed``;
    allocation and stream as for ``blind_rotate_cuda``.
    ``blind_rotate_sel_cuda.launches`` counts the launches,
    ``blind_rotate_sel_cuda.rows`` the ciphertexts they rotated,
    ``blind_rotate_sel_cuda.by_config`` the launches per tile config (a dict),
    ``blind_rotate_sel_cuda.grid`` is the last launch's grid.
    """
    return _blind_rotate(_COMPACT, acc_a, sel, bara, geom, decomp_length, log2_base, offset,
                         stepvec)


for _fn in (blind_rotate_cuda, blind_rotate_sel_cuda):
    _fn.launches, _fn.rows, _fn.by_config, _fn.grid = 0, 0, {}, 0

_EXPANDED = _Kernel(
    "blind_rotate", rotate_plan, "fb", lambda g: (g.D * g.R * g.bs, len(g.cols) * g.bs),
    fblock.kernel_layout_shape,
    "blind_rotate_cuda reads the kernel layout (n, D, ncols*bs, R*bs): build the key on the "
    "card (fblock.build_rotate_key) or convert it once (fblock.to_kernel_layout)",
    fblock.blind_rotate_fblock, blind_rotate_cuda)
_COMPACT = _Kernel(
    "blind_rotate_sel", sel_plan, "sel", lambda g: (g.R, 2 * g.N, len(g.cols)),
    fblock.sel_kernel_layout_shape,
    "blind_rotate_sel_cuda reads the compact kernel layout (steps, ncols, R, 2N): build the key "
    "on the card (fblock.build_sel_key) or convert it once (fblock.to_sel_kernel_layout)",
    fblock.blind_rotate_streamed, blind_rotate_sel_cuda)


def takes_kernel_route(geom: FBlockGeometry, log2_base: int) -> bool:
    """The route of a blind rotate, from its parameters alone: the kernels
    implement the 32-bit torus with digits of at most a byte. A 64-bit
    geometry or wider digits take the torch-op scan (``fblock``) on every
    device, as the JAX package runs them outside its Pallas kernel."""
    return geom.bits == 32 and log2_base <= 8


def check_wide_args(acc_a, key, bara, geom: FBlockGeometry, decomp_length: int,
                    log2_base: int, stepvec, key_shapes: tuple) -> None:
    """Raise ValueError on what the torch-op scan of the wide route does not
    take: an accumulator whose dtype is not the torus dtype of ``geom``,
    wrong shapes, a decomposition deeper than the torus, limb-block sums that
    could leave int32, mixed devices. ``key``: int8 (steps,) + one of
    ``key_shapes``."""
    if geom.bits not in (32, 64):
        raise ValueError(f"the torus is 32 or 64 bits wide, not {geom.bits}")
    dtype = torch.int32 if geom.bits == 32 else torch.int64
    if log2_base < 1 or decomp_length * log2_base > geom.bits or log2_base > 31:
        raise ValueError(f"l={decomp_length} digits of {log2_base} bits do not fit "
                         f"{geom.bits} bits")
    if geom.R != decomp_length * geom.C:
        raise ValueError(f"unsupported geometry {geom} for l={decomp_length}")
    # every output of a limb block sums R*N products of two int8 limbs
    if geom.R * geom.N * 128 * 128 >= 2**31:
        raise ValueError(f"R*N*2^14 = {geom.R * geom.N * 2**14} is not below 2^31: the int32 "
                         f"sums of {geom} are not exact")
    if stepvec is not None and not -(1 << (geom.bits - 1)) <= int(stepvec[0]) < 1 << (geom.bits - 1):
        raise ValueError(f"mu = {stepvec[0]} is no {geom.bits}-bit torus value")
    _check_tensors(acc_a, key, bara, geom, stepvec, key_shapes, "the key", dtype)


def _route(kernel: _Kernel, launch: Callable, acc_a, key, bara, geom: FBlockGeometry,
           decomp_length: int, log2_base: int, offset: int, stepvec) -> torch.Tensor:
    """The body of ``rotate`` and ``rotate_streamed``. ``launch`` is the
    module's launcher as the caller finds it, so that a patch takes effect."""
    args = (geom, decomp_length, log2_base, offset)
    if not takes_kernel_route(geom, log2_base):
        check_wide_args(acc_a, key, bara, geom, decomp_length, log2_base, stepvec,
                        (kernel.plain_layout(geom), kernel.kernel_layout(geom)))
        return kernel.plain(acc_a, key, bara, *args, stepvec=stepvec)
    if key.device.type == "cuda":
        return launch(acc_a, key, bara, *args, stepvec)
    _check_chain(kernel, acc_a, key, bara, geom, decomp_length, log2_base, stepvec)
    if key.device.type == "cpu":
        return kernel.plain(acc_a, key, bara, *args, stepvec=stepvec)
    raise ValueError(f"no blind rotate for device {key.device}")


@spanned("fhe.rotate")
def rotate(acc_a, fb: torch.Tensor, bara: torch.Tensor, geom: FBlockGeometry,
           decomp_length: int, log2_base: int, offset: int,
           stepvec=None) -> torch.Tensor:
    """Blind rotate over the expanded key on the tensors' device. The route
    is chosen from (geom.bits, log2_base) before anything is launched
    (``takes_kernel_route``): the kernel route is the CUDA kernel for CUDA
    tensors (the key in the kernel layout) and its plain version for CPU
    tensors (either layout); the wide route (64 bits, or digits wider than a
    byte) is the torch-op scan ``fblock.blind_rotate_fblock`` on either
    device. Anything else raises."""
    return _route(_EXPANDED, blind_rotate_cuda, acc_a, fb, bara, geom, decomp_length,
                  log2_base, offset, stepvec)


@spanned("fhe.rotate")
def rotate_streamed(acc_a, sel: torch.Tensor, bara: torch.Tensor, geom: FBlockGeometry,
                    decomp_length: int, log2_base: int, offset: int,
                    stepvec=None) -> torch.Tensor:
    """Blind rotate over the compact key on the tensors' device, routed as
    ``rotate`` is: the compact-key kernel for CUDA tensors (the key in the
    compact kernel layout) and the plain ``blind_rotate_streamed`` for CPU
    tensors (either layout) on the kernel route; the same
    ``blind_rotate_streamed`` on either device on the wide route. Anything
    else raises."""
    return _route(_COMPACT, blind_rotate_sel_cuda, acc_a, sel, bara, geom, decomp_length,
                  log2_base, offset, stepvec)

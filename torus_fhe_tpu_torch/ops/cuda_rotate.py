"""The Hopper blind-rotate kernels (csrc/): build, bindings and device
dispatch.

``blind_rotate_cuda`` launches csrc/blind_rotate.cu over the expanded F-block
key: it replaces the Pallas TPU kernel
torus_fhe_tpu/ops/pallas_rotate.py::blind_rotate_pallas, in both init modes
(explicit accumulator, or the stepvec gate test vector).
``blind_rotate_sel_cuda`` launches csrc/blind_rotate_sel.cu over the compact
key lines (ops/fblock.build_sel): it replaces the Pallas route of
torus_fhe_tpu/ops/fblock.py::blind_rotate_streamed, in the same two modes.
``rotate`` and ``rotate_streamed`` are what the bootstraps call: CUDA tensors
go to the kernel, CPU tensors to the plain version (ops/fblock
``blind_rotate_fblock`` and ``blind_rotate_streamed``). There is no fallback:
a CUDA tensor launches the kernel or raises, and a failed build raises.

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

import torch

from . import fblock
from .fblock import FBlockGeometry

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = {"blind_rotate": os.path.join(CSRC, "blind_rotate.cu"),
           "blind_rotate_sel": os.path.join(CSRC, "blind_rotate_sel.cu")}
HEADERS = [os.path.join(CSRC, "cmux_step.cuh")]
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_TILE = 16  # gates per block of blind_rotate.cu: tiles 1, 2, 4, 8, 16
SEL_MAX_TILE = 4  # gates per block of blind_rotate_sel.cu: tiles 1, 2, 4
MAX_COLS = 32


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
    if name == "blind_rotate":
        lib.blind_rotate_launch.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i,
                                            u, u, i, ip, ip, vp]
        lib.blind_rotate_launch.restype = ctypes.c_int
    else:
        lib.blind_rotate_sel_launch.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, i,
                                                u, u, i, ip, ip, vp]
        lib.blind_rotate_sel_launch.restype = ctypes.c_int
    return lib


def _col_arrays(geom: FBlockGeometry):
    ncols = len(geom.cols)
    return ((ctypes.c_int * ncols)(*[p for p, _ in geom.cols]),
            (ctypes.c_int * ncols)(*[s for _, s in geom.cols]))


def smem_bytes(bt: int, geom: FBlockGeometry, decomp_length: int) -> int:
    """Dynamic shared memory of a block of blind_rotate.cu with ``bt``
    gates: the accumulators (C*N int32 each) and the digit rows (l*C*N
    int8 each)."""
    return bt * geom.C * geom.N * (4 + decomp_length)


def sel_smem_bytes(bt: int, geom: FBlockGeometry) -> int:
    """Dynamic shared memory of a block of blind_rotate_sel.cu with ``bt``
    gates: the accumulators (C*N int32 each), four shifted copies of the
    digit rows (4*R*(N+4) int8 each), and one step's lines (ncols*R*2N)."""
    return bt * (geom.C * geom.N * 4 + 4 * geom.R * (geom.N + 4)) + \
        len(geom.cols) * geom.R * 2 * geom.N


def _pick_tile(B: int, max_tile: int, nbytes, device) -> int:
    """Gates per block: enough blocks to give every SM one, at most
    ``max_tile``, and within the shared memory a block may opt in to."""
    props = torch.cuda.get_device_properties(device)
    cap = getattr(props, "shared_memory_per_block_optin", 227 * 1024)
    want = -(-B // props.multi_processor_count)
    bt = 1
    while bt < max_tile and bt < want:
        bt *= 2
    while bt > 1 and nbytes(bt) > cap:
        bt //= 2
    if nbytes(bt) > cap:
        raise ValueError(f"one gate needs {nbytes(1)} B of shared memory, above the "
                         f"{cap} B a block may use")
    return bt


def _check_chain(acc_a, key, bara, geom: FBlockGeometry, decomp_length: int,
                 log2_base: int, stepvec, key_shape: tuple, what: str) -> None:
    """The checks both kernels share; ``key`` must be int8 (steps,) +
    ``key_shape``."""
    if geom.bits != 32:
        raise ValueError(f"the blind rotate implements the 32-bit torus, not {geom.bits}")
    if not 1 <= log2_base <= 8 or decomp_length * log2_base > 32:
        raise ValueError(f"digits must fit a byte: l={decomp_length}, log2_base={log2_base}")
    if geom.R != decomp_length * geom.C or geom.bs % 16 or len(geom.cols) > MAX_COLS:
        raise ValueError(f"unsupported geometry {geom} for l={decomp_length}")
    # every output sums R*N products of |digit| <= 2^(lb-1) and |limb| <= 128
    bound = geom.R * geom.N * (1 << (log2_base - 1)) * 128
    if bound >= 2**31:
        raise ValueError(f"R*N*2^(lb-1)*128 = {bound} is not below 2^31: the int32 "
                         f"sums of {geom} with log2_base={log2_base} are not exact")
    if key.dtype != torch.int8 or key.dim() != 1 + len(key_shape) or \
            tuple(key.shape[1:]) != key_shape:
        raise ValueError(f"{what} must be int8 (steps, {', '.join(map(str, key_shape))}), "
                         f"got {key.dtype} {tuple(key.shape)}")
    if bara.dtype != torch.int32 or bara.dim() != 2 or bara.shape[1] != key.shape[0]:
        raise ValueError(f"bara must be int32 (B, {key.shape[0]}), got "
                         f"{bara.dtype} {tuple(bara.shape)}")
    B = bara.shape[0]
    if stepvec is None:
        if acc_a is None or acc_a.dtype != torch.int32 or \
                tuple(acc_a.shape) != (B, geom.C, geom.N):
            raise ValueError(f"acc must be int32 ({B}, {geom.C}, {geom.N})")
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


def check_args(acc_a, fb, bara, geom: FBlockGeometry, decomp_length: int,
               log2_base: int, stepvec=None) -> None:
    """Raise ValueError on anything blind_rotate.cu (and its plain version)
    does not take: types, shapes, a torus other than 32 bits, digits wider
    than a byte, sums that could leave int32, mixed devices."""
    _check_chain(acc_a, fb, bara, geom, decomp_length, log2_base, stepvec,
                 (geom.D * geom.R * geom.bs, len(geom.cols) * geom.bs), "fb")


def check_sel_args(acc_a, sel, bara, geom: FBlockGeometry, decomp_length: int,
                   log2_base: int, stepvec=None) -> None:
    """The same for blind_rotate_sel.cu, whose key is the compact lines
    (steps, R, 2N, ncols) int8."""
    _check_chain(acc_a, sel, bara, geom, decomp_length, log2_base, stepvec,
                 (geom.R, 2 * geom.N, len(geom.cols)), "sel")
    if geom.N % 8:
        raise ValueError(f"the compact kernel takes N a multiple of 8, not {geom.N}")


def _launch_args(acc_a, key, bara, stepvec):
    """Contiguous tensors of a launch (held by the caller until the launch)
    and the init mode's mu."""
    if stepvec is None:
        acc_a, barb, mu = acc_a.contiguous(), None, 0
    else:
        mu, barb = int(stepvec[0]), stepvec[1].contiguous()
    return key.contiguous(), bara.contiguous(), acc_a, barb, mu & 0xFFFFFFFF


def _ptr(t):
    return None if t is None else t.data_ptr()


def blind_rotate_cuda(acc_a, fb: torch.Tensor, bara: torch.Tensor,
                      geom: FBlockGeometry, decomp_length: int, log2_base: int,
                      offset: int, stepvec=None) -> torch.Tensor:
    """The n-step CMux chain over the expanded key on the card, one launch.

    acc_a: (B, C, N) int32, or None with ``stepvec=(mu, barb)`` (int mu,
    barb (B,) int32); fb: (n, D*R*bs, ncols*bs) int8 (ops/fblock layout);
    bara: (B, n) int32. All CUDA tensors. Returns (B, C, N) int32, allocated
    here; the launch goes on the current stream. ``blind_rotate_cuda.launches``
    counts the launches.
    """
    check_args(acc_a, fb, bara, geom, decomp_length, log2_base, stepvec)
    if fb.device.type != "cuda":
        raise ValueError(f"blind_rotate_cuda takes CUDA tensors, got {fb.device}")
    B = bara.shape[0]
    out = torch.empty((B, geom.C, geom.N), dtype=torch.int32, device=fb.device)
    if B == 0:
        return out
    fb, bara, acc_a, barb, mu = _launch_args(acc_a, fb, bara, stepvec)
    bt = _pick_tile(B, MAX_TILE, lambda t: smem_bytes(t, geom, decomp_length), fb.device)
    err = _library("blind_rotate").blind_rotate_launch(
        out.data_ptr(), _ptr(acc_a), _ptr(barb), bara.data_ptr(), fb.data_ptr(),
        B, bt, fb.shape[0], geom.N, geom.bs, geom.C, decomp_length, log2_base,
        offset & 0xFFFFFFFF, mu, len(geom.cols), *_col_arrays(geom),
        torch.cuda.current_stream(fb.device).cuda_stream)
    if err:
        raise RuntimeError(f"blind_rotate kernel launch failed: CUDA error {err}")
    blind_rotate_cuda.launches += 1
    return out


blind_rotate_cuda.launches = 0


def blind_rotate_sel_cuda(acc_a, sel: torch.Tensor, bara: torch.Tensor,
                          geom: FBlockGeometry, decomp_length: int, log2_base: int,
                          offset: int, stepvec=None) -> torch.Tensor:
    """The whole CMux chain over the compact key on the card, one launch.

    sel: (steps, R, 2N, ncols) int8, the ``fblock.build_sel`` layout, read as
    it is; acc_a, stepvec, bara as for ``blind_rotate_cuda``, over ``steps``.
    Returns (B, C, N) int32, word-equal to ``fblock.blind_rotate_streamed``.
    ``blind_rotate_sel_cuda.launches`` counts the launches.
    """
    check_sel_args(acc_a, sel, bara, geom, decomp_length, log2_base, stepvec)
    if sel.device.type != "cuda":
        raise ValueError(f"blind_rotate_sel_cuda takes CUDA tensors, got {sel.device}")
    B = bara.shape[0]
    out = torch.empty((B, geom.C, geom.N), dtype=torch.int32, device=sel.device)
    if B == 0:
        return out
    sel, bara, acc_a, barb, mu = _launch_args(acc_a, sel, bara, stepvec)
    bt = _pick_tile(B, SEL_MAX_TILE, lambda t: sel_smem_bytes(t, geom), sel.device)
    err = _library("blind_rotate_sel").blind_rotate_sel_launch(
        out.data_ptr(), _ptr(acc_a), _ptr(barb), bara.data_ptr(), sel.data_ptr(),
        B, bt, sel.shape[0], geom.N, geom.C, decomp_length, log2_base,
        offset & 0xFFFFFFFF, mu, len(geom.cols), *_col_arrays(geom),
        torch.cuda.current_stream(sel.device).cuda_stream)
    if err:
        raise RuntimeError(f"blind_rotate_sel kernel launch failed: CUDA error {err}")
    blind_rotate_sel_cuda.launches += 1
    return out


blind_rotate_sel_cuda.launches = 0


def rotate(acc_a, fb: torch.Tensor, bara: torch.Tensor, geom: FBlockGeometry,
           decomp_length: int, log2_base: int, offset: int,
           stepvec=None) -> torch.Tensor:
    """Blind rotate over the expanded key on the tensors' device: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors; anything
    else raises."""
    if fb.device.type == "cuda":
        return blind_rotate_cuda(acc_a, fb, bara, geom, decomp_length, log2_base,
                                 offset, stepvec)
    check_args(acc_a, fb, bara, geom, decomp_length, log2_base, stepvec)
    if fb.device.type == "cpu":
        return fblock.blind_rotate_fblock(acc_a, fb, bara, geom, decomp_length,
                                          log2_base, offset, stepvec)
    raise ValueError(f"no blind rotate for device {fb.device}")


def rotate_streamed(acc_a, sel: torch.Tensor, bara: torch.Tensor, geom: FBlockGeometry,
                    decomp_length: int, log2_base: int, offset: int,
                    stepvec=None) -> torch.Tensor:
    """Blind rotate over the compact key on the tensors' device: the
    compact-key kernel for CUDA tensors, the plain ``blind_rotate_streamed``
    for CPU tensors; anything else raises."""
    if sel.device.type == "cuda":
        return blind_rotate_sel_cuda(acc_a, sel, bara, geom, decomp_length, log2_base,
                                     offset, stepvec)
    check_sel_args(acc_a, sel, bara, geom, decomp_length, log2_base, stepvec)
    if sel.device.type == "cpu":
        return fblock.blind_rotate_streamed(acc_a, sel, bara, geom, decomp_length,
                                            log2_base, offset, stepvec=stepvec)
    raise ValueError(f"no blind rotate for device {sel.device}")

"""The Hopper blind-rotate kernel (csrc/blind_rotate.cu): build, binding and
device dispatch.

``blind_rotate_cuda`` launches the hand-written CUDA kernel that replaces the
Pallas TPU kernel torus_fhe_tpu/ops/pallas_rotate.py::blind_rotate_pallas, in
both init modes (explicit accumulator, or the stepvec gate test vector).
``rotate`` is what the bootstrap calls: CUDA tensors go to the kernel, CPU
tensors to the plain version ops/fblock.blind_rotate_fblock. There is no
fallback: a CUDA tensor launches the kernel or raises, and a failed build
raises.

The kernel is compiled with nvcc at first use into ``_build/`` next to this
package (a shared library with a plain C interface, loaded with ctypes),
keyed by a hash of the source and flags so that an edit rebuilds it.
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
SOURCE = os.path.join(_PKG, "csrc", "blind_rotate.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
MAX_TILE = 16  # gates per block: the library has tiles 1, 2, 4, 8, 16
MAX_COLS = 32


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked for {path})")
    return path


def build() -> tuple[str, str]:
    """Compile the kernel library if it is not built yet.

    Returns (path of the .so, nvcc's report: ptxas registers and shared
    memory per kernel, empty when the library was already built)."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libblind_rotate_{tag}.so")
    if os.path.exists(so):
        return so, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    return so, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()[0])
    vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    ip = ctypes.POINTER(ctypes.c_int)
    lib.blind_rotate_launch.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, i, i, i, i,
                                        u, u, i, ip, ip, vp]
    lib.blind_rotate_launch.restype = ctypes.c_int
    return lib


def smem_bytes(bt: int, geom: FBlockGeometry, decomp_length: int) -> int:
    """Dynamic shared memory of a block of ``bt`` gates: the accumulators
    (C*N int32 each) and the digit rows (l*C*N int8 each)."""
    return bt * geom.C * geom.N * (4 + decomp_length)


def _tile(B: int, geom: FBlockGeometry, decomp_length: int, device) -> int:
    """Gates per block: enough blocks to give every SM one, at most 16, and
    within the shared memory a block may opt in to."""
    props = torch.cuda.get_device_properties(device)
    cap = getattr(props, "shared_memory_per_block_optin", 227 * 1024)
    want = -(-B // props.multi_processor_count)
    bt = 1
    while bt < MAX_TILE and bt < want:
        bt *= 2
    while bt > 1 and smem_bytes(bt, geom, decomp_length) > cap:
        bt //= 2
    if smem_bytes(bt, geom, decomp_length) > cap:
        raise ValueError(f"one gate needs {smem_bytes(1, geom, decomp_length)} B of "
                         f"shared memory, above the {cap} B a block may use")
    return bt


def check_args(acc_a, fb, bara, geom: FBlockGeometry, decomp_length: int,
               log2_base: int, stepvec=None) -> None:
    """Raise ValueError on anything the kernel (and its plain version) does
    not take: types, shapes, a torus other than 32 bits, digits wider than
    a byte, mixed devices."""
    if geom.bits != 32:
        raise ValueError(f"the blind rotate implements the 32-bit torus, not {geom.bits}")
    if not 1 <= log2_base <= 8 or decomp_length * log2_base > 32:
        raise ValueError(f"digits must fit a byte: l={decomp_length}, log2_base={log2_base}")
    if geom.R != decomp_length * geom.C or geom.bs % 16 or len(geom.cols) > MAX_COLS:
        raise ValueError(f"unsupported geometry {geom} for l={decomp_length}")
    ncols = len(geom.cols)
    if fb.dtype != torch.int8 or fb.dim() != 3 or \
            tuple(fb.shape[1:]) != (geom.D * geom.R * geom.bs, ncols * geom.bs):
        raise ValueError(f"fb must be int8 (n, {geom.D * geom.R * geom.bs}, "
                         f"{ncols * geom.bs}), got {fb.dtype} {tuple(fb.shape)}")
    if bara.dtype != torch.int32 or bara.dim() != 2 or bara.shape[1] != fb.shape[0]:
        raise ValueError(f"bara must be int32 (B, {fb.shape[0]}), got "
                         f"{bara.dtype} {tuple(bara.shape)}")
    B = bara.shape[0]
    if stepvec is None:
        if acc_a is None or acc_a.dtype != torch.int32 or \
                tuple(acc_a.shape) != (B, geom.C, geom.N):
            raise ValueError(f"acc must be int32 ({B}, {geom.C}, {geom.N})")
        tensors = (acc_a, fb, bara)
    else:
        if acc_a is not None:
            raise ValueError("pass either acc or stepvec, not both")
        barb = stepvec[1]
        if barb.dtype != torch.int32 or tuple(barb.shape) != (B,):
            raise ValueError(f"barb must be int32 ({B},)")
        tensors = (barb, fb, bara)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all tensors must be on one device")


def blind_rotate_cuda(acc_a, fb: torch.Tensor, bara: torch.Tensor,
                      geom: FBlockGeometry, decomp_length: int, log2_base: int,
                      offset: int, stepvec=None) -> torch.Tensor:
    """The n-step CMux chain on the card, one kernel launch.

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
    fb, bara = fb.contiguous(), bara.contiguous()
    if stepvec is None:
        acc_a, barb, mu = acc_a.contiguous(), None, 0
    else:
        mu, barb = int(stepvec[0]), stepvec[1].contiguous()
    bt = _tile(B, geom, decomp_length, fb.device)
    ncols = len(geom.cols)
    col_poly = (ctypes.c_int * ncols)(*[p for p, _ in geom.cols])
    col_shift = (ctypes.c_int * ncols)(*[s for _, s in geom.cols])
    err = _library().blind_rotate_launch(
        out.data_ptr(), None if acc_a is None else acc_a.data_ptr(),
        None if barb is None else barb.data_ptr(), bara.data_ptr(), fb.data_ptr(),
        B, bt, fb.shape[0], geom.N, geom.bs, geom.C, decomp_length, log2_base,
        offset & 0xFFFFFFFF, mu & 0xFFFFFFFF, ncols, col_poly, col_shift,
        torch.cuda.current_stream(fb.device).cuda_stream)
    if err:
        raise RuntimeError(f"blind_rotate kernel launch failed: CUDA error {err}")
    blind_rotate_cuda.launches += 1
    return out


blind_rotate_cuda.launches = 0


def rotate(acc_a, fb: torch.Tensor, bara: torch.Tensor, geom: FBlockGeometry,
           decomp_length: int, log2_base: int, offset: int,
           stepvec=None) -> torch.Tensor:
    """Blind rotate on the tensors' device: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors; anything else raises."""
    if fb.device.type == "cuda":
        return blind_rotate_cuda(acc_a, fb, bara, geom, decomp_length, log2_base,
                                 offset, stepvec)
    check_args(acc_a, fb, bara, geom, decomp_length, log2_base, stepvec)
    if fb.device.type == "cpu":
        return fblock.blind_rotate_fblock(acc_a, fb, bara, geom, decomp_length,
                                          log2_base, offset, stepvec)
    raise ValueError(f"no blind rotate for device {fb.device}")

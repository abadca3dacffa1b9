"""ctypes bindings to the host native runtime (csrc/host_native.cpp).

Port of torus_fhe_tpu/ops/native.py over this package's own copy of the
source. The library is built at first use with ``g++ -O3 -fopenmp -fPIC
-shared`` (the JAX package's flags) into ``_build/`` beside the package (the
name carries a hash of the source and flags, the build writes a temporary
file and renames it, so processes that build at once do not collide). A
compiler without OpenMP (one that cannot find libgomp) builds the same
source without ``-fopenmp``: its loops then run on one thread, with the same
words. If g++ is missing or fails, ``available()`` is False with a warning
that says why, and callers take their numpy paths: the same words, slower.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import warnings

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "host_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-fPIC", "-Wall", "-std=c++17", "-shared")
OPENMP = "-fopenmp"
VARIANTS = ((OPENMP, *CXX_FLAGS), CXX_FLAGS)  # with OpenMP first, without where it is missing


def so_path(flags=VARIANTS[0]) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libhost_native_{h.hexdigest()[:16]}.so")


def build() -> str:
    """The library's path, compiled first if it is not built yet: with
    OpenMP, else without it. RuntimeError with the compiler's output when
    neither build succeeds."""
    for flags in VARIANTS:
        if os.path.exists(so_path(flags)):
            return so_path(flags)
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler: g++ not found")
    os.makedirs(BUILD_DIR, exist_ok=True)
    failures = []
    for flags in VARIANTS:
        so = so_path(flags)
        tmp = f"{so}.{os.getpid()}.tmp"
        proc = subprocess.run([cxx, *flags, "-o", tmp, SOURCE], capture_output=True, text=True,
                              timeout=300)
        if proc.returncode == 0:
            os.replace(tmp, so)
            return so
        failures.append(f"{cxx} {' '.join(flags)} failed on {SOURCE} with code "
                        f"{proc.returncode}:\n{proc.stderr.strip()[-1000:]}")
    raise RuntimeError("\n".join(failures))


def openmp() -> bool:
    """The library loaded was built with OpenMP."""
    return available() and os.path.exists(so_path(VARIANTS[0]))


@functools.lru_cache(maxsize=None)
def _library():
    try:
        lib = ctypes.CDLL(build())
    except (RuntimeError, OSError, subprocess.TimeoutExpired) as err:
        warnings.warn(f"host_native unavailable, numpy paths instead: {err}")
        return None
    lib.torus_native_version.restype = ctypes.c_int32
    if lib.torus_native_version() != 1:
        raise RuntimeError(f"host_native version {lib.torus_native_version()}, want 1")
    i32, i64 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
    lib.negacyclic_polymul_batch.argtypes = [i32, i64, i64, ctypes.c_int64, ctypes.c_int32]
    lib.bl_shares_stream.argtypes = [i32, i32, i32, ctypes.c_int64, ctypes.c_int32,
                                     ctypes.c_int32, ctypes.c_int32]
    lib.bl_share_matmul.argtypes = [i32, i32, i32, ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int64]
    return lib


def available() -> bool:
    """The library is built (at the first call) and loads."""
    return _library() is not None


def _lib():
    lib = _library()
    if lib is None:
        raise RuntimeError("the host native library is not available (see the warning)")
    return lib


def _ptr(arr: np.ndarray, typ):
    return arr.ctypes.data_as(ctypes.POINTER(typ))


def negacyclic_polymul(a: np.ndarray, b: np.ndarray, bits: int) -> np.ndarray:
    """Exact negacyclic a (*) b mod 2^bits: a small ints and b torus ints,
    broadcastable, trailing axis N. Returns the broadcast shape, int32 for
    bits <= 32 and int64 for 64."""
    out_shape = np.broadcast_shapes(np.shape(a), np.shape(b))
    N = out_shape[-1]
    a_b = np.ascontiguousarray(np.broadcast_to(a, out_shape), np.int32)
    b_b = np.ascontiguousarray(np.broadcast_to(b, out_shape), np.int64)
    out = np.empty(out_shape, np.int64)
    batch = int(np.prod(out_shape[:-1])) if len(out_shape) > 1 else 1
    _lib().negacyclic_polymul_batch(_ptr(a_b, ctypes.c_int32), _ptr(b_b, ctypes.c_int64),
                                    _ptr(out, ctypes.c_int64), batch, N)
    if bits == 64:
        return out
    res = out & ((1 << bits) - 1)
    res[res >= (1 << (bits - 1))] -= 1 << bits
    return res.astype(np.int32 if bits <= 32 else np.int64)


def bl_shares_stream(key: np.ndarray, blocks: np.ndarray) -> np.ndarray:
    """Shares (G, t, k, N) int32 from the key (k, N) and the random blocks
    (G, t-1, k, N): share 0 the key plus every block, share i > 0 block
    t-1-i."""
    G, tm1, k, N = blocks.shape
    key = np.ascontiguousarray(key, np.int32)
    blocks = np.ascontiguousarray(blocks, np.int32)
    out = np.empty((G, tm1 + 1, k, N), np.int32)
    _lib().bl_shares_stream(_ptr(key, ctypes.c_int32), _ptr(blocks, ctypes.c_int32),
                            _ptr(out, ctypes.c_int32), G, tm1 + 1, k, N)
    return out


def bl_share_matmul(M: np.ndarray, rho: np.ndarray) -> np.ndarray:
    """S = M . rho in exact integer sums, int32: M (d, e), rho (e, n)."""
    M = np.ascontiguousarray(M, np.int32)
    rho = np.ascontiguousarray(rho, np.int32)
    d, e = M.shape
    out = np.empty((d, rho.shape[1]), np.int32)
    _lib().bl_share_matmul(_ptr(M, ctypes.c_int32), _ptr(rho, ctypes.c_int32),
                           _ptr(out, ctypes.c_int32), d, e, rho.shape[1])
    return out

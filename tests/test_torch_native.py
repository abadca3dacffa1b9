"""The port's host native runtime (ops/native.py over csrc/host_native.cpp)
against its numpy paths and the JAX package's native runtime.

The library is built here with g++ at first use. Every function is exact
integer arithmetic, so each result must equal the numpy path's and the JAX
package's library's word for word (tolerance 0), on inputs made from a
numpy seed.
"""

import os
import warnings

import jax
import numpy as np
import pytest
import torch

from torus_fhe_tpu.ops import native as jnative
from torus_fhe_tpu.threshold import shares as jshares
from torus_fhe_tpu_torch.ops import hostmath, native
from torus_fhe_tpu_torch.threshold import shares


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_library_builds_into_the_package():
    assert native.available()
    so = native.so_path()
    assert os.path.exists(so) and os.path.dirname(so) == native.BUILD_DIR
    assert os.path.basename(os.path.dirname(so)) == "_build"
    assert native.build() == so  # built once: the second call finds it


@pytest.mark.parametrize("bits", [32, 64])
def test_negacyclic_polymul_equal_numpy_and_jax(bits):
    rng = np.random.default_rng(bits)
    N = 256
    a = rng.integers(-2, 3, (3, 1, N), dtype=np.int32)  # small operands, broadcast over axis 1
    hi = 2**31 if bits == 32 else 2**63 - 1
    b = rng.integers(-hi, hi, (3, 4, N), dtype=np.int64)
    if bits == 32:
        b = b.astype(np.int32)
    got = native.negacyclic_polymul(a, b, bits)
    assert got.shape == (3, 4, N) and got.dtype == (np.int32 if bits == 32 else np.int64)
    np.testing.assert_array_equal(got, hostmath.negacyclic_polymul_host(a, b, bits))
    assert jnative.available()
    np.testing.assert_array_equal(got, jnative.negacyclic_polymul(a, b, bits))


@pytest.mark.parametrize("t,k", [(2, 1), (3, 2), (5, 1)])
def test_bl_shares_stream_equal_numpy_and_jax(t, k):
    rng = np.random.default_rng(t * 10 + k)
    G, N = 4, 64
    key = rng.integers(0, 2, (k, N), dtype=np.int32)
    blocks = rng.integers(0, 2, (G, t - 1, k, N), dtype=np.int32)
    got = native.bl_shares_stream(key, blocks)
    want = np.empty((G, t, k, N), np.int32)
    want[:, 0] = key + blocks.sum(1, dtype=np.int32)
    for i in range(1, t):
        want[:, i] = blocks[:, t - 1 - i]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jnative.bl_shares_stream(key, blocks))


def test_bl_share_matmul_equal_numpy_and_jax():
    rng = np.random.default_rng(5)
    M = shares.build_distribution_matrix(3, 2, 5)
    rho = rng.integers(0, 2, (M.shape[1], 128), dtype=np.int32)
    got = native.bl_share_matmul(M, rho)
    np.testing.assert_array_equal(got, (M.astype(np.int64) @ rho).astype(np.int32))
    np.testing.assert_array_equal(got, jnative.bl_share_matmul(M, rho))


@pytest.mark.parametrize("t,p", [(2, 3), (3, 5)])
def test_streaming_shares_take_the_library(t, p, monkeypatch):
    """share_secret_streaming at t > 1 goes through the library and gives
    the numpy path's shares on the same draws; the key reconstructs as
    share_1 - share_2 - ... - share_t, as with JAX's shares."""
    key = np.random.default_rng(t).integers(0, 2, (1, 128), dtype=np.int32)
    calls = []
    stream = native.bl_shares_stream
    monkeypatch.setattr(native, "bl_shares_stream",
                        lambda *args: calls.append(1) or stream(*args))
    got = shares.share_secret_streaming(key, t, p, torch.Generator().manual_seed(0))
    assert calls == [1]
    monkeypatch.setattr(native, "available", lambda: False)
    want = shares.share_secret_streaming(key, t, p, torch.Generator().manual_seed(0))
    assert sorted(got.shares) == sorted(want.shares)
    for k, v in want.shares.items():
        np.testing.assert_array_equal(got.shares[k], v)
    jrepo = jshares.share_secret_streaming(key, t, p, jax.random.PRNGKey(0))
    assert sorted(jrepo.shares) == sorted(got.shares)
    for repo in (got, jrepo):
        for g in range(1, shares.ncr(p, t) + 1):
            s = np.stack([np.asarray(repo.shares[(q, g)])
                          for q in shares.find_parties(g, t, p)]).astype(np.int64)
            np.testing.assert_array_equal(s[0] - s[1:].sum(0), key)


def test_build_without_openmp_where_the_compiler_lacks_it(monkeypatch, tmp_path):
    """A g++ that cannot build with -fopenmp (no libgomp) builds the same
    source without it; the library loads and gives the same words."""
    cxx = tmp_path / "g++"
    cxx.write_text('#!/bin/sh\nfor a in "$@"; do [ "$a" = "-fopenmp" ] && '
                   '{ echo "cannot read spec file libgomp.spec" >&2; exit 1; }; done\n'
                   'exec g++ "$@"\n')
    cxx.chmod(0o755)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", str(cxx))
    native._library.cache_clear()
    try:
        assert native.available() and not native.openmp()
        assert native.build() == native.so_path(native.CXX_FLAGS)
        M = shares.build_distribution_matrix(2, 1, 3)
        rho = np.random.default_rng(0).integers(0, 2, (M.shape[1], 64), dtype=np.int32)
        np.testing.assert_array_equal(native.bl_share_matmul(M, rho),
                                      (M.astype(np.int64) @ rho).astype(np.int32))
    finally:
        monkeypatch.undo()
        native._library.cache_clear()
    assert native.available() and native.openmp()


def test_failed_build_falls_back_to_numpy(monkeypatch, tmp_path):
    """Without a working compiler available() is False with a warning that
    says why, and the sharing takes the numpy path."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "false")  # a compiler that always fails
    native._library.cache_clear()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert not native.available()
        assert any("failed" in str(w.message) for w in caught)
        with pytest.raises(RuntimeError, match="not available"):
            native.bl_share_matmul(np.eye(2, dtype=np.int32), np.eye(2, dtype=np.int32))
        key = np.ones((1, 64), np.int32)
        repo = shares.share_secret_streaming(key, 2, 3, torch.Generator().manual_seed(1))
        assert len(repo.shares) == 2 * shares.ncr(3, 2)
    finally:
        monkeypatch.undo()
        native._library.cache_clear()
    assert native.available()

"""The port's additive key splitting (threshold/additive.py), the huge-ring
FFT product (ops/poly.negacyclic_polymul_fft64) and threshold decryption on
rings above N = 4096, against the JAX package.

- Word for word (max |diff| 0): the LWE and ring partials and their combine
  at smudging bound 0 on JAX keys, shares and ciphertexts crossed through
  ``bridge``; ``threshold_decrypt`` at N = 4,320 (the 8-party tail's ring)
  with small Benaloh–Leichter shares.
- Within a stated tolerance: the FFT product against JAX's at N = 8,192 and
  65,536 on uniform 32-bit inputs. Both are f64 FFTs with their own
  rounding; the JAX docstring bounds the error below 2^-20 of the torus, so
  the tolerance is |diff| <= 2^12 wrap-aware. Both are also held against the
  exact product (16-bit halves of one operand through the exact host
  product), which they meet at these sizes.
- By decryption and statistics: the port's own splits (torch RNG), sparse
  smudging and ``max_tolerable_bound``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu import lwe as jlwe
from torus_fhe_tpu import rlwe as jrlwe
from torus_fhe_tpu import threshold as jthr
from torus_fhe_tpu.core.params import LweParams as JLweParams
from torus_fhe_tpu.core.params import RLweParams as JRLweParams
from torus_fhe_tpu.core.torus import encode_message as jencode
from torus_fhe_tpu.ops import poly as jpoly
from torus_fhe_tpu.threshold import shares as jsh
from torus_fhe_tpu_torch import bridge, threshold
from torus_fhe_tpu_torch.core.params import LweParams, RLweParams
from torus_fhe_tpu_torch.core.torus import decode_message, encode_message
from torus_fhe_tpu_torch.lwe import lwe_encrypt, lwe_keygen
from torus_fhe_tpu_torch.ops import hostmath, poly
from torus_fhe_tpu_torch.rlwe import RLweSample, rlwe_encrypt, rlwe_keygen
from torus_fhe_tpu_torch.threshold import additive
from torus_fhe_tpu_torch.threshold import shares as tsh

FFT_TOL = 2**12  # < 2^-20 of the 32-bit torus


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so that the workers of a parallel test run do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _wrap_diff(x, y) -> int:
    d = (np.asarray(x, np.int64) - np.asarray(y, np.int64)) % 2**32
    return int(np.minimum(d, 2**32 - d).max())


def _exact(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Exact negacyclic a (*) b mod 2^32 for uniform 32-bit a: the exact host
    product of each 16-bit half of a."""
    a = a.astype(np.int64)
    lo = ((a + (1 << 15)) & 0xFFFF) - (1 << 15)
    hi = (a - lo) >> 16
    with np.errstate(over="ignore"):
        out = hostmath.negacyclic_polymul_host(lo, b, 32).astype(np.int64) + \
            (hostmath.negacyclic_polymul_host(hi, b, 32).astype(np.int64) << 16)
    return out.astype(np.int32)


@pytest.mark.parametrize("N", [8192, 65536])
def test_fft_product_within_tolerance_of_jax(N):
    rng = np.random.default_rng(N)
    a = rng.integers(-2**31, 2**31, (2, N)).astype(np.int32)
    b = rng.integers(-2**31, 2**31, (2, N)).astype(np.int32)
    got = poly.negacyclic_polymul_fft64(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jpoly.negacyclic_polymul_fft64(a, b))
    assert got.dtype == np.int32 and got.shape == (2, N)
    assert _wrap_diff(got, want) <= FFT_TOL
    exact = np.stack([_exact(a[i], b[i]) for i in range(2)])
    assert _wrap_diff(got, exact) == 0 == _wrap_diff(want, exact)


def test_fft_product_any_n_and_broadcast():
    """A ring that is not a power of two (4,320) and small int shares
    broadcast against one torus poly: exact."""
    rng = np.random.default_rng(1)
    s = rng.integers(-3, 4, (3, 1, 4320)).astype(np.int32)
    a = rng.integers(-2**31, 2**31, (1, 4320)).astype(np.int32)
    got = poly.negacyclic_polymul_fft64(torch.from_numpy(s), torch.from_numpy(a)).numpy()
    want = hostmath.negacyclic_polymul_host(s, np.broadcast_to(a, s.shape), 32)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="32-bit"):
        poly.negacyclic_polymul_fft64(torch.from_numpy(s), torch.from_numpy(a), bits=64)


def test_threshold_decrypt_at_4320_equal_jax():
    """The 8-party tail's ring: JAX's threshold_decrypt runs its host FFT,
    the port its torch FFT; with small shares both are exact."""
    N = 4320
    rp = JRLweParams(polynomial_degree=N, mask_size=1, bits=32)
    rk = jrlwe.rlwe_keygen(jax.random.PRNGKey(0), rp)
    repo = jsh.share_secret_streaming(np.asarray(rk.key), 3, 5, jax.random.PRNGKey(1))
    msg = jthr.encode_bits(0xC0FFEE, N, n_bits=24)
    ct = jrlwe.rlwe_encrypt(jax.random.PRNGKey(2), msg, 1e-4, rk, rp)
    want = jthr.threshold_decrypt(ct, repo, [1, 2, 4], 0.0, jax.random.PRNGKey(3))
    got = threshold.threshold_decrypt(RLweSample(torch.from_numpy(np.array(ct.a))),
                                      tsh.ShareSet(repo.t, repo.p, repo.shares), [1, 2, 4],
                                      0.0, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert threshold.decode_bits(got, n_bits=24) == 0xC0FFEE


@pytest.fixture(scope="module")
def jax_lwe():
    key = jlwe.lwe_keygen(jax.random.PRNGKey(0), JLweParams(500))
    msgs = np.random.default_rng(0).integers(0, 2, (3, 16)) * 2 - 1
    ct = jlwe.lwe_encrypt(jax.random.PRNGKey(1), jencode(jnp.asarray(msgs), 8), 1e-5, key,
                          msgs.shape)
    return key, msgs, ct


@pytest.mark.parametrize("parties", [2, 4, 7])
def test_lwe_partials_and_combine_equal_jax(jax_lwe, parties):
    key, msgs, ct = jax_lwe
    sh = jthr.split_lwe_key(jax.random.PRNGKey(parties), key, parties)
    want = jthr.lwe_partial_decrypt(ct, sh, 0.0, jax.random.PRNGKey(3))
    tsh_ = bridge.additive_shares_from_numpy(np.asarray(sh.shares), device="cpu")
    tct = bridge.lwe_from_numpy(np.asarray(ct.a), np.asarray(ct.b), device="cpu")
    got = threshold.lwe_partial_decrypt(tct, tsh_, 0.0, torch.Generator().manual_seed(3))
    assert got.shape == (parties, 3, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    phase = threshold.combine(tct, got)
    np.testing.assert_array_equal(phase.numpy(), np.asarray(jthr.combine(ct, want)))
    np.testing.assert_array_equal(decode_message(phase, 8).numpy(), msgs)


@pytest.mark.parametrize("N,bits,parties", [(256, 32, 3), (64, 64, 2), (8192, 32, 2)])
def test_rlwe_partials_and_combine_equal_jax(N, bits, parties):
    """Exact products up to N = 4096 and for int64 shares (64-bit torus),
    the FFT product above."""
    rp = JRLweParams(polynomial_degree=N, mask_size=1, bits=bits)
    rk = jrlwe.rlwe_keygen(jax.random.PRNGKey(0), rp)
    mu = jthr.encode_bits(0xB3, N, n_bits=8, dtype=jnp.int32 if bits == 32 else jnp.int64)
    if bits == 64:
        mu = mu << 32
    ct = jrlwe.rlwe_encrypt(jax.random.PRNGKey(1), mu, 1e-7, rk, rp)
    sh = jthr.split_rlwe_key(jax.random.PRNGKey(2), rk, parties)
    want = jthr.rlwe_partial_decrypt(ct, sh, 0.0, jax.random.PRNGKey(3))
    tct = RLweSample(torch.from_numpy(np.array(ct.a)))
    tshares = bridge.additive_shares_from_numpy(np.asarray(sh.shares), device="cpu")
    assert tshares.shares.dtype == (torch.int32 if bits == 32 else torch.int64)
    got = threshold.rlwe_partial_decrypt(tct, tshares, 0.0, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    phase = threshold.combine(tct, got)
    np.testing.assert_array_equal(phase.numpy(), np.asarray(jthr.combine(ct, want)))
    assert threshold.decode_bits(phase, n_bits=8) == 0xB3


def test_splits_reconstruct():
    g = torch.Generator().manual_seed(0)
    key = lwe_keygen(g, LweParams(500))
    sh = threshold.split_lwe_key(g, key, 5)
    assert sh.shares.shape == (5, 500) and sh.shares.dtype == torch.int32
    assert torch.equal(sh.shares.sum(0, dtype=torch.int32), key.key)
    for bits, dtype in ((32, torch.int32), (64, torch.int64)):
        rk = rlwe_keygen(g, RLweParams(64, 2, bits))
        rsh = threshold.split_rlwe_key(g, rk, 3)
        assert rsh.shares.dtype == dtype and rsh.shares.shape == (3, 2, 64)
        assert torch.equal(rsh.shares.sum(0, dtype=dtype), rk.key.to(dtype))
        assert rsh.shares[0].abs().max() > 2**20  # a proper share is uniform, not small


@pytest.mark.parametrize("parties", [2, 4])
def test_lwe_two_two_decrypt_and_frontier(parties):
    """Encrypt, split, combine the partials, decode, across a bound sweep:
    small bounds decrypt, 0.25 does not, and the frontier lies between."""
    g = torch.Generator().manual_seed(parties)
    key = lwe_keygen(g, LweParams(500))
    msgs = torch.tensor([1, -1, 1, 1, -1, -1, 1, -1] * 8)
    ct = lwe_encrypt(g, encode_message(msgs, 8), 1e-5, key, msgs.shape)
    sh = threshold.split_lwe_key(g, key, parties)

    def ok(bound):
        partials = threshold.lwe_partial_decrypt(ct, sh, bound, g)
        return torch.equal(decode_message(threshold.combine(ct, partials), 8), msgs)

    assert ok(1e-5) and not ok(0.25)
    best = threshold.max_tolerable_bound(ok, [1e-5, 1e-4, 1e-3, 0.25])
    assert 1e-5 <= best < 0.25


def test_max_tolerable_bound_is_the_largest_passing():
    seen = []

    def ok(bound):
        seen.append(bound)
        return bound in (0.01, 0.04)

    assert threshold.max_tolerable_bound(ok, [1.0, 0.04, 0.02, 0.01]) == 0.04
    assert seen == [0.01, 0.02, 0.04, 1.0]
    assert threshold.max_tolerable_bound(lambda b: False, [0.1, 0.2]) == 0.0


def test_sparse_smudging():
    """NN.cpp's RandomSmudge: about r of N coefficients a party smudged, and
    the ring 2-of-2 decode survives; an LWE r above the batch is refused."""
    g = torch.Generator().manual_seed(0)
    params = RLweParams(256, 1, 32)
    rk = rlwe_keygen(g, params)
    value, N = 0xB3, 256
    mu = threshold.encode_bits(value, N, n_bits=8)
    ct = rlwe_encrypt(g, mu, 1e-7, rk, params)
    sh = threshold.split_rlwe_key(g, rk, 3)
    exact = threshold.rlwe_partial_decrypt(ct, sh, 0.0, g)
    partials = threshold.rlwe_partial_decrypt(ct, sh, 1e-5, g, sparse_coords=N // 4)
    smudged = (partials != exact).sum(-1).double()
    assert ((smudged - N / 4).abs() < 5 * (N * 0.25 * 0.75) ** 0.5).all(), smudged
    assert threshold.decode_bits(threshold.combine(ct, partials), n_bits=8) == value
    mask = additive._sparse_mask(g, (64, 1000), 100)
    assert mask.dtype == torch.int32 and abs(mask.sum().item() / 64 - 100) < 5 * 30 ** 0.5

    key = lwe_keygen(g, LweParams(100))
    lct = lwe_encrypt(g, encode_message(torch.ones(16, dtype=torch.int64), 8), 1e-5, key, (16,))
    lsh = threshold.split_lwe_key(g, key, 2)
    part = threshold.lwe_partial_decrypt(lct, lsh, 1e-3, g, sparse_coords=4)
    base = threshold.lwe_partial_decrypt(lct, lsh, 0.0, g)
    assert 0 < int((part != base).sum()) < 32
    with pytest.raises(ValueError, match="exceeds the LWE batch axis"):
        threshold.lwe_partial_decrypt(lct, lsh, 1e-3, g, sparse_coords=17)


def test_huge_ring_additive_decrypt():
    """TlweTwoTwo's huge-ring regime: N = 2^20, k = 1, 2-of-2 additive split,
    partials through the FFT product, combine, 16 bits decoded."""
    N = 1 << 20
    g = torch.Generator().manual_seed(0)
    params = RLweParams(N, 1, 32)
    rk = rlwe_keygen(g, params)
    value = 0x5AC3
    ct = rlwe_encrypt(g, threshold.encode_bits(value, N, n_bits=16), 1e-7, rk, params)
    sh = threshold.split_rlwe_key(g, rk, 2)
    partials = threshold.rlwe_partial_decrypt(ct, sh, 1e-4, g)
    assert partials.shape == (2, N) and partials.dtype == torch.int32
    assert threshold.decode_bits(threshold.combine(ct, partials), n_bits=16) == value

"""The port's threshold decryption (torus_fhe_tpu_torch/threshold/), its
party-sharded form (parallel/sharded.threshold_decrypt_sharded) and the
torus and ring helpers it needs, against the JAX package.

Shares and ciphertexts made by JAX cross as numpy arrays; the products and
sums are exact integer arithmetic mod 2^32, so at smudging sd=0 the
tolerance is word-for-word equality. The port's own shares come from torch's
RNG and are checked by reconstruction and by decoding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu import rlwe as jrlwe
from torus_fhe_tpu.core import params as jparams
from torus_fhe_tpu.core import torus as jtorus
from torus_fhe_tpu.parallel import mesh as jmesh
from torus_fhe_tpu.parallel import sharded as jsharded
from torus_fhe_tpu.threshold import decrypt as jtdec
from torus_fhe_tpu.threshold import shares as jtsh
from torus_fhe_tpu_torch import rlwe as trlwe
from torus_fhe_tpu_torch import threshold
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.core import torus as ttorus
from torus_fhe_tpu_torch.parallel import mesh as tmesh
from torus_fhe_tpu_torch.parallel import sharded
from torus_fhe_tpu_torch.threshold import decrypt as tdec
from torus_fhe_tpu_torch.threshold import shares as tsh

CPU = torch.device("cpu")
GROUPS = [(1, 3), (2, 3), (3, 5), (4, 6)]  # (t, p)

_WORLDS = {}


def _jax_world(N):
    """A JAX ring key, its 3-of-5 shares, and a sample of 0xDEADBEEF."""
    if N not in _WORLDS:
        rp = jparams.thfhe_parameters_1024().rlwe if N == 1024 else \
            jparams.test_parameters(n=16, N=N).rlwe
        key = jax.random.PRNGKey(5)
        rk = jrlwe.rlwe_keygen(jax.random.fold_in(key, 0), rp)
        repo = jtsh.share_secret(np.asarray(rk.key), 3, 5, jax.random.fold_in(key, 1))
        msg = jtdec.encode_bits(0xDEADBEEF, N)
        sample = jrlwe.rlwe_encrypt(jax.random.fold_in(key, 2), msg, 1e-3, rk, rp)
        _WORLDS[N] = (rp, repo, sample, trlwe.RLweSample(torch.from_numpy(np.array(sample.a))))
    return _WORLDS[N]


@pytest.mark.parametrize("t,p", GROUPS)
def test_share_combinatorics_equal_jax(t, p):
    assert tsh.ncr(p, t) == jtsh.ncr(p, t) and tsh.ncr(2, 3) == 0
    for g in range(1, tsh.ncr(p, t) + 1):
        parties = tsh.find_parties(g, t, p)
        assert parties == jtsh.find_parties(g, t, p)
        assert tsh.find_group_id(parties, t, p) == g == jtsh.find_group_id(parties, t, p)
    np.testing.assert_array_equal(tsh.and_share_matrix(t, 2), jtsh.and_share_matrix(t, 2))
    # the reference's rank walk finds no party for p = 1; the port keeps that
    assert tsh.find_parties(1, 1, 1) == jtsh.find_parties(1, 1, 1) == []
    np.testing.assert_array_equal(tsh.build_distribution_matrix(t, 2, p),
                                  jtsh.build_distribution_matrix(t, 2, p))


@pytest.mark.parametrize("N", [64, 1024])
def test_partial_and_final_decrypt_equal_jax(N):
    _, repo, sample, tsample = _jax_world(N)
    sh = repo.subset_shares([1, 2, 4])
    want_p = jtdec.partial_decrypt(sample, sh, 0.0, jax.random.PRNGKey(3))
    got_p = tdec.partial_decrypt(tsample, sh, 0.0, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    got = tdec.final_decrypt(tsample, got_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jtdec.final_decrypt(sample, want_p)))
    assert tdec.decode_bits(got) == 0xDEADBEEF == jtdec.decode_bits(jnp.asarray(got.numpy()))
    one = threshold.threshold_decrypt(tsample, tsh.ShareSet(repo.t, repo.p, repo.shares),
                                      [4, 2, 1, 2], 0.0, torch.Generator().manual_seed(0))
    assert torch.equal(one, got)


@pytest.mark.parametrize("slots", [2, 8])
def test_threshold_decrypt_sharded_equals_jax(slots):
    """JAX's shares at N=1024, 3 of 5, sd=0: the port's party-sharded decrypt
    == JAX's (on its 8-device party mesh) == the sequential pair; sd=1e-3
    still decodes."""
    _, repo, sample, tsample = _jax_world(1024)
    sh = repo.subset_shares([1, 2, 4])
    signs = np.array([-1, 1, 1], np.int32)
    jm = jmesh.make_mesh(n_batch=1, n_party=8, devices=jax.devices()[:8])
    want = jsharded.threshold_decrypt_sharded(sample.a, sh, signs, 0.0, jax.random.PRNGKey(3), jm)
    tm = tmesh.make_mesh(n_batch=1, n_party=slots, devices=[CPU] * slots)
    got = sharded.threshold_decrypt_sharded(tsample.a, sh, signs, 0.0,
                                            torch.Generator().manual_seed(3), tm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.device_get(want)))
    seq = tdec.final_decrypt(tsample, tdec.partial_decrypt(tsample, sh, 0.0,
                                                           torch.Generator().manual_seed(3)))
    assert torch.equal(got, seq) and tdec.decode_bits(got) == 0xDEADBEEF
    smudged = sharded.threshold_decrypt_sharded(tsample.a, sh, signs, 1e-3,
                                                torch.Generator().manual_seed(4), tm)
    assert not torch.equal(smudged, got) and tdec.decode_bits(smudged) == 0xDEADBEEF


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_encode_decode_bits_equal_jax(dtype):
    tdt = torch.int32 if dtype == np.int32 else torch.int64
    for value, n_bits in ((0xDEADBEEF, 32), (0xBEEF, 16), (0, 8)):
        got = tdec.encode_bits(value, 64, n_bits=n_bits, dtype=tdt)
        want = jtdec.encode_bits(value, 64, n_bits=n_bits, dtype=jnp.dtype(dtype))
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        if dtype == np.int32:
            noisy = got + torch.from_numpy(
                np.random.default_rng(n_bits).integers(-2**28, 2**28, 64).astype(np.int32))
            assert tdec.decode_bits(noisy, n_bits) == value
            assert jtdec.decode_bits(jnp.asarray(noisy.numpy()), n_bits) == value
    with pytest.raises(ValueError):
        tdec.encode_bits(1, 64, msize=4)


@pytest.mark.parametrize("bits", [32, 64])
def test_mod_switch_from_torus_equals_jax(bits):
    rng = np.random.default_rng(bits)
    dt = np.int32 if bits == 32 else np.int64
    info = np.iinfo(dt)
    x = rng.integers(info.min, info.max, 500, dtype=np.int64).astype(dt)
    x[:5] = [info.min, info.max, -1, 0, 1]
    for msize in (2, 3, 5, 8, 1024):
        got = ttorus.mod_switch_from_torus(torch.from_numpy(x), msize)
        assert got.dtype == torch.int32
        want = jtorus.mod_switch_from_torus(jnp.asarray(x), msize)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_rlwe_encrypt_by_phase():
    rp = tparams.test_parameters(n=8, N=64).rlwe
    g = torch.Generator().manual_seed(9)
    key = trlwe.rlwe_keygen(g, rp)
    mu = torch.from_numpy(np.random.default_rng(1).integers(-2**31, 2**31, (3, 64))
                          .astype(np.int32))
    ct = trlwe.rlwe_encrypt(g, mu, 2**-20, key, rp, (3,))
    assert ct.a.shape == (3, 2, 64) and ct.a.dtype == torch.int32
    err = trlwe.rlwe_phase(ct, key) - mu
    assert 0 < err.abs().max() < 2**16  # noise of stddev 2^12
    # one message broadcast over the batch
    one = trlwe.rlwe_encrypt(g, mu[0], 0.0, key, rp, (2,))
    assert torch.equal(trlwe.rlwe_phase(one, key), mu[0].expand(2, 64))


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("t,p", GROUPS)
def test_port_shares_reconstruct_and_decode(t, p, streaming):
    """Each group's shares reconstruct the key (share_1 − share_2 − ...),
    and every group decrypts through the port's threshold decryption."""
    rp = tparams.test_parameters(n=8, N=64).rlwe
    g = torch.Generator().manual_seed(10 * t + p)
    key = trlwe.rlwe_keygen(g, rp)
    share = tsh.share_secret_streaming if streaming else tsh.share_secret
    repo = share(key.key, t, p, g)
    assert len(repo.shares) == tsh.ncr(p, t) * t
    msg = tdec.encode_bits(0x5A, 64, n_bits=8)
    ct = trlwe.rlwe_encrypt(g, msg, 1e-4, key, rp)
    for gid in range(1, tsh.ncr(p, t) + 1):
        parties = tsh.find_parties(gid, t, p)
        shares = [repo.get(q, gid) for q in parties]
        assert all(s.dtype == np.int32 for s in shares)
        np.testing.assert_array_equal(shares[0] - sum(shares[1:], np.zeros_like(shares[0])),
                                      key.key.numpy())
        plain = tdec.threshold_decrypt(ct, repo, parties, 1e-4, g)
        assert tdec.decode_bits(plain, 8) == 0x5A
    assert set(repo.party_shares(p)) == {gid for gid in range(1, tsh.ncr(p, t) + 1)
                                         if p in tsh.find_parties(gid, t, p)}
    if streaming and tsh.ncr(p, t) > 1:
        part = tsh.share_secret_streaming(key.key, t, p, g, groups=[2])
        assert {gid for _, gid in part.shares} == {2}


def test_subset_shares_and_huge_rings_raise():
    repo = tsh.share_secret(np.zeros((1, 8), np.int32), 3, 5, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="at least 3 unique"):
        repo.subset_shares([1, 1, 2])
    with pytest.raises(ValueError, match="at least 3 unique"):
        repo.subset_shares([0, 2, 6, 9])
    # duplicates and invalid ids are dropped, the first t valid ones used
    np.testing.assert_array_equal(repo.subset_shares([5, 2, 2, 9, 1, 3]),
                                  repo.subset_shares([1, 2, 3]))
    # rings above N = 4096 used to raise; they take the limb FFT product now
    big = trlwe.RLweSample(torch.zeros((2, 8192), dtype=torch.int32))
    big.a[0, 1] = 3
    shares = np.zeros((1, 1, 8192), np.int32)
    shares[0, 0, 2] = -5
    got = tdec.partial_decrypt(big, shares, 0.0, torch.Generator().manual_seed(0))
    want = torch.zeros((1, 8192), dtype=torch.int32)
    want[0, 3] = -15
    assert torch.equal(got, want)

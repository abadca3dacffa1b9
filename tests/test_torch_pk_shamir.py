"""The port's public-key encryption (threshold/pk.py) and Shamir key sharding
(threshold/shamir.py) against the JAX package.

Shamir is numpy in both packages: the same ``np.random.Generator`` seed gives
the same shards, compared word for word. Public-key encryption draws its
subset (Bernoulli(1/2)) and its noise from torch's RNG, which cannot repeat
jax.random, so it is checked by decryption (on the port's keys and on a JAX
public key crossed through ``bridge.public_key_from_numpy``) and by
statistics: on a crafted key whose sample s has mask 2^s at coordinate 0 and
body 0, each ciphertext's mask spells its subset and its body is the fresh
noise alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu import lwe as jlwe
from torus_fhe_tpu import threshold as jthr
from torus_fhe_tpu.core.params import LweParams as JLweParams
from torus_fhe_tpu.threshold import shamir as jshamir
from torus_fhe_tpu_torch import bridge, threshold
from torus_fhe_tpu_torch.core.params import LweParams
from torus_fhe_tpu_torch.core.torus import encode_message
from torus_fhe_tpu_torch.lwe import LweSample, lwe_keygen, lwe_phase
from torus_fhe_tpu_torch.threshold import pk, shamir
from torus_fhe_tpu_torch.threshold import shares as tsh


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so that the workers of a parallel test run do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("t,n,seed,shape", [(3, 5, 0, (630,)), (3, 7, 5, (128,)),
                                            (2, 3, 9, (4, 16)), (5, 9, 1, (64,))])
def test_shamir_shards_equal_jax(t, n, seed, shape):
    key_bits = np.random.default_rng(seed + 100).integers(0, 2, shape)
    got, want = shamir.split_key(key_bits, t, n, seed), jshamir.split_key(key_bits, t, n, seed)
    assert (got.t, got.n) == (want.t, want.n) == (t, n)
    np.testing.assert_array_equal(got.xs, want.xs)
    np.testing.assert_array_equal(got.fs, want.fs)
    assert len(set(got.xs.tolist())) == n and got.fs.max() < shamir.P
    subsets = [list(range(t)), list(range(n - 1, n - 1 - t, -1)), list(range(1, n, 2))[:t] + [0]]
    for use in subsets:
        rec = shamir.reconstruct_key(got, use)
        np.testing.assert_array_equal(rec, jshamir.reconstruct_key(want, use))
        np.testing.assert_array_equal(rec, key_bits)
    np.testing.assert_array_equal(shamir.reconstruct_key(got), key_bits)


def test_shamir_secrets_and_short_subsets():
    """Secrets of the whole field come back from any t shards; t - 1 shards
    are refused."""
    rng = np.random.default_rng(3)
    secret = rng.integers(0, shamir.P, 257)
    sh = shamir.split_secret(secret, 4, 6, np.random.default_rng(4))
    want = jshamir.split_secret(secret, 4, 6, np.random.default_rng(4))
    np.testing.assert_array_equal(sh.fs, want.fs)
    np.testing.assert_array_equal(shamir.reconstruct_secret(sh, [5, 1, 3, 2]), secret)
    with pytest.raises(ValueError, match="need 4 shards"):
        shamir.reconstruct_secret(sh, [0, 1, 2])


@pytest.fixture(scope="module")
def port_pk():
    g = torch.Generator().manual_seed(0)
    key = lwe_keygen(g, LweParams(64))
    return key, pk.public_keygen(g, key, 2**-15), g


def test_public_keygen_encrypts_zero(port_pk):
    key, pub, _ = port_pk
    a, b = pub.samples
    assert a.shape == (pk.N_SAMPLES, 64) and b.shape == (pk.N_SAMPLES,) and a.dtype == torch.int32
    err = lwe_phase(pub.samples, key).double() / 2**32
    assert err.abs().max() < 8 * 2**-15


def test_public_encrypt_decrypts_and_threshold_decrypts(port_pk):
    """The reference's pk flow: public-key encryption, the LWE -> ring-LWE
    embedding and a (2,3)-threshold decryption of the sign of coefficient 0."""
    key, pub, g = port_pk
    msgs = torch.from_numpy(np.random.default_rng(3).integers(0, 2, (4, 8)) == 1)
    ct = threshold.public_encrypt(g, pub, msgs)
    assert ct.a.shape == (4, 8, 64) and ct.b.shape == (4, 8)
    assert torch.equal(lwe_phase(ct, key) > 0, msgs)
    flat = LweSample(ct.a.reshape(-1, 64), ct.b.reshape(-1))
    ring = threshold.tlwe_from_lwe(flat)
    repo = tsh.share_secret_streaming(threshold.tlwe_key_from_lwe_key(key).key, 2, 3, g)
    for i in range(6):
        plain = threshold.threshold_decrypt(type(ring)(ring.a[i]), repo, [1, 3], 1e-4, g)
        assert bool(plain[0] > 0) == bool(msgs.reshape(-1)[i])


def test_public_encrypt_on_a_jax_public_key():
    """A JAX public key crossed over encrypts for the JAX secret key."""
    jkey = jlwe.lwe_keygen(jax.random.PRNGKey(0), JLweParams(100))
    jpub = jthr.public_keygen(jax.random.PRNGKey(1), jkey, 2**-15)
    pub = bridge.public_key_from_numpy(np.asarray(jpub.samples.a), np.asarray(jpub.samples.b),
                                       jpub.alpha, device="cpu")
    msgs = np.random.default_rng(1).integers(0, 2, 64) == 1
    ct = threshold.public_encrypt(torch.Generator().manual_seed(2), pub, torch.from_numpy(msgs))
    phase = jlwe.lwe_phase(jlwe.LweSample(jnp.asarray(ct.a.numpy()), jnp.asarray(ct.b.numpy())),
                           jkey)
    np.testing.assert_array_equal(np.asarray(phase) > 0, msgs)
    # and the JAX package's own encryption of the same bits decrypts alike
    jct = jthr.public_encrypt(jax.random.PRNGKey(2), jpub, jnp.asarray(msgs))
    np.testing.assert_array_equal(np.asarray(jlwe.lwe_phase(jct, jkey)) > 0, msgs)


def test_public_encrypt_subsets_and_noise_statistics():
    """Bernoulli(1/2) subsets: every sample is chosen in about half of 4,096
    encryptions, independently of the others, and the body's noise has
    stddev alpha (tolerances: 5 sigma of the binomial counts, 10% on the
    std of 4,096 draws)."""
    n_s, B, alpha = pk.N_SAMPLES, 4096, 2**-12
    a = torch.zeros((n_s, 8), dtype=torch.int32)
    a[:, 0] = 1 << torch.arange(n_s, dtype=torch.int32)
    pub = pk.PublicKey(LweSample(a, torch.zeros(n_s, dtype=torch.int32)), alpha)
    msgs = torch.from_numpy(np.random.default_rng(0).integers(0, 2, B) == 1)
    ct = threshold.public_encrypt(torch.Generator().manual_seed(7), pub, msgs)
    assert not ct.a[:, 1:].any()
    bits = (ct.a[:, :1].to(torch.int64) >> torch.arange(n_s)) & 1  # (B, n_s) subsets
    counts = bits.sum(0).double()
    assert ((counts - B / 2).abs() < 5 * (B / 4) ** 0.5).all(), counts
    pair = (bits[:, :-1] & bits[:, 1:]).sum(0).double()  # two samples chosen together
    assert ((pair - B / 4).abs() < 5 * (B * 3 / 16) ** 0.5).all(), pair
    mu = torch.where(msgs, encode_message(1, 8), encode_message(-1, 8))
    err = (ct.b - mu).double() / 2**32
    assert abs(err.std().item() / alpha - 1) < 0.1 and abs(err.mean().item()) < 5 * alpha / B**0.5

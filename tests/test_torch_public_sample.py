"""The port's public sampling (boot/public_sample.py) and the RLWE monomial
product it uses (rlwe.mul_by_monomial) against the JAX package.

Keys (``test_parameters(n=16, N=64)``, F-block) and seed ciphertexts come
from the JAX package through ``bridge``; JAX runs its fblock rotate backend
(the exact semantics), the port its plain versions on the CPU. Tolerance
exact: ``fresh_zero``, ``public_sample`` and ``rlwe_extract_sample_at`` are
word-equal (max |diff| 0). The port's own keys (torch RNG) are checked by
decryption, and fresh zeros by their noise: the bootstrap output noise of a
plain gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu import rlwe as jrlwe
from torus_fhe_tpu.boot import api as japi
from torus_fhe_tpu.boot import bootstrap as jboot
from torus_fhe_tpu.boot import public_sample as jps
from torus_fhe_tpu.core.params import test_parameters as make_test_params
from torus_fhe_tpu.core.torus import encode_message as jencode
from torus_fhe_tpu_torch import bridge, rlwe
from torus_fhe_tpu_torch.boot import api, gates, public_sample
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.core.torus import decode_message, encode_message
from torus_fhe_tpu_torch.lwe import lwe_phase

PARAMS = make_test_params(n=16, N=64)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so that the workers of a parallel test run do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def world():
    sk, ck = japi.make_key_pair(jax.random.PRNGKey(11), PARAMS, forms=("fblock",))
    tp = tparams.SchemeParams(**PARAMS.__dict__)
    bk, ks = ck.bootstrap_key, ck.keyswitch_key
    tsk = bridge.secret_key_from_numpy(tp, np.asarray(sk.key.key), device="cpu")
    tck = bridge.cloud_key_from_numpy(tp, np.asarray(bk.samples), np.asarray(ks.mat),
                                      ks.n_in, ks.n_out, device="cpu")
    seed = np.array([[True, False, True, False], [False, False, True, True]])
    x = japi.encrypt(jax.random.PRNGKey(1), sk, jnp.asarray(seed))
    return sk, ck, tsk, tck, x, bridge.lwe_from_numpy(np.asarray(x.a), np.asarray(x.b),
                                                      device="cpu")


def _jax_fblock(fn, *args):
    jboot.set_rotate_backend("fblock")
    try:
        return fn(*args)
    finally:
        jboot.set_rotate_backend("auto")


def _same(t, j):
    np.testing.assert_array_equal(t.a.numpy(), np.asarray(j.a))
    np.testing.assert_array_equal(t.b.numpy(), np.asarray(j.b))


def test_fresh_zero_equal_jax(world):
    sk, ck, tsk, tck, x, tx = world
    z = public_sample.fresh_zero(tck, tx)
    _same(z, _jax_fblock(jps.fresh_zero, ck, x))
    assert not api.decrypt(tsk, z).any() and z.a.any()


@pytest.mark.parametrize("want", [[[True, True, False, True], [False, True, True, False]],
                                  [True, False, False, True], True])
def test_public_sample_equal_jax(world, want):
    """Messages of the seed's shape, broadcast along the batch, and one."""
    sk, ck, tsk, tck, x, tx = world
    got = public_sample.public_sample(tck, tx, torch.tensor(want))
    _same(got, _jax_fblock(jps.public_sample, ck, x, jnp.asarray(want)))
    assert torch.equal(api.decrypt(tsk, got), torch.tensor(want).expand(2, 4))


@pytest.mark.parametrize("shift", [0, 3, -7, 64, 100, -129])
def test_mul_by_monomial_equal_jax(shift):
    a = np.random.default_rng(shift % 97).integers(-2**31, 2**31, (3, 2, 64)).astype(np.int32)
    got = rlwe.mul_by_monomial(rlwe.RLweSample(torch.from_numpy(a)), shift)
    want = jrlwe.mul_by_monomial(jrlwe.RLweSample(jnp.asarray(a)), shift)
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    per_batch = np.array([shift, 1, -shift])
    got = rlwe.mul_by_monomial(rlwe.RLweSample(torch.from_numpy(a)), torch.from_numpy(per_batch))
    want = jrlwe.mul_by_monomial(jrlwe.RLweSample(jnp.asarray(a)), jnp.asarray(per_batch))
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))


def test_rlwe_extract_sample_at_equal_jax():
    rk = jrlwe.rlwe_keygen(jax.random.PRNGKey(2), PARAMS.rlwe)
    N = PARAMS.rlwe.polynomial_degree
    bits = np.array([1, 0, 1, 1, 0, 1, 0, 0])
    mu = jnp.zeros(N, jnp.int32).at[:8].set(jencode(jnp.asarray(bits), 2))
    ct = jrlwe.rlwe_encrypt(jax.random.PRNGKey(3), mu, 1e-7, rk, PARAMS.rlwe)
    tct = rlwe.RLweSample(torch.from_numpy(np.array(ct.a)))
    key = rlwe.extract_lwe_key(rlwe.RLweKey(torch.from_numpy(np.array(rk.key)), 32))
    for pos in (0, 3, 7, N - 1):
        got = public_sample.rlwe_extract_sample_at(tct, pos)
        _same(got, jps.rlwe_extract_sample_at(ct, pos))
        if pos < 8:
            assert int(decode_message(lwe_phase(got, key), 2)) & 1 == bits[pos]


def test_port_keys_public_sample_and_noise():
    """The port's own keys: a fresh zero decrypts False from seeds of either
    bit, public samples decrypt, and the fresh zero's phase error has the
    std of a plain gate's output error (both the bootstrap output noise;
    within 25% at 256 draws each)."""
    params = tparams.test_parameters(n=16, N=64)
    g = torch.Generator().manual_seed(0)
    sk, ck = api.make_key_pair(g, params, device="cpu")
    seed = torch.from_numpy(np.random.default_rng(0).integers(0, 2, 256) == 1)
    x = api.encrypt(g, sk, seed)
    z = public_sample.fresh_zero(ck, x)
    assert not api.decrypt(sk, z).any()
    want = torch.from_numpy(np.random.default_rng(1).integers(0, 2, 256) == 1)
    assert torch.equal(api.decrypt(sk, public_sample.public_sample(ck, x, want)), want)
    eighth = int(encode_message(1, 8))
    z_err = (lwe_phase(z, sk.key) + eighth).double() / 2**32
    y = api.encrypt(g, sk, want)
    out = gates.gate_and(ck, x, y)
    g_err = (lwe_phase(out, sk.key) - torch.where(seed & want, eighth, -eighth)).double() / 2**32
    assert abs(z_err.std().item() / g_err.std().item() - 1) < 0.25

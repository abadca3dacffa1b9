"""The port's encrypted volume matching (apps/volume_matching.py) against the
JAX package.

Parity: JAX makes the 2-party 3gen keys (``test_parameters_3gen(parties=2,
n=16, N=64)``, raw samples kept) and the encrypted orders; they cross to the
port through ``torus_fhe_tpu_torch.bridge``, where the cloud key is rebuilt
in the expanded and in the compact form. The port runs its plain versions on
the CPU. Tolerance exact: every matched word equal to JAX's with either form,
max |diff| 0. The decrypted volumes are held against ``match_oracle``, the
matching arithmetic in plain integers, on the bridged and on the port's own
keys.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu import mk as jmk
from torus_fhe_tpu.apps import volume_matching as jvm
from torus_fhe_tpu.core import params as jparams
from torus_fhe_tpu_torch import bridge, mk
from torus_fhe_tpu_torch.apps import volume_matching as vm
from torus_fhe_tpu_torch.core import params as tparams

WIDTH = 5
BUYS, SELLS = np.array([5, 3, 8]), np.array([4, 6])  # the orders of JAX's test

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are tiny: one intra-op thread, so that the
    workers of a parallel test run do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



@pytest.fixture(scope="module")
def world():
    params = jparams.test_parameters_3gen(parties=2, n=16, N=64)
    sks = [jmk.mk_party_keygen(jax.random.PRNGKey(50 + p), params) for p in range(2)]
    ck = jmk.mk_cloud_keygen(jax.random.PRNGKey(51), sks, params, forms=("fblock",),
                             keep_samples=True)
    keys = [sk.lwe for sk in sks]
    cts = [jmk.mk_int_encrypt(jax.random.PRNGKey(1), keys, jnp.asarray(BUYS), WIDTH, params),
           jmk.mk_int_encrypt(jax.random.PRNGKey(2), keys, jnp.asarray(SELLS), WIDTH, params),
           jmk.mk_encrypt(jax.random.PRNGKey(3), keys, jnp.asarray(False), params),
           jmk.mk_encrypt(jax.random.PRNGKey(4), keys, jnp.asarray(True), params)]
    want = jvm.volume_match(ck, *cts, WIDTH)
    tp = tparams.SchemeParams3Gen(**params.__dict__)
    tsks = bridge.mk_secret_keys_from_numpy(tp, [np.asarray(sk.lwe.key) for sk in sks],
                                            [np.asarray(sk.rlwe.key) for sk in sks], device="cpu")
    tck = bridge.mk_cloud_key_from_numpy(tp, np.asarray(ck.bk_samples), np.asarray(ck.ks_mat), 2,
                                         forms=("fblock", "fbstream"), device="cpu")
    tin = [bridge.mk_lwe_from_numpy(np.asarray(c.a), np.asarray(c.b), device="cpu") for c in cts]
    return [sk.lwe for sk in tsks], tck, tin, want


@pytest.mark.parametrize("form", ["fblock", "fbstream"])
def test_volume_match_equal_to_jax(world, form):
    keys, tck, tin, want = world
    key = dataclasses.replace(tck, **({"bk_fb_sel": None} if form == "fblock" else {"bk_fb": None}))
    got = vm.volume_match(key, *tin, WIDTH)
    for g, w, plain in zip(got, want, vm.match_oracle(BUYS, SELLS, WIDTH)):
        np.testing.assert_array_equal(g.a.numpy(), np.asarray(w.a))
        np.testing.assert_array_equal(g.b.numpy(), np.asarray(w.b))
        np.testing.assert_array_equal(mk.mk_int_decrypt(keys, g, WIDTH) % 32, plain)


def test_match_oracle():
    """total = min(Σbuy, Σsell); each order gets min(order, total − prefix),
    the remainder (possibly negative) past the total."""
    b, s = vm.match_oracle(BUYS, SELLS, WIDTH)
    assert b.tolist() == [5, 3, 2] and s.tolist() == [4, 6]
    b, s = vm.match_oracle([2, 2], [7, 1, 9], 6)  # total 4: sells 4, then -3 and -4 mod 64
    assert b.tolist() == [2, 2] and s.tolist() == [4, 61, 60]


def test_volume_match_on_port_keys():
    """prefix_sums, min_word and volume_match on the port's own keys, compact
    form: four buys against three sells."""
    params = tparams.test_parameters_3gen(parties=2, n=16, N=64)
    g = torch.Generator().manual_seed(29)
    sks = [mk.mk_party_keygen(g, params, device="cpu") for _ in range(2)]
    ck = mk.mk_cloud_keygen(g, sks, params, device="cpu", forms=("fbstream",))
    keys = [sk.lwe for sk in sks]
    buys, sells, width = np.array([7, 1, 4, 9]), np.array([2, 9, 3]), 6
    cb, cs = (mk.mk_int_encrypt(g, keys, v, width, params) for v in (buys, sells))
    zero = mk.mk_encrypt(g, keys, torch.tensor(False), params)
    one = mk.mk_encrypt(g, keys, torch.tensor(True), params)
    prefix, total = vm.prefix_sums(ck, cb, zero, width)
    np.testing.assert_array_equal(mk.mk_int_decrypt(keys, prefix, width), [0, 7, 8, 12])
    assert int(mk.mk_int_decrypt(keys, total, width)) == 21
    assert int(mk.mk_int_decrypt(keys, vm.min_word(ck, total, mk.MKLweSample(
        cs.a[:, 0], cs.b[:, 0]), one, width), width)) == 2
    mb, ms = vm.volume_match(ck, cb, cs, zero, one, width)
    want_b, want_s = vm.match_oracle(buys, sells, width)
    np.testing.assert_array_equal(mk.mk_int_decrypt(keys, mb, width) % 64, want_b)
    np.testing.assert_array_equal(mk.mk_int_decrypt(keys, ms, width) % 64, want_s)

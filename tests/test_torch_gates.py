"""The port's gate bootstrap as a whole (keygen -> encrypt -> gate ->
decrypt), against the JAX package.

Parity: keys and ciphertexts come from the JAX package and cross to the port
through ``torus_fhe_tpu_torch.bridge``; gate outputs and the keyswitch are
exact integer arithmetic mod 2^32, so the words must be equal. The port's own
keys use a different RNG, so they are checked by decryption (truth tables).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu.boot import api as japi
from torus_fhe_tpu.boot import bootstrap as jboot
from torus_fhe_tpu.boot import gates as jgates
from torus_fhe_tpu.boot import keyswitch as jks
from torus_fhe_tpu.core.params import SchemeParams, test_parameters as make_test_params
from torus_fhe_tpu.core.torus import decode_message
from torus_fhe_tpu_torch import bridge
from torus_fhe_tpu_torch.boot import api, gates
from torus_fhe_tpu_torch.boot import bootstrap as tboot
from torus_fhe_tpu_torch.boot import keyswitch as tks
from torus_fhe_tpu_torch.core import params as tparams


def _twin():
    base = make_test_params(n=16, N=64)
    return SchemeParams(**{**base.__dict__, "bs_decomp_length": 2, "bs_log2_base": 8,
                           "rlwe_mask_size": 2, "bk_drop_limbs": 1})


JAX_PARAMS = {"k1_N64": lambda: make_test_params(n=16, N=64), "k2_rounded_N64": _twin}

PLAIN_OPS = {
    "nand": lambda a, b: ~(a & b), "or": lambda a, b: a | b,
    "and": lambda a, b: a & b, "xor": lambda a, b: a ^ b,
    "xnor": lambda a, b: ~(a ^ b), "nor": lambda a, b: ~(a | b),
    "andny": lambda a, b: ~a & b, "andyn": lambda a, b: a & ~b,
    "orny": lambda a, b: ~a | b, "oryn": lambda a, b: a | ~b,
}

_CACHE = {}


def _jax_world(name):
    """JAX keys, three encrypted bit batches, and the port's view of them."""
    if name not in _CACHE:
        params = JAX_PARAMS[name]()
        sk, ck = japi.make_key_pair(jax.random.PRNGKey(21), params, forms=("fblock",))
        bits = [jnp.asarray([False, False, True, True, False, True, True, False]),
                jnp.asarray([False, True, False, True, True, True, False, False]),
                jnp.asarray([True, False, False, True, False, True, False, True])]
        cts = [japi.encrypt(jax.random.PRNGKey(30 + i), sk, b) for i, b in enumerate(bits)]
        tp = tparams.SchemeParams(**params.__dict__)
        bk, ks = ck.bootstrap_key, ck.keyswitch_key
        tsk = bridge.secret_key_from_numpy(tp, np.asarray(sk.key.key), device="cpu")
        tck = bridge.cloud_key_from_numpy(tp, np.asarray(bk.samples), np.asarray(ks.mat),
                                          ks.n_in, ks.n_out, device="cpu")
        tcts = [bridge.lwe_from_numpy(np.asarray(c.a), np.asarray(c.b), device="cpu")
                for c in cts]
        _CACHE[name] = (params, sk, ck, cts, [np.asarray(b) for b in bits], tsk, tck, tcts)
    return _CACHE[name]


def _assert_same(t, j):
    np.testing.assert_array_equal(t.a.numpy(), np.asarray(j.a))
    np.testing.assert_array_equal(t.b.numpy(), np.asarray(j.b))


@pytest.mark.parametrize("name", list(JAX_PARAMS))
def test_gates_word_equal_to_jax(name):
    params, sk, ck, (x, y, z), (xb, yb, zb), tsk, tck, (tx, ty, tz) = _jax_world(name)
    jboot.set_rotate_backend("fblock")
    try:
        want_and = jgates.gate_and(ck, x, y)
        want_xor = jgates.gate_xor(ck, x, y) if name == "k1_N64" else None
        want_mux = jgates.gate_mux(ck, x, y, z) if name == "k1_N64" else None
    finally:
        jboot.set_rotate_backend("auto")
    got = gates.gate_and(tck, tx, ty)
    _assert_same(got, want_and)
    np.testing.assert_array_equal(api.decrypt(tsk, got).numpy(), xb & yb)
    if want_xor is not None:
        _assert_same(gates.gate_xor(tck, tx, ty), want_xor)
        got = gates.gate_mux(tck, tx, ty, tz)
        _assert_same(got, want_mux)
        np.testing.assert_array_equal(api.decrypt(tsk, got).numpy(), np.where(xb, yb, zb))


def test_keyswitch_word_equal_to_jax():
    params, sk, ck, *_, tck, _ = _jax_world("k1_N64")
    rng = np.random.default_rng(9)
    n_in = ck.keyswitch_key.n_in
    a = rng.integers(-2**31, 2**31, (5, n_in), dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, 5, dtype=np.int64).astype(np.int32)
    want = jks.keyswitch(ck.keyswitch_key, params.ks,
                         japi.LweSample(jnp.asarray(a), jnp.asarray(b)))
    got = tks.keyswitch(tck.keyswitch_key, tparams.SchemeParams(**params.__dict__).ks,
                        bridge.lwe_from_numpy(a, b, device="cpu"))
    _assert_same(got, want)
    assert tck.keyswitch_key.mat.shape[1] % 8 == 0  # padded for torch._int_mm


def test_blind_rotate_and_extract_word_equal_to_jax():
    """The explicit-accumulator route of the bootstrap (any test polynomial)."""
    params, sk, ck, (x, y, _), _, tsk, tck, _ = _jax_world("k1_N64")
    N = params.rlwe_polynomial_degree
    t = x + y
    bara, barb = decode_message(t.a, 2 * N), decode_message(t.b, 2 * N)
    v = np.random.default_rng(10).integers(-2**31, 2**31, N, dtype=np.int64).astype(np.int32)
    jboot.set_rotate_backend("fblock")
    try:
        want = jboot.blind_rotate_and_extract(jnp.asarray(v), ck.bootstrap_key, barb, bara, params)
    finally:
        jboot.set_rotate_backend("auto")
    got = tboot.blind_rotate_and_extract(torch.from_numpy(v), tck.bootstrap_key,
                                         torch.tensor(np.asarray(barb, np.int32)),
                                         torch.tensor(np.asarray(bara, np.int32)),
                                         tck.params)
    _assert_same(got, want)


@pytest.fixture(scope="module")
def port_keys():
    params = tparams.test_parameters(n=32, N=64)
    g = torch.Generator().manual_seed(123)
    sk, ck = api.make_key_pair(g, params, device="cpu")
    return sk, ck, g


def test_all_binary_gates_truth_tables(port_keys):
    sk, ck, g = port_keys
    xs = torch.tensor([False, False, True, True])
    ys = torch.tensor([False, True, False, True])
    cx, cy = api.encrypt(g, sk, xs), api.encrypt(g, sk, ys)
    assert torch.equal(api.decrypt(sk, cx), xs)
    for name, gate in gates.BINARY_GATES.items():
        assert torch.equal(api.decrypt(sk, gate(ck, cx, cy)), PLAIN_OPS[name](xs, ys)), name


def test_not_constant_mux_and_chain(port_keys):
    sk, ck, g = port_keys
    xs = torch.tensor([False, False, False, False, True, True, True, True])
    ys = torch.tensor([False, False, True, True, False, False, True, True])
    zs = torch.tensor([False, True, False, True, False, True, False, True])
    cx, cy, cz = (api.encrypt(g, sk, v) for v in (xs, ys, zs))
    assert torch.equal(api.decrypt(sk, gates.gate_not(ck, cx)), ~xs)
    const = gates.gate_constant(ck, torch.tensor([True, False, True]))
    assert torch.equal(api.decrypt(sk, const), torch.tensor([True, False, True]))
    assert torch.equal(api.decrypt(sk, gates.gate_mux(ck, cx, cy, cz)), torch.where(xs, ys, zs))
    # bootstrapped outputs feed further gates: x_{t+1} = NAND(x_t, y)
    c, want = cx, xs
    for _ in range(4):
        c, want = gates.gate_nand(ck, c, cy), ~(want & ys)
        assert torch.equal(api.decrypt(sk, c), want)


def test_keygen_refuses_quantized_mask():
    params = tparams.SchemeParams(**{**tparams.test_parameters().__dict__,
                                     "bk_mask_quantum_bits": 16})
    with pytest.raises(ValueError):
        api.make_key_pair(torch.Generator().manual_seed(0), params, device="cpu")

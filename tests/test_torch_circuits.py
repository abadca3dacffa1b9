"""The port's integer-word circuits (circuits/words.py) and the LWE -> ring-LWE
embedding (threshold/convert.py) against the JAX package.

Parity: keys and ciphertexts come from the JAX package (F-block keys, the
fblock rotate backend) and cross to the port through
``torus_fhe_tpu_torch.bridge``; the port runs its plain versions on the CPU.
Every gate is exact integer arithmetic mod 2^32, so each output word must be
equal: tolerance exact, max |diff| 0. The decrypted outputs are also held
against numpy. The port's own keys (torch RNG) are checked by decryption.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu.boot import api as japi
from torus_fhe_tpu.boot import bootstrap as jboot
from torus_fhe_tpu.circuits import words as jwords
from torus_fhe_tpu.core.params import SchemeParams, test_parameters as make_test_params
from torus_fhe_tpu.lwe import LweSample as JLwe
from torus_fhe_tpu.threshold import convert as jconvert
from torus_fhe_tpu_torch import bridge
from torus_fhe_tpu_torch.boot import api
from torus_fhe_tpu_torch.circuits import words
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.lwe import LweSample
from torus_fhe_tpu_torch.threshold import convert

WIDTH = 4
A, B = np.array([3, 6, 5]), np.array([5, 2, 5])  # < 2^(WIDTH-1): less_than's range
SEL = np.array([True, False, True])
SORT = np.array([[6, 1, 3], [2, 5, 3], [4, 0, 3]])  # word i of three independent sorts
PAY = np.array([[0, 1, 2], [1, 2, 3], [2, 3, 0]])  # 2-bit payload words

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are tiny: one intra-op thread, so that the
    workers of a parallel test run do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _twin():
    base = make_test_params(n=16, N=64)
    return SchemeParams(**{**base.__dict__, "bs_decomp_length": 2, "bs_log2_base": 8,
                           "rlwe_mask_size": 2, "bk_drop_limbs": 1})


JAX_PARAMS = {"k1_N64": lambda: make_test_params(n=16, N=64), "k2_rounded_N64": _twin}


def _sort_oracle(keys, payload):
    """The compare-swap network word for word: swap unless the sign bit of
    a - b is set (ties swap), the payload moving with its key."""
    keys, payload = [list(r) for r in keys], [list(r) for r in payload]
    mask = (1 << WIDTH) - 1
    for col in range(len(keys[0])):
        for i in range(len(keys) - 1):
            for j in range(len(keys) - 1 - i):
                a, b = keys[j][col], keys[j + 1][col]
                if not ((a - b) & mask) >> (WIDTH - 1) & 1:
                    keys[j][col], keys[j + 1][col] = b, a
                    payload[j][col], payload[j + 1][col] = payload[j + 1][col], payload[j][col]
    return np.array(keys), np.array(payload)


SORTED, SORTED_PAY = _sort_oracle(SORT, PAY)

# name -> (run(module, ck, inputs), the plain answers of the outputs, widths)
CIRCUITS = {
    "add": (lambda m, ck, c: m.add(ck, c["a"], c["b"], c["cin"], WIDTH, with_carry=True),
            [A + B], [WIDTH + 1]),
    "subtract": (lambda m, ck, c: m.subtract(ck, c["a"], c["b"], WIDTH),
                 [(A - B) % 16], [WIDTH]),
    "less_than": (lambda m, ck, c: m.less_than(ck, c["a"], c["b"], WIDTH), [A < B], [0]),
    "mux_word": (lambda m, ck, c: m.mux_word(ck, c["sel"], c["a"], c["b"], WIDTH),
                 [np.where(SEL, A, B)], [WIDTH]),
    "compare_swap": (lambda m, ck, c: m.compare_swap(ck, c["a"], c["b"], WIDTH),
                     [np.minimum(A, B), np.maximum(A, B)], [WIDTH, WIDTH]),
    "bubble_sort": (lambda m, ck, c: m.bubble_sort(ck, c["sort"], WIDTH, [c["pay"]]),
                    list(SORTED) + list(SORTED_PAY), [WIDTH] * 3 + [2] * 3),
    "minimum": (lambda m, ck, c: m.minimum(ck, c["a"], c["b"], WIDTH), [np.minimum(A, B)],
                [WIDTH]),
}


def _leaves(out):
    if isinstance(out, (tuple, list)) and not hasattr(out, "_fields"):
        return [x for o in out for x in _leaves(o)]
    return [out]


_WORLDS = {}


def _world(name):
    """JAX keys and inputs, the port's view of them, and JAX's outputs."""
    if name not in _WORLDS:
        params = JAX_PARAMS[name]()
        sk, ck = japi.make_key_pair(jax.random.PRNGKey(21), params, forms=("fblock",))
        tp = tparams.SchemeParams(**params.__dict__)
        bk, ks = ck.bootstrap_key, ck.keyswitch_key
        tsk = bridge.secret_key_from_numpy(tp, np.asarray(sk.key.key), device="cpu")
        tck = bridge.cloud_key_from_numpy(tp, np.asarray(bk.samples), np.asarray(ks.mat),
                                          ks.n_in, ks.n_out, device="cpu")
        enc = lambda seed, v, w: jwords.int_encrypt(jax.random.PRNGKey(seed), sk,
                                                    jnp.asarray(v), w)
        jin = {"a": enc(1, A, WIDTH), "b": enc(2, B, WIDTH),
               "cin": japi.encrypt(jax.random.PRNGKey(3), sk, jnp.zeros(3, bool)),
               "sel": japi.encrypt(jax.random.PRNGKey(4), sk, jnp.asarray(SEL)),
               "sort": [enc(10 + i, v, WIDTH) for i, v in enumerate(SORT)],
               "pay": [enc(20 + i, v, 2) for i, v in enumerate(PAY)]}
        cross = lambda x: (bridge.lwe_from_numpy(np.asarray(x.a), np.asarray(x.b), device="cpu")
                           if isinstance(x, JLwe) else [cross(y) for y in x])
        tin = {k: cross(v) for k, v in jin.items()}
        jboot.set_rotate_backend("fblock")
        try:
            want = {c: _leaves(run(jwords, ck, jin)) for c, (run, _, _) in CIRCUITS.items()}
        finally:
            jboot.set_rotate_backend("auto")
        _WORLDS[name] = (tsk, tck, tin, want)
    return _WORLDS[name]


@pytest.mark.parametrize("circuit", list(CIRCUITS))
@pytest.mark.parametrize("name", list(JAX_PARAMS))
def test_word_circuit_equal_to_jax(name, circuit):
    tsk, tck, tin, want = _world(name)
    run, plain, widths = CIRCUITS[circuit]
    got = _leaves(run(words, tck, tin))
    assert len(got) == len(want[circuit])
    for g, w, p, width in zip(got, want[circuit], plain, widths):
        np.testing.assert_array_equal(g.a.numpy(), np.asarray(w.a))
        np.testing.assert_array_equal(g.b.numpy(), np.asarray(w.b))
        dec = (api.decrypt(tsk, g).numpy() if width == 0
               else words.int_decrypt(tsk, g, width))
        np.testing.assert_array_equal(dec, p)


@pytest.mark.parametrize("n", [16, 630])  # 630: tfhe_128_tpu_fast, not a power of two
def test_tlwe_from_lwe_equal_to_jax(n):
    rng = np.random.default_rng(n)
    a = rng.integers(-2**31, 2**31, (3, n), dtype=np.int64).astype(np.int32)
    a[0, -1] = a[1, 1] = -2**31  # negates to itself in int32, as in JAX
    b = rng.integers(-2**31, 2**31, 3, dtype=np.int64).astype(np.int32)
    got = convert.tlwe_from_lwe(LweSample(torch.from_numpy(a), torch.from_numpy(b)))
    want = jconvert.tlwe_from_lwe(JLwe(jnp.asarray(a), jnp.asarray(b)))
    assert got.a.dtype == torch.int32 and got.a.shape == (3, 2, n)
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))


def test_tlwe_phase_is_lwe_phase():
    """Coefficient 0 of the ring phase under tlwe_key_from_lwe_key is the LWE
    phase, on the port's own keys."""
    from torus_fhe_tpu_torch.lwe import lwe_phase
    from torus_fhe_tpu_torch.rlwe import rlwe_phase

    params = tparams.test_parameters(n=30, N=64)
    g = torch.Generator().manual_seed(8)
    sk = api.make_secret_key(g, params, device="cpu")
    ct = api.encrypt(g, sk, torch.tensor([True, False, True]))
    ring_key = convert.tlwe_key_from_lwe_key(sk.key)
    assert ring_key.key.shape == (1, 30) and ring_key.bits == 32
    phase = rlwe_phase(convert.tlwe_from_lwe(ct), ring_key)
    assert torch.equal(phase[..., 0], lwe_phase(ct, sk.key))


@pytest.fixture(scope="module")
def port_keys():
    g = torch.Generator().manual_seed(31)
    sk, ck = api.make_key_pair(g, tparams.test_parameters(n=16, N=64), device="cpu")
    return sk, ck, g


def test_int_roundtrip_and_add_on_port_keys(port_keys):
    sk, ck, g = port_keys
    vals = np.array([0, 1, 77, 201, 255])
    ct = words.int_encrypt(g, sk, vals, 8)
    assert ct.a.shape == (8, 5, 16)
    np.testing.assert_array_equal(words.int_decrypt(sk, ct, 8), vals)
    a, b = words.int_encrypt(g, sk, A, WIDTH), words.int_encrypt(g, sk, B, WIDTH)
    cin = api.encrypt(g, sk, torch.ones(3, dtype=torch.bool))
    np.testing.assert_array_equal(
        words.int_decrypt(sk, words.add(ck, a, b, cin, WIDTH, with_carry=True), WIDTH + 1),
        A + B + 1)

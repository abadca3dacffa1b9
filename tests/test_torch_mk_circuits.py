"""The port's 3gen multikey integer circuits (mk/gates3gen.py) against the
JAX package.

Parity: JAX makes the keys (``test_parameters_3gen(parties=2, n=16, N=64)``,
the expanded F-block form, raw samples kept) and the ciphertexts; they cross
to the port through ``torus_fhe_tpu_torch.bridge``, where the cloud key is
rebuilt in the expanded (``fblock``) and in the compact (``fbstream``) form:
on the card these are the two kernels K4 routes to. The port runs its plain
versions on the CPU. Tolerance exact: every output word equal to JAX's, with
either form, max |diff| 0. Decrypted outputs are also held against numpy,
mod 2^WIDTH, on the bridged keys and on the port's own keys.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu import mk as jmk
from torus_fhe_tpu.core import params as jparams
from torus_fhe_tpu.mk import gates3gen as jg3
from torus_fhe_tpu.mk.samples import MKLweSample as JMK
from torus_fhe_tpu_torch import bridge, mk
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.mk import gates3gen as g3

WIDTH = 4
M = 1 << WIDTH
A, B = np.array([3, 7, 6, 2]), np.array([5, 7, 3, 15])  # the mk_int_mul cases of JAX's tests
SORT = np.array([[9, 1], [3, 3], [6, 12]])  # word i of two independent sorts
PAY = np.array([[0, 1], [1, 2], [2, 3]])
_rng = np.random.default_rng(5)
IMAGE, KERNEL = _rng.integers(0, 3, (3, 3)), _rng.integers(0, 3, (1, 2, 2))

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are tiny: one intra-op thread, so that the
    workers of a parallel test run do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _signed(x):  # two's complement of WIDTH bits: the compares' view of a word
    x = np.asarray(x) % M
    return np.where(x >= M // 2, x - M, x)


def _sort_oracle(keys, payload):
    keys, payload = keys.copy(), payload.copy()
    for col in range(keys.shape[1]):
        for i in range(len(keys) - 1):
            for j in range(len(keys) - 1 - i):
                if not _signed(keys[j, col] - keys[j + 1, col]) < 0:
                    keys[[j, j + 1], col] = keys[[j + 1, j], col]
                    payload[[j, j + 1], col] = payload[[j + 1, j], col]
    return keys, payload


SORTED, SORTED_PAY = _sort_oracle(SORT, PAY)
CONV = np.array([[[(IMAGE[i:i + 2, j:j + 2] * KERNEL[0]).sum() for j in range(2)]
                  for i in range(2)]])
SA, SB = _signed(A), _signed(B)

# name -> (run(module, ck, inputs), plain answers of the outputs, widths; 0: a bit)
CIRCUITS = {
    "mk_add": (lambda m, ck, c: m.mk_add(ck, c["a"], c["b"], c["zero"], WIDTH, with_carry=True),
               [(A + B) % (2 * M)], [WIDTH + 1]),
    "mk_sub": (lambda m, ck, c: m.mk_sub(ck, c["a"], c["b"], c["one"], WIDTH), [A - B], [WIDTH]),
    "mk_less": (lambda m, ck, c: m.mk_less(ck, c["a"], c["b"], c["one"], WIDTH), [SA < SB], [0]),
    "mk_greater": (lambda m, ck, c: m.mk_greater(ck, c["a"], c["b"], c["one"], WIDTH),
                   [SA > SB], [0]),
    "mk_leq": (lambda m, ck, c: m.mk_leq(ck, c["a"], c["b"], c["one"], WIDTH), [SA <= SB], [0]),
    "mk_geq": (lambda m, ck, c: m.mk_geq(ck, c["a"], c["b"], c["one"], WIDTH), [SA >= SB], [0]),
    "mk_int_mul": (lambda m, ck, c: m.mk_int_mul(ck, c["a"], c["b"], c["zero"], WIDTH),
                   [A * B], [WIDTH]),
    "mk_compare_swap": (lambda m, ck, c: m.mk_compare_swap(ck, c["a"], c["b"], WIDTH),
                        [np.where(SA < SB, A, B), np.where(SA < SB, B, A)], [WIDTH, WIDTH]),
    "mk_bubble_sort": (lambda m, ck, c: m.mk_bubble_sort(ck, c["sort"], WIDTH, [c["pay"]]),
                       list(SORTED) + list(SORTED_PAY), [WIDTH] * 3 + [2] * 3),
    "mk_conv2d": (lambda m, ck, c: m.mk_conv2d(ck, c["image"], c["kernel"], c["zero1"], 1, WIDTH),
                  [CONV], [WIDTH]),
}


def _leaves(out):
    if isinstance(out, (tuple, list)) and not hasattr(out, "_fields"):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _word_last(x):  # (width, ...) -> (..., width) before (parties, n): mk_conv2d's pixels
    return JMK(jnp.moveaxis(x.a, 0, -3), jnp.moveaxis(x.b, 0, -1))


@pytest.fixture(scope="module")
def world():
    params = jparams.test_parameters_3gen(parties=2, n=16, N=64)
    sks = [jmk.mk_party_keygen(jax.random.PRNGKey(40 + p), params) for p in range(2)]
    ck = jmk.mk_cloud_keygen(jax.random.PRNGKey(41), sks, params, forms=("fblock",),
                             keep_samples=True)
    keys = [sk.lwe for sk in sks]
    enc = lambda seed, v, w: jmk.mk_int_encrypt(jax.random.PRNGKey(seed), keys, jnp.asarray(v),
                                                w, params)
    bits = lambda seed, v: jmk.mk_encrypt(jax.random.PRNGKey(seed), keys, jnp.asarray(v), params)
    jin = {"a": enc(1, A, WIDTH), "b": enc(2, B, WIDTH),
           "zero": bits(3, np.zeros(4, bool)), "one": bits(4, np.ones(4, bool)),
           "zero1": bits(5, False),
           "sort": [enc(10 + i, v, WIDTH) for i, v in enumerate(SORT)],
           "pay": [enc(20 + i, v, 2) for i, v in enumerate(PAY)],
           "image": _word_last(enc(30, IMAGE, WIDTH)),
           "kernel": _word_last(enc(31, KERNEL, WIDTH))}
    cross = lambda x: (bridge.mk_lwe_from_numpy(np.asarray(x.a), np.asarray(x.b), device="cpu")
                       if isinstance(x, JMK) else [cross(y) for y in x])
    tin = {k: cross(v) for k, v in jin.items()}
    want = {c: _leaves(run(jg3, ck, jin)) for c, (run, _, _) in CIRCUITS.items()}
    tp = tparams.SchemeParams3Gen(**params.__dict__)
    tsks = bridge.mk_secret_keys_from_numpy(tp, [np.asarray(sk.lwe.key) for sk in sks],
                                            [np.asarray(sk.rlwe.key) for sk in sks], device="cpu")
    tck = bridge.mk_cloud_key_from_numpy(tp, np.asarray(ck.bk_samples), np.asarray(ck.ks_mat), 2,
                                         forms=("fblock", "fbstream"), device="cpu")
    forms = {"fblock": dataclasses.replace(tck, bk_fb_sel=None),
             "fbstream": dataclasses.replace(tck, bk_fb=None)}
    return [sk.lwe for sk in tsks], forms, tin, want


def _decode(keys, x, width):
    if width == 0:
        return mk.mk_decrypt(keys, x).numpy()
    return mk.mk_int_decrypt(keys, x, width) % (1 << width)


@pytest.mark.parametrize("form", ["fblock", "fbstream"])
@pytest.mark.parametrize("circuit", list(CIRCUITS))
def test_mk_circuit_equal_to_jax(world, circuit, form):
    keys, forms, tin, want = world
    run, plain, widths = CIRCUITS[circuit]
    got = _leaves(run(g3, forms[form], tin))
    assert len(got) == len(want[circuit])
    for g, w, p, width in zip(got, want[circuit], plain, widths):
        np.testing.assert_array_equal(g.a.numpy(), np.asarray(w.a))
        np.testing.assert_array_equal(g.b.numpy(), np.asarray(w.b))
        if circuit == "mk_conv2d":  # (C, OH, OW, width, ...): the word axis to the front
            g = mk.MKLweSample(g.a.movedim(3, 0), g.b.movedim(3, 0))
        np.testing.assert_array_equal(_decode(keys, g, width), np.asarray(p) % (1 << width)
                                      if width else p)


def test_mk_circuits_on_port_keys():
    """Decryption on the port's own keys (torch RNG), compact form: a 6-bit
    adder and multiplier at a batch of 5, and the word constants."""
    params = tparams.test_parameters_3gen(parties=2, n=16, N=64)
    g = torch.Generator().manual_seed(23)
    sks = [mk.mk_party_keygen(g, params, device="cpu") for _ in range(2)]
    ck = mk.mk_cloud_keygen(g, sks, params, device="cpu", forms=("fbstream",))
    keys = [sk.lwe for sk in sks]
    a, b = np.array([3, 17, 30, 0, 63]), np.array([9, 22, 2, 41, 63])
    ca, cb = (mk.mk_int_encrypt(g, keys, v, 6, params) for v in (a, b))
    zero = g3.mk_word_constant(ck, ca, False)
    assert zero.b.shape == (5,) and not mk.mk_decrypt(keys, zero).any()
    total = g3.mk_add(ck, ca, cb, zero, 6, with_carry=True)
    np.testing.assert_array_equal(mk.mk_int_decrypt(keys, total, 7) % 128, a + b)
    np.testing.assert_array_equal(mk.mk_int_decrypt(keys, g3.mk_int_mul(ck, ca, cb, zero, 6), 6)
                                  % 64, a * b % 64)
    np.testing.assert_array_equal(mk.mk_int_decrypt(keys, g3.mk_subtract(ck, ca, cb, 6), 6) % 64,
                                  (a - b) % 64)

"""The port's encrypted CNN layers (apps/cnn.py) against the JAX package.

Parity: keys (``test_parameters(n=16, N=64)``, F-block) and the encrypted
image come from the JAX package and cross to the port through
``torus_fhe_tpu_torch.bridge``; JAX runs its fblock rotate backend, the port
its plain versions on the CPU. Tolerance exact: every output word equal, max
|diff| 0. Decrypted outputs are held against the numpy oracles
``conv2d_reference`` / ``conv3d_reference`` mod 2^WIDTH.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu.apps import cnn as jcnn
from torus_fhe_tpu.boot import api as japi
from torus_fhe_tpu.boot import bootstrap as jboot
from torus_fhe_tpu.circuits import words as jwords
from torus_fhe_tpu.core.params import test_parameters as make_test_params
from torus_fhe_tpu_torch import bridge
from torus_fhe_tpu_torch.apps import cnn
from torus_fhe_tpu_torch.boot import api
from torus_fhe_tpu_torch.circuits import words
from torus_fhe_tpu_torch.core import params as tparams

WIDTH = 6
VALS = np.array([3, 10, 20])
_rng = np.random.default_rng(7)
IMAGE = _rng.integers(0, 6, (4, 4))
KERNELS = _rng.integers(-2, 3, (2, 2, 2))  # 2 filters, 2x2, signed taps
VOL = _rng.integers(0, 3, (3, 3, 3))
KERNELS3 = _rng.integers(-1, 3, (1, 2, 2, 2))

# name -> (run(module, ck, inputs), plain answer, input)
CASES = {
    "scale_5": (lambda m, ck, x: m.scale_by_plaintext(ck, x, 5, WIDTH), VALS * 5, "vals"),
    "scale_-3": (lambda m, ck, x: m.scale_by_plaintext(ck, x, -3, WIDTH), VALS * -3, "vals"),
    "scale_0": (lambda m, ck, x: m.scale_by_plaintext(ck, x, 0, WIDTH), VALS * 0, "vals"),
    "conv2d": (lambda m, ck, x: m.conv2d(ck, x, KERNELS, WIDTH),
               jcnn.conv2d_reference(IMAGE, KERNELS), "image"),
    "conv3d": (lambda m, ck, x: m.conv3d(ck, x, KERNELS3, WIDTH),
               jcnn.conv3d_reference(VOL, KERNELS3), "vol"),
}

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
    params = make_test_params(n=16, N=64)
    sk, ck = japi.make_key_pair(jax.random.PRNGKey(99), params, forms=("fblock",))
    tp = tparams.SchemeParams(**params.__dict__)
    bk, ks = ck.bootstrap_key, ck.keyswitch_key
    tsk = bridge.secret_key_from_numpy(tp, np.asarray(sk.key.key), device="cpu")
    tck = bridge.cloud_key_from_numpy(tp, np.asarray(bk.samples), np.asarray(ks.mat),
                                      ks.n_in, ks.n_out, device="cpu")
    jin = {k: jwords.int_encrypt(jax.random.PRNGKey(i), sk, jnp.asarray(v), WIDTH)
           for i, (k, v) in enumerate((("vals", VALS), ("image", IMAGE), ("vol", VOL)))}
    tin = {k: bridge.lwe_from_numpy(np.asarray(v.a), np.asarray(v.b), device="cpu")
           for k, v in jin.items()}
    jboot.set_rotate_backend("fblock")
    try:
        want = {c: run(jcnn, ck, jin[x]) for c, (run, _, x) in CASES.items()}
    finally:
        jboot.set_rotate_backend("auto")
    return tsk, tck, tin, want


@pytest.mark.parametrize("case", list(CASES))
def test_cnn_equal_to_jax(world, case):
    tsk, tck, tin, want = world
    run, plain, x = CASES[case]
    got = run(cnn, tck, tin[x])
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want[case].a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want[case].b))
    np.testing.assert_array_equal(words.int_decrypt(tsk, got, WIDTH), plain % (1 << WIDTH))


def test_oracles_equal_to_jax():
    rng = np.random.default_rng(3)
    img, ker = rng.integers(-9, 9, (7, 6)), rng.integers(-3, 4, (3, 3, 3))
    vol, ker3 = rng.integers(-9, 9, (5, 4, 6)), rng.integers(-3, 4, (2, 3, 3, 3))
    for stride in (1, 2):
        np.testing.assert_array_equal(cnn.conv2d_reference(img, ker, stride),
                                      jcnn.conv2d_reference(img, ker, stride))
        np.testing.assert_array_equal(cnn.conv3d_reference(vol, ker3, stride),
                                      jcnn.conv3d_reference(vol, ker3, stride))


def test_patches_and_strided_conv_on_port_keys():
    """Patch extraction is free indexing; a strided conv on the port's own
    keys decrypts to the oracle."""
    g = torch.Generator().manual_seed(5)
    sk, ck = api.make_key_pair(g, tparams.test_parameters(n=16, N=64), device="cpu")
    image = np.arange(25).reshape(5, 5) % 7
    ct = words.int_encrypt(g, sk, image, WIDTH)
    pats = cnn.extract_patches(ct, 2)
    assert pats.b.shape == (WIDTH, 4, 4, 4)
    got = words.int_decrypt(sk, pats, WIDTH)
    for t, (m, n) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        np.testing.assert_array_equal(got[t], image[m:m + 4, n:n + 4])
    vol = words.int_encrypt(g, sk, np.arange(27).reshape(3, 3, 3) % 5, WIDTH)
    assert cnn.extract_patches_3d(vol, 2).b.shape == (WIDTH, 8, 2, 2, 2)
    ker = np.array([[[1, 0], [0, -1]]])
    out = cnn.conv2d(ck, ct, ker, WIDTH, stride=2)
    np.testing.assert_array_equal(words.int_decrypt(sk, out, WIDTH),
                                  cnn.conv2d_reference(image, ker, 2) % (1 << WIDTH))

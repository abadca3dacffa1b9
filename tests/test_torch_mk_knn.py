"""The port's multikey KNN (apps/mk_knn.py) against the JAX package.

Parity: JAX makes the 2-party 3gen keys (``test_parameters_3gen(parties=2,
n=16, N=64)``, raw samples kept) and the encrypted dataset; they cross to the
port through ``torus_fhe_tpu_torch.bridge``. ``mk_knn_predict`` runs with two
test rows on a batch axis, as ``run_mk_pipeline`` does; the port's plain
versions on the CPU, over the expanded and the compact key. Tolerance exact:
the decision words equal JAX's, max |diff| 0, and decrypt to the circuit's
plaintext oracle. The threshold tail and the pipeline run on the port's own
keys (shares and smudging are random: checked by decryption).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu import mk as jmk
from torus_fhe_tpu.apps import mk_knn as jmk_knn
from torus_fhe_tpu.core import params as jparams
from torus_fhe_tpu.mk.samples import MKLweSample as JMK
from torus_fhe_tpu_torch import bridge, mk
from torus_fhe_tpu_torch.apps import mk_knn
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.lwe import LweKey, lwe_phase
from torus_fhe_tpu_torch.threshold.decrypt import MAX_EXACT_N

WIDTH, K = 4, 3
TR_F, TR_L = np.array([[1, 2], [6, 7], [2, 1]]), np.array([1, 0, 1])
TE_F, TE_L = np.array([[1, 1], [7, 7]]), np.array([1, 0])
PARAMS = tparams.test_parameters_3gen(parties=2, n=16, N=64)

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
    sks = [jmk.mk_party_keygen(jax.random.PRNGKey(100 + p), params) for p in range(2)]
    ck = jmk.mk_cloud_keygen(jax.random.PRNGKey(7), sks, params, forms=("fblock",),
                             keep_samples=True)
    keys = [sk.lwe for sk in sks]
    feats, labs = jmk_knn.mk_encrypt_dataset(jax.random.PRNGKey(2), keys, TR_F, TR_L, WIDTH,
                                             params)
    test = jmk.mk_int_encrypt(jax.random.PRNGKey(50), keys, jnp.asarray(TE_F), WIDTH, params)
    T = len(TE_F)
    batched = lambda x: JMK(  # (w, rows, ...) -> (w, rows, T, ...), as run_mk_pipeline
        jnp.broadcast_to(x.a[:, :, None], x.a.shape[:2] + (T,) + x.a.shape[2:]),
        jnp.broadcast_to(x.b[:, :, None], x.b.shape[:2] + (T,) + x.b.shape[2:]))
    jin = (batched(feats), batched(labs), test)
    want = jmk_knn.mk_knn_predict(ck, *jin, K, WIDTH)
    tp = tparams.SchemeParams3Gen(**params.__dict__)
    tsks = bridge.mk_secret_keys_from_numpy(tp, [np.asarray(sk.lwe.key) for sk in sks],
                                            [np.asarray(sk.rlwe.key) for sk in sks], device="cpu")
    tck = bridge.mk_cloud_key_from_numpy(tp, np.asarray(ck.bk_samples), np.asarray(ck.ks_mat), 2,
                                         forms=("fblock", "fbstream"), device="cpu")
    tin = [bridge.mk_lwe_from_numpy(np.asarray(x.a), np.asarray(x.b), device="cpu") for x in jin]
    return [sk.lwe for sk in tsks], tck, tin, want


@pytest.mark.parametrize("form", ["fblock", "fbstream"])
def test_mk_knn_predict_equal_to_jax(world, form):
    keys, tck, tin, want = world
    key = dataclasses.replace(tck, **({"bk_fb_sel": None} if form == "fblock" else {"bk_fb": None}))
    got = mk_knn.mk_knn_predict(key, *tin, K, WIDTH)
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    assert (mk.mk_decrypt(keys, got).numpy().astype(int).tolist()
            == mk_knn.plaintext_oracle(TR_F, TR_L, TE_F, K, WIDTH))


def test_plaintext_oracle_equal_to_jax():
    rng = np.random.default_rng(6)
    for width, k in ((4, 1), (6, 3), (8, 5)):
        tr_f, te_f = rng.integers(0, 12, (7, 3)), rng.integers(0, 12, (3, 3))
        tr_l = rng.integers(0, 2, 7)
        assert (mk_knn.plaintext_oracle(tr_f, tr_l, te_f, k, width)
                == jmk_knn.plaintext_oracle(tr_f, tr_l, te_f, k, width))


@pytest.fixture(scope="module")
def port_world():
    g = torch.Generator().manual_seed(19)
    sks = [mk.mk_party_keygen(g, PARAMS, device="cpu") for _ in range(2)]
    return [sk.lwe for sk in sks], g


def test_flatten_is_one_lwe_under_the_joint_key(port_world):
    keys, g = port_world
    ct = mk.mk_encrypt(g, keys, torch.tensor([True, False, True]), PARAMS)
    flat = mk_knn.mk_flatten(ct)
    joint = mk_knn.concat_lwe_key(keys)
    assert flat.a.shape == (3, 2 * PARAMS.lwe_size) and joint.key.shape == (2 * PARAMS.lwe_size,)
    assert torch.equal(lwe_phase(flat, joint), mk.mk_lwe_phase(ct, keys))


def test_mk_threshold_tail(port_world):
    """Flattened decision -> ring embedding -> (3,5) threshold decryption
    recovers the bit at every bound of the sweep."""
    keys, g = port_world
    for msg in (True, False):
        ct = mk.mk_encrypt(g, keys, torch.tensor(msg), PARAMS)
        res = mk_knn.mk_threshold_tail(ct, keys, g)
        assert len(res) == 4 and all(r["bit"] == int(msg) for r in res), res


def test_mk_threshold_tail_above_the_exact_ring_raises():
    """At 8 parties of 540 (mk_8party_3gen) the ring has 4,320 coefficients,
    above the exact products' 4,096. The tail used to raise there; it now
    takes the limb FFT product and recovers the bit at every bound."""
    parties, n = 8, 540
    assert parties * n > MAX_EXACT_N
    g = torch.Generator().manual_seed(0)
    keys = [LweKey(torch.randint(0, 2, (n,), generator=g, dtype=torch.int32))
            for _ in range(parties)]
    a = torch.randint(-2**31, 2**31, (parties, n), generator=g).to(torch.int32)
    mask = torch.sum(a.reshape(-1) * mk_knn.concat_lwe_key(keys).key, dtype=torch.int32)
    for msg in (True, False):
        ct = mk.MKLweSample(a, mask + (1 << 29 if msg else -(1 << 29)))
        res = mk_knn.mk_threshold_tail(ct, keys, g)
        assert len(res) == 4 and all(r["bit"] == int(msg) for r in res), res


def test_run_mk_pipeline_matches_oracle(tmp_path):
    """Keygen, multikey encryption of a synthetic CSV, one batched
    prediction for both test rows, decryption, the tail per row."""
    csv = tmp_path / "tiny.csv"
    rows, labs = np.concatenate([TR_F, TE_F]), np.concatenate([TR_L, TE_L])
    csv.write_text("id,c0,c1,label\n" + "".join(
        ",".join(map(str, [i, *r, l])) + "\n" for i, (r, l) in enumerate(zip(rows, labs))))
    seen = []
    res = mk_knn.run_mk_pipeline(torch.Generator().manual_seed(0), PARAMS, 2, str(csv), k=1,
                                 width=5, train_rows=3, test_rows=2,
                                 progress=lambda i, p: seen.append((i, p)), device="cpu")
    assert res["matches_oracle"] and res["predictions"] == res["oracle"] == [1, 0]
    assert res["correct"] == 2 and seen == [(0, 1), (1, 0)]
    for pred, tail in zip(res["predictions"], res["threshold_tail"]):
        assert [r["bit"] for r in tail] == [pred] * len(tail)

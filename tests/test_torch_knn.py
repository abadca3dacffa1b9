"""The port's encrypted KNN (apps/knn.py) against the JAX package.

Parity: keys (``test_parameters(n=16, N=64)``, F-block) and the encrypted
dataset come from the JAX package and cross to the port through
``torus_fhe_tpu_torch.bridge``; JAX runs its fblock rotate backend, the port
its plain versions on the CPU. Tolerance exact: every output word equal, max
|diff| 0. The decision is also held against the circuit's plaintext oracle.
The threshold tail and the CSV pipeline run on the port's own keys (torch
RNG): shares and smudging are random, so they are checked by decryption.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu.apps import knn as jknn
from torus_fhe_tpu.apps import mk_knn as jmk_knn
from torus_fhe_tpu.boot import api as japi
from torus_fhe_tpu.boot import bootstrap as jboot
from torus_fhe_tpu.circuits import words as jwords
from torus_fhe_tpu.core.params import test_parameters as make_test_params
from torus_fhe_tpu_torch import bridge
from torus_fhe_tpu_torch.apps import knn
from torus_fhe_tpu_torch.boot import api
from torus_fhe_tpu_torch.circuits import words
from torus_fhe_tpu_torch.core import params as tparams

WIDTH = 6  # distances stay below 2^(WIDTH-1)
K = 3
FEATS = np.array([[3, 7, 2], [4, 6, 3], [12, 9, 8], [11, 10, 9]])
LABELS = np.array([1, 1, 0, 0])
TEST_ROW = np.array([5, 7, 3])
HEADER = ("id,age_days,age_year,gender,height,weight,ap_hi,ap_lo,"
          "cholesterol,gluc,smoke,alco,active,cardio")
CSV_ROWS = [  # two clusters in (ap_hi, ap_lo); the last two rows are test rows
    [0, 0, 0, 1, 0, 0, 30, 20, 1, 1, 0, 0, 1, 0],
    [1, 0, 0, 2, 0, 0, 28, 22, 1, 1, 0, 0, 1, 0],
    [3, 0, 0, 1, 0, 0, 2, 3, 3, 2, 1, 0, 0, 1],
    [5, 0, 0, 1, 0, 0, 4, 3, 3, 2, 1, 1, 0, 1],
    [6, 0, 0, 1, 0, 0, 29, 21.7, 3, 2, 1, 1, 0, 0],
]

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
    feats, labs = jknn.encrypt_dataset(jax.random.PRNGKey(1), sk, FEATS, LABELS, WIDTH)
    test = jwords.int_encrypt(jax.random.PRNGKey(2), sk, jnp.asarray(TEST_ROW), WIDTH)
    rows = jwords.int_encrypt(jax.random.PRNGKey(3), sk, jnp.asarray(np.tile(TEST_ROW, (4, 1))),
                              WIDTH)
    jin = {"feats": feats, "labs": labs, "test": test, "rows": rows}
    tin = {k: bridge.lwe_from_numpy(np.asarray(v.a), np.asarray(v.b), device="cpu")
           for k, v in jin.items()}
    jboot.set_rotate_backend("fblock")
    try:
        want = {c: run(jknn, ck, jin) for c, run in CASES.items()}
    finally:
        jboot.set_rotate_backend("auto")
    return tsk, tck, tin, want


CASES = {
    "abs_difference": lambda m, ck, c: m.abs_difference(ck, c["feats"], c["rows"], WIDTH),
    "manhattan_distance": lambda m, ck, c: m.manhattan_distance(ck, c["feats"], c["rows"], WIDTH),
    "knn_predict": lambda m, ck, c: m.knn_predict(ck, c["feats"], c["labs"], c["test"], K, WIDTH),
}
PLAIN = {"abs_difference": np.abs(FEATS - TEST_ROW),
         "manhattan_distance": np.abs(FEATS - TEST_ROW).sum(1),
         "knn_predict": np.array(knn.plaintext_oracle(FEATS, LABELS, TEST_ROW[None], K,
                                                      WIDTH)[0])}


@pytest.mark.parametrize("case", list(CASES))
def test_knn_equal_to_jax(world, case):
    tsk, tck, tin, want = world
    got = CASES[case](knn, tck, tin)
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want[case].a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want[case].b))
    dec = (api.decrypt(tsk, got).numpy() if case == "knn_predict"
           else words.int_decrypt(tsk, got, WIDTH))
    np.testing.assert_array_equal(dec, PLAIN[case])


def test_oracle_and_csv_loader_equal_to_jax(tmp_path):
    rng = np.random.default_rng(4)
    for width in (5, 8):
        tr_f, te_f = rng.integers(0, 20, (6, 3)), rng.integers(0, 20, (4, 3))
        tr_l = rng.integers(0, 2, 6)
        for k in (1, 3, 5):
            assert (knn.plaintext_oracle(tr_f, tr_l, te_f, k, width)
                    == jmk_knn.plaintext_oracle(tr_f, tr_l, te_f, k, width))
    csv = tmp_path / "data.csv"
    csv.write_text(HEADER + "\n" + "\n".join(",".join(map(str, r)) for r in CSV_ROWS) + "\n")
    for args in ((3, 2, [6, 7]), (2, 1, None)):
        for got, want in zip(knn.load_cardio_csv(str(csv), *args),
                             jknn.load_cardio_csv(str(csv), *args)):
            np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def port_keys():
    g = torch.Generator().manual_seed(17)
    sk, ck = api.make_key_pair(g, tparams.test_parameters(n=16, N=64), device="cpu")
    return sk, ck, g


def test_threshold_tail_recovers_the_bit(port_keys):
    """The (3,5) tail with subset {1,2,4} across the 0.0125 -> 1e-3 sweep
    gives the decrypted bit at every bound: the smudging is far below the
    1/8 margin."""
    sk, _, g = port_keys
    for msg in (True, False):
        ct = api.encrypt(g, sk, torch.tensor(msg))
        res = knn.threshold_tail(ct, sk, g)
        assert [r["bound"] for r in res] == [0.0125, 0.00625, 0.003125, 0.0015625]
        assert all(r["bit"] == int(msg) for r in res), res
    with pytest.raises(ValueError, match="unique party ids"):
        knn.threshold_tail(ct, sk, g, subset=(1, 2))


def test_run_pipeline_matches_oracle(port_keys, tmp_path):
    """CSV ingest, encryption, one prediction per test row, accuracy tally
    and the threshold tail, on a synthetic cardio-schema file."""
    sk, ck, g = port_keys
    csv = tmp_path / "data.csv"
    csv.write_text(HEADER + "\n" + "\n".join(",".join(map(str, r)) for r in CSV_ROWS) + "\n")
    report = knn.run_pipeline(g, sk, ck, str(csv), k=1, width=7, train_rows=3, test_rows=2,
                              feature_cols=[6, 7], with_threshold_tail=True)
    assert report["predictions"] == report["oracle"] == [1, 0]
    assert report["labels"] == [1, 0] and report["correct"] == 2 and report["accuracy"] == 1.0
    for pred, tail in zip(report["predictions"], report["threshold_tail"]):
        assert [r["bit"] for r in tail] == [pred] * len(tail)

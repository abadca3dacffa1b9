"""The port's mesh and party-sharded ops (torus_fhe_tpu_torch/parallel/)
against the JAX package's (torus_fhe_tpu/parallel/).

JAX runs on the virtual 8-CPU mesh of tests/conftest.py, the port on meshes
of repeated CPU devices. Keys and ciphertexts are JAX's, crossed as numpy
arrays; the keyswitch and the gates are exact integer arithmetic, so the
tolerance is word-for-word equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu.boot import api as japi
from torus_fhe_tpu.boot import gates as jgates
from torus_fhe_tpu.core.params import test_parameters as jtest_params
from torus_fhe_tpu.core.params import test_parameters_3gen as jparams_3gen
from torus_fhe_tpu.lwe import LweSample as JLwe
from torus_fhe_tpu.mk import boot3gen as jboot3
from torus_fhe_tpu.mk import keys3gen as jkeys3
from torus_fhe_tpu.parallel import mesh as jmesh
from torus_fhe_tpu.parallel import sharded as jsharded
from torus_fhe_tpu_torch import bridge
from torus_fhe_tpu_torch.boot import api as tapi
from torus_fhe_tpu_torch.boot import gates as tgates
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.lwe import LweSample as TLwe
from torus_fhe_tpu_torch.mk import boot3gen
from torus_fhe_tpu_torch.parallel import dryrun, sharded
from torus_fhe_tpu_torch.parallel import mesh as tmesh

CPU = torch.device("cpu")


@pytest.mark.parametrize("parties,slots", [(3, 2), (4, 4), (3, 8)])
def test_mk_keyswitch_sharded_equals_jax(parties, slots):
    """3 parties on 2 and 8 slots pad the party axis; 4 on 4 do not."""
    params = jparams_3gen(parties=parties, n=12, N=64)
    keys = [jkeys3.mk_party_keygen(jax.random.fold_in(jax.random.PRNGKey(3), p), params)
            for p in range(parties)]
    ck = jkeys3.mk_cloud_keygen(jax.random.PRNGKey(4), keys, params, keep_samples=True)
    rng = np.random.default_rng(parties + slots)
    a = rng.integers(-2**31, 2**31, (2, 3, 64), dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, (2, 3), dtype=np.int64).astype(np.int32)
    jm = jmesh.make_mesh(n_batch=1, n_party=slots, devices=jax.devices()[:slots])
    u = JLwe(jnp.asarray(a.reshape(6, 64)), jnp.asarray(b.reshape(6)))
    want = jsharded.mk_keyswitch_sharded(ck, jsharded.mk_ks_tables_sharded(ck, jm), u, jm)

    tp = tparams.SchemeParams3Gen(**params.__dict__)
    tck = bridge.mk_cloud_key_from_numpy(tp, np.asarray(ck.bk_samples), np.asarray(ck.ks_mat),
                                         parties, forms=("fbstream",), device="cpu")
    tm = tmesh.make_mesh(n_batch=1, n_party=slots, devices=[CPU] * slots)
    tables = sharded.mk_ks_tables_sharded(tck, tm)
    assert len(tables) == slots and all(t.shape[1] % 8 == 0 for t in tables)
    tu = TLwe(torch.from_numpy(a), torch.from_numpy(b))
    got = sharded.mk_keyswitch_sharded(tck, tables, tu, tm)
    padded = -(-parties // slots) * slots
    assert got.a.shape == (2, 3, padded, params.lwe_size)
    np.testing.assert_array_equal(got.a.reshape(6, padded, -1).numpy(),
                                  np.asarray(jax.device_get(want.a)))
    np.testing.assert_array_equal(got.b.reshape(6).numpy(), np.asarray(jax.device_get(want.b)))
    single = boot3gen.mk_keyswitch(tck, tu)
    assert torch.equal(got.a[..., :parties, :], single.a) and torch.equal(got.b, single.b)
    np.testing.assert_array_equal(
        single.a.reshape(6, parties, -1).numpy(),
        np.asarray(jboot3.mk_keyswitch(ck, u).a))


@pytest.fixture(scope="module")
def single_key_world():
    params = jtest_params(n=12, N=64)
    sk, ck = japi.make_key_pair(jax.random.PRNGKey(0), params)
    rng = np.random.default_rng(0)
    xs, ys = rng.integers(0, 2, 16) == 1, rng.integers(0, 2, 16) == 1
    cx = japi.encrypt(jax.random.PRNGKey(1), sk, jnp.asarray(xs))
    cy = japi.encrypt(jax.random.PRNGKey(2), sk, jnp.asarray(ys))
    want = jgates.gate_and(ck, cx, cy)
    tp = tparams.SchemeParams(**params.__dict__)
    tsk = bridge.secret_key_from_numpy(tp, np.asarray(sk.key.key), device="cpu")
    tck = bridge.cloud_key_from_numpy(tp, np.asarray(ck.bootstrap_key.samples),
                                      np.asarray(ck.keyswitch_key.mat),
                                      ck.keyswitch_key.n_in, ck.keyswitch_key.n_out,
                                      device="cpu")
    tcx, tcy = (bridge.lwe_from_numpy(np.asarray(c.a), np.asarray(c.b), device="cpu")
                for c in (cx, cy))
    return xs, ys, want, tsk, tck, tcx, tcy


@pytest.mark.parametrize("slots", [1, 2, 8])
def test_batch_sharded_gate_equals_single_and_jax(single_key_world, slots):
    xs, ys, want, tsk, tck, tcx, tcy = single_key_world
    m = tmesh.make_mesh(n_batch=slots, devices=[CPU] * slots)
    keys = tmesh.replicate_cloud_key(tck, m)
    assert list(keys) == [CPU]  # one copy per distinct device
    assert keys[CPU].bootstrap_key.fb.data_ptr() == tck.bootstrap_key.fb.data_ptr()
    got = tmesh.run_batch_sharded(tgates.gate_and, keys, tmesh.shard_lwe_batch(tcx, m),
                                  tmesh.shard_lwe_batch(tcy, m), mesh=m)
    single = tgates.gate_and(tck, tcx, tcy)
    assert torch.equal(got.a, single.a) and torch.equal(got.b, single.b)
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    assert np.array_equal(tapi.decrypt(tsk, got).numpy(), xs & ys)


def test_mesh_construction_and_errors(monkeypatch):
    m = tmesh.make_mesh(n_batch=2, n_party=3, devices=["cpu"] * 7)
    assert m.shape == {tmesh.BATCH_AXIS: 2, tmesh.PARTY_AXIS: 3}
    assert m.batch_devices() == [CPU] * 2 and m.party_devices() == [CPU] * 3
    assert m.distinct_devices() == [CPU]
    assert tmesh.make_mesh(n_party=2, devices=[CPU] * 5).shape[tmesh.BATCH_AXIS] == 2
    with pytest.raises(ValueError, match="devices"):
        tmesh.make_mesh(n_batch=3, n_party=3, devices=[CPU] * 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    x = TLwe(torch.zeros((5, 4), dtype=torch.int32), torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="does not split"):
        tmesh.shard_lwe_batch(x, tmesh.make_mesh(n_batch=2, devices=[CPU] * 2))
    assert [tmesh.pad_to_multiple(v, 4) for v in (1, 4, 5)] == [4, 4, 8]
    arr, total = sharded.pad_parties(torch.ones((3, 2)), 3, 2)
    assert total == 4 and arr.shape == (4, 2) and arr[3].abs().sum() == 0
    arr, total = sharded.pad_parties(torch.ones((2, 3)), 3, 3, axis=1)
    assert total == 3 and arr.shape == (2, 3)


def test_dryrun_multichip_on_eight_cpu_slots():
    dryrun.dryrun_multichip([CPU] * 8)

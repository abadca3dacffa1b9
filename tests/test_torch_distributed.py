"""The port's mesh across processes (torus_fhe_tpu_torch/parallel/ after
``mesh.init_distributed``) against the JAX package's shard_map paths and the
port's one-process mesh.

The ranks are gloo processes on the CPU, spawned by a module fixture for each
world size (tests/_torch_dist_workers.py): 2 ranks and 4 ranks, each running
several checks, with their results crossed back as numpy arrays. JAX runs in
this process on its virtual 8-CPU mesh (tests/conftest.py); the keys are
JAX's, made at ``test_parameters_3gen(n=6, N=64)``, ``test_parameters_3gen(n=12,
N=64)`` and ``test_parameters(n=12, N=64)``. Everything is exact integer
arithmetic, so the tolerance is word-for-word equality. Every spawn meets
through a file store under its own ``tmp_path``, collectives time out after
30 s and a spawn is killed after 90 s.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from _torch_dist_workers import JOIN_S, collect, spawn, start, stop
from _torch_pipeline_helpers import B, MU32, MU64, rotate_inputs, world

from torus_fhe_tpu import mk as jmk
from torus_fhe_tpu import rlwe as jrlwe
from torus_fhe_tpu.boot import api as japi
from torus_fhe_tpu.boot import gates as jgates
from torus_fhe_tpu.core import params as jparams
from torus_fhe_tpu.core.torus import encode_message as jencode
from torus_fhe_tpu.lwe import LweSample as JLwe
from torus_fhe_tpu.mk import keys3gen as jkeys3
from torus_fhe_tpu.parallel import mesh as jmesh
from torus_fhe_tpu.parallel import mk_pipeline as jpipe
from torus_fhe_tpu.parallel import sharded as jsharded
from torus_fhe_tpu.threshold import decrypt as jtdec
from torus_fhe_tpu.threshold import shares as jtsh
from torus_fhe_tpu_torch import bridge, mk, parallel
from torus_fhe_tpu_torch.parallel import mesh as tmesh
from torus_fhe_tpu_torch.parallel import mk_pipeline as tpipe
from torus_fhe_tpu_torch.parallel import sharded
from torus_fhe_tpu_torch.rlwe import RLweSample
from torus_fhe_tpu_torch.threshold import decrypt as tdec

CPU = torch.device("cpu")
FORMS = ("expanded", "compact")
MICROBATCHES = (1, 2, 4)
CASES = [(f, m) for f in FORMS for m in MICROBATCHES]
# (ranks, parties): one party a rank, and 4 parties on 2 ranks (hand-offs on a
# rank and between ranks)
PIPELINES = [(2, 2), (2, 4), (4, 4)]
XS = np.array([False, False, True, True] * 2)
YS = np.array([False, True, False, True] * 2)
SMUDGE = 1e-3


def _pipeline_world(parties):
    """The ranks' task, and the references: JAX's pipelined rotate and NAND
    bootstrap on its mesh, the port's rotate on its one-process mesh."""
    params, sks, ck, jm, jkeys, tp, tck, tm, tkeys = world(parties)
    bara, barb = rotate_inputs(parties, 40 + parties)
    bara3 = bara.reshape(B, parties, -1)
    lwe_keys = [sk.lwe for sk in sks]
    cx = jmk.mk_encrypt(jax.random.PRNGKey(220), lwe_keys, jnp.asarray(XS), params)
    cy = jmk.mk_encrypt(jax.random.PRNGKey(221), lwe_keys, jnp.asarray(YS), params)
    t = jmk.mk_lwe_noiseless_trivial(jencode(1, 8), params.lwe, parties, XS.shape) - cx - cy
    task = dict(params=dict(tp.__dict__), samples=np.asarray(ck.bk_samples),
                ks_mat=np.asarray(ck.ks_mat), parties=parties, bara=bara3, barb=barb,
                mu32=MU32, mu64=MU64, cases=CASES, t_a=np.asarray(t.a), t_b=np.asarray(t.b))

    def ref():
        want = np.asarray(jpipe.mk_blind_rotate_pipelined(
            jkeys["compact"], jnp.asarray(bara3), jnp.asarray(barb), MU32, params, parties, jm,
            microbatches=4))
        boot = jpipe.mk_bootstrap_pipelined(ck, jkeys["compact"], jencode(1, 8, jnp.int64), t,
                                            jm, microbatches=4)
        one = {f"rotate_{form}_{m}": tpipe.mk_blind_rotate_pipelined(
            tkeys[form], torch.from_numpy(bara3), torch.from_numpy(barb), MU32, tp, parties, tm,
            microbatches=m).numpy() for form, m in CASES}
        tsks = bridge.mk_secret_keys_from_numpy(tp, [np.asarray(k.key) for k in lwe_keys],
                                                [np.asarray(sk.rlwe.key) for sk in sks],
                                                device="cpu")
        return {"want": want, "boot": (np.asarray(boot.a), np.asarray(boot.b)), "one": one,
                "tsks": tsks}

    return task, ref


def _keyswitch_world(parties, slots):
    """The ranks' task, and JAX's party-sharded keyswitch of a batch at
    3gen(parties, n=12, N=64) on ``slots`` party slots."""
    params = jparams.test_parameters_3gen(parties=parties, n=12, N=64)
    keys = [jkeys3.mk_party_keygen(jax.random.fold_in(jax.random.PRNGKey(13), p), params)
            for p in range(parties)]
    ck = jkeys3.mk_cloud_keygen(jax.random.PRNGKey(14), keys, params, keep_samples=True)
    rng = np.random.default_rng(parties + slots)
    a = rng.integers(-2**31, 2**31, (6, 64), dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, 6, dtype=np.int64).astype(np.int32)
    task = dict(params=dict(params.__dict__), samples=np.asarray(ck.bk_samples),
                ks_mat=np.asarray(ck.ks_mat), parties=parties, slots=slots, a=a, b=b)

    def ref():
        jm = jmesh.make_mesh(n_batch=1, n_party=slots, devices=jax.devices()[:slots])
        u = JLwe(jnp.asarray(a), jnp.asarray(b))
        want = jsharded.mk_keyswitch_sharded(ck, jsharded.mk_ks_tables_sharded(ck, jm), u, jm)
        return np.asarray(want.a), np.asarray(want.b)

    return task, ref


def _threshold_world():
    """The ranks' task (JAX's 3-of-5 shares of a ring key at N=1024 and a
    sample of 0xDEADBEEF), and JAX's party-sharded decryption at sd=0."""
    rp = jparams.thfhe_parameters_1024().rlwe
    key = jax.random.PRNGKey(6)
    rk = jrlwe.rlwe_keygen(jax.random.fold_in(key, 0), rp)
    repo = jtsh.share_secret(np.asarray(rk.key), 3, 5, jax.random.fold_in(key, 1))
    sample = jrlwe.rlwe_encrypt(jax.random.fold_in(key, 2), jtdec.encode_bits(0xDEADBEEF, 1024),
                                1e-3, rk, rp)
    task = dict(sample_a=np.asarray(sample.a), shares=np.asarray(repo.subset_shares([1, 2, 4])),
                signs=np.array([-1, 1, 1], np.int32))

    def ref():
        jm = jmesh.make_mesh(n_batch=1, n_party=8, devices=jax.devices()[:8])
        return np.asarray(jsharded.threshold_decrypt_sharded(
            sample.a, task["shares"], task["signs"], 0.0, jax.random.PRNGKey(3), jm))

    return task, ref


def _gate_world():
    """The ranks' task, and JAX's gate_and of 16 gates at
    test_parameters(n=12, N=64)."""
    params = jparams.test_parameters(n=12, N=64)
    sk, ck = japi.make_key_pair(jax.random.PRNGKey(0), params)
    rng = np.random.default_rng(1)
    xs, ys = rng.integers(0, 2, 16) == 1, rng.integers(0, 2, 16) == 1
    cx = japi.encrypt(jax.random.PRNGKey(1), sk, jnp.asarray(xs))
    cy = japi.encrypt(jax.random.PRNGKey(2), sk, jnp.asarray(ys))
    task = dict(params=dict(params.__dict__), samples=np.asarray(ck.bootstrap_key.samples),
                ks_mat=np.asarray(ck.keyswitch_key.mat), n_in=ck.keyswitch_key.n_in,
                n_out=ck.keyswitch_key.n_out, x_a=np.asarray(cx.a), x_b=np.asarray(cx.b),
                y_a=np.asarray(cy.a), y_b=np.asarray(cy.b))

    def ref():
        want = jgates.gate_and(ck, cx, cy)
        assert np.array_equal(np.asarray(japi.decrypt(sk, want)), xs & ys)
        return np.asarray(want.a), np.asarray(want.b)

    return task, ref


def _near_wrap_parts(ranks, dtype):
    """Each rank's words near the wrap of ``dtype``: sums of 2..4 of them
    overflow both ways."""
    top = np.iinfo(dtype).max
    edge = np.array([top, top - 1, -top - 1, -top, top // 2 + 1, 1, -1, 0], dtype)
    return np.stack([np.roll(edge, r) for r in range(ranks)])


@pytest.fixture(scope="module")
def worlds():
    """{kind: {case: (the ranks' task, its reference thunk)}}."""
    return {"pipe": {parties: _pipeline_world(parties) for parties in (2, 4)},
            "ks": {(3, 2): _keyswitch_world(3, 2), (4, 4): _keyswitch_world(4, 4)},
            "thr": {0: _threshold_world()}, "gate": {0: _gate_world()},
            "sum": {np.dtype(d).name: ({"parts": _near_wrap_parts(4, d)}, None)
                    for d in (np.int32, np.int64)}}


def _tasks(worlds, ranks):
    tasks = [(f"pipe{parties}", "pipeline", worlds["pipe"][parties][0])
             for r, parties in PIPELINES if r == ranks]
    tasks += [(f"ks{p}", "keyswitch", task) for (p, slots), (task, _) in worlds["ks"].items()
              if slots == ranks]
    tasks += [(f"thr{sd}", "threshold", dict(worlds["thr"][0][0], sd=sd, slots=ranks))
              for sd in (0.0, SMUDGE)]
    tasks.append(("gate", "batch_gate", dict(worlds["gate"][0][0], slots=ranks)))
    if ranks == 4:
        tasks += [(f"sum_{name}", "party_sum", task) for name, (task, _) in worlds["sum"].items()]
    else:
        tasks.append(("dryrun", "dryrun", {"slots": 2}))
    return tasks


@pytest.fixture(scope="module")
def started(worlds, tmp_path_factory):
    """A spawn of 2 gloo ranks and one of 4, running while the references
    are computed here."""
    handles = {n: start(tmp_path_factory.mktemp(f"ranks{n}"), n, _tasks(worlds, n))
               for n in (2, 4)}
    yield handles
    for handle in handles.values():
        stop(handle)


@pytest.fixture(scope="module")
def refs(worlds, started):
    """The references, computed once in this process."""
    return {kind: {case: ref() for case, (_, ref) in cases.items() if ref is not None}
            for kind, cases in worlds.items()}


@pytest.fixture(scope="module")
def ranks(started, refs):
    """{world size: each rank's results}."""
    return {n: collect(handle) for n, handle in started.items()}


def test_init_distributed_without_environment_is_a_no_op(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.init_distributed() is False
    assert tmesh.init_distributed(num_processes=1) is False
    assert not dist.is_initialized() and tmesh.process_rank() == 0
    m = tmesh.make_mesh(n_batch=1, n_party=2, devices=[CPU] * 2)
    assert not m.spans_processes and m.party_ranks() == [0, 0] and m.home() == CPU


def test_init_distributed_refuses_a_missing_rank_or_size(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="rank of this process is unknown"):
        tmesh.init_distributed("localhost:1", 2, backend="gloo")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="rank of this process is unknown"):
        tmesh.init_distributed(backend="gloo")
    monkeypatch.delenv("MASTER_ADDR")
    with pytest.raises(ValueError, match="give both"):
        tmesh.init_distributed(num_processes=3, process_id=0)
    assert not dist.is_initialized()


@pytest.mark.parametrize("form, microbatches", CASES)
@pytest.mark.parametrize("n_ranks, parties", PIPELINES)
def test_pipelined_rotate_across_ranks(refs, ranks, n_ranks, parties, form, microbatches):
    """Every rank returns JAX's words and the one-process mesh's."""
    ref = refs["pipe"][parties]
    key = f"rotate_{form}_{microbatches}"
    for got in ranks[n_ranks]:
        np.testing.assert_array_equal(got[f"pipe{parties}/{key}"], ref["want"])
        np.testing.assert_array_equal(got[f"pipe{parties}/{key}"], ref["one"][key])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("n_ranks, parties", PIPELINES)
def test_pipelined_bootstrap_across_ranks(refs, ranks, n_ranks, parties, form):
    """JAX's NAND words on every rank, and the NAND truth table; each rank
    holds the key shards of its own parties and no other."""
    ref = refs["pipe"][parties]
    per = parties // n_ranks
    for r, got in enumerate(ranks[n_ranks]):
        a, b = got[f"pipe{parties}/boot_{form}_a"], got[f"pipe{parties}/boot_{form}_b"]
        np.testing.assert_array_equal(a, ref["boot"][0])
        np.testing.assert_array_equal(b, ref["boot"][1])
        out = bridge.mk_lwe_from_numpy(a, b, device="cpu")
        assert np.array_equal(mk.mk_decrypt([s.lwe for s in ref["tsks"]], out).numpy(),
                              ~(XS & YS))
        held = got[f"pipe{parties}/held"][FORMS.index(form)]
        assert held.tolist() == [p // per == r for p in range(parties)]


@pytest.mark.parametrize("parties, n_ranks", [(3, 2), (4, 4)])
def test_mk_keyswitch_across_ranks(refs, ranks, parties, n_ranks):
    """3 parties on 2 ranks pad the party axis to 4; 4 on 4 do not."""
    want_a, want_b = refs["ks"][(parties, n_ranks)]
    for r, got in enumerate(ranks[n_ranks]):
        assert got[f"ks{parties}/held"].tolist() == [s == r for s in range(n_ranks)]
        np.testing.assert_array_equal(got[f"ks{parties}/a"], want_a)
        np.testing.assert_array_equal(got[f"ks{parties}/b"], want_b)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_threshold_decrypt_across_ranks(worlds, refs, ranks, n_ranks):
    """sd=0: JAX's words and the sequential pair's on every rank. Smudged:
    the ranks' generators differ, yet every rank gets the words of the
    one-process mesh with rank 0's generator (its seeds are broadcast)."""
    want, thr = refs["thr"][0], worlds["thr"][0][0]
    sample = RLweSample(torch.tensor(thr["sample_a"]))
    seq = tdec.final_decrypt(sample, tdec.partial_decrypt(sample, thr["shares"], 0.0,
                                                          torch.Generator().manual_seed(3)))
    m = tmesh.make_mesh(n_batch=1, n_party=n_ranks, devices=[CPU] * n_ranks)
    smudged = sharded.threshold_decrypt_sharded(sample.a, thr["shares"], thr["signs"], SMUDGE,
                                                torch.Generator().manual_seed(1000), m)
    for got in ranks[n_ranks]:
        np.testing.assert_array_equal(got["thr0.0/out"], want)
        np.testing.assert_array_equal(got["thr0.0/out"], seq.numpy())
        np.testing.assert_array_equal(got[f"thr{SMUDGE}/out"], smudged.numpy())
    assert tdec.decode_bits(smudged) == 0xDEADBEEF and not np.array_equal(smudged.numpy(), want)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_batch_sharded_gate_across_ranks(refs, ranks, n_ranks):
    """Each rank holds the chunks of its own slots and returns the whole
    batch, JAX's words."""
    want_a, want_b = refs["gate"][0]
    for r, got in enumerate(ranks[n_ranks]):
        assert got["gate/chunks"].tolist() == [s == r for s in range(n_ranks)]
        np.testing.assert_array_equal(got["gate/a"], want_a)
        np.testing.assert_array_equal(got["gate/b"], want_b)


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_party_sum_wraps_like_one_process(worlds, ranks, dtype):
    """Four ranks' words near the wrap: the sum wraps as the one-process
    torch sum does, on every rank."""
    parts = worlds["sum"][dtype][0]["parts"]
    want = torch.sum(torch.from_numpy(parts), dim=0, dtype=getattr(torch, dtype)).numpy()
    assert (want != parts.astype(np.float64).sum(0)).any()  # some sums did wrap
    for got in ranks[4]:
        assert got[f"sum_{dtype}/sum"].dtype == parts.dtype
        np.testing.assert_array_equal(got[f"sum_{dtype}/sum"], want)


def test_dryrun_across_ranks(ranks):
    """dryrun_multichip on 2 ranks of 2 CPU slots: the batch-sharded gate
    over 4 slots, the threshold decryption over 4 and the 4-party pipelined
    NAND with a hand-off within each rank and one between them."""
    assert all(got["dryrun/done"] for got in ranks[2])


def test_a_failing_rank_fails_the_spawn(tmp_path):
    """A rank that raises fails the spawn, and the rank waiting for it in a
    collective does not hang: the spawn raises the error of the rank that
    ended first, its own or the one its peer's exit left the other with."""
    start = time.monotonic()
    with pytest.raises(mp.ProcessRaisedException,
                       match="fails on purpose|Connection reset|Connection closed"):
        spawn(tmp_path, 2, [("fail", "fail_on_rank", {"rank": 1})])
    assert time.monotonic() - start < JOIN_S
    assert not os.path.exists(tmp_path / "rank0.npz")

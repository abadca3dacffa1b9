"""The port's party-pipelined multikey blind rotate
(torus_fhe_tpu_torch/parallel/mk_pipeline.py) against the JAX package.

JAX runs its pipeline on the virtual 8-CPU mesh of tests/conftest.py (its
Pallas route only runs on a TPU, so its CPU route is the XLA rotate, as in
tests/test_mk_pipeline.py); the port runs on a mesh of repeated CPU devices,
through the plain versions. The key material is JAX's (``bk_samples``),
crossed as numpy arrays, and the inputs come from numpy. Every result is
exact integer arithmetic, so the tolerance is word-for-word equality.

The tests on the port's own keys need no JAX, so that the ``cuda``-marked
one runs on a GPU machine, which has no JAX:
``python -m pytest tests/test_torch_pipeline.py -m cuda --noconftest``.
"""

import dataclasses

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from torus_fhe_tpu import mk as jmk
    from torus_fhe_tpu.core.params import test_parameters_3gen as jparams_3gen
    from torus_fhe_tpu.core.torus import encode_message as jencode
    from torus_fhe_tpu.parallel import mesh as jmesh
    from torus_fhe_tpu.parallel import mk_pipeline as jpipe
except ImportError:  # a GPU machine without JAX: the reference tests skip there
    jax = None

from torus_fhe_tpu_torch import bridge, mk
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.mk import boot3gen, gates3gen
from torus_fhe_tpu_torch.ops import cuda_rotate
from torus_fhe_tpu_torch.parallel import mesh as tmesh
from torus_fhe_tpu_torch.parallel import mk_pipeline as tpipe
from torus_fhe_tpu_torch.rlwe import RLweSample, rlwe_extract_sample

MU64 = 1 << 61  # encode_message(1, 8) on the 64-bit torus
MU32 = MU64 >> 32
N_LWE, N_RING, B = 6, 64, 8
CPU = torch.device("cpu")

_WORLDS = {}


@pytest.fixture
def needs_jax():
    if jax is None:
        pytest.skip("needs the JAX package, the reference")


def _world(parties):
    """JAX keys with their raw samples, JAX's party-sharded keys of both
    forms on its mesh, and the port's cloud key and sharded keys made from
    the same samples on a mesh of repeated CPU devices."""
    if parties not in _WORLDS:
        params = jparams_3gen(parties=parties, n=N_LWE, N=N_RING)
        sks = [jmk.mk_party_keygen(jax.random.PRNGKey(200 + p), params) for p in range(parties)]
        ck = jmk.mk_cloud_keygen(jax.random.PRNGKey(201), sks, params, forms=("fblock",),
                                 keep_samples=True)
        jm = jmesh.make_mesh(n_batch=1, n_party=parties, devices=jax.devices()[:parties])
        jkeys = {"expanded": jpipe.build_sharded_mk_fb(ck.bk_samples, params, parties, jm),
                 "compact": jpipe.build_sharded_mk_sel(ck.bk_samples, params, parties, jm)}
        tp = tparams.SchemeParams3Gen(**params.__dict__)
        samples = np.asarray(ck.bk_samples)
        tck = bridge.mk_cloud_key_from_numpy(tp, samples, np.asarray(ck.ks_mat), parties,
                                             forms=("fblock", "fbstream"), device="cpu")
        tm = tmesh.make_mesh(n_batch=1, n_party=parties, devices=[CPU] * parties)
        tkeys = {"expanded": tpipe.build_sharded_mk_fb(samples, tp, parties, tm),
                 "compact": tpipe.build_sharded_mk_sel(samples, tp, parties, tm)}
        _WORLDS[parties] = (params, sks, ck, jm, jkeys, tp, tck, tm, tkeys)
    return _WORLDS[parties]


def _rotate_inputs(parties, seed):
    rng = np.random.default_rng(seed)
    bara = rng.integers(0, 2 * N_RING, (B, parties * N_LWE), dtype=np.int64).astype(np.int32)
    barb = rng.integers(0, 2 * N_RING, B, dtype=np.int64).astype(np.int32)
    return bara, barb


@pytest.mark.parametrize("form", ["expanded", "compact"])
@pytest.mark.parametrize("microbatches", [1, 2, 4, 8])
@pytest.mark.parametrize("parties", [2, 4])
def test_pipelined_rotate_equals_jax_and_single_device(needs_jax, parties, microbatches, form):
    """M=1 has no overlap; M=8 gives one gate per microbatch."""
    params, _, _, jm, jkeys, tp, tck, tm, tkeys = _world(parties)
    bara, barb = _rotate_inputs(parties, 10 * parties + microbatches)
    want = jpipe.mk_blind_rotate_pipelined(
        jkeys[form], jnp.asarray(bara.reshape(B, parties, -1)), jnp.asarray(barb), MU32,
        params, parties, jm, microbatches=microbatches)
    got = tpipe.mk_blind_rotate_pipelined(
        tkeys[form], torch.from_numpy(bara.reshape(B, parties, -1)), torch.from_numpy(barb),
        MU32, tp, parties, tm, microbatches=microbatches)
    assert got.shape == (B, 2, N_RING) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.device_get(want)))
    # the single chain over all parties*n steps, in the same key form
    key1 = dataclasses.replace(tck, **({"bk_fb_sel": None} if form == "expanded"
                                       else {"bk_fb": None}))
    single = boot3gen._fast_rotate_extract(key1, MU64, torch.from_numpy(bara),
                                           torch.from_numpy(barb), B)
    u = rlwe_extract_sample(RLweSample(got))
    assert torch.equal(u.a, single.a) and torch.equal(u.b, single.b)


@pytest.mark.parametrize("parties", [2, 4])
def test_pipelined_bootstrap_equals_jax(needs_jax, parties):
    """mk_bootstrap_pipelined on JAX's keys and ciphertexts: JAX's words,
    and the NAND truth table under JAX's secret keys."""
    params, sks, ck, jm, jkeys, tp, tck, tm, tkeys = _world(parties)
    lwe_keys = [sk.lwe for sk in sks]
    xs = np.array([False, False, True, True] * 2)
    ys = np.array([False, True, False, True] * 2)
    cx = jmk.mk_encrypt(jax.random.PRNGKey(210), lwe_keys, jnp.asarray(xs), params)
    cy = jmk.mk_encrypt(jax.random.PRNGKey(211), lwe_keys, jnp.asarray(ys), params)
    t = jmk.mk_lwe_noiseless_trivial(jencode(1, 8), params.lwe, parties, xs.shape) - cx - cy
    want = jpipe.mk_bootstrap_pipelined(ck, jkeys["compact"], jencode(1, 8, jnp.int64), t, jm,
                                        microbatches=4)
    tt = bridge.mk_lwe_from_numpy(np.asarray(t.a), np.asarray(t.b), device="cpu")
    tsks = bridge.mk_secret_keys_from_numpy(tp, [np.asarray(k.key) for k in lwe_keys],
                                            [np.asarray(sk.rlwe.key) for sk in sks],
                                            device="cpu")
    for form, mu in (("compact", MU64), ("expanded", torch.tensor(MU64))):
        got = tpipe.mk_bootstrap_pipelined(tck, tkeys[form], mu, tt, tm, microbatches=4)
        np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
        np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
        assert np.array_equal(mk.mk_decrypt([s.lwe for s in tsks], got).numpy(), ~(xs & ys))


def test_port_keys_pipelined_nand_truth_table():
    """The port's own 4-party keys: the pipelined NAND equals the
    single-device mk_gate_nand word for word and decrypts to NAND, on a
    (2, 4) batch."""
    parties = 4
    tp = tparams.test_parameters_3gen(parties=parties, n=N_LWE, N=N_RING)
    g = torch.Generator().manual_seed(31)
    sks = [mk.mk_party_keygen(g, tp, device="cpu") for _ in range(parties)]
    ck = mk.mk_cloud_keygen(g, sks, tp, device="cpu", forms=("fbstream",), keep_samples=True)
    tm = tmesh.make_mesh(n_batch=1, n_party=parties, devices=[CPU] * parties)
    sel = tpipe.build_sharded_mk_sel(ck.bk_samples, tp, parties, tm)
    keys = [sk.lwe for sk in sks]
    xs = torch.tensor([False, False, True, True] * 2).reshape(2, 4)
    ys = torch.tensor([False, True, False, True] * 2).reshape(2, 4)
    cx, cy = mk.mk_encrypt(g, keys, xs, tp), mk.mk_encrypt(g, keys, ys, tp)
    got = tpipe.mk_bootstrap_pipelined(ck, sel, gates3gen.MU,
                                       gates3gen.mk_gate_nand_wb(ck, cx, cy), tm, microbatches=2)
    want = gates3gen.mk_gate_nand(ck, cx, cy)
    assert got.a.shape == (2, 4, parties, N_LWE)
    assert torch.equal(got.a, want.a) and torch.equal(got.b, want.b)
    assert torch.equal(mk.mk_decrypt(keys, got), ~(xs & ys))


def test_pipeline_rejects_bad_shapes_and_meshes():
    tp = tparams.test_parameters_3gen(parties=4, n=N_LWE, N=N_RING)
    tm = tmesh.make_mesh(n_batch=1, n_party=4, devices=[CPU] * 4)
    sel = tpipe.build_sharded_mk_sel(np.zeros((24, 2, 2, 2, N_RING), np.int64), tp, 4, tm)
    assert [tuple(s.shape) for s in sel] == [(N_LWE, 4, 2 * N_RING, 8)] * 4
    bara, barb = _rotate_inputs(4, 0)
    bara_t, barb_t = torch.from_numpy(bara.reshape(B, 4, -1)), torch.from_numpy(barb)
    with pytest.raises(ValueError, match="microbatches"):
        tpipe.mk_blind_rotate_pipelined(sel, bara_t, barb_t, MU32, tp, 4, tm, microbatches=3)
    three = tmesh.make_mesh(n_batch=1, n_party=3, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="party slots"):
        tpipe.mk_blind_rotate_pipelined(sel, bara_t, barb_t, MU32, tp, 4, three)
    with pytest.raises(ValueError, match="party slots"):
        tpipe.build_sharded_mk_sel(np.zeros((24, 2, 2, 2, N_RING), np.int64), tp, 4, three)
    with pytest.raises(ValueError, match="shards"):
        tpipe.mk_blind_rotate_pipelined(sel[:3], bara_t, barb_t, MU32, tp, 4, tm)
    with pytest.raises(ValueError, match="bara"):
        tpipe.mk_blind_rotate_pipelined(sel, bara_t[:, :3], barb_t, MU32, tp, 4, tm)
    with pytest.raises(ValueError, match="samples"):
        tpipe.build_sharded_mk_sel(np.zeros((20, 2, 2, 2, N_RING), np.int64), tp, 4, tm)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["expanded", "compact"])
def test_pipelined_kernels_equal_single_call(form):
    """On one card, parties as streams of cuda:0: the pipelined rotate ==
    the single-call kernel over all steps, P*M launches of the form's
    kernel and none of the other."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the blind-rotate kernels are CUDA only")
    parties, M = 4, 4
    dev = torch.device("cuda", 0)
    tp = tparams.test_parameters_3gen(parties=parties, n=N_LWE, N=N_RING)
    g = torch.Generator().manual_seed(5)
    sks = [mk.mk_party_keygen(g, tp, device=dev) for _ in range(parties)]
    ck = mk.mk_cloud_keygen(g, sks, tp, device=dev, forms=("fblock", "fbstream"),
                            keep_samples=True)
    tm = tmesh.make_mesh(n_batch=1, n_party=parties, devices=[dev] * parties)
    build = tpipe.build_sharded_mk_fb if form == "expanded" else tpipe.build_sharded_mk_sel
    shards = build(ck.bk_samples, tp, parties, tm)
    bara, barb = _rotate_inputs(parties, 7)
    bara_t, barb_t = torch.from_numpy(bara).to(dev), torch.from_numpy(barb).to(dev)
    before = (cuda_rotate.blind_rotate_cuda.launches, cuda_rotate.blind_rotate_sel_cuda.launches)
    got = tpipe.mk_blind_rotate_pipelined(shards, bara_t.reshape(B, parties, -1), barb_t, MU32,
                                          tp, parties, tm, microbatches=M)
    torch.cuda.synchronize()
    counts = (cuda_rotate.blind_rotate_cuda.launches - before[0],
              cuda_rotate.blind_rotate_sel_cuda.launches - before[1])
    assert counts == ((parties * M, 0) if form == "expanded" else (0, parties * M))
    key1 = dataclasses.replace(ck, **({"bk_fb_sel": None} if form == "expanded"
                                      else {"bk_fb": None}))
    single = boot3gen._fast_rotate_extract(key1, MU64, bara_t, barb_t, B)
    u = rlwe_extract_sample(RLweSample(got))
    assert torch.equal(u.a, single.a) and torch.equal(u.b, single.b)

"""The port's party-pipelined multikey blind rotate
(torus_fhe_tpu_torch/parallel/mk_pipeline.py) against the JAX package, over
the EXPANDED key; the compact-key cases are in
tests/test_torch_pipeline_compact.py, and both share
tests/_torch_pipeline_helpers.py.

JAX runs its pipeline on the virtual 8-CPU mesh of tests/conftest.py (its
Pallas route only runs on a TPU, so its CPU route is the XLA rotate, as in
tests/test_mk_pipeline.py); the port runs on a mesh of repeated CPU devices,
through the plain versions. The key material is JAX's (``bk_samples``),
crossed as numpy arrays, and the inputs come from numpy. Every result is
exact integer arithmetic, so the tolerance is word-for-word equality.

The tests on the port's own keys need no JAX, so that the ``cuda``-marked
one runs on a GPU machine, which has no JAX:
``python -m pytest tests/test_torch_pipeline.py tests/test_torch_pipeline_compact.py -m cuda
--noconftest``.
"""

import numpy as np
import pytest
import torch
from _torch_pipeline_helpers import (B, CPU, MU32, MU64, N_LWE, N_RING, check_pipelined_kernels,
                                     check_pipelined_rotate, jax, rotate_inputs, skip_without_jax,
                                     world)

from torus_fhe_tpu_torch import bridge, mk
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.mk import gates3gen
from torus_fhe_tpu_torch.parallel import mesh as tmesh
from torus_fhe_tpu_torch.parallel import mk_pipeline as tpipe

if jax is not None:
    import jax.numpy as jnp

    from torus_fhe_tpu import mk as jmk
    from torus_fhe_tpu.core.torus import encode_message as jencode
    from torus_fhe_tpu.parallel import mk_pipeline as jpipe


@pytest.fixture
def needs_jax():
    skip_without_jax()


@pytest.mark.parametrize("form", ["expanded"])
@pytest.mark.parametrize("microbatches", [1, 2, 4, 8])
@pytest.mark.parametrize("parties", [2, 4])
def test_pipelined_rotate_equals_jax_and_single_device(needs_jax, parties, microbatches, form):
    check_pipelined_rotate(parties, microbatches, form)


@pytest.mark.parametrize("parties", [2, 4])
def test_pipelined_bootstrap_equals_jax(needs_jax, parties):
    """mk_bootstrap_pipelined on JAX's keys and ciphertexts: JAX's words,
    and the NAND truth table under JAX's secret keys."""
    params, sks, ck, jm, jkeys, tp, tck, tm, tkeys = world(parties)
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
    bara, barb = rotate_inputs(4, 0)
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
@pytest.mark.parametrize("form", ["expanded"])
def test_pipelined_kernels_equal_single_call(form):
    check_pipelined_kernels(form)

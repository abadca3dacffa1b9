"""Shared by tests/test_torch_pipeline.py (expanded key) and
tests/test_torch_pipeline_compact.py (compact key): the JAX and the port's
party-sharded keys of one set of JAX samples, rotate inputs, and the check of
the pipelined rotate against JAX's pipeline and the single-device chain.
pytest does not collect this module. It imports JAX only if it is there, so
that the ``cuda``-marked tests run on a GPU machine, which has no JAX.
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
    from torus_fhe_tpu.parallel import mesh as jmesh
    from torus_fhe_tpu.parallel import mk_pipeline as jpipe
except ImportError:  # a GPU machine without JAX: the reference tests skip there
    jax = None

from torus_fhe_tpu_torch import bridge, mk
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.mk import boot3gen
from torus_fhe_tpu_torch.ops import cuda_rotate
from torus_fhe_tpu_torch.parallel import mesh as tmesh
from torus_fhe_tpu_torch.parallel import mk_pipeline as tpipe
from torus_fhe_tpu_torch.rlwe import RLweSample, rlwe_extract_sample

MU64 = 1 << 61  # encode_message(1, 8) on the 64-bit torus
MU32 = MU64 >> 32
N_LWE, N_RING, B = 6, 64, 8
CPU = torch.device("cpu")

_WORLDS = {}


def skip_without_jax():
    if jax is None:
        pytest.skip("needs the JAX package, the reference")


def world(parties):
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


def rotate_inputs(parties, seed):
    rng = np.random.default_rng(seed)
    bara = rng.integers(0, 2 * N_RING, (B, parties * N_LWE), dtype=np.int64).astype(np.int32)
    barb = rng.integers(0, 2 * N_RING, B, dtype=np.int64).astype(np.int32)
    return bara, barb


def check_pipelined_rotate(parties, microbatches, form):
    """The port's pipelined rotate == JAX's == the single chain over all
    parties*n steps in the same key form. M=1 has no overlap; M=8 gives one
    gate per microbatch."""
    params, _, _, jm, jkeys, tp, tck, tm, tkeys = world(parties)
    bara, barb = rotate_inputs(parties, 10 * parties + microbatches)
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


def check_pipelined_kernels(form):
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
    bara, barb = rotate_inputs(parties, 7)
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

"""The port's 1st-gen (CCS) multikey scheme against the JAX package.

Parity: JAX makes the keys (its fb form) and ciphertexts on the CPU (x64,
as tests/test_mk_ccs.py does) and they cross to the port through
``torus_fhe_tpu_torch.bridge``. The F-block products, the extract and the
keyswitch are exact integer arithmetic mod 2^32, so the words must be
equal: every tolerance below is 0. The port's own keys use torch's RNG, so
they are checked by decryption (truth tables) and by the phase bound of the
JAX test: |phase - ideal| < 1/16.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu.core import params as jparams
from torus_fhe_tpu.core.torus import encode_message as j_encode
from torus_fhe_tpu.mk import ccs as jccs
from torus_fhe_tpu.mk.samples import mk_encrypt as j_mk_encrypt
from torus_fhe_tpu.ops import fblock as jfblock
from torus_fhe_tpu_torch import bridge, mk
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.mk import ccs
from torus_fhe_tpu_torch.ops import fblock

MU = 1 << 29
XS = np.array([False, False, True, True, False, True])
YS = np.array([False, True, False, True, True, True])
_WORLDS = {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so that the workers of a parallel test run do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def port_params(params):
    return getattr(tparams, type(params).__name__)(**dataclasses.asdict(params))


def fields_of(ck) -> dict:
    """The JAX key's arrays by field name, as numpy (None fields left out)."""
    return {f.name: np.asarray(getattr(ck, f.name)) for f in dataclasses.fields(ck)
            if f.name not in ("parties", "params") and getattr(ck, f.name) is not None}


def jax_world(parties, params=None, forms=("fb",)):
    """JAX keys, two encrypted bit batches, and the port's view of them."""
    key = (parties, params, forms)
    if key not in _WORLDS:
        params = params or jparams.test_parameters_ccs(parties=parties, n=16, N=64)
        sks = [jccs.ccs_party_keygen(jax.random.PRNGKey(70 + p), params) for p in range(parties)]
        ck = jccs.ccs_cloud_keygen(jax.random.PRNGKey(9), sks, params, forms=forms)
        lwe_keys = [sk.lwe for sk in sks]
        cx = j_mk_encrypt(jax.random.PRNGKey(3), lwe_keys, jnp.asarray(XS), params)
        cy = j_mk_encrypt(jax.random.PRNGKey(4), lwe_keys, jnp.asarray(YS), params)
        tp = port_params(params)
        tck = bridge.ccs_cloud_key_from_numpy(tp, parties, device="cpu", **fields_of(ck))
        tcx, tcy = (bridge.mk_lwe_from_numpy(np.asarray(c.a), np.asarray(c.b), device="cpu")
                    for c in (cx, cy))
        _WORLDS[key] = (params, sks, ck, cx, cy, tp, tck, tcx, tcy)
    return _WORLDS[key]


def assert_same(t, j):
    np.testing.assert_array_equal(t.a.numpy(), np.asarray(j.a))
    np.testing.assert_array_equal(t.b.numpy(), np.asarray(j.b))


@pytest.mark.parametrize("name", ["mk_2party_ccs", "mk_4party_ccs", "mk_8party_ccs",
                                  "mk_16party_ccs"])
def test_registry_names_equal_jax(name):
    want = jparams.PARAMETER_REGISTRY[name]()
    got = tparams.PARAMETER_REGISTRY[name]()
    assert type(got).__name__ == type(want).__name__ == "SchemeParamsCCS"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert got.tgsw.gadget_values == want.tgsw.gadget_values
    assert got.tgsw.offset == want.tgsw.offset


@pytest.mark.parametrize("parties", [2, 3])
def test_bootstrap_equal_jax(parties):
    params, _, ck, cx, _, tp, tck, tcx, _ = jax_world(parties)
    want = jccs.mk_bootstrap(ck, j_encode(1, 8), cx)
    got = ccs.mk_bootstrap(tck, MU, tcx)
    assert got.a.shape == (len(XS), parties, params.lwe_size) and got.a.dtype == torch.int32
    assert_same(got, want)


@pytest.mark.parametrize("parties", [2, 3])
def test_gate_nand_equal_jax(parties):
    _, sks, ck, cx, cy, _, tck, tcx, tcy = jax_world(parties)
    want = jccs.mk_gate_nand(ck, cx, cy)
    got = ccs.mk_gate_nand(tck, tcx, tcy)
    assert_same(got, want)
    tkeys = bridge.mk_secret_keys_from_numpy(tck.params, [np.asarray(s.lwe.key) for s in sks],
                                             [np.asarray(s.rlwe.key) for s in sks], device="cpu")
    np.testing.assert_array_equal(mk.mk_decrypt([k.lwe for k in tkeys], got).numpy(),
                                  ~(XS & YS))


@pytest.mark.parametrize("lb", [8, 9])
def test_c1_apply_fblock_equal_jax(lb):
    """The C = 1 geometry (one output poly, l digit rows, 4 limb columns) of
    ``ccs_fb_geometry``: the port's expansion and contraction against
    JAX's, on random torus lines and inputs, at byte and wide digits."""
    params = dataclasses.replace(jparams.test_parameters_ccs(2, n=4, N=64), bs_log2_base=lb)
    geom = jccs.ccs_fb_geometry(params, 2)
    tgeom = ccs.ccs_fb_geometry(port_params(params), 2)
    assert tuple(tgeom) == tuple(geom) and tgeom.C == 1 and len(tgeom.cols) == 4
    rng = np.random.default_rng(lb)
    polys = rng.integers(-2**31, 2**31, (3, 3, 64), dtype=np.int64).astype(np.int32)
    sel = jfblock.build_sel(polys.reshape(3, 3, 1, 1, 64), geom)
    np.testing.assert_array_equal(ccs._lines(polys, tgeom), sel)
    t = rng.integers(-2**31, 2**31, (5, 1, 64), dtype=np.int64).astype(np.int32)
    gp = port_params(params).tgsw
    fb = jfblock.expand_fblock_chunk(jnp.asarray(sel), geom)
    tfb = fblock.expand_fblock_chunk(torch.from_numpy(sel), tgeom)
    np.testing.assert_array_equal(tfb.numpy(), np.asarray(fb))
    for s in range(3):
        want = jfblock.apply_fblock(jnp.asarray(t), fb[s], geom, gp.decomp_length, lb, gp.offset)
        got = fblock.apply_fblock(torch.from_numpy(t), tfb[s], tgeom, gp.decomp_length, lb,
                                  gp.offset)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("parties", [2, 3])
def test_uni_product_equal_jax(parties):
    """One step's hybrid product (the f0|f1 lines side by side in one
    contraction) against JAX's conv-form ``uni_product`` on the same key."""
    params, _, ck, _, _, tp, _, _, _ = jax_world(parties, forms=("conv", "fb"))
    tck = bridge.ccs_cloud_key_from_numpy(tp, parties, device="cpu", **fields_of(ck))
    geom = ccs.ccs_fb_geometry(tp, parties)
    rng = np.random.default_rng(parties)
    x = rng.integers(-2**31, 2**31, (4, parties + 1, 64), dtype=np.int64).astype(np.int32)
    n = params.lwe_size
    for s in (0, n + 1, parties * n - 1):
        onehot = np.eye(parties, dtype=np.int32)[s // n]
        want = jccs.uni_product(jnp.asarray(x), ck.d_kern[s], ck.f0_kern[s], ck.f1_kern[s],
                                ck.pk_kern, ck.sk_kern, jnp.asarray(onehot), params.tgsw)
        d_f = fblock.expand_fblock_chunk(tck.d_sel[s:s + 1], geom)[0]
        f_f = fblock.expand_fblock_chunk(torch.cat([tck.f0_sel[s:s + 1], tck.f1_sel[s:s + 1]], -1),
                                         ccs._pair_geometry(geom))[0]
        got = ccs.uni_product_fb(torch.from_numpy(x), d_f, f_f, tck, s // n)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wide_digit_set_equal_jax():
    """SchemeParamsCCS(12, ..., 3, 9, ...): the 2-party registry gadget,
    Bg = 2^9, on a ring of 64 (tests/test_mk_ccs.py::test_ccs_fb_wide_digits)."""
    params = jparams.SchemeParamsCCS(12, 3.05e-5, 64, 1, 32, 3, 9, 3.72e-9, 8, 2, 3.05e-5, 2)
    _, sks, ck, cx, cy, _, tck, tcx, tcy = jax_world(2, params)
    assert_same(ccs.mk_gate_nand(tck, tcx, tcy), jccs.mk_gate_nand(ck, cx, cy))
    assert_same(ccs.mk_bootstrap(tck, MU, tcx), jccs.mk_bootstrap(ck, j_encode(1, 8), cx))


@pytest.mark.parametrize("parties", [2, 3])
def test_own_keys_truth_table_and_phase(parties):
    """The port's keygen (torch RNG): NAND truth table, and a bootstrap's
    phase within 1/16 of the ideal +-1/8 (the JAX test's bound)."""
    params = tparams.test_parameters_ccs(parties=parties, n=16, N=64)
    gen = torch.Generator().manual_seed(parties)
    sks = [ccs.ccs_party_keygen(gen, params, device="cpu") for _ in range(parties)]
    ck = ccs.ccs_cloud_keygen(gen, sks, params, device="cpu")
    assert ck.d_sel.shape == (parties * 16, 3, 128, 4) and ck.pk_fb.shape[0] == parties
    keys = [sk.lwe for sk in sks]
    cx, cy = (mk.mk_encrypt(gen, keys, torch.from_numpy(v), params) for v in (XS, YS))
    out = ccs.mk_gate_nand(ck, cx, cy)
    np.testing.assert_array_equal(mk.mk_decrypt(keys, out).numpy(), ~(XS & YS))
    boot = ccs.mk_bootstrap(ck, MU, cx)
    phase = mk.mk_lwe_phase(boot, keys).to(torch.int64)
    ideal = torch.from_numpy(np.where(XS, MU, -MU))
    err = ((phase - ideal).to(torch.int32).double().abs() / 2**32).max().item()
    assert err < 1 / 16, err


def test_conv_request_builds_the_fb_form():
    """The name is from when the port read "conv" as the fb form. It now pins
    the opposite: forms=("conv",) builds the conv form (d_kern, no lines),
    as JAX's keygen does; unknown forms and too many parties raise."""
    params = tparams.test_parameters_ccs(parties=2, n=4, N=64)
    gen = torch.Generator().manual_seed(0)
    sks = [ccs.ccs_party_keygen(gen, params, device="cpu") for _ in range(2)]
    ck = ccs.ccs_cloud_keygen(gen, sks, params, device="cpu", forms=("conv",))
    assert ck.d_kern.shape == (8, 4, 3, 64) and ck.d_sel is None  # the conv form, as JAX's
    with pytest.raises(ValueError):
        ccs.ccs_cloud_keygen(gen, sks, params, device="cpu", forms=("fbstream",))
    with pytest.raises(ValueError):
        ccs.ccs_cloud_keygen(gen, sks * 2, params, device="cpu")

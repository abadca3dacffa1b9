"""The port's CCS gate against the JAX package at the gadget of every CCS
registry set above 2 parties.

The registry's 4-, 8- and 16-party sets decompose with (l, Bg) = (4, 2^8),
(5, 2^6) and (12, 2^2): digits of one int8 limb block, where the 2-party
set's 2^9 takes two (tests/test_torch_ccs.py covers that one). Each gadget
is put on the test set (``dataclasses.replace`` of
``test_parameters_ccs(parties, n, N=64)``): JAX makes the keys (fb form) and
ciphertexts on the CPU (x64), they cross through ``bridge.py``, and the
port's NAND and bootstrap must give JAX's words; every tolerance is 0. One
JAX world (keygen and ciphertexts) serves all the tests of a gadget.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu.core import params as jparams
from torus_fhe_tpu.mk import ccs as jccs
from torus_fhe_tpu.mk.samples import mk_encrypt as j_mk_encrypt
from torus_fhe_tpu_torch import bridge, mk
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.mk import ccs
from torus_fhe_tpu_torch.ops import poly

MU = 1 << 29
XS = np.array([False, False, True, True, False, True])
YS = np.array([False, True, False, True, True, True])
GADGET = ("bs_decomp_length", "bs_log2_base")
# (registry set whose gadget is taken, parties, n): each gadget at 3
# parties, and the 4-party set's at its own party count at the smallest n
WORLDS = [("mk_4party_ccs", 3, 8), ("mk_8party_ccs", 3, 8), ("mk_16party_ccs", 3, 8),
          ("mk_4party_ccs", 4, 4)]
IDS = [f"{name}-{parties}p-n{n}" for name, parties, n in WORLDS]
_CACHE = {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so that the workers of a parallel test run do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gadget_params(name: str, parties: int, n: int):
    """The test set at ``parties`` and ``n`` with registry set ``name``'s gadget."""
    reg = jparams.PARAMETER_REGISTRY[name]()
    return dataclasses.replace(jparams.test_parameters_ccs(parties=parties, n=n, N=64),
                               **{f: getattr(reg, f) for f in GADGET})


def world(name: str, parties: int, n: int):
    """JAX keys, two encrypted bit batches, and the port's view of them."""
    key = (name, parties, n)
    if key not in _CACHE:
        params = gadget_params(name, parties, n)
        sks = [jccs.ccs_party_keygen(jax.random.PRNGKey(170 + p), params) for p in range(parties)]
        ck = jccs.ccs_cloud_keygen(jax.random.PRNGKey(19), sks, params, forms=("fb",))
        lwe_keys = [sk.lwe for sk in sks]
        cx = j_mk_encrypt(jax.random.PRNGKey(13), lwe_keys, jnp.asarray(XS), params)
        cy = j_mk_encrypt(jax.random.PRNGKey(14), lwe_keys, jnp.asarray(YS), params)
        tp = tparams.SchemeParamsCCS(**dataclasses.asdict(params))
        fields = {f.name: np.asarray(getattr(ck, f.name)) for f in dataclasses.fields(ck)
                  if f.name not in ("parties", "params") and getattr(ck, f.name) is not None}
        tck = bridge.ccs_cloud_key_from_numpy(tp, parties, device="cpu", **fields)
        tcx, tcy = (bridge.mk_lwe_from_numpy(np.asarray(c.a), np.asarray(c.b), device="cpu")
                    for c in (cx, cy))
        tkeys = bridge.mk_secret_keys_from_numpy(tp, [np.asarray(s.lwe.key) for s in sks],
                                                 [np.asarray(s.rlwe.key) for s in sks],
                                                 device="cpu")
        _CACHE[key] = (ck, cx, cy, tck, tcx, tcy, [k.lwe for k in tkeys])
    return _CACHE[key]


def assert_same(t, j):
    np.testing.assert_array_equal(t.a.numpy(), np.asarray(j.a))
    np.testing.assert_array_equal(t.b.numpy(), np.asarray(j.b))


@pytest.mark.parametrize("name", ["mk_4party_ccs", "mk_8party_ccs", "mk_16party_ccs"])
def test_gadget_takes_one_limb_block(name):
    """Every digit of these gadgets fits one int8 limb: one block a
    contraction, where the 2-party set's 2^9 takes two."""
    params = tparams.SchemeParamsCCS(**dataclasses.asdict(gadget_params(name, 3, 8)))
    x = torch.from_numpy(np.random.default_rng(3).integers(-2**31, 2**31, (2, 4, 64))
                         .astype(np.int32))
    blocks = ccs._digit_blocks(x, params.tgsw)
    assert blocks.shape == (1, 2, 4, params.bs_decomp_length, 64) and blocks.dtype == torch.int8


@pytest.mark.parametrize("name,parties,n", WORLDS, ids=IDS)
def test_gate_nand_equal_jax(name, parties, n):
    ck, cx, cy, tck, tcx, tcy, keys = world(name, parties, n)
    got = ccs.mk_gate_nand(tck, tcx, tcy)
    assert got.a.shape == (len(XS), parties, n) and got.a.dtype == torch.int32
    assert_same(got, jccs.mk_gate_nand(ck, cx, cy))
    np.testing.assert_array_equal(mk.mk_decrypt(keys, got).numpy(), ~(XS & YS))


@pytest.mark.parametrize("name,parties,n", WORLDS, ids=IDS)
def test_bootstrap_equal_jax(name, parties, n):
    ck, cx, _, tck, tcx, _, _ = world(name, parties, n)
    assert_same(ccs.mk_bootstrap(tck, MU, tcx), jccs.mk_bootstrap(ck, MU, cx))


@pytest.mark.parametrize("name,parties,n", WORLDS, ids=IDS)
def test_int8_products_of_a_gate(name, parties, n):
    """A NAND makes steps x (P+3) + P int8 products: per CMux step u, the
    P public keys and the shared key against x, and f0|f1 against v; then
    one keyswitch a party (the count chip_smoke.py holds E1 and E4 to)."""
    _, _, _, tck, tcx, tcy, _ = world(name, parties, n)
    poly.int8_matmul.calls = 0
    ccs.mk_gate_nand(tck, tcx, tcy)
    assert poly.int8_matmul.calls == parties * n * (parties + 3) + parties

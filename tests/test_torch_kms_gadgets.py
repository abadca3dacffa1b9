"""The port's KMS gate against the JAX package at the gadgets of every KMS
registry set above 2 parties.

The registry's sets take paths the 2-party gadgets never reach: at 4
parties gsw (5, 2^8), a digit exactly a byte wide; at 8 parties gsw
(4, 2^11), lev (3, 2^6) and uni (8, 2^4); at 16 and 32 parties uni
l = 9 and 16 (tests/test_torch_kms.py covers the 2-party set). Each set's
six gadget fields are put on the test set (``dataclasses.replace`` of
``test_parameters_kms(parties, n, N=64)``): JAX makes the keys (fb form)
and ciphertexts on the CPU (x64), they cross through ``bridge.py``, and the
port's NAND (``fast_boot`` True and False), its relinearisation products
``uni_product_new`` (all parties' kernels side by side against x) and
``tlev_extern_mul`` (S = P+1 polys an element) must give JAX's words; every
tolerance is 0. One JAX world (keygen and ciphertexts) serves all the tests
of a gadget.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu.core import params as jparams
from torus_fhe_tpu.mk import kms as jkms
from torus_fhe_tpu.mk.samples import mk_encrypt as j_mk_encrypt
from torus_fhe_tpu_torch import bridge, mk
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.mk import kms

XS = np.array([False, False, True, True, True])
YS = np.array([False, True, False, True, False])
GADGET = ("gsw_decomp_length", "gsw_log2_base", "lev_decomp_length", "lev_log2_base",
          "uni_decomp_length", "uni_log2_base")
NAMES = ["mk_4party_kms", "mk_8party_kms", "mk_16party_kms", "mk_32party_kms"]
# (registry set whose gadgets are taken, parties, n): each set's gadgets at
# 3 parties, and the 4-party set's at its own party count at the smallest n
WORLDS = [(name, 3, 8) for name in NAMES] + [("mk_4party_kms", 4, 4)]
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
    """The test set at ``parties`` and ``n`` with registry set ``name``'s gadgets."""
    reg = jparams.PARAMETER_REGISTRY[name]()
    return dataclasses.replace(jparams.test_parameters_kms(parties=parties, n=n, N=64),
                               **{f: getattr(reg, f) for f in GADGET})


def port_params(params):
    return tparams.SchemeParamsKMS(**dataclasses.asdict(params))


def world(name: str, parties: int, n: int):
    """JAX keys, two encrypted bit batches, and the port's view of them."""
    key = (name, parties, n)
    if key not in _CACHE:
        params = gadget_params(name, parties, n)
        sks = [jkms.kms_party_keygen(jax.random.PRNGKey(180 + p), params) for p in range(parties)]
        ck = jkms.kms_cloud_keygen(jax.random.PRNGKey(18), sks, params, forms=("fb",))
        lwe_keys = [sk.lwe for sk in sks]
        cx = j_mk_encrypt(jax.random.PRNGKey(15), lwe_keys, jnp.asarray(XS), params)
        cy = j_mk_encrypt(jax.random.PRNGKey(16), lwe_keys, jnp.asarray(YS), params)
        tp = port_params(params)
        fields = {f.name: np.asarray(getattr(ck, f.name)) for f in dataclasses.fields(ck)
                  if f.name not in ("parties", "params") and getattr(ck, f.name) is not None}
        tck = bridge.kms_cloud_key_from_numpy(tp, parties, device="cpu", **fields)
        tcx, tcy = (bridge.mk_lwe_from_numpy(np.asarray(c.a), np.asarray(c.b), device="cpu")
                    for c in (cx, cy))
        tkeys = bridge.mk_secret_keys_from_numpy(tp, [np.asarray(s.lwe.key) for s in sks],
                                                 [np.asarray(s.rlwe.key) for s in sks],
                                                 device="cpu")
        _CACHE[key] = (ck, cx, cy, tck, tcx, tcy, [k.lwe for k in tkeys])
    return _CACHE[key]


@pytest.mark.parametrize("fast_boot", [True, False])
@pytest.mark.parametrize("name,parties,n", WORLDS, ids=IDS)
def test_gate_nand_equal_jax(name, parties, n, fast_boot):
    ck, cx, cy, tck, tcx, tcy, keys = world(name, parties, n)
    got = kms.mk_gate_nand(tck, tcx, tcy, fast_boot)
    assert got.a.shape == (len(XS), parties, n) and got.a.dtype == torch.int32
    want = jkms.mk_gate_nand(ck, cx, cy, fast_boot)
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    np.testing.assert_array_equal(mk.mk_decrypt(keys, got).numpy(), ~(XS & YS))


@pytest.mark.parametrize("name", NAMES)
def test_uni_product_new_equal_jax(name):
    """d1, the P public keys and the shared key side by side against the
    digits of full-range 64-bit operands, for every party's uni-encryption."""
    ck, _, _, tck, _, _, _ = world(name, 3, 8)
    x = np.random.default_rng(20).integers(-2**63, 2**63, (3, 4, 64), dtype=np.int64)
    for party in range(3):
        got = kms.uni_product_new(torch.from_numpy(x), tck, party)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jkms.uni_product_new(
            jnp.asarray(x), ck, party)))


@pytest.mark.parametrize("parties", [3, 4])
@pytest.mark.parametrize("name", NAMES)
def test_tlev_extern_mul_equal_jax(name, parties):
    """S = P+1 polys an element against runtime TLev samples of the set's
    lev gadget, full-range 64-bit words."""
    params = gadget_params(name, parties, 8)
    rng = np.random.default_rng(parties)
    c = rng.integers(-2**63, 2**63, (3, parties + 1, 64), dtype=np.int64)
    lev = rng.integers(-2**63, 2**63, (3, params.lev_decomp_length, 2, 64), dtype=np.int64)
    got = kms.tlev_extern_mul(torch.from_numpy(c), torch.from_numpy(lev), port_params(params))
    assert got.shape == (3, parties + 1, 2, 64) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jkms.tlev_extern_mul(
        jnp.asarray(c), jnp.asarray(lev), params)))

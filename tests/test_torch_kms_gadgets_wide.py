"""The port's KMS gate against the JAX package at the gadgets of the 16-
and 32-party KMS registry sets (uni l = 9 and 16, the widest
relinearisation): the tests of tests/test_torch_kms_gadgets.py, name for
name, on those two sets' worlds, in a file of their own so that each file
stays under two minutes of one test worker. Each set's six gadget fields
are put on the test set (``dataclasses.replace`` of
``test_parameters_kms(3, n=8, N=64)``): JAX makes the keys (fb form) and
ciphertexts on the CPU (x64), they cross through ``bridge.py``, and the
port's NAND (``fast_boot`` True and False), ``uni_product_new`` and
``tlev_extern_mul`` must give JAX's words; every tolerance is 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_kms_gadget_helpers import (XS, YS, _one_torch_thread, gadget_params,  # noqa: F401
                                       port_params, world)

from torus_fhe_tpu.mk import kms as jkms
from torus_fhe_tpu_torch import mk
from torus_fhe_tpu_torch.mk import kms

NAMES = ["mk_16party_kms", "mk_32party_kms"]
# (registry set whose gadgets are taken, parties, n): each set's gadgets at 3 parties
WORLDS = [(name, 3, 8) for name in NAMES]
IDS = [f"{name}-{parties}p-n{n}" for name, parties, n in WORLDS]


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

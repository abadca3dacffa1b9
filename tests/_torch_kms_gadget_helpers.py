"""What tests/test_torch_kms_gadgets.py and
tests/test_torch_kms_gadgets_wide.py share: the test set with a KMS
registry set's gadget fields, one JAX world (keys, two encrypted bit
batches, the port's view of them through ``bridge.py``) a gadget, cached in
the process, and the one-thread fixture.
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
from torus_fhe_tpu_torch import bridge
from torus_fhe_tpu_torch.core import params as tparams

XS = np.array([False, False, True, True, True])
YS = np.array([False, True, False, True, False])
GADGET = ("gsw_decomp_length", "gsw_log2_base", "lev_decomp_length", "lev_log2_base",
          "uni_decomp_length", "uni_log2_base")
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

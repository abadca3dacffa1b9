"""The CCS and KMS cloud-key files (utils/serialize.py), both ways with the
JAX package.

A file the JAX package saves loads in the port and gives the JAX gate's
words; a file the port saves loads in the JAX package and gives the port's
words; a file in the JAX package's default conv form (packed per-step
kernels, no lines) loads in the port, whose lines rebuilt from the kernels
equal the lines of a JAX keygen of the same seed in both forms. Every
comparison is word for word (tolerance 0), at test_parameters_{ccs,kms}
(n=16, N=64, 2 parties).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu.core import params as jparams
from torus_fhe_tpu.mk import ccs as jccs
from torus_fhe_tpu.mk import kms as jkms
from torus_fhe_tpu.mk.samples import MKLweSample as JMKLweSample
from torus_fhe_tpu.mk.samples import mk_encrypt as j_mk_encrypt
from torus_fhe_tpu.utils import serialize as jser
from torus_fhe_tpu_torch import bridge, mk
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.mk import ccs, kms
from torus_fhe_tpu_torch.utils import serialize as tser

XS = np.array([False, False, True, True])
YS = np.array([False, True, False, True])
SCHEMES = {
    "ccs": dict(jmod=jccs, tmod=ccs, params=jparams.test_parameters_ccs,
                jkeygen=jccs.ccs_party_keygen, jcloud=jccs.ccs_cloud_keygen,
                tkeygen=ccs.ccs_party_keygen, tcloud=ccs.ccs_cloud_keygen,
                jsave=jser.save_ccs_cloud_key, jload=jser.load_ccs_cloud_key,
                tsave=tser.save_ccs_cloud_key, tload=tser.load_ccs_cloud_key,
                lines=("d_sel", "f0_sel", "f1_sel")),
    "kms": dict(jmod=jkms, tmod=kms, params=jparams.test_parameters_kms,
                jkeygen=jkms.kms_party_keygen, jcloud=jkms.kms_cloud_keygen,
                tkeygen=kms.kms_party_keygen, tcloud=kms.kms_cloud_keygen,
                jsave=jser.save_kms_cloud_key, jload=jser.load_kms_cloud_key,
                tsave=tser.save_kms_cloud_key, tload=tser.load_kms_cloud_key,
                lines=("gsw_sel",)),
}
_WORLDS = {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so that the workers of a parallel test run do
    not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_world(scheme, forms):
    """A JAX key pair of ``forms`` and two encrypted bit batches."""
    if (scheme, forms) not in _WORLDS:
        s = SCHEMES[scheme]
        params = s["params"](parties=2, n=16, N=64)
        sks = [s["jkeygen"](jax.random.PRNGKey(90 + p), params) for p in range(2)]
        ck = s["jcloud"](jax.random.PRNGKey(11), sks, params, forms=forms)
        keys = [sk.lwe for sk in sks]
        cts = [j_mk_encrypt(jax.random.PRNGKey(20 + i), keys, jnp.asarray(v), params)
               for i, v in enumerate((XS, YS))]
        _WORLDS[(scheme, forms)] = (params, sks, ck, cts)
    return _WORLDS[(scheme, forms)]


def to_port(cts):
    return [bridge.mk_lwe_from_numpy(np.asarray(c.a), np.asarray(c.b), device="cpu") for c in cts]


def assert_same(t, j):
    np.testing.assert_array_equal(t.a.numpy(), np.asarray(j.a))
    np.testing.assert_array_equal(t.b.numpy(), np.asarray(j.b))


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_jax_file_runs_in_port(scheme, tmp_path):
    s = SCHEMES[scheme]
    params, _, ck, cts = jax_world(scheme, ("fb",))
    path = os.path.join(tmp_path, "cloud.key")
    s["jsave"](path, ck)
    tck = s["tload"](path, device="cpu")
    assert tck.parties == 2 and dataclasses.asdict(tck.params) == dataclasses.asdict(params)
    for name in s["lines"]:
        np.testing.assert_array_equal(getattr(tck, name).numpy(), np.asarray(getattr(ck, name)))
    assert_same(s["tmod"].mk_gate_nand(tck, *to_port(cts)), s["jmod"].mk_gate_nand(ck, *cts))


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_port_file_runs_in_jax(scheme, tmp_path):
    """The port's own key (torch RNG) saved, loaded by the JAX package, and
    its gate there equal to the port's; the port's reload of the file holds
    the same arrays."""
    s = SCHEMES[scheme]
    params = getattr(tparams, f"test_parameters_{scheme}")(parties=2, n=16, N=64)
    gen = torch.Generator().manual_seed(7)
    sks = [s["tkeygen"](gen, params, device="cpu") for _ in range(2)]
    tck = s["tcloud"](gen, sks, params, device="cpu")
    keys = [sk.lwe for sk in sks]
    tcx, tcy = (mk.mk_encrypt(gen, keys, torch.from_numpy(v), params) for v in (XS, YS))
    path = os.path.join(tmp_path, "cloud.key")
    s["tsave"](path, tck)
    jck = s["jload"](path)
    assert jck.parties == 2 and type(jck.params).__name__ == type(params).__name__
    want = s["tmod"].mk_gate_nand(tck, tcx, tcy)
    np.testing.assert_array_equal(mk.mk_decrypt(keys, want).numpy(), ~(XS & YS))
    got = s["jmod"].mk_gate_nand(jck, *(JMKLweSample(jnp.asarray(c.a.numpy()),
                                                     jnp.asarray(c.b.numpy())) for c in (tcx, tcy)))
    assert_same(want, got)
    again = s["tload"](path, device="cpu")
    for f in dataclasses.fields(tck):
        v = getattr(tck, f.name)
        if isinstance(v, torch.Tensor):
            assert torch.equal(getattr(again, f.name), v), f.name


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_jax_conv_file_runs_in_port(scheme, tmp_path):
    """A file of the JAX package's default conv form: the port rebuilds the
    lines from the packed kernels, equal to those of a JAX keygen of the same
    seed in both forms, and its gate gives the JAX gate's words."""
    s = SCHEMES[scheme]
    _, _, ck, cts = jax_world(scheme, ("conv",))
    _, _, both, _ = jax_world(scheme, ("conv", "fb"))
    for name in s["lines"]:
        assert getattr(ck, name) is None
    path = os.path.join(tmp_path, "cloud.key")
    s["jsave"](path, ck)
    tck = s["tload"](path, device="cpu")
    for name in s["lines"]:
        np.testing.assert_array_equal(getattr(tck, name).numpy(), np.asarray(getattr(both, name)))
    assert_same(s["tmod"].mk_gate_nand(tck, *to_port(cts)), s["jmod"].mk_gate_nand(both, *cts))


def test_wrong_kind_is_refused(tmp_path):
    _, _, ck, _ = jax_world("ccs", ("fb",))
    path = os.path.join(tmp_path, "cloud.key")
    jser.save_ccs_cloud_key(path, ck)
    with pytest.raises(ValueError):
        tser.load_kms_cloud_key(path, device="cpu")

"""The device default of the port's entry points: ``device=None`` is the
card (the current CUDA device) and raises without one; ``device="cpu"`` runs
on the CPU. Inner helpers keep torch's meaning of None.
"""

import numpy as np
import pytest
import torch

from torus_fhe_tpu_torch import bridge, mk
from torus_fhe_tpu_torch.boot import api, bootstrap, gates, keyswitch
from torus_fhe_tpu_torch.core import params as P
from torus_fhe_tpu_torch.core.device import resolve_device
from torus_fhe_tpu_torch.lwe import lwe_keygen
from torus_fhe_tpu_torch.mk import gates3gen
from torus_fhe_tpu_torch.rlwe import rlwe_keygen
from torus_fhe_tpu_torch.utils import noise

PARAMS = P.test_parameters(n=8, N=64)
PARAMS3 = P.test_parameters_3gen(parties=2, n=8, N=64)


def _gen():
    return torch.Generator().manual_seed(0)


def _mk_keys(device):
    g = _gen()
    sks = [mk.mk_party_keygen(g, PARAMS3, device=device) for _ in range(2)]
    return sks, mk.mk_cloud_keygen(g, sks, PARAMS3, device=device, forms=("fblock", "fbstream"),
                                   keep_samples=True)


def _bootstrap_keygen(device):
    g = _gen()
    return bootstrap.bootstrap_keygen(
        g, PARAMS.bs_noise_stddev, lwe_keygen(g, PARAMS.lwe), rlwe_keygen(g, PARAMS.rlwe),
        PARAMS, device=device).fb


def _keyswitch_keygen(device):
    g = _gen()
    return keyswitch.keyswitch_keygen(
        g, PARAMS.ks_noise_stddev, PARAMS.ks, lwe_keygen(g, PARAMS.lwe),
        lwe_keygen(g, PARAMS.extracted_lwe), device=device).mat


ENTRY_POINTS = {
    "make_secret_key": lambda d: api.make_secret_key(_gen(), PARAMS, device=d).key.key,
    "make_key_pair": lambda d: api.make_key_pair(_gen(), PARAMS, device=d)[1].bootstrap_key.fb,
    "bootstrap_keygen": _bootstrap_keygen,
    "rebuild_bk_forms": lambda d: bootstrap.rebuild_bk_forms(
        torch.zeros((8, PARAMS.bs_decomp_length, 2, 2, 64), dtype=torch.int32), PARAMS,
        device=d).fb,
    "keyswitch_keygen": _keyswitch_keygen,
    "mk_party_keygen": lambda d: mk.mk_party_keygen(_gen(), PARAMS3, device=d).rlwe.key,
    "mk_cloud_keygen": lambda d: _mk_keys(d)[1].bk_fb,
    "secret_key_from_numpy": lambda d: bridge.secret_key_from_numpy(
        PARAMS, np.zeros(8, np.int32), device=d).key.key,
    "lwe_from_numpy": lambda d: bridge.lwe_from_numpy(
        np.zeros((2, 8), np.int32), np.zeros(2, np.int32), device=d).a,
    "mk_lwe_from_numpy": lambda d: bridge.mk_lwe_from_numpy(
        np.zeros((2, 2, 8), np.int32), np.zeros(2, np.int32), device=d).a,
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card(name, monkeypatch):
    """Without a card the default raises and names device="cpu"; "cpu" works.
    (With a card, the default puts the result on the current CUDA device.)"""
    assert ENTRY_POINTS[name]("cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert ENTRY_POINTS[name](None).device == resolve_device(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name](None)


def test_loaders_of_whole_keys_and_inner_helpers(monkeypatch):
    sk, ck = api.make_key_pair(_gen(), PARAMS, device="cpu")
    sks, mck = _mk_keys("cpu")
    ks = ck.keyswitch_key
    loaders = [
        lambda d: bridge.cloud_key_from_numpy(PARAMS, ck.bootstrap_key.samples.numpy(),
                                              ks.mat.numpy(), ks.n_in, ks.n_out, device=d
                                              ).bootstrap_key.fb,
        lambda d: bridge.mk_secret_keys_from_numpy(
            PARAMS3, [s.lwe.key.numpy() for s in sks], [s.rlwe.key.numpy() for s in sks],
            device=d)[0].lwe.key,
        lambda d: bridge.mk_cloud_key_from_numpy(PARAMS3, mck.bk_samples.numpy(),
                                                 mck.ks_mat.numpy(), 2, device=d).bk_fb,
    ]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for load in loaders:
        assert load("cpu").device.type == "cpu"
        with pytest.raises(RuntimeError, match='device="cpu"'):
            load(None)
    # the constant gates follow their cloud key
    for const in (gates.gate_constant(ck, [True, False]),
                  gates3gen.mk_gate_constant(mck, [True, False])):
        assert const.a.device == const.b.device == ck.keyswitch_key.mat.device
    assert gates.gate_constant(ck, torch.tensor([True]), device="cpu").b.device.type == "cpu"
    # an inner helper: None is torch's default device, by design
    assert lwe_keygen(_gen(), PARAMS.lwe).key.device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")


NOISE_ENTRIES = {
    "measure_single_key": lambda: noise.measure_single_key(_gen(), PARAMS, trials=4),
    "measure_multikey_3gen": lambda: noise.measure_multikey(_gen(), PARAMS3, 2, trials=4),
    "measure_multikey_ccs": lambda: noise.measure_multikey(
        _gen(), P.test_parameters_ccs(parties=2, n=8, N=64), 2, trials=4, scheme="ccs"),
    "measure_multikey_kms": lambda: noise.measure_multikey(
        _gen(), P.test_parameters_kms(parties=2, n=8, N=64), 2, trials=4, scheme="kms"),
}


@pytest.mark.parametrize("name", list(NOISE_ENTRIES))
def test_noise_harness_defaults_to_the_card(name, monkeypatch):
    """The harness's entries take device=None as the card: without one they
    raise before any keygen and name device="cpu" (their CPU runs are in
    tests/test_torch_noise.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        NOISE_ENTRIES[name]()

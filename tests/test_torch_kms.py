"""The port's 2nd-gen (KMS) multikey scheme against the JAX package.

Parity: JAX makes the keys (its fb form) and ciphertexts on the CPU (x64,
as tests/test_mk_kms.py does) and they cross to the port through
``torus_fhe_tpu_torch.bridge``. The rotates, the TLev product, the
uni-products, the extract and the keyswitch are exact integer arithmetic
mod 2^64 and 2^32, so the words must be equal: every tolerance below is 0,
and so is the runtime-kernel product's against an int64 plain version. The
port's own keys use torch's RNG, so they are checked by decryption (truth
tables) and by the phase bound of the JAX test: |phase - ideal| < 1/16.
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
from torus_fhe_tpu.ops import poly as jpoly
from torus_fhe_tpu_torch import bridge, mk
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.mk import kms
from torus_fhe_tpu_torch.ops import poly

MU32, MU64 = 1 << 29, 1 << 61
XS = np.array([False, False, True, True, True])
YS = np.array([False, True, False, True, False])
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
    return tparams.SchemeParamsKMS(**dataclasses.asdict(params))


def fields_of(ck) -> dict:
    """The JAX key's arrays by field name, as numpy (None fields left out)."""
    return {f.name: np.asarray(getattr(ck, f.name)) for f in dataclasses.fields(ck)
            if f.name not in ("parties", "params") and getattr(ck, f.name) is not None}


def jax_world(parties):
    """JAX keys (fb form), two encrypted bit batches, and the port's view."""
    if parties not in _WORLDS:
        params = jparams.test_parameters_kms(parties=parties, n=16, N=64)
        sks = [jkms.kms_party_keygen(jax.random.PRNGKey(80 + p), params) for p in range(parties)]
        ck = jkms.kms_cloud_keygen(jax.random.PRNGKey(8), sks, params, forms=("fb",))
        lwe_keys = [sk.lwe for sk in sks]
        cx = j_mk_encrypt(jax.random.PRNGKey(5), lwe_keys, jnp.asarray(XS), params)
        cy = j_mk_encrypt(jax.random.PRNGKey(6), lwe_keys, jnp.asarray(YS), params)
        tp = port_params(params)
        tck = bridge.kms_cloud_key_from_numpy(tp, parties, device="cpu", **fields_of(ck))
        tcx, tcy = (bridge.mk_lwe_from_numpy(np.asarray(c.a), np.asarray(c.b), device="cpu")
                    for c in (cx, cy))
        _WORLDS[parties] = (params, sks, ck, cx, cy, tp, tck, tcx, tcy)
    return _WORLDS[parties]


def assert_same(t, j):
    np.testing.assert_array_equal(t.a.numpy(), np.asarray(j.a))
    np.testing.assert_array_equal(t.b.numpy(), np.asarray(j.b))


@pytest.mark.parametrize("name", ["mk_2party_kms", "mk_4party_kms", "mk_8party_kms",
                                  "mk_16party_kms", "mk_32party_kms"])
@pytest.mark.parametrize("fast", [False, True])
def test_registry_names_equal_jax(name, fast):
    want = jparams.PARAMETER_REGISTRY[name](fast)
    got = tparams.PARAMETER_REGISTRY[name](fast)
    assert type(got).__name__ == type(want).__name__ == "SchemeParamsKMS"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for gadget in ("tgsw", "tlev", "uni"):
        g, w = getattr(got, gadget), getattr(want, gadget)
        assert (g.gadget_values, g.offset) == (w.gadget_values, w.offset)


@pytest.mark.parametrize("parties", [2, 3])
@pytest.mark.parametrize("fast_boot", [True, False])
def test_bootstrap_equal_jax(parties, fast_boot):
    params, _, ck, cx, _, _, tck, tcx, _ = jax_world(parties)
    want = jkms.mk_bootstrap(ck, MU64, cx, fast_boot)
    got = kms.mk_bootstrap(tck, MU64, tcx, fast_boot)
    assert got.a.shape == (len(XS), parties, params.lwe_size) and got.a.dtype == torch.int32
    assert_same(got, want)


@pytest.mark.parametrize("parties", [2, 3])
def test_gate_nand_equal_jax(parties):
    _, sks, ck, cx, cy, _, tck, tcx, tcy = jax_world(parties)
    got = kms.mk_gate_nand(tck, tcx, tcy)
    assert_same(got, jkms.mk_gate_nand(ck, cx, cy))
    tkeys = bridge.mk_secret_keys_from_numpy(tck.params, [np.asarray(s.lwe.key) for s in sks],
                                             [np.asarray(s.rlwe.key) for s in sks], device="cpu")
    np.testing.assert_array_equal(mk.mk_decrypt([k.lwe for k in tkeys], got).numpy(),
                                  ~(XS & YS))


@pytest.mark.parametrize("parties", [2, 3])
def test_tlev_extern_mul_equal_jax(parties):
    params, _, _, _, _, tp, _, _, _ = jax_world(parties)
    rng = np.random.default_rng(parties)
    c = rng.integers(-2**63, 2**63, (3, parties + 1, 64), dtype=np.int64)
    lev = rng.integers(-2**63, 2**63, (3, params.lev_decomp_length, 2, 64), dtype=np.int64)
    want = jkms.tlev_extern_mul(jnp.asarray(c), jnp.asarray(lev), params)
    got = kms.tlev_extern_mul(torch.from_numpy(c), torch.from_numpy(lev), tp)
    assert got.shape == (3, parties + 1, 2, 64) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("parties", [2, 3])
def test_uni_product_new_equal_jax(parties):
    _, _, ck, _, _, _, tck, _, _ = jax_world(parties)
    rng = np.random.default_rng(10 + parties)
    x = rng.integers(-2**63, 2**63, (4, parties + 1, 64), dtype=np.int64)
    for party in range(parties):
        want = jkms.uni_product_new(jnp.asarray(x), ck, party)
        got = kms.uni_product_new(torch.from_numpy(x), tck, party)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [32, 64])
def test_pack_kernels_traced_equal_host(bits):
    rng = np.random.default_rng(bits)
    k = rng.integers(-2**(bits - 1), 2**(bits - 1), (3, 2, 2, 64), dtype=np.int64)
    k = k.astype(np.int32 if bits == 32 else np.int64)
    got = poly.pack_kernels_traced(torch.from_numpy(k), bits)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), poly.pack_kernels_host(k, bits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpoly.pack_kernels_traced(
        jnp.asarray(k), bits)))
    np.testing.assert_array_equal(poly.unpack_kernels_host(got.numpy(), bits, 2), k)


def _plain_multirow(rows: np.ndarray, packed: np.ndarray) -> np.ndarray:
    """out[b, m, cl, j] = sum_{r, t} rows[b, m, r, t] * kern[b, cl, r, j - t],
    negacyclic, in int64 (the packed windows unflipped)."""
    kern = packed[..., ::-1].astype(np.int64)
    N = rows.shape[-1]
    j, t = np.arange(N)[:, None], np.arange(N)[None, :]
    sign = np.where(j >= t, 1, -1)
    circ = kern[..., (j - t) % N] * sign  # (B, CL, R, j, t)
    return np.einsum("bmrt,bcrjt->bmcj", rows.astype(np.int64), circ)


@pytest.mark.parametrize("B,M,R,N,CL", [(3, 3, 2, 64, 16), (2, 5, 3, 32, 8), (1, 1, 1, 16, 4)])
def test_runtime_kernel_product_equal_plain(B, M, R, N, CL):
    """The per-element product against an int64 plain version and JAX's,
    at full-magnitude digits and limbs (sums far inside int32)."""
    rng = np.random.default_rng(M * N)
    rows = rng.integers(-128, 128, (B, M, R, N)).astype(np.int8)
    packed = rng.integers(-128, 128, (B, CL, R, N)).astype(np.int8)
    got = poly.negacyclic_extern_product_batched_kernels_multirow(torch.from_numpy(rows),
                                                                  torch.from_numpy(packed))
    assert got.dtype == torch.int32 and got.shape == (B, M, CL, N)
    np.testing.assert_array_equal(got.numpy(), _plain_multirow(rows, packed))
    want = jpoly.negacyclic_extern_product_batched_kernels_multirow(
        jnp.asarray(rows), jnp.asarray(packed), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("parties", [2, 3])
def test_own_keys_truth_table_and_phase(parties):
    """The port's keygen (torch RNG): NAND truth table with both rotate
    variants, and a bootstrap's phase within 1/16 of the ideal +-1/8."""
    params = tparams.test_parameters_kms(parties=parties, n=16, N=64)
    gen = torch.Generator().manual_seed(parties)
    sks = [kms.kms_party_keygen(gen, params, device="cpu") for _ in range(parties)]
    ck = kms.kms_cloud_keygen(gen, sks, params, device="cpu")
    assert ck.gsw_sel.shape == (parties * 16, 6, 128, 16) and ck.d_kern.shape == (parties, 8, 2, 64)
    keys = [sk.lwe for sk in sks]
    cx, cy = (mk.mk_encrypt(gen, keys, torch.from_numpy(v), params) for v in (XS, YS))
    for fast_boot in (True, False):
        out = kms.mk_gate_nand(ck, cx, cy, fast_boot)
        np.testing.assert_array_equal(mk.mk_decrypt(keys, out).numpy(), ~(XS & YS))
    boot = kms.mk_bootstrap(ck, MU64, cx)
    phase = mk.mk_lwe_phase(boot, keys).to(torch.int64)
    ideal = torch.from_numpy(np.where(XS, MU32, -MU32))
    err = ((phase - ideal).to(torch.int32).double().abs() / 2**32).max().item()
    assert err < 1 / 16, err


def test_tlev_trivial_one_equal_jax():
    params = jparams.test_parameters_kms(parties=2, n=16, N=64)
    want = jkms.tlev_trivial_one(3, params)
    got = kms.tlev_trivial_one(3, port_params(params))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

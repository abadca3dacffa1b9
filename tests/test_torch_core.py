"""torus_fhe_tpu_torch core and polynomial helpers against the JAX package.

Every function here is integer arithmetic mod 2^32 (or 2^64), so the port
must return the same words as JAX: the tolerance is exact equality. Inputs
come from numpy and go to both packages.
"""

import dataclasses
import subprocess
import sys
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu import rlwe as jrlwe
from torus_fhe_tpu.core import params as jparams
from torus_fhe_tpu.core import torus as jtorus
from torus_fhe_tpu.ops import poly as jpoly
from torus_fhe_tpu_torch import lwe as tlwe
from torus_fhe_tpu_torch import rlwe as trlwe
from torus_fhe_tpu_torch import tgsw as ttgsw
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.core import torus as ttorus
from torus_fhe_tpu_torch.ops import poly as tpoly

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PARAM_SETS = ["tfhe_parameters_128", "tfhe_parameters_128_tpu",
              "tfhe_parameters_128_tpu_fast", "test_parameters"]


def _i32(rng, shape):
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("name", PARAM_SETS)
def test_params_equal_jax(name):
    p, q = getattr(tparams, name)(), getattr(jparams, name)()
    assert dataclasses.asdict(p) == dataclasses.asdict(q)
    for sub in ("lwe", "rlwe", "tgsw", "ks", "extracted_lwe"):
        assert dataclasses.asdict(getattr(p, sub)) == dataclasses.asdict(getattr(q, sub))
    assert p.tgsw.gadget_values == q.tgsw.gadget_values
    assert p.tgsw.offset == q.tgsw.offset


def test_encode_decode_match_jax():
    rng = np.random.default_rng(0)
    mu = rng.integers(-4, 4, 64).astype(np.int32)
    for ms in (2, 4, 8, 128):
        _eq(ttorus.encode_message(torch.from_numpy(mu), ms),
            jtorus.encode_message(jnp.asarray(mu), ms))
    phase = _i32(rng, (8, 33))
    for ms in (8, 128, 1024):
        got = ttorus.decode_message(torch.from_numpy(phase), ms)
        _eq(got, jtorus.decode_message(jnp.asarray(phase), ms))
        assert got.min() >= -ms // 2 and got.max() < ms // 2


def test_double_to_torus_and_t64_match_jax():
    rng = np.random.default_rng(1)
    d = rng.uniform(-0.49, 0.49, 200)
    for dt in (np.float32, np.float64):
        x = d.astype(dt)
        _eq(ttorus.double_to_torus(torch.from_numpy(x)),
            jtorus.double_to_torus(jnp.asarray(x), jnp.int32))
    x64 = rng.integers(-2**63, 2**63 - 1, 300, dtype=np.int64)
    x64[:4] = [-1, -(2**32), -(2**32) - 1, 2**32 + 1]
    _eq(ttorus.t64_to_t32(torch.from_numpy(x64)), jtorus.t64_to_t32(jnp.asarray(x64)))


@pytest.mark.parametrize("bits", [32, 64])
def test_limb_split_and_combine_match_jax(bits):
    rng = np.random.default_rng(2)
    if bits == 32:
        x = _i32(rng, (5, 40))
    else:
        x = rng.integers(-2**63, 2**63 - 1, (5, 40), dtype=np.int64)
    x.flat[:3] = [-1, np.iinfo(x.dtype).min, np.iinfo(x.dtype).max]
    want = np.asarray(jpoly.limb_split_signed(jnp.asarray(x), bits))
    np.testing.assert_array_equal(tpoly.limb_split_signed(torch.from_numpy(x), bits).numpy(), want)
    np.testing.assert_array_equal(tpoly.limb_split_signed_host(x, bits), want)
    parts = rng.integers(-2**20, 2**20, (6, 7, 4)).astype(np.int32)
    _eq(tpoly.limb_combine(torch.from_numpy(parts), 32),
        jpoly.limb_combine(jnp.asarray(parts), 32))
    # the split inverts: limbs recombine to x mod 2^bits
    back = tpoly.limb_combine(tpoly.limb_split_signed(torch.from_numpy(x), bits).to(torch.int32), bits)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("l,lb", [(3, 7), (2, 8)])
def test_decompose_matches_jax(l, lb):
    rng = np.random.default_rng(3)
    x = _i32(rng, (4, 3, 64))
    off = tparams.TGswParams(l, lb).offset
    got = tpoly.decompose(torch.from_numpy(x), l, lb, 32, off)
    _eq(got, jpoly.decompose(jnp.asarray(x), l, lb, 32, off))
    assert got.dtype == torch.int32 and got.shape == (4, 3, l, 64)
    assert got.min() >= -(1 << (lb - 1)) and got.max() < (1 << (lb - 1))


def test_mul_by_monomial_matches_jax():
    rng = np.random.default_rng(4)
    N = 64
    x = _i32(rng, (6, 3, N))
    s = rng.integers(-2 * N, 2 * N, 6).astype(np.int32)
    _eq(tpoly.mul_by_monomial(torch.from_numpy(x), torch.from_numpy(s)),
        jpoly.mul_by_monomial(jnp.asarray(x), jnp.asarray(s)))
    for k in (0, 5, N, N + 7, -3, 2 * N + 1):
        _eq(tpoly.mul_by_monomial(torch.from_numpy(x), k), jpoly.mul_by_monomial(jnp.asarray(x), k))


def test_negacyclic_polymul_ref_matches_jax():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 2, 32).astype(np.int32)
    b = _i32(rng, (3, 32))
    _eq(tpoly.negacyclic_polymul_ref(torch.from_numpy(a), torch.from_numpy(b)),
        jpoly.negacyclic_polymul_ref(jnp.asarray(a), jnp.asarray(b)))


def test_int8_matmul_is_exact_and_pads_rows():
    rng = np.random.default_rng(6)
    a = rng.integers(-128, 128, (3, 64)).astype(np.int8)
    b = rng.integers(-128, 128, (64, 24)).astype(np.int8)
    got = tpoly.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (3, 24) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    with pytest.raises(ValueError):
        tpoly.int8_matmul(torch.from_numpy(a), torch.from_numpy(b[:, :20]))


def test_rlwe_tgsw_encrypt_phase_and_extract():
    """Port keys and samples, checked by their phases (the RNG differs from
    JAX's); the extraction is word-equal to JAX's and keeps the phase."""
    params = tparams.test_parameters(n=8, N=64)
    rp, N = params.rlwe, params.rlwe_polynomial_degree
    g = torch.Generator().manual_seed(3)
    key = trlwe.rlwe_keygen(g, rp)
    z = trlwe.rlwe_encrypt_zero(g, 2**-20, key, rp, (5,), body_round_bits=8)
    assert z.a.shape == (5, 2, N) and not (z.a[:, -1] & 255).any()  # body rounded to 2^8
    assert trlwe.rlwe_phase(z, key).abs().max() < 2**16  # noise ~2^12 + rounding
    mu = torch.from_numpy(_i32(np.random.default_rng(8), (2, N)))
    assert torch.equal(trlwe.rlwe_phase(trlwe.rlwe_noiseless_trivial(mu, rp, (2,)), key), mu)
    # TGSW: the body row (level i, poly k) of bit m has phase m * gadget_i at X^0
    gsw = ttgsw.tgsw_encrypt(g, torch.tensor([0, 1]), 2**-20, key, params.tgsw, rp).samples
    assert gsw.shape == (2, params.bs_decomp_length, 2, 2, N)
    for m in (0, 1):
        for i, gv in enumerate(params.tgsw.gadget_values):
            ph = trlwe.rlwe_phase(trlwe.RLweSample(gsw[m, i, 1]), key)
            ph[0] -= m * gv
            assert ph.abs().max() < 2**16
    # extraction: word-equal to JAX, and the LWE phase is the RLWE phase at X^0
    x = _i32(np.random.default_rng(9), (3, 2, N))
    got = trlwe.rlwe_extract_sample(trlwe.RLweSample(torch.from_numpy(x)))
    want = jrlwe.rlwe_extract_sample(jrlwe.RLweSample(jnp.asarray(x)))
    _eq(got.a, want.a)
    _eq(got.b, want.b)
    assert torch.equal(tlwe.lwe_phase(got, trlwe.extract_lwe_key(key)),
                       trlwe.rlwe_phase(trlwe.RLweSample(torch.from_numpy(x)), key)[:, 0])


def test_torch_integer_hazards():
    """The integer semantics the port relies on."""
    x = torch.tensor([2**31 - 1, 5], dtype=torch.int32)
    assert x.sum().dtype == torch.int64  # hence dtype=torch.int32 in the port
    assert x.sum(dtype=torch.int32).item() == -2**31 + 4  # wraps
    assert (torch.tensor([3], dtype=torch.int32) << 31).item() == -2**31
    assert (torch.tensor([-9], dtype=torch.int32) >> 1).item() == -5
    assert (torch.tensor([2**31 - 1], dtype=torch.int32) + 1).item() == -2**31


def test_package_never_imports_jax():
    code = ("import sys, importlib, pkgutil, torus_fhe_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'torus_fhe_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
            " or k.startswith('torus_fhe_tpu.') or k == 'torus_fhe_tpu')\n"
            "assert not bad, bad\n"
            "assert {'torus_fhe_tpu_torch.parallel.mk_pipeline', 'torus_fhe_tpu_torch.parallel.sharded',"
            " 'torus_fhe_tpu_torch.threshold.decrypt', 'torus_fhe_tpu_torch.utils.serialize',"
            " 'torus_fhe_tpu_torch.circuits.words', 'torus_fhe_tpu_torch.apps.knn',"
            " 'torus_fhe_tpu_torch.apps.cnn', 'torus_fhe_tpu_torch.apps.volume_matching',"
            " 'torus_fhe_tpu_torch.apps.mk_knn', 'torus_fhe_tpu_torch.threshold.convert',"
            " 'torus_fhe_tpu_torch.threshold.pk', 'torus_fhe_tpu_torch.threshold.shamir',"
            " 'torus_fhe_tpu_torch.threshold.additive', 'torus_fhe_tpu_torch.boot.public_sample',"
            " 'torus_fhe_tpu_torch.boot.pack', 'torus_fhe_tpu_torch.cli',"
            " 'torus_fhe_tpu_torch.__main__', 'torus_fhe_tpu_torch.mk.ccs',"
            " 'torus_fhe_tpu_torch.mk.kms', 'torus_fhe_tpu_torch.utils.noise',"
            " 'torus_fhe_tpu_torch.utils.profiling', 'torus_fhe_tpu_torch.tools.bench',"
            " 'torus_fhe_tpu_torch.tools.profile', 'torus_fhe_tpu_torch.tools.profile_trace'}"
            " <= set(sys.modules)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr

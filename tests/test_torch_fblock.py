"""The port's F-block key and plain blind rotate against the JAX package.

Keys are made by the JAX package (``forms=("fblock",)``) and their compact
TGSW samples cross to the port as numpy arrays; the port rebuilds its own
F-block key from them. The port keeps the JAX key layout, so the permutation
between the two keys is the identity: they must be byte-equal. The blind
rotate is exact integer arithmetic mod 2^32: outputs must be word-equal to
JAX's XLA scan and to its Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu.boot import api as japi
from torus_fhe_tpu.boot import bootstrap as jboot
from torus_fhe_tpu.core.params import SchemeParams, test_parameters as make_test_params
from torus_fhe_tpu.ops import fblock as jfblock
from torus_fhe_tpu.ops import poly as jpoly
from torus_fhe_tpu.ops.pallas_rotate import blind_rotate_pallas
from torus_fhe_tpu_torch.boot import bootstrap as tboot
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.ops import fblock as tfblock
from torus_fhe_tpu_torch.ops import poly as tpoly


def _twin(N=64):
    """k=2, l=2, Bg=2^8, body rounded to 2^8: the small twin of
    tfhe_parameters_128_tpu_fast (11 limb columns)."""
    base = make_test_params(n=12, N=N)
    return SchemeParams(**{**base.__dict__, "bs_decomp_length": 2, "bs_log2_base": 8,
                           "rlwe_mask_size": 2, "bk_drop_limbs": 1})


GEOMS = {"k1_N64": lambda: make_test_params(n=12, N=64),
         "k1_N256": lambda: make_test_params(n=12, N=256),
         "k2_rounded_N64": _twin}


def _port_params(p):
    return tparams.SchemeParams(**p.__dict__)


_KEYS = {}


def _jax_key(name):
    if name not in _KEYS:
        params = GEOMS[name]()
        _, ck = japi.make_key_pair(jax.random.PRNGKey(7), params, forms=("fblock",))
        _KEYS[name] = (params, np.asarray(ck.bootstrap_key.samples),
                       np.asarray(ck.bootstrap_key.fb))
    return _KEYS[name]


@pytest.mark.parametrize("name", list(GEOMS))
def test_fblock_key_equals_jax(name):
    params, samples, jfb = _jax_key(name)
    jgeom = jboot._bk_geometry(params)
    geom = tboot.bk_geometry(_port_params(params))
    assert geom == tuple(jgeom)
    if name == "k2_rounded_N64":
        assert len(geom.cols) == 11
    np.testing.assert_array_equal(tfblock.build_sel(samples, geom),
                                  jfblock.build_sel(samples, jgeom))
    fb = tfblock.build_fblocks(samples, geom, chunk=5)  # ragged last chunk
    assert fb.dtype == torch.int8 and fb.shape == jfb.shape
    np.testing.assert_array_equal(fb.numpy(), jfb)


def _inputs(params, B, seed):
    rng = np.random.default_rng(seed)
    N, C = params.rlwe_polynomial_degree, params.rlwe_mask_size + 1
    acc = rng.integers(-2**31, 2**31, (B, C, N), dtype=np.int64).astype(np.int32)
    bara = rng.integers(0, 2 * N, (B, params.lwe_size), dtype=np.int64).astype(np.int32)
    barb = rng.integers(-N, N, B, dtype=np.int64).astype(np.int32)
    return acc, bara, barb


@pytest.mark.parametrize("name", ["k1_N64", "k2_rounded_N64"])
def test_blind_rotate_explicit_acc_equals_jax(name):
    params, samples, jfb = _jax_key(name)
    jgeom = jboot._bk_geometry(params)
    geom = tboot.bk_geometry(_port_params(params))
    tg = params.tgsw
    acc, bara, _ = _inputs(params, 4, 1)
    fb = tfblock.build_fblocks(samples, geom)
    got = tfblock.blind_rotate_fblock(torch.from_numpy(acc), fb, torch.from_numpy(bara),
                                      geom, tg.decomp_length, tg.log2_base, tg.offset)
    ref = jfblock.blind_rotate_fblock(jnp.asarray(acc), jnp.asarray(jfb), jnp.asarray(bara),
                                      jgeom, tg.decomp_length, tg.log2_base, tg.offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if name == "k1_N64":
        pal = blind_rotate_pallas(jnp.asarray(acc), jnp.asarray(jfb), jnp.asarray(bara),
                                  jgeom, tg.decomp_length, tg.log2_base, tg.offset,
                                  b_tile=8, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


def test_blind_rotate_stepvec_equals_jax():
    params, samples, jfb = _jax_key("k1_N64")
    jgeom = jboot._bk_geometry(params)
    geom = tboot.bk_geometry(_port_params(params))
    tg = params.tgsw
    _, bara, barb = _inputs(params, 4, 2)
    mu = 1 << 29
    got = tfblock.blind_rotate_fblock(None, tfblock.build_fblocks(samples, geom),
                                      torch.from_numpy(bara), geom, tg.decomp_length,
                                      tg.log2_base, tg.offset,
                                      stepvec=(mu, torch.from_numpy(barb)))
    N = params.rlwe_polynomial_degree
    tv = jpoly.mul_by_monomial(jnp.full((4, N), mu, jnp.int32), -jnp.asarray(barb))
    acc0 = jnp.zeros((4, 2, N), jnp.int32).at[:, 1].set(tv)
    ref = jfblock.blind_rotate_fblock(acc0, jnp.asarray(jfb), jnp.asarray(bara), jgeom,
                                      tg.decomp_length, tg.log2_base, tg.offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    pal = blind_rotate_pallas(None, jnp.asarray(jfb), jnp.asarray(bara), jgeom,
                              tg.decomp_length, tg.log2_base, tg.offset, b_tile=8,
                              stepvec=(mu, jnp.asarray(barb)), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


@pytest.mark.parametrize("N", [64, 512])
def test_stepvec_sign_rule(N):
    """The kernel builds the test vector as pos = (w < N - (t & (N-1)))
    XOR (t >= N), t = barb & (2N-1); it must equal X^-barb * [mu..mu]."""
    mu = 1 << 29
    barb = np.arange(-N, N, dtype=np.int32)
    t = barb[:, None] & (2 * N - 1)
    w = np.arange(N)[None, :]
    pos = (w < N - (t & (N - 1))) ^ (t >= N)
    rule = np.where(pos, mu, -mu).astype(np.int32)
    geom = tfblock.fblock_geometry(1, N, 1, 2, 32, 0)
    acc0 = tfblock.stepvec_acc0(mu, torch.from_numpy(barb), geom)
    np.testing.assert_array_equal(acc0[:, 1].numpy(), rule)
    assert not acc0[:, 0].any()
    ref = jpoly.mul_by_monomial(jnp.full((2 * N, N), mu, jnp.int32), -jnp.asarray(barb))
    np.testing.assert_array_equal(rule, np.asarray(ref))
    np.testing.assert_array_equal(
        tpoly.mul_by_monomial(torch.full((2 * N, N), mu, dtype=torch.int32),
                              -torch.from_numpy(barb)).numpy(), rule)

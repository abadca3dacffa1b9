"""The port's TGSW external product and the single-key scan route against
the JAX package, and the small helpers that came with them.

Parity: inputs are made from a numpy seed (or by a JAX keygen on the CPU)
and go through the JAX function and its port. The packed kernels are held
byte for byte; the external product, the CMux step and the blind rotate
are exact integer arithmetic mod 2^bits, so every word must be equal (max
|diff| 0). JAX runs its scan route as its own tests run it:
``set_rotate_backend("scan")`` on keys that hold the conv form. The port's
own keys are checked by truth tables; sampling (torch RNG) by statistics.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu import lwe as jlwe
from torus_fhe_tpu import tgsw as jtgsw
from torus_fhe_tpu.boot import api as japi
from torus_fhe_tpu.boot import bootstrap as jboot
from torus_fhe_tpu.boot import gates as jgates
from torus_fhe_tpu.core import params as jparams
from torus_fhe_tpu.core import rng as jrng
from torus_fhe_tpu.mk import keys3gen as jkeys3
from torus_fhe_tpu.ops import poly as jpoly
from torus_fhe_tpu.rlwe import RLweSample as JRLweSample
from torus_fhe_tpu.utils import serialize as jser
from torus_fhe_tpu_torch import bridge, lwe, tgsw
from torus_fhe_tpu_torch.boot import api, bootstrap, gates
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.core import rng
from torus_fhe_tpu_torch.core.params import TGswParams
from torus_fhe_tpu_torch.mk import keys3gen
from torus_fhe_tpu_torch.ops import poly
from torus_fhe_tpu_torch.rlwe import RLweSample
from torus_fhe_tpu_torch.utils import serialize as ser

BASE = jparams.test_parameters(n=16, N=64)
# the single-key sets of the scan-route parity: the test set; k = 2, l = 2,
# Bg = 2^8 with the body's low byte dropped from the F-block form (the fast
# set's shape: the conv kernels stay full-limb, the words agree because
# keygen rounds the body); digits wider than a byte (Bg = 2^10, tfhe_80's);
# and the 64-bit torus
SETS = {
    "test": BASE,
    "k2_l2_drop1": dataclasses.replace(BASE, rlwe_mask_size=2, bs_decomp_length=2,
                                       bs_log2_base=8, bk_drop_limbs=1),
    "wide_digits": dataclasses.replace(BASE, bs_decomp_length=2, bs_log2_base=10),
    "bits64": jparams.test_parameters(n=16, N=64, bits=64),
}
XS = np.array([False, False, True, True, False, True, True, False])
YS = np.array([False, True, False, True, True, True, False, False])
_WORLDS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def backends(port: str, jax_name: str = "auto"):
    """Both packages' module-wide rotate switches, restored on exit."""
    bootstrap.set_rotate_backend(port)
    jboot.set_rotate_backend(jax_name)
    try:
        yield
    finally:
        bootstrap.set_rotate_backend("auto")
        jboot.set_rotate_backend("auto")


def port_params(p):
    return tparams.SchemeParams(**dataclasses.asdict(p))


def world(name):
    """JAX keys in both forms (conv + fblock), two bit batches, JAX's scan
    words of an AND, and the port's key in both forms (JAX's kernels carried
    as they are, the F-block key built from the samples) and ciphertexts."""
    if name not in _WORLDS:
        params = SETS[name]
        sk, ck = japi.make_key_pair(jax.random.PRNGKey(5), params, forms=("conv", "fblock"))
        cx = japi.encrypt(jax.random.PRNGKey(6), sk, jnp.asarray(XS))
        cy = japi.encrypt(jax.random.PRNGKey(7), sk, jnp.asarray(YS))
        with backends("auto", "scan"):
            want = jgates.gate_and(ck, cx, cy)
        tp = port_params(params)
        bk, ks = ck.bootstrap_key, ck.keyswitch_key
        tck = bridge.cloud_key_from_numpy(tp, np.asarray(bk.samples), np.asarray(ks.mat),
                                          ks.n_in, ks.n_out, device="cpu",
                                          forms=("conv", "fblock"),
                                          kernels=np.asarray(bk.kernels))
        tcx, tcy = (bridge.lwe_from_numpy(np.asarray(c.a), np.asarray(c.b), device="cpu")
                    for c in (cx, cy))
        _WORLDS[name] = (params, sk, ck, want, tp, tck, tcx, tcy)
    return _WORLDS[name]


def assert_same(t, j):
    np.testing.assert_array_equal(t.a.numpy(), np.asarray(j.a))
    np.testing.assert_array_equal(t.b.numpy(), np.asarray(j.b))


def rand_torus(rng_, shape, bits):
    if bits == 32:
        return rng_.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    return rng_.integers(-2**63, 2**63 - 1, shape, dtype=np.int64, endpoint=True)


@pytest.mark.parametrize("bits,drop", [(32, 0), (32, 1), (64, 0), (64, 2)])
def test_pack_tgsw_byte_equal_jax(bits, drop):
    rng_ = np.random.default_rng(bits + drop)
    samples = rand_torus(rng_, (3, 2, 3, 3, 64), bits)  # (n, l, k+1, k+1, N), k = 2
    tg = TGswParams(2, 8, bits)
    want = jtgsw.pack_tgsw(jtgsw.TGswSample(jnp.asarray(samples)), tg, drop)
    got = tgsw.pack_tgsw(tgsw.TGswSample(torch.from_numpy(samples)), tg, drop)
    assert got.kernels.dtype == torch.int8
    assert (got.bits, got.mask_size, got.limb_offset) == (want.bits, want.mask_size,
                                                          want.limb_offset) == (bits, 2, drop)
    np.testing.assert_array_equal(got.kernels.numpy(), np.asarray(want.kernels))
    np.testing.assert_array_equal(
        poly.pack_kernels_host(samples.reshape(3, 6, 3, 64), bits, drop),
        jpoly.pack_kernels_host(samples.reshape(3, 6, 3, 64), bits, drop))


@pytest.mark.parametrize("bits,l,log2_base,k,drop", [
    (32, 3, 7, 1, 0), (32, 2, 8, 2, 1), (32, 2, 10, 1, 0), (64, 3, 10, 1, 0), (64, 2, 16, 1, 1)])
def test_tgsw_extern_mul_equal_jax(bits, l, log2_base, k, drop):
    """The external product on random accumulators, digits of a byte and
    wider, 32 and 64 bits, with and without dropped kernel limbs. At 64 bits
    JAX sums each limb in int32; with R * N = 2 * 2 * 64 terms no sum
    carries past it, so the port's int64 sums give the same words."""
    rng_ = np.random.default_rng(l * log2_base + bits + drop)
    N = 64
    tg = TGswParams(l, log2_base, bits)
    samples = rand_torus(rng_, (l, k + 1, k + 1, N), bits)
    if drop:  # the body's dropped bytes are zero, as keygen's rounding makes them
        samples = (samples >> (8 * drop)) << (8 * drop)
    acc = rand_torus(rng_, (5, k + 1, N), bits)
    jg = jtgsw.pack_tgsw(jtgsw.TGswSample(jnp.asarray(samples)), tg, drop)
    want = jtgsw.tgsw_extern_mul(JRLweSample(jnp.asarray(acc)), jg, tg)
    tgp = tgsw.pack_tgsw(tgsw.TGswSample(torch.from_numpy(samples)), tg, drop)
    rows = tgsw.tgsw_decompose_rlwe(RLweSample(torch.from_numpy(acc)), tg)
    jrows = jtgsw.tgsw_decompose_rlwe(JRLweSample(jnp.asarray(acc)), tg)
    assert len(rows) == len(jrows)
    for r, jr in zip(rows, jrows):
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    got = tgsw.tgsw_extern_mul(RLweSample(torch.from_numpy(acc)), tgp, tg)
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))


@pytest.mark.parametrize("name", sorted(SETS))
def test_mux_rotate_equal_jax(name):
    params, _, ck, _, tp, tck, _, _ = world(name)
    rng_ = np.random.default_rng(11)
    N, C = params.rlwe_polynomial_degree, params.rlwe_mask_size + 1
    acc = rand_torus(rng_, (6, C, N), params.rlwe_bits)
    bara = rng_.integers(0, 2 * N, (6,), dtype=np.int32)
    for i in (0, params.lwe_size - 1):
        want = jboot.mux_rotate(JRLweSample(jnp.asarray(acc)), ck.bootstrap_key.kernels[i],
                                jnp.asarray(bara), params)
        got = bootstrap.mux_rotate(RLweSample(torch.from_numpy(acc)), tck.bootstrap_key.kernels[i],
                                   torch.from_numpy(bara), tp)
        np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))


@pytest.mark.parametrize("name", sorted(SETS))
def test_scan_route_equal_jax_and_fblock_route(name):
    """The gate on one key through the port's scan route == JAX's scan
    route, and == the port's F-block routes (the kernel's plain version
    and the F-block scan) on the same key."""
    params, sk, _, want, tp, tck, tcx, tcy = world(name)
    np.testing.assert_array_equal(tck.bootstrap_key.kernels.numpy(),
                                  np.asarray(bootstrap.rebuild_bk_forms(
                                      tck.bootstrap_key.samples, tp, ("conv",), "cpu").kernels))
    calls = poly.int8_matmul.calls
    with backends("scan"):
        got = gates.gate_and(tck, tcx, tcy)
    assert poly.int8_matmul.calls > calls  # the scan's products
    assert_same(got, want)
    for route in ("auto", "pallas", "fblock"):
        with backends(route):
            assert_same(gates.gate_and(tck, tcx, tcy), want)
    if params.rlwe_bits == 32:  # the gates' +-1/8 test vector is a 32-bit torus value
        key = bridge.secret_key_from_numpy(tp, np.asarray(sk.key.key), device="cpu")
        np.testing.assert_array_equal(api.decrypt(key, got).numpy(), XS & YS)


def test_port_keys_in_the_conv_form():
    """The port's own keygen with forms=("conv",): the scan route by
    "auto", truth tables of two gates; rebuild_bk_forms of its samples gives
    both forms, byte-equal to JAX's rebuild of the same samples."""
    params = SETS["k2_l2_drop1"]
    tp = port_params(params)
    gen = torch.Generator().manual_seed(3)
    sk, ck = api.make_key_pair(gen, tp, device="cpu", forms=("conv",))
    bk = ck.bootstrap_key
    assert bk.fb is None and bk.kernels.shape == (16, 3 * 4, 2 * 3, 64)
    assert bootstrap._resolve_backend(bk, tp) == "scan"
    cx, cy = (api.encrypt(gen, sk, torch.from_numpy(v)) for v in (XS, YS))
    np.testing.assert_array_equal(api.decrypt(sk, gates.gate_and(ck, cx, cy)).numpy(), XS & YS)
    np.testing.assert_array_equal(api.decrypt(sk, gates.gate_nand(ck, cx, cy)).numpy(),
                                  ~(XS & YS))
    both = bootstrap.rebuild_bk_forms(bk.samples, tp, ("conv", "fblock"), "cpu")
    jbk = jboot.rebuild_bk_forms(bk.samples.numpy(), params, forms=("conv", "fblock"))
    np.testing.assert_array_equal(both.kernels.numpy(), np.asarray(jbk.kernels))
    np.testing.assert_array_equal(both.fb.numpy(), np.asarray(jbk.fb))
    np.testing.assert_array_equal(both.kernels.numpy(), bk.kernels.numpy())
    with pytest.raises(ValueError, match="builds"):
        api.make_key_pair(gen, tp, device="cpu", forms=("scan",))


def test_conv_key_files_round_trip(tmp_path):
    """A conv key saved by the port records conv as JAX does; loaded with
    forms=("conv",) its kernels come back, by default as the F-block key;
    JAX loads the port's file and its scan gives the port's words."""
    params, _, _, want, tp, tck, tcx, tcy = world("test")
    ck = api.CloudKey(tp, tck.bootstrap_key._replace(fb=None), tck.keyswitch_key)
    path = str(tmp_path / "cloud.key")
    ser.save_cloud_key(path, ck)
    assert ser.load_named(path)[3]["forms"] == ["conv"]
    back = ser.load_cloud_key(path, forms=("conv",), device="cpu")
    assert back.bootstrap_key.fb is None
    np.testing.assert_array_equal(back.bootstrap_key.kernels.numpy(),
                                  tck.bootstrap_key.kernels.numpy())
    assert_same(gates.gate_and(back, tcx, tcy), want)
    default = ser.load_cloud_key(path, device="cpu").bootstrap_key
    assert default.kernels is None and default.fb.shape == tck.bootstrap_key.fb.shape
    jck = jser.load_cloud_key(path)
    np.testing.assert_array_equal(np.asarray(jck.bootstrap_key.kernels),
                                  tck.bootstrap_key.kernels.numpy())
    with backends("auto", "scan"):
        jx, jy = (jlwe.LweSample(jnp.asarray(c.a.numpy()), jnp.asarray(c.b.numpy()))
                  for c in (tcx, tcy))
        assert_same(gates.gate_and(back, tcx, tcy), jgates.gate_and(jck, jx, jy))


def test_rotate_backend_resolution_table():
    """"auto" resolves as in the JAX package: the kernel's route for an
    F-block key the kernel takes, the F-block scan for one it does not
    (digits wider than a byte, or 64 bits), the scan for a conv-only key;
    a named route needs its form."""
    assert bootstrap.get_rotate_backend() == "auto"
    table = {("test", ("conv", "fblock")): "pallas", ("test", ("fblock",)): "pallas",
             ("test", ("conv",)): "scan", ("wide_digits", ("fblock",)): "fblock",
             ("bits64", ("fblock",)): "fblock", ("bits64", ("conv",)): "scan"}
    for (name, forms), want in table.items():
        tp = port_params(SETS[name])
        bk = world(name)[5].bootstrap_key
        bk = bk._replace(kernels=bk.kernels if "conv" in forms else None,
                         fb=bk.fb if "fblock" in forms else None)
        assert bootstrap._resolve_backend(bk, tp) == want, (name, forms)
        for route in ("scan", "fblock", "pallas"):
            with backends(route):
                assert bootstrap._resolve_backend(bk, tp) == route
    _, _, _, _, tp, tck, tcx, tcy = world("test")
    for route, missing in (("scan", "kernels"), ("fblock", "fb"), ("pallas", "fb")):
        ck = api.CloudKey(tp, tck.bootstrap_key._replace(**{missing: None}), tck.keyswitch_key)
        with backends(route), pytest.raises(ValueError, match="form"):
            gates.gate_and(ck, tcx, tcy)
    with pytest.raises(ValueError, match="rotate backend"):
        bootstrap.set_rotate_backend("conv")
    assert bootstrap.get_rotate_backend() == "auto"


def test_uniform_ternary_statistics():
    gen = torch.Generator().manual_seed(0)
    x = rng.uniform_ternary(gen, (3, 40_000))
    assert x.dtype == torch.int32 and x.shape == (3, 40_000)
    j = np.asarray(jrng.uniform_ternary(jax.random.PRNGKey(0), (3, 40_000)))
    for v in (x.numpy(), j):
        assert set(np.unique(v)) == {-1, 0, 1}
        for c in (-1, 0, 1):
            assert abs((v == c).mean() - 1 / 3) < 0.01  # ~7 std of a share at 120,000 draws
        assert abs(v.mean()) < 0.01
    assert rng.uniform_ternary(gen, (4,), dtype=torch.int64).dtype == torch.int64


@pytest.mark.parametrize("noise_dtype", [np.float32, np.float64])
def test_lwe_encrypt_with_noise_equal_jax(noise_dtype):
    rng_ = np.random.default_rng(4)
    n, B = 16, 7
    key = rng_.integers(0, 2, (n,), dtype=np.int32)
    a = rand_torus(rng_, (B, n), 32)
    msg = rand_torus(rng_, (B,), 32)
    noise = rng_.normal(0, 2**-10, (B,)).astype(noise_dtype)
    want = jlwe.lwe_encrypt_with_noise(jnp.asarray(msg), jnp.asarray(noise), jnp.asarray(a),
                                       jlwe.LweKey(jnp.asarray(key)))
    got = lwe.lwe_encrypt_with_noise(torch.from_numpy(msg), torch.from_numpy(noise),
                                     torch.from_numpy(a), lwe.LweKey(torch.from_numpy(key)))
    assert_same(got, want)
    phase = lwe.lwe_phase(got, lwe.LweKey(torch.from_numpy(key))).numpy().astype(np.int64)
    assert np.abs(phase - msg).max() < 2**32 * 2**-6  # the noise alone is left


def test_gen_crp_a_same():
    """a_same=False: l independent uniform polys; True (the default): one
    repeated. The keystreams differ, so shapes, dtypes and the spread of
    the words are held against JAX's."""
    params = jparams.test_parameters_3gen(parties=2, n=16, N=1024)
    tp = tparams.SchemeParams3Gen(**params.__dict__)
    gen = torch.Generator().manual_seed(1)
    same, diff = keys3gen.gen_crp(gen, tp), keys3gen.gen_crp(gen, tp, a_same=False)
    jsame = jkeys3.gen_crp(jax.random.PRNGKey(1), params)
    jdiff = jkeys3.gen_crp(jax.random.PRNGKey(1), params, a_same=False)
    for t, j in ((same, jsame), (diff, jdiff)):
        assert tuple(t.a.shape) == j.a.shape and str(t.a.dtype)[6:] == str(j.a.dtype)
    l = params.gsw_decomp_length
    assert all(torch.equal(same.a[i], same.a[0]) for i in range(l))
    assert all(not torch.equal(diff.a[i], diff.a[0]) for i in range(1, l))
    for a in (diff.a.numpy(), np.asarray(jdiff.a)):
        hi = (a >> 63) & 1  # the top bit of uniform words: a fair coin
        assert abs(hi.mean() - 0.5) < 0.05


@pytest.mark.parametrize("bits,C", [(32, 2), (64, 2), (32, 1)])
def test_batched_kernels_product_equal_jax(bits, C):
    rng_ = np.random.default_rng(bits + C)
    B, R, N = 3, 4, 64
    digits = rng_.integers(-128, 128, (B, R, N), dtype=np.int64).astype(np.int8)
    kern = rand_torus(rng_, (B, R, C, N), bits)
    jpacked = jpoly.pack_kernels_traced(jnp.asarray(kern), bits)
    packed = poly.pack_kernels_traced(torch.from_numpy(kern), bits)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    want = jpoly.negacyclic_extern_product_batched_kernels(jnp.asarray(digits), jpacked, bits, C)
    got = poly.negacyclic_extern_product_batched_kernels(torch.from_numpy(digits), packed, bits, C)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # element b alone is the single-kernel product against its own kernel
    one = poly.negacyclic_extern_product(torch.from_numpy(digits[1:2]), packed[1], bits, C)
    np.testing.assert_array_equal(one.numpy(), got[1:2].numpy())

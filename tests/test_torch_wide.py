"""The wide route of the port against the JAX package: gadget digits wider
than a byte and the exact 64-bit F-block scan (tfhe_80, the 3gen multikey
sets from 16 parties up).

In the JAX package this route is an XLA scan outside its Pallas kernel
(mk/boot3gen.py, ``use_pallas=False``); in the port it is torch ops
(ops/fblock.py) on CPU and CUDA tensors alike, chosen from (bits, log2_base)
by ops/cuda_rotate ``rotate`` / ``rotate_streamed``. Inputs come from a seed
with numpy; keys are made by the JAX package (CPU, x64) and cross through
``torus_fhe_tpu_torch.bridge``. Tolerance: none. Every comparison with JAX is
word for word (exact integer arithmetic mod 2^32 or 2^64); the port's own
keys, made with another RNG, are checked by decrypted truth tables.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu import mk as jmk
from torus_fhe_tpu.boot import api as japi
from torus_fhe_tpu.boot import gates as jgates
from torus_fhe_tpu.core import params as jparams
from torus_fhe_tpu.mk import boot3gen as jboot3
from torus_fhe_tpu.mk import gates3gen as jgates3
from torus_fhe_tpu.mk import keys3gen as jkeys3
from torus_fhe_tpu.ops import fblock as jfblock
from torus_fhe_tpu.ops import poly as jpoly
from torus_fhe_tpu.ops.pallas_rotate import blind_rotate_pallas
from torus_fhe_tpu_torch import bridge, mk
from torus_fhe_tpu_torch.boot import api, gates
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.core import rng as trng
from torus_fhe_tpu_torch.mk import boot3gen, gates3gen, keys3gen
from torus_fhe_tpu_torch.ops import cuda_rotate
from torus_fhe_tpu_torch.ops import fblock as tfblock
from torus_fhe_tpu_torch.ops import poly as tpoly
from torus_fhe_tpu_torch.parallel import make_mesh, mk_pipeline


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's tensors here are tiny: one intra-op thread, so that the
    workers of a parallel test run do not oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

MU64 = 1 << 61
NP_DTYPE = {32: np.int32, 64: np.int64}
# (N, k, l, log2 Bg, bits): the 16-party gadget, the 256-party one, two output
# blocks (nb = 2), and the single-key Bg = 2^10 shape of tfhe_80
GEOMETRIES = {"N64_l1_Bg26_64": (64, 1, 1, 26, 64), "N64_l2_Bg18_64": (64, 1, 2, 18, 64),
              "N256_l1_Bg26_64": (256, 1, 1, 26, 64), "N64_l2_Bg10_32": (64, 1, 2, 10, 32)}
WIDE_SETS = ("mk_16party_3gen", "mk_32party_3gen", "mk_32party_3gen_for_fft", "mk_64party_3gen",
             "mk_64party_3gen_for_fft", "mk_128party_3gen", "mk_256party_3gen",
             "mk_512party_3gen")
MK_SETS = ("mk_2party_3gen", "mk_3party_3gen", "mk_4party_3gen", "mk_8party_3gen") + WIDE_SETS


def _rand(rng, shape, bits):
    lo, hi = -2**(bits - 1), 2**(bits - 1)
    return rng.integers(lo, hi, shape, dtype=np.int64).astype(NP_DTYPE[bits])


def _random_key(name, steps, seed):
    """A random expanded key of geometry ``name`` (the scan's arithmetic does
    not depend on the key being an encryption) in both of its layouts, its
    compact lines, and the two packages' geometries and gadget arguments."""
    N, k, l, lb, bits = GEOMETRIES[name]
    rng = np.random.default_rng(seed)
    geom = tfblock.fblock_geometry(steps, N, k, l, bits, 0)
    jgeom = jfblock.fblock_geometry(steps, N, k, l, bits, 0)
    assert geom == tuple(jgeom)
    samples = _rand(rng, (steps, l, k + 1, k + 1, N), bits)
    fb = tfblock.build_fblocks(samples, geom, "cpu")
    sel = torch.from_numpy(tfblock.build_sel(samples, geom))
    tg = tparams.TGswParams(l, lb, bits)
    assert tg.offset == jparams.TGswParams(l, lb, bits).offset
    return rng, geom, jgeom, fb, sel, (tg.decomp_length, tg.log2_base, tg.offset)


@pytest.mark.parametrize("lb", [8, 9, 10, 18, 26, 27])
def test_digits_to_i8_rows_equal_jax(lb):
    half = 1 << (lb - 1)
    d = np.random.default_rng(lb).integers(-half, half, (3, 2, 2, 64)).astype(np.int32)
    d[0, 0, 0, :6] = [-half, half - 1, 0, -1, 127, max(-129, -half)]  # limb carries at the edges
    want = jpoly.digits_to_i8_rows(jnp.asarray(d), lb)
    got = tpoly.digits_to_i8_rows(torch.from_numpy(d), lb)
    assert len(got) == len(want) == (1 if lb <= 8 else (lb + 8) // 8)
    for g, w in zip(got, want):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    total = sum(g.to(torch.int64) << (8 * m) for m, g in enumerate(got))
    np.testing.assert_array_equal(total.numpy(), d)
    # the carry between limbs is that of the general split
    ref = tpoly.limb_split_signed(torch.from_numpy(d), 32)
    for m, g in enumerate(got):
        assert torch.equal(g, ref[..., m])


def test_decompose_exactness_log2base_26():
    """Twin of tests/test_largeparty.py: the signed base-2^26 decomposition of
    64-bit values reconstructs within the rounding bound, equals JAX's digits,
    and its int8 limb rows recombine to the digits exactly."""
    tg = tparams.TGswParams(1, 26, 64)
    x = np.random.default_rng(0).integers(-2**63, 2**63, (4, 64), dtype=np.int64)
    digits = tpoly.decompose(torch.from_numpy(x), tg.decomp_length, tg.log2_base, tg.bits,
                             tg.offset)
    assert digits.dtype == torch.int32 and digits.shape == (4, 1, 64)
    np.testing.assert_array_equal(
        digits.numpy(), np.asarray(jpoly.decompose(jnp.asarray(x), 1, 26, 64, tg.offset)))
    d = digits.numpy().astype(np.int64)
    assert (np.abs(d) <= 2**25).all()
    err = x - (d[:, 0] << (64 - 26))
    assert (np.abs(err.astype(np.float64)) <= 2.0 ** (64 - 26 - 1)).all()
    rows = tpoly.digits_to_i8_rows(digits[:, None], tg.log2_base)
    got = sum(r.numpy().astype(np.int64) << (8 * m) for m, r in enumerate(rows))
    np.testing.assert_array_equal(got[:, 0], d)


@pytest.mark.parametrize("l,lb", [(1, 26), (2, 18), (1, 27), (4, 4)])
def test_decompose_int64_sign(l, lb):
    """The right shift of a negative int64 is arithmetic and masked: digits
    of values around the sign change and at both ends equal JAX's."""
    tg = tparams.TGswParams(l, lb, 64)
    edge = np.array([-2**63, -2**63 + 1, -1, 0, 1, 2**63 - 1, -(1 << 37), (1 << 37) - 1],
                    dtype=np.int64)
    x = np.concatenate([edge, np.random.default_rng(1).integers(-2**63, 2**63, 56,
                                                                dtype=np.int64)])[None]
    got = tpoly.decompose(torch.from_numpy(x), l, lb, 64, tg.offset)
    want = jpoly.decompose(jnp.asarray(x), l, lb, 64, jparams.TGswParams(l, lb, 64).offset)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.min() >= -(1 << (lb - 1)) and got.max() < 1 << (lb - 1)


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_contract_and_apply_fblock_equal_jax(name):
    bits = GEOMETRIES[name][4]
    rng, geom, jgeom, fb, _, args = _random_key(name, 2, 11)
    B = 3
    tdt, jdt = (torch.int32, jnp.int32) if bits == 32 else (torch.int64, jnp.int64)
    d8 = rng.integers(-128, 128, (B, geom.R, geom.N)).astype(np.int8)
    t = _rand(rng, (B, geom.C, geom.N), bits)
    fk = tfblock.to_kernel_layout(fb, geom)
    for s in range(2):
        jstep = jnp.asarray(fb[s].numpy())
        want = np.asarray(jfblock.contract_rows_fblock(jnp.asarray(d8), jstep, jgeom, jdt))
        for step in (fb[s], fk[s]):  # both layouts of the expanded key
            got = tfblock.contract_rows_fblock(torch.from_numpy(d8), step, geom, tdt)
            assert got.dtype == tdt
            np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(jfblock.apply_fblock(jnp.asarray(t), jstep, jgeom, *args))
        for step in (fb[s], fk[s]):
            got = tfblock.apply_fblock(torch.from_numpy(t), step, geom, *args)
            assert got.dtype == tdt
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(GEOMETRIES))
@pytest.mark.parametrize("init", ["acc", "stepvec"])
def test_wide_rotates_equal_jax(name, init):
    """``rotate`` and ``rotate_streamed`` take the torch-op scan for these
    geometries; both equal the JAX package's F-block scan, and launch nothing."""
    bits = GEOMETRIES[name][4]
    steps, B = 5, 3
    rng, geom, jgeom, fb, sel, args = _random_key(name, steps, 12)
    assert not cuda_rotate.takes_kernel_route(geom, args[1])
    bara = rng.integers(0, 2 * geom.N, (B, steps)).astype(np.int32)
    barb = rng.integers(-geom.N, geom.N, B).astype(np.int32)
    mu = MU64 if bits == 64 else 1 << 29
    acc0 = tfblock.stepvec_acc0(mu, torch.from_numpy(barb), geom)
    assert acc0.dtype == (torch.int64 if bits == 64 else torch.int32)
    if init == "acc":
        acc = _rand(rng, (B, geom.C, geom.N), bits)
        t_in, sv, j_in = torch.from_numpy(acc), None, jnp.asarray(acc)
    else:
        t_in, sv, j_in = None, (mu, torch.from_numpy(barb)), jnp.asarray(acc0.numpy())
    want = np.asarray(jfblock.blind_rotate_fblock(j_in, jnp.asarray(fb.numpy()),
                                                  jnp.asarray(bara), jgeom, *args))
    before = (cuda_rotate.blind_rotate_cuda.launches, cuda_rotate.blind_rotate_sel_cuda.launches)
    tb = torch.from_numpy(bara)
    for key in (fb, tfblock.to_kernel_layout(fb, geom)):
        got = cuda_rotate.rotate(t_in, key, tb, geom, *args, stepvec=sv)
        np.testing.assert_array_equal(got.numpy(), want)
    for key in (sel, tfblock.to_sel_kernel_layout(sel, geom)):
        got = cuda_rotate.rotate_streamed(t_in, key, tb, geom, *args, stepvec=sv)
        np.testing.assert_array_equal(got.numpy(), want)
    got = tfblock.blind_rotate_streamed(t_in, sel, tb, geom, *args, chunk=2, stepvec=sv)
    np.testing.assert_array_equal(got.numpy(), want)  # 5 steps in chunks of 2: a ragged last one
    assert (cuda_rotate.blind_rotate_cuda.launches,
            cuda_rotate.blind_rotate_sel_cuda.launches) == before
    if init == "acc" and bits == 64:
        jstream = jfblock.blind_rotate_streamed(j_in, jnp.asarray(sel.numpy()), jnp.asarray(bara),
                                                jgeom, *args, chunk=2, use_pallas=False)
        np.testing.assert_array_equal(np.asarray(jstream), want)


def test_reference_pallas_differs_at_wide_digits():
    """Why the port is held against the JAX package's F-block scan and not its
    Pallas route when Bg > 2^8 on the 32-bit torus: the Pallas kernel casts
    each digit to int8 (torus_fhe_tpu/ops/pallas_rotate.py:107,
    ``d.astype(jnp.int8)``) without a check, so at Bg = 2^10 its words differ
    from ``blind_rotate_fblock``'s, while at Bg = 2^8 they agree."""
    steps, B = 4, 3
    for lb, equal in ((8, True), (10, False)):
        rng, geom, jgeom, fb, _, _ = _random_key("N64_l2_Bg10_32", steps, 13)
        tg = jparams.TGswParams(2, lb, 32)
        args = (2, lb, tg.offset)
        acc = _rand(rng, (B, geom.C, geom.N), 32)
        bara = rng.integers(0, 2 * geom.N, (B, steps)).astype(np.int32)
        scan = np.asarray(jfblock.blind_rotate_fblock(jnp.asarray(acc), jnp.asarray(fb.numpy()),
                                                      jnp.asarray(bara), jgeom, *args))
        pal = np.asarray(blind_rotate_pallas(jnp.asarray(acc), jnp.asarray(fb.numpy()),
                                             jnp.asarray(bara), jgeom, *args, b_tile=8,
                                             interpret=True))
        port = tfblock.blind_rotate_fblock(torch.from_numpy(acc), fb, torch.from_numpy(bara),
                                           geom, *args).numpy()
        np.testing.assert_array_equal(port, scan)
        assert np.array_equal(pal, scan) == equal


# --- the 3gen wide set: JAX keys ------------------------------------------

WIDE_TEST = (8, 2**-13.52, 64, 1, 64, 1, 26, 2**-62.0, 4, 3, 2**-13.52, 2)


@pytest.fixture(scope="module")
def wide_world():
    """The wide test set of tests/test_mk3gen.py::test_wide_digit_fb64_exactness:
    JAX keys (fbstream form, raw samples kept), two encrypted batches, and the
    port's view of them."""
    wp = jparams.SchemeParams3Gen(*WIDE_TEST)
    sks = [jmk.mk_party_keygen(jax.random.PRNGKey(70 + p), wp) for p in range(2)]
    ck = jmk.mk_cloud_keygen(jax.random.PRNGKey(6), sks, wp, forms=("fbstream",),
                             keep_samples=True)
    keys = [sk.lwe for sk in sks]
    xs, ys = np.array([False, True, False, True]), np.array([True, True, False, False])
    cx = jmk.mk_encrypt(jax.random.PRNGKey(8), keys, jnp.asarray(xs), wp)
    cy = jmk.mk_encrypt(jax.random.PRNGKey(9), keys, jnp.asarray(ys), wp)
    tp = tparams.SchemeParams3Gen(*WIDE_TEST)
    tsks = bridge.mk_secret_keys_from_numpy(tp, [np.asarray(sk.lwe.key) for sk in sks],
                                            [np.asarray(sk.rlwe.key) for sk in sks], device="cpu")
    tck = bridge.mk_cloud_key_from_numpy(tp, np.asarray(ck.bk_samples), np.asarray(ck.ks_mat), 2,
                                         forms=("fbstream",), device="cpu")
    tcts = [bridge.mk_lwe_from_numpy(np.asarray(c.a), np.asarray(c.b), device="cpu")
            for c in (cx, cy)]
    return wp, ck, (cx, cy), (xs, ys), tp, tsks, tck, tcts


def test_wide_key_equals_jax(wide_world):
    wp, ck, _, _, tp, _, tck, _ = wide_world
    assert not keys3gen.mk_fb_supported(tp) and keys3gen.mk_fb_stream_supported(tp)
    geom = keys3gen.mk_fb64_geometry(tp, 2)
    assert geom == tuple(jkeys3.mk_fb64_geometry(wp, 2))
    assert geom.bits == 64 and len(geom.cols) == 16
    assert tck.bk_fb is None and tck.bk_fb_sel.shape == (16, 2, 128, 16)
    np.testing.assert_array_equal(tck.bk_fb_sel.numpy(), np.asarray(ck.bk_fb_sel))


@pytest.mark.parametrize("layout", ["lines", "compact_kernel_layout"])
def test_wide_fast_rotate_extract_equals_jax(wide_world, layout):
    """Twin of test_wide_digit_fb64_exactness, over both layouts of the lines."""
    wp, ck, _, _, tp, _, tck, _ = wide_world
    rng = np.random.default_rng(3)
    B, N = 3, wp.rlwe_polynomial_degree
    bara = rng.integers(0, 2 * N, (B, 2 * wp.lwe_size), dtype=np.int64).astype(np.int32)
    barb = rng.integers(0, 2 * N, (B,), dtype=np.int64).astype(np.int32)
    want = jboot3._fast_rotate_extract(ck, jnp.asarray(MU64, jnp.int64), jnp.asarray(bara),
                                       jnp.asarray(barb), B)
    if layout != "lines":
        geom = keys3gen.mk_fb64_geometry(tp, 2)
        tck = dataclasses.replace(tck, bk_fb_sel=tfblock.to_sel_kernel_layout(tck.bk_fb_sel, geom))
    before = (cuda_rotate.blind_rotate_cuda.launches, cuda_rotate.blind_rotate_sel_cuda.launches)
    got = boot3gen._fast_rotate_extract(tck, MU64, torch.from_numpy(bara),
                                        torch.from_numpy(barb), B)
    assert got.a.dtype == torch.int32 and got.a.shape == (B, N)
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    assert (cuda_rotate.blind_rotate_cuda.launches,
            cuda_rotate.blind_rotate_sel_cuda.launches) == before


@pytest.mark.parametrize("gate", ["nand", "and", "xor"])
def test_wide_gates_equal_jax(wide_world, gate):
    wp, ck, (cx, cy), (xs, ys), tp, tsks, tck, (tx, ty) = wide_world
    want = jgates3.BINARY_GATES[gate](ck, cx, cy)
    got = gates3gen.BINARY_GATES[gate](tck, tx, ty)
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    plain = {"nand": ~(xs & ys), "and": xs & ys, "xor": xs ^ ys}[gate]
    np.testing.assert_array_equal(mk.mk_decrypt([sk.lwe for sk in tsks], got).numpy(), plain)


# --- the port's own keys ---------------------------------------------------


@pytest.mark.parametrize("name", MK_SETS)
def test_every_3gen_set_builds_a_key_and_decrypts(name):
    """Each registry set's own gadget (l, Bg), keyswitch digits and noises at
    a shrunken n and N, two parties: keygen in the set's default form, then a
    NAND and an AND truth table."""
    full = tparams.PARAMETER_REGISTRY[name]()
    params = dataclasses.replace(full, lwe_size=8, rlwe_polynomial_degree=64)
    wide = name in WIDE_SETS
    assert keys3gen.mk_fb_supported(params) != wide
    forms = ("fbstream",) if wide else ("fblock",)
    g = torch.Generator().manual_seed(len(name))
    sks = [mk.mk_party_keygen(g, params, device="cpu") for _ in range(2)]
    ck = mk.mk_cloud_keygen(g, sks, params, device="cpu", forms=forms)
    l, ncols = params.gsw_decomp_length, 16 if wide else 8
    if wide:
        assert ck.bk_fb is None and ck.bk_fb_sel.shape == (16, 2 * l, 128, ncols)
    else:
        assert ck.bk_fb_sel is None and ck.bk_fb.shape == (16, 2 * 2 * l * 64, ncols * 64)
    keys = [sk.lwe for sk in sks]
    xs, ys = torch.tensor([False, False, True, True]), torch.tensor([False, True, False, True])
    cx, cy = mk.mk_encrypt(g, keys, xs, params), mk.mk_encrypt(g, keys, ys, params)
    assert torch.equal(mk.mk_decrypt(keys, gates3gen.mk_gate_nand(ck, cx, cy)), ~(xs & ys))
    assert torch.equal(mk.mk_decrypt(keys, gates3gen.mk_gate_and(ck, cx, cy)), xs & ys)


def test_wide_port_keys_truth_tables_and_chain():
    """The port's own key at the wide test set: every binary gate, MUX, and a
    NAND chain whose inputs are bootstrapped outputs."""
    params = tparams.SchemeParams3Gen(*WIDE_TEST)
    g = torch.Generator().manual_seed(31)
    sks = [mk.mk_party_keygen(g, params, device="cpu") for _ in range(2)]
    ck = mk.mk_cloud_keygen(g, sks, params, device="cpu",
                            forms=keys3gen.default_forms(params, 2))
    keys = [sk.lwe for sk in sks]
    xs = torch.tensor([False, False, False, False, True, True, True, True])
    ys = torch.tensor([False, False, True, True, False, False, True, True])
    zs = torch.tensor([False, True, False, True, False, True, False, True])
    cx, cy, cz = (mk.mk_encrypt(g, keys, v, params) for v in (xs, ys, zs))
    plain = {"nand": ~(xs & ys), "or": xs | ys, "and": xs & ys, "xor": xs ^ ys}
    for name, gate in gates3gen.BINARY_GATES.items():
        assert torch.equal(mk.mk_decrypt(keys, gate(ck, cx, cy)), plain[name]), name
    assert torch.equal(mk.mk_decrypt(keys, gates3gen.mk_gate_mux(ck, cx, cy, cz)),
                       torch.where(xs, ys, zs))
    c, want = cx, xs
    for _ in range(3):
        c, want = gates3gen.mk_gate_nand(ck, c, cy), ~(want & ys)
        assert torch.equal(mk.mk_decrypt(keys, c), want)


def test_keygen_noise_at_two_to_minus_62_is_not_rounded_away():
    """gsw_noise_stddev = 2^-62 on the 64-bit torus is about 4 units: the
    sampler must keep it (truncation toward zero takes a little off)."""
    g = torch.Generator().manual_seed(14)
    e = trng.gaussian_torus(g, 0, 2**-62.0, (100_000,), torch.int64)
    assert e.dtype == torch.int64
    std = e.double().std().item()
    assert 3.5 < std < 4.1 and abs(e.double().mean().item()) < 0.1
    assert (e != 0).float().mean() > 0.75


def test_registry_16party_key_shapes():
    """The 16-party key from its geometry, without allocating it."""
    p = tparams.mktfhe_parameters_16party_3gen()
    geom = keys3gen.mk_fb64_geometry(p, 16)
    assert (geom.n, geom.N, geom.R, geom.D, geom.bs, geom.nb) == (9440, 2048, 2, 32, 128, 16)
    assert geom.bits == 64 and len(geom.cols) == 16
    lines = (geom.n, geom.R, 2 * geom.N, len(geom.cols))  # build_sel's layout
    assert int(np.prod(lines)) == 1_237_319_680  # 1.24 GB
    assert geom.D * geom.R * geom.bs * len(geom.cols) * geom.bs == 16_777_216  # one expanded step
    d = torch.zeros((1, geom.R, 8), dtype=torch.int32)
    assert len(tpoly.digits_to_i8_rows(d, p.gsw_log2_base)) == 4  # limb blocks a step
    assert geom.R * geom.N * 128 * 128 == 2**26  # int32 sums stay exact
    K = geom.N * p.ks_decomp_length * ((1 << p.ks_log2_base) - 1)
    assert (K, 16 * (p.lwe_size + 1) * 4) == (57_344, 37_824)  # the keyswitch table, 2.17 GB


@pytest.mark.parametrize("name", WIDE_SETS)
def test_wide_sets_take_fbstream_only(name):
    p = tparams.PARAMETER_REGISTRY[name]()
    assert keys3gen.default_forms(p, p.max_parties) == ("fbstream",)
    assert not cuda_rotate.takes_kernel_route(keys3gen.mk_fb64_geometry(p, 2), p.gsw_log2_base)
    samples = np.zeros((2, p.gsw_decomp_length, 2, 2, 64), np.int64)
    tiny = dataclasses.replace(p, lwe_size=1, rlwe_polynomial_degree=64)
    with pytest.raises(ValueError, match="fbstream"):
        keys3gen.cloud_key_from_samples(tiny, samples, torch.zeros((8, 16), dtype=torch.int8), 2,
                                        forms=("fblock",), device="cpu")
    ck = keys3gen.cloud_key_from_samples(tiny, samples, torch.zeros((8, 16), dtype=torch.int8),
                                         2, forms=("fbstream",), device="cpu")
    assert ck.bk_fb_sel.shape == (2, 2 * p.gsw_decomp_length, 128, 16)


def test_pipeline_refuses_wide_sets():
    """The pipelined rotate rounds every key to its hi word, in the JAX
    package too: it serves the hi-word sets only."""
    params = tparams.SchemeParams3Gen(*WIDE_TEST)
    mesh = make_mesh(n_batch=1, n_party=2, devices=[torch.device("cpu")] * 2)
    samples = np.zeros((16, 1, 2, 2, 64), np.int64)
    with pytest.raises(NotImplementedError, match="hi-word sets only"):
        mk_pipeline.build_sharded_mk_sel(samples, params, 2, mesh)
    with pytest.raises(NotImplementedError, match="hi-word sets only"):
        mk_pipeline.mk_blind_rotate_pipelined(
            [torch.zeros((8, 2, 128, 8), dtype=torch.int8)] * 2,
            torch.zeros((4, 2, 8), dtype=torch.int32), torch.zeros(4, dtype=torch.int32),
            1 << 29, params, 2, mesh)


def test_wide_route_rejects_bad_arguments():
    _, geom, _, fb, sel, (l, lb, off) = _random_key("N64_l1_Bg26_64", 3, 15)
    acc = torch.zeros((2, geom.C, geom.N), dtype=torch.int64)
    bara = torch.zeros((2, 3), dtype=torch.int32)
    barb = torch.zeros(2, dtype=torch.int32)
    bad = [dict(acc=acc.to(torch.int32)),            # acc dtype against geom.bits
           dict(acc=acc[:, :1]),                     # acc shape
           dict(key=fb.to(torch.int32)),             # key dtype
           dict(key=fb[:, :-1]),                     # key shape
           dict(bara=bara[:, :-1]),                  # step count
           dict(bara=bara.to(torch.int64)),          # bara dtype
           dict(stepvec=(MU64, barb)),               # acc and stepvec both
           dict(acc=None, stepvec=(MU64, barb[:1])),  # barb shape
           dict(acc=None, stepvec=(1 << 63, barb)),  # mu beyond the torus
           dict(geom=geom._replace(bits=48)),        # no such torus
           dict(lb=40)]                              # digits beyond int32
    for case in bad:
        kw = dict(acc=acc, key=fb, bara=bara, geom=geom, lb=lb, stepvec=None)
        kw.update(case)
        with pytest.raises(ValueError):
            cuda_rotate.rotate(kw["acc"], kw["key"], kw["bara"], kw["geom"], l, kw["lb"], off,
                               stepvec=kw["stepvec"])
    with pytest.raises(ValueError):  # the expanded key is no compact one
        cuda_rotate.rotate_streamed(acc, fb, bara, geom, l, lb, off)
    with pytest.raises(ValueError, match="2\\^31"):  # limb-block sums beyond int32
        over = tfblock.fblock_geometry(1, 2**16, 1, 1, 64, 0)
        cuda_rotate.check_wide_args(None, torch.zeros((1, 1), dtype=torch.int8),
                                    torch.zeros((1, 1), dtype=torch.int32), over, 1, 26,
                                    (0, torch.zeros(1, dtype=torch.int32)), ((1,),))
    cuda_rotate.rotate_streamed(acc, sel, bara, geom, l, lb, off)  # and this one runs


# --- single key: Bg = 2^10 -------------------------------------------------


def test_tfhe_80_equals_jax_field_by_field():
    p, q = tparams.tfhe_parameters_80(), jparams.tfhe_parameters_80()
    assert dataclasses.asdict(p) == dataclasses.asdict(q)
    assert (p.lwe_size, p.rlwe_polynomial_degree, p.bs_decomp_length, p.bs_log2_base,
            p.rlwe_bits) == (500, 1024, 2, 10, 32)
    assert tparams.PARAMETER_REGISTRY["tfhe_80"]() == p
    assert p.tgsw.offset == q.tgsw.offset and p.tgsw.gadget_values == q.tgsw.gadget_values


def test_single_key_gate_bg_2_10_equals_jax_scan():
    """A single-key gate with Bg = 2^10 against the JAX gate on its scan
    backend (a conv-form key takes it by itself), word for word."""
    base = jparams.test_parameters(n=16, N=64)
    jp = jparams.SchemeParams(**{**base.__dict__, "bs_log2_base": 10})
    sk, ck = japi.make_key_pair(jax.random.PRNGKey(22), jp, forms=("conv",))
    assert ck.bootstrap_key.fb is None
    xs, ys = np.array([False, False, True, True]), np.array([False, True, False, True])
    cx = japi.encrypt(jax.random.PRNGKey(31), sk, jnp.asarray(xs))
    cy = japi.encrypt(jax.random.PRNGKey(32), sk, jnp.asarray(ys))
    tp = tparams.SchemeParams(**jp.__dict__)
    ks = ck.keyswitch_key
    tsk = bridge.secret_key_from_numpy(tp, np.asarray(sk.key.key), device="cpu")
    tck = bridge.cloud_key_from_numpy(tp, np.asarray(ck.bootstrap_key.samples), np.asarray(ks.mat),
                                      ks.n_in, ks.n_out, device="cpu")
    tx, ty = (bridge.lwe_from_numpy(np.asarray(c.a), np.asarray(c.b), device="cpu")
              for c in (cx, cy))
    for name in ("and", "nand", "xor"):
        want = jgates.BINARY_GATES[name](ck, cx, cy)
        got = gates.BINARY_GATES[name](tck, tx, ty)
        np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
        np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))
    np.testing.assert_array_equal(api.decrypt(tsk, gates.gate_and(tck, tx, ty)).numpy(), xs & ys)


def test_tfhe_80_gadget_port_keys_truth_table():
    """tfhe_80's own gadget, keyswitch digits and noises at a shrunken n, N."""
    params = dataclasses.replace(tparams.tfhe_parameters_80(), lwe_size=16,
                                 rlwe_polynomial_degree=64)
    g = torch.Generator().manual_seed(80)
    sk, ck = api.make_key_pair(g, params, device="cpu")
    xs, ys = torch.tensor([False, False, True, True]), torch.tensor([False, True, False, True])
    cx, cy = api.encrypt(g, sk, xs), api.encrypt(g, sk, ys)
    assert torch.equal(api.decrypt(sk, gates.gate_and(ck, cx, cy)), xs & ys)
    assert torch.equal(api.decrypt(sk, gates.gate_nand(ck, cx, cy)), ~(xs & ys))
    assert torch.equal(api.decrypt(sk, gates.gate_xor(ck, cx, cy)), xs ^ ys)

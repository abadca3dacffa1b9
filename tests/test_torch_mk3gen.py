"""The port's 3rd-gen (AKÖ) multikey path against the JAX package.

Parity: JAX makes the keys and ciphertexts (CPU, x64, as tests/test_mk3gen.py
does) and they cross to the port through ``torus_fhe_tpu_torch.bridge``. The
hi-word blind rotate, the extract, the keyswitch and the gates are exact
integer arithmetic mod 2^32, so the words must be equal. The port's own keys
use torch's RNG, so they are checked by decryption (truth tables), by the
common-public-key invariant, and by the samplers' statistics.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu import mk as jmk
from torus_fhe_tpu.core import params as jparams
from torus_fhe_tpu.mk import boot3gen as jboot3
from torus_fhe_tpu.mk import gates3gen as jgates3
from torus_fhe_tpu.mk import keys3gen as jkeys3
from torus_fhe_tpu.ops import fblock as jfblock
from torus_fhe_tpu.ops.pallas_rotate import blind_rotate_pallas
from torus_fhe_tpu_torch import bridge, mk
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.core import rng as trng
from torus_fhe_tpu_torch.mk import boot3gen, gates3gen, keys3gen
from torus_fhe_tpu_torch.ops import fblock as tfblock
from torus_fhe_tpu_torch.ops import hostmath

MU64 = 1 << 61  # encode_message(1, 8) on the 64-bit torus
MU32 = 1 << 29
PLAIN = {"nand": lambda a, b: ~(a & b), "or": lambda a, b: a | b,
         "and": lambda a, b: a & b, "xor": lambda a, b: a ^ b}

_WORLDS = {}


def _jax_world(parties):
    """JAX keys (fblock form, raw samples kept), three encrypted bit batches,
    and the port's view of them with both fast forms."""
    if parties not in _WORLDS:
        params = jparams.test_parameters_3gen(parties=parties, n=16, N=64)
        sks = [jmk.mk_party_keygen(jax.random.PRNGKey(40 + p), params) for p in range(parties)]
        ck = jmk.mk_cloud_keygen(jax.random.PRNGKey(5), sks, params, forms=("fblock",),
                                 keep_samples=True)
        lwe_keys = [sk.lwe for sk in sks]
        bits = [np.array([False, False, True, True, False, True, True, False]),
                np.array([False, True, False, True, True, True, False, False]),
                np.array([True, False, False, True, False, True, False, True])]
        cts = [jmk.mk_encrypt(jax.random.PRNGKey(60 + i), lwe_keys, jnp.asarray(b), params)
               for i, b in enumerate(bits)]
        tp = tparams.SchemeParams3Gen(**params.__dict__)
        tsks = bridge.mk_secret_keys_from_numpy(tp, [np.asarray(sk.lwe.key) for sk in sks],
                                                [np.asarray(sk.rlwe.key) for sk in sks],
                                                device="cpu")
        tck = bridge.mk_cloud_key_from_numpy(tp, np.asarray(ck.bk_samples),
                                             np.asarray(ck.ks_mat), parties,
                                             forms=("fblock", "fbstream"), device="cpu")
        tcts = [bridge.mk_lwe_from_numpy(np.asarray(c.a), np.asarray(c.b), device="cpu")
                for c in cts]
        _WORLDS[parties] = (params, sks, ck, cts, bits, tp, tsks, tck, tcts)
    return _WORLDS[parties]


def _jax_streamed_key(ck, params):
    """The JAX cloud key in its compact form only (as test_mk3gen.py makes it)."""
    geom = jkeys3.mk_fb_geometry(params, ck.parties)
    sel = jnp.asarray(jfblock.build_sel(
        jkeys3.hi_round_samples(np.asarray(ck.bk_samples)), geom))
    return jkeys3.MKCloudKey(None, ck.ks_mat, ck.parties, params, None, None, sel)


def _assert_same(t, j):
    np.testing.assert_array_equal(t.a.numpy(), np.asarray(j.a))
    np.testing.assert_array_equal(t.b.numpy(), np.asarray(j.b))


def _rotate_inputs(params, parties, B, seed):
    rng = np.random.default_rng(seed)
    N, steps = params.rlwe_polynomial_degree, parties * params.lwe_size
    acc = rng.integers(-2**31, 2**31, (B, 2, N), dtype=np.int64).astype(np.int32)
    bara = rng.integers(0, 2 * N, (B, steps), dtype=np.int64).astype(np.int32)
    barb = rng.integers(0, 2 * N, B, dtype=np.int64).astype(np.int32)
    return acc, bara, barb


@pytest.mark.parametrize("name", sorted(tparams.PARAMETER_REGISTRY))
def test_registry_equals_jax(name):
    p, q = tparams.PARAMETER_REGISTRY[name](), jparams.PARAMETER_REGISTRY[name]()
    assert type(p).__name__ == type(q).__name__
    assert dataclasses.asdict(p) == dataclasses.asdict(q)
    for sub in ("lwe", "rlwe", "tgsw", "ks"):
        assert dataclasses.asdict(getattr(p, sub)) == dataclasses.asdict(getattr(q, sub))
    assert p.tgsw.gadget_values == q.tgsw.gadget_values
    assert p.tgsw.offset == q.tgsw.offset
    if isinstance(p, tparams.SchemeParams3Gen):
        assert keys3gen.mk_fb_supported(p) == jkeys3.mk_fb_supported(q)
        assert keys3gen.mk_fb_geometry(p, 2) == tuple(jkeys3.mk_fb_geometry(q, 2))


def test_hi_round_and_build_sel_equal_jax():
    params, _, ck, *_, tp, _, tck, _ = _jax_world(2)
    samples = np.array(ck.bk_samples)
    samples[0, 0, 0, 0, :4] = [2**31 - 1, -2**31, 2**63 - 1, -2**63]  # rounding edges
    hi = keys3gen.hi_round_samples(samples)
    np.testing.assert_array_equal(hi, jkeys3.hi_round_samples(samples))
    geom = keys3gen.mk_fb_geometry(tp, 2)
    assert geom == tuple(jkeys3.mk_fb_geometry(params, 2)) and len(geom.cols) == 8
    np.testing.assert_array_equal(tfblock.build_sel(hi, geom),
                                  jfblock.build_sel(hi, jkeys3.mk_fb_geometry(params, 2)))
    np.testing.assert_array_equal(tck.bk_fb.numpy(), np.asarray(ck.bk_fb))


def test_expand_fblock_chunk_equals_jax():
    params, _, ck, *_, tp, _, tck, _ = _jax_world(2)
    geom = keys3gen.mk_fb_geometry(tp, 2)
    got = tfblock.expand_fblock_chunk(tck.bk_fb_sel[3:9], geom)
    want = jfblock.expand_fblock_chunk(jnp.asarray(tck.bk_fb_sel[3:9].numpy()),
                                       jkeys3.mk_fb_geometry(params, 2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), tck.bk_fb[3:9].numpy())


@pytest.mark.parametrize("init", ["acc", "stepvec"])
@pytest.mark.parametrize("chunk", [32, 12])  # 32 = all steps; 12: a ragged last chunk, which JAX pads
def test_blind_rotate_streamed_equals_jax(chunk, init):
    params, *_, tp, _, tck, _ = _jax_world(2)
    geom, jgeom = keys3gen.mk_fb_geometry(tp, 2), jkeys3.mk_fb_geometry(params, 2)
    tg = tparams.TGswParams(tp.gsw_decomp_length, tp.gsw_log2_base, 32)
    acc, bara, barb = _rotate_inputs(tp, 2, 3, 1)
    args = (tg.decomp_length, tg.log2_base, tg.offset)
    if init == "acc":
        t_in, j_in, t_sv, j_sv = torch.from_numpy(acc), jnp.asarray(acc), None, None
    else:
        t_in = j_in = None
        t_sv, j_sv = (MU32, torch.from_numpy(barb)), (MU32, jnp.asarray(barb))
    got = tfblock.blind_rotate_streamed(t_in, tck.bk_fb_sel, torch.from_numpy(bara), geom,
                                        *args, chunk=chunk, stepvec=t_sv)
    want = jfblock.blind_rotate_streamed(j_in, jnp.asarray(tck.bk_fb_sel.numpy()),
                                         jnp.asarray(bara), jgeom, *args, chunk=chunk,
                                         stepvec=j_sv, use_pallas=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full = tfblock.blind_rotate_fblock(t_in, tck.bk_fb, torch.from_numpy(bara), geom, *args,
                                       stepvec=t_sv)
    np.testing.assert_array_equal(got.numpy(), full.numpy())


def test_plain_rotate_equals_pallas_interpret():
    """The port's plain rotates over the mk geometry against the JAX Pallas
    kernel in interpret mode, on the expanded key of the same geometry."""
    params, _, ck, *_, tp, _, tck, _ = _jax_world(2)
    geom, jgeom = keys3gen.mk_fb_geometry(tp, 2), jkeys3.mk_fb_geometry(params, 2)
    tg = tparams.TGswParams(tp.gsw_decomp_length, tp.gsw_log2_base, 32)
    _, bara, barb = _rotate_inputs(tp, 2, 4, 2)
    args = (tg.decomp_length, tg.log2_base, tg.offset)
    pal = blind_rotate_pallas(None, ck.bk_fb, jnp.asarray(bara), jgeom, *args, b_tile=8,
                              stepvec=(MU32, jnp.asarray(barb)), interpret=True)
    got = tfblock.blind_rotate_streamed(None, tck.bk_fb_sel, torch.from_numpy(bara), geom,
                                        *args, stepvec=(MU32, torch.from_numpy(barb)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


@pytest.mark.parametrize("parties", [2, 3])
@pytest.mark.parametrize("form", ["fblock", "fbstream"])
def test_fast_rotate_extract_equals_jax(form, parties):
    params, _, ck, *_, tp, _, tck, _ = _jax_world(parties)
    _, bara, barb = _rotate_inputs(tp, parties, 4, 3)
    jck = ck if form == "fblock" else _jax_streamed_key(ck, params)
    tck1 = dataclasses.replace(tck, **({"bk_fb_sel": None} if form == "fblock"
                                       else {"bk_fb": None}))
    want = jboot3._fast_rotate_extract(jck, MU64, jnp.asarray(bara), jnp.asarray(barb), 4)
    got = boot3gen._fast_rotate_extract(tck1, MU64, torch.from_numpy(bara),
                                        torch.from_numpy(barb), 4)
    _assert_same(got, want)


def test_mk_keyswitch_equals_jax():
    params, _, ck, *_, tp, _, tck, _ = _jax_world(2)
    rng = np.random.default_rng(4)
    N = params.rlwe_polynomial_degree
    a = rng.integers(-2**31, 2**31, (5, N), dtype=np.int64).astype(np.int32)
    b = rng.integers(-2**31, 2**31, 5, dtype=np.int64).astype(np.int32)
    from torus_fhe_tpu.lwe import LweSample as JLwe
    from torus_fhe_tpu_torch.lwe import LweSample as TLwe

    want = jboot3.mk_keyswitch(ck, JLwe(jnp.asarray(a), jnp.asarray(b)))
    got = boot3gen.mk_keyswitch(tck, TLwe(torch.from_numpy(a), torch.from_numpy(b)))
    _assert_same(got, want)
    assert tck.ks_mat.shape[1] % 8 == 0  # padded for torch._int_mm


@pytest.mark.parametrize("gate", ["nand", "and", "or", "xor", "mux"])
def test_mk_gates_equal_jax(gate):
    """Both forms of the port's key give JAX's words (JAX on its expanded key)."""
    params, sks, ck, (x, y, z), (xb, yb, zb), tp, tsks, tck, (tx, ty, tz) = _jax_world(2)
    lwe_keys = [sk.lwe for sk in tsks]
    if gate == "mux":
        want = jgates3.mk_gate_mux(ck, x, y, z)
        run = lambda k: gates3gen.mk_gate_mux(k, tx, ty, tz)
        plain = np.where(xb, yb, zb)
    else:
        want = jgates3.BINARY_GATES[gate](ck, x, y)
        run = lambda k: gates3gen.BINARY_GATES[gate](k, tx, ty)
        plain = PLAIN[gate](xb, yb)
    for key in (dataclasses.replace(tck, bk_fb_sel=None), dataclasses.replace(tck, bk_fb=None)):
        got = run(key)
        _assert_same(got, want)
        np.testing.assert_array_equal(mk.mk_decrypt(lwe_keys, got).numpy(), plain)


def test_mk_samples_equal_jax():
    params, sks, ck, (x, y, _), *_, tsks, tck, (tx, ty, _) = _jax_world(2)
    jkeys, tkeys = [sk.lwe for sk in sks], [sk.lwe for sk in tsks]
    np.testing.assert_array_equal(mk.mk_lwe_phase(tx, tkeys).numpy(),
                                  np.asarray(jmk.mk_lwe_phase(x, jkeys)))
    for fn in ("nand", "xor"):
        _assert_same(gates3gen.BINARY_GATES_WB[fn](tck, tx, ty),
                     jgates3.BINARY_GATES_WB[fn](ck, x, y))
    _assert_same(gates3gen.mk_gate_constant(tck, torch.tensor([True, False])),
                 jgates3.mk_gate_constant(ck, jnp.asarray([True, False])))


# --- the port's own keys --------------------------------------------------

PARAMS = tparams.test_parameters_3gen(parties=2, n=16, N=64)


@pytest.fixture(scope="module")
def port_world():
    g = torch.Generator().manual_seed(77)
    sks = [mk.mk_party_keygen(g, PARAMS, device="cpu") for _ in range(2)]
    ck = mk.mk_cloud_keygen(g, sks, PARAMS, device="cpu", forms=("fblock", "fbstream"))
    return sks, ck, g


@pytest.mark.parametrize("form", ["fblock", "fbstream"])
def test_port_keys_gate_truth_tables(port_world, form):
    sks, ck, g = port_world
    ck = dataclasses.replace(ck, **({"bk_fb_sel": None} if form == "fblock" else {"bk_fb": None}))
    keys = [sk.lwe for sk in sks]
    xs = torch.tensor([False, False, False, False, True, True, True, True])
    ys = torch.tensor([False, False, True, True, False, False, True, True])
    zs = torch.tensor([False, True, False, True, False, True, False, True])
    cx, cy, cz = (mk.mk_encrypt(g, keys, v, PARAMS) for v in (xs, ys, zs))
    assert torch.equal(mk.mk_decrypt(keys, cx), xs)
    for name, gate in gates3gen.BINARY_GATES.items():
        assert torch.equal(mk.mk_decrypt(keys, gate(ck, cx, cy)), PLAIN[name](xs, ys)), name
        wb = gates3gen.BINARY_GATES_WB[name](ck, cx, cy)
        assert torch.equal(mk.mk_decrypt(keys, wb), PLAIN[name](xs, ys)), name
    # 3AND is -1/4 + x + y + z, as in the JAX package: on three false inputs
    # the phase -5/8 wraps to +3/8 and decrypts True, so that row is left out
    rows = xs | ys | zs
    got3 = mk.mk_decrypt(keys, gates3gen.mk_gate_3and(ck, cx, cy, cz))
    assert torch.equal(got3[rows], (xs & ys & zs)[rows]) and bool(got3[~rows].all())
    assert torch.equal(mk.mk_decrypt(keys, gates3gen.mk_gate_not(ck, cx)), ~xs)
    assert torch.equal(mk.mk_decrypt(keys, gates3gen.mk_gate_mux(ck, cx, cy, cz)),
                       torch.where(xs, ys, zs))
    const = gates3gen.mk_gate_constant(ck, torch.tensor([True, False]))
    assert torch.equal(mk.mk_decrypt(keys, const), torch.tensor([True, False]))
    # bootstrapped outputs feed further gates, in any leading batch shape
    c, want = cx, xs
    for _ in range(3):
        c, want = gates3gen.mk_gate_nand(ck, c, cy), ~(want & ys)
        assert torch.equal(mk.mk_decrypt(keys, c), want)
    grid = gates3gen.mk_gate_and(ck, *(mk.MKLweSample(t.a.reshape(2, 4, 2, -1),
                                                      t.b.reshape(2, 4)) for t in (cx, cy)))
    assert grid.a.shape == (2, 4, 2, PARAMS.lwe_size)
    assert torch.equal(mk.mk_decrypt(keys, grid).reshape(-1), xs & ys)


def test_three_party_port_keys():
    params = tparams.test_parameters_3gen(parties=3, n=16, N=64)
    g = torch.Generator().manual_seed(5)
    sks = [mk.mk_party_keygen(g, params, device="cpu") for _ in range(3)]
    ck = mk.mk_cloud_keygen(g, sks, params, device="cpu", forms=("fbstream",))
    assert ck.bk_fb is None and ck.bk_fb_sel.shape == (48, 4, 128, 8)
    keys = [sk.lwe for sk in sks]
    xs, ys = torch.tensor([False, False, True, True]), torch.tensor([False, True, False, True])
    cx, cy = mk.mk_encrypt(g, keys, xs, params), mk.mk_encrypt(g, keys, ys, params)
    assert torch.equal(mk.mk_decrypt(keys, gates3gen.mk_gate_nand(ck, cx, cy)), ~(xs & ys))


def test_int_encrypt_decrypt(port_world):
    sks, _, g = port_world
    keys = [sk.lwe for sk in sks]
    vals = torch.tensor([7, -3, 0, -128, 127])
    ct = mk.mk_int_encrypt(g, keys, vals, 8, PARAMS)
    assert ct.a.shape == (8, 5, 2, PARAMS.lwe_size)
    np.testing.assert_array_equal(mk.mk_int_decrypt(keys, ct, 8), vals.numpy())


def test_common_public_key_is_a_sum_encryption():
    """b - (sum_p s_p) (*) a must be small noise."""
    g = torch.Generator().manual_seed(3)
    sks = [mk.mk_party_keygen(g, PARAMS, device="cpu") for _ in range(3)]
    crp = mk.gen_crp(g, PARAMS)
    assert crp.a.dtype == torch.int64 and torch.equal(crp.a[0], crp.a[1])
    common = mk.common_public_key([mk.public_keygen(g, sk.rlwe, crp, PARAMS) for sk in sks])
    s_total = sum(sk.rlwe.key[0].numpy() for sk in sks)
    prod = hostmath.negacyclic_polymul_host(s_total, crp.a.numpy(), 64)
    noise = (common.b.numpy() - prod).astype(np.float64) / 2.0**64
    assert 0 < np.abs(noise).max() < 1e-6


def test_negative_binary_frequencies():
    g = torch.Generator().manual_seed(11)
    x = trng.negative_binary(g, (400_000,))
    assert x.dtype == torch.int32 and set(x.unique().tolist()) == {-1, 0, 1}
    w = trng.NEGATIVE_BINARY_WEIGHT
    sd = (w * (1 - w) / x.numel()) ** 0.5
    for v in (-1, 1):
        assert abs((x == v).double().mean().item() - w) < 5 * sd
    key = mk.mk_party_keygen(g, tparams.mktfhe_parameters_2party_3gen(), device="cpu").rlwe.key
    assert key.shape == (1, 1024) and key.min() == -1 and key.max() == 1


def test_int64_torus_samplers():
    """The 64-bit samplers the 3gen keygen uses: range, mean and stddev."""
    g = torch.Generator().manual_seed(12)
    u = trng.uniform_torus(g, (200_000,), torch.int64).double() / 2.0**64
    assert u.min() >= -0.5 and u.max() < 0.5 and u.max() - u.min() > 0.999
    assert abs(u.mean().item()) < 5 * (1 / 12 / u.numel()) ** 0.5
    assert abs(u.std().item() - 12 ** -0.5) < 0.002
    # the low word is drawn too: not all multiples of 2^32
    raw = trng.uniform_torus(g, (1000,), torch.int64)
    assert ((raw & 0xFFFFFFFF) != 0).float().mean() > 0.99
    sigma = 2**-30.70
    e = trng.gaussian_torus(g, 5 << 40, sigma, (200_000,), torch.int64)
    assert e.dtype == torch.int64
    d = (e - (5 << 40)).double() / 2.0**64
    assert abs(d.mean().item()) < 5 * sigma / d.numel() ** 0.5
    assert abs(d.std().item() / sigma - 1) < 0.02


def test_default_forms_and_unported_routes():
    assert keys3gen.default_forms(tparams.mktfhe_parameters_2party_3gen(), 2) == ("fblock",)
    for name, parties in (("mk_4party_3gen", 4), ("mk_8party_3gen", 8)):
        p = tparams.PARAMETER_REGISTRY[name]()
        assert keys3gen.default_forms(p, parties) == ("fbstream",)
    big = tparams.mktfhe_parameters_16party_3gen()
    assert not keys3gen.mk_fb_supported(big)
    assert keys3gen.default_forms(big, 16) == ("fbstream",)
    g = torch.Generator().manual_seed(0)
    tiny_wide = tparams.SchemeParams3Gen(**{**PARAMS.__dict__, "gsw_decomp_length": 1,
                                            "gsw_log2_base": 26})
    sks = [mk.mk_party_keygen(g, tiny_wide, device="cpu") for _ in range(2)]
    # a wide-digit set builds its key in the compact form of the raw 64-bit
    # samples (16 limb columns) and refuses the hi-word expanded form
    ck = mk.mk_cloud_keygen(g, sks, tiny_wide, device="cpu",
                            forms=keys3gen.default_forms(tiny_wide, 2))
    assert ck.bk_fb is None and ck.bk_fb_sel.shape == (32, 2, 128, 16)
    with pytest.raises(ValueError, match="fbstream"):
        mk.mk_cloud_keygen(g, sks, tiny_wide, device="cpu", forms=("fblock",))
    fake = keys3gen.MKCloudKey(torch.zeros((8, 8), dtype=torch.int8), 2, tiny_wide)
    with pytest.raises(ValueError, match="fbstream"):  # a wide key without its lines
        boot3gen._fast_rotate_extract(fake, MU64, torch.zeros((1, 32), dtype=torch.int32),
                                      torch.zeros(1, dtype=torch.int32), 1)
    # "conv" is the exact route (the raw samples' lines), asked for alone at a hi-word set
    one = [mk.mk_party_keygen(g, PARAMS, device="cpu")]
    exact = mk.mk_cloud_keygen(g, one, PARAMS, device="cpu", forms=("conv",))
    assert exact.exact and exact.bk_fb is None and exact.bk_fb_sel.shape[-1] == 16
    with pytest.raises(ValueError, match="conv"):
        mk.mk_cloud_keygen(g, one, PARAMS, device="cpu", forms=("conv", "fbstream"))
    assert boot3gen.hi_word(MU64) == MU32 and boot3gen.hi_word(MU32) == MU32

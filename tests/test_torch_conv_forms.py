"""The conv forms of the multikey keys against the JAX package: the CCS and
KMS conv routes and the 3gen ``"scan"`` switch.

Parity: JAX makes the keys in both forms (conv + fb) and the ciphertexts on
the CPU (x64); they cross to the port through ``bridge.py``. JAX's conv
route is its scan over the packed kernels, taken when the key holds no
lines; the port's is the exact digit-side Toeplitz product over the same
kernels. Both, and the port's fb route on the same key, are exact integer
arithmetic (mod 2^32 for CCS, mod 2^64 in KMS's ring), so every word must
be equal: tolerance 0. KMS's gsw product at these sets has R * N = 6 * 64
terms a limb sum, far inside the int32 sums of JAX's product, so its words
are those of the port's int64 sums. The packed kernels are held byte for
byte against JAX's, also where the port builds them from the lines.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu import mk as jmk
from torus_fhe_tpu.boot import bootstrap as jboot
from torus_fhe_tpu.core import params as jparams
from torus_fhe_tpu.mk import ccs as jccs
from torus_fhe_tpu.mk import gates3gen as jgates3
from torus_fhe_tpu.mk import kms as jkms
from torus_fhe_tpu.mk.samples import mk_encrypt as j_mk_encrypt
from torus_fhe_tpu.utils import serialize as jser
from torus_fhe_tpu_torch import bridge, mk
from torus_fhe_tpu_torch.boot import bootstrap
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.lwe import LweKey
from torus_fhe_tpu_torch.mk import ccs, gates3gen, kms
from torus_fhe_tpu_torch.utils import serialize as tser

XS = np.array([False, False, True, True, False, True])
YS = np.array([False, True, False, True, True, False])
LINES = {"ccs": ("d_sel", "f0_sel", "f1_sel", "pk_fb", "sk_fb"), "kms": ("gsw_sel",)}
KERNS = {"ccs": ("d_kern", "f0_kern", "f1_kern"), "kms": ("gsw_kern",)}
SCHEMES = {
    "ccs": dict(jmod=jccs, tmod=ccs, params=jparams.test_parameters_ccs, tcls=tparams.SchemeParamsCCS,
                jkeygen=jccs.ccs_party_keygen, jcloud=jccs.ccs_cloud_keygen,
                tkeygen=ccs.ccs_party_keygen, tcloud=ccs.ccs_cloud_keygen,
                bridge=bridge.ccs_cloud_key_from_numpy, jsave=jser.save_ccs_cloud_key,
                tsave=tser.save_ccs_cloud_key, tload=tser.load_ccs_cloud_key,
                jload=jser.load_ccs_cloud_key),
    "kms": dict(jmod=jkms, tmod=kms, params=jparams.test_parameters_kms, tcls=tparams.SchemeParamsKMS,
                jkeygen=jkms.kms_party_keygen, jcloud=jkms.kms_cloud_keygen,
                tkeygen=kms.kms_party_keygen, tcloud=kms.kms_cloud_keygen,
                bridge=bridge.kms_cloud_key_from_numpy, jsave=jser.save_kms_cloud_key,
                tsave=tser.save_kms_cloud_key, tload=tser.load_kms_cloud_key,
                jload=jser.load_kms_cloud_key),
}
_WORLDS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fields_of(ck, drop=()) -> dict:
    return {f.name: np.asarray(getattr(ck, f.name)) for f in dataclasses.fields(ck)
            if f.name not in ("parties", "params", *drop) and getattr(ck, f.name) is not None}


def without(ck, names):
    return dataclasses.replace(ck, **{n: None for n in names})


def world(scheme, parties):
    """JAX keys in both forms, its conv-only twin, two bit batches, and the
    port's keys in each form (conv: JAX's kernels as they are)."""
    if (scheme, parties) not in _WORLDS:
        s = SCHEMES[scheme]
        params = s["params"](parties=parties, n=16, N=64)
        sks = [s["jkeygen"](jax.random.PRNGKey(40 + p), params) for p in range(parties)]
        ck = s["jcloud"](jax.random.PRNGKey(41), sks, params, forms=("conv", "fb"))
        keys = [sk.lwe for sk in sks]
        cts = [j_mk_encrypt(jax.random.PRNGKey(42 + i), keys, jnp.asarray(v), params)
               for i, v in enumerate((XS, YS))]
        tp = s["tcls"](**dataclasses.asdict(params))
        fb = s["bridge"](tp, parties, device="cpu", **fields_of(ck))
        conv = s["bridge"](tp, parties, device="cpu", forms=("conv",), **fields_of(ck))
        tcts = [bridge.mk_lwe_from_numpy(np.asarray(c.a), np.asarray(c.b), device="cpu")
                for c in cts]
        _WORLDS[scheme, parties] = (params, ck, without(ck, LINES[scheme]), cts, tp, fb, conv,
                                    tcts, keys)
    return _WORLDS[scheme, parties]


def assert_same(t, j):
    np.testing.assert_array_equal(t.a.numpy(), np.asarray(j.a))
    np.testing.assert_array_equal(t.b.numpy(), np.asarray(j.b))


def rand_acc(rng, shape, bits):
    if bits == 32:
        return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    return rng.integers(-2**63, 2**63 - 1, shape, dtype=np.int64, endpoint=True)


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_conv_kernels_byte_equal_jax(scheme):
    """The conv form taken as it is, and built from the lines alone (no
    kernel field), equal JAX's packed kernels byte for byte; the fb form
    built from the kernels alone equals JAX's lines."""
    _, ck, _, _, tp, fb, conv, _, _ = world(scheme, 2)
    bridge_fn = SCHEMES[scheme]["bridge"]
    from_lines = bridge_fn(tp, 2, device="cpu", forms=("conv",),
                           **fields_of(ck, drop=KERNS[scheme]))
    from_kerns = bridge_fn(tp, 2, device="cpu", forms=("fb",), **fields_of(ck, drop=LINES[scheme]))
    for name in KERNS[scheme]:
        for key in (conv, from_lines):
            np.testing.assert_array_equal(getattr(key, name).numpy(), np.asarray(getattr(ck, name)))
        assert getattr(fb, name) is None
    for name in LINES[scheme][:3]:
        np.testing.assert_array_equal(getattr(from_kerns, name).numpy(),
                                      np.asarray(getattr(ck, name)))
        assert getattr(conv, name) is None


@pytest.mark.parametrize("parties", [2, 3])
def test_ccs_blind_rotate_and_uni_product_equal_jax(parties):
    params, ck, _, _, tp, fb, conv, _, _ = world("ccs", parties)
    rng = np.random.default_rng(parties)
    N, n = 64, params.lwe_size
    acc = rand_acc(rng, (4, parties + 1, N), 32)
    bara = rng.integers(0, 2 * N, (4, parties * n), dtype=np.int64).astype(np.int32)
    for s in (0, parties * n - 1):
        onehot = np.eye(parties, dtype=np.int32)[s // n]
        want = jccs.uni_product(jnp.asarray(acc), ck.d_kern[s], ck.f0_kern[s], ck.f1_kern[s],
                                ck.pk_kern, ck.sk_kern, jnp.asarray(onehot), params.tgsw)
        got = ccs.uni_product(torch.from_numpy(acc), conv.d_kern[s], conv.f0_kern[s],
                              conv.f1_kern[s], conv.pk_kern, conv.sk_kern,
                              torch.from_numpy(onehot), tp.tgsw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    want = jccs.ccs_blind_rotate(jnp.asarray(acc), ck, jnp.asarray(bara))
    got = ccs.ccs_blind_rotate(torch.from_numpy(acc), conv, torch.from_numpy(bara))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got_fb = ccs.ccs_blind_rotate_fb(torch.from_numpy(acc), fb, torch.from_numpy(bara))
    np.testing.assert_array_equal(got_fb.numpy(), np.asarray(want))


@pytest.mark.parametrize("scheme,parties,fast", [("ccs", 2, True), ("ccs", 3, True),
                                                 ("kms", 2, True), ("kms", 2, False),
                                                 ("kms", 3, True), ("kms", 3, False)])
def test_nand_conv_route_equal_jax_and_fb_route(scheme, parties, fast):
    """JAX's NAND on its conv-only key (its conv route) == the port's on
    the conv form == the port's on the fb form; it decrypts."""
    _, _, jconv, (cx, cy), _, fb, conv, (tx, ty), keys = world(scheme, parties)
    s = SCHEMES[scheme]
    args = () if scheme == "ccs" else (fast,)
    want = s["jmod"].mk_gate_nand(jconv, cx, cy, *args)
    for key in (conv, fb):
        assert_same(s["tmod"].mk_gate_nand(key, tx, ty, *args), want)
    tkeys = [LweKey(torch.tensor(np.asarray(k.key))) for k in keys]
    got = mk.mk_decrypt(tkeys, s["tmod"].mk_gate_nand(conv, tx, ty, *args))
    np.testing.assert_array_equal(got.numpy(), ~(XS & YS))


@pytest.mark.parametrize("fast", [True, False])
def test_kms_rotate_conv_equal_jax(fast):
    """The KMS blind rotate alone, on a random test vector: JAX's conv scans
    (the single rotate and the TLev rotates) == the port's == the port's
    lines."""
    params, _, jconv, _, tp, fb, conv, _, _ = world("kms", 2)
    rng = np.random.default_rng(7 + fast)
    N, n = 64, params.lwe_size
    acc = np.zeros((3, 3, N), np.int64)
    acc[:, 2] = rand_acc(rng, (3, N), 64)
    bara = rng.integers(0, 2 * N, (3, 2, n), dtype=np.int64).astype(np.int32)
    want = jkms.kms_blind_rotate(jnp.asarray(acc), jconv, jnp.asarray(bara), fast)
    for key in (conv, fb):
        got = kms.kms_blind_rotate(torch.from_numpy(acc), key, torch.from_numpy(bara), fast)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_port_keygen_both_forms(scheme):
    """One port keygen with forms=("fb", "conv"): the two routes give the
    same words and the NAND decrypts; the conv form equals the packing of
    the lines' torus values."""
    s = SCHEMES[scheme]
    tp = s["tcls"](**dataclasses.asdict(s["params"](parties=2, n=16, N=64)))
    gen = torch.Generator().manual_seed(9)
    sks = [s["tkeygen"](gen, tp, device="cpu") for _ in range(2)]
    both = s["tcloud"](gen, sks, tp, device="cpu", forms=("fb", "conv"))
    conv = without(both, LINES[scheme])
    keys = [sk.lwe for sk in sks]
    cx, cy = (mk.mk_encrypt(gen, keys, torch.from_numpy(v), tp) for v in (XS, YS))
    out = s["tmod"].mk_gate_nand(conv, cx, cy)
    assert_same(out, s["tmod"].mk_gate_nand(both, cx, cy))
    np.testing.assert_array_equal(mk.mk_decrypt(keys, out).numpy(), ~(XS & YS))
    fields = {k: v.numpy() for k, v in vars(both).items() if isinstance(v, torch.Tensor)}
    rebuilt = s["bridge"](tp, 2, device="cpu", forms=("conv",),
                          **{k: v for k, v in fields.items() if k not in KERNS[scheme]})
    for name in KERNS[scheme]:
        assert torch.equal(getattr(rebuilt, name), getattr(both, name))


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_conv_only_key_files(scheme, tmp_path):
    """A JAX file holding only the conv form loads with forms=("conv",),
    its kernels as they are, and gives JAX's words; the port's conv file
    loads in JAX, whose conv route gives the port's words; the default load
    stays the fb form."""
    _, _, jconv, (cx, cy), _, _, conv, (tx, ty), _ = world(scheme, 2)
    s = SCHEMES[scheme]
    jpath, tpath = str(tmp_path / "jax.key"), str(tmp_path / "port.key")
    s["jsave"](jpath, jconv)
    loaded = s["tload"](jpath, device="cpu", forms=("conv",))
    for name in KERNS[scheme]:
        np.testing.assert_array_equal(getattr(loaded, name).numpy(), np.asarray(getattr(jconv, name)))
    for name in LINES[scheme]:
        assert getattr(loaded, name) is None
    want = s["jmod"].mk_gate_nand(jconv, cx, cy)
    assert_same(s["tmod"].mk_gate_nand(loaded, tx, ty), want)
    default = s["tload"](jpath, device="cpu")
    assert getattr(default, LINES[scheme][0]) is not None and getattr(default, KERNS[scheme][0]) is None
    s["tsave"](tpath, conv)
    jback = s["jload"](tpath)
    for name in LINES[scheme]:
        assert getattr(jback, name) is None
    assert_same(s["tmod"].mk_gate_nand(conv, tx, ty), s["jmod"].mk_gate_nand(jback, cx, cy))
    with pytest.raises(ValueError, match="forms"):
        s["tload"](jpath, device="cpu", forms=("fblock",))


@contextlib.contextmanager
def backends(port: str, jax_name: str):
    bootstrap.set_rotate_backend(port)
    jboot.set_rotate_backend(jax_name)
    try:
        yield
    finally:
        bootstrap.set_rotate_backend("auto")
        jboot.set_rotate_backend("auto")


def test_3gen_scan_switch_gives_jax_words():
    """set_rotate_backend("scan") sends JAX's 3gen gate off the hi-word
    route onto the raw 64-bit conv scan; the port's exact key gives those
    words under it (and under "auto"), and its hi-word key refuses it.
    The hi-word route's words differ from the scan's."""
    params = jparams.test_parameters_3gen(parties=2, n=16, N=64)
    sks = [jmk.mk_party_keygen(jax.random.PRNGKey(90 + p), params) for p in range(2)]
    ck = jmk.mk_cloud_keygen(jax.random.PRNGKey(92), sks, params, forms=("conv", "fblock"),
                             keep_samples=True)
    keys = [sk.lwe for sk in sks]
    cx, cy = (jmk.mk_encrypt(jax.random.PRNGKey(93 + i), keys, jnp.asarray(v), params)
              for i, v in enumerate((XS, YS)))
    tp = tparams.SchemeParams3Gen(**params.__dict__)
    samples, mat = np.asarray(ck.bk_samples), np.asarray(ck.ks_mat)
    exact = bridge.mk_cloud_key_from_numpy(tp, samples, mat, 2, forms=("conv",), device="cpu")
    fast = bridge.mk_cloud_key_from_numpy(tp, samples, mat, 2, forms=("fblock",), device="cpu")
    tx, ty = (bridge.mk_lwe_from_numpy(np.asarray(c.a), np.asarray(c.b), device="cpu")
              for c in (cx, cy))
    with backends("scan", "scan"):
        want = jgates3.mk_gate_and(ck, cx, cy)
        assert_same(gates3gen.mk_gate_and(exact, tx, ty), want)
        with pytest.raises(ValueError, match="scan"):
            gates3gen.mk_gate_and(fast, tx, ty)
    assert_same(gates3gen.mk_gate_and(exact, tx, ty), want)
    hi = gates3gen.mk_gate_and(fast, tx, ty)
    assert not np.array_equal(hi.a.numpy(), np.asarray(want.a))
    tkeys = [LweKey(torch.tensor(np.asarray(k.key))) for k in keys]
    for out in (hi, gates3gen.mk_gate_and(exact, tx, ty)):
        np.testing.assert_array_equal(mk.mk_decrypt(tkeys, out).numpy(), XS & YS)


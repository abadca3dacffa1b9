"""Key files of the port (torus_fhe_tpu_torch/utils/serialize.py) against the
JAX package's (torus_fhe_tpu/utils/serialize.py): the two read and write the
same ``.npz`` files, schema ``torus_fhe_tpu.v1``.

Each kind crosses both ways: a file written by the JAX package loads in the
port with word-equal arrays and gives word-equal gate outputs, and a file
written by the port loads with the JAX package's own loaders and does the
same. Keys are made by the JAX package (CPU, x64), from fixed seeds.
Tolerance: none, every comparison is word for word.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torus_fhe_tpu import mk as jmk
from torus_fhe_tpu.boot import api as japi
from torus_fhe_tpu.boot import bootstrap as jboot
from torus_fhe_tpu.boot import gates as jgates
from torus_fhe_tpu.core import params as jparams
from torus_fhe_tpu.mk import gates3gen as jgates3
from torus_fhe_tpu.threshold import shares as jsh
from torus_fhe_tpu.utils import serialize as jser
from torus_fhe_tpu_torch import bridge, mk
from torus_fhe_tpu_torch.boot import api, gates
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.mk import gates3gen, keys3gen
from torus_fhe_tpu_torch.threshold import shares as tsh
from torus_fhe_tpu_torch.utils import serialize as ser

PARAMS = jparams.test_parameters(n=16, N=64)
WIDE_TEST = (8, 2**-13.52, 64, 1, 64, 1, 26, 2**-62.0, 4, 3, 2**-13.52, 2)
MK_PARAMS = {"hi_word": lambda: jparams.test_parameters_3gen(2, n=16, N=64),
             "wide": lambda: jparams.SchemeParams3Gen(*WIDE_TEST)}


def _same(t, j):
    np.testing.assert_array_equal(t.a.numpy(), np.asarray(j.a))
    np.testing.assert_array_equal(t.b.numpy(), np.asarray(j.b))


def _jax_gate(fn, *args):
    """A JAX single-key gate on the F-block scan (the exact semantics)."""
    jboot.set_rotate_backend("fblock")
    try:
        return fn(*args)
    finally:
        jboot.set_rotate_backend("auto")


@pytest.fixture(scope="module")
def jax_single():
    sk, ck = japi.make_key_pair(jax.random.PRNGKey(0), PARAMS, forms=("conv", "fblock"))
    msgs = np.array([True, False, True, False])
    other = np.array([True, True, False, False])
    cx = japi.encrypt(jax.random.PRNGKey(1), sk, jnp.asarray(msgs))
    cy = japi.encrypt(jax.random.PRNGKey(2), sk, jnp.asarray(other))
    return sk, ck, (cx, cy), (msgs, other)


@pytest.fixture(scope="module")
def jax_mk():
    out = {}
    for name, make in MK_PARAMS.items():
        params = make()
        sks = [jmk.mk_party_keygen(jax.random.PRNGKey(60 + p), params) for p in range(2)]
        forms = ("conv", "fblock") if name == "hi_word" else ("fbstream",)
        ck = jmk.mk_cloud_keygen(jax.random.PRNGKey(61), sks, params, forms=forms,
                                 keep_samples=True)
        keys = [sk.lwe for sk in sks]
        xs, ys = np.array([False, True, False, True]), np.array([True, True, False, False])
        cx = jmk.mk_encrypt(jax.random.PRNGKey(8), keys, jnp.asarray(xs), params)
        cy = jmk.mk_encrypt(jax.random.PRNGKey(9), keys, jnp.asarray(ys), params)
        out[name] = (params, sks, ck, (cx, cy), (xs, ys))
    return out


def test_key_and_ciphertext_files_from_jax_load_in_the_port(tmp_path, jax_single):
    """Twin of tests/test_serialize.py::test_key_and_ciphertext_roundtrip,
    across the two packages."""
    sk, ck, (cx, cy), (msgs, other) = jax_single
    paths = [str(tmp_path / n) for n in ("secret.key", "cloud.key", "ct.data")]
    jser.save_secret_key(paths[0], sk)
    jser.save_cloud_key(paths[1], ck)
    jser.save_lwe(paths[2], cx)
    tsk = ser.load_secret_key(paths[0], device="cpu")
    tck = ser.load_cloud_key(paths[1], device="cpu")  # the file says conv + fblock
    tx = ser.load_lwe(paths[2], device="cpu")
    assert tsk.params == tparams.SchemeParams(**PARAMS.__dict__) == tck.params
    assert dataclasses.asdict(tsk.params) == dataclasses.asdict(PARAMS)
    np.testing.assert_array_equal(tsk.key.key.numpy(), np.asarray(sk.key.key))
    _same(tx, cx)
    np.testing.assert_array_equal(tck.bootstrap_key.samples.numpy(),
                                  np.asarray(ck.bootstrap_key.samples))
    np.testing.assert_array_equal(tck.bootstrap_key.fb.numpy(), np.asarray(ck.bootstrap_key.fb))
    ks = ck.keyswitch_key
    assert (tck.keyswitch_key.n_in, tck.keyswitch_key.n_out) == (ks.n_in, ks.n_out)
    assert tck.keyswitch_key.mat.shape[1] % 8 == 0  # padded again for torch._int_mm
    np.testing.assert_array_equal(tck.keyswitch_key.mat[:, :ks.mat.shape[1]].numpy(),
                                  np.asarray(ks.mat))
    np.testing.assert_array_equal(api.decrypt(tsk, tx).numpy(), msgs)
    ty = bridge.lwe_from_numpy(np.asarray(cy.a), np.asarray(cy.b), device="cpu")
    got = gates.gate_and(tck, tx, ty)
    _same(got, _jax_gate(jgates.gate_and, ck, cx, cy))
    np.testing.assert_array_equal(api.decrypt(tsk, got).numpy(), msgs & other)
    conv = ser.load_cloud_key(paths[1], forms=("conv",), device="cpu").bootstrap_key
    assert conv.fb is None  # conv builds the packed kernels, byte-equal to JAX's
    np.testing.assert_array_equal(conv.kernels.numpy(), np.asarray(ck.bootstrap_key.kernels))
    with pytest.raises(ValueError, match="builds"):
        ser.load_cloud_key(paths[1], forms=("pallas",), device="cpu")
    with pytest.raises(ValueError, match="secret_key"):
        ser.load_secret_key(paths[2], device="cpu")


def test_key_and_ciphertext_files_from_the_port_load_in_jax(tmp_path, jax_single):
    sk, ck, (cx, cy), (msgs, other) = jax_single
    tp = tparams.SchemeParams(**PARAMS.__dict__)
    ks = ck.keyswitch_key
    tsk = bridge.secret_key_from_numpy(tp, np.asarray(sk.key.key), device="cpu")
    tck = bridge.cloud_key_from_numpy(tp, np.asarray(ck.bootstrap_key.samples),
                                      np.asarray(ks.mat), ks.n_in, ks.n_out, device="cpu")
    tx = bridge.lwe_from_numpy(np.asarray(cx.a), np.asarray(cx.b), device="cpu")
    paths = [str(tmp_path / n) for n in ("secret.key", "cloud.key", "ct.data")]
    ser.save_secret_key(paths[0], tsk)
    ser.save_cloud_key(paths[1], tck)
    ser.save_lwe(paths[2], tx, params=tp)
    sk2 = jser.load_secret_key(paths[0])
    ck2 = jser.load_cloud_key(paths[1])  # the port records fblock
    cx2 = jser.load_lwe(paths[2])
    assert sk2.params == PARAMS and ck2.params == PARAMS
    np.testing.assert_array_equal(np.asarray(sk2.key.key), np.asarray(sk.key.key))
    np.testing.assert_array_equal(np.asarray(cx2.a), np.asarray(cx.a))
    np.testing.assert_array_equal(np.asarray(ck2.keyswitch_key.mat), np.asarray(ks.mat))  # unpadded
    assert ck2.bootstrap_key.kernels is None
    np.testing.assert_array_equal(np.asarray(ck2.bootstrap_key.fb), np.asarray(ck.bootstrap_key.fb))
    want = _jax_gate(jgates.gate_and, ck, cx, cy)
    got = _jax_gate(jgates.gate_and, ck2, cx2, cy)
    np.testing.assert_array_equal(np.asarray(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(np.asarray(japi.decrypt(sk2, got)), msgs & other)
    # and the port reads its own files: gates on the loaded key == on the saved one
    tck2 = ser.load_cloud_key(paths[1], device="cpu")
    ty = bridge.lwe_from_numpy(np.asarray(cy.a), np.asarray(cy.b), device="cpu")
    for a, b in zip(gates.gate_nand(tck2, ser.load_lwe(paths[2], device="cpu"), ty),
                    gates.gate_nand(tck, tx, ty)):
        assert torch.equal(a, b)
    kind, leaves, params = ser.load(paths[2])
    assert kind == "lwe" and params == tp and len(leaves) == 2  # a, then b


@pytest.mark.parametrize("name", list(MK_PARAMS))
def test_mk_cloud_key_file_from_jax_loads_in_the_port(tmp_path, jax_mk, name):
    """Twin of tests/test_serialize.py::test_mk_cloud_key_roundtrips (3gen),
    at a hi-word set and at the wide-digit one."""
    params, sks, ck, (cx, cy), (xs, ys) = jax_mk[name]
    path = str(tmp_path / "mk3gen.key")
    jser.save_mk_cloud_key(path, ck)
    tck = ser.load_mk_cloud_key(path, device="cpu")  # the file's forms, without conv
    assert tck.parties == 2 and dataclasses.asdict(tck.params) == dataclasses.asdict(params)
    np.testing.assert_array_equal(tck.bk_samples.numpy(), np.asarray(ck.bk_samples))
    cols = np.asarray(ck.ks_mat).shape[1]
    assert tck.ks_mat.shape[1] % 8 == 0
    np.testing.assert_array_equal(tck.ks_mat[:, :cols].numpy(), np.asarray(ck.ks_mat))
    if name == "hi_word":
        assert tck.bk_fb_sel is None
        np.testing.assert_array_equal(tck.bk_fb.numpy(), np.asarray(ck.bk_fb))
        both = ser.load_mk_cloud_key(path, forms=("fblock", "fbstream"), device="cpu")
        assert both.bk_fb is not None and both.bk_fb_sel.shape == (32, 4, 128, 8)
    else:
        assert tck.bk_fb is None
        np.testing.assert_array_equal(tck.bk_fb_sel.numpy(), np.asarray(ck.bk_fb_sel))
        with pytest.raises(ValueError, match="fbstream"):
            ser.load_mk_cloud_key(path, forms=("fblock",), device="cpu")
    tx, ty = (bridge.mk_lwe_from_numpy(np.asarray(c.a), np.asarray(c.b), device="cpu")
              for c in (cx, cy))
    got = gates3gen.mk_gate_nand(tck, tx, ty)
    _same(got, jgates3.mk_gate_nand(ck, cx, cy))
    tp = tparams.SchemeParams3Gen(**params.__dict__)
    tsks = bridge.mk_secret_keys_from_numpy(tp, [np.asarray(sk.lwe.key) for sk in sks],
                                            [np.asarray(sk.rlwe.key) for sk in sks], device="cpu")
    np.testing.assert_array_equal(mk.mk_decrypt([sk.lwe for sk in tsks], got).numpy(), ~(xs & ys))


@pytest.mark.parametrize("name", list(MK_PARAMS))
def test_mk_cloud_key_file_from_the_port_loads_in_jax(tmp_path, jax_mk, name):
    params, sks, ck, (cx, cy), (xs, ys) = jax_mk[name]
    tp = tparams.SchemeParams3Gen(**params.__dict__)
    forms = keys3gen.default_forms(tp, 2)
    tck = bridge.mk_cloud_key_from_numpy(tp, np.asarray(ck.bk_samples), np.asarray(ck.ks_mat), 2,
                                         forms=forms, device="cpu")
    path = str(tmp_path / "mk3gen.key")
    ser.save_mk_cloud_key(path, tck)
    ck2 = jser.load_mk_cloud_key(path)
    assert ck2.parties == 2 and ck2.params == params and ck2.bk_kernels is None
    np.testing.assert_array_equal(np.asarray(ck2.ks_mat), np.asarray(ck.ks_mat))  # unpadded
    np.testing.assert_array_equal(np.asarray(ck2.bk_samples), np.asarray(ck.bk_samples))
    if name == "hi_word":
        np.testing.assert_array_equal(np.asarray(ck2.bk_fb), np.asarray(ck.bk_fb))
    else:
        np.testing.assert_array_equal(np.asarray(ck2.bk_fb_sel), np.asarray(ck.bk_fb_sel))
    want, got = jgates3.mk_gate_nand(ck, cx, cy), jgates3.mk_gate_nand(ck2, cx, cy)
    np.testing.assert_array_equal(np.asarray(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(np.asarray(got.b), np.asarray(want.b))
    # the port's own round trip: the gate on the loaded key == on the saved one
    tck2 = ser.load_mk_cloud_key(path, device="cpu")
    tx, ty = (bridge.mk_lwe_from_numpy(np.asarray(c.a), np.asarray(c.b), device="cpu")
              for c in (cx, cy))
    for a, b in zip(gates3gen.mk_gate_nand(tck2, tx, ty), gates3gen.mk_gate_nand(tck, tx, ty)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="keep_samples"):
        ser.save_mk_cloud_key(path, dataclasses.replace(tck, bk_samples=None))


def test_share_set_files_cross_both_ways(tmp_path):
    """Twin of tests/test_serialize.py::test_share_set_roundtrip."""
    key = np.random.default_rng(0).integers(0, 2, (1, 32)).astype(np.int32)
    jrepo = jsh.share_secret_streaming(key, 2, 4, jax.random.PRNGKey(2))
    jser.save_share_set(str(tmp_path / "jax.npz"), jrepo)
    got = ser.load_share_set(str(tmp_path / "jax.npz"))
    assert isinstance(got, tsh.ShareSet) and (got.t, got.p) == (2, 4)
    assert sorted(got.shares) == sorted(jrepo.shares)
    for k, v in jrepo.shares.items():
        np.testing.assert_array_equal(got.shares[k], np.asarray(v))
    trepo = tsh.share_secret(key, 2, 4, torch.Generator().manual_seed(3))
    ser.save_share_set(str(tmp_path / "port.npz"), trepo)
    back = jser.load_share_set(str(tmp_path / "port.npz"))
    again = ser.load_share_set(str(tmp_path / "port.npz"))
    assert (back.t, back.p) == (2, 4) and sorted(back.shares) == sorted(trepo.shares)
    for k, v in trepo.shares.items():
        np.testing.assert_array_equal(np.asarray(back.shares[k]), v)
        np.testing.assert_array_equal(again.shares[k], v)


def test_legacy_conv_only_files_raise(tmp_path, jax_single, jax_mk):
    """A file with conv kernels and no raw samples, named or positional,
    names its reason; the port has no conv backend to load it into."""
    _, ck, _, _ = jax_single
    ks = ck.keyswitch_key
    named = str(tmp_path / "named.key")
    jser.save_named(named, "cloud_key",
                    {"ks": ks.mat, "ks_meta": np.array([ks.n_in, ks.n_out]),
                     "bk": ck.bootstrap_key.kernels}, params=PARAMS, extra_meta={"forms": ["conv"]})
    positional = str(tmp_path / "positional.key")
    jser.save(positional, "cloud_key", {"bk": ck.bootstrap_key.kernels, "ks": ks.mat,
                                        "ks_meta": np.array([ks.n_in, ks.n_out])}, params=PARAMS)
    assert jser.load_cloud_key(positional).bootstrap_key.kernels is not None  # JAX reads it
    for path in (named, positional):
        with pytest.raises(ValueError, match="conv kernels"):
            ser.load_cloud_key(path, device="cpu")
    mk_ck = jax_mk["hi_word"][2]
    mk_path = str(tmp_path / "mk.key")
    jser.save_mk_cloud_key(mk_path, dataclasses.replace(mk_ck, bk_samples=None))
    with pytest.raises(ValueError, match="conv kernels"):
        ser.load_mk_cloud_key(mk_path, device="cpu")
    with pytest.raises(ValueError, match="mk_cloud_key"):
        ser.load_mk_cloud_key(named, device="cpu")


@pytest.mark.parametrize("name", ["tfhe_80", "tfhe_128_tpu_fast", "mk_16party_3gen",
                                  "mk_8party_3gen"])
def test_params_json_round_trips_exactly(tmp_path, name):
    """The parameter set is stored as class name and field values; floats
    such as 2**-15.34 come back bit-equal, in both packages, and the field
    the port keeps only for this (bk_mask_quantum_bits) is read."""
    p, q = tparams.PARAMETER_REGISTRY[name](), jparams.PARAMETER_REGISTRY[name]()
    path = str(tmp_path / "p.npz")
    ser.save_named(path, "probe", {"x": np.arange(3), "none": None}, params=p,
                   extra_meta={"parties": 2})
    kind, arrs, got, extra = ser.load_named(path)
    assert (kind, list(arrs), extra) == ("probe", ["x"], {"parties": 2}) and got == p
    assert jser.load_named(path)[2] == q
    jser.save_named(path, "probe", {"x": np.arange(3)}, params=q)
    assert ser.load_named(path)[2] == p
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
    assert meta["schema"] == "torus_fhe_tpu.v1" and json.loads(meta["params"])["__class__"] == \
        type(p).__name__
    with pytest.raises(ValueError, match="positional"):
        ser.save(path, "probe", [np.arange(2)])
        ser.load_named(path)


@pytest.mark.parametrize("loader", ["load_secret_key", "load_cloud_key", "load_lwe",
                                    "load_mk_cloud_key"])
def test_loaders_default_to_the_card(tmp_path, jax_single, jax_mk, loader):
    """``device=None`` is the card, as at every entry point: without one the
    loader raises and names ``device="cpu"``; with ``device="cpu"`` it loads."""
    sk, ck, (cx, _), _ = jax_single
    path = str(tmp_path / "file.npz")
    {"load_secret_key": lambda: jser.save_secret_key(path, sk),
     "load_cloud_key": lambda: jser.save_cloud_key(path, ck),
     "load_lwe": lambda: jser.save_lwe(path, cx),
     "load_mk_cloud_key": lambda: jser.save_mk_cloud_key(path, jax_mk["hi_word"][2])}[loader]()
    load = getattr(ser, loader)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            load(path)
    got = load(path, device="cpu")
    leaf = {"load_secret_key": lambda k: k.key.key, "load_cloud_key": lambda k: k.keyswitch_key.mat,
            "load_lwe": lambda k: k.a, "load_mk_cloud_key": lambda k: k.ks_mat}[loader](got)
    assert leaf.device.type == "cpu"

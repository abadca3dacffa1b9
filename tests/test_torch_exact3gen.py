"""The port's exact 64-bit 3gen route at a hi-word set against the JAX
package's conv route.

JAX makes the keys in its ``conv`` form (CPU, x64) with the raw samples kept;
they cross through ``bridge.py`` and the port builds its ``"conv"`` key: the
compact lines of the raw 64-bit samples, not rounded to the hi word. Its
rotate is the exact 64-bit chain on the wide route and JAX's is the conv
scan; both are exact arithmetic mod 2^64, so the gate words must be equal.
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
from torus_fhe_tpu.utils import serialize as jser
from torus_fhe_tpu_torch import bridge
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.core.torus import decode_message
from torus_fhe_tpu_torch.mk import boot3gen, gates3gen, keys3gen
from torus_fhe_tpu_torch.ops import cuda_rotate
from torus_fhe_tpu_torch.utils import serialize as ser

PLAIN = {"nand": lambda a, b: ~(a & b), "or": lambda a, b: a | b,
         "and": lambda a, b: a & b, "xor": lambda a, b: a ^ b}
_WORLDS = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _world(parties):
    """JAX conv-form keys with their samples, two bit batches, and the
    port's exact key and ciphertexts."""
    if parties not in _WORLDS:
        params = jparams.test_parameters_3gen(parties=parties, n=16, N=64)
        sks = [jmk.mk_party_keygen(jax.random.PRNGKey(70 + p), params) for p in range(parties)]
        ck = jmk.mk_cloud_keygen(jax.random.PRNGKey(71), sks, params, forms=("conv",),
                                 keep_samples=True)
        keys = [sk.lwe for sk in sks]
        bits = [np.array([False, False, True, True, False, True]),
                np.array([False, True, False, True, True, False])]
        cts = [jmk.mk_encrypt(jax.random.PRNGKey(72 + i), keys, jnp.asarray(b), params)
               for i, b in enumerate(bits)]
        tp = tparams.SchemeParams3Gen(**params.__dict__)
        tck = bridge.mk_cloud_key_from_numpy(tp, np.asarray(ck.bk_samples), np.asarray(ck.ks_mat),
                                             parties, forms=("conv",), device="cpu")
        tkeys = bridge.mk_secret_keys_from_numpy(tp, [np.asarray(sk.lwe.key) for sk in sks],
                                                 [np.asarray(sk.rlwe.key) for sk in sks],
                                                 device="cpu")
        tcts = [bridge.mk_lwe_from_numpy(np.asarray(c.a), np.asarray(c.b), device="cpu")
                for c in cts]
        _WORLDS[parties] = (params, sks, ck, cts, bits, tp, tkeys, tck, tcts)
    return _WORLDS[parties]


def _assert_same(t, j):
    np.testing.assert_array_equal(t.a.numpy(), np.asarray(j.a))
    np.testing.assert_array_equal(t.b.numpy(), np.asarray(j.b))


@pytest.mark.parametrize("parties", [2, 3])
@pytest.mark.parametrize("gate", list(PLAIN))
def test_exact_gates_equal_jax_conv_route(parties, gate):
    """A gate over the port's conv key == the JAX package's conv scan, word
    for word, and decrypts to the truth table."""
    params, sks, ck, cts, bits, tp, tkeys, tck, tcts = _world(parties)
    assert tck.exact and tck.bk_fb is None and tck.bk_fb_sel.shape[-1] == 16
    want = getattr(jgates3, f"mk_gate_{gate}")(ck, cts[0], cts[1])
    got = gates3gen.BINARY_GATES[gate](tck, tcts[0], tcts[1])
    _assert_same(got, want)
    dec = jmk.mk_decrypt([sk.lwe for sk in sks], want)
    np.testing.assert_array_equal(np.asarray(dec), PLAIN[gate](bits[0], bits[1]))


@pytest.mark.parametrize("parties", [2, 3])
def test_exact_route_takes_the_wide_branch(parties, monkeypatch):
    """The exact key runs the 64-bit geometry with the full 64-bit mu, never
    the hi-word chain, and its extract equals JAX's rotate-extract."""
    params, sks, ck, cts, bits, tp, tkeys, tck, tcts = _world(parties)
    seen = []
    real = boot3gen.rotate_streamed

    def spy(acc, sel, bara, geom, *args, stepvec=None, **kw):
        seen.append((geom.bits, len(geom.cols), stepvec[0],
                     cuda_rotate.takes_kernel_route(geom, args[1])))
        return real(acc, sel, bara, geom, *args, stepvec=stepvec, **kw)

    def hi_word_route(*a, **kw):
        raise AssertionError("the exact key took the hi-word expanded route")

    monkeypatch.setattr(boot3gen, "rotate_streamed", spy)
    monkeypatch.setattr(boot3gen, "rotate", hi_word_route)
    x = gates3gen.mk_gate_and_wb(tck, tcts[0], tcts[1])
    u = boot3gen.mk_bootstrap_wo_keyswitch(tck, gates3gen.MU, x)
    assert seen == [(64, 16, gates3gen.MU, False)]
    jx = jgates3._trivial_like(ck, cts[0], -(1 << 29)) + cts[0] + cts[1]
    ju = jboot3._mk_bootstrap_wo_keyswitch_impl(ck, jgates3._mu(ck), jx)
    _assert_same(u, ju)
    assert u.a.dtype == torch.int32  # the int64 accumulator truncated to Torus32
    # the rounded key of the same samples takes the hi-word route, other words
    fast = bridge.mk_cloud_key_from_numpy(tp, np.asarray(ck.bk_samples), np.asarray(ck.ks_mat),
                                          parties, forms=("fbstream",), device="cpu")
    assert not fast.exact
    seen.clear()
    boot3gen.mk_bootstrap_wo_keyswitch(fast, gates3gen.MU, x)
    assert seen == [(32, 8, boot3gen.hi_word(gates3gen.MU), True)]  # the kernel route
    N = tp.rlwe_polynomial_degree
    assert decode_message(x.b, 2 * N).shape == (len(bits[0]),)


def test_exact_key_file_round_trip(tmp_path):
    """save -> load keeps the conv form both ways: the port's file loads in
    the port and in JAX as the exact key, and JAX's conv-only file loads in
    the port as it."""
    params, sks, ck, cts, bits, tp, tkeys, tck, tcts = _world(2)
    want = gates3gen.mk_gate_nand(tck, tcts[0], tcts[1])
    path = str(tmp_path / "exact.key")
    ser.save_mk_cloud_key(path, tck)
    _, _, _, extra = ser.load_named(path)
    assert extra["forms"] == ["conv"]
    for loaded in (ser.load_mk_cloud_key(path, device="cpu"),
                   ser.load_mk_cloud_key(path, forms=("conv",), device="cpu")):
        assert loaded.exact and loaded.bk_fb is None
        assert torch.equal(loaded.bk_fb_sel, tck.bk_fb_sel)
        _assert_same(gates3gen.mk_gate_nand(loaded, tcts[0], tcts[1]), want)
    jck = jser.load_mk_cloud_key(path)
    assert jck.bk_kernels is not None and jck.bk_fb is None and jck.bk_fb_sel is None
    _assert_same(want, jgates3.mk_gate_nand(jck, cts[0], cts[1]))
    jpath = str(tmp_path / "jax_conv.key")
    jser.save_mk_cloud_key(jpath, ck)  # forms ["conv"], with the samples
    from_jax = ser.load_mk_cloud_key(jpath, device="cpu")
    assert from_jax.exact
    _assert_same(gates3gen.mk_gate_nand(from_jax, tcts[0], tcts[1]), want)
    # a fast form asked for by name takes the rounded key
    assert not ser.load_mk_cloud_key(jpath, forms=("fblock",), device="cpu").exact


def test_default_forms_never_pick_the_exact_route():
    for name, parties in (("mk_2party_3gen", 2), ("mk_4party_3gen", 4), ("mk_8party_3gen", 8),
                          ("mk_16party_3gen", 16)):
        assert "conv" not in keys3gen.default_forms(tparams.PARAMETER_REGISTRY[name](), parties)
    params, sks, ck, cts, bits, tp, tkeys, tck, tcts = _world(2)
    samples, mat = np.asarray(ck.bk_samples), np.asarray(ck.ks_mat)
    with pytest.raises(ValueError, match="conv"):  # at a hi-word set one form or the other
        bridge.mk_cloud_key_from_numpy(tp, samples, mat, 2, forms=("conv", "fblock"), device="cpu")
    # a key with exact lines but without them, or a rounded key at a wide set, refuses
    bare = dataclasses.replace(tck, bk_fb_sel=None)
    x = gates3gen.mk_gate_and_wb(tck, tcts[0], tcts[1])
    with pytest.raises(ValueError, match="lines"):
        boot3gen.mk_bootstrap_wo_keyswitch(bare, gates3gen.MU, x)

"""The plain reference against the program at the insecure test sizes
(n=16, N=64): word for word on a batch of every gate and on an 8-bit
less_than, at one key and at two parties; and the control (the last gadget
digit of every external product left out) disagreeing with it."""

import numpy as np
import pytest
import torch

from perfbench import keys as K
from perfbench import program
from perfbench.reference import Reference, decompose, gadget_offset, negacyclic_matrix, wrap32
from perfbench.tests.conftest import small_config

B = 24


def world(scheme, seed=5):
    cfg = small_config(scheme)
    gen = torch.Generator().manual_seed(seed)
    keys = K.make_keys(gen, cfg)
    return cfg, keys, program.Program(cfg, keys, "cpu"), gen


def fresh(gen, keys, cfg, bits):
    return K.encrypt(gen, keys, torch.as_tensor(bits), cfg["params"]["lwe_noise_stddev"])


@pytest.mark.parametrize("scheme", ["single", "3gen"])
@pytest.mark.parametrize("kind", ["and", "nand", "or", "xor"])
def test_gate_batch_word_for_word(scheme, kind):
    cfg, keys, prog, gen = world(scheme)
    rng = np.random.default_rng(1)
    bx, by = rng.integers(0, 2, B).astype(bool), rng.integers(0, 2, B).astype(bool)
    x, y = fresh(gen, keys, cfg, bx), fresh(gen, keys, cfg, by)
    out = prog.gate(kind, prog.wrap(*x), prog.wrap(*y))
    ra, rb = Reference(cfg, keys).gates([kind] * B, *x, *y)
    assert torch.equal(ra, out.a.to(torch.int64)) and torch.equal(rb, out.b.to(torch.int64))
    want = {"and": bx & by, "nand": ~(bx & by), "or": bx | by, "xor": bx ^ by}[kind]
    assert np.array_equal(K.decrypt(keys, ra, rb).numpy(), want)


def less_than_words(cfg, keys, gen, values, width=8):
    bits = torch.from_numpy(((values[:, None] >> np.arange(width)) & 1).T == 1)  # (width, S)
    return fresh(gen, keys, cfg, bits)


def test_less_than_word_for_word():
    cfg, keys, prog, gen = world("single")
    rng = np.random.default_rng(2)
    va, vb = rng.integers(0, 128, 3), rng.integers(0, 128, 3)
    wa, wb = less_than_words(cfg, keys, gen, va), less_than_words(cfg, keys, gen, vb)
    out = prog.circuit("less_than")(prog.wrap(*wa), prog.wrap(*wb), 8)
    ra, rb = Reference(cfg, keys).circuit("less_than")(wa, wb, 8)
    assert torch.equal(ra, out.a.to(torch.int64)) and torch.equal(rb, out.b.to(torch.int64))
    assert np.array_equal(K.decrypt(keys, ra, rb).numpy(), va < vb)


@pytest.mark.parametrize("scheme", ["single", "3gen"])
def test_control_disagrees(scheme):
    """The rotate with one gadget digit dropped still decrypts right, but
    differs from the reference in the words: the comparison refuses it."""
    cfg, keys, prog, gen = world(scheme, seed=9)
    rng = np.random.default_rng(3)
    bx, by = rng.integers(0, 2, B).astype(bool), rng.integers(0, 2, B).astype(bool)
    x, y = fresh(gen, keys, cfg, bx), fresh(gen, keys, cfg, by)
    ra, rb = Reference(cfg, keys).gates(["nand"] * B, *x, *y)
    ca, cb = Reference(cfg, keys, digits_dropped=1).gates(["nand"] * B, *x, *y)
    differing = int((ca != ra).sum() + (cb != rb).sum())
    assert differing > ra.numel() // 2
    assert np.array_equal(K.decrypt(keys, ca, cb).numpy(), ~(bx & by))


def test_decomposition_recomposes():
    """sum_p digit_p 2^(32 - p lb) is x to within the rounding of the last
    digit, for l lb < 32."""
    x = torch.randint(-2**31, 2**31, (4, 64), dtype=torch.int64)
    for l, lb in ((3, 7), (2, 7)):
        d = decompose(x, l, lb)
        back = sum(d[..., p, :] << (32 - (p + 1) * lb) for p in range(l))
        err = wrap32(x - back)
        assert int(err.abs().max()) <= 1 << (32 - l * lb - 1)
    assert gadget_offset(3, 7) == (64 << 25) + (64 << 18) + (64 << 11) + (1 << 10)


def test_negacyclic_matrix():
    """X^(N-1) * X = -1 and an exact product against the schoolbook one."""
    N = 8
    d, k = torch.zeros(N, dtype=torch.int64), torch.zeros(N, dtype=torch.int64)
    d[N - 1], k[1] = 1, 1
    got = (d.double() @ negacyclic_matrix(k)).long()
    assert got[0] == -1 and int(got.abs().sum()) == 1
    a, b = torch.randint(-5, 5, (N,)), torch.randint(-2**31, 2**31, (N,))
    want = torch.zeros(N, dtype=torch.int64)
    for i in range(N):
        for j in range(N):
            sign = 1 if i + j < N else -1
            want[(i + j) % N] += sign * int(a[i]) * int(b[j])
    assert torch.equal((a.double() @ negacyclic_matrix(b)).long(), want)

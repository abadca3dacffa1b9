"""The schemes, circuits and traffic kinds found by name, at the insecure
test sizes (n=16, N=64): the ``add`` circuit of the program against the
plain reference word for word, and the control disagreeing with it; the
key material, inputs and reference of the single-key and 3gen schemes
against digests recorded before they moved into their scheme files; a
layered mix that never gives one gate the same ciphertext twice; and the
work count silent on what it does not count."""

import hashlib

import numpy as np
import pytest
import torch

from perfbench import keys as K
from perfbench import program, readers, traffic, workcount
from perfbench.circuits import add
from perfbench.harness import difference
from perfbench.reference import Reference
from perfbench.tests.conftest import SMALL_MIXES, small_config

S = 3  # circuits a batch


def world(scheme, seed):
    cfg = small_config(scheme)
    gen = torch.Generator().manual_seed(seed)
    keys = K.make_keys(gen, cfg)
    return cfg, keys, gen


def add_operands(cfg, keys, gen, rng, width=8):
    """Two words of S operands over 0-255 and a carry-in of 0, encrypted
    as the add circuit's traffic draws them."""
    values, groups = add.draw(rng, {"width": width, "batch": S, "pool": 1, "operand_bits": 8})
    sigma = cfg["params"]["lwe_noise_stddev"]
    enc = [K.encrypt(gen, keys, torch.from_numpy(g[:, ..., 0, :]), sigma) for g in groups]
    (wa, wb), (ca, cb) = enc
    words = [(wa[0], wb[0]), (wa[1], wb[1]), (ca[0], cb[0])]
    return values[:, 0], words, add.want(values, {"width": width})[0]


@pytest.mark.parametrize("scheme", ["single", "3gen"])
def test_add_word_for_word(scheme):
    """The program's add (3gen: mk/gates3gen.mk_add; single key:
    circuits/words.add, reached by the same name) equals the reference's
    ripple in every word, and decrypts to (a + b) mod 256."""
    cfg, keys, gen = world(scheme, 11)
    prog = program.Program(cfg, keys, "cpu")
    values, words, want = add_operands(cfg, keys, gen, np.random.default_rng(4))
    out = prog.circuit("add")(*(prog.wrap(a, b) for a, b in words), 8)
    ra, rb = Reference(cfg, keys).circuit("add")(*words, 8)
    assert rb.shape == (8, S)
    assert torch.equal(ra, out.a.to(torch.int64)) and torch.equal(rb, out.b.to(torch.int64))
    assert np.array_equal(K.decrypt(keys, ra, rb).numpy(), want)
    total = (values[0] + values[1]) % 256
    assert np.array_equal(want, ((total[None, :] >> np.arange(8)[:, None]) & 1) == 1)


def test_control_disagrees_on_add():
    """The reference without its last gadget digit, put in the program's
    place, differs from the reference in most words of an add."""
    cfg, keys, gen = world("3gen", 12)
    _, words, want = add_operands(cfg, keys, gen, np.random.default_rng(5))
    ra, rb = Reference(cfg, keys).circuit("add")(*words, 8)
    ca, cb = Reference(cfg, keys, digits_dropped=1).circuit("add")(*words, 8)
    assert int((ca != ra).sum() + (cb != rb).sum()) > ra.numel() // 2
    assert np.array_equal(K.decrypt(keys, ra, rb).numpy(), want)


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(np.ascontiguousarray(t.cpu().numpy().astype(np.int64)).tobytes())
    return h.hexdigest()[:16]


# recorded on the tree before the schemes moved into perfbench/schemes/
PARENT = {
    "single": {"keys": "b143760803f31bf5", "inputs": "9334c6c9bdbfd484",
               "gates": "601cf0306ff33738", "control": "8be76a1154731b67"},
    "3gen": {"keys": "1e98ba03b244e8b3", "inputs": "2a8456ca548682b0",
             "gates": "f526a4b357d654be", "control": "5c2581402d927bb1"},
    "cmp8": {"values": "8472a4b450cdf8f8", "words": "640637c4f63a1b54",
             "reference": "9e414730bad4efe1"},
}


@pytest.mark.parametrize("scheme", ["single", "3gen"])
def test_scheme_draws_and_computes_as_before(scheme):
    """One seed: the same key words, the same fresh encryptions after them,
    and the same reference gates and control as on the parent tree."""
    cfg, keys, gen = world(scheme, 2**31 + 13)
    rng = np.random.default_rng(7)
    bx, by = rng.integers(0, 2, 6).astype(bool), rng.integers(0, 2, 6).astype(bool)
    sigma = cfg["params"]["lwe_noise_stddev"]
    x, y = (K.encrypt(gen, keys, torch.as_tensor(b), sigma) for b in (bx, by))
    kinds = ["and", "nand", "or", "xor", "nand", "and"]
    got = {"keys": digest(*keys), "inputs": digest(*x, *y),
           "gates": digest(*Reference(cfg, keys).gates(kinds, *x, *y)),
           "control": digest(*Reference(cfg, keys, digits_dropped=1).gates(kinds, *x, *y))}
    assert got == PARENT[scheme]


class Wrapping:
    """The program's ``wrap`` and ``circuit`` alone: the traffic's set-up
    without a cloud key."""

    class Sample:
        def __init__(self, a, b):
            self.a, self.b = a, b

    def wrap(self, a, b):
        return self.Sample(a.to(torch.int32), b.to(torch.int32))

    def circuit(self, name):
        return None


def test_less_than_traffic_draws_as_before():
    """The cmp8 mix at the test size: the same operand values, encrypted
    words and reference result as on the parent tree."""
    cfg, keys, gen = world("single", 2**31 + 21)
    mix = SMALL_MIXES["tfhe128.cmp8"]
    work = traffic.make(mix, cfg, keys, Wrapping(), np.random.default_rng(2**31 + 21), gen,
                        torch.device("cpu"))
    pool = range(mix["pool"])
    words = [(torch.stack([work.operands[r][o].a for r in pool], 1).flatten(1, 2).long(),
              torch.stack([work.operands[r][o].b for r in pool], 1).flatten(1, 2).long())
             for o in range(2)]
    less_than = Reference(cfg, keys).circuit("less_than")
    got = {"values": hashlib.sha256(work.values.astype(np.int64).tobytes()).hexdigest()[:16],
           "words": digest(*[t for o in range(2) for r in pool
                             for t in (work.operands[r][o].a, work.operands[r][o].b)]),
           "reference": digest(*less_than(words[0], words[1], 8))}
    assert got == PARENT["cmp8"]


class Draws:
    """A generator of integers that gives the draws it is handed."""

    def __init__(self, values):
        self.values = values

    def integers(self, low, high):
        assert all(0 <= v < h for v, h in zip(self.values, high))
        return np.array(self.values)


@pytest.mark.parametrize("batch", [16, 64])
def test_layered_gates_never_take_one_ciphertext_twice(batch):
    """Every draw the pool allows: the layer's two permutations differ at
    every index, so no gate gets the same ciphertext as both inputs."""
    cfg, keys, gen = world("single", 3)
    mix = dict(SMALL_MIXES["tfhe128.wide"], batch=batch, checked_per_layer=8)
    work = traffic.make(mix, cfg, keys, Wrapping(), np.random.default_rng(3), gen,
                        torch.device("cpu"))
    kind = traffic.KINDS["layered"]
    perms = work.perms.numpy()
    assert perms.shape == (kind.POOL, batch)
    assert all(sorted(p) == list(range(batch)) for p in perms)
    pairs = set()
    for p1 in range(kind.POOL):
        for r in range(kind.POOL - 1):
            work.rng = Draws([0, p1, r, 0])
            _, q1, q2, _ = work._draw()
            assert q1 == p1 and (perms[q1] != perms[q2]).all()
            pairs.add((q1, q2))
    assert len(pairs) == kind.POOL * (kind.POOL - 1)


def test_workcount_counts_only_the_hi_word_forms():
    """The 3gen set with digits too wide for the hi-word key (the 16-party
    set's l=1, Bg=2^26) and a scheme it does not know: no count, and the
    roofline reader returns None for them."""
    cfg = small_config("3gen")
    assert workcount.rotate(cfg, 8) is not None
    wide = dict(cfg, params=dict(cfg["params"], gsw_decomp_length=1, gsw_log2_base=26))
    other = dict(cfg, scheme="ccs")
    run = {"trace": {"device_s": {"blind_rotate (expanded key)": 1.0},
                     "records": {"blind_rotate (expanded key)": 2}},
           "counters": {"rotate_launches": 2, "rotate_rows": 16, "rotate_sel_launches": 0,
                        "rotate_sel_rows": 0}}
    assert readers.rotate_roofline_percent(dict(run, config=cfg)) > 0
    for c in (wide, other):
        assert workcount.rotate(c, 8) is None and workcount.keyswitch(c, 8) is None
        assert readers.rotate_roofline_percent(dict(run, config=c)) is None


def test_counter_difference():
    """A number's growth; of launches per tile config, the configs that grew."""
    assert difference(7, 3) == 4
    assert difference({4: 10, 5: 3}, {4: 10, 5: 1}) == {5: 2}
    assert difference({5: 40}, {}) == {5: 40}

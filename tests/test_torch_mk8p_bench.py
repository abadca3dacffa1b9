"""The 8-party 3rd-gen set (``mk_8party_3gen``) on the compact-key path
against the benchmark's plain reference (perfbench/reference.py).

At the published set the expanded F-block key would be 72.5 GB, so
``keys3gen.default_forms`` gives the compact form and every gate runs the
compact-key rotate (``cuda_rotate.rotate_streamed``; csrc/blind_rotate_sel.cu
on the card). Here, on the CPU, a small set with the published set's digits
(n=16, N=64, 8 parties, l=4, Bg=2^4, keyswitch 5 x 2^2) takes the same form
by lowering ``keys3gen.EXPANDED_KEY_LIMIT`` to 0: the port's gates equal the
reference word for word and decrypt right, the reference with its last gadget
digit dropped (the control) does not equal them, and a whole run of a layered
8-party NAND cell through the harness is ``correct`` while a broken
compact-key path is not. Also the benchmark's cell of the published set
(``mk8p3gen.wide``), the frozen work count of the published set by
hand, and the compact kernel's launch counter per tile config (the launch
itself only on the card, marked ``cuda``). Plain PyTorch and the benchmark:
no JAX.
"""

import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from perfbench import harness, program, traffic, workcount
from perfbench import keys as K
from perfbench.reference import Reference
from torus_fhe_tpu_torch.core import params as P
from torus_fhe_tpu_torch.core.params import SchemeParams3Gen, TGswParams
from torus_fhe_tpu_torch.mk import boot3gen, keys3gen
from torus_fhe_tpu_torch.ops import cuda_rotate, fblock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "small.mk8p3gen"  # a layered 8-party NAND cell at the small set
SMALL_NAME = "perfbench_test_8party_3gen"
B = 24


def small_8party() -> SchemeParams3Gen:
    """The 8-party set's digits and keyswitch at the insecure test sizes."""
    return SchemeParams3Gen(16, 2**-13.52, 64, 1, 64, 4, 4, 2**-30.70, 5, 2, 2**-13.52, 8)


def small_config() -> dict:
    P.PARAMETER_REGISTRY.setdefault(SMALL_NAME, small_8party)
    return {"name": "small_8party_3gen", "scheme": "3gen", "registry": SMALL_NAME,
            "parties": 8, "params": dataclasses.asdict(small_8party())}


SMALL_MIX = {"kind": "layered", "batch": 32, "gates": ["nand"], "lookahead": 2,
             "checked_per_layer": 8}


def published_config() -> dict:
    """The benchmark's configuration file of the published set."""
    spec = harness.load_spec(ROOT)
    return harness.load_config(ROOT, spec, "mk8p3gen")


@pytest.fixture
def compact(monkeypatch):
    """Every 3gen key in the compact form, as the published 8-party set has it."""
    monkeypatch.setattr(keys3gen, "EXPANDED_KEY_LIMIT", 0)


def world(seed):
    cfg = small_config()
    gen = torch.Generator().manual_seed(seed)
    keys = K.make_keys(gen, cfg)
    return cfg, keys, program.Program(cfg, keys, "cpu"), gen


def fresh(gen, keys, cfg, bits):
    return K.encrypt(gen, keys, torch.as_tensor(bits), cfg["params"]["lwe_noise_stddev"])


def test_published_set_takes_the_compact_form():
    p = P.mktfhe_parameters_8party_3gen()
    assert keys3gen.default_forms(p, 8) == ("fbstream",)
    g = keys3gen.mk_fb_geometry(p, 8)
    assert g.n * g.D * g.R * g.bs * len(g.cols) * g.bs == 72_477_573_120  # expanded, bytes
    assert g.n * int(np.prod(fblock.sel_kernel_layout_shape(g))) == 566_231_040  # compact
    assert keys3gen.default_forms(small_8party(), 8) == ("fblock",)  # small: under the cap


@pytest.mark.parametrize("kind", ["and", "nand", "or", "xor"])
def test_compact_key_gates_word_for_word(compact, kind):
    cfg, keys, prog, gen = world(5)
    assert prog.ck.bk_fb is None and prog.ck.bk_fb_sel is not None and not prog.ck.exact
    rng = np.random.default_rng(1)
    bx, by = rng.integers(0, 2, B).astype(bool), rng.integers(0, 2, B).astype(bool)
    x, y = fresh(gen, keys, cfg, bx), fresh(gen, keys, cfg, by)
    out = prog.gate(kind, prog.wrap(*x), prog.wrap(*y))
    ra, rb = Reference(cfg, keys).gates([kind] * B, *x, *y)
    assert ra.shape == (B, 8, 16)
    assert torch.equal(ra, out.a.to(torch.int64)) and torch.equal(rb, out.b.to(torch.int64))
    want = {"and": bx & by, "nand": ~(bx & by), "or": bx | by, "xor": bx ^ by}[kind]
    assert np.array_equal(K.decrypt(keys, ra, rb).numpy(), want)


def test_control_disagrees_with_the_compact_key_gates(compact):
    """The reference without the last of the four gadget digits (what
    perfbench/control.py runs) decrypts right but does not give the port's
    words: at l=4 the word comparison still sees the last digit."""
    cfg, keys, prog, gen = world(9)
    rng = np.random.default_rng(3)
    bx, by = rng.integers(0, 2, B).astype(bool), rng.integers(0, 2, B).astype(bool)
    x, y = fresh(gen, keys, cfg, bx), fresh(gen, keys, cfg, by)
    out = prog.gate("nand", prog.wrap(*x), prog.wrap(*y))
    oa, ob = out.a.to(torch.int64), out.b.to(torch.int64)
    ca, cb = Reference(cfg, keys, digits_dropped=1).gates(["nand"] * B, *x, *y)
    assert int((ca != oa).sum() + (cb != ob).sum()) > oa.numel() // 2
    assert np.array_equal(K.decrypt(keys, ca, cb).numpy(), ~(bx & by))


def run_cell():
    """The layered NAND cell at the small set, under BENCHMARK.json's metrics."""
    spec = harness.load_spec(ROOT)
    spec["workloads"] = spec["workloads"] + [{"name": CELL, "config": "small_8party_3gen",
                                              "traffic": "small", "chips": 1}]
    return harness.run_cell(ROOT, CELL, 2**31 + 91, 1.0, False, "cpu", time.perf_counter(),
                            spec, small_config(), SMALL_MIX)


def test_whole_run_takes_the_compact_rotate(compact, monkeypatch):
    calls = {"rotate": 0, "rotate_streamed": 0}

    def counted(name):
        fn = getattr(boot3gen, name)

        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    for name in calls:
        monkeypatch.setattr(boot3gen, name, counted(name))
    res = run_cell()
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["gates_compared"]["value"] > 0
    assert calls["rotate"] == 0 and calls["rotate_streamed"] > 0
    assert set(res["metrics"]) == {"setup_s"}


def _unchanged_rotate(acc_a, sel, bara, geom, l, lb, offset, stepvec=None):
    return fblock.stepvec_acc0(stepvec[0], stepvec[1], geom) if acc_a is None else acc_a


def _last_digit_dropped(acc_a, sel, bara, geom, l, lb, offset, stepvec=None):
    """The compact rotate with the last gadget digit of every step left out:
    the CPU's lines (steps, R, 2N, ncols), rows (level, polynomial), of the
    last level zeroed."""
    sel = sel.clone()
    sel[:, (l - 1) * geom.C:] = 0
    return fblock.blind_rotate_streamed(acc_a, sel, bara, geom, l, lb, offset, stepvec=stepvec)


@pytest.mark.parametrize("fault", ["state_unchanged", "last_digit_dropped", "keyswitch_altered"])
def test_broken_compact_path_is_not_correct(compact, monkeypatch, fault):
    if fault == "state_unchanged":
        monkeypatch.setattr(boot3gen, "rotate_streamed", _unchanged_rotate)
    elif fault == "last_digit_dropped":
        monkeypatch.setattr(boot3gen, "rotate_streamed", _last_digit_dropped)
    else:
        ks = boot3gen.mk_keyswitch

        def altered(*args):
            out = ks(*args)
            return type(out)(out.a, out.b + 1)
        monkeypatch.setattr(boot3gen, "mk_keyswitch", altered)
    res = run_cell()
    assert not res["correct"] and res["failed"] > 0


def test_benchmark_cell_runs_the_published_set():
    """``mk8p3gen.wide`` in BENCHMARK.json: the published set unreduced, on
    one chip, under layers of 256 NAND gates, reporting the wide cells'
    metrics; the program reads the set in the compact form."""
    spec = harness.load_spec(ROOT)
    cfg = published_config()
    assert cfg["reduced"] == [] and cfg["parties"] == 8 and cfg["scheme"] == "3gen"
    assert program.registry_params(cfg) == P.mktfhe_parameters_8party_3gen()
    assert keys3gen.default_forms(program.registry_params(cfg), cfg["parties"]) == ("fbstream",)
    cell = harness.entry(spec["workloads"], "mk8p3gen.wide", "workload")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("mk8p3gen", "wide_nand256", 1)
    mix = traffic.load(ROOT, "wide_nand256")
    assert {k: v for k, v in mix.items() if k != "about"} == {
        "kind": "layered", "batch": 256, "gates": ["nand"], "lookahead": 2,
        "checked_per_layer": 16}
    names = {m["name"] for kind in ("end_to_end", "per_layer")
             for m in harness.metrics_of(spec, kind, "mk8p3gen.wide")}
    assert names == {"gates_per_s", "setup_s", "keygen_s", "rotate_roofline.wide",
                     "keyswitch_ms_per_kgate.wide", "device_idle.wide"}


def test_workcount_by_hand():
    cfg = published_config()
    assert program.registry_params(cfg) == P.mktfhe_parameters_8party_3gen()
    w = workcount.rotate(cfg, 256)
    # 8 x 540 steps x 256 gates x (4*2 digit polys x 1024) x (2 polys x 1024 x 4 limbs)
    assert w.ops == 2 * 4320 * 256 * 8192 * 8192 == 148_434_069_749_760
    # key 4,320 x 8 x 2 x 1024 words, bara 256 x 4,320, accumulator in and out
    assert w.nbytes == 4 * (4320 * 8 * 2 * 1024 + 256 * 4320 + 2 * 256 * 2 * 1024) == 291_733_504
    assert w.bound_by() == "operations"
    assert abs(w.bound_s() * 1e3 - 75.0046) < 1e-3
    w = workcount.keyswitch(cfg, 256)
    # 1,024 extracted coefficients x 5 digits, each adding a row of 8 x 541 words
    assert w.ops == 256 * 1024 * 5 * 8 * 541 == 5_672_796_160
    table = 1024 * 5 * 3 * 4328 * 4
    assert table == 265_912_320
    assert w.nbytes == table + 4 * 256 * (1025 + 8 * 540 + 1)


def test_sel_launches_per_config_start_empty_and_the_cpu_adds_none(compact):
    """A fresh process holds no launch in ``blind_rotate_sel_cuda.by_config``;
    the CPU route adds none; the tile the cell's shape takes is one of the
    compact kernel's configs (the wgmma tile, 64 gates x 64 coefficients, on
    132 SMs)."""
    out = subprocess.run([sys.executable, "-c",
                          "from torus_fhe_tpu_torch.ops import cuda_rotate as c; "
                          "f = c.blind_rotate_sel_cuda; print(f.by_config, f.launches)"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["{}", "0"]
    counts = dict(cuda_rotate.blind_rotate_sel_cuda.by_config)
    cfg, keys, prog, gen = world(4)
    x = fresh(gen, keys, cfg, np.ones(4, bool))
    prog.gate("nand", prog.wrap(*x), prog.wrap(*x))
    assert cuda_rotate.blind_rotate_sel_cuda.by_config == counts
    p = P.mktfhe_parameters_8party_3gen()
    plan = cuda_rotate.sel_plan(256, keys3gen.mk_fb_geometry(p, 8), 4, 132)
    assert plan.config == cuda_rotate.SEL_WGMMA_CONFIG == 3
    assert cuda_rotate.SEL_CONFIGS[plan.config] == plan.tile and plan.tile.wgmma


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the compact-key kernel is CUDA only")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 256])
def test_sel_launches_counted_per_config(cuda_device, B):
    """The compact kernel at the published 8-party geometry (its first 12
    steps): one launch a call under the plan's config, word-equal to the
    plain version in both init modes."""
    p = P.mktfhe_parameters_8party_3gen()
    tg = TGswParams(p.gsw_decomp_length, p.gsw_log2_base, 32)  # the hi-word chain's gadget
    steps = 12
    geom = keys3gen.mk_fb_geometry(p, 8)._replace(n=steps)
    rng = np.random.default_rng(B)
    samples = rng.integers(-2**31, 2**31, (steps, 4, 2, 2, 1024), dtype=np.int64).astype(np.int32)
    sel = fblock.build_sel_key(samples, geom, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(B)
    acc = torch.randint(-2**31, 2**31 - 1, (B, 2, 1024), generator=g, dtype=torch.int32,
                        device=cuda_device)
    bara = torch.randint(0, 2048, (B, steps), generator=g, dtype=torch.int32, device=cuda_device)
    barb = torch.randint(-1024, 1024, (B,), generator=g, dtype=torch.int32, device=cuda_device)
    args = (geom, tg.decomp_length, tg.log2_base, tg.offset)
    plan = cuda_rotate.sel_plan(B, geom, tg.decomp_length, cuda_rotate._sm_count(cuda_device))
    before = dict(cuda_rotate.blind_rotate_sel_cuda.by_config)
    launches = cuda_rotate.blind_rotate_sel_cuda.launches
    for a, sv in ((acc, None), (None, (-(1 << 29), barb))):
        got = cuda_rotate.blind_rotate_sel_cuda(a, sel, bara, *args, stepvec=sv)
        want = fblock.blind_rotate_streamed(a, sel, bara, *args, stepvec=sv)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    after = cuda_rotate.blind_rotate_sel_cuda.by_config
    assert after[plan.config] == before.get(plan.config, 0) + 2
    assert {c: n for c, n in after.items() if c != plan.config} == \
        {c: n for c, n in before.items() if c != plan.config}
    assert cuda_rotate.blind_rotate_sel_cuda.launches == launches + 2

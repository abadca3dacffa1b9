"""The port's measurement tools of the main path, on the CPU:
tools/bench.py (the counterpart of bench.py), tools/profile.py (of
benchmarks/profile.py) and tools/profile_trace.py (of
benchmarks/profile_trace.py).

- JAX makes the keys (F-block form) and they cross through ``bridge.py``:
  ``bench.measure``'s chain of 8 NANDs gives the words of bench.py's own
  ``jax.lax.scan`` chain on the same ciphertexts, and ``profile.measure``'s
  XOR, half adder and 8-bit ripple adder give the words of
  ``torus_fhe_tpu.boot.gates`` and ``circuits.words.add``; tolerance 0;
- ``bench.measure`` and ``profile.measure`` raise when the gates' words
  decrypt wrong (a cloud key of another secret key);
- ``bench.main`` prints one JSON line whose keys are bench.py's (read from
  its source with ``ast``) less its TPU target, plus ``kernel_launches`` and
  ``key_source``; its key cache loads on a second run and is made again
  when stale, with ``--fresh-key``, or after a run cut between its two key
  writes;
- ``profile.main`` prints the header and benchmarks/profile.py's seven rows
  under its names (read from its source);
- ``profile_trace.main`` writes ``summary.json`` with the host's categories;
- each tool run as a script without a card exits 1 and says so, and run as
  a script (its directory first on ``sys.path``) leaves the standard
  library's ``profile`` to ``cProfile``, not tools/profile.py.
"""

import ast
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_kms_gadget_helpers import _one_torch_thread  # noqa: F401

from torus_fhe_tpu.boot import api as japi
from torus_fhe_tpu.boot import bootstrap as jboot
from torus_fhe_tpu.boot import gates as jgates
from torus_fhe_tpu.circuits import words as jwords
from torus_fhe_tpu.core import params as jparams
from torus_fhe_tpu.lwe import LweSample as JLwe
from torus_fhe_tpu_torch import bridge
from torus_fhe_tpu_torch.boot import api
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.tools import bench, profile, profile_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 16
TINY = lambda: tparams.test_parameters(n=16, N=64)  # noqa: E731
_CACHE = {}


def jax_source_dict(path: str, key: str) -> ast.Dict:
    """The dict literal in ``path`` that holds the key ``key``."""
    with open(os.path.join(REPO, path)) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(isinstance(k, ast.Constant) and k.value == key
                                              for k in node.keys):
            return node
    raise LookupError(f"no dict with {key!r} in {path}")


def jax_row_names(B: int) -> list:
    """The row names of benchmarks/profile.py at batch B: the first
    argument of each ``row(...)`` call, its f-string evaluated."""
    with open(os.path.join(REPO, "benchmarks", "profile.py")) as fh:
        tree = ast.parse(fh.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "row":
            expr = ast.Expression(body=node.args[0])
            names.append(eval(compile(expr, "profile.py", "eval"), {"B": B, "BW": max(B // 8, 1)}))
    return names


def to_jax(c):
    return JLwe(jnp.asarray(c.a.numpy()), jnp.asarray(c.b.numpy()))


def same(got, want):
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_array_equal(got.b.numpy(), np.asarray(want.b))


def jax_fblock(fn, *args):
    """A JAX call on the F-block scan (JAX's "auto" would take its Pallas
    interpreter for an F-block key, far slower)."""
    jboot.set_rotate_backend("fblock")
    try:
        return fn(*args)
    finally:
        jboot.set_rotate_backend("auto")


def world():
    """JAX's keys at test_parameters(n=16, N=64) and the port's view of them."""
    if "world" not in _CACHE:
        params = jparams.test_parameters(n=16, N=64)
        jsk, jck = japi.make_key_pair(jax.random.PRNGKey(21), params, forms=("fblock",))
        tp = tparams.SchemeParams(**params.__dict__)
        bk, ks = jck.bootstrap_key, jck.keyswitch_key
        tsk = bridge.secret_key_from_numpy(tp, np.asarray(jsk.key.key), device="cpu")
        tck = bridge.cloud_key_from_numpy(tp, np.asarray(bk.samples), np.asarray(ks.mat),
                                          ks.n_in, ks.n_out, device="cpu")
        _CACHE["world"] = (jck, tsk, tck)
    return _CACHE["world"]


def test_bench_chain_equals_jax():
    jck, tsk, tck = world()
    rec, (cx, cy, out) = bench.measure(tsk, tck, *bench.inputs(B), iters=1, lat_reps=1)

    def chain(ck, x0, y):  # bench.py:114-119
        def body(x, _):
            return jgates.gate_nand(ck, x, y), None

        xT, _ = jax.lax.scan(body, x0, None, length=8)
        return xT

    same(out, jax_fblock(jax.jit(chain), jck, to_jax(cx), to_jax(cy)))
    assert (rec["chain_len"], rec["batch"], rec["iters"], rec["kernel_launches"]) == (8, B, 1, 0)
    assert rec["chained_gates_per_s"] > 0 and rec["p50_single_bootstrap_ms"] > 0


def profile_words():
    if "profile" not in _CACHE:
        jck, tsk, tck = world()
        rows, w = profile.measure(tsk, tck, B, iters=1)
        j = {k: to_jax(w[k]) for k in ("ct", "ct2", "wx", "wy", "zero")}
        want = jax_fblock(lambda: {
            "xor": jgates.gate_xor(jck, j["ct"], j["ct2"]),
            "half_adder": (jgates.gate_xor(jck, j["ct"], j["ct2"]),
                           jgates.gate_and(jck, j["ct"], j["ct2"])),
            "adder8": jwords.add(jck, j["wx"], j["wy"], j["zero"], profile.WIDTH)})
        _CACHE["profile"] = (rows, w, want)
    return _CACHE["profile"]


@pytest.mark.parametrize("name", ["xor", "half_adder", "adder8"])
def test_profile_gate_words_equal_jax(name):
    rows, got, want = profile_words()
    pairs = zip(got[name], want[name]) if name == "half_adder" else [(got[name], want[name])]
    for g, w in pairs:
        same(g, w)
    assert [r[0] for r in rows] == jax_row_names(B)[1:]


@pytest.mark.parametrize("tool", ["bench", "profile"])
def test_a_key_of_another_secret_raises(tool):
    _, ck = api.make_key_pair(torch.Generator().manual_seed(3), TINY(), device="cpu")
    other = api.make_secret_key(torch.Generator().manual_seed(4), TINY(), device="cpu")
    if tool == "bench":
        with pytest.raises(AssertionError, match="bootsAND decrypt mismatch"):
            bench.measure(other, ck, *bench.inputs(B), iters=1, lat_reps=1)
    else:
        with pytest.raises(AssertionError, match="adder8: .* words decrypt wrong"):
            profile.measure(other, ck, B, iters=1)


def run_bench(capsys, *args) -> dict:
    assert bench.main([str(B), "--device", "cpu", *args]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """tools/bench.py's key cache in a temporary directory, the fast set
    replaced by the test set."""
    monkeypatch.setattr(bench, "CACHE_DIR", str(tmp_path))
    monkeypatch.setitem(bench.SETS, "fast", TINY)
    return tmp_path


def test_bench_main_prints_one_line_of_the_jax_keys(cache, capsys):
    line = run_bench(capsys)
    top = jax_source_dict("bench.py", "extra")
    jax_extra = top.values[[k.value for k in top.keys].index("extra")]
    assert set(line) == {k.value for k in top.keys} - {"vs_baseline"}
    assert set(line["extra"]) == ({k.value for k in jax_extra.keys} - {"note"}
                                  | {"kernel_launches", "key_source"})
    extra = line["extra"]
    assert line["value"] == extra["chained_gates_per_s"] > 0
    assert (extra["batch"], extra["chain_len"], extra["iters"]) == (B, 8, 4)
    assert (extra["key_source"], extra["device"], extra["kernel_launches"]) == ("keygen", "cpu", 0)


def test_bench_key_cache_loads_and_stale_keys_are_made_again(cache, capsys, monkeypatch):
    assert run_bench(capsys)["extra"]["key_source"] == "keygen"
    assert sorted(os.listdir(cache)) == ["bench_ck_fast.npz", "bench_sk_fast.npz"]
    first = bench.keys("fast", "cpu")
    assert first[3] == "cache"
    assert run_bench(capsys)["extra"]["key_source"] == "cache"
    monkeypatch.setitem(bench.SETS, "fast", lambda: tparams.test_parameters(n=12, N=64))
    assert run_bench(capsys)["extra"]["key_source"] == "keygen"
    sk, _, _, source = bench.keys("fast", "cpu")
    assert source == "cache" and sk.params.lwe_size == 12


class Cut(Exception):
    """A run killed mid-way."""


def test_bench_a_run_cut_between_its_two_key_writes_makes_both_again(cache, capsys,
                                                                     monkeypatch):
    run_bench(capsys)  # a whole pair of one set in the cache
    monkeypatch.setitem(bench.SETS, "fast", lambda: tparams.test_parameters(n=12, N=64))
    writes = []

    def cut_the_second(save):
        def write(path, key):
            writes.append(os.path.basename(path))
            if len(writes) == 2:
                raise Cut(path)
            save(path, key)
        return write

    with monkeypatch.context() as m:
        for name in ("save_secret_key", "save_cloud_key"):
            m.setattr(bench.serialize, name, cut_the_second(getattr(bench.serialize, name)))
        with pytest.raises(Cut):
            bench.main([str(B), "--device", "cpu"])
    assert len(writes) == 2  # one key of the new set written, the other not
    assert run_bench(capsys)["extra"]["key_source"] == "keygen"  # decrypt-checked inside
    sk, ck, _, source = bench.keys("fast", "cpu")
    assert source == "cache" and sk.params == ck.params and sk.params.lwe_size == 12


def test_bench_fresh_key_ignores_the_cache(cache, capsys):
    run_bench(capsys)
    assert run_bench(capsys, "--fresh-key")["extra"]["key_source"] == "keygen"


def test_profile_main_prints_the_jax_rows(capsys):
    assert profile.main(["--device", "cpu", "--params", "test", "--batch", str(B),
                         "--iters", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == f"# device=cpu params=test batch={B}"
    assert lines[1].split() == ["operation", "wall_s", "items/s"]
    rows = [(ln[:24].strip(), *map(float, ln[24:].split())) for ln in lines[2:]]
    assert [r[0] for r in rows] == jax_row_names(B) and len(rows) == 7
    assert all(wall >= 0 and rate > 0 for _, wall, rate in rows)  # 4 decimals: 0.0000 s


def test_profile_trace_writes_a_host_summary(cache, capsys):
    logdir = cache / "trace"
    assert profile_trace.main(["--device", "cpu", "--batch", "8", "--logdir", str(logdir)]) == 0
    with open(logdir / "summary.json") as fh:
        s = json.load(fh)
    assert (s["busy_share"], s["intact"], s["whole"], s["traces"]) == (None, None, True, 1)
    assert s["total_device_us"] > 0 and "int8 GEMM" in s["by_category"]
    assert s["guards"] == [{}]  # one trace file, and no guards on the CPU
    assert profile_trace.ROTATE not in s["by_category"]  # the plain version: torch ops
    assert "busy share not measured" in capsys.readouterr().out
    assert os.path.exists(cache / "bench_sk_fast.npz")  # the key, cached for the next run


@pytest.mark.parametrize("tool", ["bench", "profile", "profile_trace"])
def test_a_tool_run_as_a_script_without_a_card_exits_1(tool):
    out = subprocess.run([sys.executable, f"torus_fhe_tpu_torch/tools/{tool}.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 1 and out.stdout == "", out.stderr
    assert "torch.cuda.is_available() is false" in out.stderr


@pytest.mark.parametrize("tool", ["bench", "profile", "profile_trace", "perf_comp",
                                  "scheme_noise", "rotate_bench"])
def test_a_tool_run_as_a_script_keeps_the_standard_library_profile(tool):
    path = os.path.join(REPO, "torus_fhe_tpu_torch", "tools", f"{tool}.py")
    code = (f"import runpy, sys\nsys.path.insert(0, {os.path.dirname(path)!r})\n"
            f"sys.argv = [{path!r}, '--help']\ntry:\n"
            "    runpy.run_path(sys.argv[0], run_name='__main__')\n"
            "except SystemExit:\n    pass\n"
            "import cProfile, profile\nprint(profile.__file__)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 0, out.stderr
    assert os.path.dirname(out.stdout.splitlines()[-1]) == os.path.dirname(os.__file__)

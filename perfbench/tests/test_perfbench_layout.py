"""What the benchmark imports, and that everything BENCHMARK.json names is
found by name."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from perfbench import harness, traffic
from perfbench.tests.conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "torus_fhe_tpu"}


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_run_imports_no_jax():
    """Everything run.py and its run import, in a fresh process: no module
    whose top-level name (the part before the first dot) is JAX's or the JAX
    package's. torus_fhe_tpu_torch begins with torus_fhe_tpu, so names are
    compared whole."""
    probe = (
        "import runpy, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        f"runpy.run_path({os.path.join(ROOT, 'perfbench', 'run.py')!r}, run_name='probe')\n"
        "from perfbench import harness, program, control, readers\n"
        f"spec = harness.load_spec({ROOT!r})\n"
        "for m in spec['end_to_end'] + spec['per_layer']:\n"
        f"    harness.reader({ROOT!r}, m['name'])\n"
        "import torch.profiler\n"
        "print(' '.join(sorted({n.split('.')[0] for n in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env=dict(os.environ, USE_FLAX="0"))
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    assert "torus_fhe_tpu_torch" in names and "perfbench" in names
    assert not names & FORBIDDEN, names & FORBIDDEN


def test_sources_import_no_jax():
    """No file of the benchmark names JAX or the JAX package in an import."""
    for path in glob.glob(os.path.join(ROOT, "perfbench", "**", "*.py"), recursive=True):
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & FORBIDDEN, (path, names)


PROGRAM = "torus_fhe_tpu_torch"
REFERENCE_SIDE = ("keys.py", "reference.py", "schemes", "circuits")


def imported(path: str) -> set:
    """The modules a file imports: top-level names, and ``.name`` for a
    module of the benchmark imported relatively."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            names |= {"." + (node.module or a.name).split(".")[0] for a in node.names}
    return names


def test_only_the_program_side_imports_the_program():
    """Of the benchmark's files (its tests aside), program.py and the scheme
    files of drive/ alone import the program; the reference's side
    (keys.py, reference.py, schemes/, circuits/) imports neither the program
    nor those files."""
    bench = os.path.join(ROOT, "perfbench")
    drives = glob.glob(os.path.join(bench, "drive", "*.py"))
    assert len(drives) > 2 and all(PROGRAM in imported(p) for p in drives
                                   if not p.endswith("__init__.py"))
    for path in glob.glob(os.path.join(bench, "**", "*.py"), recursive=True):
        rel = os.path.relpath(path, bench)
        top = rel.split(os.sep)[0]
        if top in ("tests", "drive") or rel == "program.py":
            continue
        names = imported(path)
        assert PROGRAM not in names, rel
        if top in REFERENCE_SIDE:
            assert not names & {".program", ".drive", ".harness", ".kinds"}, (rel, names)


def test_every_name_resolves_to_a_file():
    s = spec()
    configs = {c["name"] for c in s["configs"]}
    for c in s["configs"]:
        with open(os.path.join(ROOT, c["file"])) as fh:
            assert json.load(fh)["name"] == c["name"]
    metrics = {m["name"]: m for m in s["end_to_end"] + s["per_layer"]}
    for w in s["workloads"]:
        assert w["config"] in configs
        assert traffic.load(ROOT, w["traffic"])["kind"] in traffic.KINDS
        reported = [m for m in metrics.values() if w["name"] in m.get("workloads", [w["name"]])]
        assert any(m["name"] == "setup_s" for m in reported)
        assert any(m in s["end_to_end"] and m["name"] != "setup_s" for m in reported)
        assert any(m in s["per_layer"] for m in reported)
    for name, m in metrics.items():
        assert callable(harness.reader(ROOT, name))
        for wl in m.get("workloads", []):
            assert wl in {w["name"] for w in s["workloads"]}
    for m in s["per_layer"]:
        assert m["moves"] in {e["name"] for e in s["end_to_end"]}


def test_configs_match_the_program():
    from perfbench import program

    for c in spec()["configs"]:
        cfg = harness.load_config(ROOT, spec(), c["name"])
        assert cfg["reduced"] == c["reduced"] == []
        program.registry_params(cfg)


def test_no_cuda_no_result():
    """run.py without a CUDA device: exit code 2, no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
                          "--workload", "tfhe128.wide", "--seed", "1", "--seconds", "1"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""


def test_benchmark_alone_does_not_run(tmp_path):
    """In a directory that holds BENCHMARK.json and perfbench/ alone, the
    harness finds no program: the import fails, so no result is printed."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-c", "import perfbench.program"],
                         capture_output=True, text=True,
                         timeout=300, cwd=tmp_path, env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0 and "torus_fhe_tpu_torch" in out.stderr

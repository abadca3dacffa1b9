"""A scheme, a circuit, a configuration, a traffic mix and a cell added to
a copy of the benchmark as new files and new BENCHMARK.json entries alone:
the copy runs the new cell through harness.run_cell and finds it correct,
and every file the copy had is byte for byte the original."""

import dataclasses
import filecmp
import json
import os
import shutil
import subprocess
import sys

from perfbench.tests.conftest import ROOT

# the toy circuit: a - b = a + ~b + 1 mod 2^width, the program's
# circuits/words.subtract, composed from the add circuit's reference
TOY_CIRCUIT = '''"""``subtract`` (circuits/words.subtract): a - b = a + ~b + 1 over words
of ``width`` bits, modulo 2^width."""

import numpy as np
import torch

from ..reference import EIGHTH, wrap32
from . import add


def draw(rng, mix):
    W, B, pool = mix["width"], mix["batch"], mix["pool"]
    values = rng.integers(0, 1 << W, (2, pool, B))
    bits = (values[..., None] >> np.arange(W)) & 1
    return values, [np.moveaxis(bits, -1, 1) == 1]


def want(values, mix):
    W = mix["width"]
    diff = (values[0] - values[1]) % (1 << W)
    return ((diff[:, None, :] >> np.arange(W)[None, :, None]) & 1) == 1


def circuit(gates, wa, wb, width):
    one = (torch.zeros_like(wa[0][0]), torch.full_like(wa[1][0], EIGHTH))  # the trivial 1
    return add.circuit(gates, wa, (wrap32(-wb[0]), wrap32(-wb[1])), one, width)
'''

CELL = "toy.sub4"


def add_toy(tmp):
    """The new files and entries, as a later change would add them: the
    single-key scheme's two files under the name ``toy``, the circuit,
    the configuration, the traffic mix and the cell."""
    from torus_fhe_tpu_torch.core import params as P

    bench = tmp / "perfbench"
    shutil.copy(bench / "schemes" / "single.py", bench / "schemes" / "toy.py")
    shutil.copy(bench / "drive" / "single.py", bench / "drive" / "toy.py")
    (bench / "circuits" / "subtract.py").write_text(TOY_CIRCUIT)
    cfg = {"name": "toy", "scheme": "toy", "registry": "tfhe_test_small", "reduced": [],
           "parties": 1, "params": dataclasses.asdict(P.test_parameters())}
    (bench / "configs" / "toy.json").write_text(json.dumps(cfg))
    mix = {"kind": "circuit", "circuit": "subtract", "width": 4, "batch": 2, "pool": 3}
    (bench / "traffic" / "toy_sub4.json").write_text(json.dumps(mix))
    spec = json.loads((tmp / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy", "source": "the insecure test set", "reduced": [],
                            "file": "perfbench/configs/toy.json", "why": "a toy"})
    spec["workloads"].append({"name": CELL, "config": "toy", "traffic": "toy_sub4", "chips": 1,
                              "why": "a toy"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("circuit_ms", "launches_per_circuit"):
            m["workloads"].append(CELL)
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))


def test_new_scheme_and_circuit_as_new_files(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    add_toy(tmp_path)
    probe = (
        "import json, sys, time\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {ROOT!r}]\n"
        "import perfbench\n"
        f"assert perfbench.__file__.startswith({str(tmp_path)!r}), perfbench.__file__\n"
        "from perfbench import harness\n"
        f"res = harness.run_cell({str(tmp_path)!r}, {CELL!r}, 2**31 + 3, 1.0, False, 'cpu',\n"
        "                        time.perf_counter())\n"
        "print(json.dumps(res))\n")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0, res["checks"]
    assert res["checks"]["gates_compared"]["value"] > 0
    assert set(res["metrics"]) == {"circuit_ms", "setup_s"}
    # every file of the benchmark is as it was
    for base, dirs, files in os.walk(os.path.join(ROOT, "perfbench")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            old = os.path.join(base, f)
            new = tmp_path / os.path.relpath(old, ROOT)
            assert filecmp.cmp(old, new, shallow=False), new

"""Each cell of BENCHMARK.json run on the card for a short window, as the
benchmark's command runs it: exit code 0 and ``correct``. Needs an NVIDIA
GPU: ``python3 -m pytest perfbench/tests -m cuda`` on a machine with one."""

import json
import os
import subprocess
import sys

import pytest

from perfbench.tests.conftest import ROOT


def workloads():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return [w["name"] for w in json.load(fh)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", workloads())
def test_cell_on_card(workload):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "perfbench", "run.py"),
                          "--workload", workload, "--seed", str(2**31 + 5), "--seconds", "3",
                          "--trace", "0"], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"

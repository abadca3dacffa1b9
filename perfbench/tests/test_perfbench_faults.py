"""The whole run of a cell (harness.run_cell), on the CPU at the test
sizes, with the program's timed path broken underneath: ``correct`` comes
out false for each fault a cell can have. The cells run on one card, so no
exchange between cards can be left out."""

import time

import pytest
import torch

from perfbench import harness
from perfbench.tests.conftest import ROOT, SCHEME
from torus_fhe_tpu_torch.boot import bootstrap, keyswitch
from torus_fhe_tpu_torch.mk import boot3gen
from torus_fhe_tpu_torch.ops import fblock

WORKLOADS = ["tfhe128.wide", "mk2p3gen.wide", "tfhe128.cmp8", "mk2p3gen.add8"]


def run(workload, small, seconds=1.5):
    cfg, mix = small(workload)
    return harness.run_cell(ROOT, workload, 2**31 + 77, seconds, False, "cpu",
                            time.perf_counter(), None, cfg, mix)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload, small):
    res = run(workload, small)
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert res["checks"]["gates_compared"]["value"] > 0


def _unchanged_rotate(acc_a, fb, bara, geom, l, lb, offset, stepvec=None):
    """A rotate that returns its state unchanged."""
    return fblock.stepvec_acc0(stepvec[0], stepvec[1], geom) if acc_a is None else acc_a


def _half_batch(gate):
    """The first half of the batch computed, the second half given its copy."""
    def broken(ck, x, y):
        out = gate(ck, x, y)
        h = out.b.shape[0] // 2 or 1
        idx = torch.arange(out.b.shape[0]) % h
        return type(out)(out.a[idx], out.b[idx])
    return broken


def _altered(fn):
    """One answer altered where it is produced: a word of the keyswitch's
    output, at a row that moves from call to call."""
    calls = [0]

    def broken(*args):
        out = fn(*args)
        b = out.b.clone().reshape(-1)
        b[calls[0] % b.numel()] += 1
        calls[0] += 1
        return type(out)(out.a, b.reshape(out.b.shape))
    return broken


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "answer_altered"])
def test_fault_is_not_correct(workload, fault, small, monkeypatch):
    if fault == "state_unchanged":
        monkeypatch.setattr(bootstrap, "rotate", _unchanged_rotate)
        monkeypatch.setattr(boot3gen, "rotate", _unchanged_rotate)
    elif fault == "half_batch":
        if small(workload)[1]["kind"] == "circuit":
            pytest.skip("one circuit of one gate a launch: no batch to halve")
        from perfbench import program
        monkeypatch.setattr(program.Program, "gate",
                            lambda self, kind, x, y: _half_batch(self.gates[kind])(self.ck, x, y))
    else:
        if SCHEME[workload] == "single":
            monkeypatch.setattr(bootstrap, "keyswitch", _altered(keyswitch.keyswitch))
        else:
            monkeypatch.setattr(boot3gen, "mk_keyswitch", _altered(boot3gen.mk_keyswitch))
    res = run(workload, small)
    assert not res["correct"] and res["failed"] > 0

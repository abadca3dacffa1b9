"""The reduction of the program's ``fhe.*`` spans in a traced window
(spans.py) and the readers of it, on a trace made by hand; the existing
readers read the same with the spans in the trace as without."""

import pytest

from perfbench import harness, spans, tracing
from perfbench.tests.conftest import ROOT
from perfbench.tests.test_perfbench_tracing import ev, trace

READERS = ("keygen_s", "launches_per_circuit", "rotate_roofline.wide",
           "rotate_ms_per_launch.circuit", "keyswitch_ms_per_kgate.wide", "device_idle.wide",
           "device_idle.circuit")
NEW_READERS = ("gate_idle_ms.circuit", "gate_idle_ms.wide", "syncs_per_gate.circuit",
               "keyswitch_ms_per_call.circuit")
SPANS = [  # one gate: two rotate launches and a keyswitch inside it
    ev("user_annotation", "fhe.gate", 120, 940),
    ev("user_annotation", "fhe.rotate", 140, 60),
    ev("user_annotation", "fhe.rotate", 695, 10),
    ev("user_annotation", "fhe.keyswitch", 990, 50),
]


def window(with_spans=True):
    """tracing's hand-made window (rotates at 200-500 and 700-1000, a GEMM at
    1000-1050, a synchronise at 480-690) with the launch calls of its
    records, a copy launched after the gate, a synchronise inside the
    keyswitch and one after the gate; with or without the program's spans."""
    events = trace() + [
        ev("cuda_runtime", "cudaLaunchCooperativeKernel", 195, 3, corr=10),
        ev("cuda_runtime", "cudaLaunchCooperativeKernel", 699, 3, corr=11),
        ev("cuda_runtime", "cudaLaunchKernel", 995, 3, corr=12),
        ev("cuda_runtime", "cudaStreamSynchronize", 1030, 15),
        ev("cuda_runtime", "cudaMemcpyAsync", 1065, 3, corr=13),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1070, 10, tid=8, corr=13),
        ev("cuda_runtime", "cudaDeviceSynchronize", 1085, 10),
        ev("gpu_user_annotation", "fhe.gate", 200, 850, tid=7),
    ]
    return events + SPANS if with_spans else events


def test_spans_split_device_idle_and_syncs():
    got = spans.summarize(window())
    assert set(got) == {"fhe.gate", "fhe.rotate", "fhe.keyswitch", spans.OUTSIDE}
    gate, rot, ks, out = (got[k] for k in ("fhe.gate", "fhe.rotate", "fhe.keyswitch",
                                            spans.OUTSIDE))
    assert (gate["count"], rot["count"], ks["count"], out["count"]) == (1, 2, 1, 0)
    assert gate["host_s"] == pytest.approx(940e-6) and rot["host_s"] == pytest.approx(70e-6)
    # self: the gate less its three nested spans; outside: the window less the gate
    assert gate["self_s"] == pytest.approx(820e-6) and out["self_s"] == pytest.approx(60e-6)
    # records by their launch call's innermost span; the copy's launch is outside
    assert rot["device_s"] == pytest.approx(600e-6) and ks["device_s"] == pytest.approx(50e-6)
    assert gate["device_s"] == 0 and out["device_s"] == pytest.approx(10e-6)
    assert gate["inclusive"]["device_s"] == pytest.approx(650e-6)
    # idle 100-200, 500-700, 1050-1070 and 1080-1100, each laid to end at
    # the launch call of the record that ended it: 95-195 (outside to 120,
    # the gate to 140, a rotate to 195), 499-699 (the gate to 695, a rotate
    # to 699), 1045-1065 (the gate to 1060, outside) and 1080-1100 (outside)
    assert out["idle_s"] == pytest.approx(50e-6)
    assert rot["idle_s"] == pytest.approx(59e-6)
    assert gate["idle_s"] == pytest.approx(231e-6)
    assert gate["inclusive"]["idle_s"] == pytest.approx(290e-6)
    s = tracing.summarize(window())
    assert sum(v["idle_s"] for v in got.values()) == pytest.approx(s["window_s"] - s["busy_s"])
    # synchronises by the innermost span at their start
    assert (gate["syncs"], ks["syncs"], rot["syncs"], out["syncs"]) == (1, 1, 0, 1)
    assert gate["inclusive"]["syncs"] == 2 and out["inclusive"]["syncs"] == 1


def test_idle_follows_the_launch_across_clock_wander():
    """A record the trace shows 290 us before its launch call (the card's
    clock and the host's wander apart): the idle stretch it ends is laid on
    the host clock to end at that call, inside the rotate that made it."""
    events = [
        ev("user_annotation", tracing.WINDOW, 0, 1000),
        ev("user_annotation", "fhe.gate", 0, 1000),
        ev("user_annotation", "fhe.rotate", 400, 100),
        ev("cuda_runtime", "cudaLaunchCooperativeKernel", 490, 5, corr=1),
        ev("kernel", "void blind_rotate_kernel<Tile<false> >()", 200, 700, tid=7, corr=1),
    ]
    got = spans.summarize(events)
    assert got["fhe.rotate"]["idle_s"] == pytest.approx(90e-6)  # 400-490
    assert got["fhe.gate"]["idle_s"] == pytest.approx(210e-6)  # 290-400, 900-1000
    assert got["fhe.rotate"]["device_s"] == pytest.approx(700e-6)


def test_no_spans_all_outside():
    got = spans.summarize(window(with_spans=False))
    assert set(got) == {spans.OUTSIDE}
    s = tracing.summarize(window(with_spans=False))
    assert got[spans.OUTSIDE]["idle_s"] == pytest.approx(s["window_s"] - s["busy_s"])
    assert got[spans.OUTSIDE]["syncs"] == 3


def run_of(events, with_block=True):
    cfg = {"scheme": "single", "parties": 1,
           "params": {"lwe_size": 630, "rlwe_polynomial_degree": 1024, "rlwe_mask_size": 1,
                      "bs_decomp_length": 3, "ks_decomp_length": 8, "ks_log2_base": 2}}
    tr = tracing.summarize(events)
    if with_block:
        tr["spans"] = spans.summarize(events)
    return {"trace": tr, "config": cfg, "mix": {"kind": "circuit"}, "units": 1, "gates": 2048,
            "keygen_s": 1.5, "counters": {"rotate_launches": 2, "rotate_rows": 2048,
                                          "rotate_sel_launches": 0, "rotate_sel_rows": 0}}


def test_new_readers_by_hand():
    run = run_of(window())
    read = {name: harness.reader(ROOT, name)(run) for name in NEW_READERS}
    assert read == {"gate_idle_ms.circuit": pytest.approx(0.29),
                    "gate_idle_ms.wide": pytest.approx(0.29),
                    "syncs_per_gate.circuit": 2.0,
                    "keyswitch_ms_per_call.circuit": pytest.approx(0.05)}


@pytest.mark.parametrize("case", ["untraced", "no block", "no spans", "no keyswitch begun"])
def test_new_readers_find_nothing(case):
    """None, not an error, where the run holds nothing to read: an untraced
    run, a harness that makes no spans block, a program without spans, or a
    window in which no keyswitch span began."""
    run = run_of(window(with_spans=case != "no spans"), with_block=case != "no block")
    if case == "untraced":
        run["trace"] = None
    if case == "no keyswitch begun":
        run["trace"]["spans"]["fhe.keyswitch"]["count"] = 0
        assert harness.reader(ROOT, "keyswitch_ms_per_call.circuit")(run) is None
        return
    assert all(harness.reader(ROOT, name)(run) is None for name in NEW_READERS)


def test_existing_readers_ignore_the_spans():
    """The seven readers of the accepted benchmark read the same with the
    program's spans in the trace as without; only the names of idle gaps
    may change."""
    with_spans, without = run_of(window()), run_of(window(with_spans=False))
    for name in READERS:
        read = harness.reader(ROOT, name)
        assert read(without) is not None and read(with_spans) == read(without), name
    assert with_spans["trace"]["busy_s"] == without["trace"]["busy_s"]
    assert with_spans["trace"]["device_s"] == without["trace"]["device_s"]

"""The reduction of a profiler trace to the per-layer metrics, on a trace
made by hand."""

import pytest

from perfbench import readers, tracing, workcount


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


ROTATE = "void blind_rotate_kernel<Tile<false, 4, 2> >(int*)"
GEMM = "void cutlass::Kernel2<cutlass_80_wmma_tensorop_i161616gemm_s8>"


def trace(lost_guard=False):
    events = [
        ev("user_annotation", tracing.GUARDS[0], 0, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 1, 1, corr=1),
        ev("user_annotation", tracing.WINDOW, 100, 1000),
        ev("cpu_op", "aten::add", 150, 40),
        ev("cuda_runtime", "cudaStreamSynchronize", 480, 210),
        ev("kernel", ROTATE, 200, 300, tid=7, corr=10),
        ev("kernel", ROTATE, 700, 300, tid=7, corr=11),
        ev("kernel", GEMM, 1000, 50, tid=7, corr=12),
        ev("user_annotation", tracing.GUARDS[1], 1200, 10),
        ev("cuda_runtime", "cudaLaunchKernel", 1201, 1, corr=2),
    ]
    if not lost_guard:
        events += [ev("kernel", "void add_kernel", 5, 1, tid=7, corr=1),
                   ev("kernel", "void add_kernel", 1205, 1, tid=7, corr=2)]
    return events


def test_summarize():
    s = tracing.summarize(trace())
    assert s["intact"] is True
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx(650e-6)  # guards' kernels left out
    assert s["records"] == {tracing.ROTATE: 2, tracing.GEMM: 1}
    assert s["device_s"][tracing.ROTATE] == pytest.approx(600e-6)
    # idle 100-200 and 1050-1100 with no host op at their start, 500-700
    # while the host waits in a synchronise
    gaps = dict(s["idle_gaps"])
    assert gaps == {"(no host operation)": pytest.approx(150e-6),
                    "cudaStreamSynchronize": pytest.approx(200e-6)}
    assert s["device_ops"][0] == [ROTATE, pytest.approx(600e-6)]


def test_lost_guard_records_show():
    assert tracing.summarize(trace(lost_guard=True))["intact"] is False


def test_readers_on_the_trace():
    cfg = {"scheme": "single", "parties": 1,
           "params": {"lwe_size": 630, "rlwe_polynomial_degree": 1024, "rlwe_mask_size": 1,
                      "bs_decomp_length": 3, "ks_decomp_length": 8, "ks_log2_base": 2}}
    run = {"trace": tracing.summarize(trace()), "config": cfg,
           "counters": {"rotate_launches": 2, "rotate_rows": 2048, "rotate_sel_launches": 0,
                        "rotate_sel_rows": 0}}
    assert readers.idle_percent(run) == pytest.approx(35.0)
    share = readers.rotate_roofline_percent(run)
    assert share == pytest.approx(100 * workcount.rotate(cfg, 1024).bound_s() / 300e-6)

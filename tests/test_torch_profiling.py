"""The port's profiling module (utils/profiling.py, on torch.profiler):
the trace summary on hand-written Chrome traces, a CPU trace of a small
gate, and the text and timer the JAX package's module gives."""

import gzip
import json

import pytest
import torch

from torus_fhe_tpu.utils import profiling as jprofiling
from torus_fhe_tpu_torch.boot import api, gates
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.tools import trace_probe
from torus_fhe_tpu_torch.utils import profiling

SEL = "void blind_rotate_kernel<Tile<true, 2, 4, 2, 2, 4, 1, 128, 1> >(unsigned int*, int const*)"
EXP = "void blind_rotate_kernel<Tile<false, 4, 2, 2, 2, 4, 1, 128, 1> >(unsigned int*, int const*)"
GEMM = "cutlass_80_tensorop_i16832gemm_s8_256x128_64x3_tn_align16"
ELEM = "void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<int> >()"
FFT = "void regular_fft<512u, EPT<8u>, 64u, 8u>(unsigned int*)"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ev(name, cat, ts, dur, pid=1, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": pid, "tid": tid}


def _write(path, events, gz=True):
    data = json.dumps({"traceEvents": events + [{"ph": "M", "name": "process_name",
                                                  "pid": 1, "args": {"name": "host"}}]})
    if gz:
        with gzip.open(path, "wt") as fh:
            fh.write(data)
    else:
        path.write_text(data)


def test_summary_of_device_lanes(tmp_path):
    """Kernels, copies and memsets count; the host spans beside them do not."""
    events = [
        _ev(SEL, "kernel", 100, 500.0, pid=0, tid=7), _ev(EXP, "kernel", 700, 300.0, pid=0, tid=7),
        _ev(GEMM, "kernel", 1000, 100.0, pid=0, tid=7), _ev(ELEM, "kernel", 1100, 50.0, pid=0, tid=7),
        _ev(FFT, "kernel", 1150, 40.0, pid=0, tid=7),
        _ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 1200, 20.0, pid=0, tid=8),
        _ev("Memset (Device)", "gpu_memset", 1220, 5.0, pid=0, tid=8),
        _ev("ncclDevKernel_AllReduce_Sum_i32_RING_LL", "kernel", 1230, 10.0, pid=0, tid=9),
        _ev("void some_kernel()", "kernel", 1240, 15.0, pid=0, tid=7),
        _ev("aten::_int_mm", "cpu_op", 0, 9000.0), _ev("aten::add", "cpu_op", 10, 100.0),
        _ev("cudaLaunchKernel", "cuda_runtime", 20, 5.0),
        _ev("gate", "gpu_user_annotation", 100, 1000.0, pid=0, tid=7),
    ]
    _write(tmp_path / "a.pt.trace.json.gz", events[:5])
    _write(tmp_path / "sub.pt.trace.json", events[5:], gz=False)
    (tmp_path / "nested").mkdir()
    s = profiling.summarize_trace(str(tmp_path), top=3)
    assert s["total_device_us"] == 1040.0
    assert s["by_category"] == {"blind_rotate_sel (compact key)": 500.0,
                                "blind_rotate (expanded key)": 300.0, "int8 GEMM": 100.0,
                                "elementwise/reduce": 50.0, "FFT": 40.0, "copy/memset": 25.0,
                                "other": 15.0, "collective": 10.0}
    assert s["by_op"] == [(SEL, 500.0, 48.1), (EXP, 300.0, 28.8), (GEMM, 100.0, 9.6)]
    assert abs(sum(s["by_category"].values()) - s["total_device_us"]) < 1e-6
    assert profiling.has_device_lanes(str(tmp_path))


def test_summary_of_host_lanes_counts_nested_spans_once(tmp_path):
    """Without a device lane the host op lanes count, each span by its own
    time: the lane's total is its outermost spans'."""
    events = [
        _ev("aten::matmul", "cpu_op", 0, 100.0), _ev("aten::_int_mm", "cpu_op", 10, 30.0),
        _ev("aten::empty", "cpu_op", 12, 5.0), _ev("aten::add", "cpu_op", 50, 20.0),
        _ev("aten::_fft_r2c", "cpu_op", 0, 40.0, tid=2),
        _ev("python_function", "python_function", 0, 500.0),
    ]
    _write(tmp_path / "h.pt.trace.json.gz", events)
    s = profiling.summarize_trace(str(tmp_path))
    assert s["total_device_us"] == 140.0
    assert dict((n, us) for n, us, _ in s["by_op"]) == {
        "aten::matmul": 50.0, "aten::_fft_r2c": 40.0, "aten::_int_mm": 25.0, "aten::add": 20.0,
        "aten::empty": 5.0}
    assert s["by_category"] == {"other": 75.0, "FFT": 40.0, "int8 GEMM": 25.0}
    assert not profiling.has_device_lanes(str(tmp_path))
    with pytest.raises(FileNotFoundError):
        profiling.summarize_trace(str(tmp_path / "none"))


def _guarded_trace(kept_before, kept_after):
    """A trace of one rotate between device_trace's two guards of 3 adds
    each, the first ``kept_before`` and ``kept_after`` of whose device
    records are kept."""
    def call(ts, corr):
        return {**_ev("cudaLaunchKernel", "cuda_runtime", ts, 2.0), "args": {"correlation": corr}}

    def rec(name, ts, corr):
        return {**_ev(name, "kernel", ts, 5.0, pid=0, tid=7), "args": {"correlation": corr}}

    before, after = profiling.GUARDS
    events = [_ev(before, "user_annotation", 0, 40.0), _ev(after, "user_annotation", 200, 40.0)]
    for i in range(3):
        events += [call(10 * i + 5, i)] + [rec(ELEM, 10 * i + 6, i)] * (i < kept_before)
        events += [call(200 + 10 * i + 5, 10 + i)] + [rec(ELEM, 200 + 10 * i + 6, 10 + i)] * (
            i < kept_after)
    return events + [call(50, 5), {**rec(SEL, 60, 5), "dur": 100.0}]


@pytest.mark.parametrize("kept", [(3, 3), (1, 3), (0, 3), (3, 0)])
def test_guards_of_a_trace(tmp_path, kept, monkeypatch):
    """device_trace's guards: their records are matched by correlation id
    with the launch calls inside their host spans, left out of the summary,
    and a trace is intact while each guard kept one; a guard's loss grows
    the next guards (twice the loss, four times the launches when all were
    lost), never shrinks them."""
    events = _guarded_trace(*kept)
    _write(tmp_path / "g.pt.trace.json.gz", events)
    before, after = profiling.GUARDS
    records = {before: (kept[0], 3), after: (kept[1], 3)}
    assert profiling.guard_records(events) == records
    s = profiling.summarize_trace(str(tmp_path))
    assert s["total_device_us"] == 100.0 and s["by_category"] == {
        "blind_rotate_sel (compact key)": 100.0}
    assert s["intact"] is (0 not in kept)
    monkeypatch.setattr(profiling, "_guard", dict.fromkeys(profiling.GUARDS, 5))
    profiling.learn(records)
    grown = {k: 5 if n == 3 else max(5, 2 * (3 - n) if n else 12) for k, (n, _) in records.items()}
    assert profiling._guard == grown


def test_cpu_trace_of_a_gate(tmp_path):
    params = tparams.test_parameters(n=8, N=64)
    gen = torch.Generator().manual_seed(0)
    sk, ck = api.make_key_pair(gen, params, device="cpu")
    x = api.encrypt(gen, sk, torch.tensor([True, False, True, True]))
    with profiling.device_trace(str(tmp_path), device="cpu") as logdir:
        out = gates.gate_and(ck, x, x)
    assert logdir == str(tmp_path)
    assert api.decrypt(sk, out).tolist() == [True, False, True, True]
    s = profiling.summarize_trace(str(tmp_path))
    assert s["total_device_us"] > 0 and s["by_op"]
    assert abs(sum(s["by_category"].values()) - s["total_device_us"]) <= \
        0.01 * s["total_device_us"]
    assert "device total:" in profiling.format_summary(s)


def test_format_summary_and_timed_equal_jax(capsys, monkeypatch):
    s = {"total_device_us": 1234.5, "by_category": {"blind_rotate (expanded key)": 1000.0,
                                                    "other": 234.5},
         "by_op": [(EXP, 1000.0, 81.0), ("x" * 100, 234.5, 19.0)]}
    assert profiling.format_summary(s) == jprofiling.format_summary(s)
    sink = {}
    for _ in range(2):
        with profiling.timed("step", sink):
            pass
    assert set(sink) == {"step"} and sink["step"] >= 0.0
    with profiling.timed("printed"):
        pass
    assert capsys.readouterr().out.startswith("[timed] printed: ")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        with profiling.device_trace("unused"):
            pass


def test_trace_probe_matches_launches_with_records(tmp_path, monkeypatch):
    """The probe's count: host launch, copy and memset calls without a device
    record of the same correlation id, by host time order, and the rotate
    kernel's records."""
    def call(name, ts, corr):
        return {**_ev(name, "cuda_runtime", ts, 2.0), "args": {"correlation": corr}}

    def rec(name, cat, ts, corr):
        return {**_ev(name, cat, ts, 5.0, pid=0, tid=7), "args": {"correlation": corr}}

    events = [call("cudaLaunchKernel", 30, 3), call("cudaMemcpyAsync", 10, 1),
              call("cudaLaunchKernel", 20, 2), call("cudaLaunchCooperativeKernel", 40, 4),
              call("cudaStreamSynchronize", 45, 9), call("cudaMemsetAsync", 50, 5),
              rec(ELEM, "kernel", 31, 3), rec(SEL, "kernel", 41, 4),
              rec("Memset (Device)", "gpu_memset", 51, 5),
              _ev("aten::add", "cpu_op", 19, 4.0)]
    _write(tmp_path / "p.pt.trace.json.gz", events)
    assert trace_probe.lost_records(str(tmp_path)) == {"ops": 5, "lost": [0, 1], "rotate": 1}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert trace_probe.main(["--traces", "1"]) == 1

"""Tracing and profiling: a per-category breakdown of a flow's device time.

Port of torus_fhe_tpu/utils/profiling.py onto ``torch.profiler``. One
context manager traces any flow and writes a Chrome trace under a
directory; ``summarize_trace`` turns the traces there into device time by
op and by category: the two blind-rotate kernels, the int8 GEMMs of
``torch._int_mm``, FFT, copies, elementwise and reduction kernels, the
collectives, and the rest.

Usage:
    with device_trace("/tmp/trace"):
        out = gates.gate_and(ck, cx, cy)
        torch.cuda.synchronize()
    print(format_summary(summarize_trace("/tmp/trace")))
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time
import uuid
from collections import defaultdict

import torch

from ..core.device import resolve_device

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # the card's lanes
HOST_CAT = "cpu_op"  # the host op lanes, counted when the trace has no device lane
WARMUP_KERNELS = 8  # device_trace's opening launches on the card


@contextlib.contextmanager
def device_trace(logdir: str, device=None):
    """Trace the body with ``torch.profiler`` (host ops, and the card's
    kernels and copies unless ``device`` is the CPU; None is the card) and
    write its Chrome trace into ``logdir``. Yields ``logdir``.

    On the card the trace opens with WARMUP_KERNELS launches of a one-word
    add, each followed by a synchronize and a millisecond of idle card,
    before the body. A session can lose the records of the device work of
    its first moments; when a kernel that holds every SM (the rotate's
    cooperative grid) runs in that span, the loss reaches to that kernel's
    end and takes its record too. The adds take the loss in its place.
    Their records, where they survive, count as elementwise work of a few
    microseconds in the summary."""
    from torch.profiler import ProfilerActivity, profile

    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        if device.type == "cuda" and WARMUP_KERNELS:
            word = torch.zeros(1, dtype=torch.int32, device=device)
            for _ in range(WARMUP_KERNELS):
                word.add_(1)
                torch.cuda.synchronize(device)
                time.sleep(1e-3)
        yield logdir
    name = f"{uuid.uuid4().hex}.pt.trace.json.gz"
    prof.export_chrome_trace(os.path.join(logdir, name))


@contextlib.contextmanager
def timed(label: str, sink: dict | None = None):
    """Wall-clock section timer; adds seconds into ``sink[label]`` if given,
    else prints."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[label] = sink.get(label, 0.0) + dt
    else:
        print(f"[timed] {label}: {dt:.4f}s")


def _trace_files(logdir: str):
    return sorted(f for pattern in ("*.trace.json", "*.trace.json.gz")
                  for f in glob.glob(os.path.join(logdir, "**", pattern), recursive=True))


def _load(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        data = json.load(fh)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


_CATEGORIES = (  # first match wins, on the lower-cased name
    (("nccl",), "collective"),
    (("gemm", "cutlass", "i16832", "wmma", "imma", "_int_mm"), "int8 GEMM"),
    (("fft",), "FFT"),
    (("memcpy", "memset", "copy"), "copy/memset"),
    (("elementwise", "reduce"), "elementwise/reduce"),
)


def _category(name: str, cat: str) -> str:
    low = name.lower().replace(" ", "")
    if "blind_rotate_kernel" in low:  # one template: Tile<COMPACT, ...>
        compact = "tile<true" in low or "ilb1e" in low  # demangled or mangled
        return "blind_rotate_sel (compact key)" if compact else "blind_rotate (expanded key)"
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copy/memset"
    for keys, category in _CATEGORIES:
        if any(k in low for k in keys):
            return category
    return "other"


def _self_times(events: list):
    """(name, category, self microseconds) of complete events on host lanes,
    each span less the spans nested in it, so no time counts twice."""
    lanes = defaultdict(list)
    for ev in events:
        lanes[(ev.get("pid"), ev.get("tid"))].append(ev)
    for lane in lanes.values():
        lane.sort(key=lambda ev: (float(ev.get("ts", 0)), -float(ev.get("dur", 0))))
        stack = []  # [end, event, self time]
        for ev in lane + [None]:
            ts = float("inf") if ev is None else float(ev.get("ts", 0))
            while stack and stack[-1][0] <= ts:
                end, done, own = stack.pop()
                yield done.get("name", "?"), done.get("cat", ""), own
            if ev is None:
                break
            dur = float(ev.get("dur", 0))
            if stack:
                stack[-1][2] -= min(dur, stack[-1][0] - ts)
            stack.append([ts + dur, ev, dur])


def has_device_lanes(logdir: str) -> bool:
    """Whether the traces under ``logdir`` hold any event of the card's
    lanes, the events ``summarize_trace`` then counts."""
    return any(ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS
               for path in _trace_files(logdir) for ev in _load(path))


def summarize_trace(logdir: str, top: int = 15) -> dict:
    """Time by op name and by category over the traces under ``logdir``.

    Returns {"total_device_us", "by_op": [(name, us, pct)], "by_category"}.
    Counts the card's lanes only (events of category kernel, gpu_memcpy,
    gpu_memset); a trace without them (a CPU run) counts its host op lanes
    (cpu_op), nested spans by their own time."""
    files = _trace_files(logdir)
    if not files:
        raise FileNotFoundError(f"no .trace.json or .trace.json.gz under {logdir}")
    events = [ev for path in files for ev in _load(path) if ev.get("ph") == "X"]
    device = [ev for ev in events if ev.get("cat") in DEVICE_CATS]
    if device:
        spans = ((ev.get("name", "?"), ev.get("cat", ""), float(ev.get("dur", 0.0)))
                 for ev in device)
    else:
        spans = _self_times([ev for ev in events if ev.get("cat") == HOST_CAT])
    op_us: dict[str, float] = defaultdict(float)
    by_cat: dict[str, float] = defaultdict(float)
    for name, cat, us in spans:
        op_us[name] += us
        by_cat[_category(name, cat)] += us
    total = sum(op_us.values())
    by_op = sorted(op_us.items(), key=lambda kv: -kv[1])[:top]
    return {
        "total_device_us": round(total, 1),
        "by_op": [(n, round(us, 1), round(100 * us / total, 1) if total else 0)
                  for n, us in by_op],
        "by_category": {k: round(v, 1) for k, v in
                        sorted(by_cat.items(), key=lambda kv: -kv[1])},
    }


def format_summary(summary: dict) -> str:
    lines = [f"device total: {summary['total_device_us']/1e3:.2f} ms"]
    lines.append("by category:")
    for cat, us in summary["by_category"].items():
        lines.append(f"  {cat:28s} {us/1e3:10.2f} ms")
    lines.append("top ops:")
    for name, us, pct in summary["by_op"]:
        lines.append(f"  {pct:5.1f}%  {us/1e3:9.2f} ms  {name[:80]}")
    return "\n".join(lines)

"""Tracing and profiling: a per-category breakdown of a flow's device time.

Port of torus_fhe_tpu/utils/profiling.py onto ``torch.profiler``. One
context manager traces any flow and writes a Chrome trace under a
directory; ``summarize_trace`` turns the traces there into device time by
op and by category: the two blind-rotate kernels, the int8 GEMMs of
``torch._int_mm``, FFT, copies, elementwise and reduction kernels, the
collectives, and the rest.

The program's layers open spans (``span``, ``spanned``) that a session
records on the calling thread's host lane, beside the launch calls and the
card's records, so device time, idle time and synchronises can be put down
to the layer whose host code was running: ``fhe.gate`` (a bootstrapped gate call),
``fhe.rotate`` (a blind rotate), ``fhe.keyswitch`` (a keyswitch). With no
session on, a span is a shared no-op.

Usage:
    with device_trace("/tmp/trace"):
        out = gates.gate_and(ck, cx, cy)
        torch.cuda.synchronize()
    print(format_summary(summarize_trace("/tmp/trace")))
"""

from __future__ import annotations

import contextlib
import functools
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
WARMUP_KERNELS = 64  # the guard launches on each side of a traced body on the card, at least
GUARDS = ("device_trace.guard_before", "device_trace.guard_after")  # their host spans
_guard = dict.fromkeys(GUARDS, 0)  # the guard launches the losses seen so far ask for
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler session
    is on, else the shared no-op context: on an x86 host a range costs
    ~9-12 us to enter and leave even with no session, the check ~0.2 us."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def spanned(name: str):
    """Decorator: the function's calls run inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


@contextlib.contextmanager
def device_trace(logdir: str, device=None):
    """Trace the body with ``torch.profiler`` (host ops, and the card's
    kernels and copies unless ``device`` is the CPU; None is the card) and
    write its Chrome trace into ``logdir``. Yields ``logdir``.

    On the card a session loses the records of its first device operations
    and, now and then, of its last ones: a count of them that grows as the
    process ages, not a span of time (tools/trace_probe.py on an H100: 0,
    10, 20 and 30 lost at ages of 0, 130, 260 and 380 s of an 8-party AND
    run again and again). A record lost there is lost whole, so a rotate kernel that
    starts among those operations loses its record though it ends much
    later. So the body runs between two guards, host spans named GUARDS,
    each a run of one-word adds, each followed by a synchronize: the losses
    fall on them. ``summarize_trace`` leaves their records out and says
    whether the body's are intact (a record of each guard kept). A guard
    that lost records makes the next trace's guard on that side twice the
    loss (four times its launches when it lost them all)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    device = resolve_device(device)
    activities = [ProfilerActivity.CPU]
    guards = dict.fromkeys(GUARDS, 0)
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        if WARMUP_KERNELS:
            guards = {g: max(WARMUP_KERNELS, _guard[g]) for g in GUARDS}
    os.makedirs(logdir, exist_ok=True)
    word = torch.zeros(1, dtype=torch.int32, device=device) if any(guards.values()) else None

    def guard(name):
        with record_function(name):
            for _ in range(guards[name]):
                word.add_(1)
                torch.cuda.synchronize(device)

    with profile(activities=activities) as prof:
        if word is not None:
            guard(GUARDS[0])
        yield logdir
        if word is not None:
            torch.cuda.synchronize(device)
            guard(GUARDS[1])
    path = os.path.join(logdir, f"{uuid.uuid4().hex}.pt.trace.json.gz")
    prof.export_chrome_trace(path)
    if word is not None:
        learn(guard_records(_load(path)))


def learn(records: dict) -> None:
    """Grow the next traces' guards past the losses of one trace's guards,
    {guard span name: (records kept, launches)}: twice the loss, or four
    times the launches where none was kept."""
    for name, (kept, launched) in records.items():
        if kept < launched:
            _guard[name] = max(_guard[name], 2 * (launched - kept) if kept else 4 * launched)


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


def _guard_correlations(events: list) -> dict:
    """{guard span name: correlation ids of the host launch calls inside it}."""
    spans = [(ev["name"], float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0)))
             for ev in events if ev.get("cat") == "user_annotation" and ev.get("name") in GUARDS]
    found = {name: set() for name, _, _ in spans}
    for ev in events:
        if ev.get("cat") == "cuda_runtime" and "Launch" in ev.get("name", ""):
            ts = float(ev["ts"])
            for name, start, end in spans:
                if start <= ts <= end:
                    found[name].add(ev.get("args", {}).get("correlation"))
    return found


def guard_records(events: list) -> dict:
    """{guard span name: (device records kept, launches)} of device_trace's
    guards among a trace's complete events, matched by correlation id."""
    kept = {ev.get("args", {}).get("correlation") for ev in events
            if ev.get("cat") in DEVICE_CATS}
    return {name: (len(ids & kept), len(ids)) for name, ids in _guard_correlations(events).items()}


def has_device_lanes(logdir: str) -> bool:
    """Whether the traces under ``logdir`` hold any event of the card's
    lanes, the events ``summarize_trace`` then counts."""
    return any(ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS
               for path in _trace_files(logdir) for ev in _load(path))


def summarize_trace(logdir: str, top: int = 15) -> dict:
    """Time by op name and by category over the traces under ``logdir``.

    Returns {"total_device_us", "by_op": [(name, us, pct)], "by_category",
    "intact"}. Counts the card's lanes only (events of category kernel,
    gpu_memcpy, gpu_memset), less the records of device_trace's guards; a
    trace without them (a CPU run) counts its host op lanes (cpu_op), nested
    spans by their own time. ``intact``: whether every trace kept a record of
    each of its guards, so lost none of the body's (None where no trace
    has guards)."""
    files = _trace_files(logdir)
    if not files:
        raise FileNotFoundError(f"no .trace.json or .trace.json.gz under {logdir}")
    intact, guarded, events = True, False, []
    for path in files:
        trace = [ev for ev in _load(path) if ev.get("ph") == "X"]
        ids = _guard_correlations(trace)
        kept = {ev.get("args", {}).get("correlation") for ev in trace
                if ev.get("cat") in DEVICE_CATS}
        guarded |= bool(ids)
        intact &= all(ids.get(g, set()) & kept for g in GUARDS) if ids else True
        own = set().union(*ids.values())
        events += [ev for ev in trace if ev.get("cat") not in DEVICE_CATS
                   or ev.get("args", {}).get("correlation") not in own]
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
        "intact": intact if guarded else None,
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

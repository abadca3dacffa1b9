"""The traced run's device record: a torch.profiler session around the
measured window, reduced to what the per-layer metrics read.

The categories and the guard logic are a copy of the port's
utils/profiling.py (``_category``, ``device_trace``'s guards,
``summarize_trace``), kept here so that the yardstick does not move with
the program. On an H100 a profiler session loses the records of its first
device operations and now and then of its last ones (a count that grows
with the process's age), so the window runs between two guards, each a
run of one-word adds with a synchronise after every add: the losses fall
on them, and their records are left out. ``intact``: each guard kept at
least one record, so the window lost none.

The window itself is a host span (``WINDOW``); device time is counted
inside it only. Idle gaps are the stretches of the window in which no
kernel, copy or memset ran on the card, each named by the innermost host
operation running where it starts.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime")
GUARDS = ("perfbench.guard_before", "perfbench.guard_after")
WINDOW = "perfbench.window"
GUARD_LAUNCHES = 128
ROTATE = "blind_rotate (expanded key)"
ROTATE_SEL = "blind_rotate_sel (compact key)"
GEMM = "int8 GEMM"
TOP = 10

_CATEGORIES = (  # first match wins, on the lower-cased name
    (("nccl",), "collective"),
    (("gemm", "cutlass", "i16832", "wmma", "imma", "_int_mm"), GEMM),
    (("fft",), "FFT"),
    (("memcpy", "memset", "copy"), "copy/memset"),
    (("elementwise", "reduce"), "elementwise/reduce"),
)


def category(name: str, cat: str) -> str:
    low = name.lower().replace(" ", "")
    if "blind_rotate_kernel" in low:  # one template: Tile<COMPACT, ...>
        compact = "tile<true" in low or "ilb1e" in low  # demangled or mangled
        return ROTATE_SEL if compact else ROTATE
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "copy/memset"
    for keys, cat_name in _CATEGORIES:
        if any(k in low for k in keys):
            return cat_name
    return "other"


@contextlib.contextmanager
def traced(device: torch.device, out: dict):
    """Trace the body (the measured window, which the caller marks with a
    ``record_function(WINDOW)`` span) between the guards; on exit ``out``
    holds ``summarize`` of the trace and, under ``spans``, the program's
    spans (spans.summarize). The trace file is written to a temporary
    directory and deleted once read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    word = torch.zeros(1, dtype=torch.int32, device=device)

    def guard(name):
        with record_function(name):
            for _ in range(GUARD_LAUNCHES):
                word.add_(1)
                torch.cuda.synchronize(device)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        guard(GUARDS[0])
        yield
        torch.cuda.synchronize(device)
        guard(GUARDS[1])
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json.gz")
        prof.export_chrome_trace(path)
        with gzip.open(path, "rt") as fh:
            data = json.load(fh)
    from . import spans

    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    complete = [ev for ev in events if ev.get("ph") == "X"]
    out.update(summarize(complete))
    out["spans"] = spans.summarize(complete)


def _span(ev) -> tuple:
    ts = float(ev.get("ts", 0))
    return ts, ts + float(ev.get("dur", 0))


def _guard_ids(events: list) -> dict:
    """{guard name: correlation ids of the launches inside its host span}."""
    spans = [(ev["name"],) + _span(ev) for ev in events
             if ev.get("cat") == "user_annotation" and ev.get("name") in GUARDS]
    found = {name: set() for name in GUARDS}
    for ev in events:
        if ev.get("cat") == "cuda_runtime" and "Launch" in ev.get("name", ""):
            ts = float(ev["ts"])
            for name, start, end in spans:
                if start <= ts <= end:
                    found[name].add(ev.get("args", {}).get("correlation"))
    return found


def _union(intervals: list) -> list:
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _innermost(lane: list, points: list) -> list:
    """Name of the innermost host event of ``lane`` (properly nested, sorted
    by start, longest first) covering each of the sorted ``points``."""
    names, stack, i = [], [], 0
    for t in points:
        while i < len(lane) and lane[i][0] <= t:
            while stack and stack[-1][1] < lane[i][0]:
                stack.pop()
            stack.append(lane[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        names.append(stack[-1][2] if stack else "(no host operation)")
    return names


def summarize(events: list) -> dict:
    """The window's device record: ``window_s`` (the WINDOW span), ``busy_s``
    (the union of device intervals inside it), device seconds and record
    counts by category, the top device operations and idle gaps, and
    ``intact``."""
    windows = [ev for ev in events if ev.get("cat") == "user_annotation"
               and ev.get("name") == WINDOW]
    if not windows:
        raise ValueError(f"the trace has no {WINDOW} span")
    w0, w1 = _span(windows[0])
    guard_ids = _guard_ids(events)
    skip = set().union(*guard_ids.values())
    device = [ev for ev in events if ev.get("cat") in DEVICE_CATS
              and ev.get("args", {}).get("correlation") not in skip]
    kept = {ev.get("args", {}).get("correlation") for ev in events
            if ev.get("cat") in DEVICE_CATS}
    intact = all(ids & kept for ids in guard_ids.values())
    inside = [ev for ev in device if w0 <= _span(ev)[0] < w1]
    by_cat, counts, by_op = defaultdict(float), defaultdict(int), defaultdict(float)
    for ev in inside:
        start, end = _span(ev)
        dur = (min(end, w1) - start) / 1e6
        cat = category(ev.get("name", "?"), ev.get("cat", ""))
        by_cat[cat] += dur
        counts[cat] += 1
        by_op[ev.get("name", "?")[:160]] += dur
    busy = _union([[max(s, w0), min(e, w1)] for s, e in map(_span, inside)])
    busy_us = sum(e - s for s, e in busy)
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    lane_key = (windows[0].get("pid"), windows[0].get("tid"))
    lane = sorted(((*_span(ev), ev.get("name", "?")) for ev in events
                   if ev.get("cat") in HOST_CATS and ev.get("name") != WINDOW
                   and (ev.get("pid"), ev.get("tid")) == lane_key),
                  key=lambda x: (x[0], -x[1]))
    gaps.sort()
    idle = defaultdict(float)
    for (s, e), name in zip(gaps, _innermost(lane, [s for s, _ in gaps])):
        idle[name[:160]] += (e - s) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6, "intact": intact,
            "device_s": dict(by_cat), "records": dict(counts),
            "device_ops": top(by_op), "idle_gaps": top(idle)}

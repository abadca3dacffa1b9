"""The program's layer spans in the traced window: what the card did, how
long it sat idle and how often the host waited, put down to the layer of
the program whose host code caused it.

The program opens ``fhe.*`` spans (``record_function`` ranges, so
``user_annotation`` events) on the calling thread's host lane, on the same
clock as the card's records: ``fhe.gate`` around a bootstrapped gate call,
``fhe.rotate`` and ``fhe.keyswitch`` inside it. ``summarize`` takes the
window's complete trace events, as ``tracing.summarize`` does, and gives
each ``fhe.*`` name:

- ``count``: its spans that start in the window; ``host_s``: their host
  seconds (cut at the window's end); ``self_s``: the window's host seconds
  in which it is the innermost ``fhe.*`` span;
- ``device_s``: the device seconds of every kernel, copy and memset record
  (as ``tracing.summarize`` counts them) whose launch call (the runtime or
  driver event of the same correlation id, on the span's lane) it is the
  innermost span of;
- ``idle_s``: the window's idle stretches (no record running, as
  ``tracing.summarize`` finds them), each laid on the host clock to end at
  the launch call of the record that ended it, cut at span boundaries,
  each piece given to the innermost span covering it: the host waited there
  while the card had nothing to run;
- ``syncs``: the synchronising calls (``SYNCS``) on the lane that start
  while it is the innermost span;
- ``inclusive``: ``device_s``, ``idle_s`` and ``syncs`` of the span and
  every span nested in it.

``OUTSIDE`` gets what no span covers: the benchmark's own work and loop.
The exclusive ``idle_s`` sum to the window's idle seconds.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

from . import tracing

PREFIX = "fhe."
OUTSIDE = "(outside the program)"
CALL_CATS = ("cuda_runtime", "cuda_driver")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")
FIELDS = ("device_s", "idle_s", "syncs")


def _segments(spans: list) -> list:
    """The time axis cut where the nesting of ``spans`` ((start, end, name),
    properly nested) changes: sorted (start, end, names open there,
    innermost last), from -inf to inf."""
    segs, stack, t = [], [], float("-inf")

    def close(upto):
        nonlocal t
        if upto > t:
            segs.append((t, upto, tuple(name for _, name in stack)))
            t = upto

    for start, end, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= start:
            close(stack[-1][0])
            stack.pop()
        close(start)
        stack.append((end, name))
    while stack:
        close(stack[-1][0])
        stack.pop()
    close(float("inf"))
    return segs


def summarize(events: list) -> dict:
    """{span name or OUTSIDE: its numbers} over the window of ``events``
    (the module docstring)."""
    window = next((ev for ev in events if ev.get("cat") == "user_annotation"
                   and ev.get("name") == tracing.WINDOW), None)
    if window is None:
        raise ValueError(f"the trace has no {tracing.WINDOW} span")
    w0, w1 = tracing._span(window)
    lane_key = (window.get("pid"), window.get("tid"))
    on_lane = lambda ev: (ev.get("pid"), ev.get("tid")) == lane_key
    spans = [(*tracing._span(ev), ev["name"]) for ev in events
             if ev.get("cat") == "user_annotation" and on_lane(ev)
             and ev.get("name", "").startswith(PREFIX)]
    segs = _segments(spans)
    starts = [s for s, _, _ in segs]
    names_at = lambda t: segs[bisect.bisect_right(starts, t) - 1][2]

    out = defaultdict(lambda: dict(count=0, host_s=0.0, self_s=0.0, device_s=0.0, idle_s=0.0,
                                   syncs=0, inclusive=dict.fromkeys(FIELDS, 0)))

    def add(names: tuple, field: str, value) -> None:
        out[names[-1] if names else OUTSIDE][field] += value
        for name in set(names) or (OUTSIDE,):
            out[name]["inclusive"][field] += value

    for start, end, name in spans:
        if w0 <= start < w1:
            out[name]["count"] += 1
            out[name]["host_s"] += (min(end, w1) - start) / 1e6
    for start, end, names in segs:
        cut = min(end, w1) - max(start, w0)
        if cut > 0:
            out[names[-1] if names else OUTSIDE]["self_s"] += cut / 1e6

    skip = set().union(*tracing._guard_ids(events).values())
    launch_at = {ev.get("args", {}).get("correlation"): float(ev["ts"]) for ev in events
                 if ev.get("cat") in CALL_CATS and on_lane(ev)}
    records = []
    for ev in events:
        corr = ev.get("args", {}).get("correlation")
        if ev.get("cat") not in tracing.DEVICE_CATS or corr in skip:
            continue
        start, end = tracing._span(ev)
        if w0 <= start < w1:
            launch = launch_at.get(corr) if corr is not None else None
            records.append((start, min(end, w1), launch))
            add(() if launch is None else names_at(launch), "device_s",
                (min(end, w1) - start) / 1e6)

    # idle stretches on the host clock (the module docstring): in a trace the
    # card's clock and the host's wander apart by up to milliseconds
    gaps, busy_to = [], w0
    for start, end, launch in sorted(records):
        if start > busy_to:
            end_h = start if launch is None else launch
            gaps.append((end_h - (start - busy_to), end_h))
        busy_to = max(busy_to, end)
    if w1 > busy_to:
        gaps.append((busy_to, w1))
    for g0, g1 in gaps:
        i = bisect.bisect_right(starts, g0) - 1
        while i < len(segs) and segs[i][0] < g1:
            s, e, names = segs[i]
            if min(e, g1) > max(s, g0):
                add(names, "idle_s", (min(e, g1) - max(s, g0)) / 1e6)
            i += 1

    for ev in events:
        if (ev.get("cat") in CALL_CATS and ev.get("name") in SYNCS and on_lane(ev)
                and w0 <= float(ev["ts"]) < w1):
            add(names_at(float(ev["ts"])), "syncs", 1)
    return {name: dict(v, inclusive=dict(v["inclusive"])) for name, v in out.items()}


def of(run: dict, name: str):
    """The numbers of span ``name`` in a run record (``run["trace"]["spans"]``),
    or None where the run holds none: an untraced run, or a program or
    harness that records no such span."""
    return ((run.get("trace") or {}).get("spans") or {}).get(name)


def per_gate(run: dict, field: str):
    """``field`` of the ``fhe.gate`` spans, inclusive, over their count."""
    gate = of(run, "fhe.gate")
    return gate["inclusive"][field] / gate["count"] if gate and gate["count"] else None

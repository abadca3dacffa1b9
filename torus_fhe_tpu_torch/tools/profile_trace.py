#!/usr/bin/env python3
"""Where the device time of one bootsAND goes, by category, on one NVIDIA
GPU. The counterpart of the JAX repository's ``benchmarks/profile_trace.py``.

Run it as a script from the root of the repository:
``python3 torus_fhe_tpu_torch/tools/profile_trace.py [--batch 4096]
[--logdir DIR] [--l3] [--device cpu]``. It takes tools/bench.py's key of
the set (tfhe_128_tpu with ``--l3``, else tfhe_128_tpu_fast) from its cache
in ``.cache/keys/``, or makes and caches it, runs one gate_and of the batch
outside the trace, then traces one more under utils/profiling.device_trace
(host clock around the gate, a synchronise and a device->host fetch). It
prints ``format_summary(summarize_trace(...))`` and the traced window's busy
share (the card's kernel and copy time over the window's wall time; not
measured on the CPU, whose trace has host lanes only) and writes the summary
as ``summary.json`` into ``--logdir`` (default ``.cache/trace``), the trace
under ``trace/`` there. On the card a trace that lost records of the body
(a guard kept none of its records) or lacks the rotate kernel's record is
taken again, up to ``TRIES`` traces; exit code 1 when none was whole.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.realpath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
# run as a script, this file's directory stands first on sys.path, where
# tools/profile.py would stand in for the standard library's profile module
# (cProfile imports it, and torch._dynamo imports cProfile)
sys.path[:] = [p for p in sys.path if os.path.realpath(p or os.curdir) != HERE]
if not any(os.path.isdir(os.path.join(p, "torus_fhe_tpu_torch")) for p in sys.path if p):
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torus_fhe_tpu_torch.boot import api, gates  # noqa: E402
from torus_fhe_tpu_torch.tools import bench, log, sync  # noqa: E402
from torus_fhe_tpu_torch.utils import profiling  # noqa: E402

ROTATE = "blind_rotate (expanded key)"  # the rotate kernel's category in the summary
TRIES = 3


def trace(fn, device, logdir: str, rotate: str = ROTATE) -> dict:
    """summarize_trace of one call of ``fn`` (a gate on ``device``: it
    returns a ciphertext) traced into ``logdir/trace`` after one untraced
    call, plus ``window_us`` (host clock: the call, a synchronise, a
    device->host fetch of the output's bodies), ``busy_share`` (device time
    over the window; None without device lanes), ``guards`` (each trace
    file's guard records (kept, launched), utils/profiling.guard_records),
    ``traces`` (taken) and ``whole`` (the last trace kept its body's records
    and, on the card, the record of the rotate kernel, whose category is
    ``rotate``). A trace that is not whole is taken again, up to TRIES
    traces."""
    fn()
    sync(device)
    tdir = os.path.join(logdir, "trace")
    for attempt in range(1, TRIES + 1):
        shutil.rmtree(tdir, ignore_errors=True)
        with profiling.device_trace(tdir, device=device):
            t = time.perf_counter()
            out = fn()
            sync(device)
            int(out.b.sum())
            window_us = (time.perf_counter() - t) * 1e6
        summary = profiling.summarize_trace(tdir)
        guards = [profiling.guard_records(profiling._load(path))
                  for path in profiling._trace_files(tdir)]
        on_card = profiling.has_device_lanes(tdir)
        whole = not on_card or bool(summary["intact"] and rotate in summary["by_category"])
        if whole:
            break
        log("profile_trace", f"trace {attempt}: intact {summary['intact']}, guards' records "
            f"(kept, launched) {guards}, categories {list(summary['by_category'])}; "
            "taking it again")
    summary.update(window_us=window_us, traces=attempt, whole=whole, guards=guards,
                   busy_share=summary["total_device_us"] / window_us if on_card else None)
    return summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--logdir", default=os.path.join(ROOT, ".cache", "trace"))
    ap.add_argument("--l3", action="store_true", help="tfhe_128_tpu (else tfhe_128_tpu_fast)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("profile_trace: torch.cuda.is_available() is false (--device cpu runs on the CPU)",
              file=sys.stderr)
        return 1
    sk, ck, _, source = bench.keys("l3" if args.l3 else "fast", device)
    log("profile_trace", f"key from {source}")
    gen = torch.Generator().manual_seed(1)
    xs = torch.from_numpy(np.random.default_rng(0).integers(0, 2, args.batch) == 1)
    cx, cy = api.encrypt(gen, sk, xs), api.encrypt(gen, sk, ~xs)
    summary = trace(lambda: gates.gate_and(ck, cx, cy), device, args.logdir)
    share = summary["busy_share"]
    if share is None:
        print("# no device lanes in the trace: the times below are the host ops' own times")
    print(profiling.format_summary(summary))
    print(f"traced window: {summary['window_us'] / 1e3:.3f} ms wall, busy share "
          + ("not measured (no device lanes)" if share is None else f"{share:.4f}"), flush=True)
    with open(os.path.join(args.logdir, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    return 0 if summary["whole"] else 1


if __name__ == "__main__":
    sys.exit(main())

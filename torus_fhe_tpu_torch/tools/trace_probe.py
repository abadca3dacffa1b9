#!/usr/bin/env python3
"""Whether a ``torch.profiler`` trace keeps the record of every device
operation it covers: traces one multikey AND (``mk.gates3gen.mk_gate_and``,
by default at ``mk_8party_3gen``, B=256, whose rotate is one cooperative
launch of ``blind_rotate_sel``) again and again through
``utils.profiling.device_trace``, in turns with its warm-up launches and
without them (``profiling.WARMUP_KERNELS`` set to 0).

Run it on one NVIDIA GPU, ``python3 -m torus_fhe_tpu_torch.tools.trace_probe
[--set NAME] [--batch B] [--traces T]``. It prints the card's name and power
limit, one JSON line a trace (the device operations launched, the indices
of those without a device record, whether the rotate kernel's record is
there) and a last JSON line that sums both kinds of trace.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile

import torch

from ..utils import profiling

LAUNCH_CALLS = ("Launch", "Memcpy", "Memset")  # host calls that put work on the card


def lost_records(logdir: str) -> dict:
    """Match the host's launch, copy and memset calls of the traces under
    ``logdir`` with the card's records by correlation id. Returns {"ops":
    calls, "lost": indices (in host time order) of the calls without a
    record, "rotate": records of a blind-rotate kernel}."""
    events = [ev for path in profiling._trace_files(logdir) for ev in profiling._load(path)
              if ev.get("ph") == "X"]
    kept = {ev.get("args", {}).get("correlation") for ev in events
            if ev.get("cat") in profiling.DEVICE_CATS}
    calls = sorted((ev for ev in events if ev.get("cat") == "cuda_runtime"
                    and any(k in ev.get("name", "") for k in LAUNCH_CALLS)),
                   key=lambda ev: float(ev["ts"]))
    return {"ops": len(calls),
            "lost": [i for i, ev in enumerate(calls)
                     if ev.get("args", {}).get("correlation") not in kept],
            "rotate": sum(ev.get("cat") == "kernel" and "blind_rotate_kernel" in ev.get("name", "")
                          for ev in events)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--set", default="mk_8party_3gen")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--traces", type=int, default=40, help="traces of each kind")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_probe: needs a CUDA device", file=sys.stderr)
        return 1
    from .. import mk
    from ..core import params as P
    from ..mk import gates3gen, keys3gen

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    params = P.PARAMETER_REGISTRY[args.set]()
    parties = params.max_parties
    gen = torch.Generator().manual_seed(0)
    sks = [mk.mk_party_keygen(gen, params, device=dev) for _ in range(parties)]
    ck = mk.mk_cloud_keygen(gen, sks, params, device=dev,
                            forms=keys3gen.default_forms(params, parties))
    keys = [sk.lwe for sk in sks]
    ones = torch.ones(args.batch, dtype=torch.bool, device=dev)
    ct = mk.mk_encrypt(gen, keys, ones, params)

    def gate():
        return gates3gen.mk_gate_and(ck, ct, ct)

    gate()
    torch.cuda.synchronize()
    warmup = profiling.WARMUP_KERNELS
    sums = {kind: {"traces": 0, "with_loss": 0, "rotate_missing": 0, "max_lost": 0}
            for kind in ("warmup", "none")}
    try:
        for _ in range(args.traces):
            for kind in sums:
                profiling.WARMUP_KERNELS = warmup if kind == "warmup" else 0
                with tempfile.TemporaryDirectory() as tmp:
                    with profiling.device_trace(tmp, dev):
                        gate()
                        torch.cuda.synchronize()
                    got = lost_records(tmp)
                print(json.dumps({"kind": kind, **got}), flush=True)
                s = sums[kind]
                s["traces"] += 1
                s["with_loss"] += bool(got["lost"])
                s["rotate_missing"] += got["rotate"] == 0
                s["max_lost"] = max(s["max_lost"], len(got["lost"]))
    finally:
        profiling.WARMUP_KERNELS = warmup
    print(json.dumps({"set": args.set, "batch": args.batch, "warmup_kernels": warmup, **sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run one cell of the benchmark of torus_fhe_tpu_torch on the NVIDIA GPU
of this machine and print its result as one JSON line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``workloads`` in BENCHMARK.json)
names a configuration and a traffic mix; ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` runs the window under the profiler and
prints its per-layer metrics, the device's busy and window seconds and the
breakdown. Every run checks what the window produced against the plain
reference; the numbers compared and their limits are the last lines on
standard error and the ``checks`` of the result line. Exit code 2 without
a CUDA device (or with fewer than the cell asks for), 3 when a module of
JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.realpath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, this directory stands first on sys.path; the harness is
# imported as the package perfbench from the root instead
sys.path[:] = [p for p in sys.path if os.path.realpath(p or os.curdir) != HERE]
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    spec = harness.load_spec(ROOT)
    chips = harness.entry(spec["workloads"], args.workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda:0", STARTED, spec)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        limit = " ".join(f"{k.replace('_', ' ')} {v}" for k, v in check.items() if k != "value")
        print(f"check {name} {check['value']} ({limit})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

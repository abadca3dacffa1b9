#!/usr/bin/env python3
"""The control of a cell's comparison, on the card at the cell's own size.

    python3 perfbench/control.py --workload <name> --seeds <n> [<n> ...] [--seconds 5]

For each seed, in one process: the cell's set-up and a short window of the
program at the cell's own load, then the comparison twice over the same
kept gates (or circuits): the program's outputs against the reference
(the lower reading, 0 on a sound run), and the reference with the last
gadget digit of every external product left out (a rotate below the
precision the parameters state), put in the program's place, against the
full reference (the upper reading). One JSON line a seed. The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.realpath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [p for p in sys.path if os.path.realpath(p or os.curdir) != HERE]
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness
    from perfbench.reference import Reference

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    spec = harness.load_spec(ROOT)
    for seed in args.seeds:
        t = time.perf_counter()
        s = harness.prepare(ROOT, args.workload, seed, device, spec)
        rec = s.work.window(args.seconds)
        harness.release(s.work)
        ref = Reference(s.cfg, s.keys)
        program = s.work.check(ref, s.keys)
        control = s.work.check(ref, s.keys, Reference(s.cfg, s.keys, digits_dropped=1))
        print(json.dumps({"workload": args.workload, "seed": seed, "units": rec["units"],
                          "program": program, "control": control,
                          "seconds": time.perf_counter() - t}), flush=True)
        del s, ref
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Times the expanded-key blind-rotate kernel (ops/cuda_rotate.blind_rotate_cuda)
and its plain version at full-size shapes on one NVIDIA GPU, with random keys.

Run it as a script, ``python3 torus_fhe_tpu_torch/tools/rotate_bench.py``: the
package it times is the ``torus_fhe_tpu_torch`` that PYTHONPATH resolves (by
default the one this file belongs to), so two checkouts can be timed in turns
on one card, in one shell command, by pointing PYTHONPATH at each. It
works on a tree whose kernel reads the ``build_fblocks`` layout as well as on
one whose kernel reads the kernel layout (``fblock.to_kernel_layout``): the
key is random bytes either way, since the kernel's time does not depend on
the key being an encryption.

Per shape it prints one JSON line: kernel ms (CUDA events, mean of ``--reps``
after one warm-up), optionally the plain version's ms (``--plain``), the
bound from shapes (``cuda_rotate.rotate_bound_ms``, where the timed package
has it), and with ``--check S`` whether kernel == plain on the first S
steps. The first line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if not any(os.path.isdir(os.path.join(p, "torus_fhe_tpu_torch")) for p in sys.path if p):
    sys.path.insert(0, ROOT)

from torus_fhe_tpu_torch.boot.bootstrap import bk_geometry  # noqa: E402
from torus_fhe_tpu_torch.core import params as P  # noqa: E402
from torus_fhe_tpu_torch.mk import keys3gen  # noqa: E402
from torus_fhe_tpu_torch.ops import cuda_rotate, fblock  # noqa: E402

def _single(name):
    p = P.PARAMETER_REGISTRY[name]()
    return bk_geometry(p), p.bs_decomp_length, p.bs_log2_base, p.tgsw.offset


def _mk2(parties):
    p = P.mktfhe_parameters_2party_3gen()
    tg = P.TGswParams(p.gsw_decomp_length, p.gsw_log2_base, 32)
    return keys3gen.mk_fb_geometry(p, parties), tg.decomp_length, tg.log2_base, tg.offset


# name: (geometry and digits, batch, init mode)
SHAPES = {
    "fast_1024": (lambda: _single("tfhe_128_tpu_fast"), 1024, "stepvec"),
    "fast_1": (lambda: _single("tfhe_128_tpu_fast"), 1, "stepvec"),
    "fast_64": (lambda: _single("tfhe_128_tpu_fast"), 64, "stepvec"),
    "fast_256": (lambda: _single("tfhe_128_tpu_fast"), 256, "stepvec"),
    "fast_4096": (lambda: _single("tfhe_128_tpu_fast"), 4096, "stepvec"),
    "l3_1024": (lambda: _single("tfhe_128_tpu"), 1024, "stepvec"),
    "l3_1": (lambda: _single("tfhe_128_tpu"), 1, "stepvec"),
    "mk2_1024": (lambda: _mk2(2), 1024, "stepvec"),
    "mk2_stage_256": (lambda: _mk2(1), 256, "acc"),   # one party's 520 steps
    "mk2_stage_64": (lambda: _mk2(1), 64, "acc"),
}


def event_ms(fn, reps: int) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_key(geom, kernel_layout: bool, dev) -> torch.Tensor:
    D, cols, rbs = geom.D, len(geom.cols) * geom.bs, geom.R * geom.bs
    shape = (geom.n, D, cols, rbs) if kernel_layout else (geom.n, D * rbs, cols)
    key = torch.empty(shape, dtype=torch.int8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    for s0 in range(0, geom.n, 64):
        key[s0:s0 + 64].copy_(torch.randint(-128, 128, key[s0:s0 + 64].shape, generator=g,
                                            dtype=torch.int8, device=dev))
    return key


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="fast_1024,fast_1,mk2_stage_256")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--plain", action="store_true", help="time the plain version too")
    ap.add_argument("--check", type=int, default=0, metavar="S",
                    help="compare kernel and plain version on the first S steps")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rotate_bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    kernel_layout = hasattr(fblock, "to_kernel_layout")
    print(json.dumps({"label": args.label, "card": smi, "kernel_layout": kernel_layout,
                      "package": os.path.dirname(os.path.dirname(cuda_rotate.__file__))}),
          flush=True)
    for name, (so, report) in cuda_rotate.build().items():
        for ln in report.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln or "warning" in ln:
                print(f"# {name}: {ln.strip()}", flush=True)
    keys = {}
    for name in args.shapes.split(","):
        make, B, mode = SHAPES[name]
        geom, l, lb, offset = make()
        N, C = geom.N, geom.C
        kid = (geom, l)
        if kid not in keys:
            keys.clear()  # one key on the card at a time
            torch.cuda.empty_cache()
            keys[kid] = random_key(geom, kernel_layout, dev)
        key = keys[kid]
        g = torch.Generator(device=dev).manual_seed(1)
        bara = torch.randint(0, 2 * N, (B, geom.n), generator=g, dtype=torch.int32, device=dev)
        barb = torch.randint(-N, N, (B,), generator=g, dtype=torch.int32, device=dev)
        acc = torch.randint(-2**31, 2**31 - 1, (B, C, N), generator=g, dtype=torch.int32,
                            device=dev)
        a, sv = (acc, None) if mode == "acc" else (None, (1 << 29, barb))
        rot = (geom, l, lb, offset)
        rec = {"label": args.label, "shape": name, "B": B, "steps": geom.n, "mode": mode}
        if args.check:
            S = min(args.check, geom.n)
            g_s = geom._replace(n=S)
            got = cuda_rotate.blind_rotate_cuda(a, key[:S], bara[:, :S].contiguous(), g_s, l, lb,
                                                offset, stepvec=sv)
            want = fblock.blind_rotate_fblock(a, key[:S], bara[:, :S].contiguous(), g_s, l, lb,
                                              offset, stepvec=sv)
            torch.cuda.synchronize()
            rec["max_abs_err"] = (got.long() - want.long()).abs().max().item()
            rec["checked_steps"] = S
        rec["ms"] = event_ms(lambda: cuda_rotate.blind_rotate_cuda(a, key, bara, *rot,
                                                                   stepvec=sv), args.reps)
        rec["us_per_step"] = rec["ms"] * 1e3 / geom.n
        if hasattr(cuda_rotate.blind_rotate_cuda, "grid"):
            plan = cuda_rotate.rotate_plan(
                B, geom, l, torch.cuda.get_device_properties(dev).multi_processor_count)
            rec["tile"] = [plan.tile.bm, plan.tile.wq]
            rec["tiles"], rec["grid"] = plan.tiles, cuda_rotate.blind_rotate_cuda.grid
        if args.plain:
            rec["plain_ms"] = event_ms(lambda: fblock.blind_rotate_fblock(a, key, bara, *rot,
                                                                          stepvec=sv), 1)
        if hasattr(cuda_rotate, "rotate_bound_ms"):
            rec["bound_ms"], rec["bound_by"] = cuda_rotate.rotate_bound_ms(B, geom, key.numel())
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

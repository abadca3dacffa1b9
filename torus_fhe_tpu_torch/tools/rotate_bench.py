#!/usr/bin/env python3
"""Times the blind-rotate kernels (ops/cuda_rotate.blind_rotate_cuda over the
expanded key, blind_rotate_sel_cuda over the compact lines) and their plain
versions at full-size shapes on one NVIDIA GPU, with random keys.

Run it as a script, ``python3 torus_fhe_tpu_torch/tools/rotate_bench.py``: the
package it times is the ``torus_fhe_tpu_torch`` that PYTHONPATH resolves (by
default the one this file belongs to), so two checkouts can be timed in turns
on one card, in one shell command, by pointing PYTHONPATH at each. It
works on a tree whose kernel reads the ``build_fblocks`` layout as well as on
one whose kernel reads the kernel layout (``fblock.to_kernel_layout``), and
likewise for the compact lines (``fblock.to_sel_kernel_layout``): the key is
random bytes either way, since the kernel's time does not depend on the key
being an encryption. Shapes whose name ends in ``_compact`` or starts with
``mk4_`` or ``mk8_`` run the compact kernel.

Per shape it prints one JSON line: kernel ms (CUDA events, mean of ``--reps``
after one warm-up), optionally the plain version's ms (``--plain``), the
bound from shapes (``cuda_rotate.rotate_bound_ms``, where the timed package
has it), and with ``--check S`` whether kernel == plain
(``blind_rotate_fblock``, ``blind_rotate_streamed``) on the first S steps. The first line names the card and its power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.realpath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
# run as a script, this file's directory stands first on sys.path, where
# tools/profile.py would stand in for the standard library's profile module
# (cProfile imports it, and torch._dynamo imports cProfile)
sys.path[:] = [p for p in sys.path if os.path.realpath(p or os.curdir) != HERE]
if not any(os.path.isdir(os.path.join(p, "torus_fhe_tpu_torch")) for p in sys.path if p):
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from torus_fhe_tpu_torch.boot.bootstrap import bk_geometry  # noqa: E402
from torus_fhe_tpu_torch.core import params as P  # noqa: E402
from torus_fhe_tpu_torch.mk import keys3gen  # noqa: E402
from torus_fhe_tpu_torch.ops import cuda_rotate, fblock  # noqa: E402

def _single(name):
    p = P.PARAMETER_REGISTRY[name]()
    return bk_geometry(p), p.bs_decomp_length, p.bs_log2_base, p.tgsw.offset


def _mk(name, parties):
    """The 3gen set ``name`` over the steps of ``parties`` parties."""
    p = P.PARAMETER_REGISTRY[name]()
    tg = P.TGswParams(p.gsw_decomp_length, p.gsw_log2_base, 32)
    return keys3gen.mk_fb_geometry(p, parties), tg.decomp_length, tg.log2_base, tg.offset


# name: (geometry and digits, batch, init mode[, "compact": the compact kernel])
SHAPES = {
    "fast_1024": (lambda: _single("tfhe_128_tpu_fast"), 1024, "stepvec"),
    "fast_1": (lambda: _single("tfhe_128_tpu_fast"), 1, "stepvec"),
    "fast_64": (lambda: _single("tfhe_128_tpu_fast"), 64, "stepvec"),
    "fast_256": (lambda: _single("tfhe_128_tpu_fast"), 256, "stepvec"),
    "fast_4096": (lambda: _single("tfhe_128_tpu_fast"), 4096, "stepvec"),
    "l3_1024": (lambda: _single("tfhe_128_tpu"), 1024, "stepvec"),
    "l3_1": (lambda: _single("tfhe_128_tpu"), 1, "stepvec"),
    "mk2_1024": (lambda: _mk("mk_2party_3gen", 2), 1024, "stepvec"),
    "mk2_stage_256": (lambda: _mk("mk_2party_3gen", 1), 256, "acc"),   # one party's 520 steps
    "mk2_stage_64": (lambda: _mk("mk_2party_3gen", 1), 64, "acc"),
    "mk8_256": (lambda: _mk("mk_8party_3gen", 8), 256, "stepvec", "compact"),
    "mk4_256": (lambda: _mk("mk_4party_3gen", 4), 256, "stepvec", "compact"),
    "mk2_1024_compact": (lambda: _mk("mk_2party_3gen", 2), 1024, "stepvec", "compact"),
    "mk8_stage_64": (lambda: _mk("mk_8party_3gen", 1), 64, "acc", "compact"),  # 540 steps
    "mk8_1": (lambda: _mk("mk_8party_3gen", 8), 1, "stepvec", "compact"),
    "mk4_1": (lambda: _mk("mk_4party_3gen", 4), 1, "stepvec", "compact"),
    "mk8_64": (lambda: _mk("mk_8party_3gen", 8), 64, "stepvec", "compact"),
    "fast_1024_compact": (lambda: _single("tfhe_128_tpu_fast"), 1024, "stepvec", "compact"),
    "fast_1_compact": (lambda: _single("tfhe_128_tpu_fast"), 1, "stepvec", "compact"),
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


def random_key(geom, kernel_layout: bool, dev, compact: bool = False) -> torch.Tensor:
    """Random bytes in the shape of the key the timed package's kernel reads.
    Compact lines are made in ``build_sel``'s layout and turned into the
    package's compact kernel layout by its own function, where it has one, so
    that ``--check`` holds whatever that layout is."""
    D, cols, rbs = geom.D, len(geom.cols) * geom.bs, geom.R * geom.bs
    if compact:
        shape = (geom.n, geom.R, 2 * geom.N, len(geom.cols))
    else:
        shape = (geom.n, D, cols, rbs) if kernel_layout else (geom.n, D * rbs, cols)
    key = torch.empty(shape, dtype=torch.int8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    for s0 in range(0, geom.n, 64):
        key[s0:s0 + 64].copy_(torch.randint(-128, 128, key[s0:s0 + 64].shape, generator=g,
                                            dtype=torch.int8, device=dev))
    return fblock.to_sel_kernel_layout(key, geom) if compact and kernel_layout else key


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
    sel_kernel_layout = hasattr(fblock, "to_sel_kernel_layout")
    print(json.dumps({"label": args.label, "card": smi, "kernel_layout": kernel_layout,
                      "sel_kernel_layout": sel_kernel_layout,
                      "package": os.path.dirname(os.path.dirname(cuda_rotate.__file__))}),
          flush=True)
    for name, (so, report) in cuda_rotate.build().items():
        for ln in report.splitlines():
            if "registers" in ln or "spill" in ln or "error" in ln or "warning" in ln:
                print(f"# {name}: {ln.strip()}", flush=True)
    keys = {}
    for name in args.shapes.split(","):
        make, B, mode = SHAPES[name][:3]
        compact = SHAPES[name][3:] == ("compact",)
        geom, l, lb, offset = make()
        N, C = geom.N, geom.C
        kid = (geom, l, compact)
        if kid not in keys:
            keys.clear()  # one key on the card at a time
            torch.cuda.empty_cache()
            keys[kid] = random_key(geom, sel_kernel_layout if compact else kernel_layout, dev,
                                   compact)
        kernel = cuda_rotate.blind_rotate_sel_cuda if compact else cuda_rotate.blind_rotate_cuda
        plain = fblock.blind_rotate_streamed if compact else fblock.blind_rotate_fblock
        key = keys[kid]
        g = torch.Generator(device=dev).manual_seed(1)
        bara = torch.randint(0, 2 * N, (B, geom.n), generator=g, dtype=torch.int32, device=dev)
        barb = torch.randint(-N, N, (B,), generator=g, dtype=torch.int32, device=dev)
        acc = torch.randint(-2**31, 2**31 - 1, (B, C, N), generator=g, dtype=torch.int32,
                            device=dev)
        a, sv = (acc, None) if mode == "acc" else (None, (1 << 29, barb))
        rot = (geom, l, lb, offset)
        rec = {"label": args.label, "shape": name, "B": B, "steps": geom.n, "mode": mode,
               "kernel": kernel.__name__}
        if args.check:
            S = min(args.check, geom.n)
            g_s = geom._replace(n=S)
            got = kernel(a, key[:S], bara[:, :S].contiguous(), g_s, l, lb, offset, stepvec=sv)
            want = plain(a, key[:S], bara[:, :S].contiguous(), g_s, l, lb, offset, stepvec=sv)
            torch.cuda.synchronize()
            rec["max_abs_err"] = (got.long() - want.long()).abs().max().item()
            rec["checked_steps"] = S
        rec["ms"] = event_ms(lambda: kernel(a, key, bara, *rot, stepvec=sv), args.reps)
        rec["us_per_step"] = rec["ms"] * 1e3 / geom.n
        if hasattr(kernel, "grid"):
            make_plan = cuda_rotate.sel_plan if compact else cuda_rotate.rotate_plan
            plan = make_plan(B, geom, l,
                             torch.cuda.get_device_properties(dev).multi_processor_count)
            rec["tile"] = [plan.tile.bm, plan.tile.wq]
            rec["tiles"], rec["grid"] = plan.tiles, kernel.grid
        if args.plain:
            rec["plain_ms"] = event_ms(lambda: plain(a, key, bara, *rot, stepvec=sv), 1)
        if hasattr(cuda_rotate, "rotate_bound_ms"):
            rec["bound_ms"], rec["bound_by"] = cuda_rotate.rotate_bound_ms(B, geom, key.numel())
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Microbenchmark table of the port on one NVIDIA GPU: keygen, encrypt,
decrypt, a gate, a half adder and an 8-bit ripple adder. The counterpart
of the JAX repository's ``benchmarks/profile.py``.

Run it as a script from the root of the repository:
``python3 torus_fhe_tpu_torch/tools/profile.py [--batch 1024] [--params
test|128] [--iters 3] [--device cpu]``. ``--params 128`` is tfhe_128,
``test`` is test_parameters(n=16, N=64); ``--device`` defaults to the card.
The keys are the port's default F-block form, so every gate is one launch
of csrc/blind_rotate.cu on the card. The unit of work is a batch: each row
gives the wall seconds of one call (the mean of ``--iters`` calls after one
warm-up, each ended by a synchronise) and items per second. The ring
encryption samples on the host and takes its exact polynomial products in
host numpy (keygen-grade), its result on the device. The adder's words are
decrypted and checked against the plaintext sums, so a wrong word raises.

Prints a ``# device=... params=... batch=...`` line (the card's name and
power limit as nvidia-smi gives them), then the table.
"""

from __future__ import annotations

import argparse
import os
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

from torus_fhe_tpu_torch import rlwe  # noqa: E402
from torus_fhe_tpu_torch.boot import api, gates  # noqa: E402
from torus_fhe_tpu_torch.circuits import words  # noqa: E402
from torus_fhe_tpu_torch.core import params as P  # noqa: E402
from torus_fhe_tpu_torch.tools import smi_line, sync  # noqa: E402

SETS = {"test": lambda: P.test_parameters(n=16, N=64), "128": P.tfhe_parameters_128}
WIDTH = 8  # the ripple adder's word


def timed(fn, device, iters: int = 3, warmup: int = 1):
    """(mean wall seconds of fn() over ``iters`` calls after ``warmup``,
    each call ended by a synchronise; the last result)."""
    out = None
    for _ in range(warmup):
        out = fn()
        sync(device)
    t = time.perf_counter()
    for _ in range(iters):
        out = fn()
        sync(device)
    return (time.perf_counter() - t) / iters, out


def make_keys(params, device) -> tuple:
    """(secret key, cloud key, seconds) of one keygen from a CPU generator
    seeded with 0, ended by a synchronise."""
    sync(device)
    t = time.perf_counter()
    sk, ck = api.make_key_pair(torch.Generator().manual_seed(0), params, device=device)
    sync(device)
    return sk, ck, time.perf_counter() - t


def measure(sk, ck, B: int, iters: int) -> tuple:
    """The table's rows after keygen, on keys held by the caller, as
    [(name, wall s, items/s)], and the ciphertexts and outputs of the gate
    rows: {"ct", "ct2", "xor", "half_adder", "wx", "wy", "zero", "adder8"}.
    Raises AssertionError when the adder's words decrypt wrong."""
    device = sk.key.key.device
    params = sk.params
    gen = torch.Generator().manual_seed(1)
    rows = []

    def row(name, wall_s, count):
        rows.append((name, wall_s, count / wall_s))

    msgs = torch.from_numpy(np.random.default_rng(0).integers(0, 2, B) == 1).to(device)
    wall, ct = timed(lambda: api.encrypt(gen, sk, msgs), device, iters)
    row(f"lwe_encrypt x{B}", wall, B)
    wall, _ = timed(lambda: api.decrypt(sk, ct), device, iters)
    row(f"lwe_decrypt x{B}", wall, B)

    rows_r = B // 8 or 1
    rkey = rlwe.rlwe_keygen(gen, params.rlwe, device=device)
    mu = torch.zeros((rows_r, params.rlwe_polynomial_degree), dtype=torch.int32, device=device)
    wall, _ = timed(lambda: rlwe.rlwe_encrypt(gen, mu, 1e-7, rkey, params.rlwe, (rows_r,),
                                              device=device), device, iters)
    row(f"rlwe_encrypt x{rows_r}", wall, rows_r)

    ct2 = api.encrypt(gen, sk, ~msgs)
    wall, xor = timed(lambda: gates.gate_xor(ck, ct, ct2), device, iters)
    row(f"gate_xor x{B}", wall, B)
    wall, half = timed(lambda: (gates.gate_xor(ck, ct, ct2), gates.gate_and(ck, ct, ct2)),
                       device, iters)
    row(f"half_adder x{B}", wall, 2 * B)

    BW = max(B // 8, 1)
    vals = np.random.default_rng(1).integers(0, 200, (2, BW))
    wx, wy = (words.int_encrypt(gen, sk, v, WIDTH) for v in vals)
    zero = api.encrypt(gen, sk, torch.zeros(BW, dtype=torch.bool, device=device))
    wall, total = timed(lambda: words.add(ck, wx, wy, zero, WIDTH), device, max(iters // 2, 1))
    wrong = int((words.int_decrypt(sk, total, WIDTH) != (vals[0] + vals[1]) % (1 << WIDTH)).sum())
    if wrong:
        raise AssertionError(f"adder8: {wrong} of {BW} words decrypt wrong")
    # 8 full adders x 5 gates each (2 XOR + 2 AND + 1 OR)
    row(f"adder8 x{BW}", wall, 5 * WIDTH * BW)
    return rows, {"ct": ct, "ct2": ct2, "xor": xor, "half_adder": half, "wx": wx, "wy": wy,
                  "zero": zero, "adder8": total}


def table(header: str, rows) -> str:
    lines = [header, f"{'operation':24s} {'wall_s':>10s} {'items/s':>14s}"]
    lines += [f"{name:24s} {wall:10.4f} {thr:14.1f}" for name, wall, thr in rows]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--params", choices=list(SETS), default="test")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("profile: torch.cuda.is_available() is false (--device cpu runs on the CPU)",
              file=sys.stderr)
        return 1
    sk, ck, keygen_s = make_keys(SETS[args.params](), device)
    rows, _ = measure(sk, ck, args.batch, args.iters)
    name = (f"{torch.cuda.get_device_name(device)} | {smi_line(device)}"
            if device.type == "cuda" else "cpu")
    print(table(f"# device={name} params={args.params} batch={args.batch}",
                [("keygen(sk+bk+ksk)", keygen_s, 1 / keygen_s)] + rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

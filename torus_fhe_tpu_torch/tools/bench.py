#!/usr/bin/env python3
"""North-star benchmark of the port: bootsAND gate bootstraps per second on
one NVIDIA GPU. The counterpart of the JAX repository's ``bench.py``.

Run it as a script from the root of the repository:
``python3 torus_fhe_tpu_torch/tools/bench.py [B] [--l3] [--fresh-key]
[--device cpu]``. B (default 4096) is the batch; ``--l3`` takes
tfhe_128_tpu, else tfhe_128_tpu_fast; ``--device`` defaults to the card.
The keys are the port's default F-block form (every gate one launch of
csrc/blind_rotate.cu on the card), made from a CPU generator seeded with 0
and kept in ``.cache/keys/bench_{sk,ck}_{fast,l3}.npz`` (utils/serialize
files); a later run loads them, unless ``--fresh-key`` is given or the
cached key's set is not the one asked for.

``measure`` decrypt-checks one bootsAND batch before timing anything, then
times ``iters`` dispatched ANDs, a chain of ``chain_len`` NANDs
x_{t+1} = NAND(x_t, y) enqueued with no host sync in between (decrypt-
checked against the plaintext recurrence), and the p50 of single gates
(B=1). Every timing is on the host clock and ends in a synchronise; the
chain's also in a device->host fetch. A failed check raises.

Prints exactly one JSON line: {"metric", "value" (the chained rate),
"unit", "extra"}; ``extra`` holds the JAX script's keys (its TPU target
left out), ``key_source`` (keygen or cache) and ``kernel_launches`` (the
launches of the rotate kernel in the timed windows).
"""

from __future__ import annotations

import argparse
import json
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

from torus_fhe_tpu_torch.boot import api, gates  # noqa: E402
from torus_fhe_tpu_torch.core import params as P  # noqa: E402
from torus_fhe_tpu_torch.ops import cuda_rotate  # noqa: E402
from torus_fhe_tpu_torch.tools import log, smi_line, sync  # noqa: E402
from torus_fhe_tpu_torch.utils import serialize  # noqa: E402

CACHE_DIR = os.path.join(ROOT, ".cache", "keys")
SETS = {"fast": P.tfhe_parameters_128_tpu_fast, "l3": P.tfhe_parameters_128_tpu}
PARAMS_NOTE = {
    "fast": ("tfhe_128_tpu_fast (n=630, N=512, k=2 module-LWE, l=2 Bg=2^8, full masks + "
             "body-2^8 rounding, 11 limb-cols)"),
    "l3": ("tfhe_128_tpu (n=630, N=1024, k=1, l=3 Bg=2^7, full masks + body-2^8 rounding, "
           "7 limb-cols)"),
}


def keys(tag: str, device, fresh: bool = False) -> tuple:
    """(secret key, cloud key, seconds, source) of set ``tag`` on ``device``:
    loaded from the cache when it holds that set's key (source "cache"),
    else made from a CPU generator seeded with 0 and written to the cache
    (source "keygen"). The seconds are those of the load or the keygen
    alone, ended by a synchronise. The cloud key is written first and the
    secret key last, each file whole or not at all: a secret key of the
    set asked for marks a whole pair, and a run cut between the two writes
    leaves a stale or missing secret key, so the next run makes both
    again."""
    params = SETS[tag]()
    sk_path, ck_path = (os.path.join(CACHE_DIR, f"bench_{k}_{tag}.npz") for k in ("sk", "ck"))
    t = time.perf_counter()
    if not fresh and os.path.exists(sk_path) and os.path.exists(ck_path):
        sk = serialize.load_secret_key(sk_path, device=device)
        if sk.params == params:
            ck = serialize.load_cloud_key(ck_path, forms=("fblock",), device=device)
            sync(device)
            return sk, ck, time.perf_counter() - t, "cache"
        log("bench", "cached key params stale; regenerating")
        t = time.perf_counter()
    sk, ck = api.make_key_pair(torch.Generator().manual_seed(0), params, device=device)
    sync(device)
    seconds = time.perf_counter() - t
    os.makedirs(CACHE_DIR, exist_ok=True)
    serialize.save_cloud_key(ck_path, ck)
    serialize.save_secret_key(sk_path, sk)
    return sk, ck, seconds, "keygen"


def measure(sk, ck, xs, ys, chain_len: int = 8, iters: int = 4, lat_reps: int = 5) -> tuple:
    """Time the bootsAND regimes on keys held by the caller. ``xs``, ``ys``:
    (B,) bool plaintexts, encrypted here under ``sk`` from a CPU generator
    seeded with 1. Returns (record, (cx, cy, the chain's last
    output)): the record holds the rates and times of ``extra`` and the
    launches of the rotate kernel in the timed windows. Raises
    AssertionError when the AND or the chain decrypts wrong."""
    device = sk.key.key.device
    xs, ys = torch.as_tensor(xs, device=device), torch.as_tensor(ys, device=device)
    B = xs.shape[0]
    gen = torch.Generator().manual_seed(1)
    cx, cy = api.encrypt(gen, sk, xs), api.encrypt(gen, sk, ys)
    sync(device)

    t = time.perf_counter()
    out = gates.gate_and(ck, cx, cy)
    sync(device)
    compile_s = time.perf_counter() - t
    if not torch.equal(api.decrypt(sk, out), xs & ys):
        raise AssertionError("bootsAND decrypt mismatch")

    counted = []  # the rotate kernel's launches in each timed window

    def window(fn):
        """Host seconds of fn, ended by a synchronise."""
        launches = cuda_rotate.blind_rotate_cuda.launches
        t = time.perf_counter()
        out = fn()
        sync(device)
        seconds = time.perf_counter() - t
        counted.append(cuda_rotate.blind_rotate_cuda.launches - launches)
        return out, seconds

    def dispatched():
        for _ in range(iters):
            gates.gate_and(ck, cx, cy)

    def chain():
        x = cx
        for _ in range(chain_len):
            x = gates.gate_nand(ck, x, cy)
        return x

    def chain_fetched():
        x = chain()
        sync(device)
        int(x.b.sum())  # a device->host fetch ends the window
        return x

    _, wall_s = window(dispatched)
    int(chain().b.sum())  # warm-up, fetch included
    outc, chain_s = window(chain_fetched)
    want = xs
    for _ in range(chain_len):
        want = ~(want & ys)
    if not torch.equal(api.decrypt(sk, outc), want):
        raise AssertionError("chained NAND decrypt mismatch")

    c1 = api.encrypt(gen, sk, torch.ones(1, dtype=torch.bool, device=device))
    gates.gate_and(ck, c1, c1)  # warm-up
    lats = [window(lambda: gates.gate_and(ck, c1, c1))[1] for _ in range(lat_reps)]
    rec = {"regime": "chained_steady_state",
           "dispatched_gates_per_s": B * iters / wall_s,
           "chained_gates_per_s": B * chain_len / chain_s,
           "chain_len": chain_len, "batch": B, "iters": iters, "wall_s": wall_s,
           "compile_s": compile_s,
           "p50_single_bootstrap_ms": sorted(lats)[len(lats) // 2] * 1e3,
           "kernel_launches": sum(counted)}
    return rec, (cx, cy, outc)


def inputs(B: int) -> tuple:
    """The (B,) bool plaintexts x and y, from numpy's generator seeded with 42."""
    rng = np.random.default_rng(42)
    return tuple(torch.from_numpy(rng.integers(0, 2, B, dtype=np.int64) == 1) for _ in range(2))


def result(rec: dict, tag: str, device, keygen_s: float, source: str) -> dict:
    """The JSON line of ``measure``'s record on set ``tag``'s keys."""
    on_card = torch.device(device).type == "cuda"
    extra = dict(rec, keygen_s=keygen_s, key_source=source, params=PARAMS_NOTE[tag],
                 backend=("csrc/blind_rotate.cu, one launch a gate batch (expanded F-block key)"
                          if on_card else "ops/fblock.blind_rotate_fblock, the plain version "
                          "(CPU tensors)"),
                 device=(f"{torch.cuda.get_device_name(device)} | {smi_line(device)}"
                         if on_card else "cpu"))
    return {"metric": "bootsAND_gates_per_sec_per_chip", "value": rec["chained_gates_per_s"],
            "unit": "gates/s", "extra": extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", type=int, nargs="?", default=4096)
    ap.add_argument("--l3", action="store_true", help="tfhe_128_tpu (else tfhe_128_tpu_fast)")
    ap.add_argument("--fresh-key", action="store_true", help="make the keys, ignore the cache")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench: torch.cuda.is_available() is false (--device cpu runs on the CPU)",
              file=sys.stderr)
        return 1
    tag = "l3" if args.l3 else "fast"
    sk, ck, keygen_s, source = keys(tag, device, args.fresh_key)
    log("bench", f"key ready from {source} ({keygen_s:.1f} s)")
    rec, _ = measure(sk, ck, *inputs(args.batch))
    print(json.dumps(result(rec, tag, device, keygen_s, source)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

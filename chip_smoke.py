#!/usr/bin/env python3
"""Smoke test of torus_fhe_tpu_torch on one NVIDIA GPU (Hopper, sm_90a).

Run from the root of the repository: ``python3 chip_smoke.py``. It builds the
blind-rotate kernel from torus_fhe_tpu_torch/csrc with nvcc, holds it against
its plain PyTorch version word for word, drives the single-key bootsAND gate
bootstrap at tfhe_128_tpu_fast (keygen -> encrypt -> gate -> decrypt) and at
tfhe_128_tpu, and prints informational times. Each phase prints one line;
the first failure ends the run with a non-zero code. The last three lines
are the kernels' JSON record, the card's name and power limit as nvidia-smi
gives them, and {"ok": true, "device": ...}. Without a CUDA device, or
outside the repository, it fails and prints no result. It imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

T0 = time.perf_counter()
DEVICE = "cuda"
SEED = 0
MAIN_BATCH = 1024
CHAIN = 4


def log(phase: str, msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {phase}: {msg}", flush=True)


def sync_time(fn):
    """(result, host seconds) of fn, synchronised on the card."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def event_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn on the card, by CUDA events, after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rand_i32(rng, shape, lo=-2**31, hi=2**31):
    return torch.from_numpy(rng.integers(lo, hi, shape, dtype=np.int64).astype(np.int32)).to(DEVICE)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from torus_fhe_tpu_torch.boot import api, bootstrap, gates
    from torus_fhe_tpu_torch.core import params as P
    from torus_fhe_tpu_torch.core.torus import decode_message
    from torus_fhe_tpu_torch.lwe import lwe_noiseless_trivial
    from torus_fhe_tpu_torch.ops import cuda_rotate, fblock

    dev = torch.device(DEVICE)
    kind = torch.cuda.get_device_name(0)

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    log("device", f"{kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}")

    # 2. build
    t = time.perf_counter()
    so, report = cuda_rotate.build()
    cuda_rotate._library()
    regs = [ln.strip() for ln in report.splitlines() if "registers" in ln]
    log("build", f"{so} in {time.perf_counter() - t:.1f} s; ptxas: {' || '.join(regs)}")

    def compare(tag, fb, geom, tg, acc, bara, barb, mu):
        """Kernel == plain version, word for word, in both init modes."""
        args = (geom, tg.decomp_length, tg.log2_base, tg.offset)
        for mode, a, sv in (("acc", acc, None), ("stepvec", None, (mu, barb))):
            got = cuda_rotate.blind_rotate_cuda(a, fb, bara, *args, stepvec=sv)
            want = fblock.blind_rotate_fblock(a, fb, bara, *args, stepvec=sv)
            torch.cuda.synchronize()
            err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item()
            if err:
                raise AssertionError(f"kernel != plain at {tag} {mode}: max |diff| {err}")
        log("kernel==plain", f"{tag}: B={bara.shape[0]} steps={fb.shape[0]} both modes equal")

    # 3. kernel against the plain version at small geometries
    rng = np.random.default_rng(SEED)
    base = P.test_parameters(n=12, N=64)
    twin = P.SchemeParams(**{**base.__dict__, "bs_decomp_length": 2, "bs_log2_base": 8,
                             "rlwe_mask_size": 2, "bk_drop_limbs": 1})
    for tag, params in (("test N=64 k=1", base), ("test N=256 k=1", P.test_parameters(n=12, N=256)),
                        ("k=2 l=2 Bg=2^8 drop-1 N=64", twin)):
        _, ck = api.make_key_pair(torch.Generator().manual_seed(SEED), params, device=dev)
        N, C = params.rlwe_polynomial_degree, params.rlwe_mask_size + 1
        for B in (1, 37):
            compare(tag, ck.bootstrap_key.fb, bootstrap.bk_geometry(params), params.tgsw,
                    rand_i32(rng, (B, C, N)), rand_i32(rng, (B, params.lwe_size), 0, 2 * N),
                    rand_i32(rng, (B,), -N, N), 1 << 29)

    # keys of the main path: tfhe_128_tpu_fast
    fast = P.tfhe_parameters_128_tpu_fast()
    gen = torch.Generator().manual_seed(SEED)
    (sk, ck), t_keygen = sync_time(lambda: api.make_key_pair(gen, fast, device=dev))
    _, t_fb = sync_time(lambda: bootstrap.bootstrap_key_from_samples(
        ck.bootstrap_key.samples, fast, dev))
    geom = bootstrap.bk_geometry(fast)
    N, C = fast.rlwe_polynomial_degree, fast.rlwe_mask_size + 1
    log("keygen", f"tfhe_128_tpu_fast: {t_keygen:.2f} s (F-block build {t_fb:.2f} s), "
        f"fb {tuple(ck.bootstrap_key.fb.shape)} = {ck.bootstrap_key.fb.numel() / 1e9:.2f} GB")
    compare("tfhe_128_tpu_fast key, first 16 steps", ck.bootstrap_key.fb[:16], geom, fast.tgsw,
            rand_i32(rng, (64, C, N)), rand_i32(rng, (64, 16), 0, 2 * N),
            rand_i32(rng, (64,), -N, N), gates.EIGHTH[1])

    # 4. main path: encrypt, bootsAND, a NAND chain, decrypt
    x = torch.from_numpy(rng.integers(0, 2, MAIN_BATCH).astype(bool)).to(dev)
    y = torch.from_numpy(rng.integers(0, 2, MAIN_BATCH).astype(bool)).to(dev)
    cx, cy = api.encrypt(gen, sk, x), api.encrypt(gen, sk, y)
    torch.cuda.synchronize()
    cuda_rotate.blind_rotate_cuda.launches = 0
    out, t_and = sync_time(lambda: gates.gate_and(ck, cx, cy))
    chain = [cx]
    for _ in range(CHAIN):
        chain.append(gates.gate_nand(ck, chain[-1], cy))
    torch.cuda.synchronize()
    launches = cuda_rotate.blind_rotate_cuda.launches
    if out.a.shape != (MAIN_BATCH, fast.lwe_size) or out.a.dtype != torch.int32:
        raise AssertionError(f"gate output {out.a.dtype} {tuple(out.a.shape)}")
    if not torch.equal(api.decrypt(sk, out), x & y):
        raise AssertionError("bootsAND decrypts wrong")
    want = x
    for t in range(1, CHAIN + 1):
        want = ~(want & y)
        if not torch.equal(api.decrypt(sk, chain[t]), want):
            raise AssertionError(f"NAND chain decrypts wrong at step {t}")
    if launches != 1 + CHAIN:
        raise AssertionError(f"main path launched the kernel {launches} times, not {1 + CHAIN}")
    log("main path", f"tfhe_128_tpu_fast B={MAIN_BATCH}: bootsAND ({t_and:.3f} s) and a "
        f"{CHAIN}-NAND chain decrypt correctly; kernel launches {launches}")

    # 5. second geometry: tfhe_128_tpu (N=1024, k=1, l=3)
    l3 = P.tfhe_parameters_128_tpu()
    sk3, ck3 = api.make_key_pair(torch.Generator().manual_seed(SEED + 1), l3, device=dev)
    x3 = torch.from_numpy(rng.integers(0, 2, 64).astype(bool)).to(dev)
    y3 = torch.from_numpy(rng.integers(0, 2, 64).astype(bool)).to(dev)
    c3x, c3y = api.encrypt(gen, sk3, x3), api.encrypt(gen, sk3, y3)
    if not torch.equal(api.decrypt(sk3, gates.gate_and(ck3, c3x, c3y)), x3 & y3):
        raise AssertionError("tfhe_128_tpu bootsAND decrypts wrong")
    N3 = l3.rlwe_polynomial_degree
    t3 = c3x + c3y
    compare("tfhe_128_tpu full key", ck3.bootstrap_key.fb, bootstrap.bk_geometry(l3), l3.tgsw,
            rand_i32(rng, (64, l3.rlwe_mask_size + 1, N3)), decode_message(t3.a, 2 * N3),
            decode_message(t3.b, 2 * N3), gates.EIGHTH[1])
    log("tfhe_128_tpu", "B=64 bootsAND decrypts correctly")
    del ck3

    # 6. times (informational) and the kernel at the main path's shapes
    t = cx + cy + lwe_noiseless_trivial(gates.EIGHTH[-1], fast.lwe, (MAIN_BATCH,), device=dev)
    bara, barb = decode_message(t.a, 2 * N), decode_message(t.b, 2 * N)  # the AND's mod-switch
    rot_args = (geom, fast.bs_decomp_length, fast.bs_log2_base, fast.tgsw.offset)
    sv = (gates.EIGHTH[1], barb)
    plain_out, plain_s = sync_time(lambda: fblock.blind_rotate_fblock(None, ck.bootstrap_key.fb,
                                                                      bara, *rot_args, stepvec=sv))
    kern_out = cuda_rotate.blind_rotate_cuda(None, ck.bootstrap_key.fb, bara, *rot_args, stepvec=sv)
    torch.cuda.synchronize()
    max_err = (kern_out.to(torch.int64) - plain_out.to(torch.int64)).abs().max().item()
    if max_err:
        raise AssertionError(f"kernel != plain at the main path's shapes: max |diff| {max_err}")
    log("kernel==plain", f"tfhe_128_tpu_fast full key B={MAIN_BATCH} stepvec: equal")
    # both init modes on the same work: the explicit accumulator is the test vector
    acc0 = fblock.stepvec_acc0(sv[0], barb, geom)
    modes = {"stepvec": (None, sv), "acc": (acc0, None)}
    times = {}
    for mode, (a, s) in modes.items():
        plain = event_ms(lambda: fblock.blind_rotate_fblock(a, ck.bootstrap_key.fb, bara,
                                                           *rot_args, stepvec=s), 1)
        kern = event_ms(lambda: cuda_rotate.blind_rotate_cuda(a, ck.bootstrap_key.fb, bara,
                                                             *rot_args, stepvec=s), 3)
        times[mode] = (kern, plain)
        log("rotate time", f"tfhe_128_tpu_fast B={MAIN_BATCH} {mode}: kernel {kern:.3f} ms, "
            f"plain {plain:.3f} ms (plain cold {plain_s:.3f} s)")
    ms, plain_ms = times["stepvec"]
    gate_s = [sync_time(lambda: gates.gate_and(ck, cx, cy))[1] for _ in range(3)]
    c1x, c1y = api.encrypt(gen, sk, x[:1]), api.encrypt(gen, sk, y[:1])
    lat = [sync_time(lambda: gates.gate_and(ck, c1x, c1y))[1] for _ in range(11)]
    log("times", f"keygen {t_keygen:.2f} s, F-block build {t_fb:.2f} s; bootsAND B={MAIN_BATCH}: "
        f"{MAIN_BATCH / statistics.mean(gate_s):.1f} gates/s through the kernel; plain blind "
        f"rotate {MAIN_BATCH / (plain_ms / 1e3):.1f} rotations/s, kernel blind rotate "
        f"{MAIN_BATCH / (ms / 1e3):.1f} rotations/s; p50 bootsAND latency B=1 "
        f"{statistics.median(lat) * 1e3:.2f} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    print(json.dumps({"kernels": [{
        "name": "blind_rotate", "route": "cuda",
        "source": "torus_fhe_tpu_torch/csrc/blind_rotate.cu",
        "replaces": "torus_fhe_tpu/ops/pallas_rotate.py:264",
        "launches": launches, "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

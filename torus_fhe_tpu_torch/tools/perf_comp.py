#!/usr/bin/env python3
"""Times one multikey NAND for each scheme (3gen, CCS, KMS) at each party
count, on one NVIDIA GPU: the port's counterpart of the JAX package's
``benchmarks/perf_comp.py`` and of the reference protocol it follows.

Run it as a script from the root of the repository, e.g.
``python3 torus_fhe_tpu_torch/tools/perf_comp.py --real --parties 2 4 8 16
--trials 3``. Per party count and scheme it takes the set (``params_for``:
the registry's ``mk_<P>party_<scheme>`` with ``--real``, the fixed set
``mk_<SUFFIX>party_<scheme>`` at P parties with ``--fixed-set SUFFIX``,
else the test set at ``--n``/``--N``), makes the keys, and times one NAND of
``--batch`` gates over all four input pairs: one warm-up call, then
``--trials`` calls, each ended by a synchronise. Each row is
decrypt-checked and held to its scheme's noise gate (3gen: 0 wrong; CCS:
the std within CCS_NOISE_BAND of ``scheme_noise.ccs_noise_std`` on the
key, and at most ``allowed_wrong`` wrong; KMS: 0 wrong and max
|phase - ideal| < PHASE_BOUND), and prints one JSON line: the JAX script's
``--out`` keys, then the key's bytes on the card beside those from shapes,
the CMux steps and ms a step, peak memory, the launches of each rotate
kernel and the bound from shapes. The first line names the card and its
power limit. A row that fails its checks ends the run with exit code 1.

The CCS and KMS keygens (host numpy) run in worker processes, all started
at once, so that the device times one row while the next keys are made;
the 3gen keygens run in this process, on the device. ``--keygen-only``
makes the keys, keeps each in ``.cache/keys/`` (utils/serialize files) and
times nothing; a later run with the same flags loads them from there.
``--no-fblock`` takes the conv forms: the exact 64-bit route for 3gen, the
conv keys for CCS and KMS. Without it 3gen takes
``mk.keys3gen.default_forms`` and CCS and KMS their fb forms.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
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

from torus_fhe_tpu_torch import bridge, mk  # noqa: E402
from torus_fhe_tpu_torch.core import params as P  # noqa: E402
from torus_fhe_tpu_torch.mk import ccs, gates3gen, keys3gen, kms  # noqa: E402
from torus_fhe_tpu_torch.ops import cuda_rotate, fblock, poly  # noqa: E402
from torus_fhe_tpu_torch.tools import smi_line, sync  # noqa: E402
from torus_fhe_tpu_torch.tools.scheme_noise import (allowed_wrong, ccs_noise_std,  # noqa: E402
                                                    phase_error)
from torus_fhe_tpu_torch.utils import serialize  # noqa: E402

SCHEMES = ("3gen", "ccs", "kms")
GATES = {"3gen": gates3gen.mk_gate_nand, "ccs": ccs.mk_gate_nand, "kms": kms.mk_gate_nand}
KEYGEN_FNS = {"3gen": (mk.mk_party_keygen, mk.mk_cloud_keygen),  # party keygen, cloud keygen
              "ccs": (ccs.ccs_party_keygen, ccs.ccs_cloud_keygen),
              "kms": (kms.kms_party_keygen, kms.kms_cloud_keygen)}
PHASE_BOUND = 1 / 16  # max |phase - ideal| of a KMS gate
# a CCS gate's noise std against ccs_noise_std on its key
CCS_NOISE_BAND = (0.75, 1.5)
# the fields of a CCS / KMS cloud key that a keygen worker hands over
# (bridge.{ccs,kms}_cloud_key_from_numpy takes them by name)
HANDED_FIELDS = {"ccs": ("d_sel", "f0_sel", "f1_sel", "pk_kern", "sk_kern", "ks_mats"),
                 "kms": ("gsw_sel", "d_kern", "f0_kern", "f1_kern", "pk_kern", "sk_kern",
                         "ks_mats")}
CONV_HANDED = {"ccs": ("d_kern", "f0_kern", "f1_kern", "pk_kern", "sk_kern", "ks_mats"),
               "kms": ("gsw_kern", "d_kern", "f0_kern", "f1_kern", "pk_kern", "sk_kern",
                       "ks_mats")}
KEYGENS = {}  # name -> (worker process, its directory); "tmp": the directory they share
KEYGEN_WAIT_S = 1800  # a row waits at most this long for its keygen worker
CACHE_DIR = os.path.join(ROOT, ".cache", "keys")


def params_for(scheme: str, parties: int, real: bool = False, fixed_set=None, n: int = 16,
               N: int = 64):
    """The set of one row (benchmarks/perf_comp.py:128-141): the fixed
    registry set at ``parties`` parties, the registry's own set, or the
    test set."""
    if fixed_set is not None:
        params = P.PARAMETER_REGISTRY[f"mk_{fixed_set}party_{scheme}"]()
        return dataclasses.replace(params, max_parties=parties)
    if real:
        return P.PARAMETER_REGISTRY[f"mk_{parties}party_{scheme}"]()
    make = {"3gen": P.test_parameters_3gen, "ccs": P.test_parameters_ccs,
            "kms": P.test_parameters_kms}[scheme]
    return make(parties=parties, n=n, N=N)


def size_tag(real: bool, fixed_set, n: int, N: int) -> str:
    if fixed_set is not None:
        return f"fx{fixed_set}"
    return "real" if real else f"n{n}N{N}"


def scheme_key_bytes(params, parties: int) -> int:
    """Bytes of a CCS or KMS cloud key in its fb form on the card, from the
    set's shapes: CCS the d1/f0/f1 lines (3 x P*n*l*2N*4), the expanded
    public-key and shared-key blocks ((P+1) x 2N*l x 4*bs) and their packed
    kernels; KMS the TGSW lines (P*n*2l*2N*16) and the packed uni, public
    and shared kernels (8 limbs of l_uni x N each); both the keyswitch
    tables (P x N*l_ks*(2^log2 - 1) x (n+1)*4 padded to a multiple of 8)."""
    n, N = params.lwe_size, params.rlwe_polynomial_degree
    ks = params.ks
    tables = parties * N * ks.decomp_length * ((1 << ks.log2_base) - 1) * (-(-(n + 1) * 4 // 8) * 8)
    if isinstance(params, P.SchemeParamsCCS):
        l, bs = params.bs_decomp_length, min(128, N)
        lines = 3 * parties * n * l * 2 * N * 4
        blocks = (parties + 1) * 2 * N * l * 4 * bs
        return lines + blocks + (parties + 1) * 4 * l * N + tables
    lines = parties * n * 2 * params.gsw_decomp_length * 2 * N * 16
    return lines + (4 * parties + 1) * 8 * params.uni_decomp_length * N + tables


def key_bytes_3gen(params, parties: int, forms: tuple) -> int:
    """Bytes of a 3gen cloud key on the card, from the set's shapes: the
    expanded key (steps x D*R*bs x ncols*bs) or the compact lines (steps x
    R x 2N x ncols; at a wide-digit set and in the exact form those of the
    raw 64-bit samples), and the keyswitch tables (N*l_ks*(2^log2 - 1) x
    P*(n+1)*4 padded to a multiple of 8)."""
    ks = params.ks
    tables = (params.rlwe_polynomial_degree * ks.decomp_length * ((1 << ks.log2_base) - 1)
              * (-(-parties * (params.lwe_size + 1) * 4 // 8) * 8))
    exact = forms == ("conv",) or not keys3gen.mk_fb_supported(params)
    g = (keys3gen.mk_fb64_geometry if exact else keys3gen.mk_fb_geometry)(params, parties)
    if "fblock" in forms:
        return g.n * g.D * g.R * g.bs * len(g.cols) * g.bs + tables
    return g.n * g.R * 2 * g.N * len(g.cols) + tables


def key_bytes(ck) -> int:
    """Bytes of a cloud key's tensors on its device (a 3gen key's raw
    samples, kept on the host for its file, left out)."""
    return sum(v.numel() * v.element_size() for k, v in vars(ck).items()
               if isinstance(v, torch.Tensor) and k != "bk_samples")


def scheme_keys(scheme: str, params, seed: int, device, forms: tuple, keep_samples: bool = False):
    """(cloud key, secret keys) of ``params`` in ``forms`` from a CPU
    generator seeded with ``seed``: the parties' keygens, then the cloud
    keygen on ``device`` (a 3gen key keeps its raw samples with
    ``keep_samples``)."""
    party, cloud = KEYGEN_FNS[scheme]
    gen = torch.Generator().manual_seed(seed)
    sks = [party(gen, params, device=device) for _ in range(params.max_parties)]
    extra = {"keep_samples": keep_samples} if scheme == "3gen" else {}
    return cloud(gen, sks, params, device=device, forms=forms, **extra), sks


def scheme_keygen(params, seed: int, out_dir: str, forms=("fb",), cache=None) -> None:
    """One CCS or KMS keygen in a worker process, on the CPU: the parties'
    keys and the cloud key of ``params`` in ``forms`` from a CPU generator
    seeded with ``seed`` (the key a function of the seed, as on the card),
    saved into ``out_dir`` as the fields of the JAX package's cloud key that
    bridge.{ccs,kms}_cloud_key_from_numpy take (``HANDED_FIELDS``, or
    ``CONV_HANDED`` for the conv form), the parties' LWE and ring keys, and
    keygen.json: its wall seconds and the shares of build_sel (the compact
    lines and their limb split), tgsw_encrypt and keyswitch_keygen in it.
    With ``cache`` (a path), the key is also saved there (``save_cache``)."""
    torch.set_num_threads(1)
    scheme, short = (ccs, "ccs") if isinstance(params, P.SchemeParamsCCS) else (kms, "kms")
    shares = {"build_sel": 0.0, "tgsw_encrypt": 0.0, "keyswitch_keygen": 0.0}

    def timed(module, fn_name):  # the share of one function, in this process only
        fn = getattr(module, fn_name)

        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                shares[fn_name] += time.perf_counter() - t
        setattr(module, fn_name, run)

    timed(fblock, "build_sel")
    timed(scheme, "keyswitch_keygen")
    if scheme is kms:
        timed(kms, "tgsw_encrypt")
    t0 = time.perf_counter()
    ck, sks = scheme_keys(short, params, seed, "cpu", forms)
    t_keygen = time.perf_counter() - t0
    t = time.perf_counter()
    for field in (HANDED_FIELDS if forms == ("fb",) else CONV_HANDED)[short]:
        np.save(os.path.join(out_dir, f"{field}.npy"), getattr(ck, field).numpy())
    np.save(os.path.join(out_dir, "lwe_keys.npy"), np.stack([sk.lwe.key.numpy() for sk in sks]))
    np.save(os.path.join(out_dir, "rlwe_keys.npy"), np.stack([sk.rlwe.key.numpy() for sk in sks]))
    if cache is not None:
        save_cache(cache, short, ck, sks)
    rec = {"keygen_s": t_keygen, "shares_s": shares, "save_s": time.perf_counter() - t}
    with open(os.path.join(out_dir, "keygen.json"), "w") as fh:
        json.dump(rec, fh)


def start_keygens(jobs, prefix: str = "keygen_") -> None:
    """Start one spawned keygen worker (``scheme_keygen``) a job, each
    writing its key into a directory of one temporary directory
    (KEYGENS). jobs: (name, params, seed, forms, cache path or None)."""
    import multiprocessing
    import tempfile

    if "tmp" not in KEYGENS:
        KEYGENS["tmp"] = tempfile.TemporaryDirectory(prefix=prefix)
    ctx = multiprocessing.get_context("spawn")
    for name, params, seed, forms, cache in jobs:
        out_dir = os.path.join(KEYGENS["tmp"].name, name)
        os.makedirs(out_dir)
        proc = ctx.Process(target=scheme_keygen, args=(params, seed, out_dir, forms, cache),
                           name=f"keygen {name}", daemon=True)
        proc.start()
        KEYGENS[name] = (proc, out_dir)


def stop_keygens() -> None:
    """End every keygen worker still running and remove their directory."""
    for name, entry in list(KEYGENS.items()):
        if name != "tmp" and entry[0].is_alive():
            entry[0].kill()
        if name != "tmp":
            entry[0].join(10)
    if "tmp" in KEYGENS:
        KEYGENS["tmp"].cleanup()
    KEYGENS.clear()


def take_key(name: str, params, device, wait_s: float, forms=("fb",)):
    """Join the keygen worker of ``name`` (at most ``wait_s``) and place its
    key on ``device`` through bridge.{ccs,kms}_cloud_key_from_numpy: (cloud
    key, secret keys, the worker's keygen.json, seconds waited, seconds to
    place the key); keygen.json gains ``npy_bytes``, the size of the files
    handed over. Raises if the worker did not end or failed."""
    import shutil

    proc, out_dir = KEYGENS.pop(name)
    t = time.perf_counter()
    proc.join(wait_s)
    t_wait = time.perf_counter() - t
    if proc.is_alive() or proc.exitcode != 0:
        raise RuntimeError(f"{name}: the keygen worker " + (
            "did not end" if proc.is_alive() else f"exited with code {proc.exitcode}"))
    with open(os.path.join(out_dir, "keygen.json")) as fh:
        made = json.load(fh)
    made["npy_bytes"] = sum(os.path.getsize(os.path.join(out_dir, f))
                            for f in os.listdir(out_dir) if f.endswith(".npy"))
    load = lambda f: np.load(os.path.join(out_dir, f"{f}.npy"), mmap_mode="r")
    short = "ccs" if isinstance(params, P.SchemeParamsCCS) else "kms"
    to_card = getattr(bridge, f"{short}_cloud_key_from_numpy")
    fields = (HANDED_FIELDS if forms == ("fb",) else CONV_HANDED)[short]
    t = time.perf_counter()
    ck = to_card(params, params.max_parties, device=device, forms=forms,
                 **{f: load(f) for f in fields})
    sks = bridge.mk_secret_keys_from_numpy(params, load("lwe_keys"), load("rlwe_keys"),
                                           device=device)
    sync(device)
    t_card = time.perf_counter() - t
    shutil.rmtree(out_dir)
    return ck, sks, made, t_wait, t_card


def cache_path(scheme: str, parties: int, tag: str, no_fblock: bool) -> str:
    return os.path.join(CACHE_DIR, f"perf_{scheme}{'' if no_fblock else '-fb'}_p{parties}_{tag}.npz")


def save_cache(path: str, scheme: str, ck, sks) -> None:
    """The cloud key (utils/serialize's file of its scheme) and, beside it,
    the parties' LWE and ring keys. utils/serialize writes each file whole
    or not at all, and the cloud key goes last: a file at ``path`` is whole
    and has its secrets beside it."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    save = {"3gen": serialize.save_mk_cloud_key, "ccs": serialize.save_ccs_cloud_key,
            "kms": serialize.save_kms_cloud_key}[scheme]
    serialize.save_named(path[:-4] + "_secrets.npz", "mk_secret_keys",
                         {"lwe": torch.stack([sk.lwe.key for sk in sks]),
                          "rlwe": torch.stack([sk.rlwe.key for sk in sks])}, params=ck.params)
    save(path, ck)


def load_cache(path: str, scheme: str, forms: tuple, device):
    """(cloud key, secret keys) of ``save_cache``'s files, on ``device``."""
    if scheme == "3gen":
        ck = serialize.load_mk_cloud_key(path, forms=forms, device=device)
    else:
        load = getattr(serialize, f"load_{scheme}_cloud_key")
        ck = load(path, device=device, forms=forms)
    _, arrs, params, _ = serialize.load_named(path[:-4] + "_secrets.npz")
    return ck, bridge.mk_secret_keys_from_numpy(params, arrs["lwe"], arrs["rlwe"], device=device)


def forms_for(scheme: str, params, no_fblock: bool) -> tuple:
    if scheme == "3gen":
        return ("conv",) if no_fblock else keys3gen.default_forms(params, params.max_parties)
    return ("conv",) if no_fblock else ("fb",)


def row_tag(scheme: str, forms: tuple) -> str:
    """The JAX script's scheme column: the key form after the scheme."""
    if scheme == "3gen":
        return {"fblock": "3gen-fb", "fbstream": "3gen-fbs", "conv": "3gen"}[forms[0]]
    return f"{scheme}-fb" if forms == ("fb",) else scheme


def row_kernel(scheme: str, ck):
    """The rotate kernel one NAND of this key launches once on the card:
    None off the card, for CCS and KMS, and for an exact (64-bit) 3gen key."""
    if scheme != "3gen" or ck.ks_mat.device.type != "cuda" or ck.exact:
        return None
    return "blind_rotate" if ck.bk_fb is not None else "blind_rotate_sel"


def digit_limbs(log2_base: int) -> int:
    """int8 limb blocks of a digit of ``log2_base`` bits."""
    return (log2_base + 8) // 8 if log2_base > 8 else 1


def ccs_bound(ck, B: int) -> tuple:
    """(ms, what bounds it) of a CCS NAND batch from shapes: per step, l
    digit rows of N a poly against 4 limb columns of N (u and each v one
    line a poly, w two: (P+1) x 4 contractions of the (P+1) digit polys),
    each digit limb block; the key and the batch's inputs and accumulators
    moved once."""
    params = ck.params
    P_, N, l = ck.parties, params.rlwe_polynomial_degree, params.bs_decomp_length
    steps = P_ * params.lwe_size
    macs = steps * digit_limbs(params.bs_log2_base) * B * (P_ + 1) * l * N * N * 4 * 4
    moved = key_bytes(ck) + B * steps * 4 + 2 * B * (P_ + 1) * N * 4
    return cuda_rotate.bound_ms(2 * macs, cuda_rotate.INT8_OPS_PER_S, moved)


def kms_bound(ck, B: int) -> tuple:
    """(ms, what bounds it) of a KMS NAND batch from shapes: the rotates'
    int8 products (party 0's B rows, each other party's B*l_lev TLev rows,
    n steps each) and the relinearisation's (the uni products of each
    party, the TLev products), each digit limb block; the key and the
    batch's inputs and accumulators moved once."""
    params = ck.params
    P_, N, n = ck.parties, params.rlwe_polynomial_degree, params.lwe_size
    gp, geom = params.tgsw, kms.kms_fb_geometry(params, n)
    llev = params.lev_decomp_length
    rot_macs = (n * digit_limbs(gp.log2_base) * (B + (P_ - 1) * B * llev) * geom.R * N * N
                * len(geom.cols))
    uni, lev = params.uni, params.tlev
    nu = digit_limbs(uni.log2_base)
    relin_macs = P_ * (nu * B * (P_ + 1) * uni.decomp_length * N * N * 8 * (P_ + 2)
                       + nu * B * uni.decomp_length * N * N * 8 * 2)
    relin_macs += (P_ - 1) * digit_limbs(lev.log2_base) * B * (P_ + 1) * llev * N * N * 16
    moved = key_bytes(ck) + B * P_ * n * 4 + 2 * B * (P_ + 1) * N * 8
    return cuda_rotate.bound_ms(2 * (rot_macs + relin_macs), cuda_rotate.INT8_OPS_PER_S, moved)


def bound_3gen(ck, B: int) -> tuple:
    """(ms, what bounds it) of a 3gen NAND batch's rotate from shapes: the
    int8 products of its steps (each digit limb block) and the key moved
    once (``cuda_rotate.rotate_bound_ms`` with the limb blocks)."""
    params, parties = ck.params, ck.parties
    geom = (keys3gen.mk_fb64_geometry if ck.exact else keys3gen.mk_fb_geometry)(params, parties)
    nl = digit_limbs(params.gsw_log2_base) if ck.exact else 1
    macs = nl * geom.n * B * (geom.R * geom.N) * (len(geom.cols) * geom.N)
    moved = key_bytes(ck) + B * geom.n * 4 + 2 * B * geom.C * geom.N * 4
    return cuda_rotate.bound_ms(2 * macs, cuda_rotate.INT8_OPS_PER_S, moved)


def row(scheme: str, ck, sks, B: int, trials: int, seed: int, warmup: bool = True) -> dict:
    """One row: a NAND batch of B gates over all four input pairs on the key
    ``ck`` (secret keys ``sks``), from a CPU generator seeded with ``seed``;
    with ``warmup`` one untimed call first, then ``trials`` calls, each
    timed on the host clock ending in a synchronise, their words equal to
    the first call's. The kernels' counts are set to 0 just before the
    first call and read after the last. The record holds the JAX script's
    row fields, ``correct`` (the decrypt check of the scheme: 0 wrong, at
    most ``allowed_wrong`` at CCS; the same words every call; the expected
    kernel launched once a call and no other, on the card; CCS's int8
    products (P+3) a step and one a party's keyswitch) and ``noise_ok``
    (the scheme's noise gate)."""
    params, device = ck.params, sks[0].lwe.key.device
    parties, n = ck.parties, params.lwe_size
    steps = parties * n
    keys = [sk.lwe for sk in sks]
    gen = torch.Generator().manual_seed(seed)
    pairs = torch.from_numpy(np.random.default_rng(seed).permutation(np.arange(B) % 4)).to(device)
    x, y = pairs >= 2, pairs % 2 == 1
    cx, cy = mk.mk_encrypt(gen, keys, x, params), mk.mk_encrypt(gen, keys, y, params)
    gate = GATES[scheme]
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    sync(device)
    cuda_rotate.blind_rotate_cuda.launches = cuda_rotate.blind_rotate_sel_cuda.launches = 0
    poly.int8_matmul.calls = 0
    calls, walls, out, same = 0, [], None, True
    for k in range(int(warmup) + max(trials, 1)):
        t = time.perf_counter()
        got = gate(ck, cx, cy)
        sync(device)
        wall = time.perf_counter() - t
        calls += 1
        if out is None:
            out, first_s = got, wall
        else:
            same &= bool(torch.equal(got.a, out.a) and torch.equal(got.b, out.b))
        if k >= int(warmup):
            walls.append(wall)
    launches = {"blind_rotate": cuda_rotate.blind_rotate_cuda.launches,
                "blind_rotate_sel": cuda_rotate.blind_rotate_sel_cuda.launches}
    products = poly.int8_matmul.calls
    peak = torch.cuda.max_memory_allocated() if on_card else None
    want = ~(x & y)
    wrong, err_max, err_std, over = phase_error(out, keys, want, PHASE_BOUND)
    fails = []
    if out.a.shape != (B, parties, n) or out.a.dtype != torch.int32:
        fails.append(f"gate output {out.a.dtype} {tuple(out.a.shape)}")
    if not same:
        fails.append("a timed call's words differ from the first call's")
    kernel = row_kernel(scheme, ck)
    want_launches = dict.fromkeys(launches, 0)
    if kernel is not None:
        want_launches[kernel] = calls
    if on_card and launches != want_launches:
        fails.append(f"launches {launches}, want {want_launches}")
    if scheme == "ccs" and ck.d_sel is not None and products != calls * (steps * (parties + 3)
                                                                           + parties):
        fails.append(f"{products} int8 products in {calls} calls, want {steps} steps x "
                     f"{parties + 3} + {parties} keyswitches a call")
    rec = {"parties": parties, "scheme": scheme, "batch": B, "trials": len(walls),
           "min_s": min(walls), "median_s": statistics.median(walls),
           "gates_per_s": B / min(walls), "first_s": first_s, "steps": steps,
           "step_ms": min(walls) / steps * 1e3, "key_bytes": key_bytes(ck), "peak_bytes": peak,
           "launches": launches, "int8_products": products, "wrong": wrong,
           "phase_err_max": err_max, "over_bound": over, "boot_noise_std": err_std}
    if scheme == "ccs":
        pred = ccs_noise_std(params, ck, sks)
        allowed = allowed_wrong(B, pred * CCS_NOISE_BAND[1])
        ratio = err_std / pred
        if wrong > allowed:
            fails.append(f"{wrong} wrong, at most {allowed}")
        noise_ok = CCS_NOISE_BAND[0] <= ratio <= CCS_NOISE_BAND[1]
        rec.update(predicted_std=pred, predicted_std_expected=ccs_noise_std(params),
                   std_over_prediction=ratio, allowed_wrong=allowed)
        rec["gate"] = (f"std {err_std:.5f} = {ratio:.3f}x the predicted {pred:.5f} within "
                       f"{CCS_NOISE_BAND}, {wrong} wrong at most {allowed}")
    else:
        if wrong:
            fails.append(f"{wrong} wrong")
        noise_ok = scheme == "3gen" or err_max < PHASE_BOUND
        rec["gate"] = f"{wrong} wrong" + ("" if scheme == "3gen" else
                                          f", max |phase - ideal| {err_max:.5f} under {PHASE_BOUND}")
    rec["bound_ms"], rec["bound_by"] = {"3gen": bound_3gen, "ccs": ccs_bound,
                                        "kms": kms_bound}[scheme](ck, B)
    rec.update(correct=not fails, noise_ok=noise_ok, fails=fails)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parties", type=int, nargs="+", default=[2])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--n", type=int, default=16)
    ap.add_argument("--N", type=int, default=64)
    ap.add_argument("--schemes", nargs="+", default=list(SCHEMES), choices=SCHEMES)
    ap.add_argument("--real", action="store_true",
                    help="the registry's set mk_<P>party_<scheme> at each party count")
    ap.add_argument("--fixed-set", default=None, metavar="SUFFIX",
                    help="the registry set mk_<SUFFIX>party_<scheme> at every party count")
    ap.add_argument("--no-fblock", action="store_true",
                    help="the conv forms: 3gen's exact route, CCS's and KMS's conv keys")
    ap.add_argument("--keygen-only", action="store_true",
                    help="make the keys and keep them in .cache/keys/, time nothing")
    ap.add_argument("--out", default=None, help="append the rows to this JSON file")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("perf_comp: torch.cuda.is_available() is false (--device cpu runs on the CPU)",
              file=sys.stderr)
        return 1
    tag = size_tag(args.real, args.fixed_set, args.n, args.N)
    size = (f"fixed-set mk_{args.fixed_set}party" if args.fixed_set is not None else
            "registry(real)" if args.real else f"n={args.n} N={args.N}")
    smi = smi_line(device)
    print(smi, flush=True)
    plan = []
    for parties in args.parties:
        for scheme in (s for s in SCHEMES if s in args.schemes):
            params = params_for(scheme, parties, args.real, args.fixed_set, args.n, args.N)
            forms = forms_for(scheme, params, args.no_fblock)
            path = cache_path(scheme, parties, tag, args.no_fblock)
            plan.append((f"{scheme}_p{parties}", scheme, params, forms, path,
                         100 * parties + 10 * SCHEMES.index(scheme)))
    # the CCS and KMS keygens overlap the device's rows, in worker processes
    workers = [(name, params, seed, forms, path if args.keygen_only else None)
               for name, scheme, params, forms, path, seed in plan
               if scheme != "3gen" and not os.path.exists(path)]
    rows, status = [], 0
    try:
        start_keygens(workers, prefix="perf_comp_")
        for name, scheme, params, forms, path, seed in plan:
            t = time.perf_counter()
            if name in KEYGENS:  # its worker also writes the cache with --keygen-only
                ck, sks, made, t_wait, t_card = take_key(name, params, device, KEYGEN_WAIT_S,
                                                         forms)
                made.update(waited_s=t_wait, to_device_s=t_card)
            elif os.path.exists(path):
                ck, sks = load_cache(path, scheme, forms, device)
                made = {"cached": path}
            else:  # a 3gen key, in this process
                ck, sks = scheme_keys(scheme, params, seed, device, forms,
                                      keep_samples=args.keygen_only)
                if args.keygen_only:
                    save_cache(path, scheme, ck, sks)
                made = {"keygen_s": time.perf_counter() - t}
            sync(device)
            made["key_s"] = time.perf_counter() - t
            if args.keygen_only:
                print(f"# keygen-only: {name} cached at {path}", file=sys.stderr, flush=True)
                del ck, sks
                continue
            rec = row(scheme, ck, sks, args.batch, args.trials, seed + 1)
            rec.update(scheme=row_tag(scheme, forms), size=size, device=str(device), card=smi,
                       key_bytes_from_shapes=(key_bytes_3gen(params, params.max_parties, forms)
                                              if scheme == "3gen" else
                                              scheme_key_bytes(params, params.max_parties)),
                       keygen=made)
            if scheme != "3gen" and forms != ("fb",):
                rec["key_bytes_from_shapes"] = None  # the shapes above are the fb form's
            elif rec["key_bytes"] != rec["key_bytes_from_shapes"]:
                rec["fails"].append("key bytes differ from those from shapes")
                rec["correct"] = False
            print(json.dumps(rec), flush=True)
            rows.append(rec)
            del ck, sks
            if not (rec["correct"] and rec["noise_ok"]):
                print(f"perf_comp: {name} failed: {'; '.join(rec['fails']) or rec['gate']}",
                      file=sys.stderr)
                status = 1
                break
    finally:
        stop_keygens()
    if args.out and rows:
        payload = []
        if os.path.exists(args.out):
            with open(args.out) as fh:
                payload = json.load(fh)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(payload + rows, fh, indent=1)
    return status


if __name__ == "__main__":
    sys.exit(main())

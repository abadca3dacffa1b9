"""One run of one cell: set-up, the measured window, the comparison that
decides ``correct``, and the result line.

Everything a cell needs is found by name from BENCHMARK.json: its
configuration (perfbench/configs/<config>.json), whose ``scheme`` names
the scheme's key material and reference (perfbench/schemes/<scheme>.py)
and its program side (perfbench/drive/<scheme>.py); its traffic mix
(perfbench/traffic/<traffic>.json), whose ``kind`` names its generator
(perfbench/kinds/<kind>.py) and, for a circuit, whose ``circuit`` names
perfbench/circuits/<circuit>.py; and every metric's reader
(perfbench/metrics/<metric>.py, a ``read(run)`` that returns a number, or
None where it finds nothing to read).

Set-up is everything from the process's start to the window: imports, the
key material made from the seed on the card (keys.py), the program's key
forms (program.py, the ``keygen_s`` span, ended by a synchronise), the
traffic's inputs and one warm-up of every shape the window uses (which
builds or loads the kernel libraries). With ``trace`` the window runs
under the profiler (tracing.py). After the window: the peak device memory,
the program's state freed, then the plain reference (reference.py) on the
kept gates or circuits.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from . import keys as K
from . import traffic, tracing
from .traffic import sync
from .reference import Reference

FORBIDDEN = ("jax", "jaxlib", "flax", "torus_fhe_tpu")  # top-level names, compared whole


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def entry(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(root: str, spec: dict, name: str) -> dict:
    with open(os.path.join(root, entry(spec["configs"], name, "configuration")["file"])) as fh:
        return json.load(fh)


def reader(root: str, name: str):
    """The ``read`` of perfbench/metrics/<name>.py."""
    path = os.path.join(root, "perfbench", "metrics", f"{name}.py")
    mod_spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_"),
                                                      path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def metrics_of(spec: dict, kind: str, workload: str) -> list:
    """The metrics of ``kind`` ("end_to_end" or "per_layer") that a cell
    reports: those that list it, and those that list no cells."""
    return [m for m in spec[kind] if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "-i", str(device.index or 0),
                              "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or torch.cuda.get_device_name(device)
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(device) + ", power limit not read"


def log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


class Setup(NamedTuple):
    cfg: dict
    mix: dict
    keys: K.Keys
    work: object  # the traffic generator of the cell, which holds the program
    material_s: float
    keygen_s: float
    warmup_s: float  # the traffic's inputs and the warm-up


def prepare(root: str, workload: str, seed: int, device, spec: dict,
            config: dict | None = None, mix: dict | None = None) -> Setup:
    """A cell's set-up: key material from the seed, the program's key forms,
    the traffic's inputs, one warm-up. ``config``, ``mix``: in place of the
    cell's configuration and traffic files (the tests' small sizes)."""
    from . import program  # the system under test

    wl = entry(spec["workloads"], workload, "workload")
    cfg = config or load_config(root, spec, wl["config"])
    mix = mix or traffic.load(root, wl["traffic"])
    gen = torch.Generator(device=device).manual_seed(seed)
    rng = np.random.default_rng(seed)
    t = time.perf_counter()
    keys = K.make_keys(gen, cfg)
    sync(device)
    material_s = time.perf_counter() - t
    t = time.perf_counter()
    prog = program.Program(cfg, keys, device)
    sync(device)
    keygen_s = time.perf_counter() - t
    t = time.perf_counter()
    work = traffic.make(mix, cfg, keys, prog, rng, gen, device)
    work.warmup()
    sync(device)
    return Setup(cfg, mix, keys, work, material_s, keygen_s, time.perf_counter() - t)


def difference(after, before):
    """A counter's growth over the window; of a dict of counts (launches per
    tile config), the entries that grew."""
    if isinstance(after, dict):
        return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}
    return after - before


def release(work) -> None:
    """Free the program's state (its cloud key) before the reference runs."""
    work.prog = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             device, started: float, spec: dict | None = None, config: dict | None = None,
             mix: dict | None = None) -> dict:
    """One run of ``workload``; ``started``: the perf_counter reading at the
    process's start. ``spec``, ``config``, ``mix``: in place of
    BENCHMARK.json, of the cell's configuration file and of its traffic file
    (the tests' small sizes). Returns the result line as a dict, ``checks``
    last."""
    from . import program

    device = torch.device(device)
    spec = spec or load_spec(root)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    entered = time.perf_counter() - started
    cfg, mix, keys, work, material_s, keygen_s, warmup_s = prepare(root, workload, seed, device,
                                                                   spec, config, mix)
    log(f"{workload} seed {seed}: imports and device {entered:.3f} s, key material "
        f"{material_s:.3f} s, program key forms {keygen_s:.3f} s, inputs and warm-up "
        f"{warmup_s:.3f} s, set-up {time.perf_counter() - started:.3f} s")

    before = program.counters()
    tr = {}
    setup_s = time.perf_counter() - started
    if trace:
        from torch.profiler import record_function
        with tracing.traced(device, tr):
            with record_function(tracing.WINDOW):
                rec = work.window(seconds)
    else:
        rec = work.window(seconds)
    after = program.counters()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    release(work)
    t = time.perf_counter()
    checks = work.check(Reference(cfg, keys), keys)
    log(f"reference: {time.perf_counter() - t:.3f} s for {checks['gates_compared']} gates, "
        f"{checks['words_compared']} words")

    run = dict(rec, workload=workload, config=cfg, mix=mix, seconds=seconds, setup_s=setup_s,
               keygen_s=keygen_s, material_s=material_s, trace=tr or None,
               counters={k: difference(after[k], before[k]) for k in after})
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(spec, kind, workload):
        value = reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = (checks["words_differing"] == 0 and checks["bits_wrong"] == 0
               and checks["gates_compared"] > 0)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": rec["units"] if rec["gates"] == 0 else rec["gates"],
              "failed": checks["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        log(f"trace: intact {tr['intact']}, device s by category {tr['device_s']}, "
            f"records {tr['records']}")
        log("spans: " + ", ".join(f"{k} count {v['count']} idle {v['idle_s']:.3f} s device "
                                  f"{v['device_s']:.3f} s syncs {v['syncs']}"
                                  for k, v in tr["spans"].items()))
    result["card"] = card(device)
    result["checks"] = {
        "words_differing": {"value": checks["words_differing"], "at_most": 0},
        "bits_wrong": {"value": checks["bits_wrong"], "at_most": 0},
        "gates_compared": {"value": checks["gates_compared"], "at_least": 1},
    }
    log(f"window {rec['window_s']:.3f} s, {rec['units']} units, counters {run['counters']}, "
        f"compared {checks}")
    lat = [1e3 * s for s in rec.get("latencies_s") or []]
    if len(lat) >= 10:
        q = statistics.quantiles(lat, n=10)
        tenths = [statistics.median(lat[i * len(lat) // 10:(i + 1) * len(lat) // 10])
                  for i in range(10)]
        log(f"latency ms: min {min(lat):.2f}, p10 {q[0]:.2f}, p50 {q[4]:.2f}, p90 {q[8]:.2f}, "
            f"max {max(lat):.2f}; median by tenth of the window "
            + " ".join(f"{t:.2f}" for t in tenths))
    return result

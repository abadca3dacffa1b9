"""The ranks of tests/test_torch_distributed.py: ``spawn`` starts a gloo
process group of CPU ranks and runs a list of tasks in each, and the tasks
drive the port's mesh across the ranks. Every rank returns its results as
numpy arrays; the test compares them with the JAX package and the port's
one-process mesh.

It imports torch, numpy and the port only (no JAX, even where JAX is
installed): the ``spawn`` start method imports this module again in every
rank. pytest does not collect it.
"""

import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torus_fhe_tpu_torch import bridge
from torus_fhe_tpu_torch.boot import gates
from torus_fhe_tpu_torch.core import params as tparams
from torus_fhe_tpu_torch.mk import keys3gen
from torus_fhe_tpu_torch.parallel import mesh as tmesh
from torus_fhe_tpu_torch.parallel import mk_pipeline as tpipe
from torus_fhe_tpu_torch.parallel import sharded
from torus_fhe_tpu_torch.parallel.dryrun import dryrun_multichip

CPU = torch.device("cpu")
COLLECTIVE_S = 30  # the process group's timeout: a collective waits at most this long
JOIN_S = 90  # all ranks of one spawn finish within this, or they are killed


def _slots(world, count):
    """This rank's share of ``count`` mesh slots, all on the CPU."""
    return [CPU] * (count // world)


def pipeline(world, params, samples, ks_mat, parties, bara, barb, mu32, mu64, cases,
             t_a, t_b):
    """The pipelined rotate for each (form, microbatches) of ``cases`` and
    the pipelined bootstrap, over ``parties`` party slots spread evenly over
    the ranks; ``held``: which parties' shards this rank holds."""
    tp = tparams.SchemeParams3Gen(**params)
    mesh = tmesh.make_mesh(n_batch=1, n_party=parties, devices=_slots(world, parties))
    shards = {"expanded": tpipe.build_sharded_mk_fb(samples, tp, parties, mesh),
              "compact": tpipe.build_sharded_mk_sel(samples, tp, parties, mesh)}
    out = {"held": np.array([[s is not None for s in shards[f]] for f in shards])}
    bara_t, barb_t = torch.from_numpy(bara), torch.from_numpy(barb)
    for form, m in cases:
        out[f"rotate_{form}_{m}"] = tpipe.mk_blind_rotate_pipelined(
            shards[form], bara_t, barb_t, mu32, tp, parties, mesh, microbatches=m).numpy()
    ck = keys3gen.MKCloudKey(keys3gen.pad_table(torch.from_numpy(ks_mat)), parties, tp)
    t = bridge.mk_lwe_from_numpy(t_a, t_b, device="cpu")
    for form in shards:
        boot = tpipe.mk_bootstrap_pipelined(ck, shards[form], mu64, t, mesh, microbatches=4)
        out[f"boot_{form}_a"], out[f"boot_{form}_b"] = boot.a.numpy(), boot.b.numpy()
    return out


def keyswitch(world, params, samples, ks_mat, parties, slots, a, b):
    """mk_keyswitch_sharded over ``slots`` party slots spread over the ranks."""
    tp = tparams.SchemeParams3Gen(**params)
    ck = keys3gen.MKCloudKey(keys3gen.pad_table(torch.from_numpy(ks_mat)), parties, tp)
    mesh = tmesh.make_mesh(n_batch=1, n_party=slots, devices=_slots(world, slots))
    tables = sharded.mk_ks_tables_sharded(ck, mesh)
    got = sharded.mk_keyswitch_sharded(ck, tables, bridge.lwe_from_numpy(a, b, device="cpu"),
                                       mesh)
    return {"held": np.array([t is not None for t in tables]), "a": got.a.numpy(),
            "b": got.b.numpy()}


def threshold(world, sample_a, shares, signs, sd, slots):
    """threshold_decrypt_sharded with a generator seeded by the rank: only
    rank 0's draws the smudging seeds."""
    mesh = tmesh.make_mesh(n_batch=1, n_party=slots, devices=_slots(world, slots))
    gen = torch.Generator().manual_seed(1000 + tmesh.process_rank())
    return {"out": sharded.threshold_decrypt_sharded(torch.from_numpy(sample_a), shares, signs,
                                                     sd, gen, mesh).numpy()}


def party_sum(world, parts):
    """party_sum of rank r's ``parts[r]``."""
    return {"sum": tmesh.party_sum(torch.from_numpy(parts[tmesh.process_rank()])).numpy()}


def batch_gate(world, params, samples, ks_mat, n_in, n_out, slots, x_a, x_b, y_a, y_b):
    """run_batch_sharded(gate_and) over ``slots`` batch slots spread over the
    ranks."""
    tp = tparams.SchemeParams(**params)
    ck = bridge.cloud_key_from_numpy(tp, samples, ks_mat, n_in, n_out, device="cpu")
    mesh = tmesh.make_mesh(n_batch=slots, devices=_slots(world, slots))
    xs = tmesh.shard_lwe_batch(bridge.lwe_from_numpy(x_a, x_b, device="cpu"), mesh)
    ys = tmesh.shard_lwe_batch(bridge.lwe_from_numpy(y_a, y_b, device="cpu"), mesh)
    out = tmesh.run_batch_sharded(gates.gate_and, tmesh.replicate_cloud_key(ck, mesh), xs, ys,
                                  mesh=mesh)
    return {"chunks": np.array([c is not None for c in xs]), "a": out.a.numpy(),
            "b": out.b.numpy()}


def dryrun(world, slots):
    """dryrun_multichip with ``slots`` CPU slots a rank: its checks raise."""
    dryrun_multichip([CPU] * slots)
    return {"done": np.array(True)}


def fail_on_rank(world, rank):
    """Rank ``rank`` raises; the others wait in a party sum for it."""
    if tmesh.process_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    tmesh.party_sum(torch.zeros(4, dtype=torch.int32))
    return {}


def _rank(index, world, store, out_dir, tasks):
    torch.set_num_threads(1)
    tmesh.init_distributed(store, world, index, backend="gloo", timeout=COLLECTIVE_S)
    try:
        results = {}
        for label, name, kwargs in tasks:
            for key, value in globals()[name](world, **kwargs).items():
                results[f"{label}/{key}"] = value
        np.savez(os.path.join(out_dir, f"rank{index}.npz"), **results)
    finally:
        dist.destroy_process_group()


def start(tmp_path, world: int, tasks: list):
    """Start ``world`` gloo ranks on the CPU, which meet through a file
    store under ``tmp_path`` and run ``tasks`` ([(label, task name, its
    keyword arguments)], in order); ``collect`` waits for them."""
    ctx = mp.start_processes(_rank, args=(world, f"file://{tmp_path}/store", str(tmp_path), tasks),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, tmp_path, time.monotonic() + JOIN_S


def stop(handle) -> None:
    """Kill the ranks of ``handle`` that are still running."""
    for p in handle[0].processes:
        if p.is_alive():
            p.kill()
        p.join(10)


def collect(handle) -> list:
    """Each rank's results, {"label/key": array}, once all have ended.
    Raises what a rank raised, or TimeoutError JOIN_S after the start; no
    rank outlives it."""
    ctx, tmp_path, deadline = handle
    try:
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{len(ctx.processes)} ranks did not finish in {JOIN_S} s")
    finally:
        stop(handle)
    ranks = []
    for r in range(len(ctx.processes)):
        with np.load(os.path.join(tmp_path, f"rank{r}.npz")) as f:
            ranks.append(dict(f))
    return ranks


def spawn(tmp_path, world: int, tasks: list) -> list:
    """``collect(start(tmp_path, world, tasks))``."""
    return collect(start(tmp_path, world, tasks))

"""Device meshes, batch-sharded execution, and meshes across processes.

Port of torus_fhe_tpu/parallel/mesh.py. A mesh is a grid of
``torch.device``s with two axes:

  * ``batch``: data parallelism over independent gates. Each batch slot
    holds a copy of the cloud key and runs its chunk of the batch;
  * ``party``: the multikey / threshold party dimension. Party-axis work
    (parallel/sharded.py, parallel/mk_pipeline.py) runs each party's share on
    the party's device and sums or hands on the results.

In one process a mesh may name one device more than once: ``[cuda:0] * 8``
runs eight slots as eight CUDA streams of one card, and the same schedule
spreads over eight cards unchanged where there are eight. Results are
identical either way. Work of different slots goes on different streams, so
slots that share a card overlap.

Across processes (JAX's ``jax.distributed.initialize``): every process calls
``init_distributed`` once, then the same mesh functions with the same
arguments, as JAX's processes run one program. ``make_mesh`` gathers every
rank's devices in rank order and records the rank of each slot. A rank runs
only its own slots; the steps that cross slots become collectives of the
default process group: ``party_sum`` (JAX's ``psum``), ``send`` / ``recv``
(one hop of JAX's ``ppermute``) and ``broadcast``, which also makes each
rank's result whole, as JAX's global array is. The words are those of the
one-process mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Callable, Sequence

import torch
import torch.distributed as dist

BATCH_AXIS = "batch"
PARTY_AXIS = "party"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None,
                     timeout: float = 300.0) -> bool:
    """Join this process to the others of a run (JAX's
    ``jax.distributed.initialize``): call it once in every process before
    building meshes; afterwards ``make_mesh`` spans every process.

    The arguments default to torchrun's variables: ``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``. ``coordinator_address`` is
    ``host:port`` or an init URL (``tcp://host:port``, ``file:///path``).
    A single process (no variables, no arguments) is a no-op that returns
    False, so one-process flows pay no set-up; otherwise it returns True once
    the process group is up. ``backend`` None is ``"nccl"``, the card; the
    CPU, or several ranks on one card (NCCL refuses two ranks on one GPU),
    take ``"gloo"``. Under NCCL the rank's card, ``rank_device()``, becomes
    the current device. A collective that waits longer than ``timeout``
    seconds raises."""
    addr = coordinator_address
    if addr is None and os.environ.get("MASTER_ADDR"):
        addr = f"{os.environ['MASTER_ADDR']}:{os.environ.get('MASTER_PORT', '29500')}"
    nproc = num_processes if num_processes is not None else \
        int(os.environ.get("WORLD_SIZE", "0") or 0)
    if addr is None and nproc in (0, 1):
        return False
    if addr is None or nproc < 1:
        raise ValueError(f"init_distributed: {nproc or 'an unknown number of'} processes at "
                         f"{addr or 'no coordinator address'}: give both (coordinator_address "
                         "and num_processes, or MASTER_ADDR and WORLD_SIZE)")
    if process_id is None:
        env_rank = os.environ.get("RANK")
        # no default of 0: every process would claim rank 0 and the group would hang
        if env_rank is None:
            raise ValueError("init_distributed: the rank of this process is unknown; pass "
                             "process_id or set RANK")
        process_id = int(env_rank)
    backend = backend or "nccl"
    if backend == "nccl":
        torch.cuda.set_device(rank_device(process_id))
    dist.init_process_group(backend, init_method=addr if "://" in addr else f"tcp://{addr}",
                            world_size=nproc, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout))
    return True


def process_rank() -> int:
    """This process's rank; 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(rank: int | None = None) -> torch.device:
    """The card of a rank: cuda:(LOCAL_RANK % device count), LOCAL_RANK
    defaulting to the rank. Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("rank_device: no CUDA device; pass devices=[torch.device('cpu')] * k "
                           "to make_mesh to run the plain versions on the CPU")
    local = int(os.environ.get("LOCAL_RANK", process_rank() if rank is None else rank))
    return torch.device("cuda", local % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An (n_batch, n_party) grid of devices, ``devices[b][p]``, and the
    rank that owns each slot, ``ranks[b][p]``. ``ranks`` None: every slot is
    this process's (a one-process mesh, rank 0 without a process group)."""

    devices: tuple
    ranks: tuple | None = None
    axis_names = (BATCH_AXIS, PARTY_AXIS)  # a class constant, not a field

    @property
    def shape(self) -> dict:
        return {BATCH_AXIS: len(self.devices), PARTY_AXIS: len(self.devices[0])}

    @property
    def spans_processes(self) -> bool:
        """Whether the cross-slot steps are collectives of the process group."""
        return self.ranks is not None

    def _ranks(self) -> tuple:
        me = process_rank()
        return self.ranks or tuple((me,) * len(row) for row in self.devices)

    def batch_devices(self) -> list:
        """The device of each batch slot (its first party column)."""
        return [row[0] for row in self.devices]

    def party_devices(self) -> list:
        """The device of each party slot (the first batch row)."""
        return list(self.devices[0])

    def batch_ranks(self) -> list:
        """The rank of each batch slot."""
        return [row[0] for row in self._ranks()]

    def party_ranks(self) -> list:
        """The rank of each party slot."""
        return list(self._ranks()[0])

    def distinct_devices(self) -> list:
        """The distinct devices of this process's slots."""
        me = process_rank()
        return list(dict.fromkeys(d for row, ranks in zip(self.devices, self._ranks())
                                  for d, r in zip(row, ranks) if r == me))

    def home(self) -> torch.device:
        """Where this process's results land: its first slot's device, row
        by row (the first slot's in one process), else the mesh's first."""
        return (self.distinct_devices() or [self.devices[0][0]])[0]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_batch: int | None = None, n_party: int = 1,
              devices: Sequence | None = None) -> Mesh:
    """A (batch, party) mesh over ``devices``, row-major. With ``devices``
    None it takes every CUDA device (after ``init_distributed``: the rank's
    card, ``rank_device()``), and raises when there is none: a mesh never
    falls back to the CPU. After ``init_distributed`` every rank calls it,
    each with its own devices, and the mesh runs over all of them in rank
    order. With ``n_batch`` None every remaining device goes to the batch
    axis."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[torch.device('cpu')] * k "
                               "to run the plain versions on the CPU")
        devices = ([rank_device()] if dist.is_initialized() else
                   [torch.device("cuda", i) for i in range(torch.cuda.device_count())])
    devices = [_device(d) for d in devices]
    ranks = None
    if dist.is_initialized():
        everyone = [None] * dist.get_world_size()
        dist.all_gather_object(everyone, [str(d) for d in devices])
        devices = [torch.device(d) for ds in everyone for d in ds]
        ranks = [r for r, ds in enumerate(everyone) for _ in ds]
    if n_batch is None:
        n_batch = len(devices) // n_party
    if n_batch < 1 or n_party < 1 or n_batch * n_party > len(devices):
        raise ValueError(f"a ({n_batch}, {n_party}) mesh needs {n_batch * n_party} devices, "
                         f"got {len(devices)}")
    def grid(items):
        return tuple(tuple(items[b * n_party:(b + 1) * n_party]) for b in range(n_batch))

    return Mesh(grid(devices), None if ranks is None else grid(ranks))


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def shard_lwe_batch(sample, mesh: Mesh) -> list:
    """Split a batched sample (``LweSample`` or ``MKLweSample``) along its
    leading axis into one chunk per batch slot, each on the slot's device;
    None for a slot of another process. The batch must divide evenly
    (``pad_to_multiple``)."""
    devs, me = mesh.batch_devices(), process_rank()
    B = sample.b.shape[0]
    if B % len(devs):
        raise ValueError(f"batch {B} does not split over {len(devs)} batch slots")
    c = B // len(devs)
    return [type(sample)(*(f[i * c:(i + 1) * c].to(d) for f in sample)) if r == me else None
            for i, (d, r) in enumerate(zip(devs, mesh.batch_ranks()))]


def _to_device(tree, device):
    """A copy of a key (tensors inside NamedTuples and dataclasses) on
    ``device``; a tensor already there is not copied."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _to_device(getattr(tree, f.name), device)
                                            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(v, device) for v in tree))
    return tree


def replicate_cloud_key(ck, mesh: Mesh) -> dict:
    """{device: the cloud key on it}, one copy per DISTINCT device of this
    process's slots, so that a mesh that repeats a card holds one copy."""
    return {d: _to_device(ck, d) for d in mesh.distinct_devices()}


def new_stream(device: torch.device):
    """A new CUDA stream of ``device``, ordered after the work already on the
    device's current stream; None for the CPU."""
    if device.type != "cuda":
        return None
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    return stream


def use_stream(stream):
    """Make ``stream`` current for its device (nothing for None)."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


def join_stream(stream, tensors) -> None:
    """Order the current stream of ``stream``'s device after ``stream``, and
    mark the tensors made on ``stream`` as used by the current stream, so
    that the caching allocator does not hand out their memory while the
    current stream may still read them."""
    if stream is None:
        return
    current = torch.cuda.current_stream(stream.device)
    current.wait_stream(stream)
    for t in tensors:
        t.record_stream(current)


def _fields(out) -> list:
    return [out] if isinstance(out, torch.Tensor) else list(out)


def _host_wire() -> bool:
    """Whether the process group carries tensors in host memory: gloo does
    (CUDA tensors are staged through the host by the helpers below), NCCL
    reads and writes the card's."""
    return dist.get_backend() != "nccl"


def broadcast(t: torch.Tensor | None, src: int, shape, dtype, device) -> torch.Tensor:
    """Rank ``src``'s tensor ``t`` on every rank, on ``device``; the other
    ranks pass None and the ``shape`` and ``dtype`` it has."""
    if _host_wire():
        buf = t.cpu() if process_rank() == src else torch.empty(shape, dtype=dtype)
    else:
        buf = (t.to(device).contiguous() if process_rank() == src
               else torch.empty(shape, dtype=dtype, device=device))
    dist.broadcast(buf, src)
    return buf.to(device)


def party_sum(part: torch.Tensor) -> torch.Tensor:
    """The sum of every rank's ``part`` (JAX's ``psum`` over the mesh), on
    ``part``'s device. Each rank passes a part of one shape and dtype (zeros
    where it holds no slot). The parts are gathered and added by one torch
    sum here, so the words wrap mod 2^bits as the one-process sum does,
    whatever the backend's own reduction would do on overflow."""
    wire = part.cpu() if _host_wire() else part.contiguous()
    parts = [torch.empty_like(wire) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, wire)
    return torch.sum(torch.stack(parts), dim=0, dtype=part.dtype).to(part.device)


def send(t: torch.Tensor, dst: int, tag: int):
    """Start sending ``t`` to rank ``dst`` (one hop of JAX's ``ppermute``)
    and return what the caller keeps until it calls ``.wait()`` on the
    first item. Under NCCL the send follows the current stream's work;
    under gloo the copy to the host waits for that work first."""
    buf = t.cpu() if _host_wire() else t.contiguous()
    return dist.isend(buf, dst, tag=tag), buf


def recv(shape, dtype, src: int, tag: int, device) -> torch.Tensor:
    """Receive on ``device`` what rank ``src`` sends with ``send``; the
    current stream's later work on it follows the receive."""
    if _host_wire():
        buf = torch.empty(shape, dtype=dtype)
        dist.irecv(buf, src, tag=tag).wait()
        return buf.to(device)
    buf = torch.empty(shape, dtype=dtype, device=device)
    dist.irecv(buf, src, tag=tag).wait()
    return buf


def gather_slots(parts: dict, owners: list, shape, dtype, device) -> list:
    """Every slot's tensor on every rank, on ``device``: ``parts`` holds
    this rank's slots ({slot: tensor of ``shape``}), ``owners`` the rank of
    each slot, which broadcasts it."""
    return [broadcast(parts.get(i), r, shape, dtype, device) for i, r in enumerate(owners)]


def run_batch_sharded(fn: Callable, keys_by_device: dict, *samples, mesh: Mesh):
    """Run ``fn(key, *chunks)`` on each of this process's batch slots'
    chunks (lists from ``shard_lwe_batch``), each slot on a stream of its
    own device, and concatenate the results of every slot on
    ``mesh.home()``: on a mesh across processes each slot's result is
    broadcast from its rank, so every rank returns the whole batch. ``fn``
    returns a tensor or a NamedTuple of tensors."""
    devs, owners, me = mesh.batch_devices(), mesh.batch_ranks(), process_rank()
    if any(len(s) != len(devs) for s in samples):
        raise ValueError(f"every sample needs one chunk per batch slot ({len(devs)})")
    mine = [i for i, r in enumerate(owners) if r == me]
    outs, streams = {}, {}
    for i in mine:
        streams[i] = new_stream(devs[i])
        with use_stream(streams[i]):
            outs[i] = fn(keys_by_device[devs[i]], *(s[i] for s in samples))
    for i in mine:  # joined after all are queued, so they overlap
        join_stream(streams[i], _fields(outs[i]))
    home = mesh.home()
    if mesh.spans_processes:
        # the result's form, from the first slot's rank: ranks without a slot lack it
        form = [None]
        if me == owners[0]:
            out0 = outs[0]
            form[0] = (None if isinstance(out0, torch.Tensor) else type(out0),
                       [(tuple(f.shape), f.dtype) for f in _fields(out0)])
        dist.broadcast_object_list(form, owners[0])
        kind, specs = form[0]
        fields = [gather_slots({i: _fields(o)[k] for i, o in outs.items()}, owners,
                               shape, dtype, home) for k, (shape, dtype) in enumerate(specs)]
        cat = [torch.cat(parts) for parts in fields]
        return cat[0] if kind is None else kind(*cat)
    cat = [torch.cat([f.to(home) for f in parts])
           for parts in zip(*(_fields(outs[i]) for i in range(len(devs))))]
    return cat[0] if isinstance(outs[0], torch.Tensor) else type(outs[0])(*cat)

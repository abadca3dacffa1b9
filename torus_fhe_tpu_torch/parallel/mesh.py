"""Device meshes and batch-sharded execution.

Port of torus_fhe_tpu/parallel/mesh.py. JAX's mesh on one host is one
process driving several devices; here it is one process driving a grid of
``torch.device``s with two axes:

  * ``batch``: data parallelism over independent gates. Each batch slot
    holds a copy of the cloud key and runs its chunk of the batch;
  * ``party``: the multikey / threshold party dimension. Party-axis work
    (parallel/sharded.py, parallel/mk_pipeline.py) runs each party's share on
    the party's device and sums or hands on the results.

A mesh may name one device more than once: ``[cuda:0] * 8`` runs eight
slots as eight CUDA streams of one card, and the same schedule spreads over
eight cards unchanged where there are eight. Results are identical either
way. Work of different slots goes on different streams, so slots that share
a card overlap. Multi-process and multi-host meshes (``torch.distributed``)
are not ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Sequence

import torch

BATCH_AXIS = "batch"
PARTY_AXIS = "party"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An (n_batch, n_party) grid of devices: ``devices[b][p]``."""

    devices: tuple
    axis_names = (BATCH_AXIS, PARTY_AXIS)  # a class constant, not a field

    @property
    def shape(self) -> dict:
        return {BATCH_AXIS: len(self.devices), PARTY_AXIS: len(self.devices[0])}

    def batch_devices(self) -> list:
        """The device of each batch slot (its first party column)."""
        return [row[0] for row in self.devices]

    def party_devices(self) -> list:
        """The device of each party slot (the first batch row)."""
        return list(self.devices[0])

    def distinct_devices(self) -> list:
        return list(dict.fromkeys(d for row in self.devices for d in row))


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_batch: int | None = None, n_party: int = 1,
              devices: Sequence | None = None) -> Mesh:
    """A (batch, party) mesh over ``devices``, row-major. With ``devices``
    None it takes every CUDA device, and raises when there is none: a mesh
    never falls back to the CPU. With ``n_batch`` None every remaining
    device goes to the batch axis."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device; pass devices=[torch.device('cpu')] * k "
                               "to run the plain versions on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if n_batch is None:
        n_batch = len(devices) // n_party
    if n_batch < 1 or n_party < 1 or n_batch * n_party > len(devices):
        raise ValueError(f"a ({n_batch}, {n_party}) mesh needs {n_batch * n_party} devices, "
                         f"got {len(devices)}")
    return Mesh(tuple(tuple(devices[b * n_party:(b + 1) * n_party]) for b in range(n_batch)))


def pad_to_multiple(n: int, m: int) -> int:
    return -(-n // m) * m


def shard_lwe_batch(sample, mesh: Mesh) -> list:
    """Split a batched sample (``LweSample`` or ``MKLweSample``) along its
    leading axis into one chunk per batch slot, each on the slot's device.
    The batch must divide evenly (``pad_to_multiple``)."""
    devs = mesh.batch_devices()
    B = sample.b.shape[0]
    if B % len(devs):
        raise ValueError(f"batch {B} does not split over {len(devs)} batch slots")
    c = B // len(devs)
    return [type(sample)(*(f[i * c:(i + 1) * c].to(d) for f in sample))
            for i, d in enumerate(devs)]


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
    """{device: the cloud key on it}, one copy per DISTINCT device of the
    mesh, so that a mesh that repeats a card holds one copy."""
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


def run_batch_sharded(fn: Callable, keys_by_device: dict, *samples, mesh: Mesh):
    """Run ``fn(key, *chunks)`` on each batch slot's chunks (lists from
    ``shard_lwe_batch``), each slot on a stream of its own device, and
    concatenate the results on the first slot's device. ``fn`` returns a
    tensor or a NamedTuple of tensors."""
    devs = mesh.batch_devices()
    if any(len(s) != len(devs) for s in samples):
        raise ValueError(f"every sample needs one chunk per batch slot ({len(devs)})")
    outs, streams = [], []
    for i, dev in enumerate(devs):
        streams.append(new_stream(dev))
        with use_stream(streams[-1]):
            outs.append(fn(keys_by_device[dev], *(s[i] for s in samples)))
    for stream, out in zip(streams, outs):  # joined after all are queued, so they overlap
        join_stream(stream, _fields(out))
    home = devs[0]
    cat = [torch.cat([f.to(home) for f in parts]) for parts in zip(*map(_fields, outs))]
    return cat[0] if isinstance(outs[0], torch.Tensor) else type(outs[0])(*cat)

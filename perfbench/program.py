"""The system under test, torus_fhe_tpu_torch, as the benchmark drives it.
Besides the scheme files of perfbench/drive/, the one module of the
benchmark that imports the program.

``Program`` hands the program the raw key material of keys.py and lets it
build its own key forms, the ones its normal path reads, through the
configuration's scheme file perfbench/drive/<scheme>.py, found by name; the
gates and circuits are the program's public functions that the scheme file
names. The counters are the program's launch counters.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from torus_fhe_tpu_torch.core import params as P
from torus_fhe_tpu_torch.ops import cuda_rotate, poly

from .byname import ByName

DRIVES = ByName("drive", "program side of a scheme")


def registry_params(cfg: dict):
    """The program's parameter set of a configuration, checked field by
    field against the numbers the configuration file states."""
    params = P.PARAMETER_REGISTRY[cfg["registry"]]()
    if dataclasses.asdict(params) != cfg["params"]:
        raise ValueError(f"{cfg['registry']}: the program's parameters {dataclasses.asdict(params)} "
                         f"differ from the configuration's {cfg['params']}")
    return params


def _table_limbs(ks: torch.Tensor) -> torch.Tensor:
    """A keyswitch table (n_in, t, base-1, cols) of 32-bit words as the
    program's int8 limb table (n_in * t * (base-1), cols * 4)."""
    flat = ks.reshape(-1, ks.shape[-1])
    return poly.limb_split_signed(flat, 32).reshape(flat.shape[0], -1)


class Program:
    """One configuration's cloud key in the program's forms, its gates, and
    its circuits by name (``prog.circuit("add")(*words, width)``)."""

    def __init__(self, cfg: dict, keys, device):
        self.params = registry_params(cfg)
        self.scheme = cfg["scheme"]
        self.drive = DRIVES[self.scheme]
        self.ck = self.drive.cloud_key(self.params, cfg, keys, torch.device(device))
        self.sample, self.gates = self.drive.SAMPLE, self.drive.GATES

    def wrap(self, a: torch.Tensor, b: torch.Tensor):
        return self.sample(a.to(torch.int32), b.to(torch.int32))

    def gate(self, kind: str, x, y):
        return self.gates[kind](self.ck, x, y)

    def circuit(self, name: str):
        """The program's circuit ``name``: ``(*words, width) -> sample``."""
        try:
            fn = self.drive.circuit(name)
        except AttributeError:
            raise KeyError(f"the program has no circuit {name!r} for scheme {self.scheme!r}") \
                from None
        return functools.partial(fn, self.ck)


def counters() -> dict:
    """The program's launch counters: the two rotate kernels (launches, the
    ciphertexts they rotated, and launches per tile config, a dict) and the
    int8 GEMMs of ops/poly."""
    return {"rotate_launches": cuda_rotate.blind_rotate_cuda.launches,
            "rotate_rows": cuda_rotate.blind_rotate_cuda.rows,
            "rotate_by_config": dict(cuda_rotate.blind_rotate_cuda.by_config),
            "rotate_sel_launches": cuda_rotate.blind_rotate_sel_cuda.launches,
            "rotate_sel_rows": cuda_rotate.blind_rotate_sel_cuda.rows,
            "rotate_sel_by_config": dict(cuda_rotate.blind_rotate_sel_cuda.by_config),
            "int8_matmuls": poly.int8_matmul.calls}

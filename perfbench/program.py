"""The system under test, torus_fhe_tpu_torch, as the benchmark drives it:
the one module of the benchmark that imports the program.

``build`` hands the program the raw key material of keys.py and lets it
build its own key forms, the ones its normal path reads (single key:
``boot.bootstrap.rebuild_bk_forms`` and the keyswitch table's byte limbs;
3gen: ``mk.keys3gen.cloud_key_from_samples`` in ``default_forms``). The
gates and circuits are the program's public functions; the counters are
its launch counters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from torus_fhe_tpu_torch.boot import bootstrap, gates, keyswitch
from torus_fhe_tpu_torch.boot.api import CloudKey
from torus_fhe_tpu_torch.circuits import words
from torus_fhe_tpu_torch.core import params as P
from torus_fhe_tpu_torch.lwe import LweSample
from torus_fhe_tpu_torch.mk import gates3gen, keys3gen
from torus_fhe_tpu_torch.mk.samples import MKLweSample
from torus_fhe_tpu_torch.ops import cuda_rotate, poly


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
    """One configuration's cloud key in the program's forms, and its gates."""

    def __init__(self, cfg: dict, keys, device):
        self.params = registry_params(cfg)
        self.scheme = cfg["scheme"]
        device = torch.device(device)
        if self.scheme == "single":
            bk = bootstrap.rebuild_bk_forms(keys.bk.to(torch.int32).cpu(), self.params,
                                            ("fblock",), device)
            n_in, cols = keys.ks.shape[0], keys.ks.shape[-1]
            ks = keyswitch.KeyswitchKey(keyswitch.pad_table(_table_limbs(keys.ks)).to(device),
                                        n_in, cols - 1)
            self.ck = CloudKey(self.params, bk, ks)
            self.sample, self.gates = LweSample, gates.BINARY_GATES
        elif self.scheme == "3gen":
            parties = cfg["parties"]
            forms = keys3gen.default_forms(self.params, parties)
            self.ck = keys3gen.cloud_key_from_samples(
                self.params, keys.bk.cpu().numpy().astype(np.int64), _table_limbs(keys.ks),
                parties, forms, device)
            self.sample, self.gates = MKLweSample, gates3gen.BINARY_GATES
        else:
            raise ValueError(f"no program path for scheme {self.scheme!r}")

    def wrap(self, a: torch.Tensor, b: torch.Tensor):
        return self.sample(a.to(torch.int32), b.to(torch.int32))

    def gate(self, kind: str, x, y):
        return self.gates[kind](self.ck, x, y)

    def less_than(self, x, y, width: int):
        if self.scheme != "single":
            raise ValueError("the less_than circuit is the single-key circuits/words one")
        return words.less_than(self.ck, x, y, width)


def counters() -> dict:
    """The program's launch counters: the two rotate kernels (launches and
    the ciphertexts they rotated) and the int8 GEMMs of ops/poly."""
    return {"rotate_launches": cuda_rotate.blind_rotate_cuda.launches,
            "rotate_rows": cuda_rotate.blind_rotate_cuda.rows,
            "rotate_sel_launches": cuda_rotate.blind_rotate_sel_cuda.launches,
            "rotate_sel_rows": cuda_rotate.blind_rotate_sel_cuda.rows,
            "int8_matmuls": poly.int8_matmul.calls}

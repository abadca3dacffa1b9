"""The 3rd-gen multikey scheme on the program's side: the cloud key through
``mk.keys3gen.cloud_key_from_samples`` in ``default_forms`` (the expanded
hi-word key while it is at most 10 GiB, else the compact lines); the gates
of ``mk/gates3gen.py``; a circuit ``name`` is ``mk/gates3gen.mk_<name>``."""

from __future__ import annotations

import numpy as np
import torch

from torus_fhe_tpu_torch.mk import gates3gen, keys3gen
from torus_fhe_tpu_torch.mk.samples import MKLweSample

from ..program import _table_limbs

SAMPLE, GATES = MKLweSample, gates3gen.BINARY_GATES


def cloud_key(params, cfg: dict, keys, device: torch.device) -> keys3gen.MKCloudKey:
    parties = cfg["parties"]
    return keys3gen.cloud_key_from_samples(
        params, keys.bk.cpu().numpy().astype(np.int64), _table_limbs(keys.ks), parties,
        keys3gen.default_forms(params, parties), device)


def circuit(name: str):
    return getattr(gates3gen, "mk_" + name)

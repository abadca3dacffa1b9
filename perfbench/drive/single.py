"""The single-key scheme on the program's side: the cloud key through
``boot.bootstrap.rebuild_bk_forms`` (the F-block form) and the keyswitch
table's byte limbs; the gates of ``boot/gates.py``; a circuit ``name`` is
``circuits/words.<name>``."""

from __future__ import annotations

import torch

from torus_fhe_tpu_torch.boot import bootstrap, gates, keyswitch
from torus_fhe_tpu_torch.boot.api import CloudKey
from torus_fhe_tpu_torch.circuits import words
from torus_fhe_tpu_torch.lwe import LweSample

from ..program import _table_limbs

SAMPLE, GATES = LweSample, gates.BINARY_GATES


def cloud_key(params, cfg: dict, keys, device: torch.device) -> CloudKey:
    bk = bootstrap.rebuild_bk_forms(keys.bk.to(torch.int32).cpu(), params, ("fblock",), device)
    n_in, cols = keys.ks.shape[0], keys.ks.shape[-1]
    ks = keyswitch.KeyswitchKey(keyswitch.pad_table(_table_limbs(keys.ks)).to(device),
                                n_in, cols - 1)
    return CloudKey(params, bk, ks)


def circuit(name: str):
    return getattr(words, name)

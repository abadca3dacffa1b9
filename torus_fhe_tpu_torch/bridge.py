"""Key material and ciphertexts from the JAX package, as numpy arrays.

The JAX package and this one compute on the same key when the port takes the
LWE key bits, the compact TGSW samples and the keyswitch table of a JAX
``SecretKey``/``CloudKey`` (``np.asarray`` of each field) and rebuilds its own
F-block key from the samples. No JAX import is needed here.
"""

from __future__ import annotations

import numpy as np
import torch

from .boot.api import CloudKey, SecretKey
from .boot.bootstrap import bootstrap_key_from_samples
from .boot.keyswitch import KeyswitchKey, pad_table
from .core.params import SchemeParams
from .lwe import LweKey, LweSample


def secret_key_from_numpy(params: SchemeParams, key_bits: np.ndarray,
                          device=None) -> SecretKey:
    """key_bits: (n,) LWE key bits (``sk.key.key``)."""
    return SecretKey(params, LweKey(torch.tensor(np.asarray(key_bits, np.int32),
                                                device=device)))


def cloud_key_from_numpy(params: SchemeParams, samples: np.ndarray, ks_mat: np.ndarray,
                         n_in: int, n_out: int, device=None) -> CloudKey:
    """samples: (n, l, k+1, k+1, N) TGSW samples (``bootstrap_key.samples``);
    ks_mat: (n_in*l*(base-1), (n_out+1)*4) int8 table
    (``keyswitch_key.mat``). The F-block key is built on ``device``."""
    bk = bootstrap_key_from_samples(torch.tensor(np.asarray(samples, np.int32)),
                                    params, device)
    mat = pad_table(torch.tensor(np.asarray(ks_mat, np.int8)))
    return CloudKey(params, bk, KeyswitchKey(mat.to(device), int(n_in), int(n_out)))


def lwe_from_numpy(a: np.ndarray, b: np.ndarray, device=None) -> LweSample:
    """An LWE batch: a (..., n), b (...,), as int32."""
    return LweSample(torch.tensor(np.asarray(a, np.int32), device=device),
                     torch.tensor(np.asarray(b, np.int32), device=device))

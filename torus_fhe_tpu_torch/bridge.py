"""Key material and ciphertexts from the JAX package, as numpy arrays.

The JAX package and this one compute on the same key when the port takes the
LWE key bits, the compact TGSW samples and the keyswitch table of a JAX
``SecretKey``/``CloudKey`` (``np.asarray`` of each field) and rebuilds its own
F-block key from the samples; the conv form's packed kernels cross as they
are (``kernels=``), as do those of the CCS and KMS keys. The same holds for the 3gen multikey keys
(``MKSecretKey``, ``MKCloudKey`` made with ``keep_samples=True``), for the
CCS and KMS multikey keys (their cloud keys by field name; their secret keys
through ``mk_secret_keys_from_numpy``), for the public key, the packing key
and additive shares. No JAX import is needed
here. Every loader puts its result on ``device``; None is
the card (core/device.resolve_device), ``"cpu"`` the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .boot.api import CloudKey, SecretKey
from .boot.bootstrap import rebuild_bk_forms
from .boot.keyswitch import KeyswitchKey, pad_table
from .boot.pack import PackingKey
from .core.device import resolve_device
from .core.params import SchemeParams, SchemeParams3Gen
from .lwe import LweKey, LweSample
from .mk import ccs, keys3gen, kms
from .mk.samples import MKLweSample
from .rlwe import RLweKey
from .threshold.additive import AdditiveShares
from .threshold.pk import PublicKey


def secret_key_from_numpy(params: SchemeParams, key_bits: np.ndarray,
                          device=None) -> SecretKey:
    """key_bits: (n,) LWE key bits (``sk.key.key``)."""
    return SecretKey(params, LweKey(torch.tensor(np.asarray(key_bits, np.int32),
                                                device=resolve_device(device))))


def cloud_key_from_numpy(params: SchemeParams, samples: np.ndarray, ks_mat: np.ndarray,
                         n_in: int, n_out: int, device=None, forms=("fblock",),
                         kernels=None) -> CloudKey:
    """samples: (n, l, k+1, k+1, N) TGSW samples (``bootstrap_key.samples``);
    ks_mat: (n_in*l*(base-1), (n_out+1)*4) int8 table
    (``keyswitch_key.mat``). The bootstrapping key's ``forms`` are built on
    ``device`` from the samples; with "conv" in ``forms``, JAX's packed
    kernels (``bootstrap_key.kernels``), where given, are taken as they are."""
    device = resolve_device(device)
    npdt = np.int32 if params.rlwe_bits == 32 else np.int64
    bk = rebuild_bk_forms(torch.tensor(np.asarray(samples, npdt)), params, forms, device)
    if "conv" in forms and kernels is not None:
        bk = bk._replace(kernels=torch.tensor(np.asarray(kernels, np.int8), device=device))
    mat = pad_table(torch.tensor(np.asarray(ks_mat, np.int8)))
    return CloudKey(params, bk, KeyswitchKey(mat.to(device), int(n_in), int(n_out)))


def lwe_from_numpy(a: np.ndarray, b: np.ndarray, device=None) -> LweSample:
    """An LWE batch: a (..., n), b (...,), as int32."""
    device = resolve_device(device)
    return LweSample(torch.tensor(np.asarray(a, np.int32), device=device),
                     torch.tensor(np.asarray(b, np.int32), device=device))


def mk_secret_keys_from_numpy(params, lwe_keys, rlwe_keys, device=None) -> list:
    """lwe_keys: per party (n,) LWE key bits (``sk.lwe.key``); rlwe_keys: per
    party (k, N) ring keys (``sk.rlwe.key``: ternary for the 3gen sets,
    binary for CCS and KMS). ``params``: any multikey set; each key is a
    (lwe, rlwe) pair, which every multikey scheme's functions read."""
    device = resolve_device(device)
    return [keys3gen.MKSecretKey(
        LweKey(torch.tensor(np.asarray(lk, np.int32), device=device)),
        RLweKey(torch.tensor(np.asarray(rk, np.int32), device=device), params.rlwe_bits))
        for lk, rk in zip(lwe_keys, rlwe_keys)]


def mk_cloud_key_from_numpy(params: SchemeParams3Gen, samples: np.ndarray,
                            ks_mat: np.ndarray, parties: int, forms=("fblock",),
                            device=None) -> keys3gen.MKCloudKey:
    """samples: (parties*n, l, 2, 2, N) int64 raw TGSW samples
    (``bk_samples``); ks_mat: (K, parties*(n+1)*4) int8 tables (``ks_mat``).
    The ``forms`` of the key are rebuilt here, on ``device``: from the
    hi-word rounded samples at a byte-digit set, from the raw ones at a
    wide-digit set, which takes ``forms=("fbstream",)``."""
    return keys3gen.cloud_key_from_samples(
        params, np.array(samples, np.int64), torch.tensor(np.asarray(ks_mat, np.int8)),
        parties, forms, resolve_device(device), keep_samples=True)


def ccs_cloud_key_from_numpy(params, parties: int, device=None, forms=("fb",),
                             **fields) -> ccs.CCSCloudKey:
    """``fields``: the arrays of a JAX ``CCSCloudKey`` by field name
    (``d_sel``, ``f0_sel``, ``f1_sel`` and/or the conv form's ``d_kern``,
    ``f0_kern``, ``f1_kern``; ``pk_kern``, ``sk_kern``, ``ks_mats``), placed
    on ``device`` in ``forms`` (``mk.ccs.cloud_key_from_fields``: a form's
    fields as they are where given)."""
    return ccs.cloud_key_from_fields(params, int(parties), fields, resolve_device(device), forms)


def kms_cloud_key_from_numpy(params, parties: int, device=None, forms=("fb",),
                             **fields) -> kms.KMSCloudKey:
    """``fields``: the arrays of a JAX ``KMSCloudKey`` by field name
    (``gsw_sel`` and/or the conv form's ``gsw_kern``; ``d_kern``,
    ``f0_kern``, ``f1_kern``, ``pk_kern``, ``sk_kern``, ``ks_mats``), placed
    on ``device`` in ``forms`` (``mk.kms.cloud_key_from_fields``)."""
    return kms.cloud_key_from_fields(params, int(parties), fields, resolve_device(device), forms)


def mk_lwe_from_numpy(a: np.ndarray, b: np.ndarray, device=None) -> MKLweSample:
    """A multikey batch: a (..., parties, n), b (...,), as int32."""
    device = resolve_device(device)
    return MKLweSample(torch.tensor(np.asarray(a, np.int32), device=device),
                       torch.tensor(np.asarray(b, np.int32), device=device))


def public_key_from_numpy(a: np.ndarray, b: np.ndarray, alpha: float,
                          device=None) -> PublicKey:
    """a (n_samples, n), b (n_samples,): the encryptions of zero
    (``pk.samples``), and the key's noise ``alpha``."""
    return PublicKey(lwe_from_numpy(a, b, device), float(alpha))


def packing_key_from_numpy(kernels: np.ndarray, n_in: int, decomp_length: int,
                           log2_base: int, bits: int, mask_size: int,
                           device=None) -> PackingKey:
    """kernels: ((k+1)*limbs, n*l, N) int8 (``PackingKey.kernels``, the same
    layout in both packages) and the key's static fields."""
    return PackingKey(torch.tensor(np.asarray(kernels, np.int8), device=resolve_device(device)),
                      int(n_in), int(decomp_length), int(log2_base), int(bits), int(mask_size))


def additive_shares_from_numpy(shares: np.ndarray, device=None) -> AdditiveShares:
    """shares: (p, ...) torus ints (``AdditiveShares.shares``), int32 or int64
    as the JAX package made them."""
    shares = np.asarray(shares)
    dtype = np.int64 if shares.dtype == np.int64 else np.int32
    return AdditiveShares(torch.tensor(shares.astype(dtype), device=resolve_device(device)))

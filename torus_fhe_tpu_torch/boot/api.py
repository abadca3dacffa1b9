"""Single-key TFHE user API: keys, encrypt, decrypt.

Port of torus_fhe_tpu/boot/api.py. Sampling and the exact keygen products
run on the generator's device (the host, for a CPU generator); the
bootstrapping key's forms (``forms``: the F-block key "fblock", this
package's default, and/or the packed kernels "conv", the JAX package's
default; boot/bootstrap.py) are built on ``device``, where the finished keys
live. ``device=None`` is the card (core/device.resolve_device): the
current CUDA device, or a RuntimeError without one; ``device="cpu"`` runs the
plain versions on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.device import resolve_device
from ..core.params import SchemeParams
from ..core.torus import encode_message
from ..lwe import LweKey, LweSample, lwe_encrypt, lwe_keygen, lwe_phase
from ..rlwe import extract_lwe_key, rlwe_keygen
from .bootstrap import BootstrapKey, bootstrap_keygen
from .keyswitch import KeyswitchKey, keyswitch_keygen


class SecretKey(NamedTuple):
    params: SchemeParams
    key: LweKey


class CloudKey(NamedTuple):
    params: SchemeParams
    bootstrap_key: BootstrapKey
    keyswitch_key: KeyswitchKey


def make_secret_key(generator: torch.Generator, params: SchemeParams,
                    device=None) -> SecretKey:
    return SecretKey(params, lwe_keygen(generator, params.lwe, device=resolve_device(device)))


def make_cloud_key(generator: torch.Generator, secret_key: SecretKey,
                   device=None, forms=("fblock",)) -> CloudKey:
    """Bootstrapping and keyswitch keys under a fresh RLWE key; ``forms``:
    the bootstrapping key's forms."""
    params = secret_key.params
    device = resolve_device(device)
    rlwe_key = rlwe_keygen(generator, params.rlwe)
    bk = bootstrap_keygen(generator, params.bs_noise_stddev, secret_key.key,
                          rlwe_key, params, device=device, forms=forms)
    ks = keyswitch_keygen(generator, params.ks_noise_stddev, params.ks,
                          secret_key.key, extract_lwe_key(rlwe_key), device=device)
    return CloudKey(params, bk, ks)


def make_key_pair(generator: torch.Generator, params: SchemeParams,
                  device=None, forms=("fblock",)) -> tuple[SecretKey, CloudKey]:
    """(secret, cloud) pair, both on ``device``; ``forms``: the
    bootstrapping key's forms."""
    device = resolve_device(device)
    sk = make_secret_key(generator, params, device=device)
    return sk, make_cloud_key(generator, sk, device=device, forms=forms)


def encrypt(generator: torch.Generator, secret_key: SecretKey,
            messages: torch.Tensor) -> LweSample:
    """Encrypt booleans as +-1/8 phases, on the secret key's device."""
    device = secret_key.key.key.device
    messages = torch.as_tensor(messages, dtype=torch.bool, device=device)
    mu = torch.where(messages, encode_message(1, 8, device=device),
                     encode_message(-1, 8, device=device))
    return lwe_encrypt(generator, mu, secret_key.params.lwe_noise_stddev,
                       secret_key.key, messages.shape)


def decrypt(secret_key: SecretKey, sample: LweSample) -> torch.Tensor:
    """Boolean decryption: positive phase = True."""
    return lwe_phase(sample, secret_key.key) > 0

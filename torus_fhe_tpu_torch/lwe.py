"""LWE keys and samples, batch-first.

Port of torus_fhe_tpu/lwe.py. A sample is a batch of ciphertexts: ``a`` has
shape (..., n) and ``b`` shape (...,), int32 torus words.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .core import rng
from .core.params import LweParams
from .core.torus import double_to_torus


class LweKey(NamedTuple):
    key: torch.Tensor  # (n,) int32 in {0, 1}

    @property
    def size(self) -> int:
        return self.key.shape[-1]


class LweSample(NamedTuple):
    a: torch.Tensor  # (..., n) torus
    b: torch.Tensor  # (...,) torus

    def __add__(self, other):
        return LweSample(self.a + other.a, self.b + other.b)

    def __sub__(self, other):
        return LweSample(self.a - other.a, self.b - other.b)

    def __neg__(self):
        return LweSample(-self.a, -self.b)

    def scale(self, c: int):
        return LweSample(self.a * c, self.b * c)


def lwe_keygen(generator: torch.Generator, params: LweParams, device=None) -> LweKey:
    """Uniform binary LWE key."""
    return LweKey(rng.uniform_binary(generator, (params.size,), device=device))


def lwe_encrypt(generator: torch.Generator, message, alpha: float,
                lwe_key: LweKey, shape=()) -> LweSample:
    """b = message + gaussian(alpha) + <a, s>, a uniform; on the key's device.

    ``message`` broadcasts against ``shape``."""
    device = lwe_key.key.device
    shape = tuple(shape)
    msg = torch.as_tensor(message, dtype=torch.int32, device=device).expand(shape)
    a = rng.uniform_torus(generator, shape + (lwe_key.size,), device=device)
    noise = rng.gaussian_torus(generator, 0, alpha, shape, device=device)
    b = msg + noise + torch.sum(a * lwe_key.key, dim=-1, dtype=torch.int32)
    return LweSample(a, b)


def lwe_encrypt_with_noise(message, noise, a: torch.Tensor, lwe_key: LweKey) -> LweSample:
    """The deterministic encryption: b = message + double_to_torus(noise) +
    <a, s> for a given mask ``a`` (..., n) and float noise, on a's device."""
    noise = torch.as_tensor(noise, device=a.device)
    msg = torch.as_tensor(message, dtype=torch.int32, device=a.device)
    b = msg + double_to_torus(noise, torch.int32) + torch.sum(a * lwe_key.key, dim=-1,
                                                              dtype=torch.int32)
    return LweSample(a, b)


def lwe_phase(sample: LweSample, lwe_key: LweKey) -> torch.Tensor:
    """phi = b - <a, s>, wrapping mod 2^32 (torch.sum alone would give int64)."""
    return sample.b - torch.sum(sample.a * lwe_key.key, dim=-1, dtype=torch.int32)


def lwe_noiseless_trivial(mu, params: LweParams, shape=(), device=None) -> LweSample:
    """(0, mu)."""
    shape = tuple(shape)
    mu = torch.as_tensor(mu, dtype=torch.int32, device=device).expand(shape)
    return LweSample(torch.zeros(shape + (params.size,), dtype=torch.int32, device=device),
                     mu.clone())

"""Multikey LWE samples, batch-first.

Port of torus_fhe_tpu/mk/samples.py. A multikey sample carries one mask per
party: ``a`` (..., parties, n) and ``b`` (...,), int32 torus words. The phase
is b - sum_p <a_p, s_p>.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..boot.gates import EIGHTH
from ..core import rng
from ..core.params import LweParams, SchemeParams3Gen
from ..lwe import LweKey


class MKLweSample(NamedTuple):
    a: torch.Tensor  # (..., parties, n) int32
    b: torch.Tensor  # (...,) int32

    def __add__(self, other):
        return MKLweSample(self.a + other.a, self.b + other.b)

    def __sub__(self, other):
        return MKLweSample(self.a - other.a, self.b - other.b)

    def __neg__(self):
        return MKLweSample(-self.a, -self.b)

    def scale(self, c: int):
        return MKLweSample(self.a * c, self.b * c)


def mk_lwe_noiseless_trivial(mu, params: LweParams, parties: int, shape=(),
                             device=None) -> MKLweSample:
    """(0, mu) with a (parties, n) zero mask."""
    shape = tuple(shape)
    mu = torch.as_tensor(mu, dtype=torch.int32, device=device).expand(shape).clone()
    return MKLweSample(torch.zeros(shape + (parties, params.size), dtype=torch.int32,
                                   device=mu.device), mu)


def _stack_keys(lwe_keys: Sequence[LweKey]) -> torch.Tensor:
    return torch.stack([k.key.to(torch.int32) for k in lwe_keys])  # (parties, n)


def mk_lwe_phase(sample: MKLweSample, lwe_keys: Sequence[LweKey]) -> torch.Tensor:
    """b - sum_p <a_p, s_p>, wrapping mod 2^32."""
    keys = _stack_keys(lwe_keys).to(sample.a.device)
    return sample.b - torch.sum(sample.a * keys, dim=(-2, -1), dtype=torch.int32)


def mk_encrypt(generator: torch.Generator, lwe_keys: Sequence[LweKey], messages,
               params: SchemeParams3Gen) -> MKLweSample:
    """Encrypt booleans as +-1/8 under the concatenated party keys, on the
    keys' device."""
    keys = _stack_keys(lwe_keys)
    device = keys.device
    messages = torch.as_tensor(messages, dtype=torch.bool, device=device)
    shape = tuple(messages.shape)
    a = rng.uniform_torus(generator, shape + (len(lwe_keys), params.lwe_size), device=device)
    mu = torch.where(messages, EIGHTH[1], EIGHTH[-1]).to(torch.int32)
    noise = rng.gaussian_torus(generator, 0, params.lwe_noise_stddev, shape, device=device)
    b = mu + noise + torch.sum(a * keys, dim=(-2, -1), dtype=torch.int32)
    return MKLweSample(a, b)


def mk_decrypt(lwe_keys: Sequence[LweKey], sample: MKLweSample) -> torch.Tensor:
    """Boolean decryption: positive phase = True."""
    return mk_lwe_phase(sample, lwe_keys) > 0


def mk_int_encrypt(generator: torch.Generator, lwe_keys: Sequence[LweKey], value,
                   width: int, params: SchemeParams3Gen) -> MKLweSample:
    """Two's-complement integers of ``width`` bits, LSB first: the bit
    position is a new leading axis, a (width, ..., parties, n)."""
    value = torch.as_tensor(value, dtype=torch.int64)
    bits = torch.stack([(value >> i) & 1 for i in range(width)]) == 1
    return mk_encrypt(generator, lwe_keys, bits, params)


def mk_int_decrypt(lwe_keys: Sequence[LweKey], sample: MKLweSample, width: int) -> np.ndarray:
    """Two's-complement decode of a (width, ...) sample, as int64 numpy."""
    bits = mk_decrypt(lwe_keys, sample).cpu().numpy()
    msb = bits[width - 1]
    result = np.zeros(bits.shape[1:], np.int64)
    for i in range(width - 1):
        result += np.logical_xor(bits[i], msb).astype(np.int64) << i
    return np.where(msb, -(result + 1), result)

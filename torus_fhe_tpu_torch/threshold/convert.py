"""LWE <-> ring-LWE conversion.

Port of torus_fhe_tpu/threshold/convert.py: an LWE ciphertext under an
n-coefficient key embeds into a degree-n ring ciphertext by the negacyclic
reversal a'[0] = a[0], a'[i] = -a[n-i], so that the constant coefficient of
s(X) (*) a'(X) equals <s, a>. The ring key is the LWE key read as a
polynomial. n need not be a power of two (630 at tfhe_128_tpu_fast).
"""

from __future__ import annotations

import torch

from ..lwe import LweKey, LweSample
from ..rlwe import RLweKey, RLweSample


def tlwe_from_lwe(sample: LweSample) -> RLweSample:
    """Embed batched LWE (a (..., n), b (...,)) into ring-LWE with k=1, on
    the sample's device. Only coefficient 0 of the body is meaningful. The
    negation wraps in the torus dtype (-(-2^31) = -2^31), as in JAX."""
    a = sample.a
    a_ring = torch.cat([a[..., :1], -a[..., 1:].flip(-1)], dim=-1)
    body = torch.zeros_like(a_ring)
    body[..., 0] = sample.b
    return RLweSample(torch.stack([a_ring, body], dim=-2))


def tlwe_key_from_lwe_key(lwe_key: LweKey, bits: int = 32) -> RLweKey:
    """Read the n LWE key bits as one degree-n ring key polynomial."""
    return RLweKey(lwe_key.key.reshape(1, -1).to(torch.int32), bits)

"""Public sampling: fresh ciphertexts made without the secret key.

Port of torus_fhe_tpu/boot/public_sample.py (the reference's
public_sample_LWE / _LWE_2 / _RLWE_01 programs). For any encrypted bit x,
XOR(x, x) is a fresh encryption of 0 whose noise is the bootstrap output
noise, whatever x's value or noise; a trivial plaintext phase on top gives a
fresh encryption of any message. One call makes a whole batch: one gate
bootstrap, on the card one launch of the blind-rotate kernel.
"""

from __future__ import annotations

import torch

from ..core.torus import encode_message
from ..lwe import LweSample, lwe_noiseless_trivial
from ..rlwe import RLweSample, mul_by_monomial, rlwe_extract_sample
from .api import CloudKey
from .gates import gate_xor


def fresh_zero(ck: CloudKey, x: LweSample) -> LweSample:
    """A fresh encryption of False derived from any ciphertext batch x."""
    return gate_xor(ck, x, x)


def public_sample(ck: CloudKey, x: LweSample, messages) -> LweSample:
    """Fresh encryptions of the booleans ``messages`` (broadcast against x's
    batch shape) from the seed ciphertext batch x: a fresh zero (phase
    -1/8) plus 1/4 where the message is True."""
    z = fresh_zero(ck, x)
    messages = torch.as_tensor(messages, dtype=torch.bool, device=z.b.device)
    mu = torch.where(messages, encode_message(1, 4, device=z.b.device),
                     encode_message(0, 4, device=z.b.device))
    return z + lwe_noiseless_trivial(mu, ck.params.lwe, z.b.shape, device=z.b.device)


def rlwe_extract_sample_at(sample: RLweSample, position: int) -> LweSample:
    """LWE extraction of coefficient ``position`` of an RLWE sample: the
    exact rotation by X^-position, then the constant-coefficient extract."""
    if position:
        sample = mul_by_monomial(sample, -position)
    return rlwe_extract_sample(sample)

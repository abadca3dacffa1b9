"""Public-key encryption from encryptions of zero.

Port of torus_fhe_tpu/threshold/pk.py (the reference's ``ThFHEPubKey``): the
public key is N_SAMPLES LWE encryptions of 0; to encrypt, draw a random
subset of them per message, sum it, and add the +-1/8 message phase with
fresh gaussian noise to b. On the device of the key's samples.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import rng
from ..core.torus import encode_message
from ..lwe import LweKey, LweSample, lwe_encrypt

N_SAMPLES = 20


class PublicKey(NamedTuple):
    samples: LweSample  # a (n_samples, n), b (n_samples,): encryptions of 0
    alpha: float


def public_keygen(generator: torch.Generator, lwe_key: LweKey, alpha: float,
                  n_samples: int = N_SAMPLES) -> PublicKey:
    """n_samples symmetric encryptions of 0 under ``lwe_key``, on its device."""
    return PublicKey(lwe_encrypt(generator, 0, alpha, lwe_key, (n_samples,)), alpha)


def public_encrypt(generator: torch.Generator, pk: PublicKey, messages) -> LweSample:
    """Subset-sum encryption of the booleans ``messages`` (...,), batched.

    choice ~ Bernoulli(1/2) per (message, sample); a = sum_s choice_s a_s,
    b = sum_s choice_s b_s + gaussian(+-1/8, alpha). The sums have at most
    n_samples terms and wrap mod 2^32.
    """
    a_pk, b_pk = pk.samples
    device = b_pk.device
    messages = torch.as_tensor(messages, dtype=torch.bool, device=device)
    shape = tuple(messages.shape)
    choice = rng.uniform_binary(generator, shape + (b_pk.shape[0],), device=device)
    a = torch.sum(choice[..., None] * a_pk, dim=-2, dtype=torch.int32)
    b_sum = torch.sum(choice * b_pk, dim=-1, dtype=torch.int32)
    mu = torch.where(messages, encode_message(1, 8, device=device),
                     encode_message(-1, 8, device=device))
    return LweSample(a, b_sum + rng.gaussian_torus(generator, mu, pk.alpha, shape,
                                                   device=device))

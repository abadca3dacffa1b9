"""Random sampling on the torus from an explicit ``torch.Generator``.

Port of torus_fhe_tpu/core/rng.py. Each sampler draws on the generator's
device and returns the result on ``device`` (default: the generator's). The
keystream is not jax.random's, so keys and ciphertexts made here are
checked by decryption, not word for word.
"""

from __future__ import annotations

import torch

from .torus import double_to_torus


def uniform_torus(generator: torch.Generator, shape, dtype=torch.int32, device=None):
    """Uniform torus elements. torch has no uint32 arithmetic, so 32-bit
    words are drawn as int64 in [-2^31, 2^31) and narrowed; 64-bit words
    join two such draws."""
    shape = tuple(shape)
    gdev = generator.device
    if dtype == torch.int32:
        raw = torch.randint(-2**31, 2**31, shape, generator=generator,
                            dtype=torch.int64, device=gdev)
        return raw.to(torch.int32).to(device)
    raw = torch.randint(-2**31, 2**31, shape + (2,), generator=generator,
                        dtype=torch.int64, device=gdev)
    return ((raw[..., 0] << 32) | (raw[..., 1] & 0xFFFFFFFF)).to(device)


def uniform_binary(generator: torch.Generator, shape, dtype=torch.int32, device=None):
    """Uniform bits in {0, 1}."""
    raw = torch.randint(0, 2, tuple(shape), generator=generator, dtype=dtype,
                        device=generator.device)
    return raw.to(device)


NEGATIVE_BINARY_WEIGHT = 0.113546097609674  # P(-1) = P(+1)


def negative_binary(generator: torch.Generator, shape, dtype=torch.int32, device=None):
    """Ternary key distribution: -1 and +1 with probability
    NEGATIVE_BINARY_WEIGHT each, else 0."""
    u = torch.rand(tuple(shape), generator=generator, device=generator.device)
    w = NEGATIVE_BINARY_WEIGHT
    out = (u >= 1.0 - w).to(dtype) - (u < w).to(dtype)
    return out.to(device)


def uniform_ternary(generator: torch.Generator, shape, dtype=torch.int32, device=None):
    """Uniform in {-1, 0, 1}."""
    raw = torch.randint(-1, 2, tuple(shape), generator=generator, dtype=dtype,
                        device=generator.device)
    return raw.to(device)


def gaussian_float(generator: torch.Generator, sigma: float, shape, device=None):
    """float32 gaussian noise of stddev ``sigma``."""
    raw = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                      device=generator.device)
    return (raw * sigma).to(device)


def gaussian_torus(generator: torch.Generator, message, sigma: float, shape,
                   dtype=torch.int32, device=None):
    """Gaussian sample on the torus centred at ``message``."""
    err = gaussian_float(generator, sigma, shape)
    out = torch.as_tensor(message, dtype=dtype, device=err.device) + double_to_torus(err, dtype)
    return out.to(device)

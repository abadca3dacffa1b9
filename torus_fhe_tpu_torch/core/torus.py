"""Torus arithmetic over fixed-point integers (Torus32 = int32, Torus64 = int64).

Port of torus_fhe_tpu/core/torus.py. A torus element t in [-1/2, 1/2) is
round(t * 2^bits) in a signed integer of width ``bits``; torch's integer add,
subtract, multiply and left shift wrap in two's complement, and its right
shift of a negative value is arithmetic, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def torus_bits(dtype: torch.dtype) -> int:
    """Bit width of a torus dtype."""
    return torch.iinfo(dtype).bits


def encode_message(mu, message_space: int, dtype=torch.int32, device=None):
    """Phase of message ``mu`` in a space of ``message_space`` elements."""
    bits = torus_bits(dtype)
    log2_ms = int(message_space).bit_length() - 1
    return torch.as_tensor(mu, dtype=dtype, device=device) << (bits - log2_ms)


def decode_message(phase: torch.Tensor, message_space: int) -> torch.Tensor:
    """Round a phase to the nearest of ``message_space`` equally spaced
    messages. Returns values in ``[-message_space/2, message_space/2)``."""
    bits = torus_bits(phase.dtype)
    log2_ms = int(message_space).bit_length() - 1
    half = 1 << (bits - log2_ms - 1)
    return (phase + half) >> (bits - log2_ms)


def double_to_torus(d: torch.Tensor, dtype=torch.int32) -> torch.Tensor:
    """Floats in [-0.5, 0.5) to torus ints, truncating toward zero.

    float64 inputs scale in float64, anything else in float32 (the scaling
    by a power of two is exact in either). The cast goes through int64, so the
    narrowing to int32 wraps instead of being undefined."""
    bits = torus_bits(dtype)
    if d.dtype != torch.float64:
        d = d.to(torch.float32)
    return torch.trunc(d * 2.0 ** bits).to(torch.int64).to(dtype)


def mod_switch_from_torus(phase: torch.Tensor, msize: int) -> torch.Tensor:
    """Nearest message in Z_msize of a torus phase: round(phase / interv) mod
    msize with interv = 2^bits / msize, over the unsigned phase (the
    threshold decode). Returns int32.

    The unsigned add wraps mod 2^bits. torch has no uint32 or uint64
    arithmetic: a 32-bit phase is taken as its residue in int64, a 64-bit
    one goes through numpy's uint64 on the host."""
    bits = torus_bits(phase.dtype)
    interv = (1 << bits) // msize
    half = interv // 2
    if bits < 64:
        u = (phase.to(torch.int64) + half) & ((1 << bits) - 1)
        return (u // interv % msize).to(torch.int32)
    with np.errstate(over="ignore"):
        u = phase.cpu().numpy().view(np.uint64) + np.uint64(half)
    out = np.asarray(u // np.uint64(interv) % np.uint64(msize), np.int32)
    return torch.from_numpy(out).to(phase.device)


def t64_to_t32(x: torch.Tensor) -> torch.Tensor:
    """Torus64 -> Torus32 keeping the top 32 bits, truncating toward zero
    (division by 2^32, not an arithmetic shift)."""
    x = x.to(torch.int64)
    q = x >> 32
    rem_nonzero = (x & 0xFFFFFFFF) != 0
    q = q + ((x < 0) & rem_nonzero).to(torch.int64)
    return q.to(torch.int32)

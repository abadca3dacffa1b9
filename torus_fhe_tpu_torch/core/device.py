"""Where the entry points put their keys and ciphertexts.

The keygen and loader entry points (boot/api.py, the keygens of
boot/bootstrap.py and boot/keyswitch.py, mk/keys3gen.py, bridge.py, the
loaders of utils/serialize.py) take
``device=None`` to mean the card: the current CUDA device. There is no
fallback to the CPU; a caller that wants the plain versions on the CPU says
``device="cpu"``. The constant gates (``gate_constant``, ``mk_gate_constant``)
default to where their cloud key lives. Inner helpers (core/rng.py, lwe.py, rlwe.py, tgsw.py) keep
torch's meaning of None: sampling on the host is by design.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device; None is the current CUDA device, and
    raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError('no CUDA device; pass device="cpu" to run the plain versions '
                               "on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)

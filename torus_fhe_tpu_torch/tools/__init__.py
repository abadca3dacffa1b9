"""Measurement tools of the port, each run as a script from the root of the
repository (see its docstring). What they share: the device synchronise
that ends a timed window, the card's name and power limit, and the log
line on standard error."""

from __future__ import annotations

import subprocess
import sys

import torch


def sync(device) -> None:
    """Wait for the card when ``device`` is a CUDA device."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def smi_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them; ``cpu`` on the CPU."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def log(tool: str, msg: str) -> None:
    """One line ``[tool] msg`` on standard error."""
    print(f"[{tool}] {msg}", file=sys.stderr, flush=True)

"""The one traffic generator: reads a mix's parameters from
traffic/<name>.json and drives the program with it from the seed.

A mix's ``kind`` names the file of perfbench/kinds/ that generates it
(byname.py): ``layered`` (layers of one batched gate call on seeded
permutations of the last layer), ``circuit`` (a closed loop of one client
sending one circuit of perfbench/circuits/ at a time). Every seed gets the
same sizes and the same amount of work per unit; the seed changes the keys,
the plaintexts, the gate order and the permutations.
"""

from __future__ import annotations

import json
import os

import torch

from .byname import ByName

KINDS = ByName("kinds", "traffic kind")


def load(root: str, name: str) -> dict:
    with open(os.path.join(root, "perfbench", "traffic", f"{name}.json")) as fh:
        mix = json.load(fh)
    if mix.get("kind") not in KINDS:
        raise ValueError(f"traffic {name}: kind {mix.get('kind')!r} is none of {sorted(KINDS)}")
    return mix


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make(mix: dict, cfg: dict, keys, prog, rng, gen, device):
    return KINDS[mix["kind"]].Traffic(mix, cfg, keys, prog, rng, gen, device)

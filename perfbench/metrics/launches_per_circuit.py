"""Rotate-kernel launches over the window (the program's counters) per
circuit completed."""

from perfbench import readers


def read(run):
    if not readers.circuit(run) or not run["units"]:
        return None
    return readers.rotate_launches(run)[0] / run["units"]

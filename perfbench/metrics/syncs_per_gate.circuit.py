"""Synchronising host calls per bootstrapped gate call in the traced
window: those inside the program's ``fhe.gate`` spans (nested spans
included) over the spans' count."""

from perfbench import spans


def read(run):
    return spans.per_gate(run, "syncs")

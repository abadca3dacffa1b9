"""Idle card ms per bootstrapped gate call in the traced window: the idle
seconds inside the program's ``fhe.gate`` spans (the gate's own host
dispatch, its rotate and its keyswitch) over the spans' count."""

from perfbench import spans


def read(run):
    idle = spans.per_gate(run, "idle_s")
    return None if idle is None else 1e3 * idle

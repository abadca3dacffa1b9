"""Share of the traced window in which nothing ran on the card, in %."""

from perfbench import readers


def read(run):
    return readers.idle_percent(run)

"""The blind rotate's share of its roofline in %: workcount.rotate's bound
at the window's batch over the mean device time of a rotate kernel in the
traced window."""

from perfbench import readers


def read(run):
    return readers.rotate_roofline_percent(run)

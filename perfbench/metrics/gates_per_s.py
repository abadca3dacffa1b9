"""Bootstrapped gates whose layer completed in the window, over the window."""


def read(run):
    return run["gates"] / run["window_s"] if run["gates"] else None

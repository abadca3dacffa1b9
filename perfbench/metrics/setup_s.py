"""Process start to the window's first operation, in s."""


def read(run):
    return run["setup_s"]

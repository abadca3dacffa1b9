"""The window over the circuits completed in it, in ms."""


def read(run):
    if run["mix"]["kind"] != "circuit" or not run["units"]:
        return None
    return 1e3 * run["window_s"] / run["units"]

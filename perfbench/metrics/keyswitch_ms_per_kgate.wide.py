"""Device ms of the int8 GEMMs (the keyswitch's one-hot products) in the
traced window per 1,000 gates of the window."""

from perfbench import tracing


def read(run):
    tr = run["trace"]
    if not tr or not run["gates"] or tracing.GEMM not in tr["device_s"]:
        return None
    return 1e3 * tr["device_s"][tracing.GEMM] / (run["gates"] / 1e3)

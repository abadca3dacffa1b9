"""Device ms of the records launched inside the program's ``fhe.keyswitch``
spans in the traced window (digits, one-hot, int8 GEMM, limb combine) per
such span: one span a keyswitch call."""

from perfbench import spans


def read(run):
    ks = spans.of(run, "fhe.keyswitch")
    return 1e3 * ks["device_s"] / ks["count"] if ks and ks["count"] else None

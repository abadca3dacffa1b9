"""Device ms of the rotate kernels in the traced window per kernel record."""

from perfbench import readers


def read(run):
    seconds, records = readers.rotate_records(run)
    return 1e3 * seconds / records if records else None

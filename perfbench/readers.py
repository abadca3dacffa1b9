"""What the metric readers (perfbench/metrics/*.py) share: each takes the
run record that harness.run_cell builds and returns a number, or None
where the run holds nothing for it to read."""

from __future__ import annotations

from . import tracing, workcount


def circuit(run: dict) -> bool:
    return run["mix"]["kind"] == "circuit"


def idle_percent(run: dict):
    """Share of the traced window in which nothing ran on the card."""
    tr = run["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def rotate_records(run: dict) -> tuple:
    """(device seconds, kernel records) of the blind-rotate kernels in the
    traced window."""
    tr = run["trace"]
    if not tr:
        return 0.0, 0
    cats = (tracing.ROTATE, tracing.ROTATE_SEL)
    return (sum(tr["device_s"].get(c, 0.0) for c in cats),
            sum(tr["records"].get(c, 0) for c in cats))


def rotate_launches(run: dict) -> tuple:
    """(launches, ciphertexts rotated) of both rotate kernels over the
    window, by the program's counters."""
    c = run["counters"]
    return (c["rotate_launches"] + c["rotate_sel_launches"],
            c["rotate_rows"] + c["rotate_sel_rows"])


def rotate_roofline_percent(run: dict):
    """The rotate's bound (workcount.rotate at the window's batch) over the
    mean device time of a rotate kernel record; None where the count does
    not read the configuration."""
    seconds, records = rotate_records(run)
    launches, rows = rotate_launches(run)
    if not records or not launches or rows % launches:
        return None
    work = workcount.rotate(run["config"], rows // launches)
    return None if work is None else 100.0 * work.bound_s() / (seconds / records)

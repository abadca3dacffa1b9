"""The 90th percentile of every circuit's latency in the window, in ms
(statistics.quantiles, n = 10, exclusive method)."""

import statistics


def read(run):
    lat = run.get("latencies_s") or []
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=10)[8]

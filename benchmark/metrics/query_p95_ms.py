"""The 95th percentile of every query's latency in the window (host
clock, call to result ready), in ms."""

import statistics


def read(summary: dict):
    lat = summary.get("latencies_s") or []
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3

"""Probe-side rows of every query completed in the window, over the
window's seconds (host clock, first query's call to last query's end)."""


def read(summary: dict):
    if summary.get("trace") or summary["window_s"] <= 0:
        return None
    return summary["queries"] * summary["probe_rows"] / summary["window_s"]

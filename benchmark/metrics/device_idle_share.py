"""1 - (union of the device's activity intervals inside the traced
window) / (the window's span), both from the one trace. Where the host
holds the device back (the join cells), the profiler's own host time
for each operation it records lengthens the gaps, so the traced share
reads above the untraced loop's."""


def read(summary: dict):
    if not summary.get("trace") or summary["busy_us"] <= 0 or summary["window_us"] <= 0:
        return None
    return 1.0 - summary["busy_us"] / summary["window_us"]

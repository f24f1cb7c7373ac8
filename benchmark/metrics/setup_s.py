"""Seconds from process start to the first timed query: imports, the
kernels' build where it is not cached, the tables made on the device,
the capture and the warm-up queries."""


def read(summary: dict):
    return summary.get("setup_s")

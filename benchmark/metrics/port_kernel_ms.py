"""Device ms per query in the port's own kernels: activities whose name
is a __global__ function of tpq_torch/csrc/*.cu."""


def read(summary: dict):
    if not summary.get("trace") or summary["port_us"] <= 0:
        return None
    return summary["port_us"] / 1e3 / summary["queries"]

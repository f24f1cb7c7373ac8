"""A query's least bytes at the card's published HBM bandwidth, over the
device busy time per query, in %. Least bytes: each input byte present
read once, each byte of the result the output contract defines written
once (benchmark/reference/<query>.py `least_bytes`), whatever kernels
the program runs."""


def read(summary: dict):
    peak, least = summary.get("hbm_peak"), summary.get("least_bytes")
    if not summary.get("trace") or not peak or not least or summary["busy_us"] <= 0:
        return None
    busy_s_per_query = summary["busy_us"] / 1e6 / summary["queries"]
    return 100.0 * (least / peak) / busy_s_per_query

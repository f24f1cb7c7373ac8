"""The share of the lane join's tail window that its matches past the
K-th inline ranks fill: the counters tpq.lane.tail_rows over
tpq.lane.tail_cap that the program observes in every traced replay
(tpq_torch.trace). Past 1 the lane join falls back to its union sort.
Nothing (None) where the program keeps no records, its calls replayed no
graph or none ran a lane join."""


def read(summary: dict):
    from benchmark.harness.kernel_bytes import observed

    seen = observed(summary, "tpq.lane.tail_cap")
    cap = sum(o["tpq.lane.tail_cap"] for o in seen)
    if cap <= 0:
        return None
    return sum(o["tpq.lane.tail_rows"] for o in seen) / cap

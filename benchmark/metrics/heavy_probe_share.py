"""The share of the live probe rows that the skew split sends down its
heavy path: the counters tpq.skew.heavy_probe_rows over tpq.skew.probe_rows
that the program observes in every traced replay (tpq_torch.trace).
Nothing (None) where the program keeps no records, its calls replayed no
graph or no call ran the split."""


def read(summary: dict):
    from tpq_torch import trace

    last = getattr(trace, "last_calls", None)
    calls = last(summary.get("queries", 0)) if last and summary.get("trace") else None
    seen = [c["observed"] for c in calls or () if "tpq.skew.probe_rows" in c["observed"]]
    rows = sum(o["tpq.skew.probe_rows"] for o in seen)
    if rows <= 0:
        return None
    return sum(o["tpq.skew.heavy_probe_rows"] for o in seen) / rows

"""Device ms per query in the distributed join's exchanges (the top-level
spans tpq.dist.exchange: bucketing by destination and the collective,
for R and for S), timed inside the graph on every traced replay, from
the program's records (tpq_torch.trace). Nothing (None) where the
program keeps no records, its calls replayed no graph or no call has
such a span."""


def read(summary: dict):
    from tpq_torch import trace

    last = getattr(trace, "last_calls", None)
    calls = last(summary.get("queries", 0)) if last and summary.get("trace") else None
    ms = [s["ms"] for c in calls or () for s in c["spans"] if s["name"] == "tpq.dist.exchange"]
    if not ms:
        return None
    return sum(ms) / len(calls)

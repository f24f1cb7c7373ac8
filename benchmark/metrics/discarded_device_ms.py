"""Device ms per query in work whose output was thrown away: the spans a
cond's else branch discarded (the lane attempt before the union-sort
fallback, the skew split before its fallback) or a whole replay a rerun
discarded. From the program's records of the traced window's calls
(tpq_torch.trace), whose spans tile each body; 0 where nothing was
discarded, nothing (None) where the program keeps no records or its
calls replayed no graph."""


def read(summary: dict):
    from tpq_torch import trace

    last = getattr(trace, "last_calls", None)
    calls = last(summary.get("queries", 0)) if last and summary.get("trace") else None
    if not calls:
        return None
    return sum(s["ms"] for c in calls for s in c["spans"] if s["discarded"]) / len(calls)

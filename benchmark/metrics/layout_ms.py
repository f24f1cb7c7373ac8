"""Device ms per query in the lane join's probe layout (the top-level span
tpq.lane.layout: the partition sort, the gathers, PAD and the pushed-down
filter), timed inside the graph on every traced replay, from the
program's records (tpq_torch.trace). Nothing (None) where the program
keeps no records or its calls replayed no graph; 0 where the layout runs
inside another span (the skew split's light path), which times it with
the rest."""


def read(summary: dict):
    from tpq_torch import trace

    last = getattr(trace, "last_calls", None)
    calls = last(summary.get("queries", 0)) if last and summary.get("trace") else None
    if not calls:
        return None
    return sum(s["ms"] for c in calls for s in c["spans"]
               if s["name"] == "tpq.lane.layout") / len(calls)

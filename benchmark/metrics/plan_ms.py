"""Host ms per query in the distributed join's eager planner
(plan_dist_capacities: two passes over the keys, two host reads), from
entry to return, from the "plan" entry of the program's records of the
traced window's calls (tpq_torch.trace). Nothing (None) where the
program keeps no records, its calls replayed no graph or carry no plan."""


def read(summary: dict):
    from tpq_torch import trace

    last = getattr(trace, "last_calls", None)
    calls = last(summary.get("queries", 0)) if last and summary.get("trace") else None
    plans = [c["plan"] for c in calls or () if "plan" in c]
    if not plans:
        return None
    return sum(p["ms"] for p in plans) / len(calls)

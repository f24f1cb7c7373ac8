"""Host ms per query in the jit's own phases, from the program's records
of the traced window's calls (tpq_torch.trace): the spans
tpq.jit.signature (flatten, key lookup, address check), load (copy-in,
numbers), launch (the graph's replay) and result (copy-out). The flags
read, a wait for the card, is left out. Nothing (None) where the program
keeps no records or its calls replayed no graph."""

PHASES = ("signature", "load", "launch", "result")


def read(summary: dict):
    from tpq_torch import trace

    last = getattr(trace, "last_calls", None)
    calls = last(summary.get("queries", 0)) if last and summary.get("trace") else None
    if not calls:
        return None
    return sum(c["host_ms"].get(p, 0.0) for c in calls for p in PHASES) / len(calls)

"""The share of the exchanges' slots that hold a live row: the counters
tpq.dist.exchange_rows over tpq.dist.exchange_slots that the program
observes in every traced replay (tpq_torch.trace). The dense exchange
copies every slot of its buckets, so a low fill is padding copied.
Nothing (None) where the program keeps no records, its calls replayed no
graph or none observed an exchange."""


def read(summary: dict):
    from tpq_torch import trace

    last = getattr(trace, "last_calls", None)
    calls = last(summary.get("queries", 0)) if last and summary.get("trace") else None
    seen = [c["observed"] for c in calls or () if "tpq.dist.exchange_slots" in c["observed"]]
    slots = sum(o["tpq.dist.exchange_slots"] for o in seen)
    if slots <= 0:
        return None
    return sum(o["tpq.dist.exchange_rows"] for o in seen) / slots

"""What the kernels' roofline shares read: each kernel's least bytes a
call, from the shapes the program observes in its records of the traced
window's calls (tpq_torch.trace, `observed`), and its device ms a query,
from the traced run's breakdown.

  * The walk/emit (csrc/lane2.cu `walk_emit_kernel`): each padded probe
    slot's key and payloads read once, each table slot's key and
    payloads read once, and each inline output row (key, R payloads, S
    payloads) written once. The lane join holds every column as int64;
    the lanes, occupancies and bucket lengths are not counted.
  * The radix split (csrc/radix_sort.cu: `digit_scatter_kernel`,
    `digit_count_kernel`, `digit_scan_kernel`): each pass reads and
    writes every int32 plane of every row once.
"""

from __future__ import annotations

WORD = 8   # bytes of an int64 column's element
PLANE = 4  # bytes of an int32 plane's element

WALK_EMIT = ("walk_emit_kernel",)
SPLIT = ("digit_scatter_kernel", "digit_count_kernel", "digit_scan_kernel")


def observed(summary: dict, name: str) -> list:
    """The observed values of the traced window's calls that observed
    `name`; none where the program keeps no records or its calls
    replayed no graph."""
    from tpq_torch import trace

    last = getattr(trace, "last_calls", None)
    calls = last(summary.get("queries", 0)) if last and summary.get("trace") else None
    return [c["observed"] for c in calls or () if name in c["observed"]]


def walk_emit_bytes(o: dict) -> int:
    """The walk/emit's least bytes from one call's tpq.lane.* counters."""
    nr, ns = o["tpq.lane.build_payloads"], o["tpq.lane.probe_payloads"]
    return WORD * ((1 + ns) * o["tpq.lane.probe_slots"]
                   + (1 + nr) * o["tpq.lane.table_slots"]
                   + (1 + nr + ns) * o["tpq.lane.inline_rows"])


def split_bytes(o: dict) -> int:
    """The radix sort's least bytes over all its passes from one call's
    tpq.radix.* counters."""
    return o["tpq.radix.passes"] * o["tpq.radix.rows"] * o["tpq.radix.planes"] * PLANE * 2


def device_ms(summary: dict, kernels) -> float | None:
    """Device ms a query in the breakdown's device ops named after one of
    `kernels` (their namespace and template arguments aside). Nothing
    (None) where the first is not among them: the breakdown lists the
    ten longest ops only."""
    ops = (summary.get("breakdown") or {}).get("device_ops") or []
    found = {k: sum(s for n, s in ops if k in n) for k in kernels
             if any(k in n for n, _ in ops)}
    if kernels[0] not in found or summary.get("queries", 0) <= 0:
        return None
    return sum(found.values()) * 1e3 / summary["queries"]


def roofline_pct(summary: dict, counter: str, nbytes, kernels) -> float | None:
    """A kernel's least bytes a query at the card's published HBM
    bandwidth over its device time a query, in %: the bytes from the
    calls that observed `counter`, by `nbytes(observed)`."""
    peak = summary.get("hbm_peak")
    seen = observed(summary, counter)
    ms = device_ms(summary, kernels)
    if not peak or not seen or not ms:
        return None
    least = sum(nbytes(o) for o in seen) / len(seen)
    return 100.0 * (least / peak) / (ms / 1e3)

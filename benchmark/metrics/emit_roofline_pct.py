"""The walk/emit kernel's least bytes a query (benchmark/harness/
kernel_bytes.py: padded probe slots and table slots read once, inline
rows written once, from the tpq.lane.* counters of the traced window's
calls) at the card's published HBM bandwidth, over the device ms a query
of `walk_emit_kernel` in the trace, in %. Nothing (None) where the
program observes no lane shapes or the kernel is not among the trace's
longest ops."""


def read(summary: dict):
    from benchmark.harness import kernel_bytes as kb

    return kb.roofline_pct(summary, "tpq.lane.probe_slots", kb.walk_emit_bytes,
                           kb.WALK_EMIT)

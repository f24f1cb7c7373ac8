"""The radix split's least bytes a query (benchmark/harness/
kernel_bytes.py: each pass reads and writes every int32 plane of every
row once, from the tpq.radix.* counters of the traced window's calls) at
the card's published HBM bandwidth, over the device ms a query of the
split's scatter, count and scan kernels in the trace, in %. Nothing
(None) where the program observes no radix sort or the scatter kernel is
not among the trace's longest ops."""


def read(summary: dict):
    from benchmark.harness import kernel_bytes as kb

    return kb.roofline_pct(summary, "tpq.radix.passes", kb.split_bytes, kb.SPLIT)

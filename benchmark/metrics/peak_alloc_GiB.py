"""torch.cuda.max_memory_allocated() over set-up (from the resident
tables on) and the window, read before the reference runs, in GiB."""


def read(summary: dict):
    peak = summary.get("peak_alloc_bytes")
    return peak / 2**30 if peak else None

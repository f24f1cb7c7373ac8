"""What a query kind's module (benchmark/queries/<kind>.py) hands the
harness: the program's call, made ready over the resident tables."""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable


@dataclass
class Prepared:
    """`call()` runs one query and returns its result: an object with
    `columns` (name -> tensor of the output capacity) and `num_rows` (a
    0-d tensor; past the capacity on overflow). `probe_rows` is the
    probe-side rows one query processes.
    `counters()` reads the program's own counters, `path()` says which
    path the program takes on these inputs (it runs the program; call
    it after the window), `close()` frees the program's state."""

    call: Callable
    probe_rows: int
    counters: Callable[[], dict] = field(default=dict)
    path: Callable[[], dict] = field(default=dict)
    close: Callable[[], None] = field(default=lambda: None)


def padded_result(columns: dict, capacity: int, device):
    """A result of live columns in the program's form: int64 columns of
    the output capacity, zero past the live rows (cut at the capacity),
    and num_rows the full count."""
    import torch

    n = next(iter(columns.values())).shape[0]
    m = min(n, capacity)
    full = {}
    for name, c in columns.items():
        buf = torch.zeros(capacity, dtype=torch.int64, device=device)
        buf[:m] = c[:m].to(torch.int64)
        full[name] = buf
    return SimpleNamespace(columns=full,
                           num_rows=torch.tensor(n, dtype=torch.int32, device=device))

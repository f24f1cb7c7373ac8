"""Macro-chunks of the probe side (port of tpq/dist/overlap.py).

The probe side is split into `n_chunks` static chunks; each chunk's
exchange depends only on its own slice and each local join only on its
own exchanged chunk. tpq leaves the overlap of chunk i+1's exchange with
chunk i's join to XLA's async collective scheduler; the port runs the
chunks in order, with the same dependence graph and the same rows.
"""

from __future__ import annotations

import torch

from tpq_torch.columnar import Table


def chunk_table(t: Table, n_chunks: int) -> list[Table]:
    """Static split along the capacity axis; chunk c holds rows
    [c*cap/n, (c+1)*cap/n) with a clamped local row count."""
    cap = t.capacity
    assert cap % n_chunks == 0, (cap, n_chunks)
    ck = cap // n_chunks
    out = []
    for c in range(n_chunks):
        cols = {k: v[c * ck:(c + 1) * ck] for k, v in t.columns.items()}
        out.append(Table(cols, (t.num_rows - c * ck).clamp(0, ck)))
    return out


def concat_tables(tables: list[Table]) -> tuple[Table, torch.Tensor]:
    """Concatenate chunked results (each with leading-valid rows) into one
    capacity-summed Table + the slot-validity mask (caller compacts)."""
    names = tables[0].names
    cols = {n: torch.cat([t.columns[n] for t in tables]) for n in names}
    valid = torch.cat([t.valid_mask() for t in tables])
    total = torch.stack([t.num_rows for t in tables]).sum(dtype=torch.int32)
    return Table(cols, total), valid

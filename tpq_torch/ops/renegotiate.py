"""Capacity renegotiation (port of tpq/ops/renegotiate.py).

Every operator has a static output capacity and reports overflow as
`num_rows > capacity`. This host loop closes it: run the operator, read
`num_rows` once, and if it passed the capacity run again at
next_pow2(max(2 * capacity, total)). Nothing is resumed: each try
recomputes from the same inputs.
"""

from __future__ import annotations

from typing import Callable

from tpq_torch.columnar import Table, next_pow2


def run_renegotiated(make_fn: Callable[[int], Callable[..., Table]],
                     args: tuple, out_capacity: int,
                     max_retries: int = 8) -> Table:
    """Run `make_fn(capacity)(*args)`, growing the capacity until the
    result fits. The operator's `num_rows` must be the true total even
    past its capacity (every tpq_torch operator's is), so one retry is
    enough."""
    cap = next_pow2(out_capacity)
    for _ in range(max_retries + 1):
        out = make_fn(cap)(*args)
        total = int(out.num_rows)  # one device sync a try
        if total <= cap:
            return out
        cap = next_pow2(max(2 * cap, total))
    raise RuntimeError(
        f"renegotiation failed after {max_retries} retries (last capacity {cap})")

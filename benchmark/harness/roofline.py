"""The table of published peaks the rooflines are held against.

A roofline share is the least time the card could take for a query's
least bytes at its published bandwidth, over the device time the query
took. The peak is the data sheet's, not a measured copy rate, so a
faster copy does not move the yardstick; the card's power limit is
printed beside every share, since a card set below its maximum reaches
less.
"""

from __future__ import annotations

# torch.cuda.get_device_name() -> HBM bytes/s. NVIDIA H100 data sheet,
# SXM part, whose rates hold at its 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def hbm_peak(device_kind: str | None) -> float | None:
    """The published HBM bytes/s of a card, None for a card not in the
    table (its roofline shares are then not reported)."""
    return PEAKS.get(device_kind or "")

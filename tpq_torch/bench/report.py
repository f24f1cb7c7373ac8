"""Bench report emission (port of tpq/bench/report.py): records to a
JSON file and to a markdown table, byte for byte as tpq writes them."""

from __future__ import annotations

import json


def emit_json(path: str, payload: dict) -> None:
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)


def markdown_table(rows: list[dict], columns: list[str] | None = None) -> str:
    """One row per record; floats at two decimals, a missing key empty."""
    if not rows:
        return "(no rows)\n"
    columns = columns or list(rows[0].keys())
    out = ["| " + " | ".join(columns) + " |", "|" + "---|" * len(columns)]
    for r in rows:
        cells = []
        for c in columns:
            v = r.get(c, "")
            cells.append(f"{v:.2f}" if isinstance(v, float) else str(v))
        out.append("| " + " | ".join(cells) + " |")
    return "\n".join(out) + "\n"

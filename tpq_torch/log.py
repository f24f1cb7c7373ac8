"""Structured per-op log (port of tpq/log.py).

Every operator run of the bench path appends one JSON record {op,
rows, elapsed_ms, ...} to an in-memory list and, when `path` is set, to
a .jsonl file. The runner calls it around whole runs, never inside a
kernel wrapper.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any


@dataclass
class OpLog:
    path: str | None = None
    records: list[dict] = field(default_factory=list)

    def emit(self, **record: Any) -> None:
        record.setdefault("t", time.time())
        self.records.append(record)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")


GLOBAL_LOG = OpLog()

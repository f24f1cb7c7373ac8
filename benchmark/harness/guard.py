"""What may not be loaded in a run: JAX, its libraries and the JAX
package the port was made from, compared by whole top-level module
name (`tpq_torch` is not `tpq`)."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tpq"})


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & FORBIDDEN)

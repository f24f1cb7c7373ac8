"""tpq_torch — the PyTorch and CUDA port of tpq for NVIDIA Hopper.

Mirrors tpq's layout: columnar (Table), hashing, datagen, colio, config,
ops (operators), kernels (CUDA kernels beside their plain torch
versions, sources in csrc/), bench. Imports torch and numpy only, never
jax or tpq.
"""

from tpq_torch.columnar import Table  # noqa: F401

__version__ = "0.1.0"

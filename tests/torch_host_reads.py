"""A guard on host reads of tensors, for tests/test_torch_jit.py and the
jit cases of test_torch_lane.py and test_torch_skew.py: while it is
active, Tensor.__bool__, .item, .tolist, __int__, __float__ and
__index__ raise (mode "raise") or are counted (mode "count"). These are
the Python-level reads that wait for the card and copy to the host; a
body that makes none runs under a CUDA graph capture. No JAX."""

import contextlib

import torch

READS = ("__bool__", "item", "tolist", "__int__", "__float__", "__index__")


@contextlib.contextmanager
def host_reads(mode: str = "raise"):
    """Yields the list of the reads made (names), in count mode."""
    if mode not in ("raise", "count"):
        raise ValueError(f"mode {mode!r}")
    made: list = []
    own = {n: torch.Tensor.__dict__.get(n) for n in READS}

    def guard(name):
        orig = getattr(torch.Tensor, name)

        def read(self, *args, **kwargs):
            if mode == "raise":
                raise AssertionError(f"host read: Tensor.{name}")
            made.append(name)
            return orig(self, *args, **kwargs)
        return read

    for name in READS:
        setattr(torch.Tensor, name, guard(name))
    try:
        yield made
    finally:
        for name, fn in own.items():
            if fn is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, fn)

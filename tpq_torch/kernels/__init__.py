"""Hand-written CUDA kernels for Hopper (sources in tpq_torch/csrc/), each
beside its plain torch version."""

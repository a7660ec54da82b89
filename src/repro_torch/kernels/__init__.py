"""Hand-written Hopper kernels: CUDA sources in ``repro_torch/csrc/``."""

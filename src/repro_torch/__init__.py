"""PyTorch + CUDA port of the NSFlow reproduction, for NVIDIA Hopper.

A second package beside the JAX reference ``repro``: modules sit at the
same relative paths and keep the same public names.  It imports ``torch``
and never ``jax`` or ``repro``.  The Pallas kernels on its path are
rewritten by hand in CUDA C++ (``csrc/``); see ``backend/registry.py``.
"""

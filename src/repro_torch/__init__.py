"""PyTorch/CUDA port of the Domino reproduction.

A second package beside the JAX reference ``repro``: the same module
layout, host modules copied, numeric modules re-implemented on torch
tensors, and the Pallas CIM kernel rewritten as a CUDA kernel for
Hopper (``csrc/cim_matmul.cu``).  Nothing here imports ``jax`` or
``repro``.  Entry points run on the card (``device=None`` means
``"cuda"``) unless the caller passes ``device="cpu"``.
"""

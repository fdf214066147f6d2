"""PyTorch/CUDA port of the adaptive quadrature engine.

The single-device Genz-Malik path of :mod:`repro` (the JAX package, which
stays the reference) rebuilt on PyTorch, with the fused rule evaluation as a
hand-written CUDA kernel for Hopper (``kernels/csrc``).  Entry points run on
the CUDA device unless the caller asks for ``device="cpu"``.
"""

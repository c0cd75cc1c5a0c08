"""PyTorch/CUDA port of the distributed sparse kernels (``repro``).

The JAX package ``repro`` is the reference; this package mirrors its
module names and public signatures, runs its local kernels as CUDA C++
written for Hopper (``kernels/csrc``), and imports neither ``jax`` nor
anything of ``repro``.
"""

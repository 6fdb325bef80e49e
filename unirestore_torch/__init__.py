"""UniRestore in PyTorch with hand-written CUDA kernels for Hopper (H100).

Mirrors ``unirestore_tpu``'s layout (``nn/``, ``diffusion/``, ``models/``,
``ops/``) with the same module and function names, so each function's JAX
counterpart is found by path. Public functions keep the JAX layouts: NHWC
images and feature maps, (B, T, C) tokens. Parameters are nested dicts and
lists of tensors shaped like the JAX pytrees, except conv weights, which are
OIHW (PyTorch's layout) instead of HWIO; ``bridge`` converts one to the
other.

This package imports ``torch`` and ``numpy`` only: never ``jax`` and nothing
of ``unirestore_tpu``.
"""

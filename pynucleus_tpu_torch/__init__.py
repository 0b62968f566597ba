"""PyTorch/CUDA port of the nonlocal finite element framework.

The JAX package ``pynucleus_tpu`` is the reference; this package keeps its
module paths and class names and imports ``torch`` (never ``jax``).  The
first slice is the dense fractional-Laplacian solve (P1, constant order,
infinite horizon, zero exterior, CG-Jacobi); its device work runs through
four hand-written kernels (``pynucleus_tpu_torch/kernels``).
"""
from .config import REAL, INDEX, getDevice

__all__ = ['REAL', 'INDEX', 'getDevice']

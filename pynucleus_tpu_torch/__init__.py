"""PyTorch/CUDA port of the nonlocal finite element framework.

The JAX package ``pynucleus_tpu`` is the reference; this package keeps its
module paths and class names and imports ``torch`` (never ``jax``).  It
runs the fractional-Laplacian solve (P1, constant order, infinite horizon,
zero exterior, CG-Jacobi) with a dense or an H2 operator; its device work
runs through eight hand-written kernels (``pynucleus_tpu_torch/kernels``).
"""
from .config import REAL, INDEX, getDevice

__all__ = ['REAL', 'INDEX', 'getDevice']

"""PyTorch/CUDA port of the nonlocal finite element framework.

The JAX package ``pynucleus_tpu`` is the reference; this package keeps its
module paths and class names and imports ``torch`` (never ``jax``).  It
runs the fractional-Laplacian solve (P1, constant order, infinite horizon,
zero exterior) with a dense or an H2 operator, the finite-horizon nonlocal
problems, and serial geometric multigrid on the Poisson problem, with LU,
CG, GMRES, BiCGStab and multigrid; its device work runs through eighteen
hand-written kernels (``pynucleus_tpu_torch/kernels``).
"""
from .config import REAL, INDEX, getDevice

__all__ = ['REAL', 'INDEX', 'getDevice']

"""K10 jacobi_smooth: the damped-Jacobi vector pass of the V-cycle (Triton).

Replaces the vector arithmetic of pynucleus_tpu/multilevel/gmg.py:_vcycle
(Jacobi branch, lines 216-218, 220 and 235-236) in three modes of one
kernel, each one elementwise pass over the level's vectors:

  ZERO      x = omega * (Dinv * b)              (first pre-sweep, x = 0)
  RESIDUAL  x = b - Ax                          (the defect before P^T)
  UPDATE    x = x + omega * (Dinv * (b - Ax))   (a sweep after A x)

``Ax`` is the level operator's matvec, made before the launch (torch.mv or
kernel K8).  Bound on the card: memory (3 to 5 float64 vectors read or
written per element, no reuse, no tensor-core work), plus the launch at
the coarse levels, where the vectors hold 1 to a few thousand entries.

``triton`` is imported inside :func:`launch`, so that this module imports
on machines without it.
"""
from __future__ import annotations

BLOCK = 1024
ZERO, RESIDUAL, UPDATE = 0, 1, 2
MODES = {'zero': ZERO, 'residual': RESIDUAL, 'update': UPDATE}
_kernel = None


def _build():
    # Triton resolves names in a kernel through the module's globals, so
    # triton and tl are bound there -- at the first launch, not at import
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def _jacobi_kernel(x_ptr, b_ptr, ax_ptr, dinv_ptr, omega_ptr, n,
                       MODE: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        omega = tl.load(omega_ptr)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        b = tl.load(b_ptr + offs, mask=m, other=0.0)
        if MODE == 0:
            d = tl.load(dinv_ptr + offs, mask=m, other=0.0)
            x = omega * (d * b)
        elif MODE == 1:
            ax = tl.load(ax_ptr + offs, mask=m, other=0.0)
            x = b - ax
        else:
            d = tl.load(dinv_ptr + offs, mask=m, other=0.0)
            ax = tl.load(ax_ptr + offs, mask=m, other=0.0)
            x = tl.load(x_ptr + offs, mask=m, other=0.0)
            x = x + omega * (d * (b - ax))
        tl.store(x_ptr + offs, x, mask=m)

    return _jacobi_kernel


def launch(mode, x, b, Ax, Dinv, omega):
    """Launch one pass of ``mode`` (ZERO, RESIDUAL or UPDATE) on the
    current stream; unused pointers may be any float64 tensor.  ``omega``
    is a float64 tensor of one element on the device (a Python float would
    reach the kernel as float32)."""
    global _kernel
    import triton
    if _kernel is None:
        _kernel = _build()
    n = x.shape[0]
    _kernel[(triton.cdiv(n, BLOCK),)](x, b, Ax, Dinv, omega, n, MODE=mode,
                                      BLOCK=BLOCK)

"""K10 jacobi_smooth: the damped-Jacobi vector pass of the V-cycle (Triton).

Replaces the vector arithmetic of pynucleus_tpu/multilevel/gmg.py:_vcycle
(Jacobi branch, lines 216-218, 220 and 235-236) in three modes of one
kernel, each one elementwise pass over the level's vectors:

  ZERO      x = omega * (Dinv * b)              (first pre-sweep, x = 0)
  RESIDUAL  x = b - Ax                          (the defect before P^T)
  UPDATE    x = x + omega * (Dinv * (b - Ax))   (a sweep after A x)

``Ax`` is the level operator's matvec, made before the launch (torch.mv,
kernel K8 or K9).  Bound on the card: memory (3 to 5 vectors read or
written per element, no reuse, no tensor-core work), plus the launch at
the coarse levels, where the vectors hold 1 to a few thousand entries.

The complex variant (complex128 x, b, Ax and Dinv, a real omega: the
complex-shifted Laplacian's V-cycle of runHelmholtz) is a second kernel
of the same modes.  Triton has no complex type: it reads the vectors'
float64 views [n, 2], re at 2 i and im at 2 i + 1, and writes the complex
products out by hand.

``triton`` is imported inside :func:`launch`, so that this module imports
on machines without it.
"""
from __future__ import annotations

BLOCK = 1024
ZERO, RESIDUAL, UPDATE = 0, 1, 2
MODES = {'zero': ZERO, 'residual': RESIDUAL, 'update': UPDATE}
_kernels = None


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

    @triton.jit
    def _jacobi_complex_kernel(x_ptr, b_ptr, ax_ptr, dinv_ptr, omega_ptr, n,
                               MODE: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        omega = tl.load(omega_ptr)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        re = 2 * offs
        br = tl.load(b_ptr + re, mask=m, other=0.0)
        bi = tl.load(b_ptr + re + 1, mask=m, other=0.0)
        if MODE == 0:
            dr = tl.load(dinv_ptr + re, mask=m, other=0.0)
            di = tl.load(dinv_ptr + re + 1, mask=m, other=0.0)
            xr = omega * (dr * br - di * bi)
            xi = omega * (dr * bi + di * br)
        elif MODE == 1:
            xr = br - tl.load(ax_ptr + re, mask=m, other=0.0)
            xi = bi - tl.load(ax_ptr + re + 1, mask=m, other=0.0)
        else:
            dr = tl.load(dinv_ptr + re, mask=m, other=0.0)
            di = tl.load(dinv_ptr + re + 1, mask=m, other=0.0)
            rr = br - tl.load(ax_ptr + re, mask=m, other=0.0)
            ri = bi - tl.load(ax_ptr + re + 1, mask=m, other=0.0)
            xr = tl.load(x_ptr + re, mask=m, other=0.0) \
                + omega * (dr * rr - di * ri)
            xi = tl.load(x_ptr + re + 1, mask=m, other=0.0) \
                + omega * (dr * ri + di * rr)
        tl.store(x_ptr + re, xr, mask=m)
        tl.store(x_ptr + re + 1, xi, mask=m)

    return _jacobi_kernel, _jacobi_complex_kernel


def launch(mode, x, b, Ax, Dinv, omega):
    """Launch one pass of ``mode`` (ZERO, RESIDUAL or UPDATE) on the
    current stream, the complex variant for complex128 vectors; unused
    pointers may be any vector of x's type.  ``omega`` is a float64 tensor
    of one element on the device (a Python float would reach the kernel as
    float32)."""
    global _kernels
    import torch
    import triton
    if _kernels is None:
        _kernels = _build()
    n = x.shape[0]
    if x.is_complex():
        # an unused omega may be a complex placeholder too
        x, b, Ax, Dinv, omega = (torch.view_as_real(t) if t.is_complex()
                                 else t for t in (x, b, Ax, Dinv, omega))
        kernel = _kernels[1]
    else:
        kernel = _kernels[0]
    kernel[(triton.cdiv(n, BLOCK),)](x, b, Ax, Dinv, omega, n, MODE=mode,
                                     BLOCK=BLOCK)

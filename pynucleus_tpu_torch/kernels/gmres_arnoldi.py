"""K17 gmres_arnoldi: the vector work of one GMRES Arnoldi step (Triton).

Replaces the O(n) work of pynucleus_tpu/base/solvers.py:365 _gmres_cycle:
the modified Gram-Schmidt of ``w = A z`` against the basis V (``ortho``,
lines 394-400), the norm and the new basis vector (401-403), and the
update ``x0 + Z^T y`` (450).  The matvec and the preconditioner stay the
operators' own; the Givens rotations and the back substitution are
O(restart^2) scalars on the host.

Step j, after ``w = A z``, in the JAX package's order (i = 0..j):

  1. partial sums of V[0].w                            (_dot_kernel)
  2. for each i: h_i = the sum of the partials;  w -= h_i V[i];  h[i] =
     h_i;  partial sums of V[i+1].w, or of w.w after the last i
                                                       (_mgs_kernel)
  3. hnorm = sqrt(the sum);  V[j+1] = w / hnorm where hnorm > guard, else
     w;  h[j+1] = hnorm                                (_normalize_kernel)

The start of a cycle is 1 and 3 on r = b - A x0 (V[0] = r / beta where
beta > 0, h[0] = beta).  ``combine`` is x += sum_k y_k B[k]
(_combine_kernel).  Every program reduces the same partial sums in the
same order (as K4), so all see identical scalars; successive launches
alternate between two rows of partials, so that none overwrites partials
another program of the same launch still reads.  Bound on the card:
memory (step j reads and writes w j+2 times and reads each V[i] once, no
reuse between the dependent launches) plus j+3 launches.

The complex variant (complex128 V, w, h and y: runHelmholtz's GMRES) is
a second set of the same four kernels.  Triton has no complex type: they
read the float64 views [n, 2] (re at 2 i, im at 2 i + 1) and write the
complex products out by hand.  A dot V[i]^H w (conjugated, as jnp.vdot)
is two real partial sums per program, of Re and of Im, kept in the two
halves of a row of partials and reduced in the same order as the real
ones; the norm sums |w|^2; the combine takes complex y.

``triton`` is imported inside the launching functions, so that this
module imports on machines without it.
"""
from __future__ import annotations

BLOCK = 1024
_kernels = None


def _build():
    # Triton resolves names in a kernel through the module's globals, so
    # triton and tl are bound there -- at the first launch, not at import
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def _dot_kernel(a_ptr, b_ptr, part_ptr, n, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        a = tl.load(a_ptr + offs, mask=m, other=0.0)
        b = tl.load(b_ptr + offs, mask=m, other=0.0)
        tl.store(part_ptr + pid, tl.sum(a * b, axis=0))

    @triton.jit(do_not_specialize=['i'])
    def _mgs_kernel(w_ptr, vi_ptr, vnext_ptr, partin_ptr, partout_ptr,
                    h_ptr, i, n, nparts, LAST: tl.constexpr,
                    BLOCK: tl.constexpr, NPART: tl.constexpr):
        pid = tl.program_id(0)
        k = tl.arange(0, NPART)
        h = tl.sum(tl.load(partin_ptr + k, mask=k < nparts, other=0.0),
                   axis=0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        w = tl.load(w_ptr + offs, mask=m, other=0.0)
        vi = tl.load(vi_ptr + offs, mask=m, other=0.0)
        w = w - h * vi
        tl.store(w_ptr + offs, w, mask=m)
        if LAST:
            tl.store(partout_ptr + pid, tl.sum(w * w, axis=0))
        else:
            vn = tl.load(vnext_ptr + offs, mask=m, other=0.0)
            tl.store(partout_ptr + pid, tl.sum(vn * w, axis=0))
        if pid == 0:
            tl.store(h_ptr + i, h)

    @triton.jit(do_not_specialize=['slot'])
    def _normalize_kernel(w_ptr, out_ptr, partin_ptr, h_ptr, guard_ptr,
                          slot, n, nparts, BLOCK: tl.constexpr,
                          NPART: tl.constexpr):
        pid = tl.program_id(0)
        k = tl.arange(0, NPART)
        nrm = tl.sqrt(tl.sum(tl.load(partin_ptr + k, mask=k < nparts,
                                     other=0.0), axis=0))
        guard = tl.load(guard_ptr)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        w = tl.load(w_ptr + offs, mask=m, other=0.0)
        tl.store(out_ptr + offs, tl.where(nrm > guard, w / nrm, w), mask=m)
        if pid == 0:
            tl.store(h_ptr + slot, nrm)

    @triton.jit
    def _combine_kernel(x_ptr, b_ptr, y_ptr, nvec, n, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        acc = tl.zeros((BLOCK,), dtype=tl.float64)
        for kk in range(0, nvec):
            row = b_ptr + kk.to(tl.int64) * n
            acc += tl.load(y_ptr + kk) * tl.load(row + offs, mask=m,
                                                 other=0.0)
        x = tl.load(x_ptr + offs, mask=m, other=0.0)
        tl.store(x_ptr + offs, x + acc, mask=m)

    # ---- the complex variant: float64 views, re at 2 i, im at 2 i + 1;
    # a row of partials holds the Re sums in [0, nparts), the Im sums in
    # [nparts, 2 nparts)

    @triton.jit
    def _dot_complex_kernel(a_ptr, b_ptr, part_ptr, n, nparts,
                            BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        ar = tl.load(a_ptr + 2 * offs, mask=m, other=0.0)
        ai = tl.load(a_ptr + 2 * offs + 1, mask=m, other=0.0)
        br = tl.load(b_ptr + 2 * offs, mask=m, other=0.0)
        bi = tl.load(b_ptr + 2 * offs + 1, mask=m, other=0.0)
        tl.store(part_ptr + pid, tl.sum(ar * br + ai * bi, axis=0))
        tl.store(part_ptr + nparts + pid, tl.sum(ar * bi - ai * br, axis=0))

    @triton.jit(do_not_specialize=['i'])
    def _mgs_complex_kernel(w_ptr, vi_ptr, vnext_ptr, partin_ptr,
                            partout_ptr, h_ptr, i, n, nparts,
                            LAST: tl.constexpr, BLOCK: tl.constexpr,
                            NPART: tl.constexpr):
        pid = tl.program_id(0)
        k = tl.arange(0, NPART)
        hr = tl.sum(tl.load(partin_ptr + k, mask=k < nparts, other=0.0),
                    axis=0)
        hi = tl.sum(tl.load(partin_ptr + nparts + k, mask=k < nparts,
                            other=0.0), axis=0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        wr = tl.load(w_ptr + 2 * offs, mask=m, other=0.0)
        wi = tl.load(w_ptr + 2 * offs + 1, mask=m, other=0.0)
        vr = tl.load(vi_ptr + 2 * offs, mask=m, other=0.0)
        vi = tl.load(vi_ptr + 2 * offs + 1, mask=m, other=0.0)
        wr = wr - (hr * vr - hi * vi)
        wi = wi - (hr * vi + hi * vr)
        tl.store(w_ptr + 2 * offs, wr, mask=m)
        tl.store(w_ptr + 2 * offs + 1, wi, mask=m)
        if LAST:
            tl.store(partout_ptr + pid, tl.sum(wr * wr + wi * wi, axis=0))
            tl.store(partout_ptr + nparts + pid, 0.0)
        else:
            nr = tl.load(vnext_ptr + 2 * offs, mask=m, other=0.0)
            ni = tl.load(vnext_ptr + 2 * offs + 1, mask=m, other=0.0)
            tl.store(partout_ptr + pid, tl.sum(nr * wr + ni * wi, axis=0))
            tl.store(partout_ptr + nparts + pid,
                     tl.sum(nr * wi - ni * wr, axis=0))
        if pid == 0:
            tl.store(h_ptr + 2 * i, hr)
            tl.store(h_ptr + 2 * i + 1, hi)

    @triton.jit(do_not_specialize=['slot'])
    def _normalize_complex_kernel(w_ptr, out_ptr, partin_ptr, h_ptr,
                                  guard_ptr, slot, n, nparts,
                                  BLOCK: tl.constexpr, NPART: tl.constexpr):
        pid = tl.program_id(0)
        k = tl.arange(0, NPART)
        nrm = tl.sqrt(tl.sum(tl.load(partin_ptr + k, mask=k < nparts,
                                     other=0.0), axis=0))
        guard = tl.load(guard_ptr)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        wr = tl.load(w_ptr + 2 * offs, mask=m, other=0.0)
        wi = tl.load(w_ptr + 2 * offs + 1, mask=m, other=0.0)
        keep = nrm > guard
        tl.store(out_ptr + 2 * offs, tl.where(keep, wr / nrm, wr), mask=m)
        tl.store(out_ptr + 2 * offs + 1, tl.where(keep, wi / nrm, wi),
                 mask=m)
        if pid == 0:
            tl.store(h_ptr + 2 * slot, nrm)
            tl.store(h_ptr + 2 * slot + 1, 0.0)

    @triton.jit
    def _combine_complex_kernel(x_ptr, b_ptr, y_ptr, nvec, n,
                                BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        accr = tl.zeros((BLOCK,), dtype=tl.float64)
        acci = tl.zeros((BLOCK,), dtype=tl.float64)
        for kk in range(0, nvec):
            row = b_ptr + kk.to(tl.int64) * (2 * n)
            yr = tl.load(y_ptr + 2 * kk)
            yi = tl.load(y_ptr + 2 * kk + 1)
            br = tl.load(row + 2 * offs, mask=m, other=0.0)
            bi = tl.load(row + 2 * offs + 1, mask=m, other=0.0)
            accr += yr * br - yi * bi
            acci += yr * bi + yi * br
        xr = tl.load(x_ptr + 2 * offs, mask=m, other=0.0)
        xi = tl.load(x_ptr + 2 * offs + 1, mask=m, other=0.0)
        tl.store(x_ptr + 2 * offs, xr + accr, mask=m)
        tl.store(x_ptr + 2 * offs + 1, xi + acci, mask=m)

    return ((_dot_kernel, _mgs_kernel, _normalize_kernel, _combine_kernel),
            (_dot_complex_kernel, _mgs_complex_kernel,
             _normalize_complex_kernel, _combine_complex_kernel))


def _kernelsAndGrid(n, isComplex=False):
    global _kernels
    import triton
    if _kernels is None:
        _kernels = _build()
    nparts = triton.cdiv(n, BLOCK)
    return _kernels[int(isComplex)], nparts, triton.next_power_of_2(nparts)


def launch_step(V, w, h, j, guard, parts):
    """Step j >= 0 (MGS of w against V[0..j], then V[j+1]), or the start
    of a cycle for j = -1 (V[0] = w / ||w||), on the current stream;
    ``parts`` is float64 scratch [2, nparts] (complex128 V, w and h:
    [2, 2 nparts]), nparts = cdiv(n, BLOCK).  Returns the number of
    launches."""
    if w.is_complex():
        return _launch_step_complex(V, w, h, j, guard, parts)
    n = w.shape[0]
    (dot_k, mgs_k, norm_k, _), nparts, NPART = _kernelsAndGrid(n)
    grid = (nparts,)
    dot_k[grid](w if j < 0 else V[0], w, parts[0], n, BLOCK=BLOCK)
    for i in range(j + 1):
        last = i == j
        mgs_k[grid](w, V[i], w if last else V[i + 1], parts[i % 2],
                    parts[(i + 1) % 2], h, i, n, nparts, LAST=last,
                    BLOCK=BLOCK, NPART=NPART)
    norm_k[grid](w, V[j + 1], parts[(j + 1) % 2], h, guard, j + 1, n, nparts,
                 BLOCK=BLOCK, NPART=NPART)
    return j + 3 if j >= 0 else 2


def _launch_step_complex(V, w, h, j, guard, parts):
    """:func:`launch_step` of the complex variant, on the float64 views."""
    import torch
    n = w.shape[0]
    (dot_k, mgs_k, norm_k, _), nparts, NPART = _kernelsAndGrid(n, True)
    grid = (nparts,)
    V, w, h = (torch.view_as_real(t) for t in (V, w, h))
    dot_k[grid](w if j < 0 else V[0], w, parts[0], n, nparts, BLOCK=BLOCK)
    for i in range(j + 1):
        last = i == j
        mgs_k[grid](w, V[i], w if last else V[i + 1], parts[i % 2],
                    parts[(i + 1) % 2], h, i, n, nparts, LAST=last,
                    BLOCK=BLOCK, NPART=NPART)
    norm_k[grid](w, V[j + 1], parts[(j + 1) % 2], h, guard, j + 1, n, nparts,
                 BLOCK=BLOCK, NPART=NPART)
    return j + 3 if j >= 0 else 2


def launch_combine(x, B, y):
    """x += sum_k y[k] B[k] over the len(y) rows of B (the complex variant
    for complex128 x, B and y); returns 1."""
    import torch
    n = x.shape[0]
    (_, _, _, comb_k), nparts, _ = _kernelsAndGrid(n, x.is_complex())
    if x.is_complex():
        x, B, y = (torch.view_as_real(t) for t in (x, B, y))
    comb_k[(nparts,)](x, B, y, y.shape[0], n, BLOCK=BLOCK)
    return 1

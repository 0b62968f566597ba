"""K4 pcg_update: the fused vector pass of one PCG iteration (Triton).

Replaces the vector work of pynucleus_tpu/base/solvers.py:_cg_core's loop
body (the matvec ``A @ p`` stays the operator's own: ``torch.mv``, as the
JAX package leaves ``A.data @ x`` to XLA, or kernel K8).  Two forms.

Jacobi (M = diag(invD)), one iteration after ``Ap = A p``:

  1. pAp partial sums over blocks                      (_pap_kernel)
  2. alpha = rz_old / pAp;  x += alpha p;  r -= alpha Ap;  z = invD r;
     partial sums of r.z and r.r                       (_update_kernel)
  3. beta = r.z;  p = z + (beta / rz_old) p;  the convergence value
     sqrt(r.z) (or sqrt(r.r)) and the residual history  (_direction_kernel)

General (any M, ``_cg_core`` with use_prec, lines 302-305 and 324-328),
two passes around the preconditioner's ``z = M r``:

  1. pAp partial sums                                  (_pap_kernel)
  2. alpha = rz_old / pAp;  x += alpha p;  r -= alpha Ap;
     partial sums of r.r                                (_step_kernel)
     -- z = M r (the caller's operator, e.g. a multigrid V-cycle) --
  3. partial sums of r.z                                (_rz_kernel)
  4. as 3. of the Jacobi form                           (_direction_kernel)

The kernels take float64 or float32 vectors (Triton compiles an instance
per pointer type): on float32 vectors (the float32 dense path) every
value, every block sum and every sum of the partial sums is a float32, as
_cg_core's jnp.vdot of float32 vectors accumulates in float32.

Every program reduces the same partial sums in the same order, so all
programs see identical scalars; the scalars stay on the device (``scal``:
r.z of the two latest iterations in slots k%2 / (k+1)%2, the convergence
value in slot 2), and the host reads one of them per iteration.  Bound on
the card: memory (about 12 float64 vector reads and writes per iteration,
no tensor-core work) plus three or four launches.

``triton`` is imported inside :func:`launch`, so that this module imports
on machines without it.
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
    def _pap_kernel(p_ptr, ap_ptr, part_ptr, n, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        p = tl.load(p_ptr + offs, mask=m, other=0.0)
        ap = tl.load(ap_ptr + offs, mask=m, other=0.0)
        tl.store(part_ptr + pid, tl.sum(p * ap, axis=0))

    @triton.jit(do_not_specialize=['old'])
    def _update_kernel(x_ptr, r_ptr, z_ptr, p_ptr, ap_ptr, invd_ptr,
                       pap_part_ptr, scal_ptr, rz_part_ptr, rr_part_ptr,
                       n, nparts, old, BLOCK: tl.constexpr,
                       NPART: tl.constexpr):
        pid = tl.program_id(0)
        k = tl.arange(0, NPART)
        pAp = tl.sum(tl.load(pap_part_ptr + k, mask=k < nparts, other=0.0),
                     axis=0)
        alpha = tl.load(scal_ptr + old) / pAp
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        x = tl.load(x_ptr + offs, mask=m, other=0.0)
        r = tl.load(r_ptr + offs, mask=m, other=0.0)
        p = tl.load(p_ptr + offs, mask=m, other=0.0)
        ap = tl.load(ap_ptr + offs, mask=m, other=0.0)
        invd = tl.load(invd_ptr + offs, mask=m, other=0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = invd * r
        tl.store(x_ptr + offs, x, mask=m)
        tl.store(r_ptr + offs, r, mask=m)
        tl.store(z_ptr + offs, z, mask=m)
        tl.store(rz_part_ptr + pid, tl.sum(r * z, axis=0))
        tl.store(rr_part_ptr + pid, tl.sum(r * r, axis=0))

    @triton.jit(do_not_specialize=['old', 'it'])
    def _direction_kernel(z_ptr, p_ptr, rz_part_ptr, rr_part_ptr, scal_ptr,
                          hist_ptr, n, nparts, old, it,
                          USE2NORM: tl.constexpr, BLOCK: tl.constexpr,
                          NPART: tl.constexpr):
        pid = tl.program_id(0)
        k = tl.arange(0, NPART)
        beta = tl.sum(tl.load(rz_part_ptr + k, mask=k < nparts, other=0.0),
                      axis=0)
        fac = beta / tl.load(scal_ptr + old)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        z = tl.load(z_ptr + offs, mask=m, other=0.0)
        p = tl.load(p_ptr + offs, mask=m, other=0.0)
        tl.store(p_ptr + offs, z + fac * p, mask=m)
        if pid == 0:
            rr = tl.sum(tl.load(rr_part_ptr + k, mask=k < nparts, other=0.0),
                        axis=0)
            if USE2NORM:
                conv = tl.sqrt(rr)
            else:
                conv = tl.sqrt(beta)
            tl.store(scal_ptr + 1 - old, beta)
            tl.store(scal_ptr + 2, conv)
            tl.store(hist_ptr + it + 1, conv)

    @triton.jit(do_not_specialize=['old'])
    def _step_kernel(x_ptr, r_ptr, p_ptr, ap_ptr, pap_part_ptr, scal_ptr,
                     rr_part_ptr, n, nparts, old, BLOCK: tl.constexpr,
                     NPART: tl.constexpr):
        pid = tl.program_id(0)
        k = tl.arange(0, NPART)
        pAp = tl.sum(tl.load(pap_part_ptr + k, mask=k < nparts, other=0.0),
                     axis=0)
        alpha = tl.load(scal_ptr + old) / pAp
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        x = tl.load(x_ptr + offs, mask=m, other=0.0)
        r = tl.load(r_ptr + offs, mask=m, other=0.0)
        p = tl.load(p_ptr + offs, mask=m, other=0.0)
        ap = tl.load(ap_ptr + offs, mask=m, other=0.0)
        x = x + alpha * p
        r = r - alpha * ap
        tl.store(x_ptr + offs, x, mask=m)
        tl.store(r_ptr + offs, r, mask=m)
        tl.store(rr_part_ptr + pid, tl.sum(r * r, axis=0))

    @triton.jit
    def _rz_kernel(r_ptr, z_ptr, rz_part_ptr, n, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        r = tl.load(r_ptr + offs, mask=m, other=0.0)
        z = tl.load(z_ptr + offs, mask=m, other=0.0)
        tl.store(rz_part_ptr + pid, tl.sum(r * z, axis=0))

    return (_pap_kernel, _update_kernel, _direction_kernel, _step_kernel,
            _rz_kernel)


def _kernelsAndGrid(n):
    global _kernels
    import triton
    if _kernels is None:
        _kernels = _build()
    nparts = triton.cdiv(n, BLOCK)
    return _kernels, nparts, triton.next_power_of_2(nparts)


def launch(x, r, z, p, Ap, invD, scal, hist, it, use2norm, parts):
    """Launch the three kernels of iteration ``it`` on the current stream
    and return how many were launched.  ``parts`` is scratch of x's type
    [3, nparts], nparts = cdiv(n, BLOCK)."""
    n = x.shape[0]
    (pap_k, upd_k, dir_k, _, _), nparts, NPART = _kernelsAndGrid(n)
    old = it % 2
    grid = (nparts,)
    pap_k[grid](p, Ap, parts[0], n, BLOCK=BLOCK)
    upd_k[grid](x, r, z, p, Ap, invD, parts[0], scal, parts[1], parts[2],
                n, nparts, old, BLOCK=BLOCK, NPART=NPART)
    dir_k[grid](z, p, parts[1], parts[2], scal, hist, n, nparts, old, it,
                USE2NORM=bool(use2norm), BLOCK=BLOCK, NPART=NPART)
    return 3


def launch_step(x, r, p, Ap, scal, it, parts):
    """General form, before ``z = M r``: passes 1 and 2 of iteration
    ``it`` on the current stream (``parts`` as for :func:`launch`);
    returns the number of launches."""
    n = x.shape[0]
    (pap_k, _, _, step_k, _), nparts, NPART = _kernelsAndGrid(n)
    grid = (nparts,)
    pap_k[grid](p, Ap, parts[0], n, BLOCK=BLOCK)
    step_k[grid](x, r, p, Ap, parts[0], scal, parts[2], n, nparts, it % 2,
                 BLOCK=BLOCK, NPART=NPART)
    return 2


def launch_direction(r, z, p, scal, hist, it, use2norm, parts):
    """General form, after ``z = M r``: passes 3 and 4 of iteration
    ``it`` (reads the r.r partials that :func:`launch_step` left in
    ``parts[2]``); returns the number of launches."""
    n = r.shape[0]
    (_, _, dir_k, _, rz_k), nparts, NPART = _kernelsAndGrid(n)
    grid = (nparts,)
    rz_k[grid](r, z, parts[1], n, BLOCK=BLOCK)
    dir_k[grid](z, p, parts[1], parts[2], scal, hist, n, nparts, it % 2, it,
                USE2NORM=bool(use2norm), BLOCK=BLOCK, NPART=NPART)
    return 2

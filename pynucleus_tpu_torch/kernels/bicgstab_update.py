"""K18 bicgstab_update: the vector passes of one BiCGStab iteration (Triton).

Replaces the vector work of pynucleus_tpu/base/solvers.py:503
_bicgstab_core's loop body (lines 517-531); the two applies ``v = A ph``,
``t = A sh`` and the preconditioner's ``ph = M p``, ``sh = M s`` stay the
operators' own.  Modes of the wrapper, in the order of an iteration,
two launches each:

  direction  partial sums of r0.r and r.r              (_dots_kernel)
             rho_new = r0.r;  ||r||;  beta = (rho_new / rho)(alpha /
             omega);  p = r + beta (p - omega v)        (_direction_kernel)
     -- ph = M p;  v = A ph --
  step       partial sums of r0.v                      (_dots_kernel)
             alpha = rho_new / r0.v;  s = r - alpha v  (_alpha_kernel)
     -- sh = M s;  t = A sh --
  update     partial sums of t.s and t.t               (_dots_kernel)
             omega = t.s / t.t;  x += alpha ph + omega sh;  r = s - omega t
                                                       (_update_kernel)

The scalars stay on the device in ``scal`` [5]: rho of the latest two
iterations (slots it%2 and (it+1)%2, as K4's), alpha, omega and ||r||; the
host reads ||r|| once per iteration, after ``direction``.  Every program
reduces the same partial sums in the same order, so all see identical
scalars, and no launch overwrites partials or a scalar that one of its own
programs reads.  Bound on the card: memory (about 20 float64 vector reads
and writes per iteration, no tensor-core work) plus six launches.

The complex variant (complex128 vectors and scalars: the complex branch of
_bicgstab_core, whose jnp.vdot conjugates its first argument) is a second
set of the same four kernels.  Triton has no complex type: they read the
float64 views [n, 2] (re at 2 i, im at 2 i + 1), ``scal`` is complex128
[5] read as its float64 view [10] (the same five slots, re and im; ||r||
real), and a conjugated dot a^H b is two real partial sums per program,
of Re and of Im, kept in the two halves of a row of partials [5,
2 nparts] and reduced in the same order by every program.  The complex
products are written out, and the divisions by hand as c10::complex
divides (Smith's scaling), so the kernel's scalars are those of its plain
version's operations.

``triton`` is imported inside :func:`launch`, so that this module imports
on machines without it.
"""
from __future__ import annotations

BLOCK = 1024
# rows of the partial sums: r0.r, r.r, r0.v, t.s, t.t
R0R, RR, R0V, TS, TT = range(5)
_kernels = None


def _build():
    # Triton resolves names in a kernel through the module's globals, so
    # triton and tl, and the complex variant's helper functions, are bound
    # there -- at the first launch, not at import
    global triton, tl, _cdiv, _cdot_parts
    import triton
    import triton.language as tl

    @triton.jit
    def _dots_kernel(a_ptr, b_ptr, c_ptr, d_ptr, pab_ptr, pcd_ptr, n,
                     TWO: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        a = tl.load(a_ptr + offs, mask=m, other=0.0)
        b = tl.load(b_ptr + offs, mask=m, other=0.0)
        tl.store(pab_ptr + pid, tl.sum(a * b, axis=0))
        if TWO:
            c = tl.load(c_ptr + offs, mask=m, other=0.0)
            d = tl.load(d_ptr + offs, mask=m, other=0.0)
            tl.store(pcd_ptr + pid, tl.sum(c * d, axis=0))

    @triton.jit(do_not_specialize=['old'])
    def _direction_kernel(r_ptr, p_ptr, v_ptr, scal_ptr, pr0r_ptr, prr_ptr,
                          old, n, nparts, BLOCK: tl.constexpr,
                          NPART: tl.constexpr):
        pid = tl.program_id(0)
        k = tl.arange(0, NPART)
        rho_new = tl.sum(tl.load(pr0r_ptr + k, mask=k < nparts, other=0.0),
                         axis=0)
        omega = tl.load(scal_ptr + 3)
        beta = (rho_new / tl.load(scal_ptr + old)) \
            * (tl.load(scal_ptr + 2) / omega)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        r = tl.load(r_ptr + offs, mask=m, other=0.0)
        p = tl.load(p_ptr + offs, mask=m, other=0.0)
        v = tl.load(v_ptr + offs, mask=m, other=0.0)
        tl.store(p_ptr + offs, r + beta * (p - omega * v), mask=m)
        if pid == 0:
            rr = tl.sum(tl.load(prr_ptr + k, mask=k < nparts, other=0.0),
                        axis=0)
            tl.store(scal_ptr + 1 - old, rho_new)
            tl.store(scal_ptr + 4, tl.sqrt(rr))

    @triton.jit(do_not_specialize=['new'])
    def _alpha_kernel(r_ptr, v_ptr, s_ptr, scal_ptr, pr0v_ptr, new, n,
                      nparts, BLOCK: tl.constexpr, NPART: tl.constexpr):
        pid = tl.program_id(0)
        k = tl.arange(0, NPART)
        alpha = tl.load(scal_ptr + new) / tl.sum(
            tl.load(pr0v_ptr + k, mask=k < nparts, other=0.0), axis=0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        r = tl.load(r_ptr + offs, mask=m, other=0.0)
        v = tl.load(v_ptr + offs, mask=m, other=0.0)
        tl.store(s_ptr + offs, r - alpha * v, mask=m)
        if pid == 0:
            tl.store(scal_ptr + 2, alpha)

    @triton.jit
    def _update_kernel(x_ptr, r_ptr, s_ptr, t_ptr, ph_ptr, sh_ptr, scal_ptr,
                       pts_ptr, ptt_ptr, n, nparts, BLOCK: tl.constexpr,
                       NPART: tl.constexpr):
        pid = tl.program_id(0)
        k = tl.arange(0, NPART)
        ts = tl.sum(tl.load(pts_ptr + k, mask=k < nparts, other=0.0), axis=0)
        tt = tl.sum(tl.load(ptt_ptr + k, mask=k < nparts, other=0.0), axis=0)
        omega = ts / tt
        alpha = tl.load(scal_ptr + 2)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        x = tl.load(x_ptr + offs, mask=m, other=0.0)
        ph = tl.load(ph_ptr + offs, mask=m, other=0.0)
        sh = tl.load(sh_ptr + offs, mask=m, other=0.0)
        s = tl.load(s_ptr + offs, mask=m, other=0.0)
        t = tl.load(t_ptr + offs, mask=m, other=0.0)
        tl.store(x_ptr + offs, x + alpha * ph + omega * sh, mask=m)
        tl.store(r_ptr + offs, s - omega * t, mask=m)
        if pid == 0:
            tl.store(scal_ptr + 3, omega)

    # ---- the complex variant: float64 views, re at 2 i, im at 2 i + 1; a
    # row of partials holds the Re sums in [0, nparts), the Im sums in
    # [nparts, 2 nparts); scal's complex slot k at 2 k (re) and 2 k + 1 (im)

    @triton.jit
    def _cdiv(ar, ai, br, bi):
        # (ar + i ai) / (br + i bi), as c10::complex operator/ divides
        big = tl.abs(br) >= tl.abs(bi)
        rat = tl.where(big, bi / br, br / bi)
        scl = tl.where(big, 1.0 / (br + bi * rat), 1.0 / (bi + br * rat))
        re = tl.where(big, (ar + ai * rat) * scl, (ar * rat + ai) * scl)
        im = tl.where(big, (ai - ar * rat) * scl, (ai * rat - ar) * scl)
        return re, im

    @triton.jit
    def _cdot_parts(a_ptr, b_ptr, part_ptr, offs, m, pid, nparts):
        # the partial sums of a^H b over one block
        ar = tl.load(a_ptr + 2 * offs, mask=m, other=0.0)
        ai = tl.load(a_ptr + 2 * offs + 1, mask=m, other=0.0)
        br = tl.load(b_ptr + 2 * offs, mask=m, other=0.0)
        bi = tl.load(b_ptr + 2 * offs + 1, mask=m, other=0.0)
        tl.store(part_ptr + pid, tl.sum(ar * br + ai * bi, axis=0))
        tl.store(part_ptr + nparts + pid, tl.sum(ar * bi - ai * br, axis=0))

    @triton.jit
    def _dots_complex_kernel(a_ptr, b_ptr, c_ptr, d_ptr, pab_ptr, pcd_ptr, n,
                             nparts, TWO: tl.constexpr, BLOCK: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        _cdot_parts(a_ptr, b_ptr, pab_ptr, offs, m, pid, nparts)
        if TWO:
            _cdot_parts(c_ptr, d_ptr, pcd_ptr, offs, m, pid, nparts)

    @triton.jit(do_not_specialize=['old'])
    def _direction_complex_kernel(r_ptr, p_ptr, v_ptr, scal_ptr, pr0r_ptr,
                                  prr_ptr, old, n, nparts,
                                  BLOCK: tl.constexpr, NPART: tl.constexpr):
        pid = tl.program_id(0)
        k = tl.arange(0, NPART)
        km = k < nparts
        rnr = tl.sum(tl.load(pr0r_ptr + k, mask=km, other=0.0), axis=0)
        rni = tl.sum(tl.load(pr0r_ptr + nparts + k, mask=km, other=0.0),
                     axis=0)
        omr = tl.load(scal_ptr + 6)
        omi = tl.load(scal_ptr + 7)
        q1r, q1i = _cdiv(rnr, rni, tl.load(scal_ptr + 2 * old),
                         tl.load(scal_ptr + 2 * old + 1))
        q2r, q2i = _cdiv(tl.load(scal_ptr + 4), tl.load(scal_ptr + 5), omr,
                         omi)
        betar = q1r * q2r - q1i * q2i
        betai = q1r * q2i + q1i * q2r
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        rr = tl.load(r_ptr + 2 * offs, mask=m, other=0.0)
        ri = tl.load(r_ptr + 2 * offs + 1, mask=m, other=0.0)
        pr = tl.load(p_ptr + 2 * offs, mask=m, other=0.0)
        pi = tl.load(p_ptr + 2 * offs + 1, mask=m, other=0.0)
        vr = tl.load(v_ptr + 2 * offs, mask=m, other=0.0)
        vi = tl.load(v_ptr + 2 * offs + 1, mask=m, other=0.0)
        dr = pr - (omr * vr - omi * vi)
        di = pi - (omr * vi + omi * vr)
        tl.store(p_ptr + 2 * offs, rr + (betar * dr - betai * di), mask=m)
        tl.store(p_ptr + 2 * offs + 1, ri + (betar * di + betai * dr),
                 mask=m)
        if pid == 0:
            nrm = tl.sum(tl.load(prr_ptr + k, mask=km, other=0.0), axis=0)
            tl.store(scal_ptr + 2 - 2 * old, rnr)
            tl.store(scal_ptr + 3 - 2 * old, rni)
            tl.store(scal_ptr + 8, tl.sqrt(nrm))
            tl.store(scal_ptr + 9, 0.0)

    @triton.jit(do_not_specialize=['new'])
    def _alpha_complex_kernel(r_ptr, v_ptr, s_ptr, scal_ptr, pr0v_ptr, new, n,
                              nparts, BLOCK: tl.constexpr,
                              NPART: tl.constexpr):
        pid = tl.program_id(0)
        k = tl.arange(0, NPART)
        km = k < nparts
        alr, ali = _cdiv(
            tl.load(scal_ptr + 2 * new), tl.load(scal_ptr + 2 * new + 1),
            tl.sum(tl.load(pr0v_ptr + k, mask=km, other=0.0), axis=0),
            tl.sum(tl.load(pr0v_ptr + nparts + k, mask=km, other=0.0),
                   axis=0))
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        rr = tl.load(r_ptr + 2 * offs, mask=m, other=0.0)
        ri = tl.load(r_ptr + 2 * offs + 1, mask=m, other=0.0)
        vr = tl.load(v_ptr + 2 * offs, mask=m, other=0.0)
        vi = tl.load(v_ptr + 2 * offs + 1, mask=m, other=0.0)
        tl.store(s_ptr + 2 * offs, rr - (alr * vr - ali * vi), mask=m)
        tl.store(s_ptr + 2 * offs + 1, ri - (alr * vi + ali * vr), mask=m)
        if pid == 0:
            tl.store(scal_ptr + 4, alr)
            tl.store(scal_ptr + 5, ali)

    @triton.jit
    def _update_complex_kernel(x_ptr, r_ptr, s_ptr, t_ptr, ph_ptr, sh_ptr,
                               scal_ptr, pts_ptr, ptt_ptr, n, nparts,
                               BLOCK: tl.constexpr, NPART: tl.constexpr):
        pid = tl.program_id(0)
        k = tl.arange(0, NPART)
        km = k < nparts
        omr, omi = _cdiv(
            tl.sum(tl.load(pts_ptr + k, mask=km, other=0.0), axis=0),
            tl.sum(tl.load(pts_ptr + nparts + k, mask=km, other=0.0), axis=0),
            tl.sum(tl.load(ptt_ptr + k, mask=km, other=0.0), axis=0),
            tl.sum(tl.load(ptt_ptr + nparts + k, mask=km, other=0.0), axis=0))
        alr = tl.load(scal_ptr + 4)
        ali = tl.load(scal_ptr + 5)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        m = offs < n
        xr = tl.load(x_ptr + 2 * offs, mask=m, other=0.0)
        xi = tl.load(x_ptr + 2 * offs + 1, mask=m, other=0.0)
        phr = tl.load(ph_ptr + 2 * offs, mask=m, other=0.0)
        phi = tl.load(ph_ptr + 2 * offs + 1, mask=m, other=0.0)
        shr = tl.load(sh_ptr + 2 * offs, mask=m, other=0.0)
        shi = tl.load(sh_ptr + 2 * offs + 1, mask=m, other=0.0)
        sr = tl.load(s_ptr + 2 * offs, mask=m, other=0.0)
        si = tl.load(s_ptr + 2 * offs + 1, mask=m, other=0.0)
        tr = tl.load(t_ptr + 2 * offs, mask=m, other=0.0)
        ti = tl.load(t_ptr + 2 * offs + 1, mask=m, other=0.0)
        xr = xr + (alr * phr - ali * phi)
        xi = xi + (alr * phi + ali * phr)
        tl.store(x_ptr + 2 * offs, xr + (omr * shr - omi * shi), mask=m)
        tl.store(x_ptr + 2 * offs + 1, xi + (omr * shi + omi * shr), mask=m)
        tl.store(r_ptr + 2 * offs, sr - (omr * tr - omi * ti), mask=m)
        tl.store(r_ptr + 2 * offs + 1, si - (omr * ti + omi * tr), mask=m)
        if pid == 0:
            tl.store(scal_ptr + 6, omr)
            tl.store(scal_ptr + 7, omi)

    return ((_dots_kernel, _direction_kernel, _alpha_kernel, _update_kernel),
            (_dots_complex_kernel, _direction_complex_kernel,
             _alpha_complex_kernel, _update_complex_kernel))


def launch(mode, x, r, r0, p, v, s, t, ph, sh, scal, parts, it):
    """Launch the two kernels of ``mode`` ('direction', 'step', 'update')
    of iteration ``it`` on the current stream; ``parts`` is float64
    scratch [5, nparts] (complex128 vectors and scal, the complex variant:
    [5, 2 nparts]), nparts = cdiv(n, BLOCK).  Returns the number of
    launches."""
    global _kernels
    import triton
    if _kernels is None:
        _kernels = _build()
    cplx = x.is_complex()
    dots_k, dir_k, alpha_k, upd_k = _kernels[int(cplx)]
    n = x.shape[0]
    if cplx:
        import torch
        x, r, r0, p, v, s, t, ph, sh, scal = (
            torch.view_as_real(q) for q in (x, r, r0, p, v, s, t, ph, sh,
                                            scal))
    nparts = triton.cdiv(n, BLOCK)
    NPART = triton.next_power_of_2(nparts)
    grid = (nparts,)
    # the complex dots kernel takes nparts (the offset of its Im sums)
    np_ = (nparts,) if cplx else ()
    if mode == 'direction':
        dots_k[grid](r0, r, r, r, parts[R0R], parts[RR], n, *np_, TWO=True,
                     BLOCK=BLOCK)
        dir_k[grid](r, p, v, scal, parts[R0R], parts[RR], it % 2, n, nparts,
                    BLOCK=BLOCK, NPART=NPART)
        return 2
    if mode == 'step':
        dots_k[grid](r0, v, r0, v, parts[R0V], parts[R0V], n, *np_,
                     TWO=False, BLOCK=BLOCK)
        alpha_k[grid](r, v, s, scal, parts[R0V], 1 - it % 2, n, nparts,
                      BLOCK=BLOCK, NPART=NPART)
        return 2
    dots_k[grid](t, s, t, t, parts[TS], parts[TT], n, *np_, TWO=True,
                 BLOCK=BLOCK)
    upd_k[grid](x, r, s, t, ph, sh, scal, parts[TS], parts[TT], n, nparts,
                BLOCK=BLOCK, NPART=NPART)
    return 2

"""LU, Jacobi, (preconditioned) CG, GMRES and BiCGStab solvers on tensors;
kernels K4, K17 and K18.

Port of lu_solver, jacobi_solver, ichol_solver, ilu_solver, cg_solver,
gmres_solver, bicgstab_solver and solverFactory of
pynucleus_tpu/base/solvers.py, for
real float64 systems, for float32 ones in Jacobi and CG (the float32
dense path), and for complex128 ones in LU, GMRES (runHelmholtz)
and BiCGStab (the complex Greens operators).  The CG keeps
``_cg_core``'s semantics: x0 = 0, convergence test on sqrt(r.M.r)
(sqrt(r.r) with use2norm) against an absolute tolerance, the residual
history, and the reference's iteration convention (the loop index at the
convergence check).

Each iteration is ``Ap = A p`` (the operator's ``matvec``: ``torch.mv``
for the dense operator, kernel K8 for the H2 operator) followed by one call
of kernel K4, which does the vector work of the JAX loop body in fused
passes; the host reads the convergence value once per iteration.  With a
diagonal preconditioner that is :func:`pcg_update` (``z = invD r`` inside
the pass); with any other (a multigrid V-cycle) :func:`pcg_update_prec`,
whose two passes go around the preconditioner's ``z = M r``
(``_cg_core``'s use_prec branch).

GMRES (``_gmres_cycle``, right-preconditioned, restarted) runs each
Arnoldi step as ``z = M V[j]`` (into Z[j]), ``w = A z`` and one call of
kernel K17 :func:`gmres_arnoldi` (modified Gram-Schmidt in the JAX
package's order, the norm, V[j+1]); the host reads the Hessenberg column,
applies the complex-safe Givens rotations (the classical ones for real
data) and stops at the JAX package's test, which is equivalent to its
masking of the remaining steps.  The back substitution is on the host and
``x0 + Z y`` is K17's :func:`gmres_combine`; a complex128 system runs
K17's and the operators' complex variants.  BiCGStab (``_bicgstab_core``)
runs its vector work through kernel K18 :func:`bicgstab_update` around its
two applies and two preconditioner applies, its scalars on the device; the
host reads ||r|| once per iteration; a complex128 system runs K18's
complex variant, whose dots conjugate their first argument (jnp.vdot).
The incomplete factorizations (IChol from the port's native copy, ILU from
scipy's spilu) factor and solve on the host, as in the JAX package; as a
preconditioner each apply moves the vector to the host and back.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .linear_operators import (LinearOperator, Diagonal_LinearOperator,
                               Dense_LinearOperator, CSR_LinearOperator)

__all__ = ['solver', 'lu_solver', 'jacobi_solver', 'ichol_solver',
           'ilu_solver', 'iterative_solver',
           'krylov_solver', 'cg_solver', 'gmres_solver', 'bicgstab_solver',
           'solverFactory', 'SOLVER_TYPES', 'pcg_update', 'pcg_update_prec',
           'gmres_arnoldi', 'gmres_combine', 'bicgstab_update']


# ------------------------------------------------------------------ K4 ----

def pcg_update(x, r, z, p, Ap, invD, scal, hist, it, use2norm=False):
    """One PCG vector pass after ``Ap = A p``, in place:

        alpha = scal[it%2] / (p.Ap);  x += alpha p;  r -= alpha Ap
        z = invD r;  beta = r.z;  p = z + beta / scal[it%2] p
        scal[(it+1)%2] = beta;  scal[2] = hist[it+1] = sqrt(beta)
                                          (sqrt(r.r) with use2norm)

    All float64, or all float32 (the float32 dense path: every value and
    every dot's sums in float32, as _cg_core on float32 vectors).

    Kernel K4's Jacobi form (Triton, kernels/pcg_update.py) on CUDA
    tensors; the plain version on CPU tensors.  Replaces the vector work of
    the body of pynucleus_tpu/base/solvers.py:_cg_core."""
    _checkVectors('pcg_update', (x, r, z, p, Ap, invD), scal, hist, it)
    n = x.shape[0]
    if x.device.type == 'cpu':
        return _pcg_update_plain(x, r, z, p, Ap, invD, scal, hist, it,
                                 use2norm)
    from ..kernels import pcg_update as k4
    parts = torch.empty((3, -(-n // k4.BLOCK)), dtype=x.dtype,
                        device=x.device)
    kernels.launches['pcg_update'] += 1
    kernels.launches['pcg_update:jacobi'] += 1
    launched = k4.launch(x, r, z, p, Ap, invD, scal, hist, it, use2norm,
                         parts)
    kernels.deviceLaunches['pcg_update'] += launched
    _countFloat32(x, launched)


def _countFloat32(x, launched):
    """Counts a K4 call on float32 vectors (``pcg_update:float32``)."""
    if x.dtype == torch.float32:
        kernels.countVariant('pcg_update:float32', launched)


def _checkVectors(name, vecs, scal, hist, it):
    x = vecs[0]
    n = x.shape[0]
    if x.dtype not in (torch.float64, torch.float32):
        raise ValueError(f'{name}: float64 or float32 vectors expected')
    for t in vecs + (scal, hist):
        if t.device != x.device or t.dtype != x.dtype \
                or not t.is_contiguous():
            raise ValueError(f'{name}: contiguous tensors of one type '
                             '(float64 or float32) on one device expected')
    if any(t.shape != (n,) for t in vecs) or scal.shape != (3,) \
            or hist.shape[0] < it + 2:
        raise ValueError(f'{name}: shape mismatch')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name}: unsupported device {x.device}')


def _pcg_update_plain(x, r, z, p, Ap, invD, scal, hist, it, use2norm=False):
    """Plain PyTorch version of :func:`pcg_update` (any device)."""
    old = it % 2
    betaOld = scal[old].clone()
    alpha = betaOld / torch.dot(p, Ap)
    x.add_(alpha * p)
    r.sub_(alpha * Ap)
    torch.mul(invD, r, out=z)
    beta = torch.dot(r, z)
    conv = torch.sqrt(torch.dot(r, r)) if use2norm else torch.sqrt(beta)
    p.mul_(beta / betaOld).add_(z)
    scal[1 - old] = beta
    scal[2] = conv
    hist[it + 1] = conv


def pcg_update_prec(x, r, z, p, Ap, M, scal, hist, it, use2norm=False):
    """One PCG vector pass with a general preconditioner M (an operator
    with ``matvec(r, out=z)``), after ``Ap = A p``, in place:

        alpha = scal[it%2] / (p.Ap);  x += alpha p;  r -= alpha Ap
        z = M r  (M's own launches)
        beta = r.z;  p = z + beta / scal[it%2] p
        scal[(it+1)%2] = beta;  scal[2] = hist[it+1] = sqrt(beta)
                                          (sqrt(r.r) with use2norm)

    Kernel K4's general form (Triton, kernels/pcg_update.py: two passes
    before M, two after) on CUDA tensors; the plain version on CPU tensors.
    Float64 or float32 vectors, as :func:`pcg_update`.  Replaces the vector
    work of _cg_core's use_prec branch
    (pynucleus_tpu/base/solvers.py:324-328)."""
    _checkVectors('pcg_update_prec', (x, r, z, p, Ap), scal, hist, it)
    n = x.shape[0]
    if x.device.type == 'cpu':
        return _pcg_update_prec_plain(x, r, z, p, Ap, M, scal, hist, it,
                                      use2norm)
    from ..kernels import pcg_update as k4
    parts = torch.empty((3, -(-n // k4.BLOCK)), dtype=x.dtype,
                        device=x.device)
    kernels.launches['pcg_update'] += 1
    kernels.launches['pcg_update:general'] += 1
    launched = k4.launch_step(x, r, p, Ap, scal, it, parts)
    M.matvec(r, out=z)
    launched += k4.launch_direction(r, z, p, scal, hist, it, use2norm,
                                    parts)
    kernels.deviceLaunches['pcg_update'] += launched
    _countFloat32(x, launched)


def _pcg_update_prec_plain(x, r, z, p, Ap, M, scal, hist, it,
                           use2norm=False):
    """Plain PyTorch version of :func:`pcg_update_prec` (any device)."""
    old = it % 2
    betaOld = scal[old].clone()
    alpha = betaOld / torch.dot(p, Ap)
    x.add_(alpha * p)
    r.sub_(alpha * Ap)
    M.matvec(r, out=z)
    beta = torch.dot(r, z)
    conv = torch.sqrt(torch.dot(r, r)) if use2norm else torch.sqrt(beta)
    p.mul_(beta / betaOld).add_(z)
    scal[1 - old] = beta
    scal[2] = conv
    hist[it + 1] = conv


# ----------------------------------------------------------------- K17 ----

def gmres_arnoldi(V, w, h, j, guard):
    """One Arnoldi step of GMRES, in place, after ``w = A z``: for i = 0..j
    (modified Gram-Schmidt, in this order)

        h[i] = V[i]^H w;  w -= h[i] V[i]

    then h[j+1] = ||w|| and V[j+1] = w / h[j+1] where h[j+1] > guard, else
    w.  With j = -1 it starts a cycle: h[0] = ||w||, V[0] = w / h[0] where
    h[0] > guard, else w.  V [restart+1, n], w [n] and h [>= j+2] on one
    device, all float64 or all complex128 (the dot conjugates V[i], as
    jnp.vdot); guard a float64 tensor [1] there (0 to start a cycle,
    1e-300 for a step, as the JAX package's guards).

    Kernel K17 (Triton, kernels/gmres_arnoldi.py; its complex variant for
    complex128) on CUDA tensors, the plain version on CPU tensors.
    Replaces the vector work of one step of
    pynucleus_tpu/base/solvers.py:365 _gmres_cycle (lines 390-403)."""
    _checkBasis('gmres_arnoldi', V, w, j + 2)
    for t, k, dt in ((h, j + 2, w.dtype), (guard, 1, torch.float64)):
        if t.device != w.device or t.dtype != dt \
                or not t.is_contiguous() or t.dim() != 1 or t.shape[0] < k:
            raise ValueError(f'gmres_arnoldi: h must be a {w.dtype} and '
                             f'guard a float64 vector on {w.device}')
    if w.device.type == 'cpu':
        return _gmres_arnoldi_plain(V, w, h, j, guard)
    from ..kernels import gmres_arnoldi as k17
    # two rows of partial sums (a complex variant's: Re, then Im)
    parts = torch.empty((2, (2 if w.is_complex() else 1)
                         * -(-w.shape[0] // k17.BLOCK)),
                        dtype=torch.float64, device=w.device)
    kernels.launches['gmres_arnoldi'] += 1
    n = k17.launch_step(V, w, h, j, guard, parts)
    kernels.deviceLaunches['gmres_arnoldi'] += n
    if w.is_complex():
        kernels.countVariant('gmres_arnoldi:complex', n)


def _checkBasis(name, B, x, rows):
    n = x.shape[0]
    dtype = x.dtype if x.dtype == torch.complex128 else torch.float64
    for t in (B, x):
        if t.device != x.device or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f'{name}: contiguous tensors on one device, all '
                             'float64 or all complex128, expected')
    if x.dim() != 1 or B.dim() != 2 or B.shape[1] != n or B.shape[0] < rows:
        raise ValueError(f'{name}: shape mismatch')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name}: unsupported device {x.device}')


def _gmres_arnoldi_plain(V, w, h, j, guard):
    """Plain PyTorch version of :func:`gmres_arnoldi` (any device)."""
    for i in range(j + 1):
        hi = torch.vdot(V[i], w)
        w.sub_(hi * V[i])
        h[i] = hi
    nrm = torch.sqrt(torch.vdot(w, w).real)
    V[j + 1] = torch.where(nrm > guard, w / nrm, w)
    h[j + 1] = nrm


def gmres_combine(x, B, y):
    """x += sum_k y[k] B[k] over the len(y) first rows of B, in place
    (x0 + Z y at the end of a GMRES cycle, Z the preconditioned basis or
    V); y of x's type (float64 or complex128) on x's device.  Kernel K17's
    combine mode on CUDA tensors, the plain version on CPU tensors.
    Replaces ``Z.T @ y`` (pynucleus_tpu/base/solvers.py:450)."""
    _checkBasis('gmres_combine', B, x, y.shape[0])
    if y.device != x.device or y.dtype != x.dtype or y.dim() != 1:
        raise ValueError(f'gmres_combine: y must be {x.dtype} on {x.device}')
    if x.device.type == 'cpu':
        return _gmres_combine_plain(x, B, y)
    if y.shape[0] == 0:
        return x
    from ..kernels import gmres_arnoldi as k17
    kernels.launches['gmres_arnoldi'] += 1
    n = k17.launch_combine(x, B, y.contiguous())
    kernels.deviceLaunches['gmres_arnoldi'] += n
    if x.is_complex():
        kernels.countVariant('gmres_arnoldi:complex', n)
    return x


def _gmres_combine_plain(x, B, y):
    """Plain PyTorch version of :func:`gmres_combine` (any device)."""
    acc = torch.zeros_like(x)
    for k in range(y.shape[0]):
        acc.add_(y[k] * B[k])
    return x.add_(acc)


# ----------------------------------------------------------------- K18 ----

BICGSTAB_MODES = ('direction', 'step', 'update')


def bicgstab_update(mode, x, r, r0, p, v, s, t, ph, sh, scal, it):
    """The vector passes of BiCGStab iteration ``it``, in place
    (pynucleus_tpu/base/solvers.py:517-531), by ``mode``:

        'direction'  rho_new = r0.r;  beta = (rho_new / scal[it%2])
                     (scal[2] / scal[3]);  p = r + beta (p - scal[3] v);
                     scal[(it+1)%2] = rho_new;  scal[4] = ||r||
        'step'       (after v = A ph) alpha = scal[(it+1)%2] / r0.v;
                     s = r - alpha v;  scal[2] = alpha
        'update'     (after t = A sh) omega = t.s / t.t;
                     x += alpha ph + omega sh;  r = s - omega t;
                     scal[3] = omega

    vectors [n] on one device (ph may be p and sh s, without a
    preconditioner), all float64 or all complex128 (the complex variant:
    a.b is the conjugated a^H b of jnp.vdot and ||r|| = sqrt(r^H r), the
    divisions complex); scal [5] of their type there, starting as (1, 1, 1,
    1, 0).  Kernel K18 (Triton, kernels/bicgstab_update.py; its complex
    variant for complex128) on CUDA tensors, the plain version on CPU
    tensors.  Replaces the vector work of _bicgstab_core's loop body."""
    if mode not in BICGSTAB_MODES:
        raise ValueError(f'bicgstab_update: mode must be one of '
                         f'{BICGSTAB_MODES}')
    vecs = (x, r, r0, p, v, s, t, ph, sh)
    n = x.shape[0]
    dtype = torch.complex128 if x.is_complex() else torch.float64
    for q in vecs + (scal,):
        if q.device != x.device or q.dtype != dtype \
                or not q.is_contiguous():
            raise ValueError('bicgstab_update: contiguous tensors on one '
                             'device, all float64 or all complex128, '
                             'expected')
    if any(q.shape != (n,) for q in vecs) or scal.shape != (5,):
        raise ValueError('bicgstab_update: shape mismatch')
    if x.device.type == 'cpu':
        return _bicgstab_update_plain(mode, x, r, r0, p, v, s, t, ph, sh,
                                      scal, it)
    if x.device.type != 'cuda':
        raise ValueError(f'bicgstab_update: unsupported device {x.device}')
    from ..kernels import bicgstab_update as k18
    cplx = x.is_complex()
    if cplx:
        # the float64 views of complex128 vectors: 16-byte aligned
        for q in vecs + (scal,):
            if q.data_ptr() % 16:
                raise ValueError('bicgstab_update: a complex128 vector not '
                                 'aligned to 16 bytes')
    parts = torch.empty((5, (2 if cplx else 1) * -(-n // k18.BLOCK)),
                        dtype=torch.float64, device=x.device)
    kernels.launches['bicgstab_update'] += 1
    n = k18.launch(mode, x, r, r0, p, v, s, t, ph, sh, scal, parts, it)
    kernels.deviceLaunches['bicgstab_update'] += n
    if cplx:
        kernels.countVariant('bicgstab_update:complex', n)


def _bicgstab_update_plain(mode, x, r, r0, p, v, s, t, ph, sh, scal, it):
    """Plain PyTorch version of :func:`bicgstab_update` (any device); its
    dot products are taken where they are used, conjugated (torch.vdot)
    for complex vectors."""
    old, new = it % 2, 1 - it % 2
    dot = torch.vdot if x.is_complex() else torch.dot
    if mode == 'direction':
        rho_new = dot(r0, r)
        omega = scal[3].clone()
        beta = (rho_new / scal[old]) * (scal[2] / omega)
        p.copy_(r + beta * (p - omega * v))
        scal[new] = rho_new
        scal[4] = torch.sqrt(dot(r, r).real)
    elif mode == 'step':
        alpha = scal[new] / dot(r0, v)
        torch.sub(r, alpha * v, out=s)
        scal[2] = alpha
    elif mode == 'update':
        omega = dot(t, s) / dot(t, t)
        x.add_(scal[2] * ph).add_(omega * sh)
        torch.sub(s, omega * t, out=r)
        scal[3] = omega


# ---------------------------------------------------------------- solvers --

class solver:
    """Base solver: setup once, then solve(b) -> x."""

    def __init__(self, A=None):
        self.A = A
        self.num_rows = A.num_rows if A is not None else -1
        self.initialized = False

    def setup(self, A=None):
        if A is not None:
            self.A = A
        self.initialized = True

    def solve(self, b):
        raise NotImplementedError()


class lu_solver(solver):
    """Dense LU on the device (pynucleus_tpu/base/solvers.py:115 lu_solver):
    a library factorisation, torch.linalg.lu_factor / lu_solve, of the
    operator's dense form (``A.data`` of a dense operator, else
    ``A.toarray()``), as the JAX package's jax.scipy.linalg.lu_factor."""

    def setup(self, A=None):
        if A is not None:
            self.A = A
        data = self.A.data if isinstance(self.A, Dense_LinearOperator) else \
            torch.as_tensor(self.A.toarray(), dtype=torch.float64,
                            device=self.A.device)
        self.lu, self.piv = torch.linalg.lu_factor(data)
        self.initialized = True

    def solve(self, b):
        return torch.linalg.lu_solve(self.lu, self.piv,
                                     b.unsqueeze(1)).squeeze(1)


class jacobi_solver(solver):
    """Diagonal scaling."""

    def setup(self, A=None):
        if A is not None:
            self.A = A
        self.invD = 1.0 / self.A.diagonal
        self.initialized = True

    def solve(self, b):
        return self.invD * b

    def asPreconditioner(self):
        return Diagonal_LinearOperator(self.invD)


class _hostPrecOperator(LinearOperator):
    """A preconditioner whose apply is a host function on numpy vectors:
    the ILU and IChol triangular solves.  Those are sequential, row after
    row, and are host algorithms in both packages (the JAX package calls
    them through jax.pure_callback inside its jitted loops), so this is the
    algorithm's own host part and no fallback: the vector goes to the
    host, is solved there and comes back to its device."""

    def __init__(self, fn, n, device):
        self._fn = fn
        self.num_rows = self.num_columns = n
        self._device = device

    @property
    def device(self):
        return self._device

    def matvec(self, x, out=None):
        y = torch.as_tensor(self._fn(x.cpu().numpy()), dtype=x.dtype,
                            device=x.device)
        return y if out is None else out.copy_(y)


def _toCSRTriple(A):
    """A as a scipy CSR matrix with summed duplicates and sorted indices
    (pynucleus_tpu/base/solvers.py:190): a CSR operator's host arrays,
    else its dense form."""
    import scipy.sparse as sp
    if isinstance(A, CSR_LinearOperator):
        M = A.to_scipy().copy()
    else:
        M = sp.csr_matrix(np.asarray(A.toarray()))
    M.sum_duplicates()
    M.sort_indices()
    return M


class _hostSolver(solver):
    """A solver whose solve is a host function (``self._apply``): b goes
    to the host and x comes back to b's device."""

    def solve(self, b):
        return torch.as_tensor(self._apply(b.cpu().numpy()), dtype=b.dtype,
                               device=b.device)

    def asPreconditioner(self):
        return _hostPrecOperator(self._apply, self.num_rows, self.A.device)


class ichol_solver(_hostSolver):
    """Incomplete Cholesky IC(0) (pynucleus_tpu/base/solvers.py:204): the
    factorization and the triangular solves of the port's copy of the
    native library (base/sparse_native.py), on the host."""

    def setup(self, A=None):
        from .sparse_native import IChol
        if A is not None:
            self.A = A
        M = _toCSRTriple(self.A)
        self._fac = IChol(M.indptr, M.indices, M.data, M.shape[0])
        self._apply = self._fac.apply
        self.num_rows = M.shape[0]
        self.initialized = True

    def __str__(self):
        return 'Incomplete Cholesky'


class ilu_solver(_hostSolver):
    """Incomplete LU by scipy's SuperLU spilu with ``fill_factor`` 1, as
    the JAX package's (pynucleus_tpu/base/solvers.py:227), on the host."""

    def __init__(self, A=None):
        super().__init__(A)
        self.fill_factor = 1.0

    def setup(self, A=None):
        from scipy.sparse.linalg import spilu
        if A is not None:
            self.A = A
        M = _toCSRTriple(self.A).tocsc()
        self._ilu = spilu(M, fill_factor=self.fill_factor)
        self._apply = self._ilu.solve
        self.num_rows = M.shape[0]
        self.initialized = True

    def __str__(self):
        return 'Incomplete LU'


class iterative_solver(solver):
    def __init__(self, A=None):
        super().__init__(A)
        self.maxIter = -1
        self.tolerance = 1e-5
        self.residuals = []


class krylov_solver(iterative_solver):
    def __init__(self, A=None):
        super().__init__(A)
        self.prec = None

    def setPreconditioner(self, prec):
        self.prec = prec


class cg_solver(krylov_solver):
    """(Preconditioned) CG in b's type: float64, or float32 on the float32
    dense and H2 paths (the operator, the preconditioner's diagonal and
    every vector float32; the tolerance compared in float32, as _cg_core
    compares a float32 residual with it)."""

    def __init__(self, A=None):
        super().__init__(A)
        self.use2norm = False
        self.maxIter = 50

    def solve(self, b):
        A = self.A
        tol = self.tolerance
        if b.dtype == torch.float32:
            tol = float(np.float32(tol))
        maxiter = self.maxIter if self.maxIter > 0 else 50
        M = self.prec
        jacobi = M is None or isinstance(M, Diagonal_LinearOperator)
        if jacobi:
            invD = (M.diagonal if M is not None
                    else torch.ones_like(b)).contiguous()
        x = torch.zeros_like(b)
        r = b - A.matvec(x)
        z = invD * r if jacobi else M.matvec(r)
        p = z.clone()
        Ap = torch.empty_like(b)
        betaOld = torch.dot(r, z)
        conv = torch.sqrt(torch.dot(r, r)) if self.use2norm \
            else torch.sqrt(betaOld)
        scal = torch.stack([betaOld, torch.zeros_like(betaOld), conv])
        hist = torch.full((maxiter + 1,), float('nan'), dtype=b.dtype,
                          device=b.device)
        hist[0] = conv
        k = 0
        convCrit = float(conv)
        while convCrit > tol and k < maxiter:
            A.matvec(p, out=Ap)
            if jacobi:
                pcg_update(x, r, z, p, Ap, invD, scal, hist, k,
                           self.use2norm)
            else:
                pcg_update_prec(x, r, z, p, Ap, M, scal, hist, k,
                                self.use2norm)
            k += 1
            convCrit = float(scal[2])
        self.residuals = hist[:k + 1].tolist()
        # reference convention: the loop index at the convergence check,
        # i.e. steps-1 when converged early
        self.iterations = k - 1 if (0 < k < maxiter) else k
        return x


class gmres_solver(krylov_solver):
    """Restarted GMRES (pynucleus_tpu/base/solvers.py:454): cycles of
    ``maxIter`` Arnoldi steps (the restart length), at most ``restarts``
    of them, right-preconditioned (flexible, Z kept) by ``prec``, from
    x0 = 0 against an absolute tolerance, in b's type (float64 or
    complex128).  ``residuals`` starts with
    ||b - A x0|| and holds each step's Givens estimate; ``iterations`` is
    the number of steps, less one when converged; ``explicitResidual`` is
    ||b - A x|| at the end."""

    def __init__(self, A=None):
        super().__init__(A)
        self.restarts = 1
        self.maxIter = 20
        self.flexible = True

    def solve(self, b):
        A, M, tol = self.A, self.prec, self.tolerance
        restart = self.maxIter if self.maxIter > 0 else 20
        n, dev = b.shape[0], b.device

        def vec(*shape):
            return torch.empty(shape, dtype=b.dtype, device=dev)
        x, w, Ax, h = vec(n).zero_(), vec(n), vec(n), vec(restart + 1)
        V = vec(restart + 1, n)
        Z = vec(restart, n) if M is not None else None
        guards = torch.tensor([0.0, 1e-300], dtype=torch.float64, device=dev)
        residuals = None
        total = 0
        resnorm = 0.0
        for _ in range(max(self.restarts, 1)):
            A.matvec(x, out=Ax)
            torch.sub(b, Ax, out=w)
            gmres_arnoldi(V, w, h, -1, guards[:1])
            beta = float(h[0].real)
            if residuals is None:
                residuals = [beta]
            resnorm, k, hist = self._cycle(A, M, V, Z, w, h, guards[1:],
                                           beta, restart, tol, x)
            residuals.extend(hist)
            total += k
            if resnorm <= tol:
                break
        A.matvec(x, out=Ax)
        self.residuals = residuals
        self.explicitResidual = float(torch.linalg.norm(b - Ax))
        self.iterations = total - 1 if (resnorm <= tol and total > 0) \
            else total
        return x

    @staticmethod
    def _cycle(A, M, V, Z, w, h, guard, beta, restart, tol, x):
        """The Arnoldi steps of one cycle from V[0] (x is x0, updated in
        place); the complex-safe Givens rotations of the Hessenberg columns
        (solvers.py:406-424: G = [[c, s], [-conj(s), conj(c)]] with
        c = conj(a)/r, s = conj(b)/r, r = sqrt(|a|^2 + |b|^2), which for
        real data is the classical rotation, operation for operation) and
        the back substitution (:444-449) on the host, in float64 or
        complex128 as h.  Returns (resnorm, steps, the steps' residual
        estimates)."""
        H = np.zeros((restart + 1, restart),
                     dtype=np.complex128 if h.is_complex() else np.float64)
        cs, sn = [1.0] * restart, [0.0] * restart
        g = [0.0] * (restart + 1)
        g[0] = beta
        hist = []
        k, resnorm = 0, beta
        while resnorm > tol and k < restart:
            j = k
            z = V[j] if M is None else M.matvec(V[j], out=Z[j])
            A.matvec(z, out=w)
            gmres_arnoldi(V, w, h, j, guard)
            # Python floats for real h, complex for complex h; conjugate()
            # of a float is the float
            hc = h[:j + 2].tolist()
            for i in range(j):
                hi = cs[i] * hc[i] + sn[i] * hc[i + 1]
                hc[i + 1] = -sn[i].conjugate() * hc[i] \
                    + cs[i].conjugate() * hc[i + 1]
                hc[i] = hi
            a, b_ = hc[j], hc[j + 1]
            denom = np.sqrt((a.real * a.real + a.imag * a.imag)
                            + (b_.real * b_.real + b_.imag * b_.imag))
            c = a.conjugate() / denom if denom > 0 else 1.0
            s_ = b_.conjugate() / denom if denom > 0 else 0.0
            hc[j], hc[j + 1] = denom, 0.0
            g[j + 1] = -s_.conjugate() * g[j]
            g[j] = c * g[j]
            H[:j + 2, j] = hc
            cs[j], sn[j] = c, s_
            resnorm = abs(g[j + 1])
            hist.append(resnorm)
            k = j + 1
        if k > 0:
            from scipy.linalg import solve_triangular
            y = solve_triangular(H[:k, :k], np.asarray(g[:k], dtype=H.dtype),
                                 lower=False)
            gmres_combine(x, V if M is None else Z,
                          torch.as_tensor(y, device=x.device))
        return resnorm, k, hist


class bicgstab_solver(krylov_solver):
    """BiCGStab (pynucleus_tpu/base/solvers.py:538) from x0 = 0 against an
    absolute tolerance on ||r||, preconditioned by ``prec`` if set, in b's
    type (float64 or complex128); ``iterations`` is the JAX package's count
    (one less when it stopped early), ``residuals`` the final ||r||."""

    def __init__(self, A=None):
        super().__init__(A)
        self.maxIter = 200

    def solve(self, b):
        A, M, tol = self.A, self.prec, self.tolerance
        maxiter = self.maxIter
        x = torch.zeros_like(b)
        r, r0, s, t = (torch.empty_like(b) for _ in range(4))
        p, v = torch.zeros_like(b), torch.zeros_like(b)
        ph, sh = (p, s) if M is None else (torch.empty_like(b),
                                           torch.empty_like(b))
        A.matvec(x, out=t)
        torch.sub(b, t, out=r)
        r0.copy_(r)
        scal = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0], dtype=b.dtype,
                            device=b.device)
        vecs = (x, r, r0, p, v, s, t, ph, sh)
        k = 0
        while True:
            # the direction of iteration k (unused if the loop stops here)
            # and ||r|| of the iterate so far
            bicgstab_update('direction', *vecs, scal, k)
            resnorm = float(scal[4].real)
            if not (resnorm > tol and k < maxiter):
                break
            if M is not None:
                M.matvec(p, out=ph)
            A.matvec(ph, out=v)
            bicgstab_update('step', *vecs, scal, k)
            if M is not None:
                M.matvec(s, out=sh)
            A.matvec(sh, out=t)
            bicgstab_update('update', *vecs, scal, k)
            k += 1
        self.iterations = k - 1 if (0 < k < maxiter) else k
        self.residuals = [resnorm]
        return x


class solverFactoryClass:
    """String -> solver construction (pynucleus_tpu/base/solvers.py:557-598).
    A combined name 'cg-jacobi' or 'cg-mg' is the first solver
    preconditioned by the second; a multilevel solver ('mg', registered by
    multilevel/gmg.py) is built from the level ``hierarchy``; a name may
    have aliases ('gs' for 'gauss_seidel', registered by
    multilevel/smoothers.py)."""

    def __init__(self):
        self.classes = {}

    def register(self, name, classType, isMultilevelSolver=False,
                 aliases=()):
        """``name`` and each of ``aliases`` build ``classType``."""
        for key in (name, *aliases):
            self.classes[key] = (classType, isMultilevelSolver)

    def build(self, name, A=None, setup=False, hierarchy=None, **kwargs):
        """The solver of ``name`` for A (a multilevel one for the level
        ``hierarchy``), its constructor given ``kwargs``; set up if
        ``setup``."""
        if A is None and hierarchy is not None:
            A = hierarchy[-1]['A']
        if name in self.classes:
            classType, isML = self.classes[name]
            s = classType(hierarchy if isML and hierarchy is not None else A,
                          **kwargs)
        elif '-' in name:
            outer, inner = name.split('-', 1)
            s = self.build(outer, A=A)
            prec = self.build(inner, A=A, setup=setup, hierarchy=hierarchy,
                              **kwargs)
            if setup and not prec.initialized:
                prec.setup()
            s.setPreconditioner(prec.asPreconditioner())
        else:
            raise KeyError(name)
        if setup and not s.initialized:
            s.setup()
        return s


solverFactory = solverFactoryClass()
solverFactory.register('lu', lu_solver)
solverFactory.register('jacobi', jacobi_solver)
solverFactory.register('ichol', ichol_solver)
solverFactory.register('ilu', ilu_solver)
solverFactory.register('cg', cg_solver)
solverFactory.register('gmres', gmres_solver)
solverFactory.register('bicgstab', bicgstab_solver)

# the --solverType choices of the port's nonlocal drivers
SOLVER_TYPES = ('cg-jacobi', 'cg', 'cg-mg', 'mg', 'lu', 'gmres',
                'gmres-jacobi', 'gmres-mg', 'bicgstab', 'bicgstab-jacobi',
                'bicgstab-mg')

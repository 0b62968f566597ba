"""Jacobi and (preconditioned) CG solvers on tensors; kernel K4.

Port of jacobi_solver, cg_solver and solverFactory of
pynucleus_tpu/base/solvers.py.  The CG keeps ``_cg_core``'s semantics:
x0 = 0, convergence test on sqrt(r.M.r) (sqrt(r.r) with use2norm) against
an absolute tolerance, the residual history, and the reference's iteration
convention (the loop index at the convergence check).

Each iteration is ``Ap = A p`` (the operator's ``matvec``: ``torch.mv``
for the dense operator, kernel K8 for the H2 operator) followed by one call
of kernel K4, which does the vector work of the JAX loop body in fused
passes; the host reads the convergence value once per iteration.  With a
diagonal preconditioner that is :func:`pcg_update` (``z = invD r`` inside
the pass); with any other (a multigrid V-cycle) :func:`pcg_update_prec`,
whose two passes go around the preconditioner's ``z = M r``
(``_cg_core``'s use_prec branch).
"""
from __future__ import annotations

import torch

from .. import kernels
from .linear_operators import Diagonal_LinearOperator

__all__ = ['solver', 'jacobi_solver', 'iterative_solver', 'krylov_solver',
           'cg_solver', 'solverFactory', 'pcg_update', 'pcg_update_prec']


# ------------------------------------------------------------------ K4 ----

def pcg_update(x, r, z, p, Ap, invD, scal, hist, it, use2norm=False):
    """One PCG vector pass after ``Ap = A p``, in place:

        alpha = scal[it%2] / (p.Ap);  x += alpha p;  r -= alpha Ap
        z = invD r;  beta = r.z;  p = z + beta / scal[it%2] p
        scal[(it+1)%2] = beta;  scal[2] = hist[it+1] = sqrt(beta)
                                          (sqrt(r.r) with use2norm)

    Kernel K4's Jacobi form (Triton, kernels/pcg_update.py) on CUDA
    tensors; the plain version on CPU tensors.  Replaces the vector work of
    the body of pynucleus_tpu/base/solvers.py:_cg_core."""
    _checkVectors('pcg_update', (x, r, z, p, Ap, invD), scal, hist, it)
    n = x.shape[0]
    if x.device.type == 'cpu':
        return _pcg_update_plain(x, r, z, p, Ap, invD, scal, hist, it,
                                 use2norm)
    from ..kernels import pcg_update as k4
    parts = torch.empty((3, -(-n // k4.BLOCK)), dtype=torch.float64,
                        device=x.device)
    kernels.launches['pcg_update'] += 1
    kernels.launches['pcg_update:jacobi'] += 1
    kernels.deviceLaunches['pcg_update'] += k4.launch(
        x, r, z, p, Ap, invD, scal, hist, it, use2norm, parts)


def _checkVectors(name, vecs, scal, hist, it):
    x = vecs[0]
    n = x.shape[0]
    for t in vecs + (scal, hist):
        if t.device != x.device or t.dtype != torch.float64 \
                or not t.is_contiguous():
            raise ValueError(f'{name}: float64 contiguous tensors on one '
                             'device expected')
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
    Replaces the vector work of _cg_core's use_prec branch
    (pynucleus_tpu/base/solvers.py:324-328)."""
    _checkVectors('pcg_update_prec', (x, r, z, p, Ap), scal, hist, it)
    n = x.shape[0]
    if x.device.type == 'cpu':
        return _pcg_update_prec_plain(x, r, z, p, Ap, M, scal, hist, it,
                                      use2norm)
    from ..kernels import pcg_update as k4
    parts = torch.empty((3, -(-n // k4.BLOCK)), dtype=torch.float64,
                        device=x.device)
    kernels.launches['pcg_update'] += 1
    kernels.launches['pcg_update:general'] += 1
    kernels.deviceLaunches['pcg_update'] += k4.launch_step(
        x, r, p, Ap, scal, it, parts)
    M.matvec(r, out=z)
    kernels.deviceLaunches['pcg_update'] += k4.launch_direction(
        r, z, p, scal, hist, it, use2norm, parts)


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
    def __init__(self, A=None):
        super().__init__(A)
        self.use2norm = False
        self.maxIter = 50

    def solve(self, b):
        A = self.A
        tol = self.tolerance
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


class solverFactoryClass:
    """String -> solver construction (pynucleus_tpu/base/solvers.py:557-598).
    A combined name 'cg-jacobi' or 'cg-mg' is the first solver
    preconditioned by the second; a multilevel solver ('mg', registered by
    multilevel/gmg.py) is built from the level ``hierarchy``."""

    def __init__(self):
        self.classes = {}

    def register(self, name, classType, isMultilevelSolver=False):
        self.classes[name] = (classType, isMultilevelSolver)

    def build(self, name, A=None, setup=False, hierarchy=None):
        if A is None and hierarchy is not None:
            A = hierarchy[-1]['A']
        if name in self.classes:
            classType, isML = self.classes[name]
            s = classType(hierarchy if isML and hierarchy is not None else A)
        elif '-' in name:
            outer, inner = name.split('-', 1)
            s = self.build(outer, A=A)
            prec = self.build(inner, A=A, setup=setup, hierarchy=hierarchy)
            if setup and not prec.initialized:
                prec.setup()
            s.setPreconditioner(prec.asPreconditioner())
        else:
            raise KeyError(name)
        if setup and not s.initialized:
            s.setup()
        return s


solverFactory = solverFactoryClass()
solverFactory.register('jacobi', jacobi_solver)
solverFactory.register('cg', cg_solver)

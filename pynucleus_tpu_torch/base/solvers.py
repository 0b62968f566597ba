"""Jacobi and (preconditioned) CG solvers on tensors; kernel K4.

Port of jacobi_solver, cg_solver and solverFactory of
pynucleus_tpu/base/solvers.py.  The CG keeps ``_cg_core``'s semantics:
x0 = 0, convergence test on sqrt(r.M.r) (sqrt(r.r) with use2norm) against
an absolute tolerance, the residual history, and the reference's iteration
convention (the loop index at the convergence check).

Each iteration is ``Ap = A p`` (the operator's ``matvec``: ``torch.mv``
for the dense operator, kernel K8 for the H2 operator) followed by one call of
:func:`pcg_update`, kernel K4, which does the vector work of the JAX loop
body in one fused pass; the host reads the convergence value once per
iteration.
"""
from __future__ import annotations

import torch

from .. import kernels
from .linear_operators import Diagonal_LinearOperator

__all__ = ['solver', 'jacobi_solver', 'iterative_solver', 'krylov_solver',
           'cg_solver', 'solverFactory', 'pcg_update']


# ------------------------------------------------------------------ K4 ----

def pcg_update(x, r, z, p, Ap, invD, scal, hist, it, use2norm=False):
    """One PCG vector pass after ``Ap = A p``, in place:

        alpha = scal[it%2] / (p.Ap);  x += alpha p;  r -= alpha Ap
        z = invD r;  beta = r.z;  p = z + beta / scal[it%2] p
        scal[(it+1)%2] = beta;  scal[2] = hist[it+1] = sqrt(beta)
                                          (sqrt(r.r) with use2norm)

    Kernel K4 (Triton, kernels/pcg_update.py) on CUDA tensors; the plain
    version on CPU tensors.  Replaces the vector work of the body of
    pynucleus_tpu/base/solvers.py:_cg_core."""
    vecs = (x, r, z, p, Ap, invD)
    n = x.shape[0]
    for t in vecs + (scal, hist):
        if t.device != x.device or t.dtype != torch.float64 \
                or not t.is_contiguous():
            raise ValueError('pcg_update: float64 contiguous tensors on one '
                             'device expected')
    if any(t.shape != (n,) for t in vecs) or scal.shape != (3,) \
            or hist.shape[0] < it + 2:
        raise ValueError('pcg_update: shape mismatch')
    if x.device.type == 'cpu':
        return _pcg_update_plain(x, r, z, p, Ap, invD, scal, hist, it,
                                 use2norm)
    if x.device.type != 'cuda':
        raise ValueError(f'pcg_update: unsupported device {x.device}')
    from ..kernels import pcg_update as k4
    parts = torch.empty((3, -(-n // k4.BLOCK)), dtype=torch.float64,
                        device=x.device)
    kernels.launches['pcg_update'] += 1
    k4.launch(x, r, z, p, Ap, invD, scal, hist, it, use2norm, parts)


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
        invD = self.prec.diagonal if self.prec is not None \
            else torch.ones_like(b)
        invD = invD.contiguous()
        x = torch.zeros_like(b)
        r = b - A.matvec(x)
        z = invD * r
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
            pcg_update(x, r, z, p, Ap, invD, scal, hist, k, self.use2norm)
            k += 1
            convCrit = float(scal[2])
        self.residuals = hist[:k + 1].tolist()
        # reference convention: the loop index at the convergence check,
        # i.e. steps-1 when converged early
        self.iterations = k - 1 if (0 < k < maxiter) else k
        return x


class solverFactoryClass:
    """String -> solver construction; 'cg-jacobi' is CG preconditioned by
    the second part."""

    def __init__(self):
        self.classes = {}

    def register(self, name, classType):
        self.classes[name] = classType

    def build(self, name, A=None, setup=False):
        if name in self.classes:
            s = self.classes[name](A)
        elif '-' in name:
            outer, inner = name.split('-', 1)
            s = self.build(outer, A=A)
            prec = self.build(inner, A=A, setup=True)
            s.setPreconditioner(prec.asPreconditioner())
        else:
            raise KeyError(name)
        if setup and not s.initialized:
            s.setup()
        return s


solverFactory = solverFactoryClass()
solverFactory.register('jacobi', jacobi_solver)
solverFactory.register('cg', cg_solver)

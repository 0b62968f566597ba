"""Classical relaxation smoothers and solvers: Gauss-Seidel, SOR, SSOR.

Port of pynucleus_tpu/multilevel/smoothers.py.  The sweeps have
sequential row dependencies, so, as in the JAX package, they run on the
host by scipy's sparse triangular solves: ``solve`` takes b on its device,
sweeps on the host and returns x on b's device.  As a preconditioner a
sweep is materialised as a dense operator on the device
(:func:`_sweepOperator`, O(n^2): moderate sizes), as the JAX package does
to keep it inside its jitted Krylov loops.
"""
import numpy as np
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import spsolve_triangular

from ..base.solvers import solver, solverFactory, _toCSRTriple
from ..base.linear_operators import Dense_LinearOperator

__all__ = ['gaussSeidel_solver', 'sor_solver', 'ssor_solver']


def _sweepOperator(solverObj):
    """The sweep's action M^{-1} as a dense operator on the device of the
    solver's A: its host sweeps of the identity's columns
    (pynucleus_tpu/multilevel/smoothers.py:27)."""
    n = solverObj.num_rows
    eye = np.eye(n)
    cols = np.stack([solverObj._sweep(eye[:, j]) for j in range(n)], axis=1)
    return Dense_LinearOperator(torch.as_tensor(cols,
                                                device=solverObj.A.device))


class _sweepSolver(solver):
    """A relaxation solver: ``solve(b, x=None)`` runs ``numSweeps`` host
    sweeps from x (0 by default)."""

    def __init__(self, A=None, numSweeps=1):
        super().__init__(A)
        self.numSweeps = numSweeps

    def solve(self, b, x=None):
        x = None if x is None else x.cpu().numpy()
        return torch.as_tensor(self._sweep(b.cpu().numpy(), x),
                               device=b.device)

    def asPreconditioner(self):
        return _sweepOperator(self)


class gaussSeidel_solver(_sweepSolver):
    """Forward Gauss-Seidel sweeps: (L + D) x_{k+1} = b - U x_k
    (pynucleus_tpu/multilevel/smoothers.py:40)."""
    omega = 1.0

    def __init__(self, A=None, numSweeps=1, **kwargs):
        super().__init__(A, numSweeps)

    def setup(self, A=None):
        if A is not None:
            self.A = A
            self.num_rows = A.num_rows
        Ac = _toCSRTriple(self.A)
        om = self.omega
        D = sp.diags(Ac.diagonal())
        self.LD = (sp.tril(Ac, -1) + D / om).tocsr()
        self.U = (sp.triu(Ac, 1) + (1.0 - 1.0 / om) * D).tocsr()
        self.initialized = True

    def _sweep(self, b, x=None):
        b = np.asarray(b)
        x = np.zeros_like(b) if x is None else np.array(x, dtype=b.dtype)
        for _ in range(self.numSweeps):
            x = spsolve_triangular(self.LD, b - self.U @ x, lower=True)
        return x


class sor_solver(gaussSeidel_solver):
    """Successive over-relaxation
    (pynucleus_tpu/multilevel/smoothers.py:71)."""

    def __init__(self, A=None, omega=1.5, numSweeps=1, **kwargs):
        super().__init__(A, numSweeps=numSweeps)
        self.omega = omega


class ssor_solver(_sweepSolver):
    """Symmetric SOR: a forward then a backward sweep
    (pynucleus_tpu/multilevel/smoothers.py:79)."""

    def __init__(self, A=None, omega=1.0, numSweeps=1, **kwargs):
        super().__init__(A, numSweeps)
        self.omega = omega

    def setup(self, A=None):
        if A is not None:
            self.A = A
            self.num_rows = A.num_rows
        Ac = _toCSRTriple(self.A)
        om = self.omega
        D = sp.diags(Ac.diagonal())
        self.LD = (sp.tril(Ac, -1) + D / om).tocsr()
        self.DU = (sp.triu(Ac, 1) + D / om).tocsr()
        self.Lp = (sp.tril(Ac, -1) + (1.0 - 1.0 / om) * D).tocsr()
        self.Up = (sp.triu(Ac, 1) + (1.0 - 1.0 / om) * D).tocsr()
        self.initialized = True

    def _sweep(self, b, x=None):
        b = np.asarray(b)
        x = np.zeros_like(b) if x is None else np.array(x, dtype=b.dtype)
        for _ in range(self.numSweeps):
            x = spsolve_triangular(self.LD, b - self.Up @ x, lower=True)
            x = spsolve_triangular(self.DU, b - self.Lp @ x, lower=False)
        return x


solverFactory.register('gauss_seidel', gaussSeidel_solver, aliases=['gs'])
solverFactory.register('sor', sor_solver)
solverFactory.register('ssor', ssor_solver)

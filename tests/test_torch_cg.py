"""CG-Jacobi of the port (torch.mv + kernel K4's plain version on the CPU)
against the JAX package's _cg_core on the same operator and right-hand
side: the same iteration count and residual history to 1e-10 relative.
"""
import os
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.nl import getFractionalKernel as jKernel
from pynucleus_tpu.nl.assembly import nonlocalBuilder as jBuilder
from pynucleus_tpu.base.solvers import _cg_core, solverFactory as jFactory
from pynucleus_tpu.base.linear_operators import (
    Dense_LinearOperator as jDense, Diagonal_LinearOperator as jDiag)

from pynucleus_tpu_torch.base.solvers import (solverFactory, pcg_update,
                                              _pcg_update_plain)
from pynucleus_tpu_torch.base.linear_operators import Dense_LinearOperator

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import __graft_entry__  # noqa: E402


def _graftProblem():
    dm, kernel, b = __graft_entry__._buildProblem()
    A = np.array(jBuilder(dm, kernel).getDense().toarray())
    return A, np.array(b.data), 1e-8, 100


def _discProblem():
    m = jfem.circle(h=0.78, radius=1.0)
    for _ in range(3):
        m = m.refine()
    dm = jfem.P1_DoFMap(m)
    A = np.array(jBuilder(dm, jKernel(2, 0.75),
                            params={'denseGrid': True}).getDense().toarray())
    b = np.array(jfem.assembleRHS(dm, jfem.constant(1.0), qOrder=3).data)
    return A, b, 1e-6, 100


@pytest.mark.parametrize('problem', [_graftProblem, _discProblem],
                         ids=['graft-interval', 'disc-noRef3'])
def test_cg_jacobi_matches_cg_core(problem):
    A, b, tol, maxiter = problem()
    js = jFactory.build('cg-jacobi', A=jDense(jnp.asarray(A)), setup=True)
    js.tolerance, js.maxIter = tol, maxiter
    xj = np.asarray(js.solve(jnp.asarray(b)))
    ts = solverFactory.build('cg-jacobi', A=Dense_LinearOperator(
        torch.as_tensor(A)), setup=True)
    ts.tolerance, ts.maxIter = tol, maxiter
    xt = ts.solve(torch.as_tensor(b)).numpy()
    assert ts.iterations == js.iterations
    rj, rt = np.asarray(js.residuals), np.asarray(ts.residuals)
    assert rt.shape == rj.shape
    assert np.abs(rt - rj).max() <= 1e-10 * rj.max()
    assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max()
    # raw _cg_core (the graft entry's call): same loop count
    invD = 1.0 / np.diag(A)
    _, iters, _ = _cg_core(jDense(jnp.asarray(A)), jDiag(jnp.asarray(invD)),
                           jnp.asarray(b), jnp.zeros_like(jnp.asarray(b)),
                           tol, maxiter, use_prec=True)
    assert len(ts.residuals) == int(iters) + 1


def test_cg_unpreconditioned_and_use2norm():
    A, b, _, _ = _discProblem()
    for use2norm in (False, True):
        js = jFactory.build('cg', A=jDense(jnp.asarray(A)), setup=True)
        ts = solverFactory.build('cg', A=Dense_LinearOperator(
            torch.as_tensor(A)), setup=True)
        for s in (js, ts):
            s.tolerance, s.maxIter, s.use2norm = 1e-7, 80, use2norm
        xj = np.asarray(js.solve(jnp.asarray(b)))
        xt = ts.solve(torch.as_tensor(b)).numpy()
        assert ts.iterations == js.iterations
        assert np.allclose(ts.residuals, js.residuals, rtol=1e-10, atol=0)
        assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max()


def test_pcg_update_step_by_hand():
    """One K4 pass against the PCG update written out in numpy."""
    rng = np.random.RandomState(3)
    n = 37
    x, r, p, Ap = (rng.randn(n) for _ in range(4))
    invD = rng.uniform(0.5, 2.0, n)
    rzOld = 1.7
    alpha = rzOld / (p @ Ap)
    x1, r1 = x + alpha * p, r - alpha * Ap
    z1 = invD * r1
    beta = r1 @ z1
    p1 = z1 + beta / rzOld * p
    t = [torch.as_tensor(a.copy()) for a in (x, r, np.zeros(n), p, Ap, invD)]
    for it, use2norm in ((0, False), (3, True)):
        tt = [a.clone() for a in t]
        scal = torch.tensor([0.0, 0.0, 0.0], dtype=torch.float64)
        scal[it % 2] = rzOld
        hist = torch.zeros(it + 2, dtype=torch.float64)
        pcg_update(*tt, scal, hist, it, use2norm)
        for got, want in zip((tt[0], tt[1], tt[2], tt[3]), (x1, r1, z1, p1)):
            assert np.allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)
        conv = np.sqrt(r1 @ r1) if use2norm else np.sqrt(beta)
        assert np.isclose(float(scal[1 - it % 2]), beta, rtol=1e-13)
        assert np.isclose(float(scal[2]), conv, rtol=1e-13)
        assert np.isclose(float(hist[it + 1]), conv, rtol=1e-13)


def test_pcg_update_validates_inputs():
    v = torch.zeros(5, dtype=torch.float64)
    scal = torch.zeros(3, dtype=torch.float64)
    hist = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError, match='float64'):
        pcg_update(v, v, v, v, v.float(), v, scal, hist, 0)
    with pytest.raises(ValueError, match='shape'):
        pcg_update(v, v, v, v, torch.zeros(4, dtype=torch.float64), v, scal,
                   hist, 0)
    with pytest.raises(ValueError, match='shape'):
        pcg_update(v, v, v, v, v, v, scal, hist, 5)
    assert _pcg_update_plain is not pcg_update

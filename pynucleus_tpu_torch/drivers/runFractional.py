"""Solve the fractional Poisson problem (infinite horizon, zero exterior)
with the port: dense or H2 assembly on the device, CG-Jacobi.

    python -m pynucleus_tpu_torch.drivers.runFractional --domain disc \\
        --s 'const(0.75)' --problem constant --element P1 \\
        --solverType cg-jacobi --matrixFormat dense|H2 [--noRef N] \\
        [--maxiter K] [--device cuda|cpu]

Port of drivers/runFractional.py for the dense and H2 slices (H2 on the
disc only).  It prints the same ``results`` and ``errors`` labels as the
JAX driver, in float64, plus the wall times of assembly and solve and, for
H2, of each build part (``timers``).
"""
from __future__ import annotations

import argparse
import time

import torch

from ..config import getDevice
from ..base.solvers import solverFactory, iterative_solver
from ..base.utilsFem import outputGroup
from ..fem.dofmaps import str2DoFMap
from ..fem.assembly import assembleRHS
from ..nl.assembly import assembleNonlocal
from ..nl.discretized import ERROR_LABELS, modelErrors
from ..nl.problems import fractionalLaplacianProblem, defaultNoRef


def parser():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--domain', default='interval',
                   choices=['interval', 'disc'])
    p.add_argument('--s', default='const(0.75)')
    p.add_argument('--problem', default='constant', choices=['constant'])
    p.add_argument('--element', default='P1', choices=['P1'])
    p.add_argument('--solverType', default='cg-jacobi',
                   choices=['cg-jacobi', 'cg'])
    p.add_argument('--matrixFormat', default='dense', choices=['dense', 'H2'])
    p.add_argument('--noRef', type=int, default=-1)
    p.add_argument('--maxiter', type=int, default=100)
    p.add_argument('--tol', type=float, default=1e-6)
    p.add_argument('--device', default='cpu')
    return p


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def main(argv=None, quiet=False):
    """Run the driver; returns a dict with the output groups ('results',
    'errors', 'timers'), the solution ``u``, the operator ``A`` and the
    solver."""
    args = parser().parse_args(argv)
    dev = getDevice(args.device)
    noRef = args.noRef if args.noRef > 0 else \
        defaultNoRef(args.domain, args.element)
    prob = fractionalLaplacianProblem(args.domain, args.s, args.problem)
    mesh = prob['mesh']
    for _ in range(noRef):
        mesh = mesh.refine()
    dm = str2DoFMap[args.element](mesh, prob['tag'], device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    parts = {}
    A = assembleNonlocal(dm, prob['kernel'], matrixFormat=args.matrixFormat,
                         zeroExterior=prob['zeroExterior'], device=dev,
                         timers=parts)
    _sync(dev)
    tAssemble = time.perf_counter() - t0

    b = assembleRHS(dm, prob['rhs'], qOrder=3)
    solver = solverFactory.build(args.solverType, A=A, setup=True)
    if isinstance(solver, iterative_solver):
        solver.tolerance = args.tol
        solver.maxIter = args.maxiter
    _sync(dev)
    t0 = time.perf_counter()
    u = solver.solve(b.data)
    _sync(dev)
    tSolve = time.perf_counter() - t0
    resError = float(torch.linalg.norm(b.data - A.matvec(u)))

    results = outputGroup('results')
    results.add('kernel', repr(prob['kernel']))
    results.add('problem', prob['problemDescription'])
    results.add('h', mesh.h)
    results.add('hmin', mesh.hmin)
    results.add('dofs', dm.num_dofs)
    results.add('solver', args.solverType)
    results.add('iterations', getattr(solver, 'iterations', 1))
    errs = modelErrors(dm, u, b, prob['analyticSolution'],
                       prob['exactL2Squared'], prob['exactHsSquared'])
    errors = outputGroup('errors')
    for label in ERROR_LABELS:
        errors.add(label, errs[label])
    timers = outputGroup('timers')
    timers.add('device', str(dev))
    timers.add('assembly seconds', tAssemble)
    for part, sec in parts.items():
        timers.add(f'assembly {part} seconds', sec)
    timers.add('solve seconds', tSolve)
    timers.add('explicit residual', resError)
    if not quiet:
        for g in (results, errors, timers):
            g.log()
    return {'results': results, 'errors': errors, 'timers': timers, 'u': u,
            'A': A, 'solver': solver, 'dm': dm}


if __name__ == '__main__':
    main()

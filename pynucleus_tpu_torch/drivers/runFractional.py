"""Solve the fractional Poisson problem (infinite horizon, zero exterior)
with the port: dense or H2 assembly on the device, CG-Jacobi, CG-MG, MG,
LU, GMRES or BiCGStab.

    python -m pynucleus_tpu_torch.drivers.runFractional --domain disc \\
        --s 'const(0.75)' --problem constant --element P1 \\
        --solverType cg-jacobi|cg|cg-mg|mg|lu|gmres[-jacobi|-mg]|... \\
        --matrixFormat dense|H2 [--noRef N] [--maxiter K] [--device cuda|cpu]

Port of drivers/runFractional.py for the dense and H2 formats (the
interval and the disc), with the solvers of ``SOLVER_TYPES`` (the JAX
driver takes any registered name).  ``--s`` takes const(s), varconst(s),
constantNonSym(s) and twoDomainNonSym(sl,sr) (the latter two on the
interval); ``--problem`` constant or, on the interval, knownSolution.  It runs on the card unless ``--device cpu`` asks for the CPU;
asking for the card without one raises.  With a multigrid solver every
level noRef 0 ... N is assembled in the requested format, as in the JAX
package.  It prints the same ``results`` and ``errors`` labels as the JAX
driver, in float64, plus wall times (``timers``): the assembly of each
level and in total, the finest H2 level's build parts, the hierarchy
set-up (prolongations, their transposes, the solver's set-up with the
inverse diagonals and the coarse LU) and the solve.  ``main(params=...)``
passes builder parameters to every level's assembly, e.g.
``{'nearEngine': 'flat'}`` (see nl.assembly.nonlocalBuilder); the JAX
driver has no flag for them either.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..config import getDevice
from ..base.solvers import solverFactory, iterative_solver, SOLVER_TYPES
from ..base.utilsFem import outputGroup
from ..fem.assembly import assembleRHS
from ..nl.discretized import modelErrors, buildMeshHierarchy, buildHierarchy
from ..nl.problems import fractionalLaplacianProblem, defaultNoRef
from .. import multilevel  # noqa: F401  (registers the 'mg' solver)


def parser():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--domain', default='interval',
                   choices=['interval', 'disc'])
    p.add_argument('--s', default='const(0.75)')
    p.add_argument('--problem', default='constant',
                   choices=['constant', 'knownSolution'])
    p.add_argument('--element', default='P1', choices=['P1'])
    p.add_argument('--solverType', default='cg-jacobi', choices=SOLVER_TYPES)
    p.add_argument('--matrixFormat', default='dense', choices=['dense', 'H2'])
    p.add_argument('--noRef', type=int, default=-1)
    p.add_argument('--maxiter', type=int, default=100)
    p.add_argument('--tol', type=float, default=1e-6)
    p.add_argument('--device', default='cuda')
    return p


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def main(argv=None, quiet=False, params=None):
    """Run the driver; returns a dict with the output groups ('results',
    'errors', 'timers'), the solution ``u``, the finest operator ``A``,
    the level ``hierarchy``, the finest dofmap ``dm``, the solver and the
    build parts of every level (``levelParts``, level -> {part:
    seconds}).  ``params`` go to the builder of every level."""
    args = parser().parse_args(argv)
    dev = getDevice(args.device)
    noRef = args.noRef if args.noRef > 0 else \
        defaultNoRef(args.domain, args.element)
    prob = fractionalLaplacianProblem(args.domain, args.s, args.problem)

    _sync(dev)
    t0 = time.perf_counter()
    meshes, dms, Ps = buildMeshHierarchy(prob['mesh'], args.solverType,
                                         prob['tag'], noRef, args.element,
                                         dev)
    _sync(dev)
    tSetup = time.perf_counter() - t0
    mesh, dm = meshes[-1], dms[-1]
    parts, levelParts = {}, {}
    t0 = time.perf_counter()
    hierarchy = buildHierarchy(dms, Ps, prob['kernel'], args.solverType,
                               args.matrixFormat, prob['zeroExterior'],
                               timers=parts, params=params,
                               levelParts=levelParts)
    _sync(dev)
    levelSeconds = {k: v for k, v in parts.items() if k.startswith('level ')}
    tAssemble = sum(levelSeconds.values())
    # the transposes R = P.T, built after the levels' assembly
    tSetup += time.perf_counter() - t0 - tAssemble
    A = hierarchy[-1]['A']

    b = assembleRHS(dm, prob['rhs'], qOrder=3)
    t0 = time.perf_counter()
    solver = solverFactory.build(args.solverType, hierarchy=hierarchy,
                                 setup=True)
    if isinstance(solver, iterative_solver):
        solver.tolerance = args.tol
        solver.maxIter = args.maxiter
    _sync(dev)
    tSetup += time.perf_counter() - t0
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
    for label, val in errs.items():
        errors.add(label, val)
    timers = outputGroup('timers')
    timers.add('device', str(dev))
    timers.add('assembly seconds', tAssemble)
    for part, sec in parts.items():
        timers.add(f'assembly {part} seconds', sec)
    timers.add('hierarchy set-up seconds', tSetup)
    timers.add('solve seconds', tSolve)
    timers.add('explicit residual', resError)
    if not quiet:
        for g in (results, errors, timers):
            g.log()
    return {'results': results, 'errors': errors, 'timers': timers, 'u': u,
            'A': A, 'hierarchy': hierarchy, 'solver': solver, 'dm': dm,
            'levelParts': levelParts}


if __name__ == '__main__':
    main()

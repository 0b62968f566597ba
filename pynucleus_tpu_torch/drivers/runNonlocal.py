"""Solve a finite-horizon nonlocal Poisson problem with the port: dense,
sparse or H2 (= sparse) assembly on the device, with the Dirichlet collar.

    python -m pynucleus_tpu_torch.drivers.runNonlocal --domain square \\
        --kernelType constant --horizon 0.2 --problem poly-Dirichlet \\
        --element P1 --solverType cg-mg|lu|mg|cg-jacobi|gmres-mg|... \\
        --matrixFormat sparse [--noRef N] \\
        [--interaction ball2|ballInf] [--device cuda|cpu]

Port of drivers/runNonlocal.py (pynucleus_tpu/nl/problems.py
nonlocalPoissonProblem and nl/discretized.py discretizedNonlocalProblem)
with the flags and defaults of the JAX driver: kernelType constant,
horizon 0.2, s const(0.4), interaction ball2, noRef 8 on the interval and
2 on the square.  The interval and the square take the poly-Dirichlet and
constant problems; poly-Neumann (the Sum operator) and the disc with a
collar are not ported.  It runs on the card unless ``--device cpu`` asks
for the CPU; asking for the card without one raises.  With a multigrid
solver every level noRef 0 ... N is assembled in the requested format.  It
prints the JAX driver's ``results`` and ``errors`` labels, in float64, and
wall times (``timers``): the assembly of each level with its parts (the
sparse format: host classification, host pattern, device fill), A_BC and
the load vector, the solver's set-up and the solve.  ``main(params=...)``
passes builder parameters to every level's assembly.
"""
from __future__ import annotations

import argparse

import numpy as np

from ..config import getDevice
from ..base.solvers import SOLVER_TYPES
from ..base.utilsFem import outputGroup
from ..nl.discretized import modelErrors, solveNonlocal
from ..nl.problems import (nonlocalPoissonProblem, defaultNoRefNonlocal,
                           KERNEL_TYPES)
from .. import multilevel  # noqa: F401  (registers the 'mg' solver)


def parser():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--kernelType', default='constant', choices=KERNEL_TYPES)
    p.add_argument('--s', default='const(0.4)')
    p.add_argument('--horizon', type=float, default=0.2)
    p.add_argument('--interaction', default='ball2',
                   choices=['ball2', 'ballInf'])
    p.add_argument('--normalized', dest='normalized', action='store_true',
                   default=True)
    p.add_argument('--no-normalized', dest='normalized',
                   action='store_false')
    p.add_argument('--domain', default='interval',
                   choices=['interval', 'square'])
    p.add_argument('--problem', default='poly-Dirichlet',
                   choices=['poly-Dirichlet', 'constant'])
    p.add_argument('--element', default='P1', choices=['P1'])
    p.add_argument('--noRef', type=int, default=-1)
    p.add_argument('--solverType', default='cg-mg', choices=SOLVER_TYPES)
    p.add_argument('--maxiter', type=int, default=100)
    p.add_argument('--tol', type=float, default=1e-6)
    p.add_argument('--matrixFormat', default='H2',
                   choices=['H2', 'sparse', 'dense'])
    p.add_argument('--device', default='cuda')
    return p


def main(argv=None, quiet=False, params=None):
    """Run the driver; returns a dict with the output groups ('results',
    'errors', 'timers'), the ``kernel`` and what nl.discretized.solveNonlocal
    returns (the solution ``u``, the finest operator ``A``, ``A_BC``, the
    level ``hierarchy``, the finest dofmap ``dm``, the solver).  ``params``
    go to the builder of every level."""
    args = parser().parse_args(argv)
    dev = getDevice(args.device)
    noRef = args.noRef if args.noRef > 0 else defaultNoRefNonlocal(args.domain)
    if args.horizon == np.inf:
        raise NotImplementedError('runNonlocal with an infinite horizon')
    prob = nonlocalPoissonProblem(args.domain, args.kernelType, args.s,
                                  args.horizon, args.interaction,
                                  args.normalized, args.problem)
    out = solveNonlocal(prob, noRef, args.element, args.solverType,
                        args.matrixFormat, args.tol, args.maxiter, dev,
                        params=params)
    mesh, dm = out['meshes'][-1], out['dm']

    results = outputGroup('results')
    results.add('kernel', repr(prob['kernel']))
    results.add('problem', prob['problemDescription'])
    results.add('h', mesh.h)
    results.add('hmin', mesh.hmin)
    results.add('dofs', dm.num_dofs)
    results.add('solver', args.solverType)
    results.add('iterations', out['iterations'])
    errors = outputGroup('errors')
    for label, val in modelErrors(dm, out['u'], out['b'],
                                  prob['analyticSolution'],
                                  prob['exactL2Squared'],
                                  prob['exactHsSquared']).items():
        errors.add(label, val)
    timers = outputGroup('timers')
    timers.add('device', str(dev))
    tim = out['timers']
    levels = sorted(out['levelParts'])
    timers.add('assembly seconds',
               sum(tim[f'assembly level {k}'] for k in levels))
    for k in levels:
        timers.add(f'assembly level {k} seconds', tim[f'assembly level {k}'])
        for part, sec in out['levelParts'][k].items():
            timers.add(f'assembly level {k} {part} seconds', sec)
    for name in ('set-up', 'A_BC', 'solver set-up', 'solve'):
        timers.add(f'{name} seconds', tim[name])
    timers.add('explicit residual', out['explicitResidualError'])
    if not quiet:
        for g in (results, errors, timers):
            g.log()
    out.update(results=results, errors=errors, timers=timers,
               kernel=prob['kernel'])
    return out


if __name__ == '__main__':
    main()

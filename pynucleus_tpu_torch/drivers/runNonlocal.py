"""Solve a nonlocal Poisson problem with the port: a finite horizon with the
Dirichlet collar (dense, sparse or H2 = sparse assembly on the device; the
constant, inverseDistance, fractional, gaussian and exponential kernels),
or the gaussian or exponential kernel of an infinite horizon with the zero
exterior (dense or H2).

    python -m pynucleus_tpu_torch.drivers.runNonlocal --domain square \\
        --kernelType constant --horizon 0.2 --problem poly-Dirichlet \\
        --element P1 --solverType cg-mg|lu|mg|cg-jacobi|gmres-mg|... \\
        --matrixFormat sparse [--noRef N] \\
        [--interaction ball2|ballInf|ellipse] [--device cuda|cpu]
    python -m pynucleus_tpu_torch.drivers.runNonlocal --domain disc \\
        --kernelType constant --horizon 0.2 --problem poly-Dirichlet \\
        --element P1 --solverType cg-mg --matrixFormat sparse [--noRef N]
    python -m pynucleus_tpu_torch.drivers.runNonlocal --domain interval \\
        --kernelType gaussian|exponential --problem poly-Dirichlet \\
        --solverType lu --matrixFormat sparse --noRef 6 [--device cpu]
    python -m pynucleus_tpu_torch.drivers.runNonlocal --domain interval \\
        --kernelType gaussian --problem gaussian --gaussianVariance 0.1 \\
        --interaction fullSpace --horizon inf --solverType lu \\
        --matrixFormat H2 [--device cpu]

Port of drivers/runNonlocal.py (pynucleus_tpu/nl/problems.py
nonlocalPoissonProblem and nl/discretized.py discretizedNonlocalProblem)
with the flags and defaults of the JAX driver: kernelType constant,
horizon 0.2, s const(0.4), interaction ball2, gaussianVariance and
exponentialRate 1, noRef 8 on the interval, 2 on the square and 4 on the
disc.  The interval, the square and the disc (of radius 1, its collar the
ring out to 1 + horizon) take the poly-Dirichlet and constant problems,
the interval also the gaussian and exponential ones; ``--interaction
ellipse`` is ball2, as the JAX driver maps it.  The gaussian kernel of
a finite horizon delta is C exp(-r^2 / (delta/3)^2), the exponential one
C exp(-rate r), each normalized as the JAX package normalizes it (the
exponential of a finite horizon on the interval only, as there).
poly-Neumann (the Sum operator) is not ported.  It runs on the card unless ``--device cpu`` asks
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

from ..config import getDevice
from ..base.solvers import SOLVER_TYPES
from ..base.utilsFem import outputGroup
from ..nl.discretized import modelErrors, solveNonlocal
from ..nl.problems import (nonlocalPoissonProblem, defaultNoRefNonlocal,
                           KERNEL_TYPES, PROBLEMS)
from .. import multilevel  # noqa: F401  (registers the 'mg' solver)


def parser():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--kernelType', default='constant', choices=KERNEL_TYPES)
    p.add_argument('--s', default='const(0.4)')
    p.add_argument('--horizon', type=float, default=0.2)
    p.add_argument('--interaction', default='ball2',
                   choices=['ball2', 'ballInf', 'fullSpace', 'ellipse'])
    p.add_argument('--gaussianVariance', type=float, default=1.0)
    p.add_argument('--exponentialRate', type=float, default=1.0)
    p.add_argument('--normalized', dest='normalized', action='store_true',
                   default=True)
    p.add_argument('--no-normalized', dest='normalized',
                   action='store_false')
    p.add_argument('--domain', default='interval',
                   choices=['interval', 'square', 'disc'])
    p.add_argument('--problem', default='poly-Dirichlet', choices=PROBLEMS)
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
    prob = nonlocalPoissonProblem(args.domain, args.kernelType, args.s,
                                  args.horizon, args.interaction,
                                  args.normalized, args.problem,
                                  args.gaussianVariance, args.exponentialRate)
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

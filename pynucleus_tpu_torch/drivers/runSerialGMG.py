"""Serial geometric multigrid on the Poisson problem (unit square or
interval, P1), comparing MG and FMG cycles with (preconditioned) CG, GMRES
and BiCGStab, with the port.

    python -m pynucleus_tpu_torch.drivers.runSerialGMG --domain square \\
        [--problem sin|poly] [--noRef N] [--element P1] \\
        [--smoother jacobi] [--maxiter 50] [--device cuda|cpu]

Port of drivers/runSerialGMG.py with its flags and defaults (square, sin,
noRef 9 on the square and 15 on the interval).  Level 0 is the first
refinement of the coarse mesh with an interior dof, then come noRef
uniform refinements; every level's stiffness is assembled in CSR (host
local matrices and pattern, K16 on the device), with the prolongation P
and R = P^T between levels.  The tolerance is 0.5 h^2; MG (V-cycles with
two damped-Jacobi sweeps on each side) and FMG_V run first, then cg,
gmres (restart maxiter // 5, 5 restarts) and bicgstab, each plain and
preconditioned by one V-cycle.  It runs on the card unless ``--device
cpu`` asks for the CPU; asking for the card without one raises.  It
prints the JAX driver's ``info``, ``rates``, ``iterations``,
``residuals`` and ``errors`` labels, in float64, and ``timers``: the
host set-up parts, each level's assembly parts (the device time of K16 by
CUDA events on the card) and each solve's seconds.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..config import getDevice
from ..base.solvers import solverFactory
from ..base.utilsFem import outputGroup
from ..fem.assembly import assembleStiffness, assembleMass, assembleRHS
from ..fem.dofmaps import P1_DoFMap, str2DoFMap
from ..fem.pdeProblems import diffusionProblem
from ..multilevel.gmg import buildProlongation, multigrid

SMOOTHER_PARAMS = {'jacobi': {'presmoothingSteps': 2,
                              'postsmoothingSteps': 2,
                              'omega': 2.0 / 3.0}}
SOLVERS = (('cg', 'CG', 1), ('gmres', 'GMRES', 5), ('bicgstab', 'BICGSTAB', 1))


def parser():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--domain', default='square',
                   choices=['interval', 'square', 'cube'])
    p.add_argument('--problem', default='sin', choices=['sin', 'poly'])
    p.add_argument('--noRef', type=int, default=-1)
    p.add_argument('--element', default='P1', choices=['P1'])
    p.add_argument('--smoother', default='jacobi', choices=['jacobi'])
    p.add_argument('--maxiter', type=int, default=50)
    p.add_argument('--device', default='cuda')
    return p


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def main(argv=None, quiet=False):
    """Run the driver; returns a dict with the output groups ('info',
    'rates', 'iterations', 'residuals', 'errors', 'timers'), the level
    ``hierarchy``, the multigrid solver ``ml``, the finest dofmap ``dm``,
    the load vector ``b`` and the last solution ``x``."""
    args = parser().parse_args(argv)
    dev = getDevice(args.device)
    p = diffusionProblem(args.domain, args.problem, args.noRef, args.element)
    timers = outputGroup('timers')
    timers.add('device', str(dev))

    t0 = time.perf_counter()
    mesh = p['mesh0']
    while P1_DoFMap(mesh, device='cpu').num_dofs == 0:
        mesh = mesh.refine()
    meshes = [mesh]
    for _ in range(p['noRef']):
        meshes.append(meshes[-1].refine())
    timers.add('meshes seconds', time.perf_counter() - t0)
    t0 = time.perf_counter()
    DM = str2DoFMap[args.element]
    dms = [DM(m, device=dev) for m in meshes]
    dm, mesh = dms[-1], meshes[-1]
    timers.add('dofmaps seconds', time.perf_counter() - t0)

    hierarchy = []
    tP = 0.0
    for lvl, dmL in enumerate(dms):
        parts = {}
        entry = {'A': assembleStiffness(dmL, timers=parts)}
        for part in ('local', 'pattern', 'scatter order', 'scatter'):
            timers.add(f'level {lvl} {part} seconds', parts[part])
        if lvl > 0:
            t0 = time.perf_counter()
            P = buildProlongation(dms[lvl - 1], dmL)
            entry['P'] = P
            entry['R'] = P.T
            tP += time.perf_counter() - t0
        hierarchy.append(entry)
    timers.add('prolongations seconds', tP)
    A = hierarchy[-1]['A']

    h = mesh.h
    tol = {'P1': 0.5 * h ** 2}[args.element]
    t0 = time.perf_counter()
    b = assembleRHS(dm, p['rhsFun']).data
    ml = multigrid(hierarchy=hierarchy,
                   smoother=(args.smoother, SMOOTHER_PARAMS[args.smoother]))
    ml.tolerance = tol
    ml.maxIter = args.maxiter
    ml.setup()
    _sync(dev)
    timers.add('load vector and multigrid set-up seconds',
               time.perf_counter() - t0)
    r0 = float(torch.linalg.norm(b))

    info = outputGroup('info')
    info.add('DoFs', dm.num_dofs)
    info.add('element', args.element)
    info.add('Tol', tol)
    rate = outputGroup('rates')
    its = outputGroup('iterations')
    res = outputGroup('residuals')
    errors = outputGroup('errors')

    def report(label, solve, iterations):
        t0 = time.perf_counter()
        x = solve()
        _sync(dev)
        timers.add(f'solve {label} seconds', time.perf_counter() - t0)
        numIter = iterations()
        resNorm = float(torch.linalg.norm(b - A.matvec(x)))
        rate.add('Rate of convergence ' + label,
                 (resNorm / r0) ** (1 / numIter))
        its.add('Number of iterations ' + label, numIter)
        res.add('Residual norm ' + label, resNorm)
        return x

    for cycle, label in (('V', 'MG'), ('FMG_V', 'FMG')):
        ml.cycle = cycle
        x = report(label, lambda: ml.solve(b), lambda: ml.iterations)
    for name, label, restarts in SOLVERS:
        maxi = args.maxiter // 5 if name == 'gmres' else args.maxiter
        for prefix in ('', 'P'):
            s = solverFactory.build(name, A=A, setup=True)
            s.tolerance = tol
            s.maxIter = maxi
            if name == 'gmres':
                s.restarts = restarts
            if prefix:
                s.setPreconditioner(ml.asPreconditioner())
            x = report(prefix + label, lambda: s.solve(b),
                       lambda: max(s.iterations, 1))

    t0 = time.perf_counter()
    M = assembleMass(dm)
    z = assembleRHS(dm, p['exactSolution']).data
    L2err = float(np.sqrt(abs(float(torch.dot(x, M.matvec(x)))
                              - 2 * float(torch.dot(z, x)) + p['L2ex'])))
    errors.add('L^2 error', L2err)
    errors.add('L^2 error constant', L2err / h ** 2)
    H10err = float(np.sqrt(abs(p['H10ex'] - float(torch.dot(b, x)))))
    errors.add('H^1_0 error', H10err)
    errors.add('H^1_0 error constant', H10err / h)
    timers.add('errors seconds', time.perf_counter() - t0)

    groups = (info, rate, its, res, errors, timers)
    if not quiet:
        for g in groups:
            g.log()
    return {g.name: g for g in groups} | {
        'hierarchy': hierarchy, 'ml': ml, 'dm': dm, 'b': b, 'x': x}


if __name__ == '__main__':
    main()

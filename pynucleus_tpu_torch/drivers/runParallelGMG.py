"""Geometric multigrid on the Poisson problem with the fine levels sharded:
MG and FMG cycles and MG-preconditioned CG, GMRES and BiCGStab, with FMG
initial guesses for PCG and PGMRES, with the port.

    python -m pynucleus_tpu_torch.drivers.runParallelGMG --domain interval \\
        [--element P1] [--noRef N] [--ranks R] [--maxiter 50] \\
        [--tolerance T] [--device cuda|cpu]

Port of drivers/runParallelGMG.py with its flags, defaults and hierarchy
(the levels span refinements cg+1 .. noRef, cg the deepest level whose
estimated dof count stays below 4500; the coarsest of them solved by LU).
``--ranks R`` (R > 1) makes a shard mesh of R shards (shard k on card
k mod device_count, every shard on the CPU with ``--device cpu``) and
the multigrid shards its levels of at least 2000 rows as
DistributedCSROperator (K29 halo, K9), the smoothers on global vectors;
the ranks are not clamped to the card count, as the JAX driver's are to
its device count.  The Krylov solvers apply the whole finest operator.
P2, P3 and the cube raise NotImplementedError, as in runSerialGMG.  It
prints the JAX driver's ``info``, ``rates``, ``iterations``,
``residuals``, ``resHist`` and ``errors`` labels and ``timers``.
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
from ..fem.dofmaps import str2DoFMap
from ..fem.pdeProblems import diffusionProblem
from ..multilevel.gmg import buildProlongation, multigrid

SMOOTHER_PARAMS = {'jacobi': {'presmoothingSteps': 2,
                              'postsmoothingSteps': 2,
                              'omega': 2.0 / 3.0}}
RUNS = ('MG', 'FMG', 'PCG', 'PGMRES', 'PBICGSTAB', 'FMGPCG', 'FMGPGMRES')


def parser():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--domain', default='square',
                   choices=['interval', 'square', 'cube'])
    p.add_argument('--problem', default='sin', choices=['sin', 'poly'])
    p.add_argument('--noRef', type=int, default=-1)
    p.add_argument('--element', default='P1', choices=['P1', 'P2', 'P3'])
    p.add_argument('--smoother', default='jacobi', choices=['jacobi'])
    p.add_argument('--maxiter', type=int, default=50)
    p.add_argument('--tolerance', type=float, default=0.)
    p.add_argument('--ranks', type=int, default=1)
    for run in RUNS:
        p.add_argument('--do' + run, default=True,
                       action=argparse.BooleanOptionalAction)
    p.add_argument('--device', default='cuda')
    return p


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def coarsestLevel(noRef, mdim, element):
    """The first refinement of the hierarchy (drivers/runParallelGMG.py:
    57-75): the deepest level whose estimated dof count stays below
    4500, plus one."""
    numInitialCells = {1: 2, 2: 8, 3: 48}[mdim]
    cells2dofsFactor = {1: {'P1': 1, 'P2': 2, 'P3': 3},
                        2: {'P1': 0.5, 'P2': 2, 'P3': 4.5},
                        3: {'P1': 1. / 6., 'P2': 1.35, 'P3': 4.5}
                        }[mdim][element]
    numCells = numInitialCells * (2 ** mdim) ** np.arange(noRef + 1)
    cg = 0
    while numCells[cg + 1] * cells2dofsFactor < 4500 and cg < noRef - 1:
        cg += 1
    return min(cg + 1, noRef - 1)


def main(argv=None, quiet=False):
    """Run the driver; returns a dict with the output groups ('info',
    'rates', 'iterations', 'residuals', 'resHist', 'errors', 'timers'),
    the multigrid solver ``ml``, the level ``hierarchy``, the shard mesh
    (None for one rank) and the last solution ``x``."""
    args = parser().parse_args(argv)
    if args.element != 'P1':
        raise NotImplementedError(f'{args.element}: the port has the P1 '
                                  'element only (ROADMAP.md A8 item 3)')
    dev = getDevice(args.device)
    p = diffusionProblem(args.domain, args.problem, args.noRef, args.element)
    noRef = p['noRef']
    timers = outputGroup('timers')
    timers.add('device', str(dev))

    t0 = time.perf_counter()
    meshes = [p['mesh0']]
    for _ in range(noRef):
        meshes.append(meshes[-1].refine())
    mdim = meshes[0].manifold_dim
    meshes = meshes[coarsestLevel(noRef, mdim, args.element):]
    DM = str2DoFMap[args.element]
    dms = [DM(m, device=dev) for m in meshes]
    while dms[0].num_dofs == 0:
        meshes, dms = meshes[1:], dms[1:]
    dm, mesh = dms[-1], meshes[-1]
    hierarchy = []
    for lvl, dmL in enumerate(dms):
        entry = {'A': assembleStiffness(dmL)}
        if lvl > 0:
            P = buildProlongation(dms[lvl - 1], dmL)
            entry['P'] = P
            entry['R'] = P.T
        hierarchy.append(entry)
    A = hierarchy[-1]['A']
    _sync(dev)
    timers.add('hierarchy seconds', time.perf_counter() - t0)

    h = mesh.h
    if args.tolerance <= 0.:
        tol = max({'P1': 0.5 * h ** 2}[args.element], 2e-9)
    else:
        tol = args.tolerance
    b = assembleRHS(dm, p['rhsFun']).data

    t0 = time.perf_counter()
    deviceMesh = None
    if args.ranks > 1:
        from ..parallel import makeDeviceMesh
        deviceMesh = makeDeviceMesh(args.ranks, device=dev)
    ml = multigrid(hierarchy=hierarchy,
                   smoother=(args.smoother, SMOOTHER_PARAMS[args.smoother]),
                   deviceMesh=deviceMesh)
    ml.tolerance = tol
    ml.maxIter = args.maxiter
    ml.setup()
    _sync(dev)
    timers.add('multigrid set-up seconds', time.perf_counter() - t0)
    r0 = float(torch.linalg.norm(b))

    info = outputGroup('info')
    info.add('Subdomains', args.ranks)
    info.add('Refinement steps', noRef)
    info.add('Elements', mesh.num_cells)
    info.add('DoFs', dm.num_dofs)
    info.add('h', h)
    info.add('hmin', mesh.hmin)
    info.add('Tolerance', tol)
    rate = outputGroup('rates')
    its = outputGroup('iterations')
    res = outputGroup('residuals')
    resHist = outputGroup('resHist')
    errors = outputGroup('errors')

    def record(label, x, numIter, residuals, seconds):
        resNorm = float(torch.linalg.norm(b - A.matvec(x)))
        numIter = max(1, numIter)
        rate.add('Rate of convergence ' + label,
                 (resNorm / r0) ** (1.0 / numIter))
        its.add('Number of iterations ' + label, numIter)
        res.add('Residual norm ' + label, resNorm)
        resHist.add(label, [float(r) for r in residuals])
        timers.add(f'solve {label} seconds', seconds)

    def timed(fn):
        t0 = time.perf_counter()
        x = fn()
        _sync(dev)
        return x, time.perf_counter() - t0

    x = None
    for cycle, label in (('V', 'MG'), ('FMG_V', 'FMG')):
        if not getattr(args, 'do' + label):
            continue
        ml.cycle = cycle
        x, sec = timed(lambda: ml.solve(b))
        record(label, x, ml.iterations, ml.residuals, sec)

    def makeKrylov(name):
        s = solverFactory.build(name, A=A, setup=True)
        s.tolerance = tol
        s.maxIter = args.maxiter if name != 'gmres' else args.maxiter // 5
        if name == 'gmres':
            s.restarts = 5
        return s

    for name, label in (('cg', 'CG'), ('gmres', 'GMRES'),
                        ('bicgstab', 'BICGSTAB')):
        if getattr(args, 'doP' + label):
            s = makeKrylov(name)
            s.setPreconditioner(ml.asPreconditioner())
            x, sec = timed(lambda: s.solve(b))
            record('P' + label, x, s.iterations, s.residuals, sec)

    # the FMG initial guess of the MG-preconditioned Krylov solver; the
    # iteration count includes the FMG pass
    for name, label in (('cg', 'FMG-PCG'), ('gmres', 'FMG-PGMRES')):
        if not getattr(args, 'do' + label.replace('-', '')):
            continue
        ml.cycle = 'FMG_V'
        saveMax = ml.maxIter
        ml.maxIter = 1
        x0 = ml.solve(b)
        ml.maxIter = saveMax
        s = makeKrylov(name)
        s.setPreconditioner(ml.asPreconditioner())
        s.setInitialGuess(x0)
        x, sec = timed(lambda: s.solve(b))
        record(label, x, s.iterations + 1, s.residuals, sec)

    M = assembleMass(dm)
    z = assembleRHS(dm, p['exactSolution']).data
    L2err = float(np.sqrt(abs(float(torch.dot(x, M.matvec(x)))
                              - 2 * float(torch.dot(z, x)) + p['L2ex'])))
    errors.add('L^2 error', L2err)
    H10err = float(np.sqrt(abs(p['H10ex'] - float(torch.dot(b, x)))))
    errors.add('H^1_0 error', H10err)

    groups = (info, rate, its, res, resHist, errors, timers)
    if not quiet:
        for g in (info, rate, its, res, errors, timers):
            g.log()
    return {g.name: g for g in groups} | {
        'ml': ml, 'hierarchy': hierarchy, 'deviceMesh': deviceMesh, 'x': x}


if __name__ == '__main__':
    main()

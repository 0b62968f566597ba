"""Distributed-operator check: assemble the nonlocal operator in dense,
sparse or H2 format, distribute it over a shard mesh in 'bcast'
(all-gathered input vector) and 'halo' (sharded vector, packed-outbox
exchange) modes, cross-check the applies and run a distributed CG solve,
with the port.

    python -m pynucleus_tpu_torch.drivers.testDistOp --domain disc \\
        --s 'const(0.75)' --problem constant --noRef 7 --buildH2 \\
        --buildDistributedH2Bcast --buildDistributedH2 --doSolve \\
        --ranks 4 [--device cuda|cpu]

Port of drivers/testDistOp.py with its flags and output groups on the
port's problems (the interval and the disc of an infinite horizon;
``--horizon h`` a finite one, the fractional kernel by default, with
``--horizonToMeshSize`` refining until horizon / h reaches it).  The base
operator is the H2 one if built, else the sparse, else the dense one; the
bcast mode wraps an H2 operator as DistributedH2Matrix(bcast=True), another
as DistributedRowBlockOperator; the halo mode an H2 operator as
DistributedH2Matrix, a CSR one as DistributedCSROperator, a dense one as
DistributedHaloOperator.  ``--ranks R`` (default $PYNUCLEUS_RANKS or 4)
shards: shard k on card k mod device_count, so one card runs R shards
with real exchanges (the JAX driver clamps R to its device count).  It
prints ``info``, ``matvec errors`` and ``solve`` as the JAX driver, and
``timers``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..config import getDevice
from ..base.solvers import solverFactory
from ..base.utilsFem import outputGroup
from ..base.linear_operators import CSR_LinearOperator
from ..fem.assembly import assembleMass, assembleRHS
from ..fem.dofmaps import str2DoFMap
from ..fem.functions import Lambda
from ..nl.assembly import nonlocalBuilder
from ..nl.h2 import H2Matrix
from ..nl.problems import (fractionalLaplacianProblem,
                           nonlocalPoissonProblem, defaultNoRef)
from ..parallel.dist import (makeDeviceMesh, DistributedRowBlockOperator,
                             DistributedHaloOperator)
from ..parallel.dist_h2 import DistributedH2Matrix, DistributedCSROperator

BUILDS = ('buildDense', 'buildSparse', 'buildH2', 'buildH2Reduced',
          'buildDistributedH2Bcast', 'buildDistributedH2', 'doSolve')
PAIRS = (('A_dense', 'A_h2', '|(A_dense - A_h2) * x |'),
         ('A_dense', 'A_h2_reduced', '|(A_dense - A_h2_reduced) * x|'),
         ('A_dense', 'A_distributed_bcast',
          '|(A_dense - A_distributed_bcast) * x|'),
         ('A_dense', 'A_distributed_halo',
          '|(A_dense - A_distributed_halo) * x|'),
         ('A_h2', 'A_h2_reduced', '|(A_h2 - A_h2_reduced) * x |'),
         ('A_h2', 'A_distributed_bcast',
          '|(A_h2 - A_distributed_bcast) * x|'),
         ('A_h2', 'A_distributed_halo',
          '|(A_h2 - A_distributed_halo) * x|'),
         ('A_sparse', 'A_distributed_bcast',
          '|(A_sparse - A_distributed_bcast) * x|'),
         ('A_sparse', 'A_distributed_halo',
          '|(A_sparse - A_distributed_halo) * x|'))


def parser():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--domain', default='interval',
                   choices=['interval', 'disc'])
    p.add_argument('--s', default='const(0.75)')
    p.add_argument('--problem', default=None,
                   help='default: constant, with a finite horizon '
                   'poly-Dirichlet')
    p.add_argument('--element', default='P1', choices=['P1'])
    p.add_argument('--noRef', type=int, default=-1)
    p.add_argument('--horizon', type=float, default=np.inf)
    p.add_argument('--kernelType', default='fractional')
    p.add_argument('--interaction', default='ball2')
    p.add_argument('--horizonToMeshSize', type=float, default=-1.)
    for flag in BUILDS:
        p.add_argument('--' + flag, default=flag == 'buildDistributedH2',
                       action=argparse.BooleanOptionalAction)
    p.add_argument('--ranks', type=int,
                   default=int(os.environ.get('PYNUCLEUS_RANKS', '4')))
    p.add_argument('--device', default='cuda')
    return p


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def main(argv=None, quiet=False):
    """Run the driver; returns a dict with the output groups ('info',
    'matvec errors', 'solve' when solved, 'timers'), the operators
    (``ops``), the probe vector ``x``, the dofmap ``dm`` and the shard
    ``mesh``."""
    args = parser().parse_args(argv)
    dev = getDevice(args.device)
    finiteHorizon = args.horizon < np.inf
    if finiteHorizon:
        prob = nonlocalPoissonProblem(
            args.domain, kernelType=args.kernelType, s=args.s,
            horizon=args.horizon, interaction=args.interaction,
            problem=args.problem or 'poly-Dirichlet')
    else:
        prob = fractionalLaplacianProblem(args.domain, args.s,
                                          args.problem or 'constant')
    mesh = makeDeviceMesh(args.ranks, device=dev)
    timers = outputGroup('timers')
    timers.add('device', str(dev))

    kernel = prob['kernel']
    m = prob['mesh']
    if args.horizonToMeshSize > 0 and kernel.finiteHorizon:
        # refine until horizon/h reaches the requested ratio
        # (ref testDistOp.py:96-99)
        while args.horizonToMeshSize > np.around(kernel.horizonValue / m.h,
                                                 5):
            m = m.refine()
    else:
        noRef = args.noRef if args.noRef > 0 else \
            defaultNoRef(args.domain, args.element)
        for _ in range(noRef):
            m = m.refine()
    dm = str2DoFMap[args.element](m, tag=prob['tag'], device=dev)

    info = outputGroup('info')
    info.add('mesh size', dm.mesh.h)
    info.add('DoFs', dm.num_dofs)
    info.add('devices', mesh.devices.size)

    analytic = prob['analyticSolution']
    if analytic is not None:
        x = dm.interpolate(analytic).data
    else:
        # probe vector: sin in the first coordinate (ref testDistOp.py:126)
        x = dm.interpolate(Lambda(lambda xx: np.sin(np.pi * xx[0]))).data
    x = x.contiguous()

    builder = nonlocalBuilder(dm, kernel, zeroExterior=prob['zeroExterior'])
    ops = {}

    def build(name, label, fn):
        t0 = time.perf_counter()
        ops[name] = fn()
        _sync(dev)
        timers.add(label + ' seconds', time.perf_counter() - t0)

    if args.buildDense:
        build('A_dense', 'assemble dense', builder.getDense)
    if args.buildSparse:
        build('A_sparse', 'assemble sparse', builder.getSparse)
    if args.buildH2:
        build('A_h2', 'assemble H2', builder.getH2)
    if args.buildH2Reduced:
        # the reference assembles on the global communicator and reduces to
        # rank 0; with one controller the reduced build is the plain one
        build('A_h2_reduced', 'assemble H2 reduced', builder.getH2)
    base = ops.get('A_h2', ops.get('A_sparse', ops.get('A_dense')))
    if args.buildDistributedH2Bcast:
        build('A_distributed_bcast', 'distribute bcast', lambda: (
            DistributedH2Matrix(base, mesh, bcast=True)
            if isinstance(base, H2Matrix)
            else DistributedRowBlockOperator(base, mesh)))
    if args.buildDistributedH2:
        build('A_distributed_halo', 'distribute halo', lambda: (
            DistributedH2Matrix(base, mesh) if isinstance(base, H2Matrix)
            else DistributedCSROperator(base, mesh)
            if isinstance(base, CSR_LinearOperator)
            else DistributedHaloOperator(base, mesh)))

    ys = {k: op.matvec(x) for k, op in ops.items()}
    matvecErrors = outputGroup('matvec errors')
    for a, b, label in PAIRS:
        if a in ys and b in ys:
            matvecErrors.add(label, float(torch.linalg.norm(ys[a] - ys[b])))
    groups = [info, matvecErrors]

    if args.doSolve and (args.buildDistributedH2
                         or args.buildDistributedH2Bcast):
        A_dist = ops.get('A_distributed_halo',
                         ops.get('A_distributed_bcast'))
        b = assembleRHS(dm, prob['rhs'], qOrder=3).data
        cg = solverFactory.build('cg', A=A_dist, setup=True)
        cg.maxIter = 1000
        t0 = time.perf_counter()
        u = cg.solve(b)
        _sync(dev)
        timers.add('distributed CG seconds', time.perf_counter() - t0)
        solveGroup = outputGroup('solve')
        solveGroup.add('residual norm', cg.residuals[-1])
        solveGroup.add('CG iterations', cg.iterations)
        if analytic is not None:
            M = assembleMass(dm)
            diff = u - dm.interpolate(analytic).data
            solveGroup.add('L2 error', float(np.sqrt(abs(float(
                torch.dot(diff, M.matvec(diff)))))))
        groups.append(solveGroup)
    groups.append(timers)
    if not quiet:
        for g in groups:
            g.log()
    return {g.name: g for g in groups} | {'ops': ops, 'x': x, 'dm': dm,
                                          'mesh': mesh}


if __name__ == '__main__':
    main()

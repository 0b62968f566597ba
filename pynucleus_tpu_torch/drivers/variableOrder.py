"""Variable fractional order studies: assemble and solve the fractional
Poisson problem (-Delta)^s(x,y) u = 1, zero exterior, for a family of
spatially varying orders in dense (and, on the interval, optionally H2)
format.

    python -m pynucleus_tpu_torch.drivers.variableOrder --domain \\
        interval|square|circle [--solver lu|cg|gmres] [--noRef N] \\
        [--s1 0.25] [--s2 0.75] [--do_transpose] [--do_h2] \\
        [--maxIter 1000] [--tol 1e-7] [--device cuda|cpu]

Port of drivers/variableOrder.py with its flags and defaults: the
interval [-1, 1] refined 8 times with const, varconst and three
leftRight orders (seven lines), the square [-1, 1]^2 (uniformSquare)
refined 5 times with leftRight(s1, s2) (the nonsymmetric local matrices,
K19), the disc (circle(n=8)) refined 5 times with innerOuter(2, s2, s1,
0.5) (a symmetric variable order, K1); the solvers lu, cg and gmres, the
Krylov ones preconditioned by the inverse diagonal; with
``--do_transpose`` the dense transpose of each nonsymmetric operator
solved too (without a preconditioner, as there).  It prints the same
``results`` labels ('{format} {s} resNorm', 'norm', 'transpose norm')
plus wall times (``timers``: each assembly and solve, host clock after
a synchronise).  ``--element P0`` raises (the port has the P1 dofmap
only: ROADMAP.md A8 item 3), as does ``--do_h2`` on the square and the
circle (the JAX package fails there too); on the interval ``--do_h2``
takes the port's variable-order H2 operators.  It runs on the card unless
``--device cpu`` asks for the CPU.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..config import getDevice
from ..base.linear_operators import (Dense_LinearOperator,
                                     Diagonal_LinearOperator)
from ..base.solvers import solverFactory, krylov_solver
from ..base.utilsFem import outputGroup
from ..fem.assembly import assembleRHS
from ..fem.dofmaps import P1_DoFMap
from ..fem.functions import constant
from ..fem.meshes import simpleInterval, uniformSquare, circle
from ..nl.assembly import assembleNonlocal
from ..nl.kernels import (getFractionalKernel, constFractionalOrder,
                          variableConstFractionalOrder,
                          leftRightFractionalOrder, innerOuterFractionalOrder)


def parser():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--domain', default='interval',
                   choices=['interval', 'square', 'circle'])
    for flag, default in (('do_dense', True), ('do_h2', False),
                          ('do_transpose', False)):
        p.add_argument('--' + flag, dest=flag, action='store_true',
                       default=default)
        p.add_argument('--no-' + flag, dest=flag, action='store_false')
    p.add_argument('--solver', default='lu', choices=['lu', 'cg', 'gmres'])
    p.add_argument('--maxIter', type=int, default=1000)
    p.add_argument('--tol', type=float, default=1e-7)
    p.add_argument('--element', default='P1', choices=['P1', 'P0'])
    p.add_argument('--s1', type=float, default=0.25)
    p.add_argument('--s2', type=float, default=0.75)
    p.add_argument('--noRef', type=int, default=-1)
    p.add_argument('--device', default='cuda')
    return p


def problem(domain, noRef, s1, s2):
    """(mesh, orders) of the JAX driver's domain: the mesh refined noRef
    times (the domain's default where noRef <= 0) and its orders."""
    smean = 0.5 * (s1 + s2)
    if domain == 'interval':
        mesh = simpleInterval(-1.0, 1.0)
        noRef = noRef if noRef > 0 else 8
        orders = [constFractionalOrder(s1), constFractionalOrder(s2),
                  variableConstFractionalOrder(s1),
                  variableConstFractionalOrder(s2),
                  leftRightFractionalOrder(s1, s2, s1, s1),
                  leftRightFractionalOrder(s1, s2, smean, smean),
                  leftRightFractionalOrder(s1, s2, s2, s2)]
    elif domain == 'square':
        mesh = uniformSquare(N=2, ax=-1.0, ay=-1.0, bx=1.0, by=1.0)
        noRef = noRef if noRef > 0 else 5
        orders = [leftRightFractionalOrder(s1, s2)]
    else:
        mesh = circle(n=8)
        noRef = noRef if noRef > 0 else 5
        orders = [innerOuterFractionalOrder(mesh.dim, s2, s1, 0.5)]
    for _ in range(noRef):
        mesh = mesh.refine()
    return mesh, orders


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _solve(name, A, b, maxIter, tol, precondition):
    """x of A x = b by the solver ``name`` from x0 = 0, the Krylov solvers
    with the inverse diagonal where ``precondition``."""
    solver = solverFactory.build(name, A=A, setup=True)
    solver.maxIter = maxIter
    solver.tolerance = tol
    if precondition and isinstance(solver, krylov_solver):
        solver.setPreconditioner(Diagonal_LinearOperator(1.0 / A.diagonal))
    return solver.solve(b)


def main(argv=None, quiet=False, params=None):
    """Run the driver; returns a dict with its output groups ('info': the
    dofs and the device, 'results', 'timers'), the dofmap ``dm`` and the
    operators ``A`` (label -> the last operator of each format).
    ``params`` go to every assembly, e.g. ``{'denseGrid': False}``, the
    per-pair dense path of a constant order (the JAX package's CPU
    default; its grid differs by 3.5e-5 on the interval, ROADMAP.md)."""
    args = parser().parse_args(argv)
    if args.element == 'P0':
        raise NotImplementedError('--element P0: the port has the P1 dofmap '
                                  'only (ROADMAP.md A8 item 3)')
    if args.do_h2 and args.domain != 'interval':
        raise NotImplementedError(
            '--do_h2 on the square and the circle: H2 of a variable or '
            'nonsymmetric order in 2D is not ported (the JAX package fails '
            'there with an AssertionError)')
    dev = getDevice(args.device)
    mesh, orders = problem(args.domain, args.noRef, args.s1, args.s2)
    dm = P1_DoFMap(mesh, device=dev)
    rhs = constant(1.0)

    info = outputGroup('info')
    info.add('dofs', dm.num_dofs)
    info.add('device', str(dev))
    results = outputGroup('results')
    timers = outputGroup('timers')
    ops = {}
    for s in orders:
        b = assembleRHS(dm, rhs).data
        kernel = getFractionalKernel(mesh.dim, s)
        for label, do in (('dense', args.do_dense), ('H2', args.do_h2)):
            if not do:
                continue
            _sync(dev)
            t0 = time.perf_counter()
            A = assembleNonlocal(dm, kernel, matrixFormat=label.lower(),
                                 params=params, device=dev)
            _sync(dev)
            timers.add(f'{label} assemble {s} seconds',
                       time.perf_counter() - t0)
            t0 = time.perf_counter()
            x = _solve(args.solver, A, b, args.maxIter, args.tol, True)
            _sync(dev)
            timers.add(f'{label} solve {s} seconds', time.perf_counter() - t0)
            ops[label] = A
            res = float(torch.linalg.norm(A.matvec(x) - b))
            results.add(f'{label} {s} resNorm', res)
            results.add(f'{label} {s} norm', float(torch.linalg.norm(x)))
            if not s.symmetric and args.do_transpose and label == 'dense':
                At = Dense_LinearOperator(A.data.T.contiguous())
                t0 = time.perf_counter()
                xt = _solve(args.solver, At, b, args.maxIter, args.tol,
                            False)
                _sync(dev)
                timers.add(f'{label} transpose solve {s} seconds',
                           time.perf_counter() - t0)
                results.add(f'{label} {s} transpose norm',
                            float(torch.linalg.norm(xt)))
    if not quiet:
        for g in (info, results, timers):
            g.log()
    return {'info': info, 'results': results, 'timers': timers, 'dm': dm,
            'A': ops}


if __name__ == '__main__':
    main()

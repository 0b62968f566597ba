"""Operator interpolation over the fractional order s with the port.

    python -m pynucleus_tpu_torch.examples.example_operator_interpolation \\
        [--device cuda|cpu]

Port of examples/example_operator_interpolation.py.  The family
(-Delta)^s for s in [0.05, 0.95] on the interval [-1, 1] refined 6 times
(P1, 63 dofs) is approximated by Chebyshev interpolation over sub-intervals
(nl/operator_interpolation.py); node operators are assembled lazily, so
re-solving for nearby values of s is fast.  For s = 0.75, 0.76 and 0.3 it
solves A(s) u = b (b the load of the constant 1) by CG preconditioned by
Jacobi to 1e-8 and prints max(u).  It runs on the card unless ``--device
cpu`` asks for the CPU.  The dense node operators take the port's default
path (the grid); ``main(argv, params={'denseGrid': False})`` takes the
per-pair path, the JAX package's choice on the CPU, whose output is the
JAX example's.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..config import getDevice
from ..base.solvers import solverFactory
from ..fem.assembly import assembleRHS
from ..fem.dofmaps import P1_DoFMap
from ..fem.functions import constant
from ..fem.meshes import simpleInterval
from ..nl.assembly import assembleNonlocal
from ..nl.kernels import kernelFactory
from ..nl.operator_interpolation import admissibleSet

ORDERS = (0.75, 0.76, 0.3)


def parser():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--device', default='cuda')
    return p


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def main(argv=None, params=None):
    """Runs the example, the node operators assembled with ``params``;
    returns the operator and, per order, the iterations, max(u), the
    seconds of its set and solve (node assemblies included) and the node
    operators assembled after it."""
    args = parser().parse_args(argv)
    dev = getDevice(args.device)
    mesh = simpleInterval(-1.0, 1.0)
    for _ in range(6):
        mesh = mesh.refine()
    dm = P1_DoFMap(mesh, device=dev)
    b = assembleRHS(dm, constant(1.)).data

    kernel = kernelFactory('fractional', s=admissibleSet([0.05, 0.95]),
                           dim=1)
    t0 = time.perf_counter()
    A = assembleNonlocal(dm, kernel, matrixFormat='dense', params=params)
    print('operator creation: {:.3f}s ({} interpolation nodes, lazy)'
          .format(time.perf_counter() - t0, A.getNumInterpolationNodes()))

    results = []
    for sVal in ORDERS:
        t0 = time.perf_counter()
        A.set(sVal)
        solver = solverFactory.build('cg-jacobi', A=A, setup=True)
        solver.maxIter = 1000
        solver.tolerance = 1e-8
        u = solver.solve(b)
        _sync(dev)
        seconds = time.perf_counter() - t0
        uMax = float(u.max())
        print('s={}: solved in {:.3f}s, |u|_max = {:.5f}'
              .format(sVal, seconds, uMax))
        results.append({'s': sVal, 'iterations': solver.iterations,
                        'u_max': uMax, 'seconds': seconds,
                        'assembled': sum(d.assembled for ops in A.ops
                                         for d in ops)})
    return A, results


if __name__ == '__main__':
    main()

#!/usr/bin/env python3
"""Outputs of the JAX package's operator interpolation over the fractional
order that chip_smoke.py phase 19 holds the port to (its JAX_INTERP pins).

    python scripts/pin_operator_interpolation_jax.py

The line of examples/example_operator_interpolation.py: the interval
[-1, 1] refined 6 times, P1, kernelFactory('fractional',
s=admissibleSet([0.05, 0.95]), dim=1), assembleNonlocal(..., 'dense'),
run on the CPU in float64; one JSON object per line:
  - the intervals and the nodes of the operator (all interpolation nodes);
  - for s = 0.75, 0.76, 0.3 in turn: the Lagrange weights, ||A(s) x|| and
    (A(s) x)[:4] for x = RandomState(19).standard_normal(N), CG
    preconditioned by Jacobi on A(s) u = b (b the load of the constant 1;
    tolerance 1e-8, maxIter 1000, as the example): its iterations and
    max(u), and the number of node operators assembled after the solve;
  - the same kernel in 'H2' at s = 0.5: ||A(s) x|| and (A(s) x)[:4].
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
NOREF = 6
RANGE = (0.05, 0.95)
ORDERS = (0.75, 0.76, 0.3)
H2_ORDER = 0.5
SEED = 19


def setup():
    from pynucleus_tpu.fem import meshFactory, dofmapFactory, functionFactory
    from pynucleus_tpu.fem import assembleRHS
    mesh = meshFactory('interval', a=-1, b=1)
    for _ in range(NOREF):
        mesh = mesh.refine()
    dm = dofmapFactory('P1', mesh)
    b = assembleRHS(dm, functionFactory('constant', value=1.))
    return dm, b


def applied(A, x):
    import numpy as np
    y = np.asarray(A @ x)
    return {'Ax_norm': float(np.linalg.norm(y)),
            'Ax4': [float(v) for v in y[:4]]}


def main():
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import numpy as np
    from pynucleus_tpu.base import solverFactory
    from pynucleus_tpu.nl.assembly import assembleNonlocal
    from pynucleus_tpu.nl.kernels import kernelFactory
    from pynucleus_tpu.nl.operator_interpolation import admissibleSet
    dm, b = setup()
    b = np.asarray(b.data if hasattr(b, 'data') else b)
    x = np.random.RandomState(SEED).standard_normal(dm.num_dofs)
    kernel = kernelFactory('fractional', s=admissibleSet(list(RANGE)), dim=1)
    A = assembleNonlocal(dm, kernel, matrixFormat='dense')
    print(json.dumps({'dofs': dm.num_dofs,
                      'intervals': [[float(a), float(c)]
                                    for a, c in A.intervals],
                      'nodes': [[float(v) for v in n] for n in A.nodes]}),
          flush=True)
    for s in ORDERS:
        A.set(s)
        out = {'s': s, 'weights': [float(v) for v in A._weights]}
        out.update(applied(A, x))
        solver = solverFactory('cg-jacobi', A=A, setup=True)
        solver.maxIter = 1000
        solver.tolerance = 1e-8
        u = np.asarray(solver(b, np.zeros(dm.num_dofs)))
        out.update({'iterations': int(solver.iterations),
                    'u_max': float(u.max()),
                    'assembled': int(sum(d.assembled for ops in A.ops
                                         for d in ops))})
        print(json.dumps(out), flush=True)
    H = assembleNonlocal(dm, kernel, matrixFormat='H2')
    H.set(H2_ORDER)
    out = {'H2 s': H2_ORDER}
    out.update(applied(H, x))
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()

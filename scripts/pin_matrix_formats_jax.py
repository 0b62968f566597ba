#!/usr/bin/env python3
"""Outputs of the JAX package for the horizon-corrected format
('H2corrected') that chip_smoke.py phase 18 holds the port to (its
JAX_H2CORRECTED pins).

    python scripts/pin_matrix_formats_jax.py [--table]

The fractional kernel of order 0.25 and horizon 0.4 on
nonlocalMeshFactory's interval [-1, 1] or square [-1, 1]^2 with its
collar (HOMOGENEOUS_DIRICHLET), refined noRef times, P1 on the interior
dofs (the domain indicator's tag), run on the CPU in float64; one JSON
object per line:
  - the interval at noRef 3 and 6 and the square at noRef 1:
    assembleNonlocal(..., 'H2corrected') at horizon 0.4, then setKernel to
    horizon 0.3: for each, the operator's largest entry, Frobenius norm and
    trace (of toarray), ||A x|| and (A x)[:4] for x_k = cos(0.3 k), and
    diag(A)[:4];
  - at noRef 6: CG preconditioned by Jacobi (tolerance 1e-10, maxIter
    1000) on A x = M 1 at horizon 0.4: iterations and ||x||.
With --table, for the interval at noRef 3 and 7 and the square at noRef 1
and 2, at horizon 0.4 and (setKernel) 0.3: max|A_c - A_sparse| /
max|A_sparse| and the relative difference of their applies to x, A_sparse
the exact finite-horizon operator (nonlocalBuilder.getSparse) of the
horizon.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
S, DELTA, DELTA2 = 0.25, 0.4, 0.3


def setup(domain, noRef):
    from pynucleus_tpu.fem.dofmaps import P1_DoFMap
    from pynucleus_tpu.nl.kernels import getFractionalKernel
    from pynucleus_tpu.nl.problems import (nonlocalMeshFactory,
                                           HOMOGENEOUS_DIRICHLET)
    dim = 1 if domain == 'interval' else 2
    k = getFractionalKernel(dim, S, horizon=DELTA)
    mesh, nI = nonlocalMeshFactory.build(
        domain, kernel=k, boundaryCondition=HOMOGENEOUS_DIRICHLET,
        **({'a': -1, 'b': 1} if domain == 'interval' else {}))
    for _ in range(noRef):
        mesh = mesh.refine()
    return P1_DoFMap(mesh, tag=nI['domain']), k


def summary(A, x):
    import numpy as np
    D = np.asarray(A.toarray())
    Ax = np.asarray(A @ x)
    return {'max_entry': float(np.abs(D).max()),
            'fro': float(np.linalg.norm(D)), 'trace': float(np.trace(D)),
            'Ax_norm': float(np.linalg.norm(Ax)),
            'Ax4': [float(v) for v in Ax[:4]],
            'diag4': [float(v) for v in np.diag(D)[:4]]}


def pins(domain, noRef):
    import numpy as np
    from pynucleus_tpu.nl.assembly import assembleNonlocal
    from pynucleus_tpu.nl.kernels import getFractionalKernel
    dm, k = setup(domain, noRef)
    A = assembleNonlocal(dm, k, matrixFormat='H2corrected')
    x = np.cos(np.arange(dm.num_dofs) * 0.3)
    out = {'line': f'{domain} noRef {noRef}', 'dofs': dm.num_dofs,
           'cells': dm.mesh.num_cells, 'delta0.4': summary(A, x)}
    if noRef == 6:
        from pynucleus_tpu.base.solvers import solverFactory
        from pynucleus_tpu.fem.assembly import assembleMass
        b = assembleMass(dm) @ np.ones(dm.num_dofs)
        s = solverFactory.build('cg-jacobi', A=A, setup=True)
        s.tolerance, s.maxIter = 1e-10, 1000
        xs = s.solve(b)
        out['cg_jacobi'] = {'iterations': int(s.iterations),
                            'x_norm': float(np.linalg.norm(np.asarray(xs)))}
    A.setKernel(getFractionalKernel(dm.mesh.dim, S, horizon=DELTA2))
    out['delta0.3'] = summary(A, x)
    print(json.dumps(out), flush=True)


def table(domain, noRef):
    import numpy as np
    from pynucleus_tpu.nl.assembly import assembleNonlocal, nonlocalBuilder
    from pynucleus_tpu.nl.kernels import getFractionalKernel
    dm, k = setup(domain, noRef)
    Ac = assembleNonlocal(dm, k, matrixFormat='H2corrected')
    x = np.cos(np.arange(dm.num_dofs) * 0.3)
    out = {'line': f'{domain} noRef {noRef}', 'cells': dm.mesh.num_cells,
           'dofs': dm.num_dofs}
    for delta in (DELTA, DELTA2):
        if delta != DELTA:
            k = getFractionalKernel(dm.mesh.dim, S, horizon=delta)
            Ac.setKernel(k)
        Asp = np.asarray(nonlocalBuilder(dm, k).getSparse().toarray())
        Sx = Asp @ x
        out[f'delta{delta}'] = {
            'entries': float(np.abs(np.asarray(Ac.toarray()) - Asp).max()
                             / np.abs(Asp).max()),
            'matvec': float(np.linalg.norm(np.asarray(Ac @ x) - Sx)
                            / np.linalg.norm(Sx))}
    print(json.dumps(out), flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--table', action='store_true')
    args = p.parse_args()
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import pynucleus_tpu  # noqa: F401  (float64)
    if args.table:
        for domain, noRef in (('interval', 3), ('interval', 7),
                              ('square', 1), ('square', 2)):
            table(domain, noRef)
        return
    for domain, noRef in (('interval', 3), ('interval', 6), ('square', 1)):
        pins(domain, noRef)


if __name__ == '__main__':
    main()

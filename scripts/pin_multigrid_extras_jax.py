#!/usr/bin/env python3
"""Outputs of the JAX package's multigrid extras that chip_smoke.py phase 20
holds the port to (its JAX_MG_EXTRAS pins).

    python scripts/pin_multigrid_extras_jax.py

Run on the CPU in float64; one JSON object per line, each named by 'line':
  - 'interval': tests/test_multilevel_extra.py's hierarchy (the interval
    [0, 1] refined 2-6 times, P1 stiffness, the load of the constant 1),
    multigrid(smoother=('chebyshev', {})) at tolerance 1e-10 with the V and
    the FMG_V cycle: iterations and max|x|; rho(D^-1 A) per level;
  - 'square': uniformSquare(N=2) refined 1-6 times (3,969 dofs on the
    finest), the same solves and rho per level;
  - 'ilu': tests/test_ilu.py's hierarchy (the interval refined 3-7 times,
    b = 1), multigrid(smoother=('ilu', {})) at tolerance 1e-10, maxIter
    50: iterations and max|x|;
  - 'sss': the SSS operator of the seeded SPD matrix of
    :func:`seededSPD` (n 2,000), applied to RandomState(SSS_SEED + 1)'s
    normal vector: ||y|| and y[:4].
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
TOL = 1e-10
SSS_N = 2000
SSS_SEED = 20
# (domain, refinements, first kept level)
HIERARCHIES = {'interval': ('interval', 6, 2), 'square': ('square', 6, 1),
               'ilu': ('interval', 7, 3)}


def seededSPD(n=SSS_N, seed=SSS_SEED):
    """A symmetric positive definite scipy CSR matrix made from a seed
    (numpy and scipy only, so that the port's script makes the same one)."""
    import numpy as np
    import scipy.sparse as sp
    rng = np.random.RandomState(seed)
    M = sp.random(n, n, density=4.0 / n, random_state=rng, format='csr')
    M = M + M.T
    return (M + sp.diags(np.asarray(abs(M).sum(axis=1)).ravel() + 1.0)) \
        .tocsr()


def levels(domain, noRef, first):
    from pynucleus_tpu import fem
    from pynucleus_tpu.multilevel.gmg import (buildMeshHierarchy,
                                              buildProlongation)
    mesh = fem.simpleInterval(0.0, 1.0) if domain == 'interval' else \
        fem.uniformSquare(N=2, ax=0., ay=0., bx=1., by=1.)
    out, dmPrev = [], None
    for m in buildMeshHierarchy(mesh, noRef)[first:]:
        dm = fem.P1_DoFMap(m)
        entry = {'A': fem.assembleStiffness(dm), 'dm': dm}
        if dmPrev is not None:
            entry['P'] = buildProlongation(dmPrev, dm)
        out.append(entry)
        dmPrev = dm
    return out


def main():
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import numpy as np
    import jax.numpy as jnp
    from pynucleus_tpu import fem
    from pynucleus_tpu.base.linear_operators import SSS_LinearOperator
    from pynucleus_tpu.multilevel.gmg import multigrid
    for line, spec in HIERARCHIES.items():
        lv = levels(*spec)
        if line == 'ilu':
            b = jnp.ones(lv[-1]['A'].num_rows)
        else:
            b = fem.assembleRHS(lv[-1]['dm'], fem.functionFactory(
                'constant', value=1.)).data
        out = {'line': line, 'dofs': lv[-1]['A'].num_rows}
        smoother = ('ilu', {}) if line == 'ilu' else ('chebyshev', {})
        for cycle in ('V',) if line == 'ilu' else ('V', 'FMG_V'):
            ml = multigrid(hierarchy=lv, smoother=smoother)
            ml.tolerance = TOL
            ml.maxIter = 50
            ml.setup()
            ml.cycle = cycle
            x = np.asarray(ml.solve(b))
            out[cycle] = {'iterations': ml.iterations,
                          'xmax': float(np.abs(x).max())}
            if line != 'ilu':
                out['rhos'] = [float(r) for r in ml.levels.rhos]
        print(json.dumps(out), flush=True)
    import scipy.sparse as sp
    A = seededSPD()
    L = sp.tril(A, k=-1).tocsr()
    S = SSS_LinearOperator(L.indices, L.indptr, L.data, A.diagonal())
    x = np.random.RandomState(SSS_SEED + 1).standard_normal(SSS_N)
    y = np.asarray(S.matvec(jnp.asarray(x)))
    print(json.dumps({'line': 'sss', 'n': SSS_N, 'nnz_L': int(L.nnz),
                      'y_norm': float(np.linalg.norm(y)),
                      'y4': [float(v) for v in y[:4]]}), flush=True)


if __name__ == '__main__':
    main()

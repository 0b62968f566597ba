#!/usr/bin/env python3
"""Outputs of the JAX package for the manifold fractional kernel and the
variable fractional orders in 1D and 2D that chip_smoke.py phase 22 holds
the port to (its JAX_ORDERS2D pins).

    python scripts/pin_orders2d_jax.py

Run on the CPU in float64, on the per-pair dense path (params={'denseGrid':
False}, the JAX package's CPU default); one JSON object per line, each
with the operator's largest entry, Frobenius norm and trace, ||A x|| and
(A x)[:4] for x_k = cos(0.3 k), diag(A)[:4]:
  - manifold_64, manifold_256: getFractionalKernel(2, 0.5, manifold=True)
    on the surface of circle(n=8) refined 3 and 5 times (64 and 256 dofs,
    P1_DoFMap(surface, tag=None)), zeroExterior=False;
  - orders_interval: each order of ORDER_CASES on the interval [-1, 1]
    refined 4 times (15 dofs), with the zero-exterior term;
  - orders_2d: each order of ORDER_CASES on its 2D mesh at noRef 2 (the
    driver's square [-1, 1]^2, uniformSquare(N=2), 9 dofs, or its disc,
    circle(n=8), 49 dofs), with the zero-exterior term;
  - driver: drivers/variableOrder.py at noRef 3, the square (lu,
    --do_transpose), the circle (lu) and the interval (lu): its results.
The orders (ORDER_CASES, also in chip_smoke.py and
tests/test_torch_orders2d.py): fe is feFractionalOrder of the P1
interpolant of s(x) = 0.45 + 0.2 x_0 on the mesh's dofmap.  About a
minute on the CPU.
"""
import contextlib
import io
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'drivers'))
PER_PAIR = {'denseGrid': False}

# name -> (the factory entry, its arguments with dim for 'dim', its 2D
# mesh); 'fe' takes the interpolant of FE_ORDER
ORDER_CASES = {
    'leftRight': ('twoDomainNonSym', (0.25, 0.75), {}, 'square'),
    'innerOuter': ('innerOuter', ('dim', 0.75, 0.25, 0.5), {}, 'disc'),
    'innerOuter_sio': ('innerOuter', ('dim', 0.75, 0.25, 0.5),
                       {'sio': 0.4, 'soi': 0.6}, 'disc'),
    'islands': ('islands', (0.3, 0.7), {'r': 0.1, 'r2': 0.6}, 'square'),
    'islands_sio': ('islands', (0.3, 0.7), {'r': 0.1, 'r2': 0.6,
                                            'sio': 0.4, 'soi': 0.6},
                    'square'),
    'layers': ('layers', ('dim', [-1.0, 0.25, 1.0], [[0.2, 0.3],
                                                      [0.3, 0.4]]), {},
               'square'),
    'layers_nonsym': ('layers', ('dim', [-1.0, 0.25, 1.0], [[0.2, 0.3],
                                                             [0.6, 0.4]]),
                      {}, 'square'),
    'smoothedLeftRight': ('smoothedLeftRight', (0.25, 0.75), {'r': 0.3},
                          'square'),
    'linearLeftRightNonSym': ('linearLeftRightNonSym', (0.25, 0.75),
                              {'r': 0.3}, 'square'),
    'innerOuterNonSym': ('innerOuterNonSym', (0.3, 0.6),
                         {'r': 0.2, 'radius': 0.5}, 'disc'),
    'fe': ('fe', (), {}, 'square'),
}


def FE_ORDER(x):
    return 0.45 + 0.2 * x[0]


def summary(D):
    import numpy as np
    D = np.asarray(D)
    x = np.cos(0.3 * np.arange(D.shape[0]))
    Ax = D @ x
    return {'dofs': int(D.shape[0]), 'max_entry': float(np.abs(D).max()),
            'fro': float(np.linalg.norm(D)), 'trace': float(np.trace(D)),
            'Ax_norm': float(np.linalg.norm(Ax)),
            'Ax4': [float(v) for v in Ax[:4]],
            'diag4': [float(v) for v in np.diag(D)[:4]]}


def mesh(domain, noRef):
    from pynucleus_tpu.fem import meshFactory
    m = {'interval': lambda: meshFactory('interval', a=-1, b=1),
         'square': lambda: meshFactory('square', ax=-1, ay=-1, bx=1, by=1),
         'disc': lambda: meshFactory('disc', n=8)}[domain]()
    for _ in range(noRef):
        m = m.refine()
    return m


def order(name, dm):
    from pynucleus_tpu.fem import Lambda
    from pynucleus_tpu.nl.kernels import fractionalOrderFactory
    entry, args, kw, _ = ORDER_CASES[name]
    if entry == 'fe':
        return fractionalOrderFactory('fe', dm.interpolate(Lambda(FE_ORDER)))
    args = [dm.mesh.dim if a == 'dim' else a for a in args]
    return fractionalOrderFactory(entry, *args, **kw)


def dense(dm, kernel, zeroExterior=True):
    import numpy as np
    from pynucleus_tpu.nl.assembly import nonlocalBuilder
    return np.asarray(nonlocalBuilder(dm, kernel, zeroExterior=zeroExterior,
                                      params=PER_PAIR).getDense().toarray())


def main():
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import pynucleus_tpu  # noqa: F401  (float64)
    from pynucleus_tpu.fem import circle, dofmapFactory, P1_DoFMap
    from pynucleus_tpu.nl import getFractionalKernel
    for noRef in (3, 5):
        m = circle(n=8)
        for _ in range(noRef):
            m = m.refine()
        dm = P1_DoFMap(m.get_surface_mesh(), tag=None)
        print(json.dumps({f'manifold_{dm.num_dofs}': summary(dense(
            dm, getFractionalKernel(2, 0.5, manifold=True),
            zeroExterior=False))}), flush=True)
    for key, domain, noRef in (('orders_interval', 'interval', 4),
                               ('orders_2d', None, 2)):
        out = {}
        for name, (*_, mesh2d) in ORDER_CASES.items():
            dm = dofmapFactory('P1', mesh(domain or mesh2d, noRef))
            out[name] = summary(dense(dm, getFractionalKernel(
                dm.mesh.dim, order(name, dm))))
        print(json.dumps({key: out}), flush=True)
    import variableOrder
    lines = {}
    for domain, extra in (('square', ['--do_transpose']), ('circle', []),
                          ('interval', [])):
        with contextlib.redirect_stdout(io.StringIO()):
            d = variableOrder.main(['--domain', domain, '--noRef', '3',
                                    '--solver', 'lu'] + extra)
        lines[domain] = d.outputGroups['results'].toDict()
    print(json.dumps({'driver': lines}), flush=True)


if __name__ == '__main__':
    main()

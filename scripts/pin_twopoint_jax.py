#!/usr/bin/env python3
"""Outputs of the JAX package for the two-point weights, the tempered
kernels and the remaining radial profiles that chip_smoke.py phase 21
holds the port to (its JAX_TWOPOINT pins).

    python scripts/pin_twopoint_jax.py

Run on the CPU in float64, on the per-pair dense path (params={'denseGrid':
False}, the JAX package's CPU default); one JSON object per line, each
with the operator's largest entry, Frobenius norm and trace, ||A x|| and
(A x)[:4] for x_k = cos(0.3 k), diag(A)[:4]:
  - tempered_phi: getFractionalKernel(1, 0.4, phi=temperedTwoPoint(2)) on
    the interval [-1, 1] refined 4 times (15 dofs), zeroExterior=False
    (the tier-1 bar of tests/test_kernels_extra.py), and its far entry's
    ratio A[0, N-1] / A0[0, N-1] to the unweighted kernel's;
  - leftRight, interface: getFractionalKernel(1, 0.4, phi=...) with
    leftRightTwoPoint(1, 2, 0.5, 3, 0.1) and interfaceTwoPoint(0.3, 0.2,
    True, 0.05) on the same interval, with the zero-exterior term;
  - nonsym_tempered: getFractionalKernel(1, constantNonSym(0.25),
    phi=temperedTwoPoint(2)) on the same interval (K19), with the
    zero-exterior term;
  - tempered_k14: FractionalKernel(1, 0.4, 0.2, ball2, temperedLambda=3)
    on nonlocalMeshFactory's interval with its collar (DIRICHLET) refined 4
    times, getSparse (its cut pairs through K14);
  - logInverseDistance, monomial (C 0.5, r^1), polynomial (C 0.5, radius
    and horizon 0.3, ball2) on the interval refined 4 times,
    zeroExterior=False;
  - greens_tempered_re, greens_tempered_im: the real and imaginary parts
    of getComplexKernel(2, greensLambda=-3j, phi=temperedTwoPoint(1)) on
    meshFactory's square [0, 1]^2 (N=2) refined 2 times (its dense
    operator, infinite horizon);
  - run_nonlocal: drivers/runNonlocal.py --problem poly-Dirichlet
    --element P1 --matrixFormat sparse (horizon 0.2): the interval at
    noRef 6 with the gaussian and the exponential kernel (lu) and the
    square at noRef 2 with the gaussian kernel (lu): dofs and the L2 error
    (about a minute for the square).
"""
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'drivers'))
PER_PAIR = {'denseGrid': False}


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


def interval(noRef):
    from pynucleus_tpu.fem import meshFactory, dofmapFactory
    mesh = meshFactory('interval', a=-1, b=1)
    for _ in range(noRef):
        mesh = mesh.refine()
    return dofmapFactory('P1', mesh)


def dense(dm, kernel, zeroExterior=True):
    import numpy as np
    from pynucleus_tpu.nl.assembly import nonlocalBuilder
    return np.asarray(nonlocalBuilder(dm, kernel, zeroExterior=zeroExterior,
                                      params=PER_PAIR).getDense().toarray())


def main():
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import pynucleus_tpu  # noqa: F401  (float64)
    from pynucleus_tpu.nl import kernels as k
    from pynucleus_tpu.nl.assembly import nonlocalBuilder
    from pynucleus_tpu.nl.problems import nonlocalMeshFactory, DIRICHLET
    from pynucleus_tpu.fem import dofmapFactory, meshFactory
    import numpy as np
    dm = interval(4)
    A = dense(dm, k.getFractionalKernel(1, 0.4, phi=k.temperedTwoPoint(2.0)),
              zeroExterior=False)
    A0 = dense(dm, k.getFractionalKernel(1, 0.4), zeroExterior=False)
    out = summary(A)
    out['far_ratio'] = float(A[0, -1] / A0[0, -1])
    print(json.dumps({'tempered_phi': out}), flush=True)
    for name, phi in (('leftRight', k.leftRightTwoPoint(1.0, 2.0, 0.5, 3.0,
                                                        0.1)),
                      ('interface', k.interfaceTwoPoint(0.3, 0.2, True,
                                                        0.05))):
        print(json.dumps({name: summary(dense(
            dm, k.getFractionalKernel(1, 0.4, phi=phi)))}), flush=True)
    print(json.dumps({'nonsym_tempered': summary(dense(
        dm, k.getFractionalKernel(1, k.constantNonSymFractionalOrder(0.25),
                                  phi=k.temperedTwoPoint(2.0))))}),
          flush=True)
    kt = k.FractionalKernel(1, k.constFractionalOrder(0.4), 0.2, k.ball2(),
                            temperedLambda=3.0)
    mesh, info = nonlocalMeshFactory.build('interval', kernel=kt,
                                           boundaryCondition=DIRICHLET,
                                           a=-1, b=1)
    for _ in range(4):
        mesh = mesh.refine()
    dmc = dofmapFactory('P1', mesh, tag=info['domain'])
    S = nonlocalBuilder(dmc, kt).getSparse()
    print(json.dumps({'tempered_k14': summary(S.toarray())}), flush=True)
    for name, kern in (
            ('logInverseDistance',
             k.getIntegrableKernel(1, 'logInverseDistance', float('inf'))),
            ('monomial', k.Kernel(1, 'monomial', float('inf'), None, 0.5,
                                  1.0, monomialPower=1.0)),
            ('polynomial', k.Kernel(1, 'polynomial', 0.3, k.ball2(), 0.5,
                                    0.0, exponentParam=0.3))):
        print(json.dumps({name: summary(dense(dm, kern, zeroExterior=False))}),
              flush=True)
    sq = meshFactory('square', N=2, ax=0, ay=0, bx=1, by=1)
    for _ in range(2):
        sq = sq.refine()
    G = np.asarray(nonlocalBuilder(
        dofmapFactory('P1', sq), k.getComplexKernel(
            2, greensLambda=-3j, phi=k.temperedTwoPoint(1.0))).getDense()
        .toarray())
    for part, D in (('re', G.real), ('im', G.imag)):
        print(json.dumps({'greens_tempered_' + part: summary(D)}), flush=True)
    import runNonlocal
    lines = {}
    for domain, kind, noRef in (('interval', 'gaussian', 6),
                                ('interval', 'exponential', 6),
                                ('square', 'gaussian', 2)):
        d, _ = runNonlocal.main([
            '--domain', domain, '--kernelType', kind, '--problem',
            'poly-Dirichlet', '--element', 'P1', '--solverType', 'lu',
            '--matrixFormat', 'sparse', '--noRef', str(noRef)])
        res = {}
        for g in d.outputGroups.values():
            res.update(g.toDict())
        lines[f'{domain}_{kind}_noRef{noRef}'] = {
            'dofs': res['dofs'],
            'L2 error interpolated': res['L2 error interpolated']}
    print(json.dumps({'run_nonlocal': lines}), flush=True)


if __name__ == '__main__':
    main()

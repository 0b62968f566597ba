#!/usr/bin/env python3
"""Outputs of the JAX package for the finite-horizon lines that
chip_smoke.py phase 17 holds the port to (its JAX_DISC, JAX_BALLS and
JAX_VAR_HORIZON pins).

    python scripts/pin_finite_horizon_jax.py [--skip-disc]

Three groups, each one JSON object per line, run on the CPU in float64:
  - the disc with its collar, `drivers/runNonlocal.py --domain disc
    --kernelType constant --horizon 0.2 --problem poly-Dirichlet --element
    P1 --solverType cg-mg --matrixFormat sparse --noRef 3`, with the ball2
    and the ballInf interaction: dofs, iterations and the L2 error
    interpolated, as the driver prints them;
  - ball1 (normalized) and the ellipse (aFac 1, bFac 0.5, not normalized)
    on squareWithInteractions(ax=0, ay=0, bx=1, by=1, horizon=0.2,
    h=0.05), P1 on every vertex (tag -1), the indicator kernel of horizon
    0.2, nonlocalBuilder(..., zeroExterior=False).getDense(): dofs, its
    Frobenius norm, ||A u|| and (A u)[:4] for u = x^2 + y^2 at the dofs;
  - the variable horizon delta(x) = 0.1 + 0.05 (x + 1) in [0.1, 0.2], s
    0.25, on the interval [-1, 1] refined 6 times (P1, interior dofs):
    getSparse, its Frobenius norm, ||A v|| and (A v)[:4] for the seeded
    v = N(0, 1) (numpy default_rng(7)), and unpreconditioned GMRES
    (tolerance 1e-10, maxIter 500) on A u = A 1: iterations and ||u||.
Each ellipse's jit programs are cached by the kernel's interaction type
alone (pynucleus_tpu/nl/kernels.py Kernel._key), so the script builds one
ellipse per process.
"""
import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def disc(interaction):
    cmd = [sys.executable, os.path.join(ROOT, 'drivers', 'runNonlocal.py'),
           '--domain', 'disc', '--kernelType', 'constant', '--horizon', '0.2',
           '--problem', 'poly-Dirichlet', '--element', 'P1', '--solverType',
           'cg-mg', '--matrixFormat', 'sparse', '--noRef', '3',
           '--interaction', interaction]
    out = subprocess.run(cmd, capture_output=True, text=True, check=True,
                         env=dict(os.environ, JAX_PLATFORMS='cpu'),
                         cwd=ROOT).stdout

    def field(name):
        return re.search(rf'^\s*{name}:\s*(\S+)', out, re.M).group(1)
    return {'line': f'disc noRef 3 {interaction}', 'dofs': int(field('dofs')),
            'iterations': int(field('iterations')),
            'L2 error interpolated': float(field('L2 error interpolated'))}


def balls():
    import numpy as np
    from pynucleus_tpu.fem import dofmapFactory
    from pynucleus_tpu.fem.meshes import squareWithInteractions
    from pynucleus_tpu.nl.kernels import (interactionFactory,
                                          getIntegrableKernel, INDICATOR)
    from pynucleus_tpu.nl.assembly import nonlocalBuilder
    mesh = squareWithInteractions(ax=0, ay=0, bx=1, by=1, horizon=0.2,
                                  h=0.05)
    dm = dofmapFactory('P1', mesh, tag=-1)
    xy = np.asarray(dm.getDoFCoordinates())
    u = xy[:, 0] ** 2 + xy[:, 1] ** 2
    for name, args, normalized in (('ball1', (), True),
                                   ('ellipse', (1.0, 0.5), False)):
        kernel = getIntegrableKernel(2, INDICATOR, 0.2,
                                     interaction=interactionFactory(name,
                                                                    *args),
                                     normalized=normalized)
        A = np.asarray(nonlocalBuilder(dm, kernel, zeroExterior=False)
                       .getDense().toarray())
        Au = A @ u
        print(json.dumps({'line': f'{name} h 0.05', 'dofs': A.shape[0],
                          'fro': float(np.linalg.norm(A)),
                          'Au_norm': float(np.linalg.norm(Au)),
                          'Au4': [float(v) for v in Au[:4]]}), flush=True)


def variableHorizon():
    import numpy as np
    import jax.numpy as jnp
    from pynucleus_tpu.fem import simpleInterval, P1_DoFMap
    from pynucleus_tpu.nl import getFractionalKernel
    from pynucleus_tpu.nl.kernels import horizonFunction
    from pynucleus_tpu.nl.assembly import nonlocalBuilder
    from pynucleus_tpu.base.solvers import solverFactory
    mesh = simpleInterval(-1.0, 1.0)
    for _ in range(6):
        mesh = mesh.refine()
    dm = P1_DoFMap(mesh)
    hf = horizonFunction(lambda x: 0.1 + 0.05 * (x[..., 0] + 1.0), 0.1, 0.2)
    A = nonlocalBuilder(dm, getFractionalKernel(1, 0.25,
                                                horizon=hf)).getSparse()
    Ah = np.asarray(A.toarray())
    v = np.random.default_rng(7).standard_normal(Ah.shape[0])
    Av = Ah @ v
    s = solverFactory.build('gmres', A=A, setup=True)
    s.tolerance, s.maxIter = 1e-10, 500
    x = np.asarray(s.solve(jnp.asarray(Ah @ np.ones(Ah.shape[0]))))
    print(json.dumps({'line': 'variable horizon noRef 6', 'dofs': Ah.shape[0],
                      'fro': float(np.linalg.norm(Ah)),
                      'Av_norm': float(np.linalg.norm(Av)),
                      'Av4': [float(t) for t in Av[:4]],
                      'gmres_iterations': int(s.iterations),
                      'x_norm': float(np.linalg.norm(x))}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--skip-disc', action='store_true')
    args = ap.parse_args()
    if not args.skip_disc:
        for interaction in ('ball2', 'ballInf'):
            print(json.dumps(disc(interaction)), flush=True)
    import jax
    jax.config.update('jax_platforms', 'cpu')
    balls()
    variableHorizon()


if __name__ == '__main__':
    main()

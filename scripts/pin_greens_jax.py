#!/usr/bin/env python3
"""Outputs of the JAX package for the complex Greens systems that
chip_smoke.py phase 16 holds the port to (its JAX_GREENS pins).

    python scripts/pin_greens_jax.py [--noRef 5]

The square (meshFactory('square', N=2), refined noRef times, P1,
Dirichlet), greens2D with greensLambda -3j and scaling 1, of an infinite
horizon and of horizon 0.45 (ball2): nonlocalBuilder(...).getDense(), its
Frobenius norm, trace and ||A v|| with A v[:4] for the seeded
v = N(0,1) + i N(0,1) (numpy default_rng(7)), then GMRES and BiCGStab
(no preconditioner, tolerance 1e-9, maxIter 300) on the load of
tests/test_complex_kernels.py:141-142: iterations, ||x|| and the relative
residual.  Runs on the CPU in float64 and prints one JSON object per
horizon.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import jax
    jax.config.update('jax_platforms', 'cpu')
    import numpy as np
    import jax.numpy as jnp
    from pynucleus_tpu.fem import meshFactory, dofmapFactory
    from pynucleus_tpu.nl.kernels import getComplexKernel
    from pynucleus_tpu.nl.assembly import nonlocalBuilder
    from pynucleus_tpu.base.solvers import solverFactory

    ap = argparse.ArgumentParser()
    ap.add_argument('--noRef', type=int, default=5)
    noRef = ap.parse_args().noRef
    mesh = meshFactory('square', N=2, ax=0, ay=0, bx=1, by=1)
    for _ in range(noRef):
        mesh = mesh.refine()
    dm = dofmapFactory('P1', mesh)
    for label, horizon in (('inf', np.inf), ('h045', 0.45)):
        kernel = getComplexKernel(2, greensLambda=-3.0j, horizon=horizon,
                                  scaling=1.0)
        A = nonlocalBuilder(dm, kernel).getDense()
        Ah = np.asarray(A.toarray())
        n = Ah.shape[0]
        rng = np.random.default_rng(7)
        v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        Av = Ah @ v
        b = np.random.RandomState(0).rand(n) \
            + 1j * np.random.RandomState(1).rand(n)
        out = {'horizon': label, 'dofs': n,
               'fro': float(np.linalg.norm(Ah)),
               'trace': [float(np.trace(Ah).real), float(np.trace(Ah).imag)],
               'Av_norm': float(np.linalg.norm(Av)),
               'Av4': [[float(z.real), float(z.imag)] for z in Av[:4]]}
        for name in ('gmres', 'bicgstab'):
            s = solverFactory.build(name, A=A, setup=True)
            s.tolerance, s.maxIter = 1e-9, 300
            x = np.asarray(s.solve(jnp.asarray(b)))
            out[name] = {'iterations': int(s.iterations),
                         'x_norm': float(np.linalg.norm(x)),
                         'residual': float(np.linalg.norm(Ah @ x - b)
                                           / np.linalg.norm(b))}
        print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()

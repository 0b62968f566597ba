"""The float32 H2corrected operator's distance from the float64 one, in the
JAX package and in the port, on the CPU.

    JAX_PLATFORMS=cpu python scripts/f32_h2corrected_gap_jax.py
        [--noRef 3 6 8]

For each depth: the fractional kernel of order 0.25 and horizon 0.4 on
nonlocalMesh's interval with its collar refined noRef times (P1 on the
interior dofs: the line of chip_smoke.py's phases 18 and 28),
'H2corrected' with params={'dtype': float32} and in float64 in both
packages.  Prints, per depth, each package's max|C32 - C64| / max|C64| of
the complement cross operator (its ring-cut entries: a float32 node at
|x - y| = delta may fall on the other side of the complement indicator),
max|A32 x - A64 x| / max|A64 x| on a cosine, and the relative distance of
the CG-Jacobi solutions (tolerance 1e-10) of A x = M 1; and the port's
float32 apply against the JAX package's.  Seconds per depth up to noRef
8; noRef 10 (5,119 dofs: phase 28's line, whose JAX gaps chip_smoke.py
pins in F28_H2C_JAX_GAPS) takes minutes.
"""
import argparse
import json

import numpy as np
import torch
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.nl.kernels import getFractionalKernel as jKernel
from pynucleus_tpu.nl.assembly import assembleNonlocal as jAssemble
from pynucleus_tpu.nl.problems import (nonlocalMeshFactory,
                                       HOMOGENEOUS_DIRICHLET as J_HD)
from pynucleus_tpu.base.solvers import solverFactory as jSolvers

from pynucleus_tpu_torch.base.solvers import solverFactory
from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
from pynucleus_tpu_torch.nl.assembly import assembleNonlocal
from pynucleus_tpu_torch.nl.kernels import getFractionalKernel
from pynucleus_tpu_torch.nl.problems import (nonlocalMesh,
                                             HOMOGENEOUS_DIRICHLET)

S, DELTA = 0.25, 0.4


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def solve(build, A, b):
    s = build('cg-jacobi', A=A, setup=True)
    s.tolerance, s.maxIter = 1e-10, 5000
    return np.asarray(s.solve(b))


def gaps(noRef):
    jk = jKernel(1, S, horizon=DELTA)
    mesh, info = nonlocalMeshFactory.build('interval', kernel=jk,
                                           boundaryCondition=J_HD, a=-1,
                                           b=1)
    tk = getFractionalKernel(1, S, horizon=DELTA)
    tmesh, tinfo = nonlocalMesh('interval', tk, HOMOGENEOUS_DIRICHLET)
    for _ in range(noRef):
        mesh, tmesh = mesh.refine(), tmesh.refine()
    jdm = jfem.P1_DoFMap(mesh, tag=info['domain'])
    tdm = P1_DoFMap(tmesh, tag=tinfo['domain'], device='cpu')
    x = np.cos(0.3 * np.arange(jdm.num_dofs))
    out = {'noRef': noRef, 'dofs': jdm.num_dofs}
    ys = {}
    for pkg in ('jax', 'port'):
        ops = {}
        for dt in (np.float32, np.float64):
            if pkg == 'jax':
                ops[dt] = jAssemble(jdm, jk, matrixFormat='H2corrected',
                                    params={'dtype': dt})
            else:
                ops[dt] = assembleNonlocal(tdm, tk,
                                           matrixFormat='H2corrected',
                                           params={'dtype': dt})
        A32, A64 = ops[np.float32], ops[np.float64]
        if pkg == 'jax':
            y32, y64 = (np.asarray(A @ jnp.asarray(x)) for A in (A32, A64))
            b = A64.mass @ jnp.ones(jdm.num_dofs)
            u32, u64 = (solve(jSolvers.build, A, b) for A in (A32, A64))
        else:
            xt = torch.as_tensor(x)
            y32, y64 = (A.matvec(xt).numpy() for A in (A32, A64))
            b = A64.mass.matvec(torch.ones(tdm.num_dofs,
                                           dtype=torch.float64))
            u32, u64 = (solve(solverFactory.build, A, b) for A in (A32, A64))
        ys[pkg] = y32
        out[pkg] = {
            'cross_gap': rel(np.asarray(A32.Cross.toarray()),
                             np.asarray(A64.Cross.toarray())),
            'apply_gap': rel(y32, y64),
            'solution_gap': float(np.linalg.norm(u32 - u64)
                                  / np.linalg.norm(u64))}
    out['port32_vs_jax32_apply'] = rel(ys['port'], ys['jax'])
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--noRef', type=int, nargs='+', default=[3, 6, 8])
    args = ap.parse_args()
    for noRef in args.noRef:
        print(json.dumps(gaps(noRef)), flush=True)


if __name__ == '__main__':
    main()

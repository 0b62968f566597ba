"""The float32 H2 operator's distance from the float64 one on the interval,
in the JAX package and in the port, on the CPU.

    JAX_PLATFORMS=cpu python scripts/f32_h2_gap_jax.py [--noRef 12 14]

For each depth: simpleInterval(-1, 1) refined noRef times, (-Delta)^0.75
(P1, infinite horizon, zero exterior), getH2 in float32 and float64 in
both packages (the JAX package with forceDeviceCSR, its device near-field
accumulator), applied to x = sin(pi linspace(-1, 1, N)) (bench.py's h2_1d
vector).  Prints, per depth, max|H32 x - H64 x| / max|H64 x| and the
diagonals' max|d32 - d64| / max|d64| of each package, and the port's
float32 operator against the JAX package's.  A few seconds to a minute
per depth (noRef 14: 16,383 dofs).
"""
import argparse
import json

import numpy as np
import torch
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.nl import getFractionalKernel as jKernel
from pynucleus_tpu.nl import assembly as jasm
from pynucleus_tpu.nl import h2 as jh2

from pynucleus_tpu_torch.interop import builderFromArrays


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def gaps(noRef):
    m = jfem.simpleInterval(-1.0, 1.0)
    for _ in range(noRef):
        m = m.refine()
    dm = jfem.P1_DoFMap(m)
    N = dm.num_dofs
    x = np.sin(np.pi * np.linspace(-1.0, 1.0, N))
    out = {}
    for dt in (np.float32, np.float64):
        Hj = jasm.nonlocalBuilder(dm, jKernel(1, 0.75), params={
            'dtype': dt, 'forceDeviceCSR': True}).getH2()
        Ht = builderFromArrays(m.vertices, m.cells, 0.75, 1, dtype=dt,
                               device='cpu').getH2()
        out[np.dtype(dt).name] = (
            np.asarray(jh2._h2_matvec(Hj, jnp.asarray(x.astype(dt)))),
            Ht.matvec(torch.as_tensor(x.astype(dt))).numpy(),
            np.asarray(Hj.diagonal), Ht.diagonal.numpy())
    (yj32, yt32, dj32, dt32), (yj64, yt64, dj64, dt64) = \
        out['float32'], out['float64']
    return {'noRef': noRef, 'dofs': N,
            'jax_apply_gap': rel(yj32, yj64), 'port_apply_gap': rel(yt32, yt64),
            'jax_diagonal_gap': rel(dj32, dj64),
            'port_diagonal_gap': rel(dt32, dt64),
            'port32_vs_jax32_apply': rel(yt32, yj32),
            'port32_vs_jax32_diagonal': rel(dt32, dj32)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--noRef', type=int, nargs='+', default=[12, 14])
    for noRef in ap.parse_args().noRef:
        print(json.dumps(gaps(noRef)), flush=True)


if __name__ == '__main__':
    main()

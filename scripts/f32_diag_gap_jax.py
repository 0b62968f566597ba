"""The float32 getDiagonal's distance from the float64 one, in the JAX
package and in the port, on the CPU.

    JAX_PLATFORMS=cpu python scripts/f32_diag_gap_jax.py [--domain interval]
        [--noRef 6 8 10]

For each depth: simpleInterval(-1, 1) or the disc circle(h=0.78) refined
noRef times, (-Delta)^0.6 (P1, infinite horizon, the zero-exterior term:
the lines of chip_smoke.py's phases 18 and 26), getDiagonal with
params={'dtype': float32} and in float64 in both packages (float64
diagonals in both dtypes, the float32 local entries summed in float64).
Prints, per depth, max|d32 - d64| / max|d64| of each package and the
port's float32 diagonal against the JAX package's.  Seconds per depth on
the interval up to noRef 10; the disc at noRef 4 about a minute.
"""
import argparse
import json

import numpy as np

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.nl import getFractionalKernel as jKernel
from pynucleus_tpu.nl import assembly as jasm

from pynucleus_tpu_torch.interop import builderFromArrays

S = 0.6


def rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def gaps(domain, noRef):
    m = jfem.simpleInterval(-1.0, 1.0) if domain == 'interval' else \
        jfem.circle(h=0.78, radius=1.0)
    for _ in range(noRef):
        m = m.refine()
    dm = jfem.P1_DoFMap(m)
    out = {}
    for dt in (np.float32, np.float64):
        dj = jasm.nonlocalBuilder(dm, jKernel(m.dim, S),
                                  params={'dtype': dt}).getDiagonal().data
        dtp = builderFromArrays(m.vertices, m.cells, S, m.dim, dtype=dt,
                                device='cpu').getDiagonal().data
        out[np.dtype(dt).name] = (np.asarray(dj), dtp.numpy())
    (dj32, dt32), (dj64, dt64) = out['float32'], out['float64']
    return {'domain': domain, 'noRef': noRef, 'dofs': dm.num_dofs,
            'dtypes': [str(dj32.dtype), str(dt32.dtype)],
            'jax_diagonal_gap': rel(dj32, dj64),
            'port_diagonal_gap': rel(dt32, dt64),
            'port32_vs_jax32': rel(dt32, dj32)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--domain', choices=('interval', 'disc'),
                    default='interval')
    ap.add_argument('--noRef', type=int, nargs='+', default=[6, 8, 10])
    args = ap.parse_args()
    for noRef in args.noRef:
        print(json.dumps(gaps(args.domain, noRef)), flush=True)


if __name__ == '__main__':
    main()

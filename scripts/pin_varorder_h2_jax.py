"""The JAX package's variable-order H2 operators on the interval: the pins
of chip_smoke.py phase 27 and the pinned JAX arrays of
tests/test_torch_varorder_h2.py.

    JAX_PLATFORMS=cpu python scripts/pin_varorder_h2_jax.py [--noRef 8]
        [--npz tests/data/varorder_h2_jax.npz]

The interval is simpleInterval(-1, 1) refined noRef + 1 times (runFractional's
interval: noRef 8 has 511 dofs), P1, zero exterior, x the standard normal
vector of numpy's default_rng(SEED).  Prints one JSON line per case: the
gaps max|H x - D x| / max|D x| of the H2 apply and of the transposed apply
(H.T, D.T) against the dense operator of the same kernel,

  LR4-d1      getH2Vector of the derivative-1 kernel of leftRight(0.25,
              0.75, 0.4, 0.6) against getDenseVector, per component
  innerOuter, innerOuter_sio, islands, islands_sio, layers, fe
              getH2 of the order (ORDER_CASES) against getDense; fe at
              noRef FE_NOREF (15 dofs) alone: beyond it the JAX getH2 of
              the fe order fails (AssertionError: its near-field nodes
              share dofs)

With --npz it writes the arrays that the tests hold the port to, for the
vector lines LR2-d1 (leftRight(0.25, 0.75), derivative 1), LR2-d2
(derivative 2) and LR4-d1: the getDense of each component kernel at noRef
4, and the getH2Vector apply and transposed apply of x at noRef 5.  About
five minutes on the CPU with --npz (the JAX package compiles each
component kernel's programs).
"""
import argparse
import json

import numpy as np
import jax
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.nl import kernels as jker
from pynucleus_tpu.nl import assembly as jasm

SEED = 27
# the orders of position: (the port's order string, or the fe spec; the
# JAX order on the JAX dofmap dm)
ORDER_CASES = {
    'innerOuter': ('innerOuter(1,0.75,0.25,0.5)',
                   lambda dm: jker.innerOuterFractionalOrder(1, 0.75, 0.25,
                                                             0.5)),
    'innerOuter_sio': ('innerOuter(1,0.75,0.25,0.5,sio=0.4,soi=0.6)',
                       lambda dm: jker.innerOuterFractionalOrder(
                           1, 0.75, 0.25, 0.5, sio=0.4, soi=0.6)),
    'islands': ('islands(0.3,0.7)',
                lambda dm: jker.islandsFractionalOrder(0.3, 0.7)),
    'islands_sio': ('islands(0.3,0.7,sio=0.4,soi=0.6)',
                    lambda dm: jker.islandsFractionalOrder(
                        0.3, 0.7, sio=0.4, soi=0.6)),
    'layers': ('layers(1,3,-1,-0.3,0.4,1,0.2,0.3,0.4,0.3,0.5,0.6,0.4,0.6,0.7)',
               lambda dm: jker.layersFractionalOrder(
                   1, [-1.0, -0.3, 0.4, 1.0],
                   [[0.2, 0.3, 0.4], [0.3, 0.5, 0.6], [0.4, 0.6, 0.7]])),
    # the interpolant of FE_ORDER on the operator's own dofmap, clipped to
    # [FE_SMIN, FE_SMAX]
    'fe': ('fe', lambda dm: jker.feFractionalOrder(
        dm.interpolate(jfem.Lambda(FE_ORDER)), FE_SMIN, FE_SMAX)),
}
FE_SMIN, FE_SMAX = 0.2, 0.8
# the largest interval on which the JAX package builds the fe order's H2
FE_NOREF = 3
# the vector lines: (leftRight parameters, derivative)
VECTOR_LINES = {'LR2-d1': ((0.25, 0.75), 1), 'LR2-d2': ((0.25, 0.75), 2),
                'LR4-d1': ((0.25, 0.75, 0.4, 0.6), 1)}


def FE_ORDER(x):
    return 0.5 + 0.3 * x[0]


def interval(noRef):
    m = jfem.simpleInterval(-1.0, 1.0)
    for _ in range(noRef + 1):
        m = m.refine()
    return m


def seeded(n):
    return np.random.default_rng(SEED).standard_normal(n)


def gap(y, ref):
    """max|y - ref| / max|ref| per column (0 where ref is 0)."""
    y, ref = np.asarray(y), np.asarray(ref)
    if y.ndim == 1:
        y, ref = y[:, None], ref[:, None]
    scale = np.abs(ref).max(axis=0)
    err = np.abs(y - ref).max(axis=0)
    return [float(e / s) if s > 0 else float(e) for e, s in zip(err, scale)]


def vectorKernel(line):
    s, der = VECTOR_LINES[line]
    return jker.getFractionalKernel(1, jker.leftRightFractionalOrder(*s),
                                    derivative=der)


def vectorGaps(line, noRef):
    dm = jfem.P1_DoFMap(interval(noRef))
    k = vectorKernel(line)
    H = jasm.nonlocalBuilder(dm, k).getH2Vector()
    D = jasm.nonlocalBuilder(dm, k).getDenseVector()
    x = jnp.asarray(seeded(dm.num_dofs))
    return {'case': line, 'noRef': noRef, 'dofs': dm.num_dofs,
            'apply': gap(H.matvec(x), D.matvec(x)),
            'transposed': gap(H.matvecTrans(x), D.matvecTrans(x))}


def orderGaps(name, noRef):
    if name == 'fe':
        noRef = FE_NOREF
    dm = jfem.P1_DoFMap(interval(noRef))
    k = jker.getFractionalKernel(1, ORDER_CASES[name][1](dm))
    H = jasm.nonlocalBuilder(dm, k).getH2()
    D = np.asarray(jasm.nonlocalBuilder(dm, k).getDense().data)
    x = seeded(dm.num_dofs)
    xj = jnp.asarray(x)
    return {'case': name, 'noRef': noRef, 'dofs': dm.num_dofs,
            'symmetric': bool(k.symmetric),
            'apply': gap(H.matvec(xj), D @ x)[0],
            'transposed': gap(H.T.matvec(xj), D.T @ x)[0]}


def vectorArrays(line):
    """The JAX arrays of a vector line: the component kernels' getDense at
    noRef 4 [V, N4, N4], the getH2Vector apply and transposed apply of the
    seeded x at noRef 5 [N5, V]."""
    k = vectorKernel(line)
    dm4 = jfem.P1_DoFMap(interval(4))
    dense = np.stack([np.asarray(jasm.nonlocalBuilder(dm4, c).getDense().data)
                      for c in k.componentKernels()])
    dm5 = jfem.P1_DoFMap(interval(5))
    H = jasm.nonlocalBuilder(dm5, k).getH2Vector()
    x = jnp.asarray(seeded(dm5.num_dofs))
    return {f'{line}/dense': dense, f'{line}/apply': np.asarray(H.matvec(x)),
            f'{line}/transposed': np.asarray(H.matvecTrans(x))}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--noRef', type=int, default=8)
    ap.add_argument('--npz', default=None)
    args = ap.parse_args()
    print(json.dumps(vectorGaps('LR4-d1', args.noRef)), flush=True)
    for name in ORDER_CASES:
        print(json.dumps(orderGaps(name, args.noRef)), flush=True)
    if args.npz:
        arrays = {}
        for line in VECTOR_LINES:
            # each component kernel compiles programs of its own: free them
            # between the lines (one process runs out of code memory)
            jax.clear_caches()
            arrays.update(vectorArrays(line))
        np.savez_compressed(args.npz, **arrays)
        print(f'wrote {args.npz}: {sorted(arrays)}', flush=True)


if __name__ == '__main__':
    main()

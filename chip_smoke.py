#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases (any failure raises; the script then exits non-zero and prints no
result line):
  1. card, CUDA and nvcc versions; build of the CUDA kernels (timed)
  2. each kernel against its plain PyTorch version on the same CUDA tensors,
     at the shapes the dense and the H2 builds of the disc at noRef 4 give
     them (float64, tolerance 1e-12 relative to the largest entry; K5's
     keys, element pairs and histogram equal), with both times
  3. the dense slice at the default noRef 5 (4465 dofs) against the JAX
     package's outputs, pinned below
  4. the dense slice at noRef 6 (18145 dofs): assembly and solve times,
     peak device memory, and the launch count of every kernel, reset to
     zero just before this run of the dense main path
  5. the H2 slice at noRef 5 against the JAX package's H2 outputs, pinned
     below; the H2 operator at noRef 6 against phase 4's dense operator
     (1e-5 relative, the Chebyshev far field), and the default (block)
     near-field engine against the flat one at noRef 6: H2 apply 1e-10
     relative, near data 1e-10 of max|data|
  6. the H2 slice at noRef 7 (73153 dofs) on the flat near-field engine
     (params={'nearEngine': 'flat'}): assembly seconds with the build
     parts, solve seconds and iterations, peak device memory, and the launch
     count of every kernel, reset to zero just before this run of the H2
     main path; CG must converge and the L2 error must be below phase 4's.
     Then the H2 kernels against their plain versions as in phase 2, at
     this path's shapes: K8 on its operator; K1's CSR targets (all calls),
     K5 (the largest segment), K6 (the largest order) and K7 on the
     recorded calls of a second build of it.  The kernel table holds these
     comparisons for K5-K8 and K1's CSR targets.
  7. the H2 CG-MG slice at noRef 5 (6 levels, every one H2) against the
     JAX package's outputs for the same driver line, pinned below
  8. the flagship, H2 CG-MG at noRef 7 (8 levels, 73153 dofs on the
     finest): assembly seconds per level and in total, hierarchy set-up
     seconds, solve seconds (the driver's, and a warm solve), iterations,
     ms per V-cycle (CUDA events), peak device memory, and the launch
     count of every kernel, reset to zero just before this run of the
     multigrid main path; it must converge within 100 iterations, with
     an L2 error within rtol 3e-2 of phase 6's (the finest operator is
     the same up to the engines' 1e-12).  Its H2 levels build their near
     field with the default block engine (K11, K12; K5 and K6 on the pairs
     that also hold orders > 8).  Then K4's two forms (ten iterations
     each, the general one with this V-cycle), K9 (P and P^T of noRef
     6 -> 7), K10 (its three modes), and K11 and K12 (their calls of the
     finest level, recorded during the run) against their plain versions
     at these shapes.
  9. the host near-field engine: the H2 slice at noRef 5 with
     params={'nearEngine': 'host'} (launch counts reset to zero just
     before it) against the JAX package's pinned H2 outputs; then the
     three engines' operators at noRef 5 agree (H2 apply 1e-10 relative,
     near data 1e-10 of max|data|).
 10. the finite-horizon path (drivers/runNonlocal.py: constant kernel,
     ball2, horizon 0.2, poly-Dirichlet with its collar): the five interval
     patch lines of tests/test_nonlocal_driver.py at noRef 6 to their
     bounds, the sparse one a path of its own (launch counts reset) whose
     K14 calls are held against the plain version; the square at noRef 2
     (sparse, cg-mg) against the JAX package's pinned outputs, with K15
     and K1's cross target held against their plain versions on all its
     calls; then the full-width line, the square at noRef 3 (sparse
     cg-mg, 4 levels, 6241 dofs; launch counts reset just before it):
     per-level assembly seconds with the host classification and pattern
     and the device fill, iterations, L2 error (below noRef 2's), peak
     device memory; K15 (its largest call) and K1's cross target (the
     calls of A_BC) against their plain versions at these shapes; the
     sparse operator against the dense one (1e-12 relative on a seeded
     vector).
 11. the serial multigrid path (drivers/runSerialGMG.py: Poisson on the
     unit square, P1, MG and FMG V-cycles with two damped-Jacobi sweeps on
     each side, CG, GMRES and BiCGStab, plain and preconditioned by one
     V-cycle): the square at noRef 4 against the JAX package's pinned
     outputs (iterations equal); then the full-width line, noRef 9 (10
     levels, 1,046,529 dofs; launch counts reset just before it) against
     the pinned JAX outputs (iterations equal, rates and residuals rtol
     1e-5, errors rtol 1e-6 above their summation floor) and the
     reference cache (tests/test_gmg.py:36-49), with the host set-up
     parts, K16's device time per level, each solve's seconds, a V-cycle
     (CUDA events) and the peak device memory; then K16 (the finest
     stiffness), K17 (one restart cycle of 10 steps and the combine) and
     K18 (10 iterations) against their plain versions at these shapes.
 12. the interval in H2 and the smooth kernels: runFractional's interval
     (s = 0.75, P1, lu, H2, noRef 6, 127 dofs; a path of its own) against
     the reference cache and the pinned JAX outputs, and its cg-mg line
     against the JAX outputs; runNonlocal's gaussian and exponential lines
     (lu, H2, fullSpace, noRef 8; each a path of its own) against their
     caches and the JAX outputs, with K1's CSR targets, K5, K6, K7, K11 and
     K12 on all their calls, K13 (a host-engine build) and K1's dense
     target, K2 and K3 (a dense build) against their plain versions with
     these profiles (erfc included, in the gaussian's 1D boundary kernel);
     the gaussian at noRef 14 (cg-jacobi, a path); H2 against dense at
     noRef 12 (8,191 dofs, 1e-5 relative) and that line's CG-MG error; then
     the full-width line, H2 CG-MG at noRef 16 (17 levels, 131,071 dofs; a
     path): per-level build parts, iterations, the warm solve, ms per
     V-cycle, peak device memory, an L2 error below noRef 12's, and K1's
     CSR targets, K5, K6, K7, K11 and K12 (their largest calls) against
     their plain versions at its shapes.
 13. variable-order and nonsymmetric kernels on the interval
     (runFractional): the six lines of tests/test_drivers_fractional.py
     :121-167 at noRef 6 (varconst, constantNonSym and twoDomainNonSym;
     dense and H2; cg-jacobi, gmres-jacobi, lu and gmres-mg; each a path
     of its own) against their pins and the pinned JAX outputs; H2 and its
     transpose against dense at noRef 12 (8,191 dofs; the transposed apply
     a path of its own, eT < max(1e-5, 3 eFwd), tests/test_h2_transpose.py
     :33); the full-width line, twoDomainNonSym gmres-mg H2 at noRef 14
     (15 levels, 32,767 dofs; a path; noRef 12 instead if its host set-up
     exceeds 300 s): iterations, errors, per-level build parts, cold and
     warm solve, ms per V-cycle, peak device memory; then K1 with the order
     codes (dense target; tree, dense and slots targets with the y shift),
     K7 with them, K19 (dense and slots targets) and K20 (noRef 12 and
     every level of the full-width line) against their plain versions.
 14. the s-derivative operators (nonlocalBuilder with getFractionalKernel(d,
     s, derivative=k)): d^2/ds^2 of s = 0.75 on the disc at noRef 5, dense
     (getDenseVector) and H2 (getH2Vector), and the three vector lines of
     leftRight on the interval at noRef 6 (getDenseVector, matvec,
     matvecTrans; each a path of its own) against the pinned JAX outputs;
     the vector kernel against central differences of the dense operators
     in (sll, srr) at noRef 8 (5e-4); dA/ds H2 against dense on the disc at
     noRef 6 (5e-4); the full-width lines, dA/ds of the flagship disc at
     noRef 7 (getH2Vector: build parts, its device time from a second build
     under torch.profiler, apply and transposed apply, peak memory) and d^2A/ds^2 of leftRight(0.25, 0.75) dense at noRef 12
     (8,191 dofs, [8191, 8191, 4]; noRef 11 if its host classification
     exceeds 300 s; each a path); then K21, K22, K23 (against torch.einsum
     too) and the power-log profile in K1, K2, K3, K6 (where called), K7
     and K12 against their plain versions.
 15. the Helmholtz path (drivers/runHelmholtz.py: S - omega^2 M + i omega
     M_B with impedance conditions, GMRES right-preconditioned by one
     V-cycle of the complex-shifted Laplacian, all complex128): the
     interval's wave and greens lines and the full-width square (noRef 8,
     4 levels, 66,049 dofs; each a path of its own) against the JAX
     driver's pinned outputs (numIter equal, the rest 1e-6 relative, the
     solution's L2 norm 1 within 1e-5), with the host set-up parts, the
     multigrid set-up, the solve, a V-cycle, a warm GMRES solve per step
     and the peak device memory; then K9's, K10's and K17's complex
     variants against their plain versions at the square's shapes (the
     finest A, P and P^T on complex vectors; n 66,049; one GMRES cycle of
     10 steps and the combine), with torch.sparse, torch.sub and
     torch.addmv beside them.
Phase 2 also holds K4's two forms, K9 (P and P^T of noRef 3 -> 4) and K10
at the noRef 4 shapes, K8 on the noRef 0, 1 and 2 operators, and K11, K12
(a default build) and K13 (a host-engine build) at the noRef 4 shapes
against their plain versions.
The last lines are the kernel table (JSON: per kernel, and per complex
variant of K9, K10 and K17, its launches on the main paths and the CUDA
launches those made, the largest error against
its plain version, its time, the plain version's, the least time the card
could take for the same work and what bounds it, and the time of one
PyTorch library call computing the same function where there is one),
the card's name and power limit, and {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# JAX package outputs of `drivers/runFractional.py --domain disc --s
# 'const(0.75)' --problem constant --element P1 --solverType cg-jacobi
# --matrixFormat dense` (default noRef 5, 4465 dofs), run on the CPU in
# float64.  The JAX run takes the per-pair path and the port the grid path
# (A differs by ~1e-7 relative), the L2 error cancels ~4 digits and CG
# stops at 1e-6, so they are held to the repo's regression tolerance
# rtol 3e-2 (nl/discretized.py reportErrors), no tighter.
JAX_NOREF5 = {
    'dofs': 4465,
    'iterations': 34,
    'errors': {
        'L2 error': 2.658977e-03,
        'relative L2 error': 5.666890e-03,
        'L2 error interpolated': 1.400320e-03,
        'relative interpolated L2 error': 2.985901e-03,
        'Linf error interpolated': 1.267110e-03,
        'relative interpolated Linf error': 3.027257e-03,
        'Hs error': 6.048856e-02,
        'relative Hs error': 6.978063e-02,
    },
}
# JAX package outputs of the same driver line with --matrixFormat H2
# (default noRef 5, host near-field engine), run on the CPU in float64.
JAX_H2_NOREF5 = {
    'dofs': 4465,
    'iterations': 34,
    'errors': {
        'L2 error': 2.6814678e-03,
        'relative L2 error': 5.7148228e-03,
        'L2 error interpolated': 1.4369129e-03,
        'relative interpolated L2 error': 3.0639282e-03,
        'Linf error interpolated': 1.2658493e-03,
        'relative interpolated Linf error': 3.0242459e-03,
        'Hs error': 6.1014731e-02,
        'relative Hs error': 7.0387631e-02,
    },
}
# JAX package outputs of the same driver line with --solverType cg-mg
# --matrixFormat H2 --noRef 5 (6 levels, every one H2; host near-field
# engine), run on the CPU in float64.  Iterations are held to +-1: the
# port's near data come from the flat device engine and differ from the
# host engine's by ~1e-12 relative, which can move a last residual that
# sits at the tolerance across it.
JAX_H2_MG_NOREF5 = {
    'dofs': 4465,
    'iterations': 7,
    'errors': {
        'L2 error': 2.681466e-03,
        'relative L2 error': 5.714818e-03,
        'L2 error interpolated': 1.436908e-03,
        'relative interpolated L2 error': 3.063918e-03,
        'Linf error interpolated': 1.265806e-03,
        'relative interpolated Linf error': 3.024142e-03,
        'Hs error': 6.101473e-02,
        'relative Hs error': 7.038763e-02,
    },
}
# JAX package outputs of `drivers/runNonlocal.py --domain square
# --kernelType constant --problem poly-Dirichlet --element P1 --solverType
# cg-mg --matrixFormat sparse` (default noRef 2, horizon 0.2, 1521 dofs),
# run on the CPU in float64; iterations +-1 and the error within the
# repo's regression tolerance rtol 3e-2.
JAX_SQUARE_NOREF2 = {'dofs': 1521, 'iterations': 7,
                     'L2 error interpolated': 3.6939776e-04}
FH_NOREF = 3
# tests/test_nonlocal_driver.py INTERVAL_CONFIGS: (kernel, format, bound)
INTERVAL_PATCH = (('constant', 'dense', 1e-12), ('constant', 'H2', 1e-12),
                  ('constant', 'sparse', 1e-12),
                  ('inverseDistance', 'dense', 1e-12),
                  ('fractional', 'dense', 1e-8))
RTOL_ERRORS = 3e-2
TOL_KERNEL = 1e-12
TOL_H2_DENSE = 1e-5
H2_NOREF = 7
H2_MAXITER = 400
MG_MAXITER = 100

# Peak rates of one H100 SXM for the bound of each kernel: HBM3 3.35 TB/s
# and float32 67 TFLOP/s outside the tensor cores; float64 34 TFLOP/s
# outside the tensor cores (NVIDIA's H100 data sheet).  A pow, log or division counts as one operation, so
# the operations bound is a lower bound.
HBM_RATE = 3.35e12
F64_PEAK = 34e12
F32_PEAK = 67e12

KERNEL_INFO = {
    'panel_scatter': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/panel_scatter.cu',
                      'pynucleus_tpu/nl/assembly.py:91'),
    'grid_distant': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/grid_distant.cu',
                     'pynucleus_tpu/nl/assembly.py:131'),
    'grid_boundary': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/grid_boundary.cu',
                      'pynucleus_tpu/nl/assembly.py:240'),
    'pcg_update': ('triton', 'pynucleus_tpu_torch/kernels/pcg_update.py',
                   'pynucleus_tpu/base/solvers.py:297'),
    'near_enum': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/near_enum.cu',
                  'pynucleus_tpu/nl/assembly.py:1280'),
    'near_enum_quad': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/near_enum.cu',
                       'pynucleus_tpu/nl/assembly.py:1506'),
    'far_field': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/far_field.cu',
                  'pynucleus_tpu/nl/assembly.py:744'),
    'h2_matvec': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/h2_matvec.cu',
                  'pynucleus_tpu/nl/h2.py:963'),
    'csr_spmv': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/csr_spmv.cu',
                 'pynucleus_tpu/base/linear_operators.py:310'),
    'jacobi_smooth': ('triton', 'pynucleus_tpu_torch/kernels/jacobi_smooth.py',
                      'pynucleus_tpu/multilevel/gmg.py:216'),
    'block_near_count': ('cuda',
                         'pynucleus_tpu_torch/kernels/csrc/near_block.cu',
                         'pynucleus_tpu/nl/assembly.py:1402'),
    'block_near_quad': ('cuda',
                        'pynucleus_tpu_torch/kernels/csrc/near_block.cu',
                        'pynucleus_tpu/nl/assembly.py:1427'),
    'tree_csr_quad': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/near_enum.cu',
                      'pynucleus_tpu/nl/assembly.py:1118'),
    'cut1d': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/cut_cells.cu',
              'pynucleus_tpu/nl/assembly.py:644'),
    'cut2d_polar': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/cut_cells.cu',
                    'pynucleus_tpu/nl/assembly.py:511'),
    'csr_scatter': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/csr_scatter.cu',
                    'pynucleus_tpu/fem/assembly.py:87'),
    'gmres_arnoldi': ('triton', 'pynucleus_tpu_torch/kernels/gmres_arnoldi.py',
                      'pynucleus_tpu/base/solvers.py:365'),
    'bicgstab_update': ('triton',
                        'pynucleus_tpu_torch/kernels/bicgstab_update.py',
                        'pynucleus_tpu/base/solvers.py:503'),
    'panel_scatter_nonsym': (
        'cuda', 'pynucleus_tpu_torch/kernels/csrc/panel_scatter_nonsym.cu',
        'pynucleus_tpu/nl/assembly.py:424'),
    'h2_matvec_T': ('cuda', 'pynucleus_tpu_torch/kernels/csrc/h2_matvec.cu',
                    'pynucleus_tpu/nl/h2.py:910'),
    'panel_scatter_vec': (
        'cuda', 'pynucleus_tpu_torch/kernels/csrc/panel_scatter_vec.cu',
        'pynucleus_tpu/nl/assembly.py:457'),
    'panel_scatter_nonsym_vec': (
        'cuda', 'pynucleus_tpu_torch/kernels/csrc/panel_scatter_vec.cu',
        'pynucleus_tpu/nl/assembly.py:484'),
    'vector_matvec': ('cuda',
                      'pynucleus_tpu_torch/kernels/csrc/vector_matvec.cu',
                      'pynucleus_tpu/base/linear_operators.py:156'),
}
# the kernels (and K1 targets) each main path must launch
DENSE_PATH = ('panel_scatter', 'grid_distant', 'grid_boundary', 'pcg_update',
              'panel_scatter:dense', 'pcg_update:jacobi')
H2_PATH = ('panel_scatter', 'pcg_update', 'near_enum', 'near_enum_quad',
           'far_field', 'h2_matvec', 'panel_scatter:slots',
           'panel_scatter:tree', 'pcg_update:jacobi')
MG_PATH = ('panel_scatter', 'pcg_update', 'near_enum', 'near_enum_quad',
           'far_field', 'h2_matvec', 'csr_spmv', 'jacobi_smooth',
           'block_near_count', 'block_near_quad', 'panel_scatter:slots',
           'panel_scatter:tree', 'pcg_update:general')
HOST_PATH = ('panel_scatter', 'pcg_update', 'tree_csr_quad', 'far_field',
             'h2_matvec', 'panel_scatter:slots', 'panel_scatter:tree',
             'pcg_update:jacobi')
INTERVAL_PATH = ('panel_scatter', 'cut1d', 'csr_spmv', 'panel_scatter:slots',
                 'panel_scatter:cross')
NONLOCAL_PATH = ('panel_scatter', 'pcg_update', 'csr_spmv', 'jacobi_smooth',
                 'cut2d_polar', 'panel_scatter:slots', 'panel_scatter:cross',
                 'pcg_update:general')
FLAT = {'nearEngine': 'flat'}
HOST = {'nearEngine': 'host'}
TOL_ENGINES = 1e-10
# where the kernel table's comparison with the plain version was made
COMPARED_AT = {
    'panel_scatter': 'disc noRef 4 (dense target), '
                     f'noRef {H2_NOREF} (CSR targets, all calls), square '
                     f'noRef {FH_NOREF} horizon 0.2 (cross target, A_BC)',
    'grid_distant': 'disc noRef 4, all calls, and an order-6 window',
    'grid_boundary': 'disc noRef 4',
    'pcg_update': f'disc noRef {H2_NOREF}, 10 iterations of each form (the '
                  'general one with the flagship V-cycle, timed with a '
                  'diagonal M)',
    'near_enum': f'disc noRef {H2_NOREF}, its largest segment',
    'near_enum_quad': f'disc noRef {H2_NOREF}, its largest order',
    'far_field': f'disc noRef {H2_NOREF}',
    'h2_matvec': f'disc noRef {H2_NOREF}, per apply of 10',
    'csr_spmv': f'disc noRef {H2_NOREF}: P x and P^T r of noRef '
                f'{H2_NOREF - 1} -> {H2_NOREF}, per pair of products',
    'jacobi_smooth': f'disc noRef {H2_NOREF}: its three modes, per set',
    'block_near_count': f'disc noRef {H2_NOREF}, the finest level of the '
                        'flagship (its one call)',
    'block_near_quad': f'disc noRef {H2_NOREF}, the finest level of the '
                       'flagship (its one call)',
    'tree_csr_quad': 'disc noRef 4, a host-engine build, all calls',
    'cut1d': 'interval noRef 6 (horizon 0.2, sparse), all calls',
    'cut2d_polar': f'square noRef {FH_NOREF} (horizon 0.2, sparse), its '
                   'largest call',
    'csr_scatter': 'the Poisson square at noRef 9: the finest stiffness (its '
                   'one call), per call',
    'gmres_arnoldi': 'the Poisson square at noRef 9: one restart cycle of 10 '
                     'steps and the combine, per cycle',
    'bicgstab_update': 'the Poisson square at noRef 9: 10 iterations',
    'panel_scatter_nonsym': 'interval twoDomainNonSym(0.25,0.75) and '
                            'constantNonSym(0.25): the dense target on all '
                            'calls of the noRef 6 dense builds and the '
                            'largest of noRef 12, the slots target on the '
                            'largest call of the noRef 14 gmres-mg H2 line',
    'h2_matvec_T': 'interval twoDomainNonSym(0.25,0.75): noRef 12, and '
                   'every level of the noRef 14 gmres-mg H2 line, timed on '
                   'the finest, per apply',
}


def log(*a):
    print(*a, flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60)


def slice_argv(noRef, fmt='dense', maxiter=100, solver='cg-jacobi'):
    return ['--domain', 'disc', '--s', 'const(0.75)', '--problem', 'constant',
            '--element', 'P1', '--solverType', solver, '--matrixFormat',
            fmt, '--noRef', str(noRef), '--maxiter', str(maxiter), '--device',
            'cuda']


# ------------------------------------------------------- bound of a kernel

def nbytes(*ts):
    """Bytes of the tensors among ts (tuples are walked)."""
    import torch
    n = 0
    for t in ts:
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
        elif isinstance(t, (tuple, list)):
            n += nbytes(*t)
        elif isinstance(t, dict):
            n += nbytes(*t.values())
    return n


def result(err, ms, plain_ms, work, library_ms=None):
    """A kernel's comparison: max abs error, kernel and plain ms, the work
    of the timed calls as [(bytes, operations, peak rate)], one PyTorch
    library call's ms."""
    return {'err': err, 'ms': ms, 'plain_ms': plain_ms, 'work': work,
            'library_ms': library_ms}


def merge(*rs):
    return result(max(r['err'] for r in rs), sum(r['ms'] for r in rs),
                  sum(r['plain_ms'] for r in rs),
                  [w for r in rs for w in r['work']])


def bound(work):
    """(ms, 'bytes' or 'operations'): the least time the card could take
    for the work, per call the larger of its bytes over HBM_RATE (each
    input read once, each output written once) and its operations over
    the peak rate of their type, summed over the calls."""
    tot = byBytes = byOps = 0.0
    for b, ops, peak in work:
        tb, to = b / HBM_RATE * 1e3, ops / peak * 1e3
        tot += max(tb, to)
        if tb >= to:
            byBytes += tb
        else:
            byOps += to
    return tot, ('bytes' if byBytes >= byOps else 'operations')


def panel_work(args):
    """K1 (any target) on recorded args (N or nnz+1, vertices, vi1, vi2,
    ..., w, PSIP, profile): per pair and node the positions, r^2, gamma
    (one pow, exp or erfc), the normal factor and nPSI^2 multiply-adds;
    the touched entries are read and written once."""
    vertices, vi1, vi2, normals = args[1], args[2], args[3], args[6]
    w, PSIP = args[-3], args[-2]
    P, Q, nn, dim = vi1.shape[0], w.shape[0], PSIP.shape[1], \
        vertices.shape[1]
    ops = P * Q * (2 * dim * (vi1.shape[1] + vi2.shape[1]) + 3 * dim + 3
                   + 2 * nn + (3 * dim + 2 if normals is not None else 0))
    return (nbytes(args[1:]) + 16 * P * nn, ops, F64_PEAK)


# ----------------------------------------------------------------- phase 2

def timed(fn):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def _clone(a):
    import torch
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, tuple):
        items = tuple(_clone(b) for b in a)
        # a named tuple (the kernels' Profile) keeps its type
        return type(a)(*items) if hasattr(a, '_fields') else items
    if isinstance(a, dict):
        return {k: _clone(v) for k, v in a.items()}
    return a


class ArgRecorder:
    """Replaces a kernel wrapper of a module by one that records cloned
    arguments of every call of the main path (and then makes the call).
    For a kernel that adds into its first argument (``dataFirst``: dense A
    [N, N], A_BC [N, NB] or CSR data [nnz+1]) that one is recorded by its
    shape.  With ``size``, only the call of the largest ``size(*args)`` is
    kept."""

    def __init__(self, module, name, dataFirst=False, size=None):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.dataFirst, self.size = dataFirst, size
        self.calls = []
        self.largest = -1

    def _record(self, args, kw):
        if self.dataFirst:
            args = (tuple(args[0].shape),) + _clone(args[1:])
        else:
            args = _clone(args)
        return args, _clone(kw)

    def __enter__(self):
        def rec(*args, **kw):
            if self.size is None:
                self.calls.append(self._record(args, kw))
            else:
                size = self.size(*args)
                if size > self.largest:
                    self.largest = size
                    self.calls = [self._record(args, kw)]
            return self.orig(*args, **kw)
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


# the H2 build's kernel wrappers (nl.assembly): K1's CSR targets, K6, K5
# and K7 (the flat engine's build), K11-K13 (the block and host engines);
# those of CSR_DATA add into the near data [nnz+1]
H2_CSR = ('panel_scatter_slots', 'panel_scatter_tree', 'near_enum_quad')
H2_BUILD = H2_CSR + ('near_enum', 'far_field')
ENGINE_KERNELS = ('block_near_count', 'block_near_quad', 'tree_csr_quad')
CSR_DATA = H2_CSR + ENGINE_KERNELS[1:]


def record_h2_build(build, names=H2_BUILD, largestOnly=False):
    """Runs ``build()``, an H2 build, with the calls of the wrappers
    ``names`` recorded; with ``largestOnly`` K5 keeps only its largest
    segment and K6 only its largest order.  Returns (what build returned,
    the recorders)."""
    import contextlib
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    sizes = {'near_enum': lambda cum, *a: int(cum[-1]),
             'near_enum_quad': lambda data, ids, *a: ids.shape[0]} \
        if largestOnly else {}
    with contextlib.ExitStack() as stack:
        recs = {n: stack.enter_context(ArgRecorder(
            asm, n, dataFirst=n in CSR_DATA, size=sizes.get(n)))
            for n in names}
        H = build()
    torch.cuda.synchronize()
    return H, recs


def compare_target_kernel(name, calls, kernel, plain, work):
    """Recorded calls of a kernel that adds into its first argument
    (recorded by its shape: dense A, A_BC or CSR data [nnz+1]) through the
    kernel and through the plain version, the calls of one shape all into
    one zero tensor each way (after an untimed warm-up call of each); CSR
    data compared on its nnz real slots.  Returns the result() with
    ``work(args)`` of each call's recorded args."""
    import torch
    byShape = {}
    for c in calls:
        byShape.setdefault(c[0][0], []).append(c)
    dev = next(a.device for a in calls[0][0] if isinstance(a, torch.Tensor))
    worst_abs = worst_rel = ms = plain_ms = 0.0
    for shape, group in byShape.items():
        Dk = torch.zeros(shape, dtype=torch.float64, device=dev)
        Dp = torch.zeros_like(Dk)
        (_, *args0), kw0 = group[0]
        kernel(torch.zeros_like(Dk), *args0, **kw0)
        plain(torch.zeros_like(Dk), *args0, **kw0)
        for (_, *args), kw in group:
            ms += timed(lambda: kernel(Dk, *args, **kw))
            plain_ms += timed(lambda: plain(Dp, *args, **kw))
        if len(shape) == 1:
            Dk, Dp = Dk[:-1], Dp[:-1]
        err = float((Dk - Dp).abs().max())
        scale = float(Dp.abs().max())
        if not (scale > 0 and err <= TOL_KERNEL * scale):
            raise AssertionError(f'{name}: kernel vs plain max err {err} '
                                 f'(max {scale}) on {shape}')
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale)
    log(f'  {name}: {len(calls)} calls on {len(byShape)} targets, max abs '
        f'err {worst_abs:.3e} (rel {worst_rel:.3e}), kernel {ms:.3f} ms, '
        f'plain {plain_ms:.3f} ms')
    return result(worst_abs, ms, plain_ms, [work(c[0]) for c in calls])


def enum_quad_work(args):
    """K6 on recorded args (nnz+1, ids, pT, ..., vertices, cells, ...,
    w, PSIP, profile): K1's quadrature body per element (two cells), the
    touched entries read and written once."""
    ids, vertices, cells, w, PSIP = args[1], args[12], args[13], args[-3], \
        args[-2]
    n, Q, nn, dim, nv = ids.shape[0], w.shape[0], PSIP.shape[1], \
        vertices.shape[1], cells.shape[1]
    ops = n * Q * (4 * dim * nv + 3 * dim + 3 + 2 * nn)
    return (nbytes(args[1:]) + 16 * n * nn, ops, F64_PEAK)


def compare_h2_build(recs):
    """K1's CSR targets, K5, K6 and K7 on their recorded calls against
    their plain versions, each after an untimed warm-up call; returns
    {name: result()}."""
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    for n in H2_BUILD:
        if not recs[n].calls:
            raise AssertionError(f'{n}: the build made no call of it')
    out = {}
    for n in H2_CSR:
        out[n] = compare_target_kernel(
            n, recs[n].calls, getattr(asm, n), getattr(asm, '_' + n + '_plain'),
            enum_quad_work if n == 'near_enum_quad' else panel_work)

    ms = plain_ms = 0.0
    work = []
    for args, kw in recs['near_enum'].calls:
        T = int(args[0][-1])
        # per element: keys and pT written (5 B), about 45 float32
        # operations of the order model (distance, log, two ceil'd ratios)
        work.append((nbytes(args) + 5 * T + 512, 45 * T, F32_PEAK))
        asm.near_enum(*args), asm._near_enum_plain(*args, T)
        got, ref = [], []
        ms += timed(lambda: got.append(asm.near_enum(*args)))
        plain_ms += timed(lambda: ref.append(asm._near_enum_plain(*args, T)))
        for what, a, b in zip(('keys', 'pT', 'hist'), got[0], ref[0]):
            if not torch.equal(a, b):
                raise AssertionError(f'near_enum: {what} differ from the '
                                     'plain version')
    log(f"  near_enum: {len(recs['near_enum'].calls)} calls, "
        f"{recs['near_enum'].largest if recs['near_enum'].size else 'all'} "
        f'elements, keys, pT and histogram equal, kernel {ms:.3f} ms, plain '
        f'{plain_ms:.3f} ms')
    out['near_enum'] = result(0.0, ms, plain_ms, work)

    out['far_field'] = compare_far_field(recs['far_field'].calls)
    return out


def compare_far_field(calls, label='far_field'):
    """K7 on recorded calls (gi, gj, profile[, order]) against its plain
    version, each after an untimed warm-up call; per entry r^2 and one
    profile evaluation (a variable order's VO_EVAL_OPS)."""
    import pynucleus_tpu_torch.nl.assembly as asm
    worst = ms = plain_ms = 0.0
    work = []
    for args, kw in calls:
        P, M, dim = args[0].shape
        order = args[3] if len(args) > 3 else kw.get('order')
        work.append((nbytes(args[:2]) + 8 * P * M * M,
                     P * M * M * (3 * dim + (VO_EVAL_OPS if order is not None
                                             else 1)), F64_PEAK))
        asm.far_field(*args, **kw), asm._far_field_plain(*args, **kw)
        got, ref = [], []
        ms += timed(lambda: got.append(asm.far_field(*args, **kw)))
        plain_ms += timed(lambda: ref.append(asm._far_field_plain(*args,
                                                                  **kw)))
        err = float((got[0] - ref[0]).abs().max())
        scale = float(ref[0].abs().max())
        if not (scale > 0 and err <= TOL_KERNEL * scale):
            raise AssertionError(f'{label}: max err {err} (max {scale})')
        worst = max(worst, err)
    log(f"  {label}: {len(calls)} calls, max abs err "
        f'{worst:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms')
    return result(worst, ms, plain_ms, work)


# per element of the near field's order model: the cell-pair validity (9
# vertex and 2 dpe node comparisons) and the float32 order (about 45
# operations: distance, log, two ceil'd ratios, the snap)
ENUM_OPS = 60


def block_count_work(args):
    """K11 on recorded args (offI, offJ, n1, n2, I, J, ncArr, cells,
    cellNodes, centers, logh, consts): the tables read once, the counts
    written once; the validity and order model per element."""
    n1, n2 = args[2], args[3]
    T = int((n1.long() * n2.long()).sum())
    return (nbytes(args) + 20 * args[0].shape[0], ENUM_OPS * T, F32_PEAK)


def block_quad_work(args):
    """K12 on recorded args (nnz+1, pairs, ncArr, cells, cellNodes,
    centers, logh, consts, vertices, vols, dofs, treePos, rules, profile):
    the order model per element; per element of a requested order K1's
    quadrature body (counted by K11's plain version on the same pairs);
    the tables read once, each pair's block(s) read and written once."""
    import pynucleus_tpu_torch.nl.assembly as asm
    pairs, tabs, rules = args[1], args[2:8], args[12]
    cells, vertices, dofs = args[3], args[8], args[10]
    counts = asm._block_near_count_plain(*pairs[:6], *tabs).sum(0)
    nv, dim, nn = cells.shape[1], vertices.shape[1], (2 * dofs.shape[1]) ** 2
    T = int((pairs[2].long() * pairs[3].long()).sum())
    ops = ENUM_OPS * T
    for o, (bx, by, w, PSIP) in rules.items():
        ops += int(counts[o // 2 - 1]) * w.shape[0] * (
            4 * dim * nv + 3 * dim + 3 + 2 * nn)
    nI, nJ, I, J = pairs[12].long(), pairs[13].long(), pairs[4], pairs[5]
    blockEntries = int((nI * nJ * (1 + (I != J).long())).sum())
    return (nbytes(args[1:]) + 16 * blockEntries, ops, F64_PEAK)


def tree_quad_work(args):
    """K13 on recorded args (nnz+1, c1, c2, I, J, offF, offB, sf,
    vertices, cells, vols, dofs, tables, bary_x, bary_y, w, PSIP,
    profile): K1's quadrature body per element, the touched entries read
    and written once."""
    c1, vertices, cells, w, PSIP = args[1], args[8], args[9], args[-3], \
        args[-2]
    n, Q, nn, dim, nv = c1.shape[0], w.shape[0], PSIP.shape[1], \
        vertices.shape[1], cells.shape[1]
    ops = n * Q * (4 * dim * nv + 3 * dim + 3 + 2 * nn)
    return (nbytes(args[1:]) + 16 * n * nn, ops, F64_PEAK)


def compare_block_count(calls):
    """K11 on its recorded calls against the plain version (counts equal),
    after an untimed call of each; returns (result(), the counts summed
    over the calls by class)."""
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    ms = plain_ms = 0.0
    total = 0
    for args, kw in calls:
        asm.block_near_count(*args), asm._block_near_count_plain(*args)
        got, ref = [], []
        ms += timed(lambda: got.append(asm.block_near_count(*args)))
        plain_ms += timed(lambda: ref.append(
            asm._block_near_count_plain(*args)))
        if not torch.equal(got[0], ref[0]):
            raise AssertionError('block_near_count: counts differ from the '
                                 'plain version')
        total = total + ref[0].sum(0).cpu()
    log(f'  block_near_count: {len(calls)} calls, '
        f'{sum(c[0][0].shape[0] for c in calls)} pairs, counts equal (by '
        f'class 2/4/6/8/>8: {total.tolist()}), kernel {ms:.3f} ms, plain '
        f'{plain_ms:.3f} ms')
    return result(0.0, ms, plain_ms,
                  [block_count_work(c[0]) for c in calls]), total.tolist()


def compare_engines(recs, names):
    """Kernels ``names`` among K11-K13 on their recorded calls against
    their plain versions; returns {name: result()}."""
    import pynucleus_tpu_torch.nl.assembly as asm
    out = {}
    for n in names:
        if not recs[n].calls:
            raise AssertionError(f'{n}: the build made no call of it')
    if 'block_near_count' in names:
        out['block_near_count'] = compare_block_count(
            recs['block_near_count'].calls)[0]
    for n, work in (('block_near_quad', block_quad_work),
                    ('tree_csr_quad', tree_quad_work)):
        if n in names:
            out[n] = compare_target_kernel(n, recs[n].calls, getattr(asm, n),
                                        getattr(asm, '_' + n + '_plain'),
                                        work)
    return out


def compare_operators(label, Ha, Hb, seed):
    """Two H2 operators of one mesh from two near-field engines: the
    apply to TOL_ENGINES relative, the near data to TOL_ENGINES of
    max|data|."""
    import torch
    x = torch.randn(Ha.num_rows, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(seed))
    ya = Ha.matvec(x)
    rel = float(torch.linalg.norm(Hb.matvec(x) - ya) / torch.linalg.norm(ya))
    da, db = Ha.Anear.dataT, Hb.Anear.dataT
    dErr = float((da - db).abs().max() / da.abs().max())
    if not (rel <= TOL_ENGINES and dErr <= TOL_ENGINES):
        raise AssertionError(f'{label}: apply {rel}, near data {dErr} '
                             f'(> {TOL_ENGINES})')
    log(f'  {label}: apply relative error {rel:.3e}, near data {dErr:.3e} '
        f'of max|data| (<= {TOL_ENGINES})')


def h2_matvec_work(H):
    """K8 per apply: x read and y written, the operator's arrays read
    once; the near products, the leaf moments and leaf outputs, the up
    and down transfers and the far blocks."""
    A = H.Anear
    b = 16 * H.num_rows + nbytes(
        A.perm, A.rowNode, A.indptrT, A.tStartRow, A.tLen, A.rowLen,
        A.tmplStart, A.tmplAll, A.dataZ, H.leafPhi, H.leafNode, H.Ttr,
        H.parent, H.Kall, H.src, H.dst)
    M = H.M
    ops = 2 * A.nnz + 4 * H.L * H.nbar * M + 4 * M * M * H.nNodes \
        + 2 * M * M * H.Kall.shape[0]
    return (b, ops, F64_PEAK)


def compare_h2_matvec(H, reps=10, label=''):
    """K8: ``reps`` applies of the operator H each way, after one untimed
    apply of each; returns the result() per apply."""
    import torch
    from pynucleus_tpu_torch.nl import h2
    x = torch.randn(H.num_rows, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(0))
    yk = torch.empty_like(x)
    h2.h2_matvec(H, x, out=yk), h2._h2_matvec_plain(H, x)
    ms = timed(lambda: [h2.h2_matvec(H, x, out=yk) for _ in range(reps)])
    yp = []
    plain_ms = timed(lambda: [yp.append(h2._h2_matvec_plain(H, x))
                              for _ in range(reps)])
    err = float((yk - yp[-1]).abs().max())
    scale = float(yp[-1].abs().max())
    if not (scale > 0 and err <= TOL_KERNEL * scale):
        raise AssertionError(f'h2_matvec: max err {err} (max {scale})')
    log(f'  h2_matvec{label}: {reps} applies, max abs err {err:.3e} (rel '
        f'{err / scale:.3e}), kernel {ms / reps:.3f} ms, plain '
        f'{plain_ms / reps:.3f} ms per apply')
    return result(err, ms / reps, plain_ms / reps, [h2_matvec_work(H)])


def compare_csr_spmv(P, reps=10, dtype=None, extra=()):
    """K9 on a prolongation P and its transpose (and on the operators
    ``extra``): y = A x and y += A x against the plain version; then
    ``reps`` products y = A x each way and through one torch.sparse CSR
    product (the library's yardstick, never used by the port), after an
    untimed call of each.  x is float64, or ``dtype`` (complex128: K9's
    complex variant, the library product on the data cast to it).
    Returns the result() per set of products."""
    import torch
    from pynucleus_tpu_torch.base.linear_operators import (csr_spmv,
                                                           _csr_spmv_plain)
    dtype = dtype or torch.float64
    g = torch.Generator('cuda').manual_seed(2)
    worst = ms = plain_ms = lib_ms = 0.0
    work = []
    for A in (P, P.transposed()) + tuple(extra):
        def vec(n):
            return torch.randn(n, dtype=dtype, device='cuda', generator=g)
        x, y0 = vec(A.num_columns), vec(A.num_rows)
        args = (A.indptr, A.indices, A.data, x)
        for acc in (False, True):
            yk, yp = y0.clone(), y0.clone()
            csr_spmv(*args, out=yk, accumulate=acc)
            _csr_spmv_plain(*args, yp, acc)
            err = float((yk - yp).abs().max())
            scale = float(yp.abs().max())
            if not (scale > 0 and err <= TOL_KERNEL * scale):
                raise AssertionError(f'csr_spmv: max err {err} (max {scale})')
            worst = max(worst, err)
        S = torch.sparse_csr_tensor(A.indptr, A.indices, A.data.to(dtype),
                                    size=A.shape)
        yl = torch.mv(S, x)
        csr_spmv(*args, out=yk)
        if not float((yl - yk).abs().max()) <= \
                TOL_KERNEL * float(yl.abs().max()):
            raise AssertionError('csr_spmv: the library product differs')
        _csr_spmv_plain(*args, yp)
        ms += timed(lambda: [csr_spmv(*args, out=yk)
                             for _ in range(reps)]) / reps
        plain_ms += timed(lambda: [_csr_spmv_plain(*args, yp)
                                   for _ in range(reps)]) / reps
        lib_ms += timed(lambda: [torch.mv(S, x) for _ in range(reps)]) / reps
        # a real product 2 operations an entry, a real entry times a complex
        # value 4, a complex product 8
        opsPerEntry = 2 * (1 + x.is_complex()) * (1 + A.data.is_complex())
        work.append((nbytes(A.indptr, A.indices, A.data, x)
                     + x.element_size() * A.num_rows, opsPerEntry * A.nnz,
                     F64_PEAK))
    log(f'  csr_spmv ({dtype}): P {tuple(P.shape)} and P^T, nnz {P.nnz}'
        + ''.join(f', A {tuple(A.shape)} nnz {A.nnz} ({A.data.dtype})'
                  for A in extra)
        + f', max abs err {worst:.3e}, kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, torch.sparse {lib_ms:.4f} ms per set of '
        'products')
    return result(worst, ms, plain_ms, work, lib_ms)


def compare_jacobi_smooth(n, reps=10, dtype=None):
    """K10: its three modes on random vectors [n] (float64, or ``dtype``:
    complex128, the complex variant) against the plain version, ``reps``
    passes of each mode each way after an untimed one; returns the result()
    per set of three passes, with the time of the library call of the
    residual mode, one torch.sub (never used by the port), beside that
    mode's own."""
    import torch
    from pynucleus_tpu_torch.multilevel.gmg import (jacobi_smooth,
                                                    _jacobi_smooth_plain)
    dtype = dtype or torch.float64
    cplx = dtype.is_complex
    g = torch.Generator('cuda').manual_seed(3)
    b, Ax, x0 = (torch.randn(n, dtype=dtype, device='cuda', generator=g)
                 for _ in range(3))
    Dinv = torch.rand(n, dtype=torch.float64, device='cuda', generator=g) \
        + 0.5
    if cplx:
        Dinv = torch.complex(Dinv, torch.rand(n, dtype=torch.float64,
                                              device='cuda', generator=g))
    om = torch.tensor([2.0 / 3.0], dtype=torch.float64, device='cuda')
    worst = ms = plain_ms = 0.0
    work = []
    # vectors read or written, and operations (a complex product 6, a
    # complex sum 2, a real times a complex 2)
    modes = (('zero', 3, 8 if cplx else 2), ('residual', 3, 2 if cplx else 1),
             ('update', 5, 12 if cplx else 4))
    for mode, nvec, ops in modes:
        xk, xp = x0.clone(), x0.clone()
        jacobi_smooth(mode, xk, b, Ax=Ax, Dinv=Dinv, omega=om)
        _jacobi_smooth_plain(mode, xp, b, Ax=Ax, Dinv=Dinv, omega=om)
        err = float((xk - xp).abs().max())
        scale = float(xp.abs().max())
        if not (scale > 0 and err <= TOL_KERNEL * scale):
            raise AssertionError(f'jacobi_smooth ({mode}): max err {err}')
        worst = max(worst, err)
        ms += timed(lambda: [jacobi_smooth(mode, xk, b, Ax=Ax, Dinv=Dinv,
                                           omega=om)
                             for _ in range(reps)]) / reps
        plain_ms += timed(lambda: [_jacobi_smooth_plain(
            mode, xp, b, Ax=Ax, Dinv=Dinv, omega=om)
            for _ in range(reps)]) / reps
        work.append((b.element_size() * nvec * n, ops * n, F64_PEAK))
    torch.sub(b, Ax, out=xp)
    lib_ms = timed(lambda: [torch.sub(b, Ax, out=xp)
                            for _ in range(reps)]) / reps
    res_ms = timed(lambda: [jacobi_smooth('residual', xk, b, Ax=Ax)
                            for _ in range(reps)]) / reps
    log(f'  jacobi_smooth ({dtype}): n {n}, three modes, max abs err '
        f'{worst:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per set; '
        f'residual mode {res_ms:.4f} ms, torch.sub {lib_ms:.4f} ms')
    r = result(worst, ms, plain_ms, work, lib_ms)
    r['residual_ms'] = res_ms
    return r


def grid_distant_work(args):
    """K2 on recorded args (N, X, ccf, vols, dofs, PhiXw, PhiX, PsiYw, w,
    t_lo, t_hi, profile): per cell pair of the window Q^2 kernel values
    (one pow or exp each) and the two contractions with the dpe shape functions, per
    cell its dpe^2 block; the touched entries read and written once."""
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    X, ccf, dofs, t_lo, t_hi = args[1], args[2], args[4], args[9], args[10]
    nC, Q, dim = X.shape
    dpe = dofs.shape[1]
    d2 = asm._d2f32(ccf, torch.arange(nC, device=ccf.device))
    pairs = int(((d2 >= t_lo) & (d2 < t_hi)).sum())
    ops = pairs * (Q * Q * (3 * dim + 5) + 2 * Q * Q * dpe
                   + 2 * Q * dpe * dpe) + 3 * nC * Q * dpe * dpe
    return (nbytes(args[1:]) + 16 * (pairs + nC) * dpe * dpe, ops, F64_PEAK)


def grid_boundary_work(args):
    """K3 on recorded args (N, X, vols, dofs, Ysurf, svolw2, normals,
    exclPtr, exclIdx, PhiXw, PhiX, profile, useNormals): a kernel value (and
    the normal factor) per cell node and surface node not excluded, per
    cell its dpe^2 block."""
    X, dofs, Ysurf, exclIdx, useNormals = args[1], args[3], args[4], \
        args[8], args[12]
    nC, Q1, dim = X.shape
    S, Q2, _ = Ysurf.shape
    dpe = dofs.shape[1]
    evals = (nC * S - exclIdx.numel()) * Q1 * Q2
    ops = evals * (3 * dim + 3 + (3 * dim + 2 if useNormals else 0)) \
        + 3 * nC * Q1 * dpe * dpe
    return (nbytes(args[1:]) + 16 * nC * dpe * dpe, ops, F64_PEAK)


def compare_pcg(name, fns, states, M=None, iters=10):
    """``iters`` PCG iterations through fns[0] (the kernel) on states[0],
    with A p by the operator ``M[0]`` and, for the general form, the
    preconditioner ``M[1]``; each iteration the plain version fns[1] takes
    the same step from a copy of the kernel's state into states[1] (the
    same inputs: two separate trajectories would drift apart by rounding,
    most where the residual has shrunk), and x, r, p and the history must
    agree after it.  Returns (max abs err, kernel ms, plain ms), the times
    summed over the iterations (the operator's apply is not timed, the
    preconditioner's is)."""
    A, prec = M
    ms = plain_ms = worst = 0.0
    pre = [prec] if prec is not None else []
    for it in range(iters):
        A.matvec(states[0][3], out=states[0][4])
        for vk, vp in zip(*states):
            vp.copy_(vk)
        args = [st[:5] + pre + st[5:] for st in states]
        ms += timed(lambda: fns[0](*args[0], it))
        plain_ms += timed(lambda: fns[1](*args[1], it))
        for what, i in (('x', 0), ('r', 1), ('p', 3), ('hist', -1)):
            vk = states[0][i][:it + 2] if what == 'hist' else states[0][i]
            vp = states[1][i][:it + 2] if what == 'hist' else states[1][i]
            err = float((vk - vp).abs().max())
            scale = float(vp.abs().max())
            if not err <= TOL_KERNEL * scale:
                raise AssertionError(f'{name}: {what} max err {err} '
                                     f'(max {scale}) at iteration {it}')
            worst = max(worst, err)
    return worst, ms, plain_ms


def pcg_state(b, z0, extra):
    """PCG start from x = 0: [x, r, z, p, Ap, *extra, scal, hist] with
    z0 = M b given."""
    import torch
    x = torch.zeros_like(b)
    r = b.clone()
    z = z0.clone()
    p = z.clone()
    rz = torch.dot(r, z)
    scal = torch.stack([rz, torch.zeros_like(rz), torch.sqrt(rz)])
    hist = torch.full((12,), float('nan'), dtype=b.dtype, device=b.device)
    hist[0] = scal[2]
    return [x, r, z, p, torch.empty_like(b)] + extra + [scal, hist]


def compare_pcg_forms(A, b, M, label, iters=10):
    """K4's two forms against their plain versions, ``iters`` iterations
    each (fewer than the solve needs: a converged residual is rounding
    noise) with A p of the operator A: the Jacobi form with invD the inverse
    diagonal of M's finest level, the general form with M (a multigrid
    preconditioner, whose K8, K9 and K10 launches are no main path's);
    the general form's time is taken with M = that diagonal (one
    torch.mul), so that it is K4's own.  Returns the merged result()."""
    from pynucleus_tpu_torch.base import solvers
    from pynucleus_tpu_torch.base.linear_operators import \
        Diagonal_LinearOperator
    n = b.shape[0]
    invD = M.levels.Dinvs[-1]
    Mdiag = Diagonal_LinearOperator(invD)
    jac = (solvers.pcg_update, solvers._pcg_update_plain)
    gen = (solvers.pcg_update_prec, solvers._pcg_update_prec_plain)
    # warm-up (Triton compiles the kernels at their first launch)
    for fn in jac:
        w = pcg_state(b, invD * b, [invD])
        A.matvec(w[3], out=w[4])
        fn(*w, 0)
    for fn in gen:
        w = pcg_state(b, M.matvec(b), [])
        A.matvec(w[3], out=w[4])
        fn(*w[:5], M, *w[5:], 0)
    errJ, msJ, plainJ = compare_pcg('pcg_update (Jacobi form)', jac, [
        pcg_state(b, invD * b, [invD]) for _ in range(2)], (A, None), iters)
    errG, _, _ = compare_pcg('pcg_update (general form, CG-MG)', gen, [
        pcg_state(b, M.matvec(b), []) for _ in range(2)], (A, M), iters)
    errD, msG, plainG = compare_pcg('pcg_update (general form)', gen, [
        pcg_state(b, Mdiag.matvec(b), []) for _ in range(2)], (A, Mdiag),
        iters)
    log(f'  pcg_update ({label}): {iters} iterations of each form; Jacobi: '
        f'max abs err {errJ:.3e}, kernel {msJ:.3f} ms, plain {plainJ:.3f} ms; '
        f'general (CG-MG): max abs err {errG:.3e}, timed with M = diag: '
        f'kernel {msG:.3f} ms, plain {plainG:.3f} ms')
    # per iteration, Jacobi: x, r, p, Ap, invD read, x, r, z, p written;
    # general: x, r, p, Ap, z read, x, r, p written
    return merge(result(errJ, msJ, plainJ,
                        [(72 * n, 13 * n, F64_PEAK)] * iters),
                 result(max(errG, errD), msG, plainG,
                        [(64 * n, 12 * n, F64_PEAK)] * iters))


def phase2():
    import numpy as np
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.nl.discretized import (buildMeshHierarchy,
                                                    buildHierarchy)
    from pynucleus_tpu_torch.multilevel.gmg import multigrid

    log('phase 2: kernels against their plain versions (disc, noRef 4, '
        'dense and H2 builds, the H2 CG-MG hierarchy of noRef 0-4)')
    prob = fractionalLaplacianProblem('disc', 'const(0.75)')
    mesh = prob['mesh']
    for _ in range(4):
        mesh = mesh.refine()
    dm = P1_DoFMap(mesh, prob['tag'], device='cuda')
    with ArgRecorder(asm, 'panel_scatter', dataFirst=True) as k1, \
            ArgRecorder(asm, 'grid_distant', dataFirst=True) as k2, \
            ArgRecorder(asm, 'grid_boundary', dataFirst=True) as k3:
        A = asm.nonlocalBuilder(dm, prob['kernel']).getDense()
    torch.cuda.synchronize()
    # noRef 6 adds an order-6 window (12-node rule), which takes K2's
    # warp-cooperative branch: cover it with the order-6 rule on the
    # order-4 window of noRef 4
    from pynucleus_tpu_torch.fem.quadrature import simplexCompact
    b6, w6 = simplexCompact(6, 2)
    Phi6 = dm.evalPhi(b6)
    (N4, _, ccf, vols, dofs, *_, t_lo, t_hi, prof), _ = k2.calls[-1]

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device='cuda')
    k2.calls.append(((
        N4, dev(np.einsum('qk,ckd->cqd', b6, mesh.vertices[mesh.cells])),
        ccf, vols, dofs, dev(Phi6 * w6), dev(Phi6), dev(-Phi6 * w6),
        dev(w6), t_lo, t_hi, prof), {}))
    out = {}
    out['panel_scatter'] = compare_target_kernel(
        'panel_scatter', k1.calls, asm.panel_scatter, asm._panel_scatter_plain,
        panel_work)
    out['grid_distant'] = compare_target_kernel(
        'grid_distant', k2.calls, asm.grid_distant, asm._grid_distant_plain,
        grid_distant_work)
    out['grid_boundary'] = compare_target_kernel(
        'grid_boundary', k3.calls, asm.grid_boundary, asm._grid_boundary_plain,
        grid_boundary_work)

    # K4's two forms (the general one with the V-cycle of the H2 hierarchy
    # of noRef 0-4), K9 on P and P^T of noRef 3 -> 4, K10 at n = 1081, K8
    # on the hierarchy's noRef 0, 1 and 2 operators (1, 10 and 55 dofs)
    b = assembleRHS(dm, prob['rhs'], qOrder=3).data
    n = b.shape[0]
    _, dms, Ps = buildMeshHierarchy(prob['mesh'], 'cg-mg', prob['tag'], 4,
                                    'P1', torch.device('cuda'))
    hier = buildHierarchy(dms, Ps, prob['kernel'], 'cg-mg', 'H2', True)
    mg = multigrid(hier)
    mg.setup()
    compare_pcg_forms(hier[-1]['A'], b, mg.asPreconditioner(), 'noRef 4')
    compare_csr_spmv(hier[-1]['P'])
    compare_jacobi_smooth(n)
    for k in (0, 1, 2):
        compare_h2_matvec(hier[k]['A'], label=f' (noRef {k}, '
                          f'{hier[k]["A"].num_rows} dofs, '
                          f'{hier[k]["A"].nLvl} tree levels)')

    # the H2 kernels at these shapes too (the kernel table holds them at
    # the shapes of phase 6's main path, K11 and K12 at phase 8's), the
    # flat engine's from a flat build, K11 and K12 from a default (block)
    # build, K13 from a host-engine build
    H, recs = record_h2_build(
        lambda: asm.nonlocalBuilder(dm, prob['kernel'], FLAT).getH2())
    compare_h2_build(recs)
    compare_h2_matvec(H)
    _, recs = record_h2_build(
        lambda: asm.nonlocalBuilder(dm, prob['kernel']).getH2(),
        ENGINE_KERNELS[:2])
    compare_engines(recs, ENGINE_KERNELS[:2])
    _, recs = record_h2_build(
        lambda: asm.nonlocalBuilder(dm, prob['kernel'], HOST).getH2(),
        ENGINE_KERNELS[2:])
    out.update(compare_engines(recs, ENGINE_KERNELS[2:]))
    return out


# ------------------------------------------------------------- phases 3-6

def check_against_jax(out, ref):
    """dofs equal, iterations +-1 (the pinned runs' comments say why),
    errors within RTOL_ERRORS of the pinned JAX outputs."""
    res = out['results'].toDict()
    errs = out['errors'].toDict()
    if res['dofs'] != ref['dofs']:
        raise AssertionError(f"dofs {res['dofs']} != {ref['dofs']}")
    if abs(res['iterations'] - ref['iterations']) > 1:
        raise AssertionError(f"iterations {res['iterations']} vs "
                             f"{ref['iterations']} +- 1")
    for label, val in ref['errors'].items():
        got = errs[label]
        if not abs(got - val) <= RTOL_ERRORS * abs(val):
            raise AssertionError(f'{label}: {got} vs JAX {val}')
    log(f"  dofs {res['dofs']}, iterations {res['iterations']}, L2 error "
        f"{errs['L2 error']:.6e}: matches the JAX outputs (dofs, iterations "
        f'+-1, errors within rtol {RTOL_ERRORS})')
    return errs


def phase3():
    from pynucleus_tpu_torch.drivers.runFractional import main
    log('phase 3: dense slice at noRef 5 against the JAX package')
    return check_against_jax(main(slice_argv(5), quiet=True), JAX_NOREF5)


def run_main_path(argv, path, params=None):
    """One run of a main path through the driver (builder ``params`` to
    every level), with every launch count set to 0 just before and read
    just after; each kernel of the path must have launched, an iterative
    solver must have converged."""
    import torch
    from pynucleus_tpu_torch import kernels
    from pynucleus_tpu_torch.drivers.runFractional import main
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.resetLaunches()
    out = main(argv, quiet=True, params=params)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    counts['device'] = dict(kernels.deviceLaunches)
    peak = torch.cuda.max_memory_allocated()
    res = out['results'].toDict()
    tim = out['timers'].toDict()
    errs = out['errors'].toDict()
    log(f"  dofs {res['dofs']}, iterations {res['iterations']}, assembly "
        f"{tim['assembly seconds']:.3f} s, solve {tim['solve seconds']:.3f} "
        f's, peak device memory {peak / 2**30:.3f} GiB')
    parts = {k[len('assembly '):-len(' seconds')]: round(v, 3)
             for k, v in tim.items()
             if k.startswith('assembly ') and k != 'assembly seconds'}
    if parts:
        log(f'  assembly parts (s): {parts}')
    log(f'  errors: {errs}')
    log(f'  launches: {counts}')
    for k in path:
        if counts[k] <= 0:
            raise AssertionError(f'kernel {k} was not launched by the main '
                                 'path')
    solver = out['solver']
    if hasattr(solver, 'residuals') and (
            not solver.residuals[-1] <= solver.tolerance
            or res['iterations'] >= solver.maxIter):
        raise AssertionError(f'{res["solver"]} did not converge: '
                             f'{solver.residuals[-3:]}')
    for k, v in errs.items():
        if not v == v or v < 0:
            raise AssertionError(f'{k} = {v}')
    return out, counts


def phase4(errs5):
    log('phase 4: dense slice at noRef 6')
    out, counts = run_main_path(slice_argv(6), DENSE_PATH)
    errs = out['errors'].toDict()
    if not errs['L2 error'] < errs5['L2 error']:
        raise AssertionError(f"L2 error {errs['L2 error']} not below noRef 5 "
                             f"{errs5['L2 error']}")
    return counts, errs, out['A'], out['dm']


def phase5(A6, dm6):
    import torch
    from pynucleus_tpu_torch.drivers.runFractional import main
    from pynucleus_tpu_torch.nl.assembly import assembleNonlocal
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    log('phase 5: H2 slice at noRef 5 against the JAX package; H2 against '
        'dense at noRef 6')
    check_against_jax(main(slice_argv(5, 'H2'), quiet=True), JAX_H2_NOREF5)
    kernel = fractionalLaplacianProblem('disc', 'const(0.75)')['kernel']
    H = assembleNonlocal(dm6, kernel, matrixFormat='H2', device='cuda')
    x = torch.randn(dm6.num_dofs, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(1))
    ref = A6.matvec(x)
    rel = float(torch.linalg.norm(H.matvec(x) - ref) / torch.linalg.norm(ref))
    if not rel <= TOL_H2_DENSE:
        raise AssertionError(f'H2 vs dense at noRef 6: relative error {rel}')
    log(f'  H2 vs dense matvec at noRef 6: relative error {rel:.3e} '
        f'(<= {TOL_H2_DENSE})')
    compare_operators('block vs flat engine at noRef 6', H, assembleNonlocal(
        dm6, kernel, matrixFormat='H2', device='cuda', params=FLAT), 6)


def phase6(errs6):
    """The H2 main path at noRef H2_NOREF, then each of its kernels against
    its plain version at the shapes of that path: K8 on its operator, K1's
    CSR targets, K5 (largest segment), K6 (largest order) and K7 on the
    recorded calls of a second build of it.  Returns the launch counts, the
    comparisons and the errors."""
    import torch
    from pynucleus_tpu_torch.nl.assembly import assembleNonlocal
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    log(f'phase 6: H2 slice at noRef {H2_NOREF} (flat near-field engine)')
    out, counts = run_main_path(slice_argv(H2_NOREF, 'H2', H2_MAXITER),
                                H2_PATH, FLAT)
    errs = out['errors'].toDict()
    if not errs['L2 error'] < errs6['L2 error']:
        raise AssertionError(f"L2 error {errs['L2 error']} not below dense "
                             f"noRef 6 {errs6['L2 error']}")
    H, dm = out['A'], out['dm']
    del out
    log(f'  kernels against their plain versions at the noRef {H2_NOREF} '
        'shapes')
    cmp = {'h2_matvec': compare_h2_matvec(H)}
    del H
    torch.cuda.empty_cache()
    prob = fractionalLaplacianProblem('disc', 'const(0.75)')
    recs = record_h2_build(lambda: assembleNonlocal(
        dm, prob['kernel'], matrixFormat='H2',
        zeroExterior=prob['zeroExterior'], device='cuda', params=FLAT),
        largestOnly=True)[1]
    cmp.update(compare_h2_build(recs))
    return counts, cmp, errs


def phase7():
    from pynucleus_tpu_torch.drivers.runFractional import main
    log('phase 7: H2 CG-MG slice at noRef 5 (6 levels) against the JAX '
        'package')
    check_against_jax(main(slice_argv(5, 'H2', MG_MAXITER, 'cg-mg'),
                           quiet=True), JAX_H2_MG_NOREF5)


def phase8(errs6):
    """The flagship: the multigrid main path at noRef H2_NOREF and a warm
    solve, then K4's two forms, K9, K10, and K11 and K12 (their finest
    level's calls, recorded during the run) against their plain versions
    at its finest shapes.  Returns the launch counts and the
    comparisons."""
    import torch
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    import pynucleus_tpu_torch.nl.assembly as asm
    log(f'phase 8: the flagship, H2 CG-MG at noRef {H2_NOREF}')
    # K11's and K12's calls of the finest level (the largest) are recorded
    # during the run; a recorded call is cloned, not launched again
    with ArgRecorder(asm, 'block_near_count',
                     size=lambda offI, *a: offI.shape[0]) as k11, \
            ArgRecorder(asm, 'block_near_quad', dataFirst=True,
                        size=lambda data, pairs, *a: pairs[0].shape[0]) \
            as k12:
        out, counts = run_main_path(slice_argv(H2_NOREF, 'H2', MG_MAXITER,
                                               'cg-mg'), MG_PATH)
    errs = out['errors'].toDict()
    tim = out['timers'].toDict()
    ref = errs6['L2 error']
    if not abs(errs['L2 error'] - ref) <= RTOL_ERRORS * ref:
        raise AssertionError(f"L2 error {errs['L2 error']} not within rtol "
                             f'{RTOL_ERRORS} of the CG-Jacobi {ref}')
    hierarchy = out['hierarchy']
    levelS = [tim[f'assembly level {k} seconds']
              for k in range(len(hierarchy))]
    M = out['solver'].prec
    b = torch.randn(M.num_rows, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(5))
    z = torch.empty_like(b)
    M.matvec(b, out=z)
    perCycle = timed(lambda: [M.matvec(b, out=z) for _ in range(10)]) / 10
    its = out['results'].toDict()['iterations']
    solver, A = out['solver'], hierarchy[-1]['A']
    rhs = assembleRHS(out['dm'], fractionalLaplacianProblem(
        'disc', 'const(0.75)')['rhs'], qOrder=3).data
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.solve(rhs)
    torch.cuda.synchronize()
    tWarm = time.perf_counter() - t0
    log(f"  L2 error {errs['L2 error']:.6e} (CG-Jacobi {ref:.6e}), "
        f'{its} iterations')
    log(f"  assembly {tim['assembly seconds']:.3f} s, per level (s) "
        f"{[round(t, 3) for t in levelS]}; hierarchy set-up "
        f"{tim['hierarchy set-up seconds']:.3f} s; solve "
        f"{tim['solve seconds']:.4f} s (the driver's, cold), "
        f'{tWarm:.4f} s warm ({solver.iterations} iterations)')
    log(f'  V-cycle {perCycle:.3f} ms (CUDA events over 10 cycles)')
    log(f'  kernels against their plain versions at the noRef {H2_NOREF} '
        'shapes')
    P = hierarchy[-1]['P']
    cmp = {'pcg_update': compare_pcg_forms(A, rhs, M, f'noRef {H2_NOREF}'),
           'csr_spmv': compare_csr_spmv(P),
           'jacobi_smooth': compare_jacobi_smooth(P.num_rows)}
    del out, hierarchy, M, solver, A
    torch.cuda.empty_cache()
    cmp['block_near_count'], byClass = compare_block_count(k11.calls)
    log(f'  near-field elements of the finest level: block engine '
        f'{sum(byClass[:4])} (orders 2/4/6/8: {byClass[:4]}), flat engine '
        f'{byClass[4]} (orders > 8)')
    cmp['block_near_quad'] = compare_target_kernel(
        'block_near_quad', k12.calls, asm.block_near_quad,
        asm._block_near_quad_plain, block_quad_work)
    return counts, cmp


def phase9():
    """The host near-field engine through the driver at noRef 5 (a path
    of its own, launch counts reset), held to the pinned JAX outputs; then
    the three engines' operators at noRef 5 agree.  Returns the launch
    counts."""
    from pynucleus_tpu_torch.nl.assembly import assembleNonlocal
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    log('phase 9: H2 slice at noRef 5 on the host near-field engine; the '
        'three engines at noRef 5')
    out, counts = run_main_path(slice_argv(5, 'H2'), HOST_PATH, HOST)
    check_against_jax(out, JAX_H2_NOREF5)
    kernel = fractionalLaplacianProblem('disc', 'const(0.75)')['kernel']
    for engine in ('block', 'flat'):
        H = assembleNonlocal(out['dm'], kernel, matrixFormat='H2',
                             device='cuda', params={'nearEngine': engine})
        compare_operators(f'{engine} vs host engine at noRef 5', H,
                          out['A'], 5)
    return counts


# ---------------------------------------------------------------- phase 10

# operations per unit of the cut-pair kernels (a pow, atan2, sin, cos or
# division counts as one): K14 per node (the clipped interval, y, the
# kernel value, the weight and the 10 upper-triangle multiply-adds); K15
# per x node (its window: 4 atan2, 3 floor-mods, the clips and the sort),
# per ray (angle, cos, sin, 3 ray-edge solves, the ball clip) and per
# radial node of a ray that hits the cell (y, the kernel value, the
# barycentrics and the 21 upper-triangle multiply-adds)
CUT1D_NODE_OPS = 47
CUT2D_XNODE_OPS = 70
CUT2D_RAY_OPS = 77
CUT2D_NODE_OPS = 74


def nonlocal_argv(domain, noRef, fmt, solver, kernelType='constant'):
    return ['--domain', domain, '--kernelType', kernelType, '--horizon',
            '0.2', '--problem', 'poly-Dirichlet', '--element', 'P1',
            '--solverType', solver, '--matrixFormat', fmt, '--noRef',
            str(noRef), '--device', 'cuda']


def run_nonlocal_path(argv, path):
    """One run of the finite-horizon path through runNonlocal, with every
    launch count set to 0 just before and read just after; each kernel of
    the path must have launched, an iterative solver must have
    converged."""
    import torch
    from pynucleus_tpu_torch import kernels
    from pynucleus_tpu_torch.drivers.runNonlocal import main
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.resetLaunches()
    out = main(argv, quiet=True)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    counts['device'] = dict(kernels.deviceLaunches)
    peak = torch.cuda.max_memory_allocated()
    res = out['results'].toDict()
    tim = out['timers'].toDict()
    errs = out['errors'].toDict()
    log(f"  {' '.join(argv[:2] + argv[10:14])}: dofs {res['dofs']}, "
        f"iterations {res['iterations']}, assembly "
        f"{tim['assembly seconds']:.3f} s, A_BC {tim['A_BC seconds']:.3f} s, "
        f"solve {tim['solve seconds']:.3f} s, peak device memory "
        f'{peak / 2**30:.3f} GiB, L2 error interpolated '
        f"{errs['L2 error interpolated']:.6e}")
    log(f'  launches: {counts}')
    for k in path:
        if counts[k] <= 0:
            raise AssertionError(f'kernel {k} was not launched by the path')
    solver = out['solver']
    if hasattr(solver, 'residuals') and (
            not solver.residuals[-1] <= solver.tolerance
            or res['iterations'] >= solver.maxIter):
        raise AssertionError(f'{res["solver"]} did not converge: '
                             f'{solver.residuals[-3:]}')
    for k, v in errs.items():
        if not v == v or v < 0:
            raise AssertionError(f'{k} = {v}')
    out['peak'] = peak
    return out, counts


def cut1d_work(args):
    """K14 on recorded args (shape, target, index, vertices, vi1, vi2,
    vols1, tq, wq, ur, wr, horizon, profile): every (x, y) node product of
    every pair; inputs read once, the 16 entries of a pair read and
    written once."""
    P = args[4].shape[0]
    Q = args[7].shape[0] * args[9].shape[0]
    return (nbytes(args[2:]) + 16 * 16 * P, CUT1D_NODE_OPS * P * Q, F64_PEAK)


def cut2d_work(args):
    """K15 on recorded args (shape, target, index, vertices, vi1, vi2,
    vols1, bary_x, wx, thetas, wtheta, rq, wr, horizon, inter, profile): the
    window of every x node, every ray, and the radial nodes of the rays
    that hit the cell in this run's data (counted by the plain version's
    ray part, chunked); inputs read once, the 36 entries of a pair read
    and written once."""
    import pynucleus_tpu_torch.nl.assembly as asm
    (vertices, vi1, vi2, bary_x, thetas, wtheta, horizon,
     inter) = args[3], args[4], args[5], args[7], args[9], args[10], \
        args[13], args[14]
    P, Qx, Qr = vi1.shape[0], bary_x.shape[1], args[11].shape[0]
    rays = hitRays = 0
    for sl in asm._plainChunks(P, Qx * thetas.shape[0] * 8):
        hits = asm._cut2dRays(vertices, vi1[sl], vi2[sl], bary_x, thetas,
                              wtheta, horizon, inter)[-1]
        rays += hits.numel()
        hitRays += int(hits.sum())
    ops = CUT2D_XNODE_OPS * P * Qx + CUT2D_RAY_OPS * rays \
        + CUT2D_NODE_OPS * hitRays * Qr
    return (nbytes(args[2:]) + 16 * 36 * P, ops, F64_PEAK)


def phase10():
    """The finite-horizon path.  Returns the launch counts of its two paths
    (the interval's sparse patch line, the square at noRef FH_NOREF) and
    the comparisons of K14, K15 and K1's cross target."""
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch.drivers.runNonlocal import main
    log('phase 10: the finite-horizon path (runNonlocal, horizon 0.2)')
    cmp = {}
    countsI = None
    for kernelType, fmt, bnd in INTERVAL_PATCH:
        argv = nonlocal_argv('interval', 6, fmt, 'lu', kernelType)
        if (kernelType, fmt) == ('constant', 'sparse'):
            with ArgRecorder(asm, 'cut1d', dataFirst=True) as k14:
                out, countsI = run_nonlocal_path(argv, INTERVAL_PATH)
        else:
            out = main(argv, quiet=True)
        err = out['errors'].toDict()['L2 error interpolated']
        if not err < bnd:
            raise AssertionError(f'interval {kernelType} {fmt}: L2 error '
                                 f'interpolated {err} >= {bnd}')
        log(f'  interval noRef 6 {kernelType} {fmt} lu: L2 error '
            f'interpolated {err:.3e} (< {bnd})')
    cmp['cut1d'] = compare_target_kernel('cut1d', k14.calls, asm.cut1d,
                                         asm._cut1d_plain, cut1d_work)

    with ArgRecorder(asm, 'cut2d_polar', dataFirst=True) as k15, \
            ArgRecorder(asm, 'panel_scatter_cross', dataFirst=True) as kx:
        out = main(nonlocal_argv('square', 2, 'sparse', 'cg-mg'),
                   quiet=True)
    res, errs = out['results'].toDict(), out['errors'].toDict()
    ref = JAX_SQUARE_NOREF2
    got = errs['L2 error interpolated']
    if res['dofs'] != ref['dofs'] or \
            abs(res['iterations'] - ref['iterations']) > 1 or \
            not abs(got - ref['L2 error interpolated']) \
            <= RTOL_ERRORS * ref['L2 error interpolated']:
        raise AssertionError(f'square noRef 2: {res}, {errs} vs JAX {ref}')
    log(f"  square noRef 2 sparse cg-mg: dofs {res['dofs']}, iterations "
        f"{res['iterations']}, L2 error interpolated {got:.7e}: matches the "
        f'JAX outputs (dofs, iterations +-1, error within rtol '
        f'{RTOL_ERRORS})')
    compare_target_kernel('cut2d_polar (noRef 2, all calls)', k15.calls,
                          asm.cut2d_polar, asm._cut2d_polar_plain,
                          cut2d_work)
    compare_target_kernel('panel_scatter_cross (noRef 2, A_BC)', kx.calls,
                          asm.panel_scatter_cross,
                          asm._panel_scatter_cross_plain, panel_work)
    del out, k15, kx
    torch.cuda.empty_cache()

    log(f'  the full-width line: square noRef {FH_NOREF}, sparse, cg-mg')
    with ArgRecorder(asm, 'cut2d_polar', dataFirst=True,
                     size=lambda out, t, i, v, vi1, *a: vi1.shape[0]) as k15, \
            ArgRecorder(asm, 'panel_scatter_cross', dataFirst=True) as kx:
        out, countsS = run_nonlocal_path(
            nonlocal_argv('square', FH_NOREF, 'sparse', 'cg-mg'),
            NONLOCAL_PATH)
    tim = out['timers'].toDict()
    errs = out['errors'].toDict()
    if not errs['L2 error interpolated'] < got:
        raise AssertionError(f"noRef {FH_NOREF} L2 error "
                             f"{errs['L2 error interpolated']} not below "
                             f'noRef 2 {got}')
    for k in range(FH_NOREF + 1):
        parts = {p: round(tim[f'assembly level {k} {p} seconds'], 3)
                 for p in ('classification', 'pattern', 'quadrature')}
        log(f"  level {k}: {out['hierarchy'][k]['A'].num_rows} dofs, nnz "
            f"{out['hierarchy'][k]['A'].nnz}, assembly "
            f"{tim[f'assembly level {k} seconds']:.3f} s (host "
            f"classification {parts['classification']}, host pattern "
            f"{parts['pattern']}, device fill {parts['quadrature']})")
    log(f"  A_BC {tuple(out['A_BC'].shape)} {tim['A_BC seconds']:.3f} s, "
        f"solver set-up {tim['solver set-up seconds']:.3f} s, solve "
        f"{tim['solve seconds']:.4f} s, explicit residual "
        f"{tim['explicit residual']:.3e}, peak device memory "
        f"{out['peak'] / 2**30:.3f} GiB")
    A, dm, kernel = out['A'], out['dm'], out['kernel']
    del out
    torch.cuda.empty_cache()
    D = asm.assembleNonlocal(dm, kernel, matrixFormat='dense',
                             device='cuda')
    x = torch.randn(dm.num_dofs, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(10))
    ref = D.matvec(x)
    rel = float(torch.linalg.norm(A.matvec(x) - ref) / torch.linalg.norm(ref))
    if not rel <= TOL_KERNEL:
        raise AssertionError(f'sparse vs dense at noRef {FH_NOREF}: {rel}')
    log(f'  sparse vs dense apply at noRef {FH_NOREF}: relative error '
        f'{rel:.3e} (<= {TOL_KERNEL})')
    del A, D
    torch.cuda.empty_cache()
    log(f'  kernels against their plain versions at the noRef {FH_NOREF} '
        'shapes')
    cmp['cut2d_polar'] = compare_target_kernel(
        'cut2d_polar', k15.calls, asm.cut2d_polar, asm._cut2d_polar_plain,
        cut2d_work)
    log(f'  cut2d_polar: {k15.largest} pairs in its largest call')
    cmp['panel_scatter_cross'] = compare_target_kernel(
        'panel_scatter_cross (A_BC)', kx.calls, asm.panel_scatter_cross,
        asm._panel_scatter_cross_plain, panel_work)
    return countsI, countsS, cmp


# ---------------------------------------------------------------- phase 11

# JAX package outputs of `drivers/runSerialGMG.py --domain square --noRef
# N`, run on the CPU in float64 (printed to 7 digits): label -> (iterations,
# rate, residual norm); errors L2 and H1_0
SERIAL_LABELS = ('MG', 'FMG', 'CG', 'PCG', 'GMRES', 'PGMRES', 'BICGSTAB',
                 'PBICGSTAB')
JAX_SERIAL = {
    4: {'DoFs': 961, 'Tol': 9.765625e-04,
        'iterations': (5, 4, 8, 3, 5, 3, 3, 1),
        'residuals': (7.453214e-04, 5.298254e-04, 8.871800e-04, 1.794617e-04,
                      8.725642e-04, 1.165668e-04, 7.755684e-04,
                      1.959891e-04),
        'errors': (1.340462e-03, 1.095661e-01)},
    9: {'DoFs': 1046529, 'Tol': 9.536743e-07,
        'iterations': (9, 5, 50, 5, 22, 5, 14, 2),
        'rates': (3.199636e-01, 1.282801e-01, 8.348316e-01, 1.543608e-01,
                  6.565008e-01, 1.042137e-01, 5.158734e-01, 5.563332e-03),
        'residuals': (3.387693e-07, 3.348073e-07, 1.158627e-06, 8.446646e-07,
                      9.187029e-07, 1.184738e-07, 9.111774e-07,
                      2.983109e-07),
        'errors': (1.517652e-06, 3.497728e-03)},
}
SERIAL_NOREF = 9
# the reference's cache (tests/test_gmg.py:36-49, BASELINE.md:19):
# (group, label, value, atol, rtol); iterations exact
SERIAL_CACHE = (('iterations', 'MG', 9, 0, 0),
                ('rates', 'MG', 0.31996358412183235, 1e-2, 0),
                ('residuals', 'MG', 3.387693291422185e-07, 0, 3e-1),
                ('iterations', 'CG', 50, 0, 0),
                ('rates', 'CG', 0.8348286600972041, 1e-2, 0),
                ('residuals', 'PCG', 8.44664592068035e-07, 0, 3e-1),
                ('iterations', 'FMG', 5, 0, 0),
                ('iterations', 'PCG', 5, 0, 0),
                ('errors', 'L^2 error', 1.6442082655606228e-06, 0, 2.0),
                ('errors', 'H^1_0 error', 0.003537410542403111, 0, 2.0))
# rates and residuals of the JAX noRef 9 table within this (the pinned
# values carry 7 digits); errors within TOL_SERIAL_ERRORS above the
# summation floor of their formulas (see check_serial)
TOL_SERIAL = 1e-5
TOL_SERIAL_ERRORS = 1e-6
# except unpreconditioned BiCGStab, whose 14 erratic steps amplify
# rounding: its residual differs from the JAX package's CPU run by 4.1e-5
# relative on an H100 (NVIDIA H100 80GB HBM3, 700 W), while its rate, its
# iterations and every other solver's numbers agree to 3e-6 or better;
# phase 11 measures in every run how far that residual moves when only
# the summation orders change (the dot products, A x's row sums, or all
# of them on the host's CPU)
TOL_SERIAL_LABEL = {'BICGSTAB': 1e-4}
# K18's scalars (rho, alpha, omega, ||r||) against the plain version's,
# each relative to itself
TOL_SCALARS = 1e-8
SERIAL_PATH = ('csr_scatter', 'csr_spmv', 'jacobi_smooth', 'pcg_update',
               'pcg_update:jacobi', 'pcg_update:general', 'gmres_arnoldi',
               'bicgstab_update')


def serial_argv(noRef):
    return ['--domain', 'square', '--noRef', str(noRef), '--device', 'cuda']


def check_serial(out, noRef):
    """The driver's groups against the JAX outputs of JAX_SERIAL[noRef]:
    dofs and iterations equal; at noRef 9 also rates and residuals within
    TOL_SERIAL, the errors within TOL_SERIAL_ERRORS plus the floor
    sqrt(n) eps ex / err^2 of their formulas (sums of n terms of the size
    of the exact norm ex cancel to err^2; the JAX package's CPU dot sums in
    another order), and the reference cache.  Logs every comparison, then
    raises if one failed."""
    import numpy as np
    ref = JAX_SERIAL[noRef]
    g = {k: out[k].toDict() for k in ('info', 'rates', 'iterations',
                                      'residuals', 'errors')}
    bad = []
    if g['info']['DoFs'] != ref['DoFs']:
        bad.append(f"DoFs {g['info']['DoFs']} != {ref['DoFs']}")
    its = [g['iterations']['Number of iterations ' + k]
           for k in SERIAL_LABELS]
    if its != list(ref['iterations']):
        bad.append(f"iterations {its} != JAX {list(ref['iterations'])}")
    log(f"  square noRef {noRef}: {g['info']['DoFs']} dofs, Tol "
        f"{g['info']['Tol']:.6e}; iterations {dict(zip(SERIAL_LABELS, its))}"
        f" (JAX {list(ref['iterations'])})")
    worst = {}
    for group, key in (('rates', 'Rate of convergence '),
                       ('residuals', 'Residual norm ')):
        if group not in ref:
            continue
        rel = [abs(g[group][key + k] - v) / v
               for k, v in zip(SERIAL_LABELS, ref[group])]
        worst[group] = max(rel)
        for k, r in zip(SERIAL_LABELS, rel):
            if r > TOL_SERIAL_LABEL.get(k, TOL_SERIAL):
                bad.append(f'{group} {k}: relative difference {r:.2e} > '
                           f'{TOL_SERIAL_LABEL.get(k, TOL_SERIAL)}')
        log(f'  {group}: ' + ', '.join(
            f'{k} {g[group][key + k]:.6e}' for k in SERIAL_LABELS)
            + f' (largest relative difference from JAX {worst[group]:.2e})')
    n = ref['DoFs']
    eps = float(np.finfo(float).eps)
    for (label, ex), val in zip((('L^2 error', 0.25),
                                 ('H^1_0 error', 2 * np.pi ** 2 / 4)),
                                ref['errors']):
        got = g['errors'][label]
        tol = TOL_SERIAL_ERRORS + np.sqrt(n) * eps * ex / val ** 2
        rel = abs(got - val) / val
        log(f'  {label} {got:.7e} (JAX {val:.6e}, relative difference '
            f'{rel:.2e}, allowed {tol:.2e})')
        if rel > tol:
            bad.append(f'{label}: {got} vs JAX {val} (rtol {tol:.2e})')
    if noRef == SERIAL_NOREF:
        for group, label, val, atol, rtol in SERIAL_CACHE:
            key = label if group == 'errors' else {
                'iterations': 'Number of iterations ',
                'rates': 'Rate of convergence ',
                'residuals': 'Residual norm '}[group] + label
            got = g[group][key]
            if not abs(got - val) <= atol + rtol * abs(val):
                bad.append(f'cache {key}: {got} vs {val}')
        log(f'  the reference cache (tests/test_gmg.py:36-49, BASELINE.md:19):'
            f' {"met" if not any(b.startswith("cache") for b in bad) else "MISSED"}')
    if bad:
        raise AssertionError('runSerialGMG: ' + '; '.join(bad))
    return worst


def scatter_work(args):
    """K16 on recorded args (vals, order, offsets): its inputs read once,
    the data [nnz] written once; one addition per kept contribution."""
    vals, order, offsets = args[:3]
    return (nbytes(vals, order, offsets) + 8 * (offsets.shape[0] - 1),
            order.shape[0], F64_PEAK)


def compare_csr_scatter(dm, reps=10):
    """K16 on the finest level's stiffness (the dofmap dm's local matrices
    and gather order) against its plain version (equal to 1e-12 of the
    largest entry; the same sums in the same order), ``reps`` calls each
    way after an untimed one, and the library yardstick: one index_add_ of
    all contributions into [nnz+1], the dropped ones into the last slot
    (never used by the port).  Returns the result() per call."""
    import torch
    from pynucleus_tpu_torch.fem.assembly import (
        csr_scatter, _csr_scatter_plain, localStiffness, scatterPlan)
    _, _, order, offsets = scatterPlan(dm)
    vals = torch.as_tensor(localStiffness(dm).reshape(-1), device='cuda')
    nnz = offsets.shape[0] - 1
    dk = torch.empty(nnz, dtype=torch.float64, device='cuda')
    dp = torch.empty_like(dk)
    csr_scatter(vals, order, offsets, out=dk)
    _csr_scatter_plain(vals, order, offsets, dp)
    err = float((dk - dp).abs().max())
    scale = float(dp.abs().max())
    if not (scale > 0 and err <= TOL_KERNEL * scale):
        raise AssertionError(f'csr_scatter: max err {err} (max {scale})')
    ms = timed(lambda: [csr_scatter(vals, order, offsets, out=dk)
                        for _ in range(reps)]) / reps
    plain_ms = timed(lambda: [_csr_scatter_plain(vals, order, offsets, dp)
                              for _ in range(reps)]) / reps
    # the flat slot of every contribution (nnz for a dropped one)
    slot = torch.full_like(vals, nnz, dtype=torch.int64)
    slot[order.long()] = torch.repeat_interleave(
        torch.arange(nnz, device='cuda'), (offsets[1:] - offsets[:-1]).long())
    lib = torch.zeros(nnz + 1, dtype=torch.float64, device='cuda')
    lib.index_add_(0, slot, vals)
    libErr = float((lib[:nnz] - dp).abs().max())
    if not libErr <= 1e-10 * scale:
        raise AssertionError(f'csr_scatter: index_add_ differs by {libErr}')
    lib_ms = timed(lambda: [lib.zero_().index_add_(0, slot, vals)
                            for _ in range(reps)]) / reps
    log(f'  csr_scatter: {vals.shape[0]} local entries, {order.shape[0]} '
        f'kept, nnz {nnz}, max abs err {err:.3e}, kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms (max difference '
        f'{libErr:.2e}, atomics)')
    return result(err, ms, plain_ms, [scatter_work((vals, order, offsets))],
                  lib_ms)


def _max_err(pairs):
    """Largest absolute difference and largest entry over (kernel, plain)
    tensor pairs."""
    err = max(float((a - b).abs().max()) for a, b in pairs)
    scale = max(float(b.abs().max()) for _, b in pairs)
    return err, scale


def compare_gmres_arnoldi(A, b, restart=10):
    """K17 on one full restart cycle of GMRES on the operator A from x0 =
    0: the start and each of the ``restart`` Arnoldi steps, then the
    combine x0 + V y, each call made by the kernel and by the plain
    version on copies of the same state (the cycle goes on from the
    kernel's), compared to 1e-12 of the largest entry and timed with CUDA
    events; and the combine's library yardstick, one torch.addmv.  In b's
    type: float64, or complex128 (K17's complex variant, complex y).
    Returns the result() per cycle."""
    import numpy as np
    import torch
    from pynucleus_tpu_torch.base import solvers as S
    n = b.shape[0]
    cplx = b.is_complex()
    V = torch.empty((restart + 1, n), dtype=b.dtype, device='cuda')
    h = torch.zeros(restart + 1, dtype=b.dtype, device='cuda')
    guards = torch.tensor([0.0, 1e-300], dtype=torch.float64, device='cuda')
    w = b.clone()
    worst = ms = plain_ms = 0.0
    work = []
    for j in range(-1, restart):
        if j >= 0:
            A.matvec(V[j], out=w)
        guard = guards[:1] if j < 0 else guards[1:]
        Vp, wp, hp = V.clone(), w.clone(), h.clone()
        ms += timed(lambda: S.gmres_arnoldi(V, w, h, j, guard))
        plain_ms += timed(lambda: S._gmres_arnoldi_plain(Vp, wp, hp, j,
                                                         guard))
        err, scale = _max_err(((V[:j + 2], Vp[:j + 2]), (w, wp)))
        herr = float((h[:j + 2] - hp[:j + 2]).abs().max())
        if not (err <= TOL_KERNEL * scale and
                herr <= TOL_KERNEL * float(hp[:j + 2].abs().max())):
            raise AssertionError(f'gmres_arnoldi step {j}: max err {err}, '
                                 f'h {herr}')
        worst = max(worst, err)
        # V[0..j] and w read, w and V[j+1] written (the start: w read,
        # V[0] written); 4 n operations a Gram-Schmidt term, 3 n for the
        # norm and the division (complex: 16 n and 6 n)
        work.append((b.element_size() * n * (j + 4 if j >= 0 else 2),
                     (16 if cplx else 4) * n * (j + 1)
                     + (6 if cplx else 3) * n, F64_PEAK))
    rng = np.random.default_rng(11)
    y = rng.normal(size=restart)
    if cplx:
        y = y + 1j * rng.normal(size=restart)
    y = torch.as_tensor(y, device='cuda')
    x0 = torch.randn(n, dtype=b.dtype, device='cuda',
                     generator=torch.Generator('cuda').manual_seed(12))
    xk, xp = x0.clone(), x0.clone()
    cms = timed(lambda: S.gmres_combine(xk, V, y))
    cplain = timed(lambda: S._gmres_combine_plain(xp, V, y))
    err, scale = _max_err(((xk, xp),))
    if not err <= TOL_KERNEL * scale:
        raise AssertionError(f'gmres_combine: max err {err}')
    worst = max(worst, err)
    Vt = V[:restart].T
    torch.addmv(x0, Vt, y)
    lib_ms = timed(lambda: torch.addmv(x0, Vt, y))
    ms += cms
    plain_ms += cplain
    work.append((b.element_size() * n * (restart + 2),
                 (8 if cplx else 2) * n * restart + (2 if cplx else 1) * n,
                 F64_PEAK))
    log(f'  gmres_arnoldi ({b.dtype}): one cycle of {restart} steps on n {n} '
        '(start, '
        f'steps, combine), max abs err {worst:.3e}, kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms; combine {cms:.4f} ms, torch.addmv {lib_ms:.4f} '
        'ms')
    r = result(worst, ms, plain_ms, work)
    r.update(combine_ms=cms, combine_library_ms=lib_ms)
    return r


def compare_bicgstab_update(A, b, iters=10):
    """K18 on ``iters`` BiCGStab iterations on the operator A from x0 = 0
    (no preconditioner): each of its calls made by the kernel and by the
    plain version on copies of the same state (the iteration goes on from
    the kernel's), vectors and scalars compared to 1e-12 of their largest
    entry and timed with CUDA events.  Returns the result() per
    ``iters`` iterations."""
    import torch
    from pynucleus_tpu_torch.base import solvers as S
    x = torch.zeros_like(b)
    r, r0 = b.clone(), b.clone()
    p, v, s, t = (torch.zeros_like(b) for _ in range(4))
    scal = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0], dtype=torch.float64,
                        device='cuda')
    n = b.shape[0]
    # inputs read and outputs written once: direction r0, r, p, v -> p;
    # step r0, v, r -> s; update t, s, x, p -> x, r (ph = p, sh = s)
    nvec = {'direction': 5, 'step': 4, 'update': 6}
    nops = {'direction': 9, 'step': 4, 'update': 10}
    worst = ms = plain_ms = worstScal = 0.0
    work = []
    for it in range(iters):
        for mode in ('direction', 'step', 'update'):
            if mode == 'step':
                A.matvec(p, out=v)
            elif mode == 'update':
                A.matvec(s, out=t)
            k = [x, r, r0, p, v, s, t, p, s, scal]
            q = [a.clone() for a in k[:7]]
            q = q + [q[3], q[5], scal.clone()]
            ms += timed(lambda: S.bicgstab_update(mode, *k, it))
            plain_ms += timed(lambda: S._bicgstab_update_plain(mode, *q, it))
            err, scale = _max_err(list(zip(k[:7], q[:7])))
            # each scalar is a quotient of dot products that cancel, which
            # the kernel's block sums and torch.dot round differently; the
            # vectors they scale are held to TOL_KERNEL
            serr = float(((k[-1] - q[-1]).abs() / q[-1].abs()).max())
            if not (err <= TOL_KERNEL * scale and serr <= TOL_SCALARS):
                raise AssertionError(f'bicgstab_update ({mode}, {it}): max '
                                     f'err {err}, scalars {serr}')
            worst = max(worst, err)
            worstScal = max(worstScal, serr)
            work.append((8 * n * nvec[mode], nops[mode] * n, F64_PEAK))
    log(f'  bicgstab_update: {iters} iterations on n {n}, max abs err '
        f'{worst:.3e} (scalars: relative {worstScal:.2e}), kernel {ms:.4f} '
        f'ms, plain {plain_ms:.4f} ms (||r|| {float(scal[4]):.3e})')
    return result(worst, ms, plain_ms, work)


def warm_solves(out):
    """Each solve of the driver again, warm (the kernels compiled), timed
    by the host clock to a synchronize: returns {label: seconds}."""
    import torch
    from pynucleus_tpu_torch.base.solvers import solverFactory
    from pynucleus_tpu_torch.drivers.runSerialGMG import SOLVERS
    ml, b = out['ml'], out['b']
    A = out['hierarchy'][-1]['A']
    secs = {}

    def run(label, solve):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
    for cycle, label in (('V', 'MG'), ('FMG_V', 'FMG')):
        ml.cycle = cycle
        run(label, lambda: ml.solve(b))
    for name, label, restarts in SOLVERS:
        for prefix in ('', 'P'):
            s = solverFactory.build(name, A=A, setup=True)
            s.tolerance = ml.tolerance
            s.maxIter = ml.maxIter // 5 if name == 'gmres' else ml.maxIter
            if name == 'gmres':
                s.restarts = restarts
            if prefix:
                s.setPreconditioner(ml.asPreconditioner())
            run(prefix + label, lambda: s.solve(b))
    return secs


class LibraryCSR:
    """The CSR operator A applied by one torch.sparse CSR product (another
    order of each row's sum than K9's); a yardstick, never used by the
    port."""

    def __init__(self, A):
        import torch
        self.S = torch.sparse_csr_tensor(A.indptr, A.indices, A.data,
                                         size=A.shape)
        self.num_rows, self.num_columns = A.shape

    def matvec(self, x, out=None):
        import torch
        y = torch.mv(self.S, x)
        return y if out is None else out.copy_(y)


def bicgstab_spread(out):
    """Unpreconditioned BiCGStab as in the driver four ways: through K18
    and K9 (the port), through K18's plain version (other orders of the
    dot products), with A x by a torch.sparse product (another order of
    each row's sum), and on the host's CPU (the plain versions: the CPU's
    blocked dot products and sequential row sums, less accurate sums of a
    million terms, as the JAX package's CPU run takes).  Returns the final
    residuals ||b - A x|| of the four and the relative spread of the last
    three from the first."""
    import torch
    from pynucleus_tpu_torch.base import solvers as S
    from pynucleus_tpu_torch.base.linear_operators import CSR_LinearOperator
    ml, b = out['ml'], out['b']
    A = out['hierarchy'][-1]['A']
    Ah = CSR_LinearOperator(A.indptrH, A.indicesH, A.dataH,
                            num_columns=A.num_columns, device='cpu')
    res = []
    for fn, op, rhs in ((S.bicgstab_update, A, b),
                        (S._bicgstab_update_plain, A, b),
                        (S.bicgstab_update, LibraryCSR(A), b),
                        (S.bicgstab_update, Ah, b.cpu())):
        orig, S.bicgstab_update = S.bicgstab_update, fn
        try:
            s = S.bicgstab_solver(op)
            s.tolerance, s.maxIter = ml.tolerance, ml.maxIter
            x = s.solve(rhs)
        finally:
            S.bicgstab_update = orig
        res.append(float(torch.linalg.norm(b - A.matvec(x.to(b.device)))))
    return res, [abs(r - res[0]) / res[0] for r in res[1:]]


def phase11():
    """The serial multigrid path (drivers/runSerialGMG.py): the square at
    noRef 4 against the JAX outputs; the full-width line at noRef
    SERIAL_NOREF (launch counts reset just before it) against the JAX
    outputs and the reference cache, with its set-up parts, K16 per level,
    the solves, a V-cycle and the peak memory; then K16, K17 and K18
    against their plain versions at its shapes.  Returns the launch counts
    and the comparisons."""
    import torch
    from pynucleus_tpu_torch import kernels
    from pynucleus_tpu_torch.drivers.runSerialGMG import main
    log('phase 11: the serial multigrid path (runSerialGMG, the Poisson '
        'square)')
    check_serial(main(serial_argv(4), quiet=True), 4)
    log(f'  the full-width line: square noRef {SERIAL_NOREF}')
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.resetLaunches()
    t0 = time.perf_counter()
    out = main(serial_argv(SERIAL_NOREF), quiet=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(kernels.launches)
    counts['device'] = dict(kernels.deviceLaunches)
    peak = torch.cuda.max_memory_allocated()
    log(f'  launches: {counts}')
    for k in SERIAL_PATH:
        if counts[k] <= 0:
            raise AssertionError(f'kernel {k} was not launched by the path')
    tim = out['timers'].toDict()
    nLvl = len(out['hierarchy'])
    log(f'  {nLvl} levels, the driver {wall:.3f} s, peak device memory '
        f'{peak / 2**30:.3f} GiB')
    log('  host set-up (s): ' + ', '.join(
        f'{k[:-len(" seconds")]} {v:.3f}' for k, v in tim.items()
        if k.endswith(' seconds') and not k.startswith(('level ', 'solve '))))
    for part in ('local', 'pattern', 'scatter order'):
        log(f'  {part} (host s) per level: '
            f"{[round(tim[f'level {k} {part} seconds'], 3) for k in range(nLvl)]}")
    log('  K16 csr_scatter (device ms, CUDA events) per level: '
        f"{[round(tim[f'level {k} scatter seconds'] * 1e3, 4) for k in range(nLvl)]}")
    log('  solves (s): ' + ', '.join(
        f"{k} {tim[f'solve {k} seconds']:.4f}" for k in SERIAL_LABELS))
    secs = warm_solves(out)
    log('  warm solves (s): ' + ', '.join(f'{k} {v:.4f}'
                                          for k, v in secs.items()))
    res, spread = bicgstab_spread(out)
    log(f'  BICGSTAB residual through K18 and K9 {res[0]:.7e}; through '
        f"K18's plain version {res[1]:.7e} (relative {spread[0]:.2e}); "
        f'with A x by torch.sparse {res[2]:.7e} (relative {spread[1]:.2e}); '
        f'on the host CPU {res[3]:.7e} (relative {spread[2]:.2e})')
    worst = check_serial(out, SERIAL_NOREF)
    ml, b, dm = out['ml'], out['b'], out['dm']
    A = out['hierarchy'][-1]['A']
    M = ml.asPreconditioner()
    z = torch.empty_like(b)
    M.matvec(b, out=z)
    perCycle = timed(lambda: [M.matvec(b, out=z) for _ in range(10)]) / 10
    log(f'  V-cycle (2+2 sweeps, {nLvl} levels) {perCycle:.3f} ms (CUDA '
        'events over 10 cycles)')
    del out, ml, M, z
    torch.cuda.empty_cache()
    log(f'  kernels against their plain versions at the noRef '
        f'{SERIAL_NOREF} shapes')
    cmp = {'csr_scatter': compare_csr_scatter(dm),
           'gmres_arnoldi': compare_gmres_arnoldi(A, b),
           'bicgstab_update': compare_bicgstab_update(A, b)}
    summary = {'dofs': A.num_rows, 'levels': nLvl, 'wall_s': wall,
               'peak_GiB': peak / 2**30, 'vcycle_ms': perCycle,
               'largest_rel_diff': worst, 'bicgstab_spread': spread,
               'warm_solve_s': secs}
    log(f'  summary: {json.dumps(summary)}')
    return counts, cmp


# ---------------------------------------------------------------- phase 12

# JAX package outputs of `drivers/runFractional.py --domain interval --s
# 'const(0.75)' --problem constant --element P1 --solverType lu
# --matrixFormat H2` (default noRef 6, 127 dofs) and of the same line with
# --solverType cg-mg (7 levels, every one H2), run on the CPU in float64.
# The port's near data equal the JAX package's to 1e-15 of max|data| there
# (tests/test_torch_interval_h2.py), so the errors are held to
# TOL_INTERVAL_JAX relative.
JAX_INTERVAL_LU = {
    'dofs': 127, 'iterations': 1,
    'errors': {'L2 error': 0.0014601356600079179,
               'relative L2 error': 0.00178829366113067,
               'L2 error interpolated': 0.0010913476899855,
               'relative interpolated L2 error': 0.0013367044777926175,
               'Linf error interpolated': 0.000987510692509408,
               'relative interpolated Linf error': 0.0013127378473115044,
               'Hs error': 0.04187962925463276,
               'relative Hs error': 0.040269522411370114}}
JAX_INTERVAL_MG = {
    'dofs': 127, 'iterations': 3,
    'errors': {'L2 error': 0.0014601358642015285,
               'L2 error interpolated': 0.0010913478773632536,
               'Hs error': 0.04187962925529021}}
TOL_INTERVAL_JAX = 1e-6
# the reference cache of the lu line (tests/test_drivers_fractional.py:95-98)
INTERVAL_H2_CACHE = {'Hs error': 0.041849732677658555,
                     'L2 error': 0.001458788789368659,
                     'L2 error interpolated': 0.001089628333551184,
                     'Linf error interpolated': 0.0009871148528776685}
# runNonlocal's smooth lines (lu, H2, fullSpace, default noRef 8, 511
# dofs): flags, the reference cache (tests/test_nonlocal_driver.py:83-104)
# and the JAX package's output (CPU, float64) of 'L2 error interpolated'
SMOOTH_LINES = {
    'gaussian': (['--kernelType', 'gaussian', '--problem', 'gaussian',
                  '--gaussianVariance', '0.1'], 2.9565447289171816e-03,
                 2.9352268303818796e-03),
    'exponential': (['--kernelType', 'exponential', '--problem',
                     'exponential', '--exponentialRate', '8.0'],
                    2.5530396949181036e-04, 2.545126451525732e-04)}
# the square with the gaussian kernel (runNonlocal, lu, H2, fullSpace,
# variance 0.1) at noRef 3, 225 dofs, for the 2D profiles: the gaussian
# and its boundary form C exp(-a r2) / (2 a r); the JAX package's output
# (CPU, float64) of 'L2 error interpolated' (no reference cache holds the
# square).  The 2D exponential kernel (rate 8, scaling 0.7: it has no
# normalization in 2D) and its boundary form on the same mesh, built
# through the library.
SQUARE_NOREF = 3
JAX_SQUARE_GAUSSIAN = 41.68066922312951
SQUARE_EXPONENTIAL = {'exponentialRate': 8.0, 'scaling': 0.7}
INTERVAL_NOREF = 16
INTERVAL_CHECK_NOREF = 12
SMOOTH_NOREF = 14
INTERVAL_LU_PATH = ('panel_scatter', 'near_enum', 'near_enum_quad',
                    'far_field', 'h2_matvec', 'block_near_count',
                    'block_near_quad', 'panel_scatter:slots',
                    'panel_scatter:tree')
SMOOTH_CG_PATH = INTERVAL_LU_PATH + ('pcg_update', 'pcg_update:jacobi')
# the kernels of this slice, held with the smooth profiles (and K1, K5-K7,
# K11, K12 at the noRef 16 line's shapes), and the solve's kernels K4, K8,
# K9, K10 at the noRef 16 line's shapes, in the kernel table's
# 'at_interval'
INTERVAL_KERNELS = ('panel_scatter', 'grid_distant', 'grid_boundary',
                    'near_enum', 'near_enum_quad', 'far_field',
                    'block_near_count', 'block_near_quad', 'tree_csr_quad',
                    'pcg_update', 'h2_matvec', 'csr_spmv', 'jacobi_smooth')
INTERVAL_COMPARED_AT = (
    'interval: the gaussian (variance 0.1) and exponential (rate 8) lines '
    'at noRef 8 (all calls of their H2 builds; K13 a host-engine build, K1 '
    'dense, K2 and K3 a dense build), the 2D boundary profiles on the '
    'square (K1 tree and dense targets, K3, K7), and K1, K5-K7, K11, K12 '
    f'the largest call of the fractional CG-MG line at noRef {INTERVAL_NOREF}; '
    f'on that line K8 on each of its levels (timed on the finest, per '
    'apply), K9 on the finest prolongation, K10 at the finest size, K4 '
    'one iteration fewer than the solve took, each form, with its V-cycle')


def interval_argv(noRef, solver):
    return ['--domain', 'interval', '--s', 'const(0.75)', '--problem',
            'constant', '--element', 'P1', '--solverType', solver,
            '--matrixFormat', 'H2', '--noRef', str(noRef), '--maxiter',
            str(MG_MAXITER), '--device', 'cuda']


def smooth_argv(kind, noRef, solver='lu', domain='interval'):
    return ['--domain', domain] + SMOOTH_LINES[kind][0] + [
        '--interaction', 'fullSpace', '--horizon', 'inf', '--solverType',
        solver, '--matrixFormat', 'H2', '--noRef', str(noRef), '--device',
        'cuda']


def check_interval_jax(out, ref, label):
    """dofs and iterations equal, errors within TOL_INTERVAL_JAX of the
    pinned JAX outputs."""
    res, errs = out['results'].toDict(), out['errors'].toDict()
    bad = [f"{k}: {errs[k]} vs JAX {v}" for k, v in ref['errors'].items()
           if not abs(errs[k] - v) <= TOL_INTERVAL_JAX * abs(v)]
    if res['dofs'] != ref['dofs'] or res['iterations'] != ref['iterations']:
        bad.append(f"dofs {res['dofs']}, iterations {res['iterations']} vs "
                   f"JAX {ref['dofs']}, {ref['iterations']}")
    if bad:
        raise AssertionError(f'{label}: ' + '; '.join(bad))
    log(f"  {label}: dofs {res['dofs']}, iterations {res['iterations']}, "
        f"L2 error {errs['L2 error']:.9e}: the JAX outputs (errors within "
        f'rtol {TOL_INTERVAL_JAX})')
    return errs


def compare_smooth_builds(kind, domain='interval'):
    """The kernels of this slice with the ``kind`` profile on the card
    against their plain versions, at the shapes of its smooth line (the
    interval at noRef 8, or the square at SQUARE_NOREF, held to its pinned
    JAX output): K1's CSR targets, K5, K6, K7, K11 and K12 on the recorded
    calls of the line's run (launch counts reset just before it: a path
    of its own), then compare_profile_builds on its mesh.  Returns (the
    launch counts, {name: result()}, (dofmap, kernel))."""
    noRef = 8 if domain == 'interval' else SQUARE_NOREF
    (out, counts), recs = record_h2_build(
        lambda: run_nonlocal_path(smooth_argv(kind, noRef, domain=domain),
                                  INTERVAL_LU_PATH),
        H2_BUILD + ENGINE_KERNELS[:2])
    errs = out['errors'].toDict()
    got = errs['L2 error interpolated']
    if domain == 'interval':
        _, cache, jaxErr = SMOOTH_LINES[kind]
        ok = abs(got - cache) <= RTOL_ERRORS * cache
        what = f'the reference cache {cache:.7e} (rtol {RTOL_ERRORS}) and '
    else:
        jaxErr, ok, what = JAX_SQUARE_GAUSSIAN, True, ''
    if not (ok and abs(got - jaxErr) <= TOL_INTERVAL_JAX * jaxErr):
        raise AssertionError(f'{kind} {domain} line: L2 error interpolated '
                             f'{got} vs {what}JAX {jaxErr} (rtol '
                             f'{TOL_INTERVAL_JAX})')
    log(f'  {kind} {domain} noRef {noRef} lu H2: L2 error interpolated '
        f'{got:.9e}: {what}the JAX output (rtol {TOL_INTERVAL_JAX})')
    dm, kernel = out['dm'], out['kernel']
    del out
    log(f'  kernels against their plain versions, {kind} profile')
    cmp = compare_h2_build(recs)
    cmp.update(compare_engines(recs, ENGINE_KERNELS[:2]))
    return counts, compare_profile_builds(dm, kernel, cmp), (dm, kernel)


def compare_profile_builds(dm, kernel, cmp=None):
    """The kernels that evaluate ``kernel``'s profiles (its own and its
    boundary kernel's) against their plain versions on the dofmap dm: K13
    on a host-engine build, K1's dense target, K2 and K3 on a dense build
    (in 2D K3 without its exclusions);
    without ``cmp`` (the comparisons of a recorded driver run) also K1's
    CSR targets, K5-K7, K11 and K12 on a default H2 build.  Returns
    {name: result()}, K1's targets merged."""
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    if cmp is None:
        _, recs = record_h2_build(
            lambda: asm.assembleNonlocal(dm, kernel, matrixFormat='H2',
                                         device='cuda'),
            H2_BUILD + ENGINE_KERNELS[:2])
        cmp = compare_h2_build(recs)
        cmp.update(compare_engines(recs, ENGINE_KERNELS[:2]))
    _, recs = record_h2_build(
        lambda: asm.assembleNonlocal(dm, kernel, matrixFormat='H2',
                                     device='cuda', params=HOST),
        ENGINE_KERNELS[2:])
    cmp.update(compare_engines(recs, ENGINE_KERNELS[2:]))
    with ArgRecorder(asm, 'panel_scatter', dataFirst=True) as k1, \
            ArgRecorder(asm, 'grid_distant', dataFirst=True) as k2, \
            ArgRecorder(asm, 'grid_boundary', dataFirst=True) as k3:
        asm.assembleNonlocal(dm, kernel, matrixFormat='dense',
                             device='cuda')
    torch.cuda.synchronize()
    k3calls = k3.calls
    if kernel.dim == 2:
        # the smooth 2D kernels send every cell-surface pair to K1 (orders
        # above 4), so K3 adds nothing there: it is held on those calls
        # with their exclusion lists (exclPtr, exclIdx) emptied
        k3calls = [(a[:7] + (torch.zeros_like(a[7]), a[8][:0]) + a[9:], kw)
                   for a, kw in k3calls]
    for name, calls, work in (('panel_scatter', k1.calls, panel_work),
                              ('grid_distant', k2.calls, grid_distant_work),
                              ('grid_boundary', k3calls, grid_boundary_work)):
        cmp[name] = compare_target_kernel(
            f'{name} ({kernel}, dense)', calls, getattr(asm, name),
            getattr(asm, '_' + name + '_plain'), work)
    cmp['panel_scatter'] = merge(cmp['panel_scatter'],
                                 cmp.pop('panel_scatter_slots'),
                                 cmp.pop('panel_scatter_tree'))
    return cmp


def phase12():
    """The interval in H2 and the smooth kernels: the reference line
    against the cache and the JAX outputs, the kernels of this slice with
    the gaussian and exponential profiles against their plain versions,
    the gaussian at noRef SMOOTH_NOREF, H2 against dense at noRef
    INTERVAL_CHECK_NOREF and the full-width line, CG-MG at noRef
    INTERVAL_NOREF, with its kernels against their plain versions at its
    shapes.  Returns the launch counts of its paths and the comparisons."""
    import contextlib
    import numpy as np
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch.drivers.runFractional import main
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.nl.kernels import getIntegrableKernel
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    prob = fractionalLaplacianProblem('interval', 'const(0.75)')
    log('phase 12: the interval in H2 (runFractional) and the gaussian and '
        'exponential kernels (runNonlocal)')
    counts = {}
    out, counts['lu'] = run_main_path(interval_argv(6, 'lu'),
                                      INTERVAL_LU_PATH)
    errs = check_interval_jax(out, JAX_INTERVAL_LU, 'interval noRef 6 lu H2')
    bad = [k for k, v in INTERVAL_H2_CACHE.items()
           if not abs(errs[k] - v) <= RTOL_ERRORS * v]
    if bad:
        raise AssertionError(f'interval lu H2: {bad} miss the reference '
                             'cache')
    log(f'  the reference cache (tests/test_drivers_fractional.py:95-98): '
        f'met (rtol {RTOL_ERRORS})')
    check_interval_jax(main(interval_argv(6, 'cg-mg'), quiet=True),
                       JAX_INTERVAL_MG, 'interval noRef 6 cg-mg H2')

    byProfile = {}
    for kind in SMOOTH_LINES:
        counts[kind], byProfile[kind], _ = compare_smooth_builds(kind)
    # the 2D profile codes: the gaussian square line, then the exponential
    # kernel on its mesh
    counts['square'], byProfile['square'], (dm, _) = compare_smooth_builds(
        'gaussian', 'square')
    kExp = getIntegrableKernel(2, 'exponential', np.inf,
                               **SQUARE_EXPONENTIAL)
    log(f'  {kExp} and its boundary kernel on the square at noRef '
        f'{SQUARE_NOREF}: the kernels against their plain versions')
    byProfile['square exponential'] = compare_profile_builds(dm, kExp)
    del dm
    out, counts['gaussian14'] = run_nonlocal_path(
        smooth_argv('gaussian', SMOOTH_NOREF, 'cg-jacobi'), SMOOTH_CG_PATH)
    g14 = out['errors'].toDict()['L2 error interpolated']
    log(f"  gaussian noRef {SMOOTH_NOREF} cg-jacobi H2: dofs "
        f"{out['results'].toDict()['dofs']}, L2 error interpolated "
        f'{g14:.6e} (noRef 8: {SMOOTH_LINES["gaussian"][2]:.6e}; the '
        'solution is exact only up to the zero Dirichlet data)')
    del out
    torch.cuda.empty_cache()

    log(f'  H2 against dense at noRef {INTERVAL_CHECK_NOREF}, and its CG-MG '
        'error')
    outC = main(interval_argv(INTERVAL_CHECK_NOREF, 'cg-mg'), quiet=True)
    errC = outC['errors'].toDict()['L2 error']
    H, dm = outC['A'], outC['dm']
    del outC
    D = asm.assembleNonlocal(dm, prob['kernel'], matrixFormat='dense',
                             device='cuda')
    x = torch.randn(dm.num_dofs, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(12))
    ref = D.matvec(x)
    rel = float(torch.linalg.norm(H.matvec(x) - ref) / torch.linalg.norm(ref))
    if not rel <= TOL_H2_DENSE:
        raise AssertionError(f'interval H2 vs dense at noRef '
                             f'{INTERVAL_CHECK_NOREF}: {rel}')
    log(f'  {dm.num_dofs} dofs: H2 vs dense apply relative error {rel:.3e} '
        f'(<= {TOL_H2_DENSE}); CG-MG L2 error {errC:.6e}')
    del H, D, dm
    torch.cuda.empty_cache()

    log(f'  the full-width line: interval noRef {INTERVAL_NOREF}, H2 CG-MG')
    recNames = {'block_near_count': (lambda offI, *a: offI.shape[0], False),
                'block_near_quad': (lambda data, pairs, *a: pairs[0].shape[0],
                                    True),
                'near_enum': (lambda cum, *a: int(cum[-1]), False),
                'near_enum_quad': (lambda data, ids, *a: ids.shape[0], True),
                'far_field': (lambda gi, *a: gi.shape[0], False),
                'panel_scatter_slots': (lambda d, v, vi1, *a: vi1.shape[0],
                                        True),
                'panel_scatter_tree': (lambda d, v, vi1, *a: vi1.shape[0],
                                       True)}
    with contextlib.ExitStack() as stack:
        recs = {n: stack.enter_context(ArgRecorder(asm, n, dataFirst=df,
                                                   size=size))
                for n, (size, df) in recNames.items()}
        out, counts['mg16'] = run_main_path(
            interval_argv(INTERVAL_NOREF, 'cg-mg'), MG_PATH)
    errs = out['errors'].toDict()
    if not errs['L2 error'] < errC:
        raise AssertionError(f"noRef {INTERVAL_NOREF} L2 error "
                             f"{errs['L2 error']} not below noRef "
                             f'{INTERVAL_CHECK_NOREF} {errC}')
    hierarchy, tim = out['hierarchy'], out['timers'].toDict()
    for k in range(len(hierarchy)):
        parts = out['levelParts'][k]
        log(f"  level {k}: {hierarchy[k]['A'].num_rows} dofs, assembly "
            f"{tim[f'assembly level {k} seconds']:.3f} s: " + ', '.join(
                f'{p} {v:.3f}' for p, v in parts.items()))
    M = out['solver'].prec
    b = torch.randn(M.num_rows, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(13))
    z = torch.empty_like(b)
    M.matvec(b, out=z)
    perCycle = timed(lambda: [M.matvec(b, out=z) for _ in range(10)]) / 10
    solver, dm = out['solver'], out['dm']
    rhs = assembleRHS(dm, prob['rhs'], qOrder=3).data
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.solve(rhs)
    torch.cuda.synchronize()
    tWarm = time.perf_counter() - t0
    summary = {'dofs': dm.num_dofs, 'levels': len(hierarchy),
               'iterations': out['results'].toDict()['iterations'],
               'L2_error': errs['L2 error'],
               'L2_error_noRef12': errC,
               'assembly_s': tim['assembly seconds'],
               'solve_s': tim['solve seconds'], 'warm_solve_s': tWarm,
               'vcycle_ms': perCycle,
               'peak_GiB': torch.cuda.max_memory_allocated() / 2 ** 30}
    log(f'  summary: {json.dumps(summary)}')
    log(f'  kernels against their plain versions at the noRef '
        f'{INTERVAL_NOREF} shapes (the largest call of each; K8 on every '
        'level of the hierarchy, timed on the finest)')
    A, P = hierarchy[-1]['A'], hierarchy[-1]['P']
    k8 = [compare_h2_matvec(lv['A'], reps=10 if k == len(hierarchy) - 1
                            else 1, label=f' level {k}')
          for k, lv in enumerate(hierarchy)]
    mg = {'h2_matvec': dict(k8[-1], err=max(r['err'] for r in k8)),
          'csr_spmv': compare_csr_spmv(P),
          'jacobi_smooth': compare_jacobi_smooth(P.num_rows),
          'pcg_update': compare_pcg_forms(
              A, rhs, M, f'interval noRef {INTERVAL_NOREF}',
              iters=out['results'].toDict()['iterations'] - 1)}
    del out, hierarchy, M, solver, z, A, P
    torch.cuda.empty_cache()
    mg.update(compare_h2_build(recs))
    mg['block_near_count'] = compare_block_count(
        recs['block_near_count'].calls)[0]
    mg['block_near_quad'] = compare_target_kernel(
        'block_near_quad', recs['block_near_quad'].calls,
        asm.block_near_quad, asm._block_near_quad_plain, block_quad_work)
    mg['panel_scatter'] = merge(mg.pop('panel_scatter_slots'),
                                mg.pop('panel_scatter_tree'))
    # per kernel: the smooth profiles' comparisons and the noRef 16 line's
    cmp = {}
    for name in INTERVAL_KERNELS:
        rs = [byProfile[k][name] for k in byProfile if name in byProfile[k]]
        if name in mg:
            rs.append(mg[name])
        cmp[name] = rs[0] if len(rs) == 1 else merge(*rs)
    return counts, cmp, summary


# ---------------------------------------------------------------- phase 13

def _vo_argv(s, problem, solver, fmt):
    return ['--domain', 'interval', '--s', s, '--problem', problem,
            '--element', 'P1', '--solverType', solver, '--matrixFormat', fmt]


LR = 'twoDomainNonSym(0.25,0.75)'
# tests/test_drivers_fractional.py:121-167 (VARIABLE_CONFIGS): argv, the
# pinned reference values (rtol 3e-2), and the JAX package's outputs of
# the same driver line (default noRef 6, 127 dofs; CPU, float64) with its
# iterations, held to TOL_INTERVAL_JAX relative and +-1 iteration.
VARIABLE_LINES = (
    ('varconst', _vo_argv('varconst(0.75)', 'constant', 'cg-jacobi', 'dense'),
     {'Hs error': 0.041842962898268554, 'L2 error': 0.0014584869817160686,
      'Linf error interpolated': 0.0009870492444583046},
     {'L2 error': 0.0014584876514333886,
      'L2 error interpolated': 0.0010892434381019561,
      'Linf error interpolated': 0.0009870496485860358,
      'Hs error': 0.04184297753455954}, 41),
    ('constantNonSym', _vo_argv('constantNonSym(0.25)', 'constant',
                                'gmres-jacobi', 'dense'),
     {'Hs error': 0.09611243700814974, 'L2 error': 0.0266553185536795,
      'Linf error interpolated': 0.04664216828925677},
     {'L2 error': 0.026655322723040574,
      'L2 error interpolated': 0.008022626666842203,
      'Linf error interpolated': 0.04664203600833766,
      'Hs error': 0.09611246910485544}, 9),
    ('twoDomainNonSym', _vo_argv(LR, 'knownSolution', 'lu', 'dense'),
     {'L2 error': 0.0020560901451394443,
      'Linf error interpolated': 0.003599161364716205},
     {'L2 error': 0.0020165419394079244,
      'L2 error interpolated': 0.0012040812422250483,
      'Linf error interpolated': 0.0036074442982775012}, 1),
    ('constantNonSym-H2', _vo_argv('constantNonSym(0.25)', 'constant',
                                   'gmres-jacobi', 'H2'),
     {'L2 error': 0.02665532198267176},
     {'L2 error': 0.026655317676124377,
      'L2 error interpolated': 0.008022571820942168,
      'Linf error interpolated': 0.046641894707784626,
      'Hs error': 0.09611199629077337}, 9),
    ('twoDomainNonSym-H2-lu', _vo_argv(LR, 'knownSolution', 'lu', 'H2'),
     {'L2 error': 0.001968154983051443},
     {'L2 error': 0.0020155700017095396,
      'L2 error interpolated': 0.001202654921585978,
      'Linf error interpolated': 0.0036095994277783594}, 1),
    ('twoDomainNonSym-H2-mg', _vo_argv(LR, 'knownSolution', 'gmres-mg', 'H2'),
     {'L2 error': 0.001968148149500615},
     {'L2 error': 0.002015603941010537,
      'L2 error interpolated': 0.0012026945043101618,
      'Linf error interpolated': 0.0036093081028042984}, 5))
# the kernels each of those paths must launch
VO_DENSE_NONSYM = ('panel_scatter', 'panel_scatter_nonsym',
                   'panel_scatter:dense', 'panel_scatter_nonsym:dense')
VO_H2 = ('panel_scatter', 'panel_scatter_nonsym', 'far_field', 'h2_matvec',
         'panel_scatter:tree', 'panel_scatter_nonsym:slots')
VO_PATHS = {
    'varconst': DENSE_PATH,
    'constantNonSym': VO_DENSE_NONSYM + ('gmres_arnoldi',),
    'twoDomainNonSym': VO_DENSE_NONSYM,
    'constantNonSym-H2': VO_H2 + ('gmres_arnoldi',),
    'twoDomainNonSym-H2-lu': VO_H2,
    'twoDomainNonSym-H2-mg': VO_H2 + ('gmres_arnoldi', 'csr_spmv',
                                      'jacobi_smooth')}
VO_TRANSPOSE_PATH = VO_H2 + ('h2_matvec_T',)
VO_NOREF = 14
VO_CHECK_NOREF = 12
# the L2 error of twoDomainNonSym(0.25,0.75) knownSolution lu H2 at noRef
# VO_CHECK_NOREF: the JAX driver's (drivers/runFractional.py on the CPU,
# float64).  Far above the dense line's: the JAX package's H2 fault of a
# variable order (ROADMAP.md section C), which the port mirrors; held to
# TOL_INTERVAL_JAX relative
JAX_VO_CHECK_H2_L2 = 0.09597993396216485
# the full-width line's host set-up limit: above it noRef 12 is run instead
VO_HOST_LIMIT = 300.0
# operations of one variable-order kernel evaluation (two pow, two lgamma,
# an exp, a division and about ten products and sums)
VO_EVAL_OPS = 16
_VO_FULL = (f'the noRef {VO_NOREF} twoDomainNonSym(0.25,0.75) gmres-mg H2 '
            'line (15 levels, 32,767 dofs)')
VO_COMPARED_AT = {
    'panel_scatter': (
        'interval, twoDomainNonSym(0.25,0.75) (order code 2) and '
        'constantNonSym(0.25) (code 1): the dense target on the '
        f'zero-exterior calls of the noRef 6 and {VO_CHECK_NOREF} dense '
        'builds; the tree target (y shift) on all calls of the noRef '
        f'{VO_CHECK_NOREF} H2 build, its pairs also through the dense and '
        f'the slots targets, and on all calls of {_VO_FULL}'),
    'far_field': ('all calls of the noRef 6 H2 builds of twoDomainNonSym '
                  f'and constantNonSym, and the largest of {_VO_FULL}'),
    'h2_matvec': f'every level of {_VO_FULL}, timed on the finest, per apply',
    'csr_spmv': (f'{_VO_FULL}: P x and P^T r of its finest level, per pair '
                 'of products'),
    'jacobi_smooth': f'{_VO_FULL}: its three modes at the finest size, per set',
    'gmres_arnoldi': (f'{_VO_FULL}: one cycle of the solve\'s iterations on '
                      'the finest operator and right-hand side, per cycle'),
}


def vo_main_path(argv, path):
    """run_main_path of a variable-order line on the card at noRef
    ``argv``'s; its errors must be finite."""
    return run_main_path(argv + ['--device', 'cuda', '--maxiter',
                                 str(MG_MAXITER)], path)


def check_variable_line(label, out, pins, jaxOut, its):
    """The pinned reference values (rtol 3e-2) and the JAX outputs
    (TOL_INTERVAL_JAX relative), iterations within +-1."""
    res, errs = out['results'].toDict(), out['errors'].toDict()
    bad = [f'{k}: {errs[k]} vs pin {v}' for k, v in pins.items()
           if not abs(errs[k] - v) <= RTOL_ERRORS * abs(v)]
    bad += [f'{k}: {errs[k]} vs JAX {v}' for k, v in jaxOut.items()
            if not abs(errs[k] - v) <= TOL_INTERVAL_JAX * abs(v)]
    if ('Hs error' in errs) != ('Hs error' in jaxOut):
        bad.append('the Hs error is reported where the JAX driver does not '
                   'report it, or the other way round')
    if res['dofs'] != 127 or abs(res['iterations'] - its) > 1:
        bad.append(f"dofs {res['dofs']}, iterations {res['iterations']} vs "
                   f'127, {its}')
    if bad:
        raise AssertionError(f'{label}: ' + '; '.join(bad))
    log(f"  {label}: iterations {res['iterations']}, L2 error "
        f"{errs['L2 error']:.9e}: the pins (rtol {RTOL_ERRORS}) and the JAX "
        f'outputs (rtol {TOL_INTERVAL_JAX})')


def nonsym_work(args):
    """K19 on recorded args (N or nnz+1, vertices, vi1, vi2, index, volsym,
    bary_x, bary_y, w, PHIxPSI, PHIyPSI, profile, order): per pair and node
    the positions, r^2, two kernel evaluations and 2 nPSI^2 multiply-adds
    each way; the touched entries read and written once."""
    vertices, vi1, vi2 = args[1], args[2], args[3]
    w, PX = args[8], args[9]
    P, Q, nn, dim = vi1.shape[0], w.shape[0], PX.shape[1], vertices.shape[1]
    ops = P * Q * (2 * dim * (vi1.shape[1] + vi2.shape[1]) + 3 * dim + 4
                   + 2 * VO_EVAL_OPS + 4 * nn)
    return (nbytes(args[1:11]) + 16 * P * nn, ops, F64_PEAK)


def panel_order_work(args):
    """panel_work with a variable order's evaluation per node."""
    b, ops, peak = panel_work(args)
    return (b, ops + args[2].shape[0] * args[-3].shape[0] * VO_EVAL_OPS,
            peak)


def compare_h2_matvec_T(H, reps=10, label=''):
    """K20: ``reps`` transposed applies each way after an untimed one;
    returns the result() per apply."""
    import torch
    from pynucleus_tpu_torch.nl import h2
    x = torch.randn(H.num_rows, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(1))
    yk = torch.empty_like(x)
    h2.h2_matvec_T(H, x, out=yk), h2._h2_matvec_T_plain(H, x)
    ms = timed(lambda: [h2.h2_matvec_T(H, x, out=yk) for _ in range(reps)])
    yp = []
    plain_ms = timed(lambda: [yp.append(h2._h2_matvec_T_plain(H, x))
                              for _ in range(reps)])
    err = float((yk - yp[-1]).abs().max())
    scale = float(yp[-1].abs().max())
    if not (scale > 0 and err <= TOL_KERNEL * scale):
        raise AssertionError(f'h2_matvec_T: max err {err} (max {scale})')
    log(f'  h2_matvec_T{label}: {reps} applies, max abs err {err:.3e} (rel '
        f'{err / scale:.3e}), kernel {ms / reps:.3f} ms, plain '
        f'{plain_ms / reps:.3f} ms per apply')
    # the work of K8's apply, plus the atomics of the column scatter
    b, ops, peak = h2_matvec_work(H)
    return result(err, ms / reps, plain_ms / reps,
                  [(b, ops + H.Anear.nnz, peak)])


def _k19_plain(target):
    import pynucleus_tpu_torch.nl.assembly as asm

    def plain(out, vertices, vi1, vi2, index, *rest):
        return asm._panel_scatter_nonsym_plain(out, target, index, vertices,
                                               vi1, vi2, *rest)
    return plain


def _k1_synthetic(calls, N):
    """K1's dense and slots targets with an order and a y shift on the
    pairs of recorded tree-target calls: their dof rows into one dense
    [N, N] A, and every local entry of every call into a slot of its own of
    one CSR data vector."""
    import torch
    dense, slots = [], []
    total = sum(c[0][4].shape[0] * c[0][4].shape[1] ** 2 for c in calls)
    off = 0
    for (shape, *a), kw in calls:
        (vertices, vi1, vi2, dofRows, volsym, normals, I, J, offF, offB,
         tables, bary_x, bary_y, w, PSIP, prof) = a
        P, n = dofRows.shape
        dense.append((((N, N), vertices, vi1, vi2, dofRows, volsym, normals,
                       bary_x, bary_y, w, PSIP, prof), kw))
        sl = torch.arange(off, off + P * n * n, dtype=torch.int32,
                          device=dofRows.device).reshape(P, n * n)
        off += P * n * n
        slots.append((((total + 1,), vertices, vi1, vi2, sl, volsym,
                       normals, bary_x, bary_y, w, PSIP, prof), kw))
    return dense, slots


def phase13():
    """Variable-order and nonsymmetric kernels on the interval: the six
    VARIABLE_CONFIGS lines at noRef 6 (each a path), H2 and its transpose
    against dense at noRef VO_CHECK_NOREF (a path: the transposed apply),
    the full-width line (twoDomainNonSym gmres-mg H2 at noRef VO_NOREF, a
    path) with its build parts, solves, V-cycle and peak memory, and K1
    (order codes, dense, slots and tree targets with the y shift), K7,
    K19 and K20 against their plain versions.  Returns the launch counts
    of its paths, the comparisons and the summary."""
    import contextlib
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch import kernels
    from pynucleus_tpu_torch.drivers.runFractional import main
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    log('phase 13: variable-order and nonsymmetric kernels on the interval '
        '(varconst, constantNonSym, twoDomainNonSym)')
    counts = {}
    k1dense, k7, k19dense = [], [], []
    for label, argv, pins, jaxOut, its in VARIABLE_LINES:
        with ArgRecorder(asm, 'panel_scatter', dataFirst=True) as r1, \
                ArgRecorder(asm, 'far_field') as r7, \
                ArgRecorder(asm, 'panel_scatter_nonsym', dataFirst=True) \
                as r19:
            out, counts[label] = vo_main_path(argv, VO_PATHS[label])
        check_variable_line(label, out, pins, jaxOut, its)
        if label != 'varconst':
            k1dense += r1.calls
            k7 += r7.calls
            k19dense += r19.calls
        del out

    prob = fractionalLaplacianProblem('interval', LR, 'knownSolution')
    log(f'  H2 and its transpose against dense at noRef {VO_CHECK_NOREF} '
        '(the transposed apply a path of its own)')
    from pynucleus_tpu_torch.nl.discretized import buildMeshHierarchy
    meshes, dms, _ = buildMeshHierarchy(prob['mesh'], 'lu', prob['tag'],
                                        VO_CHECK_NOREF, 'P1', 'cuda')
    dmC = dms[-1]
    del meshes
    with ArgRecorder(asm, 'panel_scatter', dataFirst=True) as r1, \
            ArgRecorder(asm, 'panel_scatter_nonsym', dataFirst=True,
                        size=lambda A, v, vi1, *a: vi1.shape[0]) as r19:
        D = asm.assembleNonlocal(dmC, prob['kernel'], matrixFormat='dense',
                                 device='cuda').data
    torch.cuda.synchronize()
    k1dense += r1.calls
    k19dense += r19.calls
    torch.cuda.empty_cache()
    kernels.resetLaunches()
    # K1's tree target with the y shift: all calls of this build (the two
    # runs over a jump facet nearly cancel in a slot, so one call alone can
    # leave sums far below its items' size)
    with ArgRecorder(asm, 'panel_scatter_tree', dataFirst=True) as rTree:
        H = asm.assembleNonlocal(dmC, prob['kernel'], matrixFormat='H2',
                                 device='cuda')
    x = torch.sin(torch.linspace(-1.0, 1.0, dmC.num_dofs,
                                 dtype=torch.float64, device='cuda'))
    yF, yT = H.matvec(x), H.T.matvec(x)
    torch.cuda.synchronize()
    counts['transpose'] = dict(kernels.launches)
    counts['transpose']['device'] = dict(kernels.deviceLaunches)
    for k in VO_TRANSPOSE_PATH:
        if counts['transpose'][k] <= 0:
            raise AssertionError(f'kernel {k} was not launched by the '
                                 'transposed-apply path')
    eFwd = float(torch.linalg.norm(yF - D @ x))
    eT = float(torch.linalg.norm(yT - D.T @ x))
    if not (eT < max(1e-5, 3.0 * eFwd)
            and eFwd <= TOL_H2_DENSE * float(torch.linalg.norm(D @ x))):
        raise AssertionError(f'H2 vs dense at noRef {VO_CHECK_NOREF}: eFwd '
                             f'{eFwd}, eT {eT}')
    log(f'  {dmC.num_dofs} dofs, dense {D.numel() * 8 / 1e6:.0f} MB: '
        f'|H x - A x| {eFwd:.3e}, |H^T x - A^T x| {eT:.3e} (< max(1e-5, '
        f'3 eFwd), tests/test_h2_transpose.py:33); relative '
        f'{eFwd / float(torch.linalg.norm(D @ x)):.3e} and '
        f'{eT / float(torch.linalg.norm(D.T @ x)):.3e}')
    # the solutions of both operators by LU: their errors (the JAX package
    # gives the H2 line a larger error than the dense one from noRef 8 on,
    # ROADMAP.md section C; the port follows it)
    from pynucleus_tpu_torch.nl.discretized import modelErrors
    bC = assembleRHS(dmC, prob['rhs'], qOrder=3)
    checkErrs = {}
    for what, Ad in (('dense', D), ('H2', torch.as_tensor(
            H.toarray(), dtype=torch.float64, device='cuda'))):
        lu, piv = torch.linalg.lu_factor(Ad)
        u = torch.linalg.lu_solve(lu, piv, bC.data[:, None])[:, 0]
        checkErrs[what] = modelErrors(dmC, u, bC.data,
                                      prob['analyticSolution'],
                                      prob['exactL2Squared'], None)
        del Ad, lu, piv
    log(f'  noRef {VO_CHECK_NOREF} lu: L2 error dense '
        f"{checkErrs['dense']['L2 error']:.6e}, H2 "
        f"{checkErrs['H2']['L2 error']:.9e}; L2 error interpolated dense "
        f"{checkErrs['dense']['L2 error interpolated']:.6e}, H2 "
        f"{checkErrs['H2']['L2 error interpolated']:.6e}")
    eH2 = checkErrs['H2']['L2 error']
    if not abs(eH2 - JAX_VO_CHECK_H2_L2) <= \
            TOL_INTERVAL_JAX * JAX_VO_CHECK_H2_L2:
        raise AssertionError(f'noRef {VO_CHECK_NOREF} H2 lu: L2 error {eH2} '
                             f'vs the JAX driver {JAX_VO_CHECK_H2_L2}')
    log(f'  the H2 lu L2 error is the JAX driver\'s {JAX_VO_CHECK_H2_L2:.9e} '
        f'(rtol {TOL_INTERVAL_JAX})')
    k20 = [compare_h2_matvec_T(H, label=f' noRef {VO_CHECK_NOREF}')]
    tree = rTree.calls
    k1d, k1s = _k1_synthetic(tree, dmC.num_dofs)
    del D, H, yF, yT, dmC, dms
    torch.cuda.empty_cache()

    # the full-width line
    noRef = VO_NOREF
    # K1's tree target: all calls (the two runs over a jump facet nearly
    # cancel in a slot, so the calls of a level are compared together)
    recNames = {'far_field': (lambda gi, *a: gi.shape[0], False),
                'panel_scatter_nonsym_slots': (
                    lambda d, v, vi1, *a: vi1.shape[0], True),
                'panel_scatter_tree': (None, True)}
    while True:
        log(f'  the full-width line: {LR} knownSolution gmres-mg H2 at '
            f'noRef {noRef}')
        with contextlib.ExitStack() as stack:
            recs = {n: stack.enter_context(ArgRecorder(asm, n, dataFirst=df,
                                                       size=size))
                    for n, (size, df) in recNames.items()}
            out, counts['full'] = vo_main_path(
                _vo_argv(LR, 'knownSolution', 'gmres-mg', 'H2')
                + ['--noRef', str(noRef)], VO_PATHS['twoDomainNonSym-H2-mg'])
        # the build parts but the far field (K7), the operator's set-up and
        # the split (a part of the plan), on every level
        host = sum(v for p in out['levelParts'].values() for k, v in p.items()
                   if k not in ('far field', 'near operator set-up',
                                'plan (split leaves)'))
        if host <= VO_HOST_LIMIT or noRef == VO_CHECK_NOREF:
            break
        log(f'  host set-up {host:.1f} s > {VO_HOST_LIMIT} s: noRef '
            f'{VO_CHECK_NOREF} instead')
        noRef = VO_CHECK_NOREF
        del out
    errs = out['errors'].toDict()
    hierarchy, tim = out['hierarchy'], out['timers'].toDict()
    for k in range(len(hierarchy)):
        parts = out['levelParts'][k]
        log(f"  level {k}: {hierarchy[k]['A'].num_rows} dofs, assembly "
            f"{tim[f'assembly level {k} seconds']:.3f} s: " + ', '.join(
                f'{p} {v:.3f}' for p, v in parts.items()))
    M = out['solver'].prec
    b = torch.randn(M.num_rows, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(14))
    z = torch.empty_like(b)
    M.matvec(b, out=z)
    perCycle = timed(lambda: [M.matvec(b, out=z) for _ in range(10)]) / 10
    solver, dm = out['solver'], out['dm']
    rhs = assembleRHS(dm, prob['rhs'], qOrder=3).data
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.solve(rhs)
    torch.cuda.synchronize()
    tWarm = time.perf_counter() - t0
    summary = {'noRef': noRef, 'dofs': dm.num_dofs,
               'levels': len(hierarchy),
               'iterations': out['results'].toDict()['iterations'],
               'L2_error': errs['L2 error'],
               'Linf_error_interpolated': errs['Linf error interpolated'],
               'assembly_s': tim['assembly seconds'],
               'finest_level_parts_s': out['levelParts'][len(hierarchy) - 1],
               'host_setup_s': host,
               'solve_s': tim['solve seconds'], 'warm_solve_s': tWarm,
               'vcycle_ms': perCycle,
               'explicit_residual': tim['explicit residual'],
               'peak_GiB': torch.cuda.max_memory_allocated() / 2 ** 30,
               'noRef12_lu_errors': checkErrs}
    log(f'  summary: {json.dumps(summary)}')
    # finite errors of a converged solve (run_main_path) with the expected
    # dofs; the line is held to the JAX outputs at noRef 6 above
    if dm.num_dofs != 2 ** (noRef + 1) - 1 or not all(
            v == v and v >= 0 and v != float('inf') for v in errs.values()):
        raise AssertionError(f'noRef {noRef}: dofs {dm.num_dofs}, {errs}')
    log(f'  kernels against their plain versions at the noRef {noRef} shapes '
        '(the largest call of each, K1 all its tree-target calls; K8 and K20 '
        'on every level, timed on the finest; K9 on the finest P, K10 at '
        'the finest size, K17 on the finest operator and right-hand side, '
        'one cycle of the solve\'s iterations)')
    last = len(hierarchy) - 1
    k8 = [compare_h2_matvec(lv['A'], reps=10 if k == last else 1,
                            label=f' level {k}')
          for k, lv in enumerate(hierarchy)]
    k20 += [compare_h2_matvec_T(lv['A'], reps=10 if k == last else 1,
                                label=f' level {k}')
            for k, lv in enumerate(hierarchy)]
    A, P = hierarchy[-1]['A'], hierarchy[-1]['P']
    cmp = {'h2_matvec': dict(k8[-1], err=max(r['err'] for r in k8)),
           'csr_spmv': compare_csr_spmv(P),
           'jacobi_smooth': compare_jacobi_smooth(P.num_rows),
           'gmres_arnoldi': compare_gmres_arnoldi(
               A, rhs, restart=max(summary['iterations'], 1))}
    del out, hierarchy, M, solver, z, A, P
    torch.cuda.empty_cache()
    k7 += recs['far_field'].calls
    cmp.update({'h2_matvec_T': dict(k20[-1], err=max(r['err'] for r in k20)),
                'far_field': compare_far_field(k7, 'far_field (orders)')})
    k1 = [compare_target_kernel('panel_scatter (order, dense)', k1dense,
                                asm.panel_scatter, asm._panel_scatter_plain,
                                panel_order_work),
          compare_target_kernel('panel_scatter (order, tree, y shift)', tree,
                                asm.panel_scatter_tree,
                                asm._panel_scatter_tree_plain,
                                panel_order_work),
          compare_target_kernel(f'panel_scatter (order, tree, y shift, noRef '
                                f'{noRef})', recs['panel_scatter_tree'].calls,
                                asm.panel_scatter_tree,
                                asm._panel_scatter_tree_plain,
                                panel_order_work),
          compare_target_kernel('panel_scatter (order, dense, y shift)', k1d,
                                asm.panel_scatter, asm._panel_scatter_plain,
                                panel_order_work),
          compare_target_kernel('panel_scatter (order, slots, y shift)', k1s,
                                asm.panel_scatter_slots,
                                asm._panel_scatter_slots_plain,
                                panel_order_work)]
    cmp['panel_scatter'] = merge(*k1)
    cmp['panel_scatter_nonsym'] = merge(
        compare_target_kernel('panel_scatter_nonsym (dense)', k19dense,
                              asm.panel_scatter_nonsym, _k19_plain('dense'),
                              nonsym_work),
        compare_target_kernel('panel_scatter_nonsym (slots)',
                              recs['panel_scatter_nonsym_slots'].calls,
                              asm.panel_scatter_nonsym_slots,
                              _k19_plain('slots'), nonsym_work))
    return counts, cmp, summary


# ---------------------------------------------------------------- phase 14

# JAX package outputs, run on the CPU in float64 (getDenseVector and getH2
# of nl/assembly.py nonlocalBuilder on the drivers' meshes, x = numpy
# RandomState(14) standard_normal(N)): the interval at noRef 6 (127 dofs),
# per vector line the Frobenius norm of each component and the norms of
# matvec(x) and matvecTrans(x); the disc at noRef 5 (4465 dofs), d^2/ds^2
# of s = 0.75, the norms of A x for the dense operator (params={'denseGrid':
# True}, the grid path, as the port's default) and the H2 operator.  Held
# to TOL_DERIV_JAX relative.
JAX_VECTOR_NOREF6 = {
    'LR2-d1': {'components': [6.517508709957474, 924.1232194495659],
               'matvec': 841.291904101015,
               'matvecTrans': 840.3457653651976},
    'LR2-d2': {'components': [61.4617095320536, 0.0, 0.0,
                              9635.573930541792],
               'matvec': 8835.391851993249,
               'matvecTrans': 8822.673328452054},
    'LR4-d1': {'components': [6.387706986956925, 922.987548784992,
                              1.5734508825023479, 8.90777776800417],
               'matvec': 840.1892407230822,
               'matvecTrans': 840.0775999682043}}
JAX_DISC5_D2 = {'dense': 2142.6239279254646, 'H2': 2142.6968773060808}
TOL_DERIV_JAX = 1e-6
DERIV_PIN_NOREF = 5
DERIV_VECTOR_PIN_NOREF = 6
# the three vector lines: leftRight parameters and derivative
DERIV_VECTOR_LINES = (('LR2-d1', (0.25, 0.75), 1), ('LR2-d2', (0.25, 0.75), 2),
                      ('LR4-d1', (0.25, 0.75, 0.4, 0.6), 1))
# the finite-difference check (tests/test_vector_assembly.py:59-80): order
# leftRight(0.3, 0.6), step 1e-5, at noRef DERIV_FD_NOREF
DERIV_FD_NOREF = 8
TOL_DERIV_FD = 5e-4
# dA/ds of s = 0.75 on the disc: H2 against dense at noRef
# DERIV_CHECK_NOREF, the full-width line at DERIV_NOREF
DERIV_CHECK_NOREF = 6
TOL_DERIV_H2 = 5e-4
DERIV_NOREF = 7
# d^2A/ds^2 of leftRight(0.25, 0.75), dense vector on the interval at
# DERIV_VECTOR_NOREF; DERIV_VECTOR_FALLBACK if its host set-up exceeds
# DERIV_HOST_LIMIT seconds
DERIV_VECTOR_NOREF = 12
DERIV_VECTOR_FALLBACK = 11
DERIV_HOST_LIMIT = 300.0
# the kernels each path of phase 14 must launch
DERIV_DENSE_PATH = ('panel_scatter', 'grid_distant', 'grid_boundary',
                    'vector_matvec', 'panel_scatter:dense',
                    'vector_matvec:apply')
DERIV_H2_PATH = ('panel_scatter', 'far_field', 'h2_matvec', 'near_enum',
                 'near_enum_quad', 'block_near_count', 'block_near_quad',
                 'panel_scatter:slots', 'panel_scatter:tree')
DERIV_VEC_PATH = ('panel_scatter_vec', 'panel_scatter_nonsym_vec',
                  'vector_matvec', 'vector_matvec:apply',
                  'vector_matvec:transposed')
# operations of one vector-kernel node term (side, pow, log, the power-log
# polynomial and the log correction)
VEC_TERM_OPS = 14
DERIV_COMPARED_AT = {
    'panel_scatter': 'disc noRef 5, d^2/ds^2 of s = 0.75 (power-log '
                     'profile): the dense target (a dense build) and the CSR '
                     'targets (an H2 build), all calls',
    'grid_distant': 'disc noRef 5, d^2/ds^2 of s = 0.75, all calls',
    'grid_boundary': 'disc noRef 5, d^2/ds^2 of s = 0.75',
    'near_enum_quad': 'disc noRef 5, d^2/ds^2 of s = 0.75, all calls',
    'far_field': 'disc noRef 5, d^2/ds^2 of s = 0.75, all calls',
    'block_near_quad': 'disc noRef 5, d^2/ds^2 of s = 0.75, all calls',
}
COMPARED_AT.update({
    'panel_scatter_vec': 'interval, the three vector lines at noRef 6 and '
                         'leftRight(0.25, 0.75) d^2/ds^2 at noRef 12: all '
                         'calls',
    'panel_scatter_nonsym_vec': 'interval, the three vector lines at noRef 6 '
                                '(all calls) and leftRight(0.25, 0.75) '
                                'd^2/ds^2 at noRef 12 (its largest call)',
    'vector_matvec': 'interval, leftRight(0.25, 0.75) d^2/ds^2 at noRef 12 '
                     '(8,191 x 8,191 x 4): one apply and one transposed '
                     'apply, per pair, library torch.einsum'})


def count_path(label, path, fn):
    """Runs fn() as a main path: every launch count set to 0 just before
    and read just after; each kernel of ``path`` must have launched.
    Returns (fn's result, the counts)."""
    import torch
    from pynucleus_tpu_torch import kernels
    torch.cuda.synchronize()
    kernels.resetLaunches()
    out = fn()
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    counts['device'] = dict(kernels.deviceLaunches)
    for k in path:
        if counts[k] <= 0:
            raise AssertionError(f'kernel {k} was not launched by the '
                                 f'{label} path')
    return out, counts


def vec_work(args):
    """K21 or K22 on recorded args (N, vertices, vi1, vi2, dofRows, volsym,
    bary_x, bary_y, w, P1[, P2], vp, logTables): per pair and node the
    positions, r^2, the node term (twice for K22) and V nPSI^2
    multiply-adds each way; the touched entries of A [N, N, V] read and
    written once (at most all of A, however many pairs share them)."""
    (shape, vertices, vi1, vi2, dofRows, volsym, bx, by, w, P1, *rest) = args
    ways = 2 if len(rest) == 3 else 1
    V = rest[-2].grads.shape[1]
    P, Q, nn, dim = vi1.shape[0], w.shape[0], P1.shape[1], vertices.shape[1]
    ops = P * Q * (2 * dim * (vi1.shape[1] + vi2.shape[1]) + 3 * dim
                   + ways * (VEC_TERM_OPS + 2 * V * nn))
    touched = min(P * nn, shape[0] * shape[1]) * V
    return (nbytes(args[1:]) + 16 * touched, ops, F64_PEAK)


def _vec_plain(nonsym):
    import pynucleus_tpu_torch.nl.assembly as asm
    return asm._panel_scatter_nonsym_vec_plain if nonsym else \
        asm._panel_scatter_vec_plain


def compare_vector_matvec(A, reps=10):
    """K23: ``reps`` applies and transposed applies of the dense vector
    operator's data A [N, M, V] each way, after an untimed one, and one
    torch.einsum call each way; returns the result() per pair of applies."""
    import torch
    from pynucleus_tpu_torch.base.linear_operators import (
        vector_matvec, _vector_matvec_plain)
    N, M, V = A.shape
    x = torch.randn(N, dtype=torch.float64, device='cuda',
                    generator=torch.Generator('cuda').manual_seed(23))
    worst = ms = plain_ms = lib_ms = 0.0
    for trans, eq in ((False, 'nmk,m->nk'), (True, 'nmk,n->mk')):
        vector_matvec(A, x, trans), _vector_matvec_plain(A, x, trans)
        torch.einsum(eq, A, x)
        got, ref = [], []
        ms += timed(lambda: [got.append(vector_matvec(A, x, trans))
                             for _ in range(reps)]) / reps
        plain_ms += timed(lambda: [ref.append(_vector_matvec_plain(A, x,
                                                                   trans))
                                   for _ in range(reps)]) / reps
        lib_ms += timed(lambda: [torch.einsum(eq, A, x)
                                 for _ in range(reps)]) / reps
        err = float((got[-1] - ref[-1]).abs().max())
        scale = float(ref[-1].abs().max())
        if not (scale > 0 and err <= TOL_KERNEL * scale):
            raise AssertionError(f'vector_matvec (trans={trans}): max err '
                                 f'{err} (max {scale})')
        worst = max(worst, err)
    log(f'  vector_matvec: [{N}, {M}, {V}], apply and transposed apply, max '
        f'abs err {worst:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, '
        f'torch.einsum {lib_ms:.3f} ms per pair')
    b = 2 * (nbytes(A) + 8 * N + 8 * max(N, M) * V)
    return result(worst, ms, plain_ms, [(b, 4 * N * M * V, F64_PEAK)],
                  library_ms=lib_ms)


def _seeded(n):
    import numpy as np
    import torch
    return torch.as_tensor(np.random.RandomState(14).standard_normal(n),
                           device='cuda')


def _relclose(got, ref, tol):
    return abs(got - ref) <= tol * abs(ref)


def phase14():
    """The s-derivative operators: the constant order's d^2/ds^2 on the
    disc at noRef 5, dense and H2, and the three vector lines on the
    interval at noRef 6 against the pinned JAX outputs (each a path); the
    finite-difference check of the vector kernel at noRef DERIV_FD_NOREF
    and dA/ds H2 against dense on the disc at noRef DERIV_CHECK_NOREF; the
    full-width lines (dA/ds of the flagship disc at noRef DERIV_NOREF with
    getH2Vector, d^2A/ds^2 of leftRight(0.25, 0.75) dense at noRef
    DERIV_VECTOR_NOREF; each a path), and K21, K22, K23 and the power-log
    profile in K1, K2, K3, K6 (where called), K7 and K12 against their plain
    versions.  Returns the launch counts of its paths, the comparisons of
    K21-K23, those of the power-log profile and the summary."""
    import contextlib
    import numpy as np
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch.nl.discretized import buildMeshHierarchy
    from pynucleus_tpu_torch.nl.kernels import (getFractionalKernel,
                                                leftRightFractionalOrder)
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    log('phase 14: the s-derivative operators (dA/ds, d^2A/ds^2)')
    counts, summary = {}, {}

    def level(domain, noRef):
        """The dofmap of the driver's mesh of ``domain`` at noRef."""
        prob = fractionalLaplacianProblem(domain, 'const(0.75)')
        _, dms, _ = buildMeshHierarchy(prob['mesh'], 'lu', prob['tag'],
                                       noRef, 'P1', 'cuda')
        return dms[-1]

    def disc(noRef):
        return level('disc', noRef)

    def interval(noRef):
        return level('interval', noRef)

    # --- the constant order's d^2/ds^2 on the disc at noRef 5
    dm5 = disc(DERIV_PIN_NOREF)
    k2 = getFractionalKernel(2, 0.75, derivative=2)
    x5 = _seeded(dm5.num_dofs)
    with ArgRecorder(asm, 'panel_scatter', dataFirst=True) as r1, \
            ArgRecorder(asm, 'grid_distant', dataFirst=True) as r2, \
            ArgRecorder(asm, 'grid_boundary', dataFirst=True) as r3:
        y, counts['disc5_dense'] = count_path(
            'disc noRef 5 d2 dense', DERIV_DENSE_PATH,
            lambda: asm.nonlocalBuilder(dm5, k2).getDenseVector().matvec(x5))
    got = float(torch.linalg.norm(y))
    if not _relclose(got, JAX_DISC5_D2['dense'], TOL_DERIV_JAX):
        raise AssertionError(f'disc noRef 5 d2 dense: |A x| {got} vs JAX '
                             f"{JAX_DISC5_D2['dense']}")
    log(f'  disc noRef 5, d^2/ds^2 of s = 0.75, dense: |A x| {got:.12e}, '
        f'the JAX output (rtol {TOL_DERIV_JAX})')
    names = asm.__dict__
    (got, counts['disc5_h2']), recs = record_h2_build(lambda: count_path(
        'disc noRef 5 d2 H2', DERIV_H2_PATH,
        lambda: float(torch.linalg.norm(asm.nonlocalBuilder(dm5, k2)
                                        .getH2Vector().matvec(x5)))),
        H2_BUILD + ENGINE_KERNELS[:2])
    if not _relclose(got, JAX_DISC5_D2['H2'], TOL_DERIV_JAX):
        raise AssertionError(f'disc noRef 5 d2 H2: |H x| {got} vs JAX '
                             f"{JAX_DISC5_D2['H2']}")
    log(f'  disc noRef 5, d^2/ds^2 of s = 0.75, H2 (getH2Vector): |H x| '
        f'{got:.12e}, the JAX output (rtol {TOL_DERIV_JAX})')
    log('  the power-log profile in the kernels against their plain versions '
        '(these two builds)')
    prof = {}
    for n in H2_CSR:
        if recs[n].calls:
            prof[n] = compare_target_kernel(
                n + ' (power-log)', recs[n].calls, names[n],
                names['_' + n + '_plain'],
                enum_quad_work if n == 'near_enum_quad' else panel_work)
    if not (recs['panel_scatter_slots'].calls
            and recs['panel_scatter_tree'].calls and recs['far_field'].calls
            and (recs['block_near_quad'].calls
                 or recs['near_enum_quad'].calls)):
        raise AssertionError('the H2 build made no call of K1 (slots, tree), '
                             'K7, or K6 or K12')
    prof['far_field'] = compare_far_field(recs['far_field'].calls,
                                          'far_field (power-log)')
    if recs['block_near_quad'].calls:
        prof['block_near_quad'] = compare_target_kernel(
            'block_near_quad (power-log)', recs['block_near_quad'].calls,
            asm.block_near_quad, asm._block_near_quad_plain, block_quad_work)
    for name, calls, work in (('panel_scatter', r1.calls, panel_work),
                              ('grid_distant', r2.calls, grid_distant_work),
                              ('grid_boundary', r3.calls,
                               grid_boundary_work)):
        c = compare_target_kernel(f'{name} (power-log, dense)', calls,
                                  names[name], names['_' + name + '_plain'],
                                  work)
        prof[name] = merge(c, *(prof.pop(n) for n in ('panel_scatter_slots',
                                                      'panel_scatter_tree')
                                if name == 'panel_scatter'))
    del recs, r1, r2, r3, dm5, y
    torch.cuda.empty_cache()

    # --- the vector lines on the interval at noRef 6
    dm6 = interval(DERIV_VECTOR_PIN_NOREF)
    x6 = _seeded(dm6.num_dofs)
    k21, k22 = [], []
    for label, sv, d in DERIV_VECTOR_LINES:
        kv = getFractionalKernel(1, leftRightFractionalOrder(*sv),
                                 derivative=d)

        def line():
            A = asm.nonlocalBuilder(dm6, kv).getDenseVector()
            return A, A.matvec(x6), A.matvecTrans(x6)
        with ArgRecorder(asm, 'panel_scatter_vec', dataFirst=True) as rv, \
                ArgRecorder(asm, 'panel_scatter_nonsym_vec',
                            dataFirst=True) as rn:
            (A, y, yT), counts[label] = count_path(
                f'interval noRef 6 {label}', DERIV_VEC_PATH, line)
        k21 += rv.calls
        k22 += rn.calls
        ref = JAX_VECTOR_NOREF6[label]
        got = {'components': [float(torch.linalg.norm(A.data[:, :, v]))
                              for v in range(A.vectorSize)],
               'matvec': float(torch.linalg.norm(y)),
               'matvecTrans': float(torch.linalg.norm(yT))}
        bad = [f'{k}: {got[k]} vs {ref[k]}' for k in ('matvec', 'matvecTrans')
               if not _relclose(got[k], ref[k], TOL_DERIV_JAX)]
        bad += [f'component {v}: {a} vs {b}' for v, (a, b) in enumerate(
            zip(got['components'], ref['components']))
            if not (len(got['components']) == len(ref['components'])
                    and _relclose(a, b, TOL_DERIV_JAX))]
        if bad:
            raise AssertionError(f'{label}: ' + '; '.join(bad))
        log(f"  interval noRef 6 {label}: V {A.vectorSize}, |matvec| "
            f"{got['matvec']:.12e}, |matvecTrans| {got['matvecTrans']:.12e}: "
            f'the JAX outputs (rtol {TOL_DERIV_JAX})')
        if d == 2:
            P = int(round(A.vectorSize ** 0.5))
            H = A.data.reshape(A.num_rows, A.num_rows, P, P)
            sym = float((H[:, :, 0, 1] - H[:, :, 1, 0]).abs().max()
                        / H.abs().max())
            if not sym <= 1e-10:
                raise AssertionError(f'{label}: components (0,1) and (1,0) '
                                     f'differ by {sym}')
            log(f'  {label}: components (0,1) and (1,0) within {sym:.2e}')
        del A, y, yT

    # --- the finite-difference check
    log(f'  d/dp of leftRight(0.3, 0.6) at noRef {DERIV_FD_NOREF} against '
        'central differences of the dense operators (step 1e-5)')
    dmF = interval(DERIV_FD_NOREF)
    kv = getFractionalKernel(1, leftRightFractionalOrder(0.3, 0.6),
                             derivative=1)
    arr = asm.nonlocalBuilder(dmF, kv).getDenseVector().data
    eps = 1e-5

    def plain(a, b):
        return asm.nonlocalBuilder(dmF, getFractionalKernel(
            1, leftRightFractionalOrder(a, b))).getDense().data
    fdErr = []
    for q, (da, db) in enumerate(((eps, 0.0), (0.0, eps))):
        fd = (plain(0.3 + da, 0.6 + db) - plain(0.3 - da, 0.6 - db)) \
            / (2 * eps)
        fdErr.append(float((arr[:, :, q] - fd).abs().max() / fd.abs().max()))
    if not max(fdErr) < TOL_DERIV_FD:
        raise AssertionError(f'finite differences: {fdErr}')
    log(f'  components 0, 1 against the differences: {fdErr[0]:.3e}, '
        f'{fdErr[1]:.3e} of the largest entry (< {TOL_DERIV_FD})')
    summary['fd_rel_err'] = fdErr
    del arr, dmF, dm6
    torch.cuda.empty_cache()

    # --- dA/ds of s = 0.75 on the disc: H2 against dense
    k1 = getFractionalKernel(2, 0.75, derivative=1)
    dmC = disc(DERIV_CHECK_NOREF)
    xC = _seeded(dmC.num_dofs)
    yD = asm.nonlocalBuilder(dmC, k1).getDenseVector().matvec(xC)
    yH = asm.nonlocalBuilder(dmC, k1).getH2Vector().matvec(xC)
    rel = float(torch.linalg.norm(yH - yD) / torch.linalg.norm(yD))
    if not rel < TOL_DERIV_H2:
        raise AssertionError(f'disc noRef {DERIV_CHECK_NOREF} dA/ds: H2 vs '
                             f'dense {rel}')
    log(f'  disc noRef {DERIV_CHECK_NOREF} ({dmC.num_dofs} dofs), dA/ds: H2 '
        f'against dense {rel:.4e} relative on one apply (< {TOL_DERIV_H2})')
    summary['disc_check'] = {'noRef': DERIV_CHECK_NOREF,
                             'dofs': dmC.num_dofs, 'h2_vs_dense': rel}
    del yD, yH, dmC
    torch.cuda.empty_cache()

    # --- the full-width line: dA/ds of the flagship disc in H2
    log(f'  the full-width line: dA/ds of s = 0.75 on the disc at noRef '
        f'{DERIV_NOREF}, getH2Vector')
    dm7 = disc(DERIV_NOREF)
    torch.cuda.reset_peak_memory_stats()

    def flagship():
        b = asm.nonlocalBuilder(dm7, k1)
        t0 = time.perf_counter()
        H = b.getH2Vector()
        torch.cuda.synchronize()
        tB = time.perf_counter() - t0
        return (H, tB, b.timers, timed(lambda: H.matvec(x7)),
                timed(lambda: H.matvecTrans(x7)))
    x7 = _seeded(dm7.num_dofs)
    (H, tBuild, parts, first, firstT), counts['disc7_h2'] = count_path(
        f'disc noRef {DERIV_NOREF} dA/ds H2', DERIV_H2_PATH, flagship)
    ms = timed(lambda: [H.matvec(x7) for _ in range(10)]) / 10
    msT = timed(lambda: [H.matvecTrans(x7) for _ in range(10)]) / 10
    y7 = H.matvec(x7)
    if not (y7.shape == (dm7.num_dofs, 1) and bool(torch.isfinite(y7).all())):
        raise AssertionError(f'noRef {DERIV_NOREF}: H x {y7.shape}')
    peak = torch.cuda.max_memory_allocated()
    del H
    torch.cuda.empty_cache()
    # the device part of the build: a second build under torch.profiler
    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as profiled:
        t0 = time.perf_counter()
        asm.nonlocalBuilder(dm7, k1).getH2Vector()
        torch.cuda.synchronize()
        tProf = time.perf_counter() - t0
    dev = {}
    for ev in profiled.key_averages():
        t = getattr(ev, 'device_time_total', None)
        if t is None:
            t = getattr(ev, 'cuda_time_total', 0)
        if t and ev.device_type.name == 'CUDA':
            dev[ev.key[:48]] = dev.get(ev.key[:48], 0.0) + t / 1e3
    devMs = sum(dev.values())
    summary['disc_full'] = {
        'noRef': DERIV_NOREF, 'dofs': dm7.num_dofs, 'build_s': tBuild,
        'parts_s': {k: round(v, 4) for k, v in parts.items()},
        'profiled_build_s': tProf, 'device_ms': devMs,
        'device_busy_share': devMs / 1e3 / tProf,
        'device_ms_by_kernel': dict(sorted(dev.items(),
                                           key=lambda kv: -kv[1])[:8]),
        'matvec_ms_first': first, 'matvec_ms': ms,
        'matvecTrans_ms_first': firstT, 'matvecTrans_ms': msT,
        'peak_GiB': peak / 2 ** 30, 'norm_Hx': float(torch.linalg.norm(y7))}
    log(f"  summary: {json.dumps(summary['disc_full'])}")
    del y7, dm7
    torch.cuda.empty_cache()

    # --- the full-width line: d^2A/ds^2 of leftRight(0.25, 0.75), dense
    kv = getFractionalKernel(1, leftRightFractionalOrder(0.25, 0.75),
                             derivative=2)
    noRef = DERIV_VECTOR_NOREF
    while True:
        log(f'  the full-width line: d^2A/ds^2 of leftRight(0.25, 0.75) on '
            f'the interval at noRef {noRef}, getDenseVector')
        dmV = interval(noRef)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

        def vectorLine():
            b = asm.nonlocalBuilder(dmV, kv)
            t0 = time.perf_counter()
            b._classifyAll()
            tCls = time.perf_counter() - t0
            A = b.getDenseVector()
            torch.cuda.synchronize()
            return A, tCls, time.perf_counter() - t0

        def apply():
            A, tCls, tAll = vectorLine()
            return A, tCls, tAll, A.matvec(xV), A.matvecTrans(xV)
        xV = _seeded(dmV.num_dofs)
        (A, tCls, tAll, y, yT), counts['vector_full'] = count_path(
            f'interval noRef {noRef} d2 vector', DERIV_VEC_PATH, apply)
        peak = torch.cuda.max_memory_allocated()
        if tCls <= DERIV_HOST_LIMIT or noRef == DERIV_VECTOR_FALLBACK:
            break
        log(f'  host classification {tCls:.1f} s > {DERIV_HOST_LIMIT} s: '
            f'noRef {DERIV_VECTOR_FALLBACK} instead')
        noRef = DERIV_VECTOR_FALLBACK
        del A, y, yT
    if not (bool(torch.isfinite(y).all()) and bool(torch.isfinite(yT).all())):
        raise AssertionError(f'noRef {noRef} vector line: non-finite apply')
    summary['vector_full'] = {
        'noRef': noRef, 'dofs': dmV.num_dofs, 'V': A.vectorSize,
        'GB': A.data.numel() * 8 / 1e9, 'build_s': tAll,
        'host_classification_s': tCls, 'peak_GiB': peak / 2 ** 30,
        'norm_matvec': float(torch.linalg.norm(y)),
        'norm_matvecTrans': float(torch.linalg.norm(yT))}
    log(f"  summary: {json.dumps(summary['vector_full'])}")
    del y, yT
    log(f'  K21, K22 and K23 against their plain versions (the noRef 6 lines '
        f'and noRef {noRef}, its calls recorded in a second build)')
    cmp = {'vector_matvec': compare_vector_matvec(A.data)}
    del A
    torch.cuda.empty_cache()
    with ArgRecorder(asm, 'panel_scatter_vec', dataFirst=True) as rv, \
            ArgRecorder(asm, 'panel_scatter_nonsym_vec', dataFirst=True,
                        size=lambda A, v, vi1, *a: vi1.shape[0]) as rn:
        asm.nonlocalBuilder(dmV, kv).getDenseVector()
    k21 += rv.calls
    k22 += rn.calls
    del dmV
    torch.cuda.empty_cache()
    cmp['panel_scatter_vec'] = compare_target_kernel(
        'panel_scatter_vec', k21, asm.panel_scatter_vec, _vec_plain(False),
        vec_work)
    cmp['panel_scatter_nonsym_vec'] = compare_target_kernel(
        'panel_scatter_nonsym_vec', k22, asm.panel_scatter_nonsym_vec,
        _vec_plain(True), vec_work)
    torch.cuda.empty_cache()
    return counts, cmp, prof, summary


# ---------------------------------------------------------------- phase 15

# JAX package outputs of `drivers/runHelmholtz.py --domain D [--problem
# P]`, run on the CPU in float64 (the results group, to full precision)
JAX_HELMHOLTZ = {
    ('interval', 'wave'): {'DoFs': 129, 'numIter': 23,
                           'res': 4.38928474391897e-06,
                           'solution L2 norm': 0.9999999758530215,
                           'L2 error': 1.5359002813128508e-06},
    ('interval', 'greens'): {'DoFs': 129, 'numIter': 11,
                             'res': 7.5679531697032636e-06,
                             'solution L2 norm': 0.00027988735977089665},
    ('square', 'wave'): {'DoFs': 66049, 'numIter': 26,
                         'res': 9.518279657696444e-06,
                         'solution L2 norm': 1.0000000471161223,
                         'L2 error': 1.0066312136028506e-05},
}
# the pinned outputs are held to 1e-6 relative (numIter equal), and the
# square's solution L2 norm to 1 within 1e-5 (tests/test_helmholtz.py)
TOL_HELMHOLTZ = 1e-6
HELMHOLTZ_PATH = ('csr_scatter', 'csr_spmv:complex', 'jacobi_smooth:complex',
                  'gmres_arnoldi:complex')
COMPLEX_INFO = {
    'csr_spmv:complex': KERNEL_INFO['csr_spmv'],
    'jacobi_smooth:complex': KERNEL_INFO['jacobi_smooth'],
    'gmres_arnoldi:complex': KERNEL_INFO['gmres_arnoldi'],
}
COMPLEX_COMPARED_AT = {
    'csr_spmv:complex': 'the Helmholtz square (66,049 dofs): the finest '
                        'complex operator A and the real P and P^T of '
                        'levels 16,641 -> 66,049 on complex vectors, per '
                        'set of three products',
    'jacobi_smooth:complex': 'the Helmholtz square: n 66,049, its three '
                             'modes, per set',
    'gmres_arnoldi:complex': 'the Helmholtz square: one restart cycle of 10 '
                             'steps on the complex A and the combine, per '
                             'cycle',
}


def helmholtz_argv(domain, problem='wave'):
    return ['--domain', domain, '--problem', problem, '--device', 'cuda']


def check_helmholtz(out, domain, problem):
    """The driver's results against the pinned JAX outputs: DoFs and
    numIter equal, the rest within TOL_HELMHOLTZ relative; the square's
    solution L2 norm within 1e-5 of 1, the interval's wave line the
    reference cache (tests/test_helmholtz.py:11-17)."""
    ref = JAX_HELMHOLTZ[(domain, problem)]
    r = out['results'].toDict()
    bad = []
    if out['info'].toDict()['DoFs'] != ref['DoFs']:
        bad.append(f"DoFs {out['info'].toDict()['DoFs']}")
    if r['numIter'] != ref['numIter']:
        bad.append(f"numIter {r['numIter']} != JAX {ref['numIter']}")
    rel = {}
    for label in ('res', 'solution L2 norm', 'L2 error'):
        if label in ref:
            rel[label] = abs(r[label] - ref[label]) / abs(ref[label])
            if rel[label] > TOL_HELMHOLTZ:
                bad.append(f'{label} {r[label]} vs JAX {ref[label]}')
    if problem == 'wave' and not abs(r['solution L2 norm'] - 1.0) <= 1e-5:
        bad.append(f"solution L2 norm {r['solution L2 norm']} not 1")
    if (domain, problem) == ('interval', 'wave') and not (
            abs(r['numIter'] - 24) <= 1 and r['L2 error'] < 5e-6):
        bad.append('the reference cache')
    log(f'  {domain} {problem}: {json.dumps(r)} (relative to JAX: '
        f'{json.dumps(rel)})')
    if bad:
        raise AssertionError(f'runHelmholtz {domain} {problem}: '
                             + '; '.join(bad))
    return rel


def phase15():
    """The Helmholtz path (runHelmholtz, complex128): K9, K10 and K17's
    complex variants against their plain versions at the square's shapes;
    the interval's wave and greens lines and the square (66,049 dofs; each
    a path) against the pinned JAX outputs, with the square's host set-up
    parts, multigrid set-up, solve, a V-cycle, a GMRES step and the peak
    memory.  Returns the launch counts, the comparisons and a summary."""
    import torch
    from pynucleus_tpu_torch.drivers.runHelmholtz import main
    log('phase 15: the Helmholtz path (runHelmholtz, complex128 GMRES with '
        'a complex-shifted V-cycle)')
    counts = {}
    for problem in ('wave', 'greens'):
        out, counts[f'interval_{problem}'] = count_path(
            f'interval {problem}', HELMHOLTZ_PATH,
            lambda: main(helmholtz_argv('interval', problem), quiet=True))
        check_helmholtz(out, 'interval', problem)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, counts['square'] = count_path(
        'square wave', HELMHOLTZ_PATH,
        lambda: main(helmholtz_argv('square'), quiet=True))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    for label, c in counts.items():
        for k in ('csr_spmv', 'jacobi_smooth', 'gmres_arnoldi'):
            # every launch of the paths is a complex one: the device counts
            # are the complex variants'
            if c[k] != c[k + ':complex']:
                raise AssertionError(f'{k}: real launches on the Helmholtz '
                                     f'path {label}')
    log('  launches: ' + json.dumps({k: counts['square'][k]
                                     for k in HELMHOLTZ_PATH}))
    rel = check_helmholtz(out, 'square', 'wave')
    tim = out['timers'].toDict()
    log('  the square (s): ' + ', '.join(
        f'{k[:-len(" seconds")]} {v:.4f}' for k, v in tim.items()
        if k.endswith(' seconds')) + f'; the driver {wall:.3f} s, peak '
        f'device memory {peak / 2**30:.3f} GiB')
    ml, b, gm, A = out['ml'], out['b'], out['gmres'], out['A']
    M = ml.asPreconditioner()
    z = torch.empty_like(b)
    M.matvec(b, out=z)
    vcycle = timed(lambda: [M.matvec(b, out=z) for _ in range(10)]) / 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gm.solve(b)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    steps = len(gm.residuals) - 1
    log(f'  V-cycle ({len(ml.levels.As)} levels, 2+2 sweeps) {vcycle:.4f} ms '
        f'(CUDA events over 10); warm GMRES solve {warm:.4f} s, {steps} '
        f'steps, {warm / steps * 1e3:.3f} ms a step')
    summary = {'dofs': A.num_rows, 'levels': len(ml.levels.As),
               'numIter': out['results'].toDict()['numIter'],
               'wall_s': wall, 'timers_s': {k: v for k, v in tim.items()
                                            if k.endswith(' seconds')},
               'peak_GiB': peak / 2**30, 'vcycle_ms': vcycle,
               'warm_solve_s': warm, 'ms_per_step': warm / steps * 1e3,
               'relative_to_jax': rel}
    P = out['hierarchy'][-1]['P']
    del out, M, z, gm
    torch.cuda.empty_cache()
    log('  complex kernels against their plain versions at the square\'s '
        'shapes')
    cmp = {'csr_spmv:complex': compare_csr_spmv(P, dtype=torch.complex128,
                                                extra=(A,)),
           'jacobi_smooth:complex': compare_jacobi_smooth(
               A.num_rows, dtype=torch.complex128),
           'gmres_arnoldi:complex': compare_gmres_arnoldi(A, b)}
    k17 = cmp['gmres_arnoldi:complex']
    summary['k17_ms_per_step'] = (k17['ms'] - k17['combine_ms']) / 10
    log(f'  summary: {json.dumps(summary)}')
    return counts, cmp, summary


def main():
    try:
        import torch
    except ImportError:
        sys.exit('chip_smoke: torch is not installed')
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: torch.cuda.is_available() is False')
    if not os.path.isdir(os.path.join(HERE, 'pynucleus_tpu_torch')):
        sys.exit('chip_smoke: run it from a checkout of the repository')
    sys.path.insert(0, HERE)
    from pynucleus_tpu_torch import kernels

    smi = run(['nvidia-smi', '--query-gpu=name,power.limit',
               '--format=csv,noheader'])
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f'nvidia-smi failed: {smi.stderr.strip()}'
    log('phase 1: card', card)
    import triton
    log('  python', sys.version.split()[0], 'torch', torch.__version__,
        'CUDA', torch.version.cuda, 'triton', triton.__version__)
    nvcc = run([kernels._nvcc(), '--version'])
    log('  nvcc:', nvcc.stdout.strip().splitlines()[-1] if nvcc.returncode == 0
        else nvcc.stderr.strip())
    t0 = time.perf_counter()
    lib = kernels.buildLibrary()
    kernels.library()
    log(f'  built {os.path.relpath(lib, HERE)} in '
        f'{time.perf_counter() - t0:.1f} s')

    cmp = phase2()
    errs5 = phase3()
    counts6, errs6, A6, dm6 = phase4(errs5)
    phase5(A6, dm6)
    del A6
    counts7, cmp7, errs7 = phase6(errs6)
    phase7()
    counts8, cmp8 = phase8(errs7)
    counts9 = phase9()
    countsI, countsS, cmp10 = phase10()
    countsG, cmp11 = phase11()
    counts12, cmp12, _ = phase12()
    counts13, cmp13, summary13 = phase13()
    counts14, cmp14, prof14, summary14 = phase14()
    counts15, cmp15, summary15 = phase15()

    # K1 is one kernel with four targets: the dense one compared at the
    # noRef 4 shapes, the CSR ones at the H2 main path's, the cross one at
    # the finite-horizon path's
    cmp['panel_scatter'] = merge(cmp['panel_scatter'],
                                 cmp7.pop('panel_scatter_slots'),
                                 cmp7.pop('panel_scatter_tree'),
                                 cmp10.pop('panel_scatter_cross'))
    cmp.update(cmp7)
    cmp.update(cmp8)
    cmp.update(cmp10)
    cmp.update(cmp11)
    paths = ((DENSE_PATH, 'dense_noRef6', counts6),
             (H2_PATH, f'h2_cg_jacobi_noRef{H2_NOREF}', counts7),
             (MG_PATH, f'h2_cg_mg_noRef{H2_NOREF}', counts8),
             (HOST_PATH, 'h2_host_engine_noRef5', counts9),
             (INTERVAL_PATH, 'fh_interval_sparse_noRef6', countsI),
             (NONLOCAL_PATH, f'fh_square_sparse_cg_mg_noRef{FH_NOREF}',
              countsS),
             (SERIAL_PATH, f'serial_gmg_square_noRef{SERIAL_NOREF}',
              countsG),
             (INTERVAL_LU_PATH, 'h2_lu_interval_noRef6', counts12['lu']),
             (INTERVAL_LU_PATH, 'h2_lu_gaussian_interval_noRef8',
              counts12['gaussian']),
             (INTERVAL_LU_PATH, 'h2_lu_exponential_interval_noRef8',
              counts12['exponential']),
             (INTERVAL_LU_PATH, f'h2_lu_gaussian_square_noRef{SQUARE_NOREF}',
              counts12['square']),
             (SMOOTH_CG_PATH,
              f'h2_cg_jacobi_gaussian_interval_noRef{SMOOTH_NOREF}',
              counts12['gaussian14']),
             (MG_PATH, f'h2_cg_mg_interval_noRef{INTERVAL_NOREF}',
              counts12['mg16'])) + tuple(
        (VO_PATHS[label], f'interval_{label}_noRef6', counts13[label])
        for label, *_ in VARIABLE_LINES) + (
        (VO_TRANSPOSE_PATH, f'h2_transpose_interval_noRef{VO_CHECK_NOREF}',
         counts13['transpose']),
        (VO_PATHS['twoDomainNonSym-H2-mg'],
         f"h2_gmres_mg_twoDomainNonSym_noRef{summary13['noRef']}",
         counts13['full']),
        (DERIV_DENSE_PATH, 'd2_dense_disc_noRef5', counts14['disc5_dense']),
        (DERIV_H2_PATH, 'd2_h2_disc_noRef5', counts14['disc5_h2'])) + tuple(
        (DERIV_VEC_PATH, f'vector_{label}_interval_noRef6', counts14[label])
        for label, *_ in DERIV_VECTOR_LINES) + (
        (DERIV_H2_PATH, f"d1_h2_disc_noRef{summary14['disc_full']['noRef']}",
         counts14['disc7_h2']),
        (DERIV_VEC_PATH,
         f"vector_LR2-d2_interval_noRef{summary14['vector_full']['noRef']}",
         counts14['vector_full']))
    table = []
    cmp['panel_scatter_nonsym'] = cmp13.pop('panel_scatter_nonsym')
    cmp['h2_matvec_T'] = cmp13.pop('h2_matvec_T')
    cmp.update(cmp14)
    for name in kernels.KERNELS:
        route, src, replaces = KERNEL_INFO[name]
        c = cmp[name]
        bms, by = bound(c['work'])
        byPath = {label: counts[name] for path, label, counts in paths
                  if name in path}
        # the CUDA launches the wrapper calls made, counted as they launched
        device = sum(counts['device'][name] for path, _, counts in paths
                     if name in path)
        row = {'name': name, 'route': route, 'source': src,
               'replaces': replaces, 'launches': sum(byPath.values()),
               'max_abs_err': c['err'], 'ms': c['ms'],
               'plain_ms': c['plain_ms'], 'bound_ms': bms, 'bound_by': by,
               'library_ms': c['library_ms'],
               'launches_by_path': byPath,
               'device_launches': device,
               'compared_at': COMPARED_AT[name]}
        row.update({k: v for k, v in c.items()
                    if k not in ('err', 'ms', 'plain_ms', 'work',
                                 'library_ms')})
        if name in cmp12:
            # the same kernel with the gaussian and exponential profiles at
            # the smooth lines' shapes and, for K1, K4-K12, at the noRef 16
            # line's
            c12 = cmp12[name]
            ims, iby = bound(c12['work'])
            row['at_interval'] = {
                'max_abs_err': c12['err'], 'ms': c12['ms'],
                'plain_ms': c12['plain_ms'], 'bound_ms': ims,
                'bound_by': iby, 'library_ms': c12['library_ms'],
                'compared_at': INTERVAL_COMPARED_AT}
        if name in cmp13:
            # K1 and K7 with the variable orders' codes (and K1's y shift),
            # K8, K9, K10 and K17 at the shapes of the gmres-mg H2 line
            c13 = cmp13[name]
            vms, vby = bound(c13['work'])
            row['at_varorder'] = {
                'max_abs_err': c13['err'], 'ms': c13['ms'],
                'plain_ms': c13['plain_ms'], 'bound_ms': vms,
                'bound_by': vby, 'library_ms': c13['library_ms'],
                'compared_at': VO_COMPARED_AT[name]}
        if name in prof14:
            # the power-log profile of the s-derivatives of a constant order
            c14 = prof14[name]
            dms, dby = bound(c14['work'])
            row['at_derivative'] = {
                'max_abs_err': c14['err'], 'ms': c14['ms'],
                'plain_ms': c14['plain_ms'], 'bound_ms': dms,
                'bound_by': dby, 'library_ms': c14['library_ms'],
                'compared_at': DERIV_COMPARED_AT[name]}
        split = {'panel_scatter': ('launches_by_target', kernels.K1_TARGETS),
                 'panel_scatter_nonsym': ('launches_by_target',
                                          kernels.K19_TARGETS),
                 'pcg_update': ('launches_by_form', kernels.K4_FORMS),
                 'vector_matvec': ('launches_by_form', kernels.K23_FORMS)}
        if name in split:
            key, names = split[name]
            row[key] = {t.split(':')[1]: sum(counts[t] for *_, counts in paths)
                        for t in names}
        table.append(row)
    # the complex variants of K9, K10 and K17 on the Helmholtz paths (every
    # K9, K10 and K17 launch there is a complex one, phase 15 checks)
    helmholtz = (('interval_wave', 'helmholtz_interval_wave_noRef7'),
                 ('interval_greens', 'helmholtz_interval_greens_noRef7'),
                 ('square', 'helmholtz_square_wave_noRef8'))
    for name in kernels.COMPLEX:
        route, src, replaces = COMPLEX_INFO[name]
        c = cmp15[name]
        bms, by = bound(c['work'])
        byPath = {label: counts15[key][name] for key, label in helmholtz}
        row = {'name': name, 'route': route, 'source': src,
               'replaces': replaces, 'launches': sum(byPath.values()),
               'max_abs_err': c['err'], 'ms': c['ms'],
               'plain_ms': c['plain_ms'], 'bound_ms': bms, 'bound_by': by,
               'library_ms': c['library_ms'],
               'launches_by_path': byPath,
               'device_launches': sum(
                   counts15[key]['device'][name.split(':')[0]]
                   for key, _ in helmholtz),
               'compared_at': COMPLEX_COMPARED_AT[name]}
        row.update({k: v for k, v in c.items()
                    if k not in ('err', 'ms', 'plain_ms', 'work',
                                 'library_ms')})
        table.append(row)
    log(f'phase 14 summary: {json.dumps(summary14)}')
    log(f'phase 15 summary: {json.dumps(summary15)}')
    print(json.dumps({'kernels': table}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()

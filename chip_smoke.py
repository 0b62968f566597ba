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
Phase 2 also holds K4's two forms, K9 (P and P^T of noRef 3 -> 4) and K10
at the noRef 4 shapes, K8 on the noRef 0, 1 and 2 operators, and K11, K12
(a default build) and K13 (a host-engine build) at the noRef 4 shapes
against their plain versions.
The last lines are the kernel table (JSON: per kernel its launches on the
main paths and the CUDA launches those made, the largest error against
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
    ..., w, PSIP, C, e): per pair and node the positions, r^2, gamma (one
    pow), the normal factor and nPSI^2 multiply-adds; the touched entries
    are read and written once."""
    vertices, vi1, vi2, normals = args[1], args[2], args[3], args[6]
    w, PSIP = args[-4], args[-3]
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
        return tuple(_clone(b) for b in a)
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
    w, PSIP, C, e): K1's quadrature body per element (two cells), the
    touched entries read and written once."""
    ids, vertices, cells, w, PSIP = args[1], args[12], args[13], args[-4], \
        args[-3]
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

    worst = ms = plain_ms = 0.0
    work = []
    for args, kw in recs['far_field'].calls:
        P, M, dim = args[0].shape
        work.append((nbytes(args[:2]) + 8 * P * M * M,
                     P * M * M * (3 * dim + 1), F64_PEAK))
        asm.far_field(*args, **kw), asm._far_field_plain(*args, **kw)
        got, ref = [], []
        ms += timed(lambda: got.append(asm.far_field(*args, **kw)))
        plain_ms += timed(lambda: ref.append(asm._far_field_plain(*args,
                                                                  **kw)))
        err = float((got[0] - ref[0]).abs().max())
        scale = float(ref[0].abs().max())
        if not (scale > 0 and err <= TOL_KERNEL * scale):
            raise AssertionError(f'far_field: max err {err} (max {scale})')
        worst = max(worst, err)
    log(f"  far_field: {len(recs['far_field'].calls)} calls, max abs err "
        f'{worst:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms')
    out['far_field'] = result(worst, ms, plain_ms, work)
    return out


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
    centers, logh, consts, vertices, vols, dofs, treePos, rules, C, e): the
    order model per element; per element of a requested order K1's
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
    vertices, cells, vols, dofs, tables, bary_x, bary_y, w, PSIP, C, e):
    K1's quadrature body per element, the touched entries read and written
    once."""
    c1, vertices, cells, w, PSIP = args[1], args[8], args[9], args[-4], \
        args[-3]
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
        A.tmplStart, A.tmplAll, A.dataZ, H.leafPhi, H.leafNode, H.T,
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


def compare_csr_spmv(P, reps=10):
    """K9 on a prolongation P and its transpose: y = A x and y += A x
    against the plain version; then ``reps`` products y = P x and
    y = P^T r each way and through one torch.sparse CSR product (the
    library's yardstick, never used by the port), after an untimed call
    of each.  Returns the result() per pair of products."""
    import torch
    from pynucleus_tpu_torch.base.linear_operators import (csr_spmv,
                                                           _csr_spmv_plain)
    g = torch.Generator('cuda').manual_seed(2)
    worst = ms = plain_ms = lib_ms = 0.0
    work = []
    for A in (P, P.transposed()):
        def vec(n):
            return torch.randn(n, dtype=torch.float64, device='cuda',
                               generator=g)
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
        S = torch.sparse_csr_tensor(A.indptr, A.indices, A.data,
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
        work.append((nbytes(A.indptr, A.indices, A.data, x)
                     + 8 * A.num_rows, 2 * A.nnz, F64_PEAK))
    log(f'  csr_spmv: P {tuple(P.shape)} and P^T, nnz {P.nnz}, max abs err '
        f'{worst:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
        f'torch.sparse {lib_ms:.4f} ms per pair of products')
    return result(worst, ms, plain_ms, work, lib_ms)


def compare_jacobi_smooth(n, reps=10):
    """K10: its three modes on random vectors [n] against the plain
    version, ``reps`` passes of each mode each way after an untimed one;
    returns the result() per set of three passes, with the time of the
    library call of the residual mode, one torch.sub (never used by the
    port), beside that mode's own."""
    import torch
    from pynucleus_tpu_torch.multilevel.gmg import (jacobi_smooth,
                                                    _jacobi_smooth_plain)
    g = torch.Generator('cuda').manual_seed(3)
    b, Ax, x0 = (torch.randn(n, dtype=torch.float64, device='cuda',
                             generator=g) for _ in range(3))
    Dinv = torch.rand(n, dtype=torch.float64, device='cuda', generator=g) \
        + 0.5
    om = torch.tensor([2.0 / 3.0], dtype=torch.float64, device='cuda')
    worst = ms = plain_ms = 0.0
    work = []
    for mode, (nvec, ops) in (('zero', (3, 2)), ('residual', (3, 1)),
                              ('update', (5, 4))):
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
        work.append((8 * nvec * n, ops * n, F64_PEAK))
    torch.sub(b, Ax, out=xp)
    lib_ms = timed(lambda: [torch.sub(b, Ax, out=xp)
                            for _ in range(reps)]) / reps
    res_ms = timed(lambda: [jacobi_smooth('residual', xk, b, Ax=Ax)
                            for _ in range(reps)]) / reps
    log(f'  jacobi_smooth: n {n}, three modes, max abs err {worst:.3e}, '
        f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per set; residual '
        f'mode {res_ms:.4f} ms, torch.sub {lib_ms:.4f} ms')
    r = result(worst, ms, plain_ms, work, lib_ms)
    r['residual_ms'] = res_ms
    return r


def grid_distant_work(args):
    """K2 on recorded args (N, X, ccf, vols, dofs, PhiXw, PhiX, PsiYw, w,
    t_lo, t_hi, C, e): per cell pair of the window Q^2 kernel values (one
    pow each) and the two contractions with the dpe shape functions, per
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
    exclPtr, exclIdx, PhiXw, PhiX, C, e, useNormals): a kernel value (and
    the normal factor) per cell node and surface node not excluded, per
    cell its dpe^2 block."""
    X, dofs, Ysurf, exclIdx, useNormals = args[1], args[3], args[4], \
        args[8], args[13]
    nC, Q1, dim = X.shape
    S, Q2, _ = Ysurf.shape
    dpe = dofs.shape[1]
    evals = (nC * S - exclIdx.numel()) * Q1 * Q2
    ops = evals * (3 * dim + 3 + (3 * dim + 2 if useNormals else 0)) \
        + 3 * nC * Q1 * dpe * dpe
    return (nbytes(args[1:]) + 16 * nC * dpe * dpe, ops, F64_PEAK)


def compare_pcg(name, fns, states, M=None, iters=10):
    """``iters`` PCG iterations of two states, one through each of fns
    (kernel, plain), with A p by the operator ``M[0]`` and, for the
    general form, the preconditioner ``M[1]``; x, r, p and the history
    must agree.  Returns (max abs err, kernel ms, plain ms), the times
    summed over the iterations (the operator's apply is not timed, the
    preconditioner's is)."""
    A, prec = M
    ms = plain_ms = worst = 0.0
    for it in range(iters):
        for st in states:
            A.matvec(st[3], out=st[4])
        args = [states[0][:5] + ([prec] if prec is not None else [])
                + states[0][5:], states[1][:5]
                + ([prec] if prec is not None else []) + states[1][5:]]
        ms += timed(lambda: fns[0](*args[0], it))
        plain_ms += timed(lambda: fns[1](*args[1], it))
    for what, i in (('x', 0), ('r', 1), ('p', 3), ('hist', -1)):
        vk = states[0][i][:iters + 1] if what == 'hist' else states[0][i]
        vp = states[1][i][:iters + 1] if what == 'hist' else states[1][i]
        err = float((vk - vp).abs().max())
        scale = float(vp.abs().max())
        if not err <= TOL_KERNEL * scale:
            raise AssertionError(f'{name}: {what} max err {err} '
                                 f'(max {scale})')
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


def compare_pcg_forms(A, b, M, label):
    """K4's two forms against their plain versions, ten iterations each
    with A p of the operator A: the Jacobi form with invD the inverse
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
        pcg_state(b, invD * b, [invD]) for _ in range(2)], (A, None))
    errG, _, _ = compare_pcg('pcg_update (general form, CG-MG)', gen, [
        pcg_state(b, M.matvec(b), []) for _ in range(2)], (A, M))
    errD, msG, plainG = compare_pcg('pcg_update (general form)', gen, [
        pcg_state(b, Mdiag.matvec(b), []) for _ in range(2)], (A, Mdiag))
    log(f'  pcg_update ({label}): 10 iterations of each form; Jacobi: max '
        f'abs err {errJ:.3e}, kernel {msJ:.3f} ms, plain {plainJ:.3f} ms; '
        f'general (CG-MG): max abs err {errG:.3e}, timed with M = diag: '
        f'kernel {msG:.3f} ms, plain {plainG:.3f} ms')
    # per iteration, Jacobi: x, r, p, Ap, invD read, x, r, z, p written;
    # general: x, r, p, Ap, z read, x, r, p written
    return merge(result(errJ, msJ, plainJ, [(72 * n, 13 * n, F64_PEAK)] * 10),
                 result(max(errG, errD), msG, plainG,
                        [(64 * n, 12 * n, F64_PEAK)] * 10))


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
    (N4, _, ccf, vols, dofs, *_, t_lo, t_hi, C, e), _ = k2.calls[-1]

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                               device='cuda')
    k2.calls.append(((
        N4, dev(np.einsum('qk,ckd->cqd', b6, mesh.vertices[mesh.cells])),
        ccf, vols, dofs, dev(Phi6 * w6), dev(Phi6), dev(-Phi6 * w6),
        dev(w6), t_lo, t_hi, C, e), {}))
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
    just after; each kernel of the path must have launched, CG must have
    converged."""
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
    if not solver.residuals[-1] <= solver.tolerance \
            or res['iterations'] >= solver.maxIter:
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
    vols1, tq, wq, ur, wr, horizon, C, e): every (x, y) node product of
    every pair; inputs read once, the 16 entries of a pair read and
    written once."""
    P = args[4].shape[0]
    Q = args[7].shape[0] * args[9].shape[0]
    return (nbytes(args[2:]) + 16 * 16 * P, CUT1D_NODE_OPS * P * Q, F64_PEAK)


def cut2d_work(args):
    """K15 on recorded args (shape, target, index, vertices, vi1, vi2,
    vols1, bary_x, wx, thetas, wtheta, rq, wr, horizon, inter, C, e): the
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
    events; and the combine's library yardstick, one torch.addmv.  Returns
    the result() per cycle."""
    import numpy as np
    import torch
    from pynucleus_tpu_torch.base import solvers as S
    n = b.shape[0]
    V = torch.empty((restart + 1, n), dtype=torch.float64, device='cuda')
    h = torch.zeros(restart + 1, dtype=torch.float64, device='cuda')
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
        # norm and the division
        work.append((8 * n * (j + 4 if j >= 0 else 2),
                     4 * n * (j + 1) + 3 * n, F64_PEAK))
    y = torch.as_tensor(np.random.default_rng(11).normal(size=restart),
                        device='cuda')
    x0 = torch.randn(n, dtype=torch.float64, device='cuda',
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
    work.append((8 * n * (restart + 2), 2 * n * restart + n, F64_PEAK))
    log(f'  gmres_arnoldi: one cycle of {restart} steps on n {n} (start, '
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
              countsG))
    table = []
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
        split = {'panel_scatter': ('launches_by_target', kernels.K1_TARGETS),
                 'pcg_update': ('launches_by_form', kernels.K4_FORMS)}
        if name in split:
            key, names = split[name]
            row[key] = {t.split(':')[1]: sum(counts[t] for *_, counts in paths)
                        for t in names}
        table.append(row)
    print(json.dumps({'kernels': table}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()

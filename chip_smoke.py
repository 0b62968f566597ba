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
     (1e-5 relative, the Chebyshev far field)
  6. the H2 slice at noRef 7 (73153 dofs): assembly seconds with the build
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
     the same).  Then K4's two
     forms (ten iterations each, the general one with this V-cycle), K9
     (P and P^T of noRef 6 -> 7) and K10 (its three modes) against their
     plain versions at these shapes.
Phase 2 also holds K4's two forms, K9 (P and P^T of noRef 3 -> 4) and K10
at the noRef 4 shapes, and K8 on the noRef 0, 1 and 2 operators, against
their plain versions.
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
}
# the kernels (and K1 targets) each main path must launch
DENSE_PATH = ('panel_scatter', 'grid_distant', 'grid_boundary', 'pcg_update',
              'panel_scatter:dense', 'pcg_update:jacobi')
H2_PATH = ('panel_scatter', 'pcg_update', 'near_enum', 'near_enum_quad',
           'far_field', 'h2_matvec', 'panel_scatter:slots',
           'panel_scatter:tree', 'pcg_update:jacobi')
MG_PATH = ('panel_scatter', 'pcg_update', 'near_enum', 'near_enum_quad',
           'far_field', 'h2_matvec', 'csr_spmv', 'jacobi_smooth',
           'panel_scatter:slots', 'panel_scatter:tree', 'pcg_update:general')
# where the kernel table's comparison with the plain version was made
COMPARED_AT = {
    'panel_scatter': 'disc noRef 4 (dense target), '
                     f'noRef {H2_NOREF} (CSR targets, all calls)',
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


def compare_assembly_kernel(name, calls, kernel, plain, work):
    """Each recorded call once through the kernel and once through the
    plain version, each into its own zero A, after one untimed warm-up
    call of each; returns the result() over the calls (``work(args)`` of
    each call's recorded args)."""
    import torch
    worst_abs = worst_rel = 0.0
    ms = plain_ms = 0.0
    for (N, *args), kw in calls:
        Ak = torch.zeros((N, N), dtype=torch.float64, device='cuda')
        Ap = torch.zeros_like(Ak)
        # warm-up into a scratch A (module loading, allocator), then timed
        kernel(torch.zeros_like(Ak), *args)
        plain(torch.zeros_like(Ak), *args)
        ms += timed(lambda: kernel(Ak, *args))
        plain_ms += timed(lambda: plain(Ap, *args))
        err = float((Ak - Ap).abs().max())
        scale = float(Ap.abs().max())
        if not (scale > 0 and err <= TOL_KERNEL * scale):
            raise AssertionError(f'{name}: kernel vs plain max err {err} '
                                 f'(max|A| {scale})')
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / scale)
    log(f'  {name}: {len(calls)} calls, max abs err {worst_abs:.3e} '
        f'(rel {worst_rel:.3e}), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms')
    return result(worst_abs, ms, plain_ms, [work(c[0]) for c in calls])


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
    [N, N] or the near data [nnz+1]) that one is recorded by its length.  With ``size``, only the call of
    the largest ``size(*args)`` is kept."""

    def __init__(self, module, name, dataFirst=False, size=None):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.dataFirst, self.size = dataFirst, size
        self.calls = []
        self.largest = -1

    def _record(self, args, kw):
        if self.dataFirst:
            args = (args[0].shape[0],) + _clone(args[1:])
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


# the H2 build's kernel wrappers (nl.assembly); the first three add into
# the near data [nnz+1]
H2_CSR = ('panel_scatter_slots', 'panel_scatter_tree', 'near_enum_quad')
H2_BUILD = H2_CSR + ('near_enum', 'far_field')


def record_h2_build(build, largestOnly):
    """Runs ``build()``, an H2 build, with the calls of K1's CSR targets,
    K5, K6 and K7 recorded; with ``largestOnly`` K5 keeps only its largest
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
            asm, n, dataFirst=n in H2_CSR, size=sizes.get(n)))
            for n in H2_BUILD}
        H = build()
    torch.cuda.synchronize()
    return H, recs


def compare_csr_kernel(name, calls, kernel, plain, work):
    """The recorded calls of a kernel that adds into the near-field data
    [nnz+1], all into one zero vector through the kernel and one through
    the plain version (after an untimed warm-up of each); compared on the
    nnz real slots.  Returns the result()."""
    import torch
    n = calls[0][0][0]
    Dk = torch.zeros(n, dtype=torch.float64, device='cuda')
    Dp = torch.zeros_like(Dk)
    kernel(torch.zeros_like(Dk), *calls[0][0][1:])
    plain(torch.zeros_like(Dk), *calls[0][0][1:])
    ms = plain_ms = 0.0
    for args, kw in calls:
        if args[0] != n:
            raise AssertionError(f'{name}: calls on different data')
        ms += timed(lambda: kernel(Dk, *args[1:]))
        plain_ms += timed(lambda: plain(Dp, *args[1:]))
    err = float((Dk[:-1] - Dp[:-1]).abs().max())
    scale = float(Dp[:-1].abs().max())
    if not (scale > 0 and err <= TOL_KERNEL * scale):
        raise AssertionError(f'{name}: kernel vs plain max err {err} '
                             f'(max|data| {scale})')
    log(f'  {name}: {len(calls)} calls, max abs err {err:.3e} '
        f'(rel {err / scale:.3e}), kernel {ms:.3f} ms, plain '
        f'{plain_ms:.3f} ms')
    return result(err, ms, plain_ms, [work(c[0]) for c in calls])


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
        out[n] = compare_csr_kernel(
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
    returns the result() per set of three passes."""
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
    log(f'  jacobi_smooth: n {n}, three modes, max abs err {worst:.3e}, '
        f'kernel {ms:.4f} ms, plain {plain_ms:.4f} ms per set')
    return result(worst, ms, plain_ms, work)


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
    out['panel_scatter'] = compare_assembly_kernel(
        'panel_scatter', k1.calls, asm.panel_scatter, asm._panel_scatter_plain,
        panel_work)
    out['grid_distant'] = compare_assembly_kernel(
        'grid_distant', k2.calls, asm.grid_distant, asm._grid_distant_plain,
        grid_distant_work)
    out['grid_boundary'] = compare_assembly_kernel(
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
    # the shapes of phase 6's main path)
    H, recs = record_h2_build(
        lambda: asm.nonlocalBuilder(dm, prob['kernel']).getH2(), False)
    compare_h2_build(recs)
    compare_h2_matvec(H)
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


def run_main_path(argv, path):
    """One run of a main path through the driver, with every launch count
    set to 0 just before and read just after; each kernel of the path must
    have launched, CG must have converged."""
    import torch
    from pynucleus_tpu_torch import kernels
    from pynucleus_tpu_torch.drivers.runFractional import main
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


def phase6(errs6):
    """The H2 main path at noRef H2_NOREF, then each of its kernels against
    its plain version at the shapes of that path: K8 on its operator, K1's
    CSR targets, K5 (largest segment), K6 (largest order) and K7 on the
    recorded calls of a second build of it.  Returns the launch counts, the
    comparisons and the errors."""
    import torch
    from pynucleus_tpu_torch.nl.assembly import assembleNonlocal
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    log(f'phase 6: H2 slice at noRef {H2_NOREF}')
    out, counts = run_main_path(slice_argv(H2_NOREF, 'H2', H2_MAXITER),
                                H2_PATH)
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
        zeroExterior=prob['zeroExterior'], device='cuda'), True)[1]
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
    solve, then K4's two forms, K9 and K10 against their plain versions
    at its finest shapes.  Returns the launch counts and the
    comparisons."""
    import torch
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    log(f'phase 8: the flagship, H2 CG-MG at noRef {H2_NOREF}')
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

    # K1 is one kernel with three targets: the dense one compared at the
    # noRef 4 shapes, the CSR ones at the H2 main path's
    cmp['panel_scatter'] = merge(cmp['panel_scatter'],
                                 cmp7.pop('panel_scatter_slots'),
                                 cmp7.pop('panel_scatter_tree'))
    cmp.update(cmp7)
    cmp.update(cmp8)
    paths = ((DENSE_PATH, 'dense_noRef6', counts6),
             (H2_PATH, f'h2_cg_jacobi_noRef{H2_NOREF}', counts7),
             (MG_PATH, f'h2_cg_mg_noRef{H2_NOREF}', counts8))
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

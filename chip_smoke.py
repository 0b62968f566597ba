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
The last lines are the kernel table (JSON), the card's name and power
limit, and {"ok": true, "device": {...}}.
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
RTOL_ERRORS = 3e-2
TOL_KERNEL = 1e-12
TOL_H2_DENSE = 1e-5
H2_NOREF = 7
H2_MAXITER = 400

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
}
# the kernels (and K1 targets) each main path must launch
DENSE_PATH = ('panel_scatter', 'grid_distant', 'grid_boundary', 'pcg_update',
              'panel_scatter:dense')
H2_PATH = ('panel_scatter', 'pcg_update', 'near_enum', 'near_enum_quad',
           'far_field', 'h2_matvec', 'panel_scatter:slots',
           'panel_scatter:tree')
# where the kernel table's comparison with the plain version was made
COMPARED_AT = {
    'panel_scatter': 'disc noRef 4 (dense target), '
                     f'noRef {H2_NOREF} (CSR targets, all calls)',
    'grid_distant': 'disc noRef 4, all calls, and an order-6 window',
    'grid_boundary': 'disc noRef 4',
    'pcg_update': 'disc noRef 4, 10 iterations',
    'near_enum': f'disc noRef {H2_NOREF}, its largest segment',
    'near_enum_quad': f'disc noRef {H2_NOREF}, its largest order',
    'far_field': f'disc noRef {H2_NOREF}',
    'h2_matvec': f'disc noRef {H2_NOREF}, per apply of 10',
}


def log(*a):
    print(*a, flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=60)


def slice_argv(noRef, fmt='dense', maxiter=100):
    return ['--domain', 'disc', '--s', 'const(0.75)', '--problem', 'constant',
            '--element', 'P1', '--solverType', 'cg-jacobi', '--matrixFormat',
            fmt, '--noRef', str(noRef), '--maxiter', str(maxiter), '--device',
            'cuda']


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


def compare_assembly_kernel(name, calls, kernel, plain):
    """Each recorded call once through the kernel and once through the
    plain version, each into its own zero A, after one untimed warm-up
    call of each; returns (max abs err, kernel ms, plain ms) summed over
    the calls."""
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
    return worst_abs, ms, plain_ms


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


def compare_csr_kernel(name, calls, kernel, plain):
    """The recorded calls of a kernel that adds into the near-field data
    [nnz+1], all into one zero vector through the kernel and one through
    the plain version (after an untimed warm-up of each); compared on the
    nnz real slots.  Returns (max abs err, kernel ms,
    plain ms)."""
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
    return err, ms, plain_ms


def compare_h2_build(recs):
    """K1's CSR targets, K5, K6 and K7 on their recorded calls against
    their plain versions, each after an untimed warm-up call; returns
    {name: (max abs err, kernel ms, plain ms)}."""
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    for n in H2_BUILD:
        if not recs[n].calls:
            raise AssertionError(f'{n}: the build made no call of it')
    out = {}
    for n in H2_CSR:
        out[n] = compare_csr_kernel(n, recs[n].calls, getattr(asm, n),
                                    getattr(asm, '_' + n + '_plain'))

    ms = plain_ms = 0.0
    for args, kw in recs['near_enum'].calls:
        T = int(args[0][-1])
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
    out['near_enum'] = (0.0, ms, plain_ms)

    worst = ms = plain_ms = 0.0
    for args, kw in recs['far_field'].calls:
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
    out['far_field'] = (worst, ms, plain_ms)
    return out


def compare_h2_matvec(H, reps=10):
    """K8: ``reps`` applies of the operator H each way, after one untimed
    apply of each; returns (max abs err, kernel ms, plain ms) per apply."""
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
    log(f'  h2_matvec: {reps} applies, max abs err {err:.3e} (rel '
        f'{err / scale:.3e}), kernel {ms / reps:.3f} ms, plain '
        f'{plain_ms / reps:.3f} ms per apply')
    return err, ms / reps, plain_ms / reps


def phase2():
    import numpy as np
    import torch
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.base import solvers

    log('phase 2: kernels against their plain versions (disc, noRef 4, '
        'dense and H2 builds)')
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
        'panel_scatter', k1.calls, asm.panel_scatter, asm._panel_scatter_plain)
    out['grid_distant'] = compare_assembly_kernel(
        'grid_distant', k2.calls, asm.grid_distant, asm._grid_distant_plain)
    out['grid_boundary'] = compare_assembly_kernel(
        'grid_boundary', k3.calls, asm.grid_boundary, asm._grid_boundary_plain)

    # K4: ten CG-Jacobi iterations of the assembled noRef 4 matrix
    b = assembleRHS(dm, prob['rhs'], qOrder=3).data
    invD = (1.0 / torch.diagonal(A.data)).contiguous()

    def state():
        x = torch.zeros_like(b)
        r = b.clone()
        z = invD * r
        p = z.clone()
        rz = torch.dot(r, z)
        scal = torch.stack([rz, torch.zeros_like(rz), torch.sqrt(rz)])
        hist = torch.full((12,), float('nan'), dtype=b.dtype, device='cuda')
        hist[0] = scal[2]
        return [x, r, z, p, torch.empty_like(b), invD, scal, hist]

    sk, sp = state(), state()
    # warm-up (Triton compiles the kernels at their first launch)
    for fn in (solvers.pcg_update, solvers._pcg_update_plain):
        w = state()
        torch.mv(A.data, w[3], out=w[4])
        fn(*w, 0)
    torch.cuda.synchronize()
    ms = plain_ms = 0.0
    for it in range(10):
        for s in (sk, sp):
            torch.mv(A.data, s[3], out=s[4])
        ms += timed(lambda: solvers.pcg_update(*sk, it))
        plain_ms += timed(lambda: solvers._pcg_update_plain(*sp, it))
    worst_abs = 0.0
    sk[7], sp[7] = sk[7][:11], sp[7][:11]
    for name, i in (('x', 0), ('r', 1), ('p', 3), ('hist', 7)):
        vk, vp = sk[i], sp[i]
        err = float((vk - vp).abs().max())
        scale = float(vp.abs().max())
        if not err <= TOL_KERNEL * scale:
            raise AssertionError(f'pcg_update: {name} max err {err} '
                                 f'(max {scale})')
        worst_abs = max(worst_abs, err)
    log(f'  pcg_update: 10 iterations, max abs err {worst_abs:.3e}, '
        f'kernel {ms:.3f} ms, plain {plain_ms:.3f} ms')
    out['pcg_update'] = (worst_abs, ms, plain_ms)

    # the H2 kernels at these shapes too (the kernel table holds them at
    # the shapes of phase 6's main path)
    H, recs = record_h2_build(
        lambda: asm.nonlocalBuilder(dm, prob['kernel']).getH2(), False)
    compare_h2_build(recs)
    compare_h2_matvec(H)
    return out


# ------------------------------------------------------------- phases 3-6

def check_against_jax(out, ref):
    """dofs equal, iterations +-1, errors within RTOL_ERRORS of the pinned
    JAX outputs."""
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
        raise AssertionError(f'CG did not converge: {solver.residuals[-3:]}')
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
    comparisons and the operator's number of levels."""
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
    nLvl = H.nLvl
    del H
    torch.cuda.empty_cache()
    prob = fractionalLaplacianProblem('disc', 'const(0.75)')
    recs = record_h2_build(lambda: assembleNonlocal(
        dm, prob['kernel'], matrixFormat='H2',
        zeroExterior=prob['zeroExterior'], device='cuda'), True)[1]
    cmp.update(compare_h2_build(recs))
    return counts, cmp, nLvl


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
    counts7, cmp7, nLvl7 = phase6(errs6)

    # K1 is one kernel with three targets: the dense one compared at the
    # noRef 4 shapes, the CSR ones at the H2 main path's
    parts = [cmp['panel_scatter'], cmp7.pop('panel_scatter_slots'),
             cmp7.pop('panel_scatter_tree')]
    cmp['panel_scatter'] = (max(p[0] for p in parts),
                            sum(p[1] for p in parts),
                            sum(p[2] for p in parts))
    cmp.update(cmp7)
    # CUDA launches behind one count (one launch of the wrapper)
    each = {'grid_distant': 2, 'pcg_update': 3, 'h2_matvec': 2 * nLvl7 + 2}
    table = []
    for name in kernels.KERNELS:
        route, src, replaces = KERNEL_INFO[name]
        err, ms, plain_ms = cmp[name]
        byPath = {}
        if name in DENSE_PATH:
            byPath['dense_noRef6'] = counts6[name]
        if name in H2_PATH:
            byPath[f'h2_noRef{H2_NOREF}'] = counts7[name]
        row = {'name': name, 'route': route, 'source': src,
               'replaces': replaces, 'launches': sum(byPath.values()),
               'launches_by_path': byPath,
               'device_launches_each': each.get(name, 1),
               'compared_at': COMPARED_AT[name],
               'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms}
        if name == 'panel_scatter':
            row['launches_by_target'] = {
                t.split(':')[1]: counts6[t] + counts7[t]
                for t in kernels.K1_TARGETS}
        table.append(row)
    print(json.dumps({'kernels': table}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()

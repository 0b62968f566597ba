#!/usr/bin/env python3
"""Where the time of the port's dense or H2 slice goes, on one NVIDIA GPU.

    python scripts/profile_torch_slice.py [--noRef 6] [--matrixFormat dense|H2]
        [--solverType cg-jacobi|cg-mg] [--out FILE.json]

Runs the disc problem (s = 0.75, P1, zero exterior) at the given refinement
on 'cuda': one warm-up assembly + solve at noRef 3 (kernel build, Triton
compiles, module loading), then the assembly (with cg-mg every level
noRef 0 ... noRef) and two solves at full size.  Reports
  - the assembly wall time (a clean run; with cg-mg per level) and the
    finest level's parts from a second run that synchronises around each
    part, so that nothing overlaps: host classification, each kernel
    wrapper call, and everything else (for H2 also the builder's own part
    timers, which synchronise at each part's end);
  - device time per kernel name from torch.profiler (CUPTI, a third run
    of the finest level) and the device busy share of the assembly and of
    the warm solve;
  - the cold and warm solve times and the time per CG iteration, and the
    time of one operator apply (CUDA events over 20 applies);
  - with cg-mg, the V-cycle: ms per cycle (CUDA events); per level the ms
    of its own steps run alone (CUDA events) and their device ms by kernel
    (K8, K9, K10, the coarse LU and the rest; torch.profiler); and the host
    and CUDA-event µs per call of each kernel of the cycle and of K10's
    plain version, on a coarse and on the finest level.
Prints the numbers as JSON, and writes them to --out if it is given.
"""
import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--noRef', type=int, default=6)
    ap.add_argument('--matrixFormat', default='dense', choices=['dense', 'H2'])
    ap.add_argument('--solverType', default='cg-jacobi',
                    choices=['cg-jacobi', 'cg-mg'])
    ap.add_argument('--out', default=None)
    args = ap.parse_args()

    import torch
    from torch.profiler import profile, ProfilerActivity
    if not torch.cuda.is_available():
        sys.exit('needs an NVIDIA GPU')
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch import kernels
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    from pynucleus_tpu_torch.nl.discretized import (buildMeshHierarchy,
                                                    buildHierarchy)
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.base.solvers import solverFactory

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    prob = fractionalLaplacianProblem('disc', 'const(0.75)')

    h2 = args.matrixFormat == 'H2'
    mg = args.solverType == 'cg-mg'

    def getOp(builder):
        return builder.getH2() if h2 else builder.getDense()

    def hierarchyFor(noRef, timers=None):
        """The finest dofmap and the level list of the driver (every
        level with cg-mg, the finest alone with cg-jacobi)."""
        _, dms, Ps = buildMeshHierarchy(prob['mesh'], args.solverType,
                                        prob['tag'], noRef, 'P1',
                                        torch.device('cuda'))
        return dms[-1], buildHierarchy(dms, Ps, prob['kernel'],
                                       args.solverType, args.matrixFormat,
                                       True, timers=timers)

    def solve(hierarchy, dm):
        b = assembleRHS(dm, prob['rhs'], qOrder=3).data
        s = solverFactory.build(args.solverType, hierarchy=hierarchy,
                                setup=True)
        s.tolerance, s.maxIter = 1e-6, 400
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.solve(b)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, s

    # warm-up: build, Triton compiles, lazy module loading
    solve(*reversed(hierarchyFor(3)))

    # host-timed parts of the assembly
    parts = {}

    def timedCall(name, fn):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            n, tot = parts.get(name, (0, 0.0))
            parts[name] = (n + 1, tot + dt)
            return out
        return wrapped

    patched = {n: getattr(asm, n) for n in (
        ('panel_scatter_slots', 'panel_scatter_tree', 'near_enum',
         'near_enum_quad', 'far_field', 'classifyPairList') if h2 else
        ('panel_scatter', 'grid_distant', 'grid_boundary',
         'classifyPairsDenseGrid', 'classifyBoundaryPairs'))}
    levelParts = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dm, hierarchy = hierarchyFor(args.noRef, levelParts)
    torch.cuda.synchronize()
    tHier = time.perf_counter() - t0
    peakAsm = torch.cuda.max_memory_allocated()
    levelS = {k: v for k, v in levelParts.items() if k.startswith('level ')}
    builderParts = {k: v for k, v in levelParts.items() if k not in levelS}
    tAsm = levelS[f'level {args.noRef}']

    def assemble():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        builder = asm.nonlocalBuilder(dm, prob['kernel'])
        A = getOp(builder)
        torch.cuda.synchronize()
        return A, time.perf_counter() - t0

    try:
        for n, fn in patched.items():
            setattr(asm, n, timedCall(n, fn))
        A, tParts = assemble()
    finally:
        for n, fn in patched.items():
            setattr(asm, n, fn)
    del A
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as profA:
        A, tProf = assemble()
    del A
    A = hierarchy[-1]['A']

    tCold, s = solve(hierarchy, dm)
    its, steps = s.iterations, len(s.residuals) - 1
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as profS:
        tWarm, s = solve(hierarchy, dm)
    steps2 = len(s.residuals) - 1

    def deviceTimes(prof):
        out = {}
        for ev in prof.key_averages():
            t = getattr(ev, 'device_time_total', None)
            if t is None:
                t = getattr(ev, 'cuda_time_total', 0)
            if t and ev.device_type.name == 'CUDA':
                out[ev.key] = out.get(ev.key, 0.0) + t / 1e3  # ms
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    devA = deviceTimes(profA)
    devS = deviceTimes(profS)
    vcycle = vcycleSplit(s.prec.levels, deviceTimes) if mg else None
    x = torch.randn(dm.num_dofs, dtype=torch.float64, device='cuda')
    y = torch.empty_like(x)
    A.matvec(x, out=y)
    matvecMs = eventMs(lambda: [A.matvec(x, out=y) for _ in range(20)]) / 20
    res = {
        'card': card, 'matrixFormat': args.matrixFormat,
        'solverType': args.solverType,
        'noRef': args.noRef, 'dofs': dm.num_dofs,
        'cells': dm.mesh.num_cells,
        'hierarchy_wall_s': tHier,
        'assembly_levels_s': levelS,
        'assembly_s': tAsm,
        'assembly_synchronised_s': tParts,
        'assembly_parts_s': {k: {'calls': n, 'seconds': t}
                             for k, (n, t) in parts.items()},
        'builder_parts_s': builderParts,
        'assembly_profiled_s': tProf,
        'assembly_device_ms_by_kernel': devA,
        'assembly_device_busy_share': sum(devA.values()) / 1e3 / tAsm,
        'peak_device_memory_GiB': peakAsm / 2 ** 30,
        'solve_cold_s': tCold, 'solve_warm_s': tWarm,
        'iterations': its, 'cg_steps': steps,
        'warm_s_per_cg_step': tWarm / max(steps2, 1),
        'solve_device_ms_by_kernel': devS,
        'solve_device_busy_share': sum(devS.values()) / 1e3 / tWarm,
        'matvec_ms': matvecMs,
        'vcycle': vcycle,
        'launches': dict(kernels.launches),
        'device_launches': dict(kernels.deviceLaunches),
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))


# device kernel names of the V-cycle's launches, by port kernel
KERNEL_GROUPS = (
    ('K8 h2_matvec', ('gather_kernel', 'moments_kernel', 'up_kernel',
                      'far_kernel', 'down_kernel', 'near_leaf_kernel')),
    ('K9 csr_spmv', ('csr_spmv',)),
    ('K10 jacobi_smooth', ('_jacobi_kernel',)),
    ('dense matvec (torch.mv)', ('gemv',)),
)


def eventMs(fn):
    """CUDA-event ms of fn() on the current stream."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def vcycleSplit(levels, deviceTimes, reps=10):
    """The V-cycle of a multigrid preconditioner's levels: CUDA-event ms
    per cycle; per level the CUDA-event ms of its own steps (the pre-sweep,
    residual and restriction, then the prolongation and post-sweep; the LU
    solve on level 0) and their device ms by port kernel (torch.profiler;
    the rest is the coarse LU solve and copies), each over ``reps`` runs of
    that level's steps alone; and the host cost of one launch of each
    kernel of the cycle (:func:`launchCost`)."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    from pynucleus_tpu_torch.multilevel.gmg import (_mg_apply, _coarseSolve,
                                                    _smoothRestrict,
                                                    _prolongSmooth)

    def group(dev):
        out = {}
        for name, ms in dev.items():
            key = next((k for k, subs in KERNEL_GROUPS
                        if any(s_ in name for s_ in subs)),
                       'coarse LU and other')
            out[key] = out.get(key, 0.0) + ms / reps
        return out

    g = torch.Generator('cuda').manual_seed(0)

    def vec(n):
        return torch.randn(n, dtype=torch.float64, device='cuda', generator=g)

    own, byKernel = [], []
    for lvl in range(len(levels.As)):
        b = vec(levels.As[lvl].num_rows)
        if lvl == 0:
            def steps():
                _coarseSolve(levels, b)
        else:
            x, xc = torch.empty_like(b), vec(levels.As[lvl - 1].num_rows)

            def steps():
                _smoothRestrict(levels, lvl, b, x)
                _prolongSmooth(levels, lvl, b, x, xc)
        steps()
        own.append(eventMs(lambda: [steps() for _ in range(reps)]) / reps)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                steps()
            torch.cuda.synchronize()
        byKernel.append(group(deviceTimes(prof)))
    b = vec(levels.As[-1].num_rows)
    out = torch.empty_like(b)
    _mg_apply(levels, b, out=out)
    cycle = eventMs(lambda: [_mg_apply(levels, b, out=out)
                             for _ in range(reps)]) / reps
    return {'ms_per_cycle': cycle,
            'levels': len(levels.As),
            'dofs_by_level': [A.num_rows for A in levels.As],
            'ms_level_own_steps': own,
            'ms_level_own_steps_sum': sum(own),
            'device_ms_level_own_steps_by_kernel': byKernel,
            'launch_cost': launchCost(levels, vec)}


def launchCost(levels, vec, reps=200):
    """Host µs to issue one call (host clock over ``reps`` calls that are
    not waited for, after a synchronize) and CUDA-event µs per call, for
    each kernel of the V-cycle and for K10's plain version, on the finest
    level and on the first level with more than 50 dofs (the coarse
    levels are where the cycle is bound by launches)."""
    import torch
    from pynucleus_tpu_torch.multilevel.gmg import (jacobi_smooth,
                                                    _jacobi_smooth_plain)
    out = {}
    small = next(l for l, A in enumerate(levels.As) if A.num_rows > 50)
    for lvl in (small, len(levels.As) - 1):
        A, P = levels.As[lvl], levels.Ps[lvl]
        b, Ax, x = (vec(A.num_rows) for _ in range(3))
        xc = vec(P.num_columns)
        kw = {'Ax': Ax, 'Dinv': levels.Dinvs[lvl], 'omega': levels.omegaT}
        calls = {
            'K10 jacobi_smooth (update)':
                lambda: jacobi_smooth('update', x, b, **kw),
            'K10 plain version (update)':
                lambda: _jacobi_smooth_plain('update', x, b, **kw),
            'K9 csr_spmv (P xc, accumulate)':
                lambda: P.matvec(xc, out=x, accumulate=True),
            'K8 h2_matvec or torch.mv': lambda: A.matvec(b, out=Ax)}
        row = {}
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            host = (time.perf_counter() - t0) / reps * 1e6
            torch.cuda.synchronize()
            dev = eventMs(lambda: [fn() for _ in range(reps)]) / reps * 1e3
            row[name] = {'host_us': host, 'event_us': dev}
        out[f'level {lvl} ({A.num_rows} dofs)'] = row
    return out


if __name__ == '__main__':
    main()

#!/usr/bin/env python3
"""Where the time of the port's dense or H2 slice goes, on one NVIDIA GPU.

    python scripts/profile_torch_slice.py [--noRef 6] [--matrixFormat dense|H2]
        [--out FILE.json]

Runs the disc problem (s = 0.75, P1, zero exterior) at the given refinement
on 'cuda': one warm-up assembly + solve at noRef 3 (kernel build, Triton
compiles, module loading), then the assembly and two CG-Jacobi solves at
full size.  Reports
  - the assembly wall time (a clean run) and its parts from a second run
    that synchronises around each part, so that nothing overlaps: host
    classification, each kernel wrapper call, and everything else (for H2
    also the builder's own part timers, which synchronise at each part's
    end);
  - device time per kernel name from torch.profiler (CUPTI, a third run)
    and the device busy share of the assembly and of the warm solve;
  - the cold and warm solve times and the time per CG iteration, and for
    H2 the time of one operator apply (CUDA events over 20 applies).
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
    ap.add_argument('--out', default=None)
    args = ap.parse_args()

    import torch
    from torch.profiler import profile, ProfilerActivity
    if not torch.cuda.is_available():
        sys.exit('needs an NVIDIA GPU')
    import pynucleus_tpu_torch.nl.assembly as asm
    from pynucleus_tpu_torch import kernels
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.base.solvers import solverFactory

    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    prob = fractionalLaplacianProblem('disc', 'const(0.75)')

    def build(noRef):
        mesh = prob['mesh']
        for _ in range(noRef):
            mesh = mesh.refine()
        return P1_DoFMap(mesh, prob['tag'], device='cuda')

    h2 = args.matrixFormat == 'H2'

    def getOp(builder):
        return builder.getH2() if h2 else builder.getDense()

    def solve(A, dm):
        b = assembleRHS(dm, prob['rhs'], qOrder=3).data
        s = solverFactory.build('cg-jacobi', A=A, setup=True)
        s.tolerance, s.maxIter = 1e-6, 400
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.solve(b)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, s.iterations, len(s.residuals) - 1

    # warm-up: build, Triton compiles, lazy module loading
    dmw = build(3)
    solve(getOp(asm.nonlocalBuilder(dmw, prob['kernel'])), dmw)

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
    dm = build(args.noRef)
    builderParts = {}

    def assemble():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        builder = asm.nonlocalBuilder(dm, prob['kernel'])
        A = getOp(builder)
        torch.cuda.synchronize()
        if not builderParts:
            builderParts.update(getattr(builder, 'timers', {}))
        return A, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    A, tAsm = assemble()
    peakAsm = torch.cuda.max_memory_allocated()
    del A
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

    tCold, its, steps = solve(A, dm)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as profS:
        tWarm, its2, steps2 = solve(A, dm)

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
    x = torch.randn(dm.num_dofs, dtype=torch.float64, device='cuda')
    y = torch.empty_like(x)
    A.matvec(x, out=y)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        A.matvec(x, out=y)
    end.record()
    torch.cuda.synchronize()
    res = {
        'card': card, 'matrixFormat': args.matrixFormat,
        'noRef': args.noRef, 'dofs': dm.num_dofs,
        'cells': dm.mesh.num_cells,
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
        'matvec_ms': start.elapsed_time(end) / 20,
        'launches': dict(kernels.launches),
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res, indent=1))


if __name__ == '__main__':
    main()

"""Complex Helmholtz with impedance boundary conditions, solved by GMRES
right-preconditioned with a complex-shifted-Laplacian geometric
multigrid, with the port.

    python -m pynucleus_tpu_torch.drivers.runHelmholtz --domain square \\
        [--problem wave|greens] [--element P1] [--frequency 40] \\
        [--maxiter 300] [--device cuda|cpu]

Port of drivers/runHelmholtz.py with its flags and defaults (square,
noRef 8: 66,049 dofs; interval, noRef 7; frequency 40; problem wave):

  A      = S - omega^2 M + i omega M_B           (the solve operator)
  A_prec = A + 0.5 i omega^2 M                   (the multigrid levels)

with every dof free (NO_BOUNDARY) and M_B the boundary mass, on the
coarse levels its Galerkin restriction P^T M_B P.  The levels are the
refinements from the coarse-level rule of the JAX driver on (the square:
4 levels, 1,089 to 66,049 dofs; the interval: 2).  S and M are assembled
in CSR on the device (K16) and combined on the host in scipy, as the JAX
driver does; the complex128 operators then live on the device.  GMRES
(restart ``--maxiter``, one cycle, absolute tolerance 1e-5) runs K17's
complex variant and is preconditioned by one V-cycle (2+2 damped-Jacobi
sweeps, omega 0.8: K9's and K10's complex variants, a complex coarse LU).
It runs on the card unless ``--device cpu`` asks for the CPU; asking for
the card without one raises; the cube raises (no 3D mesh in the port).
It prints the JAX driver's ``info`` and ``results`` (numIter, the last
residual, the solution's L2 norm and the L2 error, each
sqrt(|vdot(x, M x)|)) and ``timers``: the host set-up parts, the
multigrid set-up and the solve, in seconds.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..config import getDevice
from ..base.linear_operators import CSR_LinearOperator
from ..base.solvers import gmres_solver
from ..base.utilsFem import outputGroup
from ..fem.assembly import (assembleStiffness, assembleMass, assembleRHS,
                            assembleSurfaceMass, assembleSurfaceRHS)
from ..fem.dofmaps import str2DoFMap
from ..fem.meshes import NO_BOUNDARY
from ..fem.pdeProblems import helmholtzProblem
from ..multilevel.gmg import buildProlongation, multigrid

SMOOTHER = ('jacobi', {'omega': 0.8, 'presmoothingSteps': 2,
                       'postsmoothingSteps': 2})
SHIFT = 0.5
TOLERANCE = 1e-5


def parser():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--domain', default='square',
                   choices=['square', 'interval', 'cube'])
    p.add_argument('--problem', default='wave', choices=['wave', 'greens'])
    p.add_argument('--element', default='P1', choices=['P1'])
    p.add_argument('--frequency', type=float, default=40.0)
    p.add_argument('--maxiter', type=int, default=300)
    p.add_argument('--device', default='cuda')
    return p


def hierarchyMeshes(mesh0, noRef):
    """The meshes of the JAX driver's levels: mesh0 refined noRef times,
    from the first level of its coarse-level rule (the first refinement
    whose successor has 4,500 cells or more by the rule's count, one
    past it, and at most noRef - 1) to the finest."""
    meshes = [mesh0]
    for _ in range(noRef):
        meshes.append(meshes[-1].refine())
    mdim = mesh0.manifold_dim
    numInitialCells = {1: 2, 2: 8, 3: 48}[mdim]
    numCells = numInitialCells * (2 ** mdim) ** np.arange(noRef + 1)
    cg = 0
    while numCells[cg + 1] < 4500 and cg < noRef - 1:
        cg += 1
    cg = min(cg + 1, noRef - 1)
    return meshes[cg:]


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _fromScipy(A, device):
    A = A.tocsr()
    A.sort_indices()
    return CSR_LinearOperator.from_scipy(A, device=device)


def solveHelmholtz(meshes, problem, frequency=40.0, maxiter=300,
                   element='P1', device='cuda', timers=None):
    """The JAX driver's body on the level meshes ``meshes`` (coarse to
    fine): the complex-shifted multigrid hierarchy, the load and boundary
    vectors of ``problem`` (a dict of :func:`helmholtzProblem`) and GMRES.
    Returns a dict with the output groups 'info' and 'results', the level
    ``hierarchy``, the multigrid solver ``ml``, the operator ``A``, the
    mass matrix ``M``, the finest dofmap ``dm``, the load ``b``, the
    solver ``gmres`` and the solution ``x``.  ``timers``, an outputGroup,
    receives the seconds of each part."""
    dev = getDevice(device)
    timers = outputGroup('timers') if timers is None else timers

    def timed(label, fn):
        _sync(dev)
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        timers.add(f'{label} seconds', time.perf_counter() - t0)
        return out

    DM = str2DoFMap[element]
    # impedance (Robin) condition: every dof is free
    dms = timed('dofmaps', lambda: [DM(m, tag=NO_BOUNDARY, device=dev)
                                    for m in meshes])
    dm, mesh = dms[-1], meshes[-1]
    freq = frequency
    Ss, Ms = timed('S and M', lambda: (
        [assembleStiffness(d).to_scipy() for d in dms],
        [assembleMass(d).to_scipy() for d in dms]))
    Ps = timed('prolongations', lambda: [None] + [
        buildProlongation(dms[lvl - 1], dms[lvl])
        for lvl in range(1, len(dms))])

    def boundaryMass():
        # the fine level's boundary mass, Galerkin-restricted to the coarse
        # levels
        MBs = [None] * len(dms)
        MBs[-1] = assembleSurfaceMass(dm)
        for lvl in range(len(dms) - 2, -1, -1):
            P = Ps[lvl + 1].to_scipy()
            MBs[lvl] = (P.T @ MBs[lvl + 1] @ P).tocsr()
        return MBs
    MBs = timed('M_B', boundaryMass)

    def getOp(lvl, shift=0.0):
        A = (Ss[lvl] - freq ** 2 * Ms[lvl]).astype(np.complex128) \
            + 1j * freq * MBs[lvl]
        if shift:
            A = A + 1j * shift * freq ** 2 * Ms[lvl]
        return _fromScipy(A, dev)

    def operators():
        hierarchy = []
        for lvl in range(len(dms)):
            entry = {'A': getOp(lvl, shift=SHIFT)}
            if lvl > 0:
                entry['P'] = Ps[lvl]
                entry['R'] = Ps[lvl].T
            hierarchy.append(entry)
        return (hierarchy, getOp(len(dms) - 1),
                _fromScipy(Ms[-1].astype(np.complex128), dev))
    hierarchy, A, M = timed('host combination', operators)

    def setupMG():
        ml = multigrid(hierarchy=hierarchy, smoother=SMOOTHER)
        ml.tolerance = TOLERANCE
        ml.maxIter = maxiter
        ml.setup()
        return ml
    ml = timed('multigrid set-up', setupMG)

    def loads():
        b = assembleRHS(dm, problem['rhs'], qOrder=3).data
        b = b.to(torch.complex128)
        if problem['boundaryCond'] is not None:
            b = b + torch.as_tensor(
                assembleSurfaceRHS(dm, problem['boundaryCond']), device=dev)
        return b
    b = timed('load vectors', loads)

    gmres = gmres_solver(A)
    gmres.maxIter = maxiter
    gmres.restarts = 1
    gmres.tolerance = TOLERANCE
    gmres.setPreconditioner(ml.asPreconditioner())
    x = timed('solve', lambda: gmres.solve(b))
    res = gmres.residuals[1:]    # the reference's history has no initial one

    info = outputGroup('info')
    info.add('DoFs', dm.num_dofs)
    info.add('h', mesh.h)
    info.add('frequency', freq)
    results = outputGroup('results')
    results.add('Tolerance', TOLERANCE)
    results.add('numIter', len(res))
    results.add('res', float(res[-1]))
    results.add('solution L2 norm',
                float(np.sqrt(abs(complex(torch.vdot(x, M.matvec(x)))))))
    if problem['solEx'] is not None:
        diff = x - dm.interpolate(problem['solEx']).data
        results.add('L2 error', float(np.sqrt(abs(complex(
            torch.vdot(diff, M.matvec(diff)))))))
    return {'info': info, 'results': results, 'timers': timers,
            'hierarchy': hierarchy, 'ml': ml, 'A': A, 'M': M, 'dm': dm,
            'b': b, 'gmres': gmres, 'x': x}


def main(argv=None, quiet=False):
    """Run the driver; returns :func:`solveHelmholtz`'s dict."""
    args = parser().parse_args(argv)
    dev = getDevice(args.device)
    p = helmholtzProblem(args.domain, args.problem, args.frequency)
    timers = outputGroup('timers')
    timers.add('device', str(dev))
    t0 = time.perf_counter()
    meshes = hierarchyMeshes(p['mesh0'], p['noRef'])
    timers.add('meshes seconds', time.perf_counter() - t0)
    out = solveHelmholtz(meshes, p, args.frequency, args.maxiter,
                         args.element, dev, timers)
    if not quiet:
        for g in ('info', 'results', 'timers'):
            out[g].log()
    return out


if __name__ == '__main__':
    main()

"""Level hierarchy, solve and error report of a stationary nonlocal
problem.

Port of discretizedNonlocalProblem (pynucleus_tpu/nl/discretized.py:139-
288: the mesh and dofmap hierarchy, every level's operator, the Dirichlet
collar's A_BC and right-hand side, the solve and its explicit residual) and
of stationaryModelSolution's error formulas (:34-129) as plain functions;
the ``@generates`` DAG of the JAX package's driver is not ported.  The
solution comes from the device; the error integrals are host numpy with the
mass matrix of fem/assembly.py.
"""
from __future__ import annotations

import time

import numpy as np

import torch

from ..base.solvers import solverFactory, iterative_solver
from ..fem.assembly import assembleMass, assembleRHS
from ..fem.dofmaps import str2DoFMap
from ..multilevel.gmg import buildProlongation
from .assembly import assembleNonlocal, nonlocalBuilder, _sync
from .problems import DIRICHLET

__all__ = ['ERROR_LABELS', 'modelErrors', 'buildMeshHierarchy',
           'buildHierarchy', 'solveNonlocal']


def buildMeshHierarchy(mesh, solverType, tag, noRef, element, device):
    """(meshes, dms, Ps): the meshes of noRef 0 ... noRef by uniform
    refinement of ``mesh``; with a multigrid solver ('mg' in solverType) a
    dofmap on every level and the prolongation P of every level from the
    one below (Ps[0] is None), else a dofmap on the finest level only."""
    DM = str2DoFMap[element]
    meshes = [mesh]
    for _ in range(noRef):
        meshes.append(meshes[-1].refine())
    needAllLevels = 'mg' in solverType
    dms = [DM(m, tag=tag, device=device) for m in meshes] if needAllLevels \
        else [None] * (len(meshes) - 1) + [DM(meshes[-1], tag=tag,
                                               device=device)]
    Ps = [None]
    if needAllLevels:
        for lvl in range(1, len(meshes)):
            Ps.append(buildProlongation(dms[lvl - 1], dms[lvl]))
    return meshes, dms, Ps


def buildHierarchy(dms, Ps, kernel, solverType, matrixFormat, zeroExterior,
                   timers=None, params=None, levelParts=None):
    """The level list [{'A', 'P', 'R'}, ...], coarse to fine: every level
    assembled in ``matrixFormat`` with a multigrid solver (H2 stays H2 on
    every level), else the finest level only; R = P.T (its CSR is built
    here).  ``params`` go to the builder of every level.  ``timers``, if a
    dict, receives the assembly seconds of each level ('level k',
    synchronised at the level's end) and the finest level's build parts;
    ``levelParts``, if a dict, the build parts of every level (level ->
    {part: seconds})."""
    needAllLevels = 'mg' in solverType
    hierarchy = []
    nLvl = len(dms)
    for lvl in range(nLvl):
        entry = {}
        if needAllLevels or lvl == nLvl - 1:
            dm = dms[lvl]
            parts = {}
            t0 = time.perf_counter()
            entry['A'] = assembleNonlocal(dm, kernel,
                                          matrixFormat=matrixFormat,
                                          zeroExterior=zeroExterior,
                                          params=params, timers=parts)
            _sync(dm.device)
            if timers is not None:
                timers[f'level {lvl}'] = time.perf_counter() - t0
                if lvl == nLvl - 1:
                    timers.update(parts)
            if levelParts is not None:
                levelParts[lvl] = parts
        if 0 < lvl < len(Ps) and Ps[lvl] is not None:
            entry['P'] = Ps[lvl]
            entry['R'] = Ps[lvl].T
        hierarchy.append(entry)
    return hierarchy

# labels, in the order of the JAX package's report (reportErrors)
ERROR_LABELS = ('L2 error', 'relative L2 error', 'L2 error interpolated',
                'relative interpolated L2 error', 'Linf error interpolated',
                'relative interpolated Linf error', 'Hs error',
                'relative Hs error')


def modelErrors(dm, u, b, analyticSolution, exactL2Squared, exactHsSquared):
    """Errors of the solution u (fe_vector or tensor) against the analytic
    solution; b is the load vector the solve used.  As the JAX package
    reports them, an error whose data is missing (no analytic solution, no
    exact norm) is left out."""
    uh = np.asarray(u.toarray() if hasattr(u, 'toarray') else
                    u.detach().cpu().numpy(), dtype=np.float64)
    bh = b.toarray() if hasattr(b, 'toarray') else b.detach().cpu().numpy()
    out = {}
    if analyticSolution is None:
        return out
    M = assembleMass(dm)
    if exactL2Squared is not None:
        z = assembleRHS(dm, analyticSolution).toarray()
        L2 = np.sqrt(abs(exactL2Squared - 2 * float(z @ uh)
                         + float(uh @ (M @ uh))))
        out['L2 error'] = L2
        out['relative L2 error'] = L2 / np.sqrt(exactL2Squared)
    uI = np.asarray(analyticSolution(dm.getDoFCoordinates()), dtype=np.float64)
    d = uh - uI
    L2i = float(np.sqrt(d @ (M @ d)))
    Linf = float(np.abs(d).max())
    out['L2 error interpolated'] = L2i
    out['relative interpolated L2 error'] = L2i / float(np.sqrt(uI @ (M @ uI)))
    out['Linf error interpolated'] = Linf
    out['relative interpolated Linf error'] = Linf / float(np.abs(uI).max())
    if exactHsSquared is not None:
        Hs = np.sqrt(abs(float(bh @ uh) - exactHsSquared))
        out['Hs error'] = Hs
        out['relative Hs error'] = Hs / np.sqrt(exactHsSquared)
    return {label: out[label] for label in ERROR_LABELS if label in out}


def solveNonlocal(prob, noRef, element, solverType, matrixFormat, tol,
                  maxiter, device, params=None):
    """discretizedNonlocalProblem of a finite-horizon problem ``prob``
    (nl/problems.py nonlocalPoissonProblem): the mesh and dofmap hierarchy
    of noRef uniform refinements with the problem's dof tag, every level's
    operator in ``matrixFormat`` with a multigrid solver (the finest only
    otherwise), A_BC of the Dirichlet collar on the finest level, the load
    b = assembleRHS(qOrder=3) - A_BC u_BC, the solve and its explicit
    residual.  Returns a dict of them with ``timers`` (seconds: 'set-up',
    'assembly level k' with the parts of each level, 'A_BC', 'solve') and
    ``levelParts``."""
    dev = device
    timers = {}
    _sync(dev)
    t0 = time.perf_counter()
    meshes, dms, Ps = buildMeshHierarchy(prob['mesh'], solverType,
                                         prob['tag'], noRef, element, dev)
    dm = dms[-1]
    dmBC = dm.getComplementDoFMap()
    _sync(dev)
    timers['set-up'] = time.perf_counter() - t0
    parts, levelParts = {}, {}
    hierarchy = buildHierarchy(dms, Ps, prob['kernel'], solverType,
                               matrixFormat, prob['zeroExterior'],
                               timers=parts, params=params,
                               levelParts=levelParts)
    for lvl in sorted(levelParts):
        timers[f'assembly level {lvl}'] = parts[f'level {lvl}']
    A = hierarchy[-1]['A']
    t0 = time.perf_counter()
    A_BC = None
    b = assembleRHS(dm, prob['rhs'], qOrder=3)
    if prob['boundaryCondition'] == DIRICHLET and dmBC.num_dofs > 0:
        A_BC = nonlocalBuilder(dm, prob['kernel'], params=params,
                               zeroExterior=prob['zeroExterior'],
                               device=dev).getDenseCross()
        if prob['dirichletData'] is not None:
            uBC = dmBC.interpolate(prob['dirichletData'])
            b.data = b.data - A_BC.matvec(uBC.data)
    _sync(dev)
    timers['A_BC'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = solverFactory.build(solverType, hierarchy=hierarchy, setup=True)
    if isinstance(solver, iterative_solver):
        solver.tolerance = tol
        solver.maxIter = maxiter
    _sync(dev)
    timers['solver set-up'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    u = solver.solve(b.data)
    _sync(dev)
    timers['solve'] = time.perf_counter() - t0
    resError = float(torch.linalg.norm(b.data - A.matvec(u)))
    return {'meshes': meshes, 'dm': dm, 'dmBC': dmBC, 'hierarchy': hierarchy,
            'A': A, 'A_BC': A_BC, 'b': b, 'u': u, 'solver': solver,
            'iterations': getattr(solver, 'iterations', 1),
            'explicitResidualError': resError, 'timers': timers,
            'levelParts': levelParts}

"""Level hierarchy and error report of a stationary nonlocal solve.

Port of discretizedNonlocalProblem.buildMeshHierarchy and buildHierarchy
(pynucleus_tpu/nl/discretized.py:166-213) and of stationaryModelSolution's
error formulas (:34-129) as plain functions; the ``@generates`` DAG of the
JAX package's driver is not ported.  The solution comes from the device;
the error integrals are host numpy with the mass matrix of
fem/assembly.py.
"""
from __future__ import annotations

import time

import numpy as np

from ..fem.assembly import assembleMass, assembleRHS
from ..fem.dofmaps import str2DoFMap
from ..multilevel.gmg import buildProlongation
from .assembly import assembleNonlocal, _sync

__all__ = ['ERROR_LABELS', 'modelErrors', 'buildMeshHierarchy',
           'buildHierarchy']


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
                   timers=None):
    """The level list [{'A', 'P', 'R'}, ...], coarse to fine: every level
    assembled in ``matrixFormat`` with a multigrid solver (H2 stays H2 on
    every level), else the finest level only; R = P.T (its CSR is built
    here).  ``timers``, if a dict, receives the assembly seconds of each
    level ('level k', synchronised at the level's end) and the finest
    level's build parts."""
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
                                          timers=parts)
            _sync(dm.device)
            if timers is not None:
                timers[f'level {lvl}'] = time.perf_counter() - t0
                if lvl == nLvl - 1:
                    timers.update(parts)
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
    solution; b is the load vector the solve used."""
    uh = np.asarray(u.toarray() if hasattr(u, 'toarray') else
                    u.detach().cpu().numpy(), dtype=np.float64)
    bh = b.toarray() if hasattr(b, 'toarray') else b.detach().cpu().numpy()
    M = assembleMass(dm)
    z = assembleRHS(dm, analyticSolution).toarray()
    L2 = np.sqrt(abs(exactL2Squared - 2 * float(z @ uh) + float(uh @ (M @ uh))))
    uI = np.asarray(analyticSolution(dm.getDoFCoordinates()), dtype=np.float64)
    d = uh - uI
    L2i = float(np.sqrt(d @ (M @ d)))
    Linf = float(np.abs(d).max())
    Hs = np.sqrt(abs(float(bh @ uh) - exactHsSquared))
    return {'L2 error': L2,
            'relative L2 error': L2 / np.sqrt(exactL2Squared),
            'L2 error interpolated': L2i,
            'relative interpolated L2 error':
                L2i / float(np.sqrt(uI @ (M @ uI))),
            'Linf error interpolated': Linf,
            'relative interpolated Linf error': Linf / float(np.abs(uI).max()),
            'Hs error': Hs,
            'relative Hs error': Hs / np.sqrt(exactHsSquared)}

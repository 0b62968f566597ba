"""Fractional Laplacian problems on the interval and the disc.

Port of the infinite-horizon ``problem constant`` cases of
pynucleus_tpu/nl/problems.py (fractionalLaplacianProblem and the
nonlocalMeshFactory entries 'interval' and 'disc') as a plain function;
the ``@generates`` DAG of the JAX package's driver comes in a later port.
"""
from __future__ import annotations

import numpy as np
from scipy.special import gamma as Gamma

from ..fem.meshes import simpleInterval, circle, PHYSICAL
from ..fem.dofmaps import P1_DoFMap
from ..fem.functions import constant, solFractional
from .kernels import constFractionalOrder, getFractionalKernel

__all__ = ['parseFractionalOrder', 'defaultNoRef', 'fractionalLaplacianProblem']


def parseFractionalOrder(sArg):
    """'const(0.75)' (or a number) -> constFractionalOrder."""
    if isinstance(sArg, (int, float)):
        return constFractionalOrder(float(sArg))
    if sArg.startswith('const(') and sArg.endswith(')'):
        return constFractionalOrder(float(sArg[len('const('):-1]))
    raise NotImplementedError(sArg)


def defaultNoRef(domain, element='P1'):
    """Refinement count of the driver's default (ref nonlocalProblems.py
    :556-603, non-adaptive)."""
    if domain == 'interval':
        return {'P0': 6, 'P1': 6, 'P2': 5, 'P3': 5}[element]
    if domain == 'disc':
        return 5
    raise NotImplementedError(domain)


def _coarseMesh(domain):
    """Coarse mesh of the homogeneous-Dirichlet, infinite-horizon problem,
    refined until the P1 space on the PHYSICAL tag has dofs."""
    if domain == 'interval':
        mesh = simpleInterval(-1.0, 1.0)
    elif domain == 'disc':
        mesh = circle(h=0.78, radius=1.0)
    else:
        raise NotImplementedError(domain)
    while P1_DoFMap(mesh, PHYSICAL, device='cpu').num_dofs == 0:
        mesh = mesh.refine()
    return mesh


def fractionalLaplacianProblem(domain, s, problem='constant'):
    """(-Delta)^s u = 1 on the unit ball, u = 0 outside.  Returns a dict
    with kernel, rhs, analyticSolution, exactL2Squared, exactHsSquared,
    the coarse mesh, the dof tag and zeroExterior."""
    if problem != 'constant':
        raise NotImplementedError(problem)
    dim = {'interval': 1, 'disc': 2}[domain]
    sFun = parseFractionalOrder(s)
    sval = sFun.value
    radius = 1.0
    kernel = getFractionalKernel(dim, sFun)
    C = 2.0 ** (-2 * sval) * Gamma(dim / 2.) \
        / Gamma((dim + 2 * sval) / 2.) / Gamma(1. + sval)
    if domain == 'interval':
        exactHsSquared = C * np.sqrt(np.pi) * Gamma(sval + 1) \
            / Gamma(sval + 1.5)
        exactL2Squared = C ** 2 * np.sqrt(np.pi) \
            * Gamma(1 + 2 * sval) / Gamma(1.5 + 2 * sval) * radius ** 2
    else:
        exactHsSquared = C * np.pi * radius ** (2 - 2 * sval) / (sval + 1)
        exactL2Squared = C ** 2 * np.pi / (1 + 2 * sval) * radius ** 2
    return {'kernel': kernel,
            'dim': dim,
            'rhs': constant(1.0),
            'analyticSolution': solFractional(sval, dim, radius),
            'exactL2Squared': exactL2Squared,
            'exactHsSquared': exactHsSquared,
            'mesh': _coarseMesh(domain),
            'tag': PHYSICAL,
            'zeroExterior': True,
            'problemDescription': 'constant rhs, homogeneous Dirichlet'}

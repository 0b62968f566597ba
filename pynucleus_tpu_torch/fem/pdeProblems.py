"""Local PDE problems of the serial multigrid driver.

Port of diffusionProblem (pynucleus_tpu/fem/pdeProblems.py:16-94) as a
plain function returning a dict, as nl/problems.py does for the nonlocal
problems: -Delta u = f with homogeneous Dirichlet conditions on the unit
interval (problem 'sin') and the unit square ('sin', 'poly'), with the JAX
package's right-hand sides, exact solutions, exact norms ``L2ex`` =
||u||^2_L2 and ``H10ex`` = |u|^2_H1, coarse meshes and default noRef.  The
functions are the JAX package's expressions, evaluated over all points at
once.  The cube is not ported: the port has no 3D mesh or dofmap.
"""
from __future__ import annotations

import numpy as np

from .functions import function
from .meshes import simpleInterval, uniformSquare

__all__ = ['diffusionProblem', 'defaultNoRefDiffusion', 'pointwise']


class pointwise(function):
    """A callable f(x) applied to the points X [N, dim] at once, with x
    [dim, N] (x[0] the first coordinates), as the JAX package's Lambda
    applies it to one point x [dim] at a time."""

    def __init__(self, fun):
        self.fun = fun

    def eval(self, X):
        return np.asarray(self.fun(X.T), dtype=np.float64)


def defaultNoRefDiffusion(domain, element='P1'):
    """The JAX package's default noRef (pdeProblems.py:32-41)."""
    if domain in ('interval', 'unitInterval'):
        return {'P1': 15, 'P2': 14, 'P3': 13}[element]
    if domain in ('cube', 'unitCube', 'gradedCube'):
        return {'P1': 6, 'P2': 5, 'P3': 4}[element]
    return {'P1': 9, 'P2': 8, 'P3': 7}[element]


def diffusionProblem(domain='square', problem='sin', noRef=-1,
                     element='P1'):
    """dict of the problem: dim, mesh0 (the coarse mesh), rhsFun,
    exactSolution, L2ex, H10ex and noRef (the default when noRef <= 0)."""
    if noRef is None or noRef <= 0:
        noRef = defaultNoRefDiffusion(domain, element)
    out = {'noRef': noRef, 'diffusivity': None, 'reaction': None,
           'boundaryCond': None}
    if domain in ('interval', 'unitInterval'):
        out.update(dim=1, mesh0=simpleInterval(0.0, 1.0))
        if problem == 'sin':
            out.update(
                rhsFun=pointwise(lambda x: np.pi ** 2 * np.sin(np.pi * x[0])),
                exactSolution=pointwise(lambda x: np.sin(np.pi * x[0])),
                L2ex=0.5, H10ex=np.pi ** 2 / 2)
        else:
            raise NotImplementedError(problem)
    elif domain in ('square', 'unitSquare'):
        out.update(dim=2, mesh0=uniformSquare(N=2, ax=0., ay=0., bx=1., by=1.))
        if problem == 'sin':
            out.update(
                rhsFun=pointwise(
                    lambda x: 2 * np.pi ** 2 * np.sin(np.pi * x[0])
                    * np.sin(np.pi * x[1])),
                exactSolution=pointwise(
                    lambda x: np.sin(np.pi * x[0]) * np.sin(np.pi * x[1])),
                L2ex=0.25, H10ex=2 * np.pi ** 2 / 4)
        elif problem == 'poly':
            out.update(
                rhsFun=pointwise(
                    lambda x: 32 * x[0] * (1 - x[0]) + 32 * x[1] * (1 - x[1])),
                exactSolution=pointwise(
                    lambda x: 16 * x[0] * x[1] * (1 - x[0]) * (1 - x[1])),
                L2ex=256 / 900, H10ex=256 / 45)
        else:
            raise NotImplementedError(problem)
    elif domain in ('cube', 'unitCube'):
        raise NotImplementedError('diffusionProblem on the cube: the port has '
                                  'no 3D mesh or dofmap')
    else:
        raise NotImplementedError(domain)
    return out

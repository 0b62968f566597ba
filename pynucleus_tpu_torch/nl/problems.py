"""Nonlocal problems: the fractional Laplacian on the interval and the disc
(infinite horizon), the finite-horizon nonlocal Poisson problems on the
interval and the square with an interaction collar (the constant,
inverseDistance, fractional, gaussian and exponential kernels), and the
gaussian and exponential kernels' problems of an infinite horizon.

Port of pynucleus_tpu/nl/problems.py as plain functions (the ``@generates``
DAG of the JAX package's drivers is not ported): the infinite-horizon
``problem constant`` and, on the interval, ``knownSolution`` of
fractionalLaplacianProblem, for the orders of parseFractionalOrder; nonlocalMeshFactory's
'interval', 'square' and 'disc' entries with their indicators
(intervalIndicators, squareIndicators, radialIndicators, :44-168), with
the collar for a finite horizon and the plain domain for an infinite one; processKernel
(:214-236); nonlocalPoissonProblem (:416-566) with the ``poly-Dirichlet``,
``constant``, ``gaussian`` and ``exponential`` problems (``poly-Neumann``
needs the Sum operator and is not ported).
"""
from __future__ import annotations

import numpy as np
from scipy.special import gamma as Gamma

from ..fem.meshes import (simpleInterval, circle, intervalWithInteraction,
                          squareWithInteractions, uniformSquare,
                          discWithInteraction, PHYSICAL, NO_BOUNDARY)
from ..fem.dofmaps import P1_DoFMap
from ..fem.functions import (constant, Lambda, squareIndicator,
                             radialIndicator, solFractional)
from .kernels import (constFractionalOrder, variableConstFractionalOrder,
                      constantNonSymFractionalOrder, leftRightFractionalOrder,
                      fractionalOrderFactory, getFractionalKernel,
                      getIntegrableKernel, ball2, ballInf, FRACTIONAL,
                      GAUSSIAN, EXPONENTIAL)

__all__ = ['parseFractionalOrder', 'defaultNoRef',
           'fractionalLaplacianProblem', 'nonlocalMesh', 'processKernel',
           'nonlocalPoissonProblem', 'defaultNoRefNonlocal', 'DIRICHLET',
           'NEUMANN', 'HOMOGENEOUS_DIRICHLET', 'HOMOGENEOUS_NEUMANN',
           'KERNEL_TYPES', 'PROBLEMS']

# boundary condition enums (pynucleus_tpu/nl/problems.py)
DIRICHLET = 0
NEUMANN = 1
HOMOGENEOUS_DIRICHLET = 2
HOMOGENEOUS_NEUMANN = 3


def parseFractionalOrder(sArg):
    """'const(0.75)', 'varconst(0.75)', 'constantNonSym(0.25)',
    'twoDomainNonSym(0.25,0.75)' or 'twoDomain(0.25,0.75)' (or a number)
    -> the fractional order (pynucleus_tpu/nl/problems.py
    parseFractionalOrder); and the other names of fractionalOrderFactory
    with the arguments of their constructors, numbers, positional or
    ``name=value``: 'innerOuter(2,0.75,0.25,0.5)' (dim, sii, soo, r),
    'islands(0.3,0.7,r=0.1,r2=0.6)', 'smoothedLeftRight(0.25,0.75,r=0.1)'
    (also smoothedTwoDomain), 'linearLeftRightNonSym(0.25,0.75,r=0.5)',
    'innerOuterNonSym(0.3,0.6,r=0.1,radius=0.5)' and 'layers(dim, nL,
    the nL + 1 boundaries, the nL^2 orders row by row)'.  The fe order
    needs an FE vector and is not parsed."""
    if isinstance(sArg, (int, float)):
        return constFractionalOrder(float(sArg))
    for name, builder in [
            ('const', lambda v: constFractionalOrder(v[0])),
            ('varconst', lambda v: variableConstFractionalOrder(v[0])),
            ('constantNonSym', lambda v: constantNonSymFractionalOrder(v[0])),
            ('twoDomainNonSym',
             lambda v: leftRightFractionalOrder(v[0], v[1])),
            ('twoDomain', lambda v: leftRightFractionalOrder(v[0], v[1]))]:
        if sArg.startswith(name + '('):
            inner = sArg[len(name) + 1:-1]
            return builder([float(t) for t in inner.split(',') if t.strip()])
    name, _, inner = sArg.partition('(')
    if name == 'fe' or name not in fractionalOrderFactory \
            or not inner.endswith(')'):
        raise NotImplementedError(sArg)
    args, kw = [], {}
    for tok in (t.strip() for t in inner[:-1].split(',')):
        if '=' in tok:
            k, v = tok.split('=')
            kw[k.strip()] = float(v)
        elif tok:
            args.append(float(tok))
    if name == 'innerOuter':
        args[0] = int(args[0])
    elif name == 'layers':
        dim, nL = int(args[0]), int(args[1])
        bounds = args[2:3 + nL]
        orders = np.reshape(args[3 + nL:], (nL, nL))
        return fractionalOrderFactory[name](dim, bounds, orders)
    return fractionalOrderFactory[name](*args, **kw)


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
    """(-Delta)^s u = f on the unit ball, u = 0 outside
    (pynucleus_tpu/nl/problems.py fractionalLaplacianProblem): 'constant'
    (f = 1; the analytic solution and the exact norms of a constant order,
    none for a leftRight order, as there) or, on the interval,
    'knownSolution' (u = (1 - x^2)^beta, beta = 0.7, f from scipy's hyp2f1
    on the host with s(x, x) per point, :323-338).  Returns a dict with
    kernel, rhs, analyticSolution, exactL2Squared, exactHsSquared, the
    coarse mesh, the dof tag and zeroExterior."""
    dim = {'interval': 1, 'disc': 2}[domain]
    sFun = parseFractionalOrder(s)
    kernel = getFractionalKernel(dim, sFun)
    radius = 1.0
    sval = sFun.value if hasattr(sFun, 'value') else None
    out = {'kernel': kernel, 'dim': dim, 'mesh': _coarseMesh(domain),
           'tag': PHYSICAL, 'zeroExterior': True, 'analyticSolution': None,
           'exactL2Squared': None, 'exactHsSquared': None}
    if problem == 'constant':
        out['rhs'] = constant(1.0)
        out['problemDescription'] = 'constant rhs, homogeneous Dirichlet'
        if sval is not None:
            C = 2.0 ** (-2 * sval) * Gamma(dim / 2.) \
                / Gamma((dim + 2 * sval) / 2.) / Gamma(1. + sval)
            if domain == 'interval':
                out['exactHsSquared'] = C * np.sqrt(np.pi) \
                    * Gamma(sval + 1) / Gamma(sval + 1.5)
                out['exactL2Squared'] = C ** 2 * np.sqrt(np.pi) \
                    * Gamma(1 + 2 * sval) / Gamma(1.5 + 2 * sval) \
                    * radius ** 2
            else:
                out['exactHsSquared'] = C * np.pi \
                    * radius ** (2 - 2 * sval) / (sval + 1)
                out['exactL2Squared'] = C ** 2 * np.pi / (1 + 2 * sval) \
                    * radius ** 2
            out['analyticSolution'] = solFractional(sval, dim, radius)
        return out
    if problem == 'knownSolution' and domain == 'interval':
        from scipy.special import hyp2f1
        beta = 0.7

        def fun(x):
            # pointwise s(x, x) for variable orders
            sv = float(np.asarray(sFun(np.asarray(x)[None, :],
                                       np.asarray(x)[None, :]))[0])
            return (2.0 ** (2 * sv) * Gamma(sv + 0.5) * Gamma(beta + 1.)
                    / np.sqrt(np.pi) / Gamma(beta + 1. - sv)
                    * hyp2f1(sv + 0.5, -beta + sv, 0.5, x[0] ** 2))
        out['rhs'] = Lambda(fun)
        out['problemDescription'] = 'known analytic solution'
        out['analyticSolution'] = Lambda(
            lambda x: max(1. - x[0] ** 2, 0.) ** beta)
        out['exactL2Squared'] = np.sqrt(np.pi) * Gamma(1 + 2 * beta) \
            / Gamma(1.5 + 2 * beta) * radius ** 2
        return out
    raise NotImplementedError((domain, problem))


# ------------------------------------------------------ finite horizon ----

def intervalIndicators(a=-1.0, b=1.0):
    eps = 1e-12
    domainIndicator = squareIndicator(np.array([a + eps]), np.array([b - eps]))
    interactionIndicator = Lambda(
        lambda x: 1.0 if (x[0] < a - eps or x[0] > b + eps) else 0.0)
    boundaryIndicator = Lambda(
        lambda x: 1.0 if (abs(x[0] - a) < eps or abs(x[0] - b) < eps) else 0.0)
    return domainIndicator, boundaryIndicator, interactionIndicator


def radialIndicators(radius=1.0):
    eps = 1e-12
    domainIndicator = radialIndicator(radius - eps)
    interactionIndicator = constant(1.0) - radialIndicator(radius + eps)
    boundaryIndicator = radialIndicator(radius + eps) \
        - radialIndicator(radius - eps)
    return domainIndicator, boundaryIndicator, interactionIndicator


def squareIndicators(ax=-1.0, ay=-1.0, bx=1.0, by=1.0):
    eps = 1e-12
    domainIndicator = squareIndicator(np.array([ax + eps, ay + eps]),
                                      np.array([bx - eps, by - eps]))
    interactionIndicator = constant(1.0) - squareIndicator(
        np.array([ax - eps, ay - eps]), np.array([bx + eps, by + eps]))
    boundaryIndicator = constant(1.0) - domainIndicator - interactionIndicator
    return domainIndicator, boundaryIndicator, interactionIndicator


# name -> (dim, mesh with collar, indicators, domain parameters, plain
# mesh and its parameters)
_DOMAINS = {
    'interval': (1, intervalWithInteraction, intervalIndicators,
                 {'a': -1.0, 'b': 1.0}, simpleInterval,
                 {'a': -1.0, 'b': 1.0}),
    'square': (2, squareWithInteractions, squareIndicators,
               {'ax': -1., 'ay': -1., 'bx': 1., 'by': 1.}, uniformSquare,
               {'N': 2, 'M': 2, 'ax': -1., 'ay': -1., 'bx': 1., 'by': 1.}),
    'disc': (2, discWithInteraction, radialIndicators, {'radius': 1.0},
             circle, {'h': 0.78, 'radius': 1.0}),
}


def _domain(name):
    if name not in _DOMAINS:
        raise NotImplementedError(f'domain {name!r}')
    return _DOMAINS[name]


def nonlocalMesh(domain, kernel, boundaryCondition):
    """(mesh, info) of pynucleus_tpu/nl/problems.py nonlocalMeshFactory
    .build (:59-120): for a finite horizon the domain with its interaction
    collar of width horizon (no exterior term); for an infinite one, with a
    homogeneous Dirichlet condition, the plain domain, tag PHYSICAL and the
    zero-exterior term; and the domain, boundary and interaction
    indicators."""
    dim, meshCollar, indicators, params, meshPlain, paramsPlain = \
        _domain(domain)
    horizonValue = kernel.horizonValue
    if not horizonValue > 0:
        raise NotImplementedError('a positive horizon is expected')
    if boundaryCondition == HOMOGENEOUS_DIRICHLET:
        tag = PHYSICAL
    elif boundaryCondition == DIRICHLET:
        if horizonValue == np.inf:
            raise NotImplementedError(
                'inhomogeneous Dirichlet for infinite horizon')
        tag = NO_BOUNDARY
    else:
        raise NotImplementedError(f'boundary condition {boundaryCondition}')
    zeroExterior = horizonValue == np.inf
    domainIndicator, boundaryIndicator, interactionIndicator = indicators()
    if zeroExterior:
        mesh = meshPlain(**paramsPlain)
    else:
        mesh = meshCollar(horizon=horizonValue, **params)
    while P1_DoFMap(mesh, tag, device='cpu').num_dofs == 0:
        mesh = mesh.refine()
    return mesh, {'domain': domainIndicator, 'boundary': boundaryIndicator,
                  'interaction': interactionIndicator, 'tag': tag,
                  'zeroExterior': zeroExterior}


# the driver's kernel types: the fractional kernel and the integrable ones
KERNEL_TYPES = ('fractional', 'constant', 'indicator', 'inverseDistance',
                'peridynamic', 'gaussian', 'exponential')


def processKernel(domain, kernelType, s, horizon, interaction='ball2',
                  normalized=True, gaussianVariance=1.0, exponentialRate=1.0):
    """The kernel of the driver's flags (pynucleus_tpu/nl/problems.py
    processKernel): a finite horizon takes the ball2 or ballInf
    interaction (ball2 for any other name, 'fullSpace' and 'ellipse'
    included: the JAX driver's mapping, mirrored), an infinite one the full
    space; 'constant' is the indicator kernel and
    'inverseDistance' the peridynamic one; the gaussian kernel takes its
    variance, the exponential one its rate."""
    dim = _domain(domain)[0]
    inter = None
    if horizon != np.inf:
        inter = {'ball2': ball2(), 'ballInf': ballInf()}.get(interaction,
                                                             ball2())
    if kernelType == 'fractional':
        return getFractionalKernel(dim, parseFractionalOrder(s),
                                   horizon=horizon, interaction=inter,
                                   normalized=normalized)
    if kernelType not in KERNEL_TYPES:
        raise NotImplementedError(f'kernelType {kernelType!r}')
    kname = {'constant': 'indicator',
             'inverseDistance': 'peridynamic'}.get(kernelType, kernelType)
    return getIntegrableKernel(dim, kname, horizon, interaction=inter,
                               normalized=normalized,
                               gaussian_variance=gaussianVariance,
                               exponentialRate=exponentialRate)


def defaultNoRefNonlocal(domain):
    """Refinement count of runNonlocal's default."""
    return {'interval': 8, 'square': 2, 'disc': 4}[domain]


PROBLEMS = ('poly-Dirichlet', 'constant', 'gaussian', 'exponential')


def nonlocalPoissonProblem(domain, kernelType='constant', s='const(0.4)',
                           horizon=0.2, interaction='ball2', normalized=True,
                           problem='poly-Dirichlet', gaussianVariance=1.0,
                           exponentialRate=1.0):
    """Nonlocal Poisson problem: a dict with the kernel, the coarse mesh
    (with its collar for a finite horizon), the dof tag (the domain
    indicator), the boundary condition, rhs, Dirichlet data and analytic
    solution.

    poly-Dirichlet is the quadratic patch test: for any normalized kernel
    the nonlocal operator reproduces -Laplacian on quadratics, so
    u = 1 - |x|^2, extended into the collar as Dirichlet data, is solved to
    machine precision.  gaussian and exponential are the manufactured
    solutions exp(-x^2 / (2 variance)) and exp(-rate |x|) of the
    infinite-horizon gaussian and exponential kernels on the interval
    (pynucleus_tpu/nl/problems.py:540-564), homogeneous Dirichlet."""
    kernel = processKernel(domain, kernelType, s, horizon, interaction,
                           normalized, gaussianVariance, exponentialRate)
    dim = kernel.dim
    if problem == 'poly-Dirichlet':
        boundaryCondition = DIRICHLET
    elif problem in ('constant', 'gaussian', 'exponential'):
        boundaryCondition = HOMOGENEOUS_DIRICHLET
    else:
        raise NotImplementedError(f'problem {problem!r} (poly-Neumann needs '
                                  'the Sum operator)')
    mesh, info = nonlocalMesh(domain, kernel, boundaryCondition)
    out = {'kernel': kernel, 'dim': dim, 'mesh': mesh,
           # dofs are interior where the domain indicator is positive
           'tag': info['domain'], 'zeroExterior': info['zeroExterior'],
           'boundaryCondition': boundaryCondition,
           'domainIndicator': info['domain'],
           'interactionIndicator': info['interaction'],
           'dirichletData': None, 'analyticSolution': None,
           'exactL2Squared': None, 'exactHsSquared': None}
    if problem == 'poly-Dirichlet':
        out['problemDescription'] = 'quadratic patch test, Dirichlet collar'
        out['rhs'] = constant(2.0 * dim)
        out['dirichletData'] = Lambda(
            lambda x: 1 - np.sum(np.asarray(x) ** 2))
        if kernel.kernelType != FRACTIONAL or hasattr(kernel.s, 'value'):
            out['analyticSolution'] = Lambda(
                lambda x: 1 - np.sum(np.asarray(x) ** 2))
    elif problem == 'constant':
        out['problemDescription'] = 'constant forcing, homogeneous collar'
        out['rhs'] = constant(1.0)
    elif problem == 'gaussian':
        # manufactured Gaussian solution for the infinite-horizon Gaussian
        # kernel (the Dirichlet data is approximated by zero, valid for
        # small variance)
        gv = kernel.variance if (kernel.kernelType == GAUSSIAN
                                 and not kernel.finiteHorizon) else 1.0
        out['problemDescription'] = 'gaussian forcing, homogeneous collar'
        out['rhs'] = Lambda(
            lambda x: np.exp(-0.5 * x[0] ** 2 / gv)
            - np.exp(-0.25 * x[0] ** 2 / gv) / np.sqrt(2.0))
        if kernel.kernelType == GAUSSIAN and not kernel.finiteHorizon:
            out['analyticSolution'] = Lambda(
                lambda x: np.exp(-0.5 * x[0] ** 2 / gv))
    else:
        er = kernel.exponentParam if (kernel.kernelType == EXPONENTIAL
                                      and not kernel.finiteHorizon) else 1.0
        scal = kernel.scalingValue
        out['problemDescription'] = 'exponential forcing, homogeneous collar'
        out['rhs'] = Lambda(
            lambda x: np.exp(-er * abs(x[0]))
            * (1.0 / er - abs(x[0])) * scal * 2.0)
        if kernel.kernelType == EXPONENTIAL and not kernel.finiteHorizon:
            out['analyticSolution'] = Lambda(
                lambda x: np.exp(-er * abs(x[0])))
    return out

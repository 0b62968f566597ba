"""Nonlocal kernels: the constant-order fractional kernel, with infinite or
finite horizon, and the integrable indicator ('constant') and peridynamic
('inverseDistance') kernels of a finite horizon.

Port of the symmetric constant-coefficient part of
pynucleus_tpu/nl/kernels.py: the interaction domains fullSpace, ball2 and
ballInf (:717-798), constantFractionalLaplacianScaling (:901),
constantIntegrableScaling (:917) for the indicator and peridynamic kernels,
Kernel and FractionalKernel (:1031, :1249), getFractionalKernel (:1681) and
getIntegrableKernel (:1728).  Every kernel here is gamma(r2) = C * r2^e on
the device (Kernel._radialJax, :1089-1101), times the interaction indicator
for a finite horizon; the device kernels take (C, e) from
:meth:`Kernel.radialParams`, gamma = 0 at r2 = 0 exactly as ``_radial_eval``
(nl/assembly.py) does, and the indicator as (code, horizon^2) from
:meth:`Kernel.indicatorParams`.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.special import gamma as Gamma

__all__ = ['constFractionalOrder', 'Kernel', 'FractionalKernel',
           'getFractionalKernel', 'getIntegrableKernel',
           'constantFractionalLaplacianScaling', 'constantIntegrableScaling',
           'fullSpace', 'ball2', 'ballInf', 'interactionFactory',
           'radialEval', 'FRACTIONAL', 'INDICATOR', 'PERIDYNAMIC']

FRACTIONAL = 'fractional'
INDICATOR = 'indicator'
PERIDYNAMIC = 'peridynamic'


class constFractionalOrder:
    symmetric = True

    def __init__(self, s):
        self.value = float(s)
        self.smin = self.smax = self.value

    @property
    def min(self):
        return self.smin

    @property
    def max(self):
        return self.smax

    def __repr__(self):
        return f'const({self.value})'


# ------------------------------------------------------------- interactions

class interactionDomain:
    """chi_{N(x)}(y) for the norm ball |x - y| < horizon of one norm.

    innerRadius2/outerRadius2 give Euclidean radii with ball2(inner) <=
    interaction <= ball2(outer) for the horizon screen.  ``code`` names the
    ball for the kernels and their plain versions, which evaluate its
    indicator (jaxIndicator) and its norm of ray directions (jaxDirNorm)
    from it: 0 the full space, 1 ball2 (|x-y|_2), 2 ballInf (|x-y|_inf)."""
    complement = False
    symmetric = True
    code = 0

    def innerRadius2(self, hv, dim):
        return hv

    def outerRadius2(self, hv, dim):
        return hv


class fullSpace(interactionDomain):
    def __repr__(self):
        return 'fullSpace'


class ball2(interactionDomain):
    """Euclidean ball |x-y|_2 < horizon."""
    code = 1

    def __repr__(self):
        return 'ball2'


class ballInf(interactionDomain):
    """Max-norm ball |x-y|_inf < horizon."""
    code = 2

    def outerRadius2(self, hv, dim):
        return hv * np.sqrt(dim)

    def __repr__(self):
        return 'ballInf'


interactionFactory = {'fullSpace': fullSpace, 'ball2': ball2,
                      'ballInf': ballInf}


# --------------------------------------------------------------- scalings

def constantFractionalLaplacianScaling(dim, s, horizon):
    """Normalization so the operator converges to -Laplacian (includes the
    bilinear-form 1/2)."""
    if 1.0 < s < 2.0:
        s = s - 1.0
    if horizon <= 0 or s <= 0 or s >= 1:
        return np.nan
    if horizon < np.inf:
        return (2.0 - 2 * s) * horizon ** (2 * s - 2.0) * dim \
            * Gamma(0.5 * dim) / np.pi ** (0.5 * dim) * 0.5
    return 2.0 ** (2.0 * s) * s * Gamma(s + 0.5 * dim) \
        / np.pi ** (0.5 * dim) / Gamma(1.0 - s) * 0.5


def constantIntegrableScaling(kType, interaction, dim, horizon):
    """Second-moment normalizations of the indicator and peridynamic
    kernels (the gaussian and exponential ones are not ported)."""
    if horizon <= 0:
        return np.nan
    if kType == INDICATOR:
        if dim == 1:
            return 3.0 / horizon ** 3 / 2.0
        if dim == 2:
            if isinstance(interaction, ball2):
                return 8.0 / np.pi / horizon ** 4 / 2.0
            if isinstance(interaction, ballInf):
                return 3.0 / 4.0 / horizon ** 4 / 2.0
        raise NotImplementedError((kType, dim))
    if kType == PERIDYNAMIC:
        if dim == 1:
            return 2.0 / horizon ** 2 / 2.0
        if dim == 2 and isinstance(interaction, ball2):
            return 6.0 / np.pi / horizon ** 3 / 2.0
        raise NotImplementedError((kType, dim))
    raise NotImplementedError(kType)


# ----------------------------------------------------------------- kernels

class Kernel:
    """gamma(x, y) = scalingValue * |x-y|^singularityValue, times the
    interaction indicator for a finite horizon (symmetric, constant
    coefficients)."""

    isComplex = False
    variable = False
    variableOrder = False
    variableHorizon = False
    symmetric = True
    phi = None

    def __init__(self, dim, kernelType, horizon, interaction, scalingValue,
                 singularityValue, boundary=False):
        self.dim = dim
        self.kernelType = kernelType
        self.horizonValue = float(horizon)
        self.interaction = interaction if interaction is not None \
            else fullSpace()
        self.scalingValue = float(scalingValue)
        self.singularityValue = float(singularityValue)
        self.min_singularity = self.max_singularity = self.singularityValue
        self.boundary = boundary
        self.complement = self.interaction.complement

    @property
    def finiteHorizon(self):
        return self.horizonValue != np.inf and not self.complement

    def getSingularityValue(self):
        return self.singularityValue

    def radialParams(self):
        """(C, e) of gamma(r2) = C * r2**e, the device kernels' parameters
        (indicator: e = 0; peridynamic: e = -1/2)."""
        return self.scalingValue, 0.5 * self.singularityValue

    def indicatorParams(self):
        """(code, horizon^2) of the interaction indicator that the panel
        quadrature (K1) applies per node, or None for an infinite horizon."""
        if not self.finiteHorizon:
            return None
        return self.interaction.code, self.horizonValue ** 2

    def getModifiedKernel(self, horizon=None):
        """The kernel with the given horizon: the zero-exterior term asks
        an infinite-horizon kernel for its own; another horizon is not
        ported."""
        if horizon is not None and float(horizon) != self.horizonValue:
            raise NotImplementedError('changing the horizon of a kernel')
        return self

    def __repr__(self):
        return (f'kernel({self.kernelType}, d={self.dim}, '
                f'horizon={self.horizonValue}, C={self.scalingValue:.6g}, '
                f'sing={self.singularityValue})')


class FractionalKernel(Kernel):
    """gamma(x,y) = scaling * |x-y|^{singularity}, singularity = -d-2s
    (boundary kernel: 1-d-2s), constant order."""

    def __init__(self, dim, s, horizon=np.inf, interaction=None, scaling=None,
                 normalized=True, boundary=False):
        if not isinstance(s, constFractionalOrder):
            s = constFractionalOrder(s)
        self.s = s
        if scaling is None:
            scaling = constantFractionalLaplacianScaling(
                dim, s.value, float(horizon)) if normalized else 0.5
        super().__init__(dim, FRACTIONAL, horizon, interaction, scaling,
                         (1 if boundary else 0) - dim - 2 * s.value,
                         boundary=boundary)
        self.min_singularity = (1 if boundary else 0) - dim - 2 * s.max
        self.max_singularity = (1 if boundary else 0) - dim - 2 * s.min

    def getBoundaryKernel(self):
        """Kernel of the Gauss-theorem surface term: scaling / s and
        singularity 1-d-2s."""
        return FractionalKernel(self.dim, self.s, horizon=self.horizonValue,
                                scaling=self.scalingValue / self.s.value,
                                boundary=True)


def getFractionalKernel(dim, s, horizon=np.inf, interaction=None,
                        scaling=None, normalized=True):
    hv = float(horizon)
    if interaction is None:
        interaction = fullSpace() if hv == np.inf else ball2()
    return FractionalKernel(dim, s, hv, interaction, scaling,
                            normalized=normalized)


def getIntegrableKernel(dim, kernel, horizon, interaction=None, scaling=None,
                        normalized=True):
    """The indicator (gamma = C) or peridynamic (gamma = C / |x-y|) kernel of
    a finite horizon."""
    hv = float(horizon)
    if interaction is None:
        interaction = fullSpace() if hv == np.inf else ball2()
    if scaling is None:
        scaling = constantIntegrableScaling(kernel, interaction, dim, hv) \
            if normalized else 0.5
    sing = {INDICATOR: 0.0, PERIDYNAMIC: -1.0}[kernel]
    return Kernel(dim, kernel, hv, interaction, scaling, sing)


def radialEval(r2, C, e):
    """gamma(r2) = C * r2**e, and exactly 0 where r2 == 0 (coincident
    quadrature points of the singular rules)."""
    pos = r2 > 0
    return torch.where(pos, C * torch.where(pos, r2, 1.0) ** e, 0.0)

"""Nonlocal kernels: the constant-order fractional kernel, with infinite or
finite horizon, the integrable indicator ('constant') and peridynamic
('inverseDistance') kernels of a finite horizon, and the gaussian and
exponential kernels of an infinite horizon.

Port of the symmetric constant-coefficient part of
pynucleus_tpu/nl/kernels.py: the interaction domains fullSpace, ball2 and
ballInf (:717-798), constantFractionalLaplacianScaling (:901),
constantIntegrableScaling (:917) for the indicator, peridynamic, gaussian
and exponential kernels, Kernel and FractionalKernel (:1031, :1249) with
the gaussian and exponential boundary kernels (:1182-1199),
getFractionalKernel (:1681) and getIntegrableKernel (:1728).

Every kernel here is a radial profile gamma(r2) (Kernel._radialJax,
:1089-1121), times the interaction indicator for a finite horizon.  The
device kernels take the profile as :class:`Profile` (code, C, e, a) from
:meth:`Kernel.profileParams` and evaluate it as :func:`radialEval` does,
gamma = 0 at r2 = 0 exactly as ``_radial_eval`` (nl/assembly.py) does; the
indicator comes as (code, horizon^2) from :meth:`Kernel.indicatorParams`.
The profiles (r = sqrt(r2)):

  POWER              C r2^e      (fractional, indicator e = 0, peridynamic
                                  e = -1/2)
  GAUSSIAN           C exp(-a r2)
  EXPONENTIAL        C exp(-a r)
  GAUSSIAN_BOUNDARY  1D: C 1/2 sqrt(pi/a) erfc(sqrt(a) r)
                     2D: C exp(-a r2) / (2 a r)
  EXPONENTIAL_BOUNDARY  1D: C/a exp(-a r);  2D: C exp(-a r) (r/a + 1/a^2) / r

The tempered fractional, log-inverse-distance, monomial and polynomial
profiles (:1095-1096, :1122-1128) are not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.special import gamma as Gamma

__all__ = ['constFractionalOrder', 'Kernel', 'FractionalKernel',
           'getFractionalKernel', 'getIntegrableKernel',
           'constantFractionalLaplacianScaling', 'constantIntegrableScaling',
           'fullSpace', 'ball2', 'ballInf', 'interactionFactory',
           'radialEval', 'Profile', 'FRACTIONAL', 'INDICATOR',
           'PERIDYNAMIC', 'GAUSSIAN', 'EXPONENTIAL', 'POWER']

FRACTIONAL = 'fractional'
INDICATOR = 'indicator'
PERIDYNAMIC = 'peridynamic'
GAUSSIAN = 'gaussian'
EXPONENTIAL = 'exponential'

# radial profile codes, shared with kernels/csrc/common.cuh radial()
POWER = 0
GAUSSIAN_PROFILE = 1
EXPONENTIAL_PROFILE = 2
GAUSSIAN_BOUNDARY_1D = 3
GAUSSIAN_BOUNDARY_2D = 4
EXPONENTIAL_BOUNDARY_1D = 5
EXPONENTIAL_BOUNDARY_2D = 6
PROFILE_CODES = range(7)


class Profile(NamedTuple):
    """A kernel's radial profile as the device kernels take it: its code
    and the parameters C (scaling), e (the power's exponent of r2) and a
    (the gaussian's or exponential's rate)."""
    code: int
    C: float
    e: float
    a: float


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


def constantIntegrableScaling(kType, interaction, dim, horizon,
                              gaussian_variance=1.0, exponentialRate=1.0):
    """Second-moment normalizations of the integrable kernels (includes
    the bilinear-form 1/2)."""
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
    if kType in (GAUSSIAN, EXPONENTIAL) and horizon < np.inf:
        raise NotImplementedError(
            f'the {kType} kernel of a finite horizon is not ported')
    if kType == GAUSSIAN:
        if dim == 1:
            return 1.0 / np.sqrt(2.0 * np.pi * gaussian_variance) / 2.0
        if dim == 2 and isinstance(interaction, fullSpace):
            return 1.0 / (2.0 * np.pi * gaussian_variance) / 2.0
        raise NotImplementedError((kType, dim))
    if kType == EXPONENTIAL:
        if dim == 1:
            return exponentialRate ** 3 / 2.0 / 2.0
        raise NotImplementedError((kType, dim))
    raise NotImplementedError(kType)


# ----------------------------------------------------------------- kernels

class Kernel:
    """gamma(x, y) = the radial profile of kernelType (scalingValue *
    |x-y|^singularityValue for the fractional, indicator and peridynamic
    kernels; C exp(-a r^2) and C exp(-a r) for the gaussian and the
    exponential, a = exponentParam), times the interaction indicator for a
    finite horizon (symmetric, constant coefficients)."""

    isComplex = False
    variable = False
    variableOrder = False
    variableHorizon = False
    symmetric = True
    phi = None

    def __init__(self, dim, kernelType, horizon, interaction, scalingValue,
                 singularityValue, boundary=False, exponentParam=0.0,
                 variance=1.0):
        self.dim = dim
        self.kernelType = kernelType
        self.horizonValue = float(horizon)
        self.interaction = interaction if interaction is not None \
            else fullSpace()
        self.scalingValue = float(scalingValue)
        self.singularityValue = float(singularityValue)
        self.min_singularity = self.max_singularity = self.singularityValue
        self.boundary = boundary
        self.exponentParam = float(exponentParam)
        self.variance = float(variance)
        self.complement = self.interaction.complement

    @property
    def finiteHorizon(self):
        return self.horizonValue != np.inf and not self.complement

    def getSingularityValue(self):
        return self.singularityValue

    def profileParams(self):
        """The radial profile (code, C, e, a) that the device kernels and
        their plain versions evaluate (:func:`radialEval`)."""
        t, C, a = self.kernelType, self.scalingValue, self.exponentParam
        if t in (FRACTIONAL, INDICATOR, PERIDYNAMIC):
            return Profile(POWER, C, 0.5 * self.singularityValue, 0.0)
        code = {GAUSSIAN: GAUSSIAN_PROFILE,
                EXPONENTIAL: EXPONENTIAL_PROFILE,
                GAUSSIAN + 'Boundary': (GAUSSIAN_BOUNDARY_1D, GAUSSIAN_BOUNDARY_2D),
                EXPONENTIAL + 'Boundary': (EXPONENTIAL_BOUNDARY_1D,
                                           EXPONENTIAL_BOUNDARY_2D)}.get(t)
        if code is None:
            raise NotImplementedError(f'the radial profile of {t}')
        if isinstance(code, tuple):
            code = code[0] if self.dim == 1 else code[1]
        return Profile(code, C, 0.0, a)

    def getBoundaryKernel(self):
        """Kernel of the Gauss-theorem elimination of the exterior: for the
        gaussian and exponential kernels Gamma_b(r) = r^(1-d) int_r^inf
        gamma(t) t^(d-1) dt in closed form, with factor 2 on the scaling
        (the stored one holds the bilinear form's 1/2, the exterior mass
        needs the full kernel)."""
        if self.kernelType in (GAUSSIAN, EXPONENTIAL):
            return Kernel(self.dim, self.kernelType + 'Boundary',
                          self.horizonValue, self.interaction,
                          2.0 * self.scalingValue, 0.0, boundary=True,
                          exponentParam=self.exponentParam,
                          variance=self.variance)
        raise NotImplementedError(
            'boundary kernel not defined for ' + str(self.kernelType))

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
                        normalized=True, gaussian_variance=1.0,
                        exponentialRate=1.0):
    """The indicator (gamma = C) or peridynamic (gamma = C / |x-y|) kernel of
    a finite horizon, or the gaussian (C exp(-a |x-y|^2), a = 1 / (2
    variance^dim)) or exponential (C exp(-rate |x-y|)) kernel of an infinite
    one."""
    hv = float(horizon)
    if kernel in (GAUSSIAN, EXPONENTIAL) and hv < np.inf:
        raise NotImplementedError(f'{kernel} kernel with a finite horizon')
    if interaction is None:
        interaction = fullSpace() if hv == np.inf else ball2()
    if scaling is None:
        scaling = constantIntegrableScaling(
            kernel, interaction, dim, hv, gaussian_variance=gaussian_variance,
            exponentialRate=exponentialRate) if normalized else 0.5
    sing = {INDICATOR: 0.0, PERIDYNAMIC: -1.0, GAUSSIAN: 0.0,
            EXPONENTIAL: 0.0}[kernel]
    exponentParam = 0.0
    if kernel == GAUSSIAN:
        exponentParam = 0.5 / gaussian_variance ** dim
    elif kernel == EXPONENTIAL:
        exponentParam = exponentialRate
    return Kernel(dim, kernel, hv, interaction, scaling, sing,
                  exponentParam=exponentParam, variance=gaussian_variance)


def profileArgs(prof):
    """(code, C, e, a) of a :class:`Profile` as the C entry points take
    them; anything else (such as a bare (C, e)) raises."""
    if not isinstance(prof, Profile) or int(prof.code) not in PROFILE_CODES:
        raise ValueError(f'a radial Profile (code, C, e, a) is expected, got '
                         f'{prof!r}')
    return int(prof.code), float(prof.C), float(prof.e), float(prof.a)


def radialEval(r2, prof):
    """gamma(r2) of the radial profile ``prof`` (:class:`Profile`), and
    exactly 0 where r2 == 0 (coincident quadrature points of the singular
    rules), as pynucleus_tpu/nl/assembly.py _radial_eval evaluates
    Kernel._radialJax: the same operations in the same order."""
    code, C, e, a = profileArgs(prof)
    pos = r2 > 0
    r2s = torch.where(pos, r2, 1.0)
    if code == POWER:
        val = C * r2s ** e
    elif code == GAUSSIAN_PROFILE:
        val = C * torch.exp(-a * r2s)
    elif code == EXPONENTIAL_PROFILE:
        val = C * torch.exp(-a * torch.sqrt(r2s))
    elif code == GAUSSIAN_BOUNDARY_1D:
        val = C * 0.5 * np.sqrt(np.pi / a) \
            * torch.special.erfc(np.sqrt(a) * torch.sqrt(r2s))
    elif code == GAUSSIAN_BOUNDARY_2D:
        val = C * torch.exp(-a * r2s) / (2.0 * a * torch.sqrt(r2s))
    elif code == EXPONENTIAL_BOUNDARY_1D:
        val = C / a * torch.exp(-a * torch.sqrt(r2s))
    else:
        r = torch.sqrt(r2s)
        val = C * torch.exp(-a * r) * (r / a + 1.0 / a ** 2) / r
    return torch.where(pos, val, 0.0)

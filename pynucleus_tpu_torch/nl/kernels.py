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
  POWER_LOG          r2^e (C + C1 ln r2 + C2 ln^2 r2)   (the s-derivatives
                                  of a constant order, below)

The fractional orders (:115-204): const, and varconst, constantNonSym and
leftRight (twoDomain, twoDomainNonSym), registered by name as
:data:`fractionalOrderFactory` does there.  A variable order (constantNonSym,
leftRight: ``kernel.variable``) is evaluated per quadrature node,
s(x, y) and the normalization C(d, s) of an infinite horizon
(FractionalKernel.evalXY, :1290-1330), by :func:`evalXY` and, on the card,
common.cuh kernelXY() from the order's :class:`OrderParams`; constantNonSym
and leftRight are nonsymmetric.  A variable order with a finite horizon
raises NotImplementedError.

The s-derivatives of the fractional kernel (:1437-1675, getFractionalKernel
with ``derivative``), of an infinite horizon:

  DerivativeFractionalKernel  d^k/ds^k (k = 1, 2) of C(s) r2^(-d/2-s) (the
        boundary kernel: of C(s)/s r2^((1-d)/2-s)) for a constant order: the
        POWER_LOG profile, its coefficients formed on the host from C(s),
        C'(s) and C''(s) (closed form, scipy's digamma and trigamma)
  VectorFractionalKernel  of a leftRight order with 2 or 4 parameters:
        component q of derivative 1 is d gamma/ds * ds/dp_q, of derivative 2
        d^2 gamma/ds^2 * ds/dp_i ds/dp_j (valueSize P or P^2), with the
        coefficients of ln|x-y| and ln^2|x-y| of the singular rules' log
        correction (evalLogCoeffs); the device kernels take it as
        :class:`VectorParams`, per side of the order a row of coefficients
        and the side's parameter gradient, and evaluate it as
        :func:`vectorTerms` does (pow and log only)

The complex Greens-function kernels (ComplexKernel, :1761-1834, with the
Bessel functions _bessel_j0y0, :56): greens2D, C i H0^(1)(lam r) =
C (-Y0(lam r) + i J0(lam r)) with lam = -Im(greensLambda), the GREENS_2D
profile (complex128 values; J0 and Y0 from the A&S 9.4.1-9.4.3 rational
approximations of :func:`besselJ0Y0`, as the JAX program, not scipy's);
greens3D, C exp(-greensLambda r) / r, the GREENS_3D profile, evaluated
by :func:`radialEval` only (3D assembly raises in both packages).

A finite horizon, tempered kernels and two-point weights (phi) raise
NotImplementedError.  The tempered fractional, log-inverse-distance,
monomial and polynomial profiles (:1095-1096, :1122-1128) are not ported.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.special import gamma as Gamma, gammaln, digamma, polygamma

__all__ = ['constFractionalOrder', 'variableConstFractionalOrder',
           'constantNonSymFractionalOrder', 'leftRightFractionalOrder',
           'fractionalOrderFactory', 'OrderParams', 'evalXY', 'orderEval',
           'Kernel', 'FractionalKernel',
           'getFractionalKernel', 'getIntegrableKernel',
           'constantFractionalLaplacianScaling', 'constantIntegrableScaling',
           'fullSpace', 'ball2', 'ballInf', 'interactionFactory',
           'radialEval', 'Profile', 'FRACTIONAL', 'INDICATOR',
           'PERIDYNAMIC', 'GAUSSIAN', 'EXPONENTIAL', 'POWER', 'POWER_LOG',
           'DerivativeFractionalKernel', 'VectorFractionalKernel',
           'VectorParams', 'vectorTerms', 'vectorEval', 'vectorLogCoeffs',
           'ComplexKernel', 'getComplexKernel', 'getKernel', 'besselJ0Y0',
           'GREENS_2D', 'GREENS_3D', 'GREENS_2D_PROFILE',
           'GREENS_3D_PROFILE', 'COMPLEX_PROFILES']

FRACTIONAL = 'fractional'
INDICATOR = 'indicator'
PERIDYNAMIC = 'peridynamic'
GAUSSIAN = 'gaussian'
EXPONENTIAL = 'exponential'
GREENS_2D = 'greens2D'
GREENS_3D = 'greens3D'

# radial profile codes, shared with kernels/csrc/common.cuh radial()
POWER = 0
GAUSSIAN_PROFILE = 1
EXPONENTIAL_PROFILE = 2
GAUSSIAN_BOUNDARY_1D = 3
GAUSSIAN_BOUNDARY_2D = 4
EXPONENTIAL_BOUNDARY_1D = 5
EXPONENTIAL_BOUNDARY_2D = 6
POWER_LOG = 7
# the complex profiles (complex128 values): greens2D C (-Y0 + i J0)(a r)
# and, for the host and the plain versions only, greens3D C exp(-lam r)/r
# with lam = a + i e
GREENS_2D_PROFILE = 8
GREENS_3D_PROFILE = 9
PROFILE_CODES = range(10)
COMPLEX_PROFILES = (GREENS_2D_PROFILE, GREENS_3D_PROFILE)


class Profile(NamedTuple):
    """A kernel's radial profile as the device kernels take it: its code
    and the parameters C (scaling), e (the power's exponent of r2), a (the
    gaussian's or exponential's rate; greens2D's wavenumber lam; greens3D's
    Re lam, with e its Im lam) and C1, C2 (the POWER_LOG profile's
    coefficients of ln r2 and ln^2 r2)."""
    code: int
    C: float
    e: float
    a: float
    C1: float = 0.0
    C2: float = 0.0


# fractional order codes, shared with kernels/csrc/common.cuh kernelXY()
ORDER_NONE = 0          # the kernel is its radial profile
ORDER_CONST = 1         # s(x, y) = sll, normalized per node
ORDER_LEFT_RIGHT = 2    # sll / srr / slr / srl by the sides of x and y
ORDER_CODES = range(3)


class OrderParams(NamedTuple):
    """A variable fractional order as the device kernels take it: its code
    and values (sll, srr, slr, srl, interface; a constant order has all four
    values equal), the dimension d of the normalization C(d, s) and whether
    the kernel is the boundary kernel C(s)/s r^(1-d-2s)."""
    code: int
    sll: float
    srr: float
    slr: float
    srl: float
    interface: float
    dim: int
    boundary: bool


class fractionalOrderBase:
    """s(x, y) (pynucleus_tpu/nl/kernels.py fractionalOrderBase): host
    evaluation ``__call__`` on [..., dim] arrays, its bounds ``min`` and
    ``max``, its number of parameters, and ``orderParams`` for the device
    kernels."""
    symmetric = True
    numParameters = 1

    @property
    def min(self):
        return self.smin

    @property
    def max(self):
        return self.smax


class constFractionalOrder(fractionalOrderBase):
    def __init__(self, s):
        self.value = float(s)
        self.smin = self.smax = self.value

    def __call__(self, X, Y):
        return np.full(np.asarray(X).shape[:-1], self.value)

    def _key(self):
        return (type(self).__name__, self.value)

    def orderParams(self, dim, boundary):
        return OrderParams(ORDER_CONST, self.value, self.value, self.value,
                           self.value, 0.0, dim, boundary)

    def __repr__(self):
        return f'const({self.value})'


class variableConstFractionalOrder(constFractionalOrder):
    """Constant value treated as variable (pynucleus_tpu/nl/kernels.py
    variableConstFractionalOrder): the kernel stays a radial profile
    (FractionalKernel.variable is False), only ``variableOrder`` is set."""

    def __repr__(self):
        return f'varconst({self.value})'


class constantNonSymFractionalOrder(constFractionalOrder):
    """Constant value on the nonsymmetric path (pynucleus_tpu/nl/kernels.py
    constantNonSymFractionalOrder): s(x, y) and its normalization are
    evaluated per quadrature node."""
    symmetric = False

    def __repr__(self):
        return f'constantNonSym({self.value})'


class leftRightFractionalOrder(fractionalOrderBase):
    """s = sll if x, y < interface, srr if both are not, slr / srl across
    (pynucleus_tpu/nl/kernels.py leftRightFractionalOrder).  The side of a
    point is the strict comparison x[0] < interface, as there."""
    symmetric = False

    def __init__(self, sll, srr, slr=None, srl=None, interface=0.0):
        self.sll, self.srr = sll, srr
        # tied cross-values (slr = sll, srl = srr) leave two parameters,
        # explicit ones four
        self._tied = slr is None and srl is None
        self.numParameters = 2 if self._tied else 4
        self.slr = slr if slr is not None else sll
        self.srl = srl if srl is not None else srr
        self.interface = interface
        self.smin = min(sll, srr, self.slr, self.srl)
        self.smax = max(sll, srr, self.slr, self.srl)

    def __call__(self, X, Y):
        X = np.atleast_2d(X)
        Y = np.atleast_2d(Y)
        xl = X[..., 0] < self.interface
        yl = Y[..., 0] < self.interface
        return np.where(xl & yl, self.sll,
                        np.where(~xl & ~yl, self.srr,
                                 np.where(xl, self.slr, self.srl)))

    def evalGrad(self, x, y):
        """ds/dp [..., numParameters] at x, y [..., dim]
        (pynucleus_tpu/nl/kernels.py evalGradJax): the indicator of the
        side pair, the cross sides folded into sll and srr when tied."""
        xl = x[..., 0] < self.interface
        yl = y[..., 0] < self.interface
        ll = (xl & yl).to(x.dtype)
        rr = (~xl & ~yl).to(x.dtype)
        lr = (xl & ~yl).to(x.dtype)
        rl = (~xl & yl).to(x.dtype)
        if self._tied:
            return torch.stack([ll + lr, rr + rl], dim=-1)
        return torch.stack([ll, rr, lr, rl], dim=-1)

    def _key(self):
        return (type(self).__name__, self.sll, self.srr, self.slr, self.srl,
                self.interface, self._tied)

    def orderParams(self, dim, boundary):
        return OrderParams(ORDER_LEFT_RIGHT, self.sll, self.srr, self.slr,
                           self.srl, self.interface, dim, boundary)

    def __repr__(self):
        if self.slr != self.sll or self.srl != self.srr:
            return (f'twoDomain({self.sll},{self.srr},'
                    f'{self.slr},{self.srl})')
        return f'twoDomain({self.sll},{self.srr})'


# name -> order (pynucleus_tpu/nl/kernels.py:564-569 fractionalOrderFactory,
# the entries ported)
fractionalOrderFactory = {
    'const': constFractionalOrder,
    'varconst': variableConstFractionalOrder,
    'constantNonSym': constantNonSymFractionalOrder,
    'twoDomain': leftRightFractionalOrder,
    'twoDomainNonSym': leftRightFractionalOrder,
    'leftRight': leftRightFractionalOrder,
}


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

    def orderParams(self):
        """The variable fractional order of the kernel (:class:`OrderParams`)
        that the device kernels evaluate per node, or None for a radial
        profile."""
        return None

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
    (boundary kernel: 1-d-2s) for a constant order s; for a variable one
    (``variable``: constantNonSym, leftRight) gamma(x, y) = C(d, s)
    |x-y|^(-d-2s) with s = s(x, y) and C(d, s) evaluated per quadrature node
    (pynucleus_tpu/nl/kernels.py:1249-1330 FractionalKernel).  A varconst
    order sets ``variableOrder`` but stays a radial profile."""

    def __init__(self, dim, s, horizon=np.inf, interaction=None, scaling=None,
                 normalized=True, boundary=False):
        if not isinstance(s, fractionalOrderBase):
            s = constFractionalOrder(s)
        self.s = s
        self.variableOrder = type(s) is not constFractionalOrder
        sval = s.value if hasattr(s, 'value') else 0.5 * (s.min + s.max)
        if scaling is None:
            scaling = constantFractionalLaplacianScaling(
                dim, sval, float(horizon)) if normalized else 0.5
        super().__init__(dim, FRACTIONAL, horizon, interaction, scaling,
                         (1 if boundary else 0) - dim - 2 * sval,
                         boundary=boundary)
        self.symmetric = s.symmetric
        self.variable = self.variableOrder and not isinstance(
            s, variableConstFractionalOrder)
        if self.variable and self.horizonValue != np.inf:
            raise NotImplementedError('a variable order with a finite '
                                      'horizon')
        self.min_singularity = (1 if boundary else 0) - dim - 2 * s.max
        self.max_singularity = (1 if boundary else 0) - dim - 2 * s.min

    @property
    def sValue(self):
        return self.s.value

    def orderParams(self):
        """The variable order's :class:`OrderParams`, or None."""
        if not self.variable:
            return None
        return self.s.orderParams(self.dim, self.boundary)

    def getBoundaryKernel(self):
        """Kernel of the Gauss-theorem surface term: scaling / s and
        singularity 1-d-2s (a variable order evaluates C(s)/s per node)."""
        scal = self.scalingValue / self.s.value \
            if hasattr(self.s, 'value') else 1.0
        return FractionalKernel(self.dim, self.s, horizon=self.horizonValue,
                                scaling=scal, boundary=True)


# -------------------------------------------------------- s-derivatives

def _prefactorDerivatives(dim, s, normalized, boundary):
    """(P, P', P'') at s of the prefactor P = C(s) of an infinite horizon,
    or C(s)/s for the boundary kernel (pynucleus_tpu/nl/kernels.py
    VectorFractionalKernel._prefactor, :1561-1576; an unnormalized kernel
    has C = 1/2), on the host in float64.  C is the JAX expression; the
    derivatives come from those of ln P in closed form,

        (ln C)'  = 2 ln 2 + 1/s + digamma(s + d/2) + digamma(1 - s)
        (ln C)'' = -1/s^2 + trigamma(s + d/2) - trigamma(1 - s)

    (ln(C/s) adds -1/s and +1/s^2), P' = P (ln P)', P'' = P ((ln P)'^2 +
    (ln P)'').  The JAX package differentiates the expression with jvp;
    scipy's digamma and trigamma agree with its derivatives of gammaln to
    rounding, torch's trigamma (polygamma(1, .)) is less accurate."""
    s = float(s)
    if normalized:
        C = (2.0 ** (2 * s) * s / np.pi ** (0.5 * dim) * 0.5 *
             np.exp(gammaln(s + 0.5 * dim) - gammaln(1.0 - s)))
        a1 = 2.0 * np.log(2.0) + 1.0 / s + digamma(s + 0.5 * dim) \
            + digamma(1.0 - s)
        a2 = -1.0 / s ** 2 + polygamma(1, s + 0.5 * dim) \
            - polygamma(1, 1.0 - s)
    else:
        C, a1, a2 = 0.5, 0.0, 0.0
    if boundary:
        C, a1, a2 = C / s, a1 - 1.0 / s, a2 + 1.0 / s ** 2
    return float(C), float(C * a1), float(C * (a1 * a1 + a2))


def _exponentBase(dim, boundary):
    """-d/2, or (1-d)/2 for the boundary kernel: r2's exponent is this
    minus s."""
    return 0.5 * (1.0 - dim) if boundary else -0.5 * dim


def _checkDerivative(horizon, derivative):
    if float(horizon) != np.inf:
        raise NotImplementedError('s-derivative kernels of a finite horizon '
                                  'are not ported')
    if int(derivative) not in (1, 2):
        raise NotImplementedError(f'derivative {derivative}: 1 or 2')


class DerivativeFractionalKernel(FractionalKernel):
    """d^k/ds^k (k = ``derivative``, 1 or 2) of the fractional kernel of a
    constant order s, infinite horizon (pynucleus_tpu/nl/kernels.py
    DerivativeFractionalKernel): g(s) = C(s) r2^(-d/2-s), or C(s)/s
    r2^((1-d)/2-s) for the boundary kernel, so

        g'  = r2^e (C'  - C ln r2)
        g'' = r2^e (C'' - 2 C' ln r2 + C ln^2 r2),     e = -d/2-s

    the POWER_LOG profile (:meth:`profileParams`), evaluated by
    :meth:`radial`.  valueSize 1."""

    def __init__(self, dim, s, horizon=np.inf, interaction=None,
                 normalized=True, boundary=False, derivative=1):
        _checkDerivative(horizon, derivative)
        super().__init__(dim, s, horizon, interaction, normalized=normalized,
                         boundary=boundary)
        if self.variable:
            raise NotImplementedError('derivative kernels of a variable '
                                      'order: a leftRight order gives a '
                                      'vector kernel')
        self.derivative = int(derivative)
        self.normalized = normalized
        self.valueSize = 1

    def radial(self, r2):
        """g^(k)(r2) [...] (the JAX _radialJax), 0 where r2 == 0 (as
        _radial_eval)."""
        return radialEval(r2, self.profileParams())

    def profileParams(self):
        """Profile(POWER_LOG, C0, e, 0, C1, C2): g^(k) = r2^e (C0 + C1 ln r2
        + C2 ln^2 r2) from C, C', C'' at s."""
        C, dC, d2C = _prefactorDerivatives(self.dim, self.sValue,
                                           self.normalized, self.boundary)
        e = _exponentBase(self.dim, self.boundary) - self.sValue
        if self.derivative == 1:
            return Profile(POWER_LOG, dC, e, 0.0, -C, 0.0)
        return Profile(POWER_LOG, d2C, e, 0.0, -2.0 * dC, C)

    def getBoundaryKernel(self):
        """d^k/ds^k of the boundary kernel C(s)/s r2^((1-d)/2-s), the
        s-derivative taken of it as a whole."""
        return DerivativeFractionalKernel(
            self.dim, self.s, horizon=self.horizonValue,
            normalized=self.normalized, boundary=True,
            derivative=self.derivative)


class VectorParams(NamedTuple):
    """A vector kernel of a leftRight order as the device kernels take it.
    Sides in the order ll, rr, lr, rl (x left and y left, both right, x left
    only, y left only; left is x[0] < interface): ``coefs`` [4, 6] the row
    (c0, c1, c2, b, c, e) of each side and ``grads`` [4, V] its gradient
    row (0 or 1) of the V components.  At r2 > 0 on side sigma, with rad =
    r2^e and L = ln r2, component v is

        value  rad (c0 + c1 L + c2 L^2) G[sigma, v]
        log coefficients of ln r and ln^2 r  (b rad G, c rad G)."""
    coefs: np.ndarray
    grads: np.ndarray
    interface: float

    def table(self):
        """The flat float64 table [4*6 + 4*V] of the C entry points."""
        return np.concatenate([np.ravel(self.coefs), np.ravel(self.grads)])


def vectorSide(x, y, interface):
    """The side index [...] of each node pair: 0 ll, 1 rr, 2 lr, 3 rl."""
    xl = x[..., 0] < interface
    yl = y[..., 0] < interface
    return torch.where(xl & yl, 0, torch.where(~xl & ~yl, 1,
                                               torch.where(xl, 2, 3)))


def vectorTerms(x, y, r2, vp):
    """(value, b, c, side) [...] of :class:`VectorParams` vp at nodes x, y
    [..., dim] with r2 = |x-y|^2: the scalar factors of all components
    (component v is the factor times vp.grads[side, v]), exactly 0 where
    r2 == 0.  The operations of common.cuh vecTerms, in its order."""
    side = vectorSide(x, y, vp.interface)
    cf = torch.as_tensor(vp.coefs, dtype=r2.dtype, device=r2.device)[side]
    pos = r2 > 0
    r2s = torch.where(pos, r2, 1.0)
    rad = r2s ** cf[..., 5]
    L = torch.log(r2s)
    val = rad * ((cf[..., 0] + cf[..., 1] * L) + cf[..., 2] * (L * L))
    return (torch.where(pos, val, 0.0),
            torch.where(pos, cf[..., 3] * rad, 0.0),
            torch.where(pos, cf[..., 4] * rad, 0.0), side)


def _grads(vp, side, dtype):
    return torch.as_tensor(vp.grads, dtype=dtype, device=side.device)[side]


def vectorEval(x, y, r2, vp):
    """All components [..., V] of :class:`VectorParams` vp at x, y."""
    val, _, _, side = vectorTerms(x, y, r2, vp)
    return val[..., None] * _grads(vp, side, r2.dtype)


def vectorLogCoeffs(x, y, r2, vp):
    """The log coefficients (b, c) [..., V] of vp at x, y."""
    _, b, c, side = vectorTerms(x, y, r2, vp)
    G = _grads(vp, side, r2.dtype)
    return b[..., None] * G, c[..., None] * G


class VectorFractionalKernel(FractionalKernel):
    """The vector-valued s-derivative kernel of a multi-parameter order,
    infinite horizon (pynucleus_tpu/nl/kernels.py VectorFractionalKernel):
    of the leftRight order with 2 (tied) or 4 parameters, component q of
    derivative 1 is d gamma/ds (x, y; s(x, y)) * ds/dp_q (x, y), of
    derivative 2 d^2 gamma/ds^2 * ds/dp_i ds/dp_j at q = i P + j
    (valueSize P or P^2).  :meth:`vectorParams` is the per-side table that
    :meth:`evalComponents` and :meth:`evalLogCoeffs` and the device kernels
    (K21, K22) evaluate.  Nonsymmetric and variable."""

    def __init__(self, dim, s, horizon=np.inf, interaction=None,
                 normalized=True, boundary=False, derivative=1):
        _checkDerivative(horizon, derivative)
        if not isinstance(s, leftRightFractionalOrder):
            raise NotImplementedError(f'vector kernels of the order {s!r}: '
                                      'the leftRight order only')
        super().__init__(dim, s, horizon, interaction, normalized=normalized,
                         boundary=boundary)
        self.derivative = int(derivative)
        self.normalized = normalized
        P = int(s.numParameters)
        self.valueSize = P if self.derivative == 1 else P * P
        self.symmetric = False
        self.variable = True

    def _outer(self, grad, shape):
        return (grad[..., :, None] * grad[..., None, :]).reshape(
            shape + (self.valueSize,))

    def evalComponents(self, x, y, r2):
        """All valueSize components [..., V] at x, y [..., dim] with r2 =
        |x-y|^2 (evalComponentsJax), 0 where r2 == 0."""
        return vectorEval(x, y, r2, self.vectorParams())

    def evalLogCoeffs(self, x, y, r2):
        """(b, c) [..., V]: the coefficients of ln|x-y| and ln^2|x-y| in
        the integrand (evalLogCoeffsJax): derivative 1 b = -2 gamma, c = 0;
        derivative 2 b = -4 C'(s) r^alpha, c = 4 gamma (gamma = C(s)
        r^alpha, alpha' = -2)."""
        return vectorLogCoeffs(x, y, r2, self.vectorParams())

    def vectorParams(self):
        """The :class:`VectorParams` of the kernel: per side its order
        value's C, C', C'' and exponent, and its gradient row (evalGrad at
        a point pair of the side)."""
        s = self.s
        e0 = _exponentBase(self.dim, self.boundary)
        coefs = []
        for sv in (s.sll, s.srr, s.slr, s.srl):
            C, dC, d2C = _prefactorDerivatives(self.dim, sv, self.normalized,
                                               self.boundary)
            if self.derivative == 1:
                coefs.append((dC, -C, 0.0, -2.0 * C, 0.0, e0 - sv))
            else:
                coefs.append((d2C, -2.0 * dC, C, -4.0 * dC, 4.0 * C, e0 - sv))
        iface = float(s.interface)
        left, right = iface - 1.0, iface + 1.0
        xs = torch.tensor([[left], [right], [left], [right]],
                          dtype=torch.float64)
        ys = torch.tensor([[left], [right], [right], [left]],
                          dtype=torch.float64)
        grad = s.evalGrad(xs, ys)
        if self.derivative == 2:
            grad = self._outer(grad, (4,))
        return VectorParams(np.array(coefs), grad.numpy(), iface)

    def evalXY(self, x, y, r2):
        raise TypeError('vector-valued kernel: use evalComponents (scalar '
                        'assembly paths take valueSize 1)')

    def componentKernels(self):
        """The scalar kernel of each component."""
        return [_ComponentFractionalKernel(self, q)
                for q in range(self.valueSize)]

    def getBoundaryKernel(self):
        return VectorFractionalKernel(
            self.dim, self.s, horizon=self.horizonValue,
            normalized=self.normalized, boundary=True,
            derivative=self.derivative)


class _ComponentFractionalKernel(FractionalKernel):
    """Scalar view of component q of a :class:`VectorFractionalKernel`
    (pynucleus_tpu/nl/kernels.py _ComponentFractionalKernel), with the
    parent's derivative (the quadrature-order bump).  Its assembly needs
    the log correction inside the scalar kernels (K1, K19, K7): not ported,
    the builder raises."""

    def __init__(self, parent, q):
        super().__init__(parent.dim, parent.s, horizon=parent.horizonValue,
                         normalized=parent.normalized,
                         boundary=parent.boundary)
        self.parent = parent
        self.q = int(q)
        self.symmetric = False
        self.variable = True
        self.derivative = parent.derivative

    def evalXY(self, x, y, r2):
        return self.parent.evalComponents(x, y, r2)[..., self.q]

    def evalLogCoeffs(self, x, y, r2):
        b, c = self.parent.evalLogCoeffs(x, y, r2)
        return b[..., self.q], c[..., self.q]

    def getBoundaryKernel(self):
        return _ComponentFractionalKernel(self.parent.getBoundaryKernel(),
                                          self.q)


def getFractionalKernel(dim, s, horizon=np.inf, interaction=None,
                        scaling=None, normalized=True, derivative=0, phi=None,
                        temperedLambda=0.0):
    """The fractional kernel of order s; with ``derivative`` (1 or 2) its
    s-derivative: a :class:`VectorFractionalKernel` for an order of several
    parameters, else a :class:`DerivativeFractionalKernel`."""
    if phi is not None or temperedLambda != 0.0:
        raise NotImplementedError('two-point weights (phi) and tempered '
                                  'kernels are not ported')
    if not isinstance(s, fractionalOrderBase):
        s = constFractionalOrder(s)
    hv = float(horizon)
    if interaction is None:
        interaction = fullSpace() if hv == np.inf else ball2()
    if derivative:
        cls = VectorFractionalKernel if s.numParameters > 1 else \
            DerivativeFractionalKernel
        return cls(dim, s, hv, interaction, normalized=normalized,
                   derivative=derivative)
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


class ComplexKernel(Kernel):
    """The complex Greens-function kernels (pynucleus_tpu/nl/kernels.py
    ComplexKernel, :1761-1834):

        greens2D  gamma(x, y) = C i H0^(1)(lam |x-y|), lam =
                  -Im(greensLambda); singularity 0 (log-integrable, the
                  declared value of both packages: the s = 0 singular rules)
        greens3D  gamma(x, y) = C exp(-greensLambda |x-y|) / |x-y|,
                  complex greensLambda; singularity -1

    times the interaction indicator of a finite horizon (ball2 by
    default).  The device kernels evaluate the GREENS_2D profile (complex
    K1 and K15); greens3D is a profile of the host and the plain versions
    (3D assembly raises).  It has no boundary kernel, so no zero-exterior
    term (the builder's bilinear form is the double integral alone)."""

    isComplex = True

    def __init__(self, dim, kernelType, horizon=np.inf, interaction=None,
                 scaling=1.0, greensLambda=1.0j):
        if kernelType == GREENS_2D:
            if dim != 2:
                raise ValueError('greens2D kernel needs dim=2')
            sing = 0.0
        elif kernelType == GREENS_3D:
            if dim != 3:
                raise ValueError('greens3D kernel needs dim=3')
            sing = -1.0
        else:
            raise NotImplementedError(kernelType)
        hv = float(horizon)
        if interaction is None:
            interaction = fullSpace() if hv == np.inf else ball2()
        super().__init__(dim, kernelType, hv, interaction, float(scaling),
                         sing)
        self.greensLambda = complex(greensLambda)

    def profileParams(self):
        lam, C = self.greensLambda, self.scalingValue
        if self.kernelType == GREENS_2D:
            return Profile(GREENS_2D_PROFILE, C, 0.0, -lam.imag)
        return Profile(GREENS_3D_PROFILE, C, lam.imag, lam.real)

    def __call__(self, x, y):
        """Host evaluation with scipy's exact Bessel functions (the JAX
        package's __call__): 0 beyond a finite horizon."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        y = np.atleast_2d(np.asarray(y, dtype=np.float64))
        r = float(np.sqrt(((x - y) ** 2).sum()))
        C = self.scalingValue
        if self.finiteHorizon and r > self.horizonValue:
            return 0.0j
        if self.kernelType == GREENS_2D:
            from scipy.special import hankel1
            val = C * 1j * hankel1(0.0, -self.greensLambda.imag * r)
        else:
            val = C * np.exp(-self.greensLambda * r) / r
        return complex(val)

    def getBoundaryKernel(self):
        raise NotImplementedError('boundary kernel not defined for complex '
                                  'kernels')

    def __repr__(self):
        return (f'kernel({self.kernelType}, d={self.dim}, '
                f'horizon={self.horizonValue}, C={self.scalingValue:.6g}, '
                f'lambda={self.greensLambda})')


def getComplexKernel(dim, kernel=GREENS_2D, greensLambda=1.0j,
                     horizon=np.inf, interaction=None, scaling=1.0,
                     phi=None):
    """The complex Greens kernel ``kernel`` (GREENS_2D or GREENS_3D)."""
    if phi is not None:
        raise NotImplementedError('two-point weights (phi) are not ported')
    return ComplexKernel(dim, kernel, horizon=horizon,
                         interaction=interaction, scaling=scaling,
                         greensLambda=greensLambda)


def getKernel(dim, kernel=FRACTIONAL, **kwargs):
    """The kernel of type ``kernel`` (pynucleus_tpu/nl/kernels.py
    getKernel): fractional, the Greens kernels, or an integrable one."""
    if kernel == FRACTIONAL:
        return getFractionalKernel(dim, **kwargs)
    if kernel in (GREENS_2D, GREENS_3D):
        return getComplexKernel(dim, kernel=kernel, **kwargs)
    return getIntegrableKernel(dim, kernel=kernel, **kwargs)


def profileArgs(prof):
    """(code, C, e, a, C1, C2) of a :class:`Profile` as the C entry points
    take them; anything else (such as a bare (C, e)) raises."""
    if not isinstance(prof, Profile) or int(prof.code) not in PROFILE_CODES:
        raise ValueError(f'a radial Profile (code, C, e, a, C1, C2) is '
                         f'expected, got {prof!r}')
    return (int(prof.code), float(prof.C), float(prof.e), float(prof.a),
            float(prof.C1), float(prof.C2))


def besselJ0Y0(x):
    """J0(x), Y0(x) for x > 0 (x float64): pynucleus_tpu/nl/kernels.py
    _bessel_j0y0 copied as it is, the Abramowitz & Stegun 9.4.1-9.4.3
    rational approximations (about 1e-7 from the exact functions): the
    power series in (x/3)^2 up to 3, the modulus and phase form beyond,
    the same coefficients, Horner order and 1e-30 floor.  It is the
    approximation the JAX program evaluates, not a better one (common.cuh
    besselJ0Y0 is its copy on the card)."""
    xs = torch.where(x > 1e-30, x, 1e-30)
    q = xs / 3.0
    t = q * q
    j0s = (1.0 + t * (-2.2499997 + t * (1.2656208 + t * (-0.3163866
           + t * (0.0444479 + t * (-0.0039444 + t * 0.0002100))))))
    y0s = (2.0 / np.pi) * torch.log(0.5 * xs) * j0s \
        + (0.36746691 + t * (0.60559366 + t * (-0.74350384 + t * (0.25300117
           + t * (-0.04261214 + t * (0.00427916 - t * 0.00024846))))))
    u = 3.0 / torch.clamp(xs, min=3.0)
    f = (0.79788456 + u * (-0.00000077 + u * (-0.00552740 + u * (-0.00009512
         + u * (0.00137237 + u * (-0.00072805 + u * 0.00014476))))))
    th = xs - 0.78539816 + u * (-0.04166397 + u * (-0.00003954
         + u * (0.00262573 + u * (-0.00054125 + u * (-0.00029333
         + u * 0.00013558)))))
    rsqrt = 1.0 / torch.sqrt(xs)
    j0l = f * torch.cos(th) * rsqrt
    y0l = f * torch.sin(th) * rsqrt
    small = xs <= 3.0
    return torch.where(small, j0s, j0l), torch.where(small, y0s, y0l)


def radialEval(r2, prof):
    """gamma(r2) of the radial profile ``prof`` (:class:`Profile`), and
    exactly 0 where r2 == 0 (coincident quadrature points of the singular
    rules), as pynucleus_tpu/nl/assembly.py _radial_eval evaluates
    Kernel._radialJax: the same operations in the same order.  The complex
    profiles give complex128 values (ComplexKernel._radialJax):

        GREENS_2D  C (-Y0(a r) + i J0(a r))          (besselJ0Y0)
        GREENS_3D  C exp(-a r) (cos(e r) - i sin(e r)) / r"""
    code, C, e, a, C1, C2 = profileArgs(prof)
    pos = r2 > 0
    r2s = torch.where(pos, r2, 1.0)
    if code in COMPLEX_PROFILES:
        r = torch.sqrt(r2s)
        if code == GREENS_2D_PROFILE:
            j0, y0 = besselJ0Y0(a * r)
            val = torch.complex(C * -y0, C * j0)
        else:
            mag = C * torch.exp(-a * r)
            val = torch.complex(mag * torch.cos(e * r) / r,
                                -(mag * torch.sin(e * r)) / r)
        return torch.where(pos, val, torch.zeros((), dtype=val.dtype))
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
    elif code == POWER_LOG:
        L = torch.log(r2s)
        val = r2s ** e * ((C + C1 * L) + C2 * (L * L))
    else:
        r = torch.sqrt(r2s)
        val = C * torch.exp(-a * r) * (r / a + 1.0 / a ** 2) / r
    return torch.where(pos, val, 0.0)


def orderArgs(order):
    """(code, sll, srr, slr, srl, interface, piD2, halfDim, eBase, boundary)
    of an :class:`OrderParams` (or None) as the C entry points take them:
    pi^(d/2), d/2 and the exponent base (-d/2, or (1-d)/2 for the boundary
    kernel) are formed here on the host, as the JAX expression forms them
    from Python floats."""
    if order is None:
        return (ORDER_NONE, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0)
    if not isinstance(order, OrderParams) or int(order.code) not in \
            ORDER_CODES:
        raise ValueError(f'an OrderParams is expected, got {order!r}')
    d = order.dim
    eBase = 0.5 * (1.0 - d) if order.boundary else -0.5 * d
    return (int(order.code), float(order.sll), float(order.srr),
            float(order.slr), float(order.srl), float(order.interface),
            float(np.pi ** (0.5 * d)), float(0.5 * d), float(eBase),
            int(bool(order.boundary)))


def orderEval(x, y, order):
    """s(x, y) [...] of an :class:`OrderParams` at x, y [..., dim]."""
    if order.code == ORDER_CONST:
        return torch.full(torch.broadcast_shapes(x.shape[:-1], y.shape[:-1]),
                          float(order.sll), dtype=x.dtype, device=x.device)
    xl = x[..., 0] < order.interface
    yl = y[..., 0] < order.interface

    def v(a):
        return torch.tensor(float(a), dtype=x.dtype, device=x.device)
    return torch.where(xl & yl, v(order.sll),
                       torch.where(~xl & ~yl, v(order.srr),
                                   torch.where(xl, v(order.slr),
                                               v(order.srl))))


def evalXY(x, y, r2, prof, order=None):
    """gamma(x, y) from positions x, y [..., dim] and r2 = |x-y|^2, exactly 0
    where r2 == 0: the radial profile ``prof`` (:func:`radialEval`) if
    ``order`` is None, else the variable-order fractional kernel of
    pynucleus_tpu/nl/kernels.py FractionalKernel.evalXY (infinite horizon),
    the same operations in the same order:

        C = 2^(2s) s / pi^(d/2) * 0.5 * exp(lgamma(s + d/2) - lgamma(1 - s))
        gamma = C r2^(-d/2 - s), or (C/s) r2^((1-d)/2 - s) (boundary)

    with s = s(x, y) (:func:`orderEval`) and torch.lgamma for gammaln."""
    if order is None:
        return radialEval(r2, prof)
    _, _, _, _, _, _, piD2, halfDim, eBase, boundary = orderArgs(order)
    pos = r2 > 0
    r2s = torch.where(pos, r2, 1.0)
    sv = orderEval(x, y, order)
    C = (2.0 ** (2 * sv) * sv / piD2 * 0.5 *
         torch.exp(torch.lgamma(sv + halfDim) - torch.lgamma(1.0 - sv)))
    if boundary:
        val = (C / sv) * r2s ** (eBase - sv)
    else:
        val = C * r2s ** (eBase - sv)
    return torch.where(pos, val, 0.0)

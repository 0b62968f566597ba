"""Nonlocal kernels: the constant-order fractional kernel, with infinite or
finite horizon and an optional tempering exp(-lambda |x-y|), the integrable
indicator ('constant'), peridynamic ('inverseDistance'), gaussian and
exponential kernels (of a finite or an infinite horizon), the
log-inverse-distance, monomial and polynomial profiles, and the two-point
weights phi(x, y) that multiply a kernel.

Port of the symmetric constant-coefficient part of
pynucleus_tpu/nl/kernels.py: the two-point functions (:585-712, :971-1028:
constant, tempered, leftRight, lambda, lookup, interface and
twoPointFunctionFactory), the interaction domains fullSpace, ball2,
ballInf, ball1, the ellipse and ball2Complement (:717-895, with
interactionFactory's aliases), constantFractionalLaplacianScaling (:901,
with its tempered branch), constantIntegrableScaling (:917), Kernel and
FractionalKernel (:1031, :1249) with the gaussian and exponential boundary
kernels (:1182-1199), getFractionalKernel (:1681, an admissibleSet order to
the ranged kernel of nl/operator_interpolation.py), getIntegrableKernel
(:1728) and kernelFactory (:1853-1856: 'fractional', 'greens2D', 'greens3D').

Every kernel here is a radial profile gamma(r2) (Kernel._radialJax,
:1089-1128), times the interaction indicator for a finite horizon.  The
device kernels take the profile as :class:`Profile` (code, C, e, a, C1, C2,
t, wcode, wlam) from :meth:`Kernel.profileParams` and evaluate it as
:func:`radialEval` does,
gamma = 0 at r2 = 0 exactly as ``_radial_eval`` (nl/assembly.py) does; the
indicator comes as an :class:`Indicator` (code, horizon^2, T) from
:meth:`Kernel.indicatorParams`, evaluated as :func:`indicatorMask` does,
and K15 clips its rays in the ball's norm of a direction
(:func:`dirNorm`).  A complement kernel (:meth:`Kernel.getComplementKernel`,
the interaction ball2Complement) has no finite horizon but the indicator
|x-y|^2 >= horizon^2 (code 5) in the same place: the cross operator of
the horizon-corrected format (nl/assembly.py horizonCorrected).
The profiles (r = sqrt(r2)):

  POWER              C r2^e      (fractional, indicator e = 0, peridynamic
                                  e = -1/2, monomial e = p/2)
  GAUSSIAN           C exp(-a r2)
  EXPONENTIAL        C exp(-a r)
  GAUSSIAN_BOUNDARY  1D: C 1/2 sqrt(pi/a) erfc(sqrt(a) r)
                     2D: C exp(-a r2) / (2 a r)
  EXPONENTIAL_BOUNDARY  1D: C/a exp(-a r);  2D: C exp(-a r) (r/a + 1/a^2) / r
  POWER_LOG          r2^e (C + C1 ln r2 + C2 ln^2 r2)   (the s-derivatives
                                  of a constant order, below)
  LOG_INVERSE_DISTANCE  C ln(1 / r)
  POLYNOMIAL         C (1 - r2 / a^2)^2

The power and power-log values of a tempered kernel (``temperedLambda``,
the profile's t) are multiplied by exp(-t r) (:1095-1096, :1480-1481).  A
two-point weight phi(x, y) (``phi=`` of the kernel factories) is either
smooth, the tempered exp(-lambda |x-y|), which multiplies the kernel at
every quadrature node on the device (the profile's wcode and wlam, after
the value: pynucleus_tpu/nl/assembly.py:54-64; the kernel's
``phiDevice``), or piecewise constant (constant, leftRight, lambda,
lookup, interface: the kernel's ``phi``), which the builder evaluates on
the host at the cell centres of each cell pair and folds into the pair's
volume factor, dropping the pairs of weight 0.  The boundary kernel of the
zero-exterior term keeps the tempering and drops phi, as in the JAX
package.

The fractional orders (:115-475): const, and varconst, constantNonSym,
leftRight (twoDomain, twoDomainNonSym) and the orders of position
innerOuter, islands, layers, smoothedLeftRight (smoothedTwoDomain),
linearLeftRightNonSym, innerOuterNonSym (smoothedInnerOuter) and fe (an
FE vector's raster), registered by name as :data:`fractionalOrderFactory`
does there.  A variable order (every one but const and varconst:
``kernel.variable``) is evaluated per quadrature node, s(x, y) and the
normalization C(d, s) of an infinite horizon (FractionalKernel.evalXY,
:1290-1330), by :func:`evalXY` (:func:`orderEval`, each order's jaxEval)
and, on the card, common.cuh kernelXY() from the order's
:class:`OrderParams`; innerOuter, islands and layers are symmetric where
their cross values are, the others nonsymmetric.  The manifold kernel
(MANIFOLD_FRACTIONAL, ``manifold=True``, :1252-1284) is the fractional
kernel of a constant order on a closed 1-manifold in R^2: the power
profile with the effective dimension dim - 1.  A variable order with a
finite horizon or a tempering raises NotImplementedError.  A variable horizon delta(x) of
a constant order (variableHorizonFractionalKernel, :1349, with an affine
:class:`horizonFunction`) is C(delta(x)) |x-y|^(-d-2s) 1{|x-y| <= delta(x)},
nonsymmetric, evaluated by :func:`evalXY` and K19 from its own
:class:`HorizonParams` (:meth:`Kernel.horizonParams`).

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

Where the JAX package drops a weight silently, the port raises: a
``temperedLambda`` given to getFractionalKernel (the JAX factory swallows
it; the FractionalKernel constructor takes it), phi with a variable
horizon, a tempering of a variable order.  getIntegrableKernel's
polynomial kernel raises too (the JAX factory sets its a to 0, so its
values are infinite): build Kernel(dim, 'polynomial', ..., exponentParam=a).
"""
from __future__ import annotations

import copy
import ctypes
from typing import NamedTuple

import numpy as np
import torch
from scipy.special import gamma as Gamma, gammaln, digamma, polygamma

from ..base.factory import factory

__all__ = ['constFractionalOrder', 'variableConstFractionalOrder',
           'constantNonSymFractionalOrder', 'leftRightFractionalOrder',
           'fractionalOrderFactory', 'OrderParams', 'evalXY', 'orderEval',
           'innerOuterFractionalOrder', 'smoothedLeftRightFractionalOrder',
           'linearLeftRightFractionalOrder',
           'smoothedInnerOuterFractionalOrder', 'islandsFractionalOrder',
           'layersFractionalOrder', 'feFractionalOrder',
           'OrderTable', 'DENSE_ONLY_ORDERS',
           'ORDER_COMPONENT', 'componentTerms', 'MANIFOLD_FRACTIONAL',
           'FractionalKernel',
           'getFractionalKernel', 'getIntegrableKernel',
           'constantFractionalLaplacianScaling', 'constantIntegrableScaling',
           'fullSpace', 'ball2', 'ballInf', 'ball1', 'ellipse',
           'ball2Complement',
           'interactionFactory', 'Indicator', 'indicatorMask', 'dirNorm',
           'horizonFunction', 'variableHorizonFractionalKernel',
           'HorizonParams', 'horizonArgs',
           'radialEval', 'Profile', 'FRACTIONAL', 'INDICATOR',
           'PERIDYNAMIC', 'GAUSSIAN', 'EXPONENTIAL', 'POLYNOMIAL',
           'LOGINVERSEDISTANCE', 'MONOMIAL', 'POWER', 'POWER_LOG',
           'LOG_INVERSE_DISTANCE_PROFILE', 'POLYNOMIAL_PROFILE',
           'TWO_POINT_NONE', 'TWO_POINT_TEMPERED',
           'twoPointFunction', 'constantTwoPoint', 'temperedTwoPoint',
           'leftRightTwoPoint', 'lambdaTwoPoint', 'lookupTwoPoint',
           'interfaceTwoPoint', 'twoPointFunctionFactory', 'Kernel',
           'DerivativeFractionalKernel', 'VectorFractionalKernel',
           'VectorParams', 'vectorTerms', 'vectorEval', 'vectorLogCoeffs',
           'ComplexKernel', 'getComplexKernel', 'getKernel', 'kernelFactory',
           'besselJ0Y0',
           'GREENS_2D', 'GREENS_3D', 'GREENS_2D_PROFILE',
           'GREENS_3D_PROFILE', 'COMPLEX_PROFILES']

FRACTIONAL = 'fractional'
# the fractional kernel of a closed 1-manifold in R^2 (chordal distance,
# effective dimension dim - 1: FractionalKernel(..., manifold=True))
MANIFOLD_FRACTIONAL = 'manifold_fractional'
INDICATOR = 'indicator'
PERIDYNAMIC = 'peridynamic'
GAUSSIAN = 'gaussian'
EXPONENTIAL = 'exponential'
POLYNOMIAL = 'polynomial'
LOGINVERSEDISTANCE = 'logInverseDistance'
MONOMIAL = 'monomial'
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
# C ln(1 / r) and C (1 - r2 / a^2)^2 (pynucleus_tpu/nl/kernels.py:1122-1128)
LOG_INVERSE_DISTANCE_PROFILE = 10
POLYNOMIAL_PROFILE = 11
PROFILE_CODES = range(12)
COMPLEX_PROFILES = (GREENS_2D_PROFILE, GREENS_3D_PROFILE)
# the tempering multiplies these profiles' values
TEMPERED_PROFILES = (POWER, POWER_LOG)

# two-point weight codes, shared with kernels/csrc/common.cuh twoPoint():
# none, or the tempered exp(-wlam |x-y|)
TWO_POINT_NONE = 0
TWO_POINT_TEMPERED = 1


class Profile(NamedTuple):
    """A kernel's radial profile as the device kernels take it: its code
    and the parameters C (scaling), e (the power's exponent of r2), a (the
    gaussian's or exponential's rate; greens2D's wavenumber lam; greens3D's
    Re lam, with e its Im lam; the polynomial's radius), C1, C2 (the
    POWER_LOG profile's coefficients of ln r2 and ln^2 r2), t (the
    tempering lambda of the power and power-log profiles: their value
    times exp(-t r)) and the smooth two-point weight (wcode, wlam): code
    TWO_POINT_TEMPERED multiplies gamma by exp(-wlam |x-y|) after the
    tempering."""
    code: int
    C: float
    e: float
    a: float
    C1: float = 0.0
    C2: float = 0.0
    t: float = 0.0
    wcode: int = TWO_POINT_NONE
    wlam: float = 0.0

    def rounded(self, dtype):
        """The profile as a kernel of value type ``dtype`` evaluates it:
        for float32 each parameter rounded to float32 once on the host (as
        the JAX expression C * r2 ** e rounds its Python floats against a
        float32 array), for float64 the profile itself."""
        if dtype != torch.float32:
            return self
        return self._replace(**{k: float(np.float32(getattr(self, k)))
                                for k in ('C', 'e', 'a', 'C1', 'C2', 't',
                                          'wlam')})


# fractional order codes, shared with kernels/csrc/common.cuh kernelXY()
ORDER_NONE = 0          # the kernel is its radial profile
ORDER_CONST = 1         # s(x, y) = sll, normalized per node
ORDER_LEFT_RIGHT = 2    # sll / srr / slr / srl by the sides of x and y
ORDER_INNER_OUTER = 3   # sii / soo / sio / soi by |x - c|^2 < r^2
ORDER_ISLANDS = 4       # sii / soo / sio / soi by r <= |x_d| <= r2 for all d
ORDER_LAYERS = 5        # orders[I, J] of the layers of x[-1] and y[-1]
ORDER_SMOOTHED_LR = 6   # s(x): smoothstep from sll to srr across x[0] = iface
ORDER_LINEAR_LR = 7     # s(x): linear from sll to srr across x[0] = iface
ORDER_SMOOTHED_IO = 8   # s(x): smoothstep from sl to sr across |x| = radius
ORDER_FE = 9            # s(x): the raster of an FE vector, multilinear
ORDER_COMPONENT = 10    # component q of a vector s-derivative kernel
ORDER_CODES = range(11)
# the orders of position whose H2 operator the JAX package fails to build on
# the interval (an AssertionError in its getH2): the kernels have them for
# the dense targets of K1 and K19 only, and the H2 format raises
DENSE_ONLY_ORDERS = (ORDER_SMOOTHED_LR, ORDER_LINEAR_LR, ORDER_SMOOTHED_IO)
# the coefficient row of a side of a component order: (c0, c1, c2, b, c, e)
# of :class:`VectorParams` and the side's gradient entry G_q
COMPONENT_ROW = 7
# the variant names of the codes in kernels.launches
ORDER_VARIANTS = {ORDER_INNER_OUTER: 'inner_outer',
                  ORDER_ISLANDS: 'islands', ORDER_LAYERS: 'layers',
                  ORDER_SMOOTHED_LR: 'smoothed_left_right',
                  ORDER_LINEAR_LR: 'linear_left_right',
                  ORDER_SMOOTHED_IO: 'smoothed_inner_outer',
                  ORDER_FE: 'fe'}


class OrderTable:
    """An order's table (float64 [n], on the host) and its copies on the
    devices it was used on, made once per device and kept as long as the
    order that owns the table."""

    def __init__(self, host):
        self.host = host
        self._copies = {}

    def on(self, device):
        """The table on ``device``."""
        dev = torch.device(device)
        if dev not in self._copies:
            self._copies[dev] = self.host.to(dtype=torch.float64,
                                             device=dev).contiguous()
        return self._copies[dev]


class OrderParams(NamedTuple):
    """A variable fractional order as the device kernels take it: its code
    and values (sll, srr, slr, srl, interface; a constant order has all four
    values equal), the dimension d of the normalization C(d, s) and whether
    the kernel is the boundary kernel C(s)/s r^(1-d-2s).  The orders of
    position (codes 3-9) also take ``g``, up to four floats
    formed on the host as the JAX expressions form them from Python floats
    (innerOuter: the centre's coordinates and r^2 at g[2]; islands: r, r2;
    smoothedLeftRight: the interface and 0.5/r; linearLeftRight: the
    interface, r and 2r; smoothedInnerOuter: the radius and 0.5/r), and
    ``table`` (an :class:`OrderTable` of layers' inner boundaries then its
    [n, n] orders, or of fe's raster [n] or [n, n]) with its ``n``, and
    fe's raster box ``lo``, ``hi`` [dim].  The component order
    (ORDER_COMPONENT, :class:`_ComponentFractionalKernel`) is component q of
    a vector kernel: its ``table`` the [4, COMPONENT_ROW] rows of the sides
    ll, rr, lr, rl (the side's :class:`VectorParams` coefficients and its
    gradient entry G_q), ``interface`` the sides' interface."""
    code: int
    sll: float
    srr: float
    slr: float
    srl: float
    interface: float
    dim: int
    boundary: bool
    g: tuple = ()
    table: object = None
    n: int = 0
    lo: tuple = ()
    hi: tuple = ()


class HorizonParams(NamedTuple):
    """A variable horizon as K19 takes it: delta(x) = clip(c0 + c x_0, min,
    max) of :class:`horizonFunction`, the constant order s, the dimension d
    of the normalization and whether C is the normalization at delta(x) or
    1/2 (variableHorizonFractionalKernel.evalXY)."""
    c0: float
    c: float
    min: float
    max: float
    s: float
    dim: int
    normalized: bool


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


def _mixedOrder(xi, yi, sii, soo, sio, soi):
    """sii where x and y are in, soo where both are out, sio / soi
    across (x in / y in): the np.where nest of the JAX orders."""
    return np.where(xi & yi, sii,
                    np.where(~xi & ~yi, soo, np.where(xi, sio, soi)))


class innerOuterFractionalOrder(fractionalOrderBase):
    """s by whether x and y lie inside the ball of radius r around
    ``center``: sii inside-inside, soo outside-outside, sio / soi across
    (pynucleus_tpu/nl/kernels.py:206-248).  Inside is the strict
    |x - c|^2 < r^2; symmetric iff sio == soi."""

    def __init__(self, dim, sii, soo, r, center=None, sio=np.nan,
                 soi=np.nan):
        if not np.isfinite(sio):
            sio = 0.5 * (sii + soo)
        if not np.isfinite(soi):
            soi = 0.5 * (sii + soo)
        self.dim = dim
        self.sii, self.soo, self.sio, self.soi = sii, soo, sio, soi
        self.r = float(r)
        self.center = (np.zeros(dim) if center is None
                       else np.asarray(center, dtype=np.float64))
        self.smin = min(sii, soo, sio, soi)
        self.smax = max(sii, soo, sio, soi)
        self.symmetric = (sio == soi)

    def _inside(self, X):
        return np.sum((np.asarray(X) - self.center) ** 2, axis=-1) \
            < self.r ** 2

    def __call__(self, X, Y):
        return _mixedOrder(self._inside(np.atleast_2d(X)),
                           self._inside(np.atleast_2d(Y)), self.sii,
                           self.soo, self.sio, self.soi)

    def _key(self):
        return (type(self).__name__, self.sii, self.soo, self.sio, self.soi,
                self.r, tuple(self.center))

    def orderParams(self, dim, boundary):
        c = tuple(float(v) for v in self.center) + (0.0,) * (2 - self.dim)
        return OrderParams(ORDER_INNER_OUTER, self.sii, self.soo, self.sio,
                           self.soi, 0.0, dim, boundary,
                           g=c[:2] + (self.r ** 2,))

    def __repr__(self):
        return f'innerOuter({self.sii},{self.soo},r={self.r})'


def _smoothstep01(t, xp):
    t = xp.clip(t, 0.0, 1.0)
    return 3.0 * t ** 2 - 2.0 * t ** 3


class smoothedLeftRightFractionalOrder(fractionalOrderBase):
    """s(x) alone: a smoothstep from sll to srr over [interface - r,
    interface + r] of x[0] (pynucleus_tpu/nl/kernels.py:256-285);
    nonsymmetric."""
    symmetric = False

    def __init__(self, sll, srr, r=0.1, slope=200.0, interface=0.0):
        self.sll, self.srr = sll, srr
        self.r = float(r)
        self.interface = float(interface)
        self.smin = min(sll, srr)
        self.smax = max(sll, srr)

    def __call__(self, X, Y):
        t = (np.atleast_2d(X)[..., 0] - self.interface) * (0.5 / self.r) \
            + 0.5
        return self.sll + (self.srr - self.sll) * _smoothstep01(t, np)

    def _key(self):
        return (type(self).__name__, self.sll, self.srr, self.r,
                self.interface)

    def orderParams(self, dim, boundary):
        return OrderParams(ORDER_SMOOTHED_LR, self.sll, self.srr, self.sll,
                           self.srr, self.interface, dim, boundary,
                           g=(self.interface, 0.5 / self.r))

    def __repr__(self):
        return f'smoothedLeftRight({self.sll},{self.srr},r={self.r})'


class linearLeftRightFractionalOrder(fractionalOrderBase):
    """s(x) alone: linear from sll to srr over [interface - r, interface +
    r] of x[0] (pynucleus_tpu/nl/kernels.py:288-314); nonsymmetric."""
    symmetric = False

    def __init__(self, sll, srr, r=0.1, interface=0.0):
        self.sll, self.srr = sll, srr
        self.r = float(r)
        self.interface = float(interface)
        self.smin = min(sll, srr)
        self.smax = max(sll, srr)

    def __call__(self, X, Y):
        t = np.clip((np.atleast_2d(X)[..., 0] - self.interface + self.r)
                    / (2 * self.r), 0.0, 1.0)
        return self.sll + (self.srr - self.sll) * t

    def _key(self):
        return (type(self).__name__, self.sll, self.srr, self.r,
                self.interface)

    def orderParams(self, dim, boundary):
        return OrderParams(ORDER_LINEAR_LR, self.sll, self.srr, self.sll,
                           self.srr, self.interface, dim, boundary,
                           g=(self.interface, self.r, 2 * self.r))

    def __repr__(self):
        return f'linearLeftRight({self.sll},{self.srr},r={self.r})'


class smoothedInnerOuterFractionalOrder(fractionalOrderBase):
    """s(x) alone: a smoothstep from sl (inside) to sr over |x| in [radius
    - r, radius + r] (pynucleus_tpu/nl/kernels.py:317-342, the factory's
    innerOuterNonSym); nonsymmetric."""
    symmetric = False

    def __init__(self, sl, sr, r=0.1, slope=200.0, radius=0.5):
        self.sl, self.sr = sl, sr
        self.r = float(r)
        self.radius = float(radius)
        self.smin = min(sl, sr)
        self.smax = max(sl, sr)

    def __call__(self, X, Y):
        rr = np.sqrt(np.sum(np.atleast_2d(X) ** 2, axis=-1))
        t = (rr - self.radius) * (0.5 / self.r) + 0.5
        return self.sl + (self.sr - self.sl) * _smoothstep01(t, np)

    def _key(self):
        return (type(self).__name__, self.sl, self.sr, self.r, self.radius)

    def orderParams(self, dim, boundary):
        return OrderParams(ORDER_SMOOTHED_IO, self.sl, self.sr, self.sl,
                           self.sr, 0.0, dim, boundary,
                           g=(self.radius, 0.5 / self.r))

    def __repr__(self):
        return f'smoothedInnerOuter({self.sl},{self.sr})'


class islandsFractionalOrder(fractionalOrderBase):
    """s by membership of x and y in the islands r <= |x_d| <= r2 for every
    coordinate d (pynucleus_tpu/nl/kernels.py:345-379); symmetric iff
    sio == soi."""

    def __init__(self, sii, soo, r=0.1, r2=0.6, sio=np.nan, soi=np.nan):
        if not np.isfinite(sio):
            sio = 0.5 * (sii + soo)
        if not np.isfinite(soi):
            soi = 0.5 * (sii + soo)
        self.sii, self.soo, self.sio, self.soi = sii, soo, sio, soi
        self.r, self.r2 = float(r), float(r2)
        self.smin = min(sii, soo, sio, soi)
        self.smax = max(sii, soo, sio, soi)
        self.symmetric = (sio == soi)

    def _inIsland(self, X):
        p = np.abs(np.asarray(X))
        return np.all((p >= self.r) & (p <= self.r2), axis=-1)

    def __call__(self, X, Y):
        return _mixedOrder(self._inIsland(np.atleast_2d(X)),
                           self._inIsland(np.atleast_2d(Y)), self.sii,
                           self.soo, self.sio, self.soi)

    def _key(self):
        return (type(self).__name__, self.sii, self.soo, self.sio, self.soi,
                self.r, self.r2)

    def orderParams(self, dim, boundary):
        return OrderParams(ORDER_ISLANDS, self.sii, self.soo, self.sio,
                           self.soi, 0.0, dim, boundary, g=(self.r, self.r2))

    def __repr__(self):
        return f'islands({self.sii},{self.soo})'


class layersFractionalOrder(fractionalOrderBase):
    """Layers along the last coordinate: s = layerOrders[I, J] with I, J
    the layers of x[-1] and y[-1] (searchsorted of the inner boundaries,
    side 'right'; pynucleus_tpu/nl/kernels.py:382-415); symmetric iff the
    orders are."""

    def __init__(self, dim, layerBoundaries, layerOrders):
        self.dim = dim
        self.layerBoundaries = np.asarray(layerBoundaries, dtype=np.float64)
        self.layerOrders = np.asarray(layerOrders, dtype=np.float64)
        self.smin = float(self.layerOrders.min())
        self.smax = float(self.layerOrders.max())
        self.symmetric = bool(np.allclose(self.layerOrders,
                                          self.layerOrders.T))
        self._table = OrderTable(torch.as_tensor(np.concatenate(
            [self.layerBoundaries[1:-1], self.layerOrders.ravel()])))

    def _layer(self, X):
        idx = np.searchsorted(self.layerBoundaries[1:-1],
                              np.asarray(X)[..., -1], side='right')
        return np.clip(idx, 0, self.layerOrders.shape[0] - 1)

    def __call__(self, X, Y):
        return self.layerOrders[self._layer(np.atleast_2d(X)),
                                self._layer(np.atleast_2d(Y))]

    def _key(self):
        return (type(self).__name__, tuple(self.layerBoundaries),
                tuple(self.layerOrders.ravel()))

    def orderParams(self, dim, boundary):
        return OrderParams(ORDER_LAYERS, self.smin, self.smax, self.smin,
                           self.smax, 0.0, dim, boundary, table=self._table,
                           n=self.layerOrders.shape[0])

    def __repr__(self):
        return f'layers({self.layerOrders.shape[0]})'


class feFractionalOrder(fractionalOrderBase):
    """s(x) of an FE vector (pynucleus_tpu/nl/kernels.py:418-475):
    evaluated on the host by locating x in the mesh (fem.lookup), on the
    device on the JAX package's raster, gridN points per axis in 1D and
    min(gridN, 192) in 2D over the mesh's bounding box, the FE values
    clipped to [smin, smax] at the points and interpolated multilinearly
    (the raster and the box travel in the order's OrderParams);
    nonsymmetric."""
    symmetric = False

    def __init__(self, vec, smin=None, smax=None, gridN=256):
        from ..fem.lookup import lookupFunction
        self.vec = vec
        self.dm = vec.dm
        arr = np.asarray(vec.data.detach().cpu().numpy()
                         if hasattr(vec.data, 'detach') else vec.data)
        self.smin = float(smin if smin is not None else arr.min())
        self.smax = float(smax if smax is not None else arr.max())
        self._lookup = lookupFunction(vec.dm.mesh, vec.dm, vec,
                                      fallback=0.5 * (self.smin + self.smax))
        mesh = vec.dm.mesh
        self._lo = mesh.vertices.min(axis=0)
        self._hi = mesh.vertices.max(axis=0)
        dim = mesh.dim
        if dim > 2:
            raise NotImplementedError('feFractionalOrder in 3D')
        n = gridN if dim == 1 else min(gridN, 192)
        axes = [np.linspace(self._lo[d], self._hi[d], n)
                for d in range(dim)]
        G = np.meshgrid(*axes, indexing='ij')
        pts = np.stack([g.ravel() for g in G], axis=1)
        vals = np.clip(self._lookup(pts), self.smin, self.smax)
        self._gridN = n
        self._grid = torch.as_tensor(vals.reshape((n,) * dim))
        self._table = OrderTable(self._grid.reshape(-1))

    def __call__(self, X, Y):
        vals = np.clip(self._lookup(np.atleast_2d(X)), self.smin, self.smax)
        return np.broadcast_to(
            vals, np.broadcast_shapes(np.atleast_2d(X).shape[:-1],
                                      np.atleast_2d(Y).shape[:-1])).copy()

    @property
    def numParameters(self):
        return self.dm.num_dofs

    def _key(self):
        return (type(self).__name__, id(self.vec), self.smin, self.smax)

    def orderParams(self, dim, boundary):
        return OrderParams(ORDER_FE, self.smin, self.smax, self.smin,
                           self.smax, 0.0, dim, boundary,
                           table=self._table, n=self._gridN,
                           lo=tuple(float(v) for v in self._lo),
                           hi=tuple(float(v) for v in self._hi))

    def __repr__(self):
        return f'fe({self.smin},{self.smax})'


# name -> order (pynucleus_tpu/nl/kernels.py:564-580 fractionalOrderFactory
# with its aliases)
fractionalOrderFactory = {
    'const': constFractionalOrder,
    'varconst': variableConstFractionalOrder,
    'constantNonSym': constantNonSymFractionalOrder,
    'twoDomain': leftRightFractionalOrder,
    'twoDomainNonSym': leftRightFractionalOrder,
    'leftRight': leftRightFractionalOrder,
    'innerOuter': innerOuterFractionalOrder,
    'smoothedLeftRight': smoothedLeftRightFractionalOrder,
    'smoothedTwoDomain': smoothedLeftRightFractionalOrder,
    'linearLeftRightNonSym': linearLeftRightFractionalOrder,
    'innerOuterNonSym': smoothedInnerOuterFractionalOrder,
    'islands': islandsFractionalOrder,
    'layers': layersFractionalOrder,
    'fe': feFractionalOrder,
}


# -------------------------------------------------------- two-point weights

class twoPointFunction:
    """phi(x, y) weights multiplying the kernel (pynucleus_tpu/nl/
    kernels.py:585-700).  ``smooth`` marks the weight that the device
    kernels evaluate at every quadrature node (:meth:`deviceParams`, the
    profile's wcode and wlam); the others are evaluated on the host at
    cell centres by ``evalPairs`` (numpy)."""
    symmetric = True
    smooth = False

    def evalPairs(self, x, y):
        raise NotImplementedError()

    def eval(self, x, y):
        raise NotImplementedError()


class constantTwoPoint(twoPointFunction):
    """phi = const."""

    def __init__(self, value=1.0):
        self.value = float(value)

    def evalPairs(self, x, y):
        return np.full(np.atleast_2d(x).shape[0], self.value)

    def eval(self, x, y):
        return torch.full(torch.broadcast_shapes(x.shape[:-1], y.shape[:-1]),
                          self.value, dtype=x.dtype, device=x.device)

    def _key(self):
        return ('constantTwoPoint', self.value)


class temperedTwoPoint(twoPointFunction):
    """phi = exp(-lambda |x-y|): the smooth weight, evaluated per
    quadrature node on the device (code TWO_POINT_TEMPERED)."""
    smooth = True

    def __init__(self, lambdaCoeff, dim=None):
        self.lambdaCoeff = float(lambdaCoeff)
        self.dim = dim

    def evalPairs(self, x, y):
        r = np.linalg.norm(np.atleast_2d(x) - np.atleast_2d(y), axis=-1)
        return np.exp(-self.lambdaCoeff * r)

    def eval(self, x, y):
        r = torch.sqrt(((x - y) ** 2).sum(-1))
        return torch.exp(-self.lambdaCoeff * r)

    def deviceParams(self):
        """(wcode, wlam) of the device kernels' profile."""
        return TWO_POINT_TEMPERED, self.lambdaCoeff

    def _key(self):
        return ('temperedTwoPoint', self.lambdaCoeff)


class leftRightTwoPoint(twoPointFunction):
    """phi = vll/vrr on same-side pairs, vlr/vrl across the interface (the
    side of a point: x[0] <= interface).  Piecewise constant: evaluated on
    the host at cell centres, as in the JAX package."""

    def __init__(self, vll, vrr, vlr=None, vrl=None, interface=0.0):
        self.vll, self.vrr = vll, vrr
        self.vlr = vlr if vlr is not None else 0.5 * (vll + vrr)
        self.vrl = vrl if vrl is not None else 0.5 * (vll + vrr)
        self.interface = interface
        self.symmetric = (self.vlr == self.vrl)

    def evalPairs(self, x, y):
        x0 = np.atleast_2d(x)[:, 0]
        y0 = np.atleast_2d(y)[:, 0]
        xl = x0 <= self.interface
        yl = y0 <= self.interface
        return np.where(xl & yl, self.vll,
                        np.where(~xl & ~yl, self.vrr,
                                 np.where(xl, self.vlr, self.vrl)))

    def eval(self, x, y):
        xl = x[..., 0] <= self.interface
        yl = y[..., 0] <= self.interface

        def v(a):
            return torch.tensor(float(a), dtype=x.dtype, device=x.device)
        return torch.where(xl & yl, v(self.vll),
                           torch.where(~xl & ~yl, v(self.vrr),
                                       torch.where(xl, v(self.vlr),
                                                   v(self.vrl))))

    def _key(self):
        return ('leftRightTwoPoint', self.vll, self.vrr, self.vlr, self.vrl,
                self.interface)


class lambdaTwoPoint(twoPointFunction):
    """phi from a python callable fun(x, y); host evaluation at cell
    centers."""

    def __init__(self, fun, symmetric=True):
        self.fun = fun
        self.symmetric = symmetric

    def evalPairs(self, x, y):
        x = np.atleast_2d(x)
        y = np.atleast_2d(y)
        return np.array([self.fun(x[k], y[k]) for k in range(x.shape[0])])

    def _key(self):
        return ('lambdaTwoPoint', id(self.fun))


class lookupTwoPoint(twoPointFunction):
    """phi(x, y) = (w(x)+w(y))/2 with w an FE vector (fem.lookup)."""

    def __init__(self, vec):
        from ..fem.lookup import lookupFunction
        self.vec = vec
        self._lookup = lookupFunction(vec.dm.mesh, vec.dm, vec)

    def evalPairs(self, x, y):
        return 0.5 * (self._lookup(np.atleast_2d(x))
                      + self._lookup(np.atleast_2d(y)))

    def _key(self):
        return ('lookupTwoPoint', id(self.vec))


class interfaceTwoPoint(twoPointFunction):
    """Interface weight phi(x, y) for two-domain kernels: 1 within the own
    subdomain, 0 within the other, 1/2 on pairs straddling the interface
    that BOTH kernels can reach (pynucleus_tpu/nl/kernels.py:971-1025).
    Piecewise constant with breakpoints at interface and interface -/+
    horizon2/horizon1, so evaluation at cell centers is exact per cell pair
    on a mesh aligned to them."""

    def __init__(self, horizon1, horizon2, left, interface=0.0,
                 stripLo=0.0, stripHi=1.0):
        self.horizon1 = horizon1
        self.horizon2 = horizon2
        self.left = left
        self.interface = interface
        # in 2D the physical domains occupy the strip stripLo < y < stripHi;
        # points outside it are exterior collar
        self.stripLo = stripLo
        self.stripHi = stripHi
        self.symmetric = True

    def _key(self):
        return ('interfaceTwoPoint', self.horizon1, self.horizon2,
                self.left, self.interface, self.stripLo, self.stripHi)

    def evalPairs(self, x, y):
        """x, y [P, dim] -> weights [P]."""
        c = self.interface
        x = np.atleast_2d(np.asarray(x))
        y = np.atleast_2d(np.asarray(y))
        x0, y0 = x[:, 0], y[:, 0]
        if self.left:
            w = np.full(len(x0), 0.5)
            w = np.where((x0 <= c) & (y0 <= c), 1.0, w)
            w = np.where((x0 > c) & (y0 > c), 0.0, w)
            w = np.where((x0 <= c - self.horizon2) & (y0 > c), 1.0, w)
            w = np.where((x0 > c) & (y0 <= c - self.horizon2), 1.0, w)
        else:
            w = np.full(len(x0), 0.5)
            w = np.where((x0 >= c) & (y0 >= c), 1.0, w)
            w = np.where((x0 < c) & (y0 < c), 0.0, w)
            w = np.where((x0 >= c + self.horizon1) & (y0 < c), 1.0, w)
            w = np.where((x0 < c) & (y0 >= c + self.horizon1), 1.0, w)
        if x.shape[1] >= 2:
            # strip-exterior points belong to the partner's kernel: weight 1
            # iff the in-strip partner lies on this kernel's side
            xin = (x[:, 1] > self.stripLo) & (x[:, 1] < self.stripHi)
            yin = (y[:, 1] > self.stripLo) & (y[:, 1] < self.stripHi)
            own = (lambda p0: p0 <= c) if self.left else (lambda p0: p0 >= c)
            w = np.where(xin & ~yin, np.where(own(x0), 1.0, 0.0), w)
            w = np.where(~xin & yin, np.where(own(y0), 1.0, 0.0), w)
            w = np.where(~xin & ~yin, 0.0, w)
        return w


# name -> two-point function, with the aliases of pynucleus_tpu/nl/
# kernels.py twoPointFunctionFactory (:704-712, :1027-1028)
twoPointFunctionFactory = factory()
twoPointFunctionFactory.register('constant', constantTwoPoint,
                                 aliases=['const', 'constantTwoPoint'])
twoPointFunctionFactory.register('tempered', temperedTwoPoint,
                                 aliases=['temperedTwoPoint'])
twoPointFunctionFactory.register('leftRight', leftRightTwoPoint,
                                 aliases=['leftRightTwoPoint'])
twoPointFunctionFactory.register('lambda', lambdaTwoPoint)
twoPointFunctionFactory.register('lookup', lookupTwoPoint)
twoPointFunctionFactory.register('interface', interfaceTwoPoint,
                                 aliases=['interfaceTwoPoint'])


# ------------------------------------------------------------- interactions

# interaction codes, shared with kernels/csrc/common.cuh inBall() and K15
# (which takes 1-4); code 5 is the complement of ball2
FULL_SPACE, BALL2, BALL_INF, BALL1, ELLIPSE, BALL2_COMPLEMENT = range(6)
IDENTITY_T = (1.0, 0.0, 0.0, 1.0)


class Indicator(NamedTuple):
    """The interaction indicator of a finite horizon as the device kernels
    take it: the ball's code, horizon^2 and, for the ellipse, its map T
    (row-major T00, T01, T10, T11)."""
    code: int
    h2: float
    T: tuple = IDENTITY_T


class interactionDomain:
    """chi_{N(x)}(y) for the norm ball |x - y| < horizon of one norm
    (pynucleus_tpu/nl/kernels.py:717-860).

    innerRadius2/outerRadius2 give Euclidean radii with ball2(inner) <=
    interaction <= ball2(outer) for the horizon screen.  ``code`` names the
    ball for the kernels and their plain versions, which evaluate its
    indicator (:func:`indicatorMask`, jaxIndicator) and its norm of ray
    directions (:func:`dirNorm`, jaxDirNorm) from it and from ``T``: 0 the
    full space, 1 ball2 (|x-y|_2), 2 ballInf (|x-y|_inf), 3 ball1
    (|x-y|_1), 4 the ellipse (|T (x-y)|_2), 5 the complement of ball2
    (|x-y|_2 >= horizon, ``complement``)."""
    complement = False
    symmetric = True
    code = FULL_SPACE
    T = IDENTITY_T

    def innerRadius2(self, hv, dim):
        return hv

    def outerRadius2(self, hv, dim):
        return hv


class fullSpace(interactionDomain):
    def __repr__(self):
        return 'fullSpace'


class ball2(interactionDomain):
    """Euclidean ball |x-y|_2 < horizon."""
    code = BALL2

    def __repr__(self):
        return 'ball2'


class ballInf(interactionDomain):
    """Max-norm ball |x-y|_inf < horizon."""
    code = BALL_INF

    def outerRadius2(self, hv, dim):
        return hv * np.sqrt(dim)

    def __repr__(self):
        return 'ballInf'


class ball1(interactionDomain):
    """L1 (diamond) ball |x-y|_1 < horizon."""
    code = BALL1

    def innerRadius2(self, hv, dim):
        return hv / np.sqrt(dim)

    def __repr__(self):
        return 'ball1'


class ellipse(interactionDomain):
    """Elliptic interaction |T (x-y)|_2 < horizon with
    T = diag(1/a, 1/b) . rot(theta) (one of the axes is 1)."""
    code = ELLIPSE

    def __init__(self, aFac=1.0, bFac=0.5, theta=0.0):
        assert aFac == 1.0 or bFac == 1.0, \
            'one of the two axes must be equal to 1'
        self.aFac, self.bFac, self.theta = float(aFac), float(bFac), \
            float(theta)
        c, s = np.cos(self.theta), np.sin(self.theta)
        self.T = tuple(float(v) for v in (c / self.aFac, -s / self.aFac,
                                          s / self.bFac, c / self.bFac))

    def innerRadius2(self, hv, dim):
        return hv * min(self.aFac, self.bFac)

    def outerRadius2(self, hv, dim):
        return hv * max(self.aFac, self.bFac)

    def __repr__(self):
        return f'ellipse({self.aFac},{self.bFac},{self.theta})'


class ball2Complement(interactionDomain):
    """The outside of the Euclidean ball, |x-y|_2 >= horizon: the support
    of a complement kernel (pynucleus_tpu/nl/kernels.py:863-877)."""
    complement = True
    code = BALL2_COMPLEMENT

    def __repr__(self):
        return 'ball2Complement'


# name -> interaction, with the aliases of pynucleus_tpu/nl/kernels.py
# interactionFactory (:879-895; the retriangulation and barycenter names of
# the reference all take the exact cut-cell clipping)
interactionFactory = {'fullSpace': fullSpace, 'full': fullSpace}
for _cls, _aliases in ((ball2, ('ball2', 'ball', 'ball2_retriangulation',
                                'ball2_barycenter', '2')),
                       (ballInf, ('ballInf', 'ballInf_retriangulation',
                                  'ballInf_barycenter', 'inf')),
                       (ball1, ('ball1', 'ball1_retriangulation',
                                'ball1_barycenter', '1')),
                       (ellipse, ('ellipse', 'ellipse_retriangulation',
                                  'ellipse_barycenter')),
                       (ball2Complement, ('ball2Complement',))):
    interactionFactory.update(dict.fromkeys(_aliases, _cls))


def _ellipseNorm2(d, T):
    """|T d|_2^2 of directions d [..., 2]: T[i,0] d_0 + T[i,1] d_1, the
    terms of jnp.einsum('ij,...j->...i', T, d) in its order, each product
    and sum rounded on its own (XLA's CPU einsum fuses the second product
    into a multiply-add, so a rotated ellipse's norms differ from the JAX
    package's by an ulp or two)."""
    t0 = T[0] * d[..., 0] + T[1] * d[..., 1]
    t1 = T[2] * d[..., 0] + T[3] * d[..., 1]
    return t0 * t0 + t1 * t1


def indicatorMask(x, y, r2, indicator):
    """chi(x, y) [...] as a bool tensor of an :class:`Indicator` (or a
    (code, h2) pair) at x, y [..., dim] with r2 = |x-y|^2, as
    pynucleus_tpu/nl/kernels.py jaxIndicator evaluates it; None for the
    full space (code 0).  Code 5 (ball2Complement) is r2 >= h2."""
    code, h2, *T = indicator
    T = T[0] if T else IDENTITY_T
    if code == FULL_SPACE:
        return None
    if code == BALL2:
        return r2 < h2
    if code == BALL2_COMPLEMENT:
        return r2 >= h2
    if code == BALL_INF:
        m = (x - y).abs().amax(-1)
    elif code == BALL1:
        m = (x - y).abs().sum(-1)
    elif code == ELLIPSE:
        # T is a float64 array in the JAX expression: float32 differences
        # take its products and sums in float64
        return _ellipseNorm2((x - y).double(), T) < h2
    else:
        raise ValueError(f'interaction code {code}: 0 to 5')
    return m * m < h2


def dirNorm(d, code, T=IDENTITY_T):
    """The interaction norm of ray directions d [..., 2] (jaxDirNorm): 2-norm
    (ball2), max norm (ballInf), 1-norm (ball1) or |T d|_2 (the
    ellipse)."""
    if code == BALL_INF:
        return d.abs().amax(-1)
    if code == BALL1:
        return d.abs().sum(-1)
    if code == ELLIPSE:
        return torch.sqrt(_ellipseNorm2(d, T))
    return torch.sqrt((d ** 2).sum(-1))


# --------------------------------------------------------------- scalings

def constantFractionalLaplacianScaling(dim, s, horizon, tempered=0.0):
    """Normalization so the operator converges to -Laplacian (includes the
    bilinear-form 1/2); a tempered kernel of an infinite horizon (s != 1/2)
    takes Gamma(d/2) / |Gamma(-2s)| / pi^(d/2) / 4 (pynucleus_tpu/nl/
    kernels.py:911-914)."""
    if 1.0 < s < 2.0:
        s = s - 1.0
    if horizon <= 0 or s <= 0 or s >= 1:
        return np.nan
    if horizon < np.inf:
        return (2.0 - 2 * s) * horizon ** (2 * s - 2.0) * dim \
            * Gamma(0.5 * dim) / np.pi ** (0.5 * dim) * 0.5
    if tempered == 0.0 or s == 0.5:
        return 2.0 ** (2.0 * s) * s * Gamma(s + 0.5 * dim) \
            / np.pi ** (0.5 * dim) / Gamma(1.0 - s) * 0.5
    return Gamma(0.5 * dim) / abs(Gamma(-2 * s)) / np.pi ** (0.5 * dim) * 0.25


def constantIntegrableScaling(kType, interaction, dim, horizon,
                              gaussian_variance=1.0, exponentialRate=1.0):
    """Second-moment normalizations of the integrable kernels (includes
    the bilinear-form 1/2; pynucleus_tpu/nl/kernels.py:917-965)."""
    from scipy.special import erf
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
            if isinstance(interaction, ball1):
                # second moment of the diamond |z|_1 < delta is 2 delta^4/3
                return 3.0 / horizon ** 4 / 2.0
        raise NotImplementedError((kType, dim))
    if kType == PERIDYNAMIC:
        if dim == 1:
            return 2.0 / horizon ** 2 / 2.0
        if dim == 2 and isinstance(interaction, ball2):
            return 6.0 / np.pi / horizon ** 3 / 2.0
        raise NotImplementedError((kType, dim))
    if kType == GAUSSIAN:
        if dim == 1:
            if horizon < np.inf:
                return 4.0 / np.sqrt(np.pi) / (erf(3.0) - 6.0 * np.exp(-9.0)
                                               / np.sqrt(np.pi)) \
                    / (horizon / 3.0) ** 3 / 2.0
            return 1.0 / np.sqrt(2.0 * np.pi * gaussian_variance) / 2.0
        if dim == 2:
            if isinstance(interaction, ball2) and horizon < np.inf:
                return 4.0 / np.pi / (1.0 - 10.0 * np.exp(-9.0)) \
                    / (horizon / 3.0) ** 4 / 2.0
            if isinstance(interaction, fullSpace):
                return 1.0 / (2.0 * np.pi * gaussian_variance) / 2.0
        raise NotImplementedError((kType, dim))
    if kType == EXPONENTIAL:
        if dim == 1:
            if horizon < np.inf:
                return exponentialRate ** 3 / (
                    2.0 - np.exp(-exponentialRate * horizon)
                    * (2.0 + 2.0 * exponentialRate * horizon
                       + (exponentialRate * horizon) ** 2)) / 2.0
            return exponentialRate ** 3 / 2.0 / 2.0
        raise NotImplementedError((kType, dim))
    if kType == POLYNOMIAL:
        return 0.5
    if kType == LOGINVERSEDISTANCE:
        return 1.0
    raise NotImplementedError(kType)


# ----------------------------------------------------------------- kernels

class Kernel:
    """gamma(x, y) = the radial profile of kernelType (scalingValue *
    |x-y|^singularityValue for the fractional, indicator and peridynamic
    kernels, times exp(-temperedLambda |x-y|) for a tempered fractional
    one; C exp(-a r^2) and C exp(-a r) for the gaussian and the
    exponential, a = exponentParam; C ln(1/r), C r^monomialPower and C (1 -
    r^2/a^2)^2 for the log-inverse-distance, monomial and polynomial
    types), times the interaction indicator for a finite horizon and the
    two-point weight: the smooth ``phiDevice`` (a temperedTwoPoint, per
    quadrature node) or the host ``phi`` (per cell pair, at the cell
    centres); symmetric, constant coefficients."""

    isComplex = False
    variable = False
    variableOrder = False
    variableHorizon = False
    symmetric = True
    phi = None
    phiDevice = None

    def __init__(self, dim, kernelType, horizon, interaction, scalingValue,
                 singularityValue, boundary=False, exponentParam=0.0,
                 variance=1.0, temperedLambda=0.0, monomialPower=0.0):
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
        self.temperedLambda = float(temperedLambda)
        self.monomialPower = float(monomialPower)
        self.complement = self.interaction.complement

    def setTwoPoint(self, phi):
        """Attach the two-point weight phi (or None): a smooth one as the
        device weight ``phiDevice``, any other as the host ``phi``, as the
        JAX factories set phiJax and phi."""
        if phi is None:
            return self
        if not hasattr(phi, 'evalPairs'):
            raise TypeError(f'phi must be a two-point function '
                            f'(twoPointFunctionFactory), got {phi!r}')
        if getattr(phi, 'smooth', False):
            self.phiDevice = phi
        else:
            self.phi = phi
        return self

    def hasWeight(self):
        """Whether a two-point weight or a tempering multiplies gamma."""
        return self.phi is not None or self.phiDevice is not None \
            or self.temperedLambda != 0.0

    def _key(self):
        """Value identity of the kernel (pynucleus_tpu/nl/kernels.py
        Kernel._key): its parameters, the interaction's type, and the
        two-point weights' keys."""
        return (type(self).__name__, self.dim, self.kernelType,
                self.horizonValue, self.scalingValue, self.singularityValue,
                self.boundary, self.symmetric, self.temperedLambda,
                self.exponentParam, self.monomialPower, self.variance,
                type(self.interaction).__name__, self.complement,
                self.phi._key() if self.phi is not None else None,
                self.phiDevice._key() if self.phiDevice is not None
                else None)

    @property
    def finiteHorizon(self):
        return self.horizonValue != np.inf and not self.complement

    def getSingularityValue(self):
        return self.singularityValue

    def weightParams(self):
        """(wcode, wlam) of the smooth two-point weight (none: code 0)."""
        if self.phiDevice is None:
            return TWO_POINT_NONE, 0.0
        return self.phiDevice.deviceParams()

    def profileParams(self):
        """The radial profile (code, C, e, a, C1, C2, t, wcode, wlam) that
        the device kernels and their plain versions evaluate
        (:func:`radialEval`): the fractional kernel's tempering is t (the
        other types' _radialJax branches take none), the smooth two-point
        weight (wcode, wlam)."""
        t, C, a = self.kernelType, self.scalingValue, self.exponentParam
        w = self.weightParams()
        if t in (FRACTIONAL, MANIFOLD_FRACTIONAL):
            return Profile(POWER, C, 0.5 * self.singularityValue, 0.0,
                           t=self.temperedLambda, wcode=w[0], wlam=w[1])
        if t in (INDICATOR, PERIDYNAMIC):
            return Profile(POWER, C, 0.5 * self.singularityValue, 0.0,
                           wcode=w[0], wlam=w[1])
        if t == MONOMIAL:
            # C r2^(p/2): the power profile's operations
            return Profile(POWER, C, 0.5 * self.monomialPower, 0.0,
                           wcode=w[0], wlam=w[1])
        code = {GAUSSIAN: GAUSSIAN_PROFILE,
                EXPONENTIAL: EXPONENTIAL_PROFILE,
                LOGINVERSEDISTANCE: LOG_INVERSE_DISTANCE_PROFILE,
                POLYNOMIAL: POLYNOMIAL_PROFILE,
                GAUSSIAN + 'Boundary': (GAUSSIAN_BOUNDARY_1D, GAUSSIAN_BOUNDARY_2D),
                EXPONENTIAL + 'Boundary': (EXPONENTIAL_BOUNDARY_1D,
                                           EXPONENTIAL_BOUNDARY_2D)}.get(t)
        if code is None:
            raise NotImplementedError(f'the radial profile of {t}')
        if isinstance(code, tuple):
            code = code[0] if self.dim == 1 else code[1]
        return Profile(code, C, 0.0, a, wcode=w[0], wlam=w[1])

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
        """The interaction :class:`Indicator` (code, horizon^2, T) that the
        panel quadrature (K1, K19) applies per node, or None for an
        infinite horizon (the JAX programs' gate ``finiteHorizon or
        complement``: a complement kernel's is code 5)."""
        if not (self.finiteHorizon or self.complement):
            return None
        return Indicator(self.interaction.code, self.horizonValue ** 2,
                         tuple(self.interaction.T))

    def horizonParams(self):
        """The variable horizon delta(x) (:class:`HorizonParams`) that K19
        evaluates per node, or None for a horizon of one value."""
        return None

    def getModifiedKernel(self, horizon=None, interaction=None):
        """The kernel with the given horizon and interaction
        (pynucleus_tpu/nl/kernels.py:1203-1214): a copy with the interaction
        and its ``complement`` flag replaced; the scaling, horizon value and
        profile stay.  The zero-exterior term asks an infinite-horizon
        kernel for its own horizon; another horizon is not ported."""
        if horizon is not None and float(horizon) != self.horizonValue:
            raise NotImplementedError('changing the horizon of a kernel')
        if interaction is None:
            return self
        k = copy.copy(self)
        k.interaction = interaction
        k.complement = interaction.complement
        return k

    def getComplementKernel(self):
        """The kernel on the complement of its ball2, |x-y| >= horizon
        (pynucleus_tpu/nl/kernels.py:1216-1218): not a finite horizon, its
        indicator code 5."""
        return self.getModifiedKernel(interaction=ball2Complement())

    def eval(self, x, y):
        """gamma(x, y) [...] at x, y [..., dim] (tensors) times the
        interaction indicator of a finite horizon or of a complement kernel:
        pynucleus_tpu/nl/kernels.py Kernel.jaxEval."""
        r2 = ((x - y) ** 2).sum(-1)
        val = evalXY(x, y, r2, self.profileParams(), self.orderParams(),
                     self.horizonParams())
        ind = self.indicatorParams()
        if ind is not None:
            val = val * indicatorMask(x, y, r2, ind)
        return val

    def __call__(self, x, y):
        """Pointwise host evaluation gamma(x, y) (pynucleus_tpu/nl/
        kernels.py Kernel.__call__): 0 beyond a finite horizon (r2 >
        horizon^2, the Euclidean ball of any interaction) and inside a
        complement kernel's (r2 < horizon^2).  A point at the horizon
        exactly keeps its value here and not in :meth:`eval`, as in the
        JAX package; the other profiles evaluate through :meth:`eval`.  A
        tempered kernel is multiplied by exp(-lambda |x-y|), a host weight
        phi by its value at (x, y).  The smooth weight enters through
        :meth:`eval` only (the JAX package's __call__ evaluates phiJax only
        for the other profiles)."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        y = np.atleast_2d(np.asarray(y, dtype=np.float64))
        r2 = float(((x - y) ** 2).sum())
        C = self.scalingValue
        t = self.kernelType
        if t in (FRACTIONAL, MANIFOLD_FRACTIONAL):
            if r2 == 0.0:
                return 0.0
            val = C * r2 ** (0.5 * self.singularityValue)
            if self.temperedLambda != 0.0:
                val *= np.exp(-self.temperedLambda * np.sqrt(r2))
        elif t == INDICATOR:
            val = C
        elif t == PERIDYNAMIC:
            val = C * r2 ** -0.5
        else:
            val = float(self.eval(torch.as_tensor(x), torch.as_tensor(y))
                        .reshape(-1)[0])
            if self.phi is not None:
                val = val * float(self.phi.evalPairs(x, y)[0])
            return val
        if self.finiteHorizon and r2 > self.horizonValue ** 2:
            val = 0.0
        if self.complement and r2 < self.horizonValue ** 2:
            val = 0.0
        if self.phi is not None:
            val = val * float(self.phi.evalPairs(x, y)[0])
        return float(val)

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
    order sets ``variableOrder`` but stays a radial profile.  With
    ``temperedLambda`` the kernel of a constant order is tempered, gamma
    times exp(-lambda |x-y|), normalized by the tempered scaling of an
    infinite horizon; the boundary kernel keeps the tempering.

    ``manifold=True`` is the MANIFOLD_FRACTIONAL kernel of a closed
    (dim-1)-manifold in R^dim (pynucleus_tpu/nl/kernels.py:1252-1284): the
    chordal distance |x-y| with the effective dimension dim - 1 in the
    scaling and the singularity alone; ``dim`` stays the space's.  A
    variable order of it raises (its normalization would take ``dim``)."""

    def __init__(self, dim, s, horizon=np.inf, interaction=None, scaling=None,
                 normalized=True, boundary=False, temperedLambda=0.0,
                 manifold=False):
        if not isinstance(s, fractionalOrderBase):
            s = constFractionalOrder(s)
        self.s = s
        self.manifold = manifold
        dEff = dim - 1 if manifold else dim
        self.variableOrder = type(s) is not constFractionalOrder
        sval = s.value if hasattr(s, 'value') else 0.5 * (s.min + s.max)
        if scaling is None:
            scaling = constantFractionalLaplacianScaling(
                dEff, sval, float(horizon), temperedLambda) if normalized \
                else 0.5
        super().__init__(dim, MANIFOLD_FRACTIONAL if manifold else FRACTIONAL,
                         horizon, interaction, scaling,
                         (1 if boundary else 0) - dEff - 2 * sval,
                         boundary=boundary, temperedLambda=temperedLambda)
        self.symmetric = s.symmetric
        self.variable = self.variableOrder and not isinstance(
            s, variableConstFractionalOrder)
        if self.variable and self.horizonValue != np.inf:
            raise NotImplementedError('a variable order with a finite '
                                      'horizon')
        if self.variable and self.temperedLambda != 0.0:
            # the JAX package's variable-order evalXY drops the tempering
            raise NotImplementedError('a tempered kernel of a variable '
                                      'order')
        if manifold and (self.variable or self.horizonValue != np.inf):
            raise NotImplementedError('a variable order or a finite horizon '
                                      'of the manifold kernel')
        self.min_singularity = (1 if boundary else 0) - dEff - 2 * s.max
        self.max_singularity = (1 if boundary else 0) - dEff - 2 * s.min

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
                                scaling=scal, boundary=True,
                                temperedLambda=self.temperedLambda)

    def _key(self):
        skey = self.s._key() if hasattr(self.s, '_key') else \
            ('s', getattr(self.s, 'value', None))
        return super()._key() + (self.variableOrder, self.variable) + skey


class horizonFunction:
    """A position-dependent horizon delta(x) = clip(c0 + c x_0, min, max),
    affine in the first coordinate (pynucleus_tpu/nl/kernels.py:1416
    horizonFunction takes any function; every delta of its tests is of this
    form).  Any other function raises NotImplementedError."""

    def __init__(self, c0, c, lo=None, hi=None):
        if callable(c0) or hi is None:
            # the JAX package's horizonFunction(fn, lo, hi)
            raise NotImplementedError('a general delta(x): the port takes '
                                      'the affine clip(c0 + c x_0, min, max)')
        self.c0, self.c = float(c0), float(c)
        self.min, self.max = float(lo), float(hi)

    def __call__(self, x):
        """delta at host points x [..., dim]."""
        x = np.asarray(x, dtype=np.float64)
        return np.minimum(np.maximum(self.c0 + self.c * x[..., 0],
                                     self.min), self.max)

    def eval(self, x):
        """delta at x [..., dim] (a tensor), each operation as jaxEval:
        min(max(c0 + c x_0, min), max)."""
        return torch.clamp(self.c0 + self.c * x[..., 0], self.min, self.max)

    def params(self):
        return (self.c0, self.c, self.min, self.max)


class variableHorizonFractionalKernel(FractionalKernel):
    """Fractional kernel of a constant order with a position-dependent
    horizon delta(x) (pynucleus_tpu/nl/kernels.py:1349):

        gamma(x, y) = C(d, s, delta(x)) |x-y|^(-d-2s) 1{|x-y|^2 <= delta(x)^2}

    with the finite-horizon normalization evaluated at delta(x) (or 1/2),
    times the ball2 indicator of the largest horizon.  Not symmetric: it
    takes the per-pair path (K19) and the indicator fallback for its cut
    pairs; the horizon screen brackets pairs with [min delta, max delta].
    Evaluated per node from :meth:`horizonParams` (:func:`evalXY`)."""

    def __init__(self, dim, s, horizonFun, normalized=True):
        if not isinstance(horizonFun, horizonFunction):
            raise NotImplementedError('a general delta(x): the port takes '
                                      'the affine horizonFunction')
        self.horizonFun = horizonFun
        self.horizonMin = horizonFun.min
        super().__init__(dim, s, horizon=horizonFun.max, interaction=ball2(),
                         normalized=normalized)
        if self.variable:
            raise NotImplementedError('variable horizon with variable order')
        self.variableHorizon = True
        self.symmetric = False
        self.normalized = normalized

    def horizonParams(self):
        return HorizonParams(*self.horizonFun.params(), self.sValue, self.dim,
                             self.normalized)

    def getBoundaryKernel(self):
        raise NotImplementedError('a variable horizon has no exterior term')

    def __repr__(self):
        return (f'kernel(fractional, d={self.dim}, s={self.sValue}, '
                f'horizon={self.horizonFun.params()})')


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
    :meth:`radial`; with ``temperedLambda`` times exp(-lambda r) (the JAX
    _gOfS tempers the kernel, not its boundary kernel).  valueSize 1."""

    def __init__(self, dim, s, horizon=np.inf, interaction=None,
                 normalized=True, boundary=False, derivative=1,
                 temperedLambda=0.0):
        _checkDerivative(horizon, derivative)
        super().__init__(dim, s, horizon, interaction, normalized=normalized,
                         boundary=boundary, temperedLambda=temperedLambda)
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

    def __call__(self, x, y):
        """Pointwise host evaluation of g^(k) (pynucleus_tpu/nl/kernels.py
        DerivativeFractionalKernel.__call__): 0 at x == y, beyond a finite
        horizon and inside a complement kernel's; the host weight phi
        multiplies it (the smooth one does not, as there)."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        y = np.atleast_2d(np.asarray(y, dtype=np.float64))
        r2 = float(((x - y) ** 2).sum())
        if r2 == 0.0 or (self.finiteHorizon and r2 > self.horizonValue ** 2) \
                or (self.complement and r2 < self.horizonValue ** 2):
            return 0.0
        prof = self.profileParams()._replace(wcode=TWO_POINT_NONE, wlam=0.0)
        val = float(radialEval(torch.tensor([r2], dtype=torch.float64),
                               prof)[0])
        if self.phi is not None:
            val = val * float(self.phi.evalPairs(x, y)[0])
        return val

    def profileParams(self):
        """Profile(POWER_LOG, C0, e, 0, C1, C2): g^(k) = r2^e (C0 + C1 ln r2
        + C2 ln^2 r2) from C, C', C'' at s."""
        C, dC, d2C = _prefactorDerivatives(self.dim, self.sValue,
                                           self.normalized, self.boundary)
        e = _exponentBase(self.dim, self.boundary) - self.sValue
        t = 0.0 if self.boundary else self.temperedLambda
        w = self.weightParams()
        if self.derivative == 1:
            return Profile(POWER_LOG, dC, e, 0.0, -C, 0.0, t, *w)
        return Profile(POWER_LOG, d2C, e, 0.0, -2.0 * dC, C, t, *w)

    def getBoundaryKernel(self):
        """d^k/ds^k of the boundary kernel C(s)/s r2^((1-d)/2-s), the
        s-derivative taken of it as a whole."""
        return DerivativeFractionalKernel(
            self.dim, self.s, horizon=self.horizonValue,
            normalized=self.normalized, boundary=True,
            derivative=self.derivative, temperedLambda=self.temperedLambda)


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


def componentTerms(x, y, r2, order):
    """(gamma, b, c) [...] of a component order (:class:`OrderParams` of
    code ORDER_COMPONENT) at nodes x, y [..., dim] with r2 = |x-y|^2: the
    component's value and its log coefficients (the parent's
    :func:`vectorEval` and :func:`vectorLogCoeffs` at column q: the side's
    factors of :func:`vectorTerms` times its gradient entry G_q), exactly 0
    where r2 == 0.  The operations of common.cuh componentTerm."""
    side = vectorSide(x, y, order.interface)
    tab = order.table.on(r2.device).to(r2.dtype).reshape(4, COMPONENT_ROW)
    cf = tab[side]
    pos = r2 > 0
    r2s = torch.where(pos, r2, 1.0)
    rad = r2s ** cf[..., 5]
    L = torch.log(r2s)
    val = rad * ((cf[..., 0] + cf[..., 1] * L) + cf[..., 2] * (L * L))
    G = cf[..., 6]
    return (torch.where(pos, val * G, 0.0),
            torch.where(pos, (cf[..., 3] * rad) * G, 0.0),
            torch.where(pos, (cf[..., 4] * rad) * G, 0.0))


def logExtra(x, y, r2, order, logTables):
    """The singular rules' log correction [P, Q] of a component order at
    the node pairs (x, y) [P, Q, dim] (pynucleus_tpu/nl/assembly.py
    _log_extra_scalar): cw1 (b + 2 c lnR) + cw2 c with lnR = ln|x-y| -
    lnEta and (b, c) the component's log coefficients
    (:func:`componentTerms`), 0 where r2 == 0; logTables = (lnEta, cw1,
    cw2) [Q]."""
    lnEta, cw1, cw2 = logTables
    _, b, c = componentTerms(x, y, r2, order)
    lnR = 0.5 * torch.log(torch.where(r2 > 0, r2, 1.0)) - lnEta[None, :]
    return cw1[None, :] * (b + 2.0 * c * lnR) + cw2[None, :] * c


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
    parent's derivative (the quadrature-order bump; the singular rules' log
    correction of its buckets).  The device kernels (K1, K19, K7) take it
    as the component order (:meth:`orderParams`, ORDER_COMPONENT): the
    parent's :class:`VectorParams` row of each side and the side's gradient
    entry G_q."""

    def __init__(self, parent, q):
        super().__init__(parent.dim, parent.s, horizon=parent.horizonValue,
                         normalized=parent.normalized,
                         boundary=parent.boundary)
        self.parent = parent
        self.q = int(q)
        self.symmetric = False
        self.variable = True
        self.derivative = parent.derivative
        vp = parent.vectorParams()
        rows = np.concatenate([vp.coefs, vp.grads[:, self.q:self.q + 1]],
                              axis=1)
        self._order = OrderParams(
            ORDER_COMPONENT, parent.s.sll, parent.s.srr, parent.s.slr,
            parent.s.srl, vp.interface, self.dim, self.boundary,
            table=OrderTable(torch.as_tensor(np.ravel(rows),
                                             dtype=torch.float64)),
            n=COMPONENT_ROW)

    def orderParams(self):
        """The component order (ORDER_COMPONENT): its table [4 *
        COMPONENT_ROW] of the sides' rows (c0, c1, c2, b, c, e, G_q)."""
        return self._order

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
                        temperedLambda=0.0, manifold=False, **kwargs):
    """The fractional kernel of order s; with ``derivative`` (1 or 2) its
    s-derivative: a :class:`VectorFractionalKernel` for an order of several
    parameters, else a :class:`DerivativeFractionalKernel`.  An order
    ranging over an ``admissibleSet`` gives a ``RangedFractionalKernel``
    (nl/operator_interpolation.py), which takes ``kwargs`` (errorBound,
    M_min, M_max, xi), as pynucleus_tpu/nl/kernels.py:1685-1688.  ``phi``
    is a two-point weight (:meth:`Kernel.setTwoPoint`).  ``manifold=True``
    gives the MANIFOLD_FRACTIONAL kernel (:class:`FractionalKernel`) of a
    constant order and a single horizon; with a ranged order, a variable
    horizon or an s-derivative it raises (the JAX factory drops it
    there)."""
    from .operator_interpolation import admissibleSet, RangedFractionalKernel
    if manifold and (isinstance(s, admissibleSet) or derivative
                     or isinstance(horizon, horizonFunction)
                     or callable(horizon)):
        raise NotImplementedError('the manifold kernel of a ranged order, '
                                  'a variable horizon or an s-derivative '
                                  '(the JAX factory drops manifold there)')
    if isinstance(s, admissibleSet):
        if phi is not None or temperedLambda != 0.0:
            raise NotImplementedError('a two-point weight or tempering of '
                                      'a ranged kernel (the JAX factory '
                                      'drops them)')
        return RangedFractionalKernel(dim, s, horizon=horizon,
                                      normalized=normalized, **kwargs)
    if kwargs:
        raise TypeError(f'getFractionalKernel: unexpected {sorted(kwargs)}')
    if temperedLambda != 0.0:
        # the JAX getFractionalKernel takes the argument in its **kwargs and
        # never passes it on: its kernel is not tempered
        raise NotImplementedError(
            'getFractionalKernel does not temper (the JAX factory drops '
            'temperedLambda); build FractionalKernel(dim, s, horizon, '
            'temperedLambda=...) instead')
    if not isinstance(s, fractionalOrderBase):
        s = constFractionalOrder(s)
    if isinstance(horizon, horizonFunction) or callable(horizon):
        # a function-valued horizon (pynucleus_tpu/nl/kernels.py:1691-1697)
        if phi is not None:
            raise NotImplementedError('a two-point weight with a variable '
                                      'horizon (the JAX factory drops it)')
        return variableHorizonFractionalKernel(dim, s, horizon,
                                               normalized=normalized)
    hv = float(horizon)
    if interaction is None:
        interaction = fullSpace() if hv == np.inf else ball2()
    if derivative:
        if s.numParameters > 1:
            if phi is not None:
                raise NotImplementedError('a two-point weight of a vector '
                                          'kernel (the JAX factory drops '
                                          'it)')
            return VectorFractionalKernel(dim, s, hv, interaction,
                                          normalized=normalized,
                                          derivative=derivative)
        return DerivativeFractionalKernel(
            dim, s, hv, interaction, normalized=normalized,
            derivative=derivative).setTwoPoint(phi)
    return FractionalKernel(dim, s, hv, interaction, scaling,
                            normalized=normalized,
                            manifold=manifold).setTwoPoint(phi)


def getIntegrableKernel(dim, kernel, horizon, interaction=None, scaling=None,
                        normalized=True, phi=None, gaussian_variance=1.0,
                        exponentialRate=1.0):
    """The indicator (gamma = C) or peridynamic (gamma = C / |x-y|) kernel of
    a finite horizon, the gaussian (C exp(-a |x-y|^2); a = 1 / (delta/3)^2
    for a finite horizon delta, else 1 / (2 variance^dim)) or exponential
    (C exp(-rate |x-y|)) kernel, or the log-inverse-distance kernel (C
    ln(1/|x-y|)), with the two-point weight ``phi``
    (pynucleus_tpu/nl/kernels.py:1728-1758).  The polynomial kernel raises:
    the JAX factory gives it a = 0 (infinite values)."""
    hv = float(horizon)
    if kernel == POLYNOMIAL:
        raise NotImplementedError(
            'getIntegrableKernel sets the polynomial kernel\'s a to 0 in the '
            'JAX package (infinite values); build Kernel(dim, '
            '"polynomial", horizon, interaction, C, 0.0, exponentParam=a)')
    if interaction is None:
        interaction = fullSpace() if hv == np.inf else ball2()
    if scaling is None:
        scaling = constantIntegrableScaling(
            kernel, interaction, dim, hv, gaussian_variance=gaussian_variance,
            exponentialRate=exponentialRate) if normalized else 0.5
    sing = {INDICATOR: 0.0, PERIDYNAMIC: -1.0, GAUSSIAN: 0.0,
            EXPONENTIAL: 0.0, LOGINVERSEDISTANCE: 0.0}[kernel]
    exponentParam = 0.0
    if kernel == GAUSSIAN:
        exponentParam = (1.0 / (hv / 3.0) ** 2 if hv < np.inf
                         else 0.5 / gaussian_variance ** dim)
    elif kernel == EXPONENTIAL:
        exponentParam = exponentialRate
    return Kernel(dim, kernel, hv, interaction, scaling, sing,
                  exponentParam=exponentParam,
                  variance=gaussian_variance).setTwoPoint(phi)


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
                 scaling=1.0, greensLambda=1.0j, phi=None):
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
        self.setTwoPoint(phi)

    def profileParams(self):
        lam, C = self.greensLambda, self.scalingValue
        w = self.weightParams()
        if self.kernelType == GREENS_2D:
            return Profile(GREENS_2D_PROFILE, C, 0.0, -lam.imag, wcode=w[0],
                           wlam=w[1])
        return Profile(GREENS_3D_PROFILE, C, lam.imag, lam.real, wcode=w[0],
                       wlam=w[1])

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
        if self.phi is not None:
            val = val * float(self.phi.evalPairs(x, y)[0])
        return complex(val)

    def _key(self):
        return super()._key() + (self.greensLambda,)

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
    """The complex Greens kernel ``kernel`` (GREENS_2D or GREENS_3D), with
    the two-point weight ``phi``."""
    return ComplexKernel(dim, kernel, horizon=horizon,
                         interaction=interaction, scaling=scaling,
                         greensLambda=greensLambda, phi=phi)


def getKernel(dim, kernel=FRACTIONAL, **kwargs):
    """The kernel of type ``kernel`` (pynucleus_tpu/nl/kernels.py
    getKernel): fractional, the Greens kernels, or an integrable one."""
    if kernel == FRACTIONAL:
        return getFractionalKernel(dim, **kwargs)
    if kernel in (GREENS_2D, GREENS_3D):
        return getComplexKernel(dim, kernel=kernel, **kwargs)
    return getIntegrableKernel(dim, kernel=kernel, **kwargs)


kernelFactory = factory()
kernelFactory.register(FRACTIONAL, getFractionalKernel)
kernelFactory.register(GREENS_2D, lambda dim, **kw: getComplexKernel(
    dim, kernel=GREENS_2D, **kw))
kernelFactory.register(GREENS_3D, lambda dim, **kw: getComplexKernel(
    dim, kernel=GREENS_3D, **kw))


def profileArgs(prof):
    """(code, C, e, a, C1, C2, t, wcode, wlam) of a :class:`Profile` as the
    C entry points take them; anything else (such as a bare (C, e)), a
    tempering of a profile that takes none or an unknown two-point code
    raises."""
    if not isinstance(prof, Profile) or int(prof.code) not in PROFILE_CODES:
        raise ValueError(f'a radial Profile (code, C, e, a, C1, C2, t, '
                         f'wcode, wlam) is expected, got {prof!r}')
    if float(prof.t) != 0.0 and int(prof.code) not in TEMPERED_PROFILES:
        raise ValueError(f'profile {prof.code}: only the power and '
                         'power-log profiles are tempered')
    if int(prof.wcode) not in (TWO_POINT_NONE, TWO_POINT_TEMPERED):
        raise ValueError(f'two-point code {prof.wcode}: 0 (none) or 1 '
                         '(tempered)')
    return (int(prof.code), float(prof.C), float(prof.e), float(prof.a),
            float(prof.C1), float(prof.C2), float(prof.t), int(prof.wcode),
            float(prof.wlam))


def _twoPoint(val, r2s, wcode, wlam):
    """val times the smooth two-point weight at r2s = |x-y|^2: exp(-wlam
    |x-y|) for TWO_POINT_TEMPERED (temperedTwoPoint.jaxEval after the
    kernel's value, pynucleus_tpu/nl/assembly.py:58-62), else val."""
    if wcode == TWO_POINT_TEMPERED:
        return val * torch.exp(-wlam * torch.sqrt(r2s))
    return val


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
    Kernel._radialJax: the same operations in the same order, the power
    and power-log values times exp(-t r) where t != 0 (the tempering), then
    times the smooth two-point weight of (wcode, wlam).  The complex
    profiles give complex128 values (ComplexKernel._radialJax):

        GREENS_2D  C (-Y0(a r) + i J0(a r))          (besselJ0Y0)
        GREENS_3D  C exp(-a r) (cos(e r) - i sin(e r)) / r"""
    code, C, e, a, C1, C2, t, wcode, wlam = profileArgs(prof)
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
        val = _twoPoint(val, r2s, wcode, wlam)
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
    elif code == LOG_INVERSE_DISTANCE_PROFILE:
        val = C * torch.log(1.0 / torch.sqrt(r2s))
    elif code == POLYNOMIAL_PROFILE:
        q = 1.0 - r2s / a ** 2
        val = C * (q * q)
    else:
        r = torch.sqrt(r2s)
        val = C * torch.exp(-a * r) * (r / a + 1.0 / a ** 2) / r
    if t != 0.0:
        val = val * torch.exp(-t * torch.sqrt(r2s))
    val = _twoPoint(val, r2s, wcode, wlam)
    return torch.where(pos, val, 0.0)


def _orderNorm(order):
    """pi^(d/2), d/2 and the exponent base (-d/2, or (1-d)/2 for the
    boundary kernel) of an :class:`OrderParams`, formed on the host as the
    JAX expression forms them from Python floats."""
    d = order.dim
    eBase = 0.5 * (1.0 - d) if order.boundary else -0.5 * d
    return float(np.pi ** (0.5 * d)), float(0.5 * d), float(eBase)


def orderArgs(order, device=None):
    """(code, sll, srr, slr, srl, interface, piD2, halfDim, eBase, boundary,
    xdim, g0, g1, g2, g3, table, n, lo0, lo1, hi0, hi1) of an
    :class:`OrderParams` (or None) as every C entry point that takes an
    order takes it (common.cuh ORDER_PARAMS): :func:`_orderNorm`'s host
    values, the order of position's point dimension, its constants g and
    its table (a pointer to the copy on ``device``, which an order with a
    table needs; None without one) with fe's box."""
    if order is None:
        return (ORDER_NONE, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0, 0,
                0.0, 0.0, 0.0, 0.0, None, 0, 0.0, 0.0, 0.0, 0.0)
    if not isinstance(order, OrderParams) or int(order.code) not in \
            ORDER_CODES:
        raise ValueError(f'an OrderParams is expected, got {order!r}')
    table = None
    if order.table is not None:
        if device is None:
            raise ValueError('orderArgs: an order with a table needs the '
                             'device of its copy')
        table = ctypes.c_void_p(order.table.on(device).data_ptr())
    g = tuple(float(v) for v in order.g) + (0.0,) * (4 - len(order.g))
    lo = tuple(float(v) for v in order.lo) + (0.0,) * (2 - len(order.lo))
    hi = tuple(float(v) for v in order.hi) + (0.0,) * (2 - len(order.hi))
    return (int(order.code), float(order.sll), float(order.srr),
            float(order.slr), float(order.srl), float(order.interface),
            *_orderNorm(order), int(bool(order.boundary)), int(order.dim),
            *g, table, int(order.n), *lo, *hi)


def _horizonConsts(horizon):
    """The host constants of variableHorizonFractionalKernel.evalXY, formed
    from Python floats as the JAX expression forms them: 2 - 2s, 2s - 2, d,
    Gamma(d/2) (scipy's), pi^(d/2) and the exponent -d/2 - s."""
    s, d = float(horizon.s), int(horizon.dim)
    return (2.0 - 2.0 * s, 2.0 * s - 2.0, float(d), float(Gamma(0.5 * d)),
            float(np.pi ** (0.5 * d)), -0.5 * d - s)


def horizonArgs(horizon):
    """(on, c0, c, min, max, 2 - 2s, 2s - 2, d, Gamma(d/2), pi^(d/2),
    -d/2 - s, normalized) of a :class:`HorizonParams` as K19's entry points
    take them (on = 0 and zeros for None)."""
    if horizon is None:
        return (0,) + (0.0,) * 10 + (0,)
    return (1, *(float(v) for v in horizon[:4]), *_horizonConsts(horizon),
            int(bool(horizon.normalized)))


def _mixedOrderT(xi, yi, order, v):
    """The torch.where nest of the two-region orders (innerOuter, islands):
    sll in-in, srr out-out, slr / srl across."""
    return torch.where(xi & yi, v(order.sll),
                       torch.where(~xi & ~yi, v(order.srr),
                                   torch.where(xi, v(order.slr),
                                               v(order.srl))))


def _smoothstepT(t):
    """3 t^2 - 2 t^3 of t clipped to [0, 1], t^3 as t (t t): the JAX
    expression's integer powers (t ** 3 is lax.integer_pow, x (x x))."""
    t = torch.clamp(t, 0.0, 1.0)
    return 3.0 * (t * t) - 2.0 * (t * (t * t))


def _feRaster(x, order):
    """feFractionalOrder.jaxEval: the raster [n] or [n, n] (order.table)
    at x [..., dim], multilinear, t clipped to the box and the cell index
    to [0, n-2], in the JAX expression's order."""
    n = int(order.n)
    g = order.table.on(x.device).to(x.dtype)
    lo = torch.tensor(order.lo, dtype=x.dtype, device=x.device)
    hi = torch.tensor(order.hi, dtype=x.dtype, device=x.device)
    t = torch.clamp((x - lo) / (hi - lo), 0.0, 1.0) * (n - 1)
    i0 = torch.clamp(torch.floor(t).to(torch.int32), 0, n - 2)
    f = t - i0
    i0 = i0.long()
    if x.shape[-1] == 1:
        i, fx = i0[..., 0], f[..., 0]
        return (1 - fx) * g[i] + fx * g[i + 1]
    i, j = i0[..., 0], i0[..., 1]
    fx, fy = f[..., 0], f[..., 1]
    return ((1 - fx) * (1 - fy) * g[i * n + j]
            + fx * (1 - fy) * g[(i + 1) * n + j]
            + (1 - fx) * fy * g[i * n + j + 1]
            + fx * fy * g[(i + 1) * n + j + 1])


def orderEval(x, y, order):
    """s(x, y) [...] of an :class:`OrderParams` at x, y [..., dim]: each
    order's jaxEval (pynucleus_tpu/nl/kernels.py:115-475), the same
    comparisons and operations in the same order (common.cuh orderAt is
    its copy on the card)."""
    shape = torch.broadcast_shapes(x.shape[:-1], y.shape[:-1])

    def v(a):
        return torch.tensor(float(a), dtype=x.dtype, device=x.device)
    code = int(order.code)
    if code == ORDER_CONST:
        return torch.full(shape, float(order.sll), dtype=x.dtype,
                          device=x.device)
    if code == ORDER_LEFT_RIGHT:
        return _mixedOrderT(x[..., 0] < order.interface,
                            y[..., 0] < order.interface, order, v)
    g = order.g
    if code == ORDER_INNER_OUTER:
        c = torch.tensor(g[:x.shape[-1]], dtype=x.dtype, device=x.device)
        return _mixedOrderT(((x - c) ** 2).sum(-1) < g[2],
                            ((y - c) ** 2).sum(-1) < g[2], order, v)
    if code == ORDER_ISLANDS:
        def inIsland(p):
            p = p.abs()
            return ((p >= g[0]) & (p <= g[1])).all(-1)
        return _mixedOrderT(inIsland(x), inIsland(y), order, v)
    if code == ORDER_LAYERS:
        nL = int(order.n)
        tab = order.table.on(x.device).to(x.dtype)
        edges = tab[:nL - 1].contiguous()
        orders = tab[nL - 1:]

        def layer(p):
            c = p[..., -1].contiguous()
            idx = torch.searchsorted(edges, c, right=True)
            return torch.clamp(idx, 0, nL - 1)
        I, J = torch.broadcast_tensors(layer(x), layer(y))
        return orders[I * nL + J]
    if code == ORDER_SMOOTHED_LR:
        t = (x[..., 0] - g[0]) * g[1] + 0.5
        val = order.sll + (order.srr - order.sll) * _smoothstepT(t)
    elif code == ORDER_LINEAR_LR:
        t = torch.clamp((x[..., 0] - g[0] + g[1]) / g[2], 0.0, 1.0)
        val = order.sll + (order.srr - order.sll) * t
    elif code == ORDER_SMOOTHED_IO:
        rr = torch.sqrt((x ** 2).sum(-1))
        t = (rr - g[0]) * g[1] + 0.5
        val = order.sll + (order.srr - order.sll) * _smoothstepT(t)
    elif code == ORDER_FE:
        val = _feRaster(x, order)
    else:
        raise ValueError(f'order code {code}')
    # the orders of x alone, broadcast to the pairs of (x, y)
    return torch.broadcast_to(val, shape)


def evalXY(x, y, r2, prof, order=None, horizon=None):
    """gamma(x, y) from positions x, y [..., dim] and r2 = |x-y|^2, exactly 0
    where r2 == 0: the radial profile ``prof`` (:func:`radialEval`) if
    ``order`` is None, else the variable-order fractional kernel of
    pynucleus_tpu/nl/kernels.py FractionalKernel.evalXY (infinite horizon),
    the same operations in the same order:

        C = 2^(2s) s / pi^(d/2) * 0.5 * exp(lgamma(s + d/2) - lgamma(1 - s))
        gamma = C r2^(-d/2 - s), or (C/s) r2^((1-d)/2 - s) (boundary)

    with s = s(x, y) (:func:`orderEval`) and torch.lgamma for gammaln; with
    a variable ``horizon`` (:class:`HorizonParams`, no order) the kernel of
    variableHorizonFractionalKernel.evalXY, delta = delta(x)
    (:meth:`horizonFunction.eval`):

        C = (2 - 2s) delta^(2s-2) d Gamma(d/2) / pi^(d/2) * 0.5  (or 0.5)
        gamma = C r2^(-d/2 - s) where r2 <= delta^2, else 0."""
    pos = r2 > 0
    r2s = torch.where(pos, r2, 1.0)
    if horizon is not None:
        a, e, d, G, piD2, expo = _horizonConsts(horizon)
        delta = horizonFunction(*horizon[:4]).eval(x)
        C = a * delta ** e * d * G / piD2 * 0.5 if horizon.normalized \
            else 0.5
        val = torch.where(r2s <= delta * delta, C * r2s ** expo, 0.0)
        return torch.where(pos, val, 0.0)
    if order is None:
        return radialEval(r2, prof)
    if int(order.code) == ORDER_COMPONENT:
        return componentTerms(x, y, r2, order)[0]
    piD2, halfDim, eBase = _orderNorm(order)
    boundary = bool(order.boundary)
    sv = orderEval(x, y, order)
    C = (2.0 ** (2 * sv) * sv / piD2 * 0.5 *
         torch.exp(torch.lgamma(sv + halfDim) - torch.lgamma(1.0 - sv)))
    if boundary:
        val = (C / sv) * r2s ** (eBase - sv)
    else:
        val = C * r2s ** (eBase - sv)
    _, _, _, _, _, _, _, wcode, wlam = profileArgs(prof)
    val = _twoPoint(val, r2s, wcode, wlam)
    return torch.where(pos, val, 0.0)

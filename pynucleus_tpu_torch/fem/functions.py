"""Function objects for right-hand sides and analytic solutions (host numpy).

Carried over from pynucleus_tpu/fem/functions.py.  Functions are evaluated
only at setup time (interpolation nodes, quadrature points) over X [N, dim];
the results go to the device as tensors.  Sums, differences and products of
functions (and of functions and numbers) are functions, as the JAX
package's indicator arithmetic of the finite-horizon problems needs.
"""
from __future__ import annotations

import numpy as np
from scipy.special import gamma as Gamma

__all__ = ['function', 'constant', 'Lambda', 'squareIndicator',
           'radialIndicator', 'solFractional']


class function:
    def __call__(self, X):
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        return self.eval(X)

    def eval(self, X):
        raise NotImplementedError()

    def __add__(self, other):
        return sumFunction(self, asFunction(other))

    def __radd__(self, other):
        return sumFunction(asFunction(other), self)

    def __sub__(self, other):
        return sumFunction(self, mulFunction(asFunction(other), -1.0))

    def __rsub__(self, other):
        return sumFunction(asFunction(other), mulFunction(self, -1.0))

    def __mul__(self, other):
        if isinstance(other, function):
            return prodFunction(self, other)
        return mulFunction(self, other)

    def __rmul__(self, other):
        return mulFunction(self, other)

    def __neg__(self):
        return mulFunction(self, -1.0)


class sumFunction(function):
    def __init__(self, f, g):
        self.f, self.g = f, g

    def eval(self, X):
        return self.f.eval(X) + self.g.eval(X)


class mulFunction(function):
    def __init__(self, f, fac):
        self.f, self.fac = f, fac

    def eval(self, X):
        return self.fac * self.f.eval(X)


class prodFunction(function):
    def __init__(self, f, g):
        self.f, self.g = f, g

    def eval(self, X):
        return self.f.eval(X) * self.g.eval(X)


class constant(function):
    def __init__(self, value):
        self.value = value

    def eval(self, X):
        return np.full(X.shape[0], self.value, dtype=np.float64)

    def __repr__(self):
        return f'constant({self.value})'


class Lambda(function):
    """Wrap a per-point python callable f(x) with x [dim]; complex values
    stay complex (complex128), others are float64."""

    def __init__(self, fun):
        self.fun = fun

    def eval(self, X):
        vals = np.array([self.fun(x) for x in X])
        if np.iscomplexobj(vals):
            return vals.astype(np.complex128)
        return vals.astype(np.float64)


class squareIndicator(function):
    """1 on the box a <= x <= b (componentwise), else 0."""

    def __init__(self, a, b):
        self.a = np.asarray(a, dtype=np.float64)
        self.b = np.asarray(b, dtype=np.float64)

    def eval(self, X):
        inside = np.all((X >= self.a[None, :]) & (X <= self.b[None, :]),
                        axis=1)
        return inside.astype(np.float64)


class radialIndicator(function):
    def __init__(self, radius, center=None):
        self.radius = radius
        self.center = center

    def eval(self, X):
        c = self.center if self.center is not None else np.zeros(X.shape[1])
        r = np.linalg.norm(X - c[None, :], axis=1)
        return (r <= self.radius).astype(np.float64)


class solFractional(function):
    """Analytic solution of (-Delta)^s u = 1 on the unit ball, u=0 outside:
    u(x) = 2^{-2s} Gamma(d/2)/Gamma((d+2s)/2)/Gamma(1+s) (1-|x|^2)_+^s."""

    def __init__(self, s, dim, radius=1.0):
        self.s = s
        self.dim = dim
        self.radius = radius
        self.C = 2.0 ** (-2.0 * s) * Gamma(dim / 2.0) \
            / Gamma((dim + 2.0 * s) / 2.0) / Gamma(1.0 + s)

    def eval(self, X):
        r2 = np.sum(X ** 2, axis=1) / self.radius ** 2
        val = np.maximum(1.0 - r2, 0.0) ** self.s
        return self.C * self.radius ** (2.0 * self.s) * val


def asFunction(f):
    if isinstance(f, function):
        return f
    if np.isscalar(f):
        return constant(f)
    if callable(f):
        return Lambda(f)
    raise TypeError(f)

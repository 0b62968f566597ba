"""Fractional kernel gamma(x, y) = C |x-y|^{-d-2s} (constant order).

Port of the constant-order, infinite-horizon part of
pynucleus_tpu/nl/kernels.py (FractionalKernel, constFractionalOrder,
constantFractionalLaplacianScaling, getFractionalKernel and the boundary
kernel of the zero-exterior term).  The device kernels evaluate the radial
profile gamma(r2) = C * r2^(singularity/2) from (C, singularity/2), with
gamma = 0 at r2 = 0 exactly as ``_radial_eval`` (nl/assembly.py) does.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.special import gamma as Gamma

__all__ = ['constFractionalOrder', 'FractionalKernel', 'getFractionalKernel',
           'constantFractionalLaplacianScaling', 'radialEval']


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


def constantFractionalLaplacianScaling(dim, s, horizon):
    """Normalization so the operator converges to -Laplacian (infinite
    horizon; includes the bilinear-form 1/2)."""
    if 1.0 < s < 2.0:
        s = s - 1.0
    if horizon <= 0 or s <= 0 or s >= 1:
        return np.nan
    if horizon != np.inf:
        raise NotImplementedError('finite horizon')
    return 2.0 ** (2.0 * s) * s * Gamma(s + 0.5 * dim) \
        / np.pi ** (0.5 * dim) / Gamma(1.0 - s) * 0.5


class FractionalKernel:
    """gamma(x,y) = scaling * |x-y|^{singularity}, singularity = -d-2s
    (boundary kernel: 1-d-2s).  Infinite horizon, full-space interaction,
    constant order: the class of kernels the dense grid path assembles."""

    kernelType = 'fractional'
    isComplex = False
    variable = False
    variableOrder = False
    complement = False
    finiteHorizon = False
    symmetric = True
    phi = None

    def __init__(self, dim, s, scaling=None, boundary=False):
        if not isinstance(s, constFractionalOrder):
            s = constFractionalOrder(s)
        self.dim = dim
        self.s = s
        self.horizonValue = np.inf
        self.boundary = boundary
        if scaling is None:
            scaling = constantFractionalLaplacianScaling(dim, s.value, np.inf)
        self.scalingValue = float(scaling)
        self.singularityValue = float((1 if boundary else 0) - dim - 2 * s.value)
        self.min_singularity = (1 if boundary else 0) - dim - 2 * s.max
        self.max_singularity = (1 if boundary else 0) - dim - 2 * s.min

    def getSingularityValue(self):
        return self.singularityValue

    def radialParams(self):
        """(C, e) of gamma(r2) = C * r2**e, the device kernels' parameters."""
        return self.scalingValue, 0.5 * self.singularityValue

    def getModifiedKernel(self, horizon=None):
        if horizon is not None and float(horizon) != np.inf:
            raise NotImplementedError('finite horizon')
        return self

    def getBoundaryKernel(self):
        """Kernel of the Gauss-theorem surface term: scaling / s and
        singularity 1-d-2s."""
        return FractionalKernel(self.dim, self.s,
                                scaling=self.scalingValue / self.s.value,
                                boundary=True)

    def __repr__(self):
        return (f'kernel({self.kernelType}, d={self.dim}, '
                f'horizon={self.horizonValue}, C={self.scalingValue:.6g}, '
                f'sing={self.singularityValue})')


def getFractionalKernel(dim, s, scaling=None):
    return FractionalKernel(dim, s, scaling=scaling)


def radialEval(r2, C, e):
    """gamma(r2) = C * r2**e, and exactly 0 where r2 == 0 (coincident
    quadrature points of the singular rules)."""
    pos = r2 > 0
    return torch.where(pos, C * torch.where(pos, r2, 1.0) ** e, 0.0)

"""Singularity-cancelling quadrature rules for element pairs (host build).

Carried over from pynucleus_tpu/nl/quad_singular.py (1D singular rules and
the distant tensor rules, the nonsymmetric tables buildPHI and the 1D
singular rules' log-correction tables lnEta, cw1 and cw2 of the
s-derivative kernels).

Each rule is reduced to STATIC tables for the batched device kernel:
    bary_x [nv1, Q], bary_y [nv2, Q], w [Q], PSI [nPSI, Q]
with the convention that the pair contribution is
    contrib[I, J] = vol1 * vol2 * sum_q w_q * gamma(x_q, y_q) * PSI[I,q] * PSI[J,q]
where x_q = sum_v bary_x[v, q] * simplex1[perm1[v]], etc.  Shared vertices
come FIRST in the permuted simplices (perm handled host-side in panels.py).

PSI row order: [cell1 local dofs (permuted element order), cell2 extra dofs],
where dofs supported on the shared interface appear once (phi_x - phi_y) and
the cell2 duplicate row is identically zero.
"""
from __future__ import annotations

import numpy as np

from ..fem.quadrature import (gauss01, gaussJacobi01, tensorRule,
                              simplexCompact, simplexDuffy, logWeights)

__all__ = ['PanelRule', 'sameCellRule1D', 'vertexRule1D', 'distantRule',
           'boundaryVertexRule1D', 'boundaryDistantRule']


class PanelRule:
    """Static tables for one panel class.

    Singular rules may carry log-correction tables for s-derivative kernels
    (whose integrand has extra ln|x-y| factors that the plain Gauss-Jacobi
    weight does not absorb): ``lnEta`` [Q] = ln of the radial variable(s)
    product per node, and ``cw1``/``cw2`` [Q] such that for an integrand
    F = a + b ln r (+ c ln^2 r) with a,b,c sharing the rule's power-law
    singularity, sum_q w_q F_q + cw1_q (b_q + 2 c_q lnR_q) + cw2_q c_q
    integrates the log factors exactly (lnR = ln r - lnEta is smooth)."""

    def __init__(self, bary_x, bary_y, w, name='', lnEta=None, cw1=None,
                 cw2=None):
        self.bary_x = np.ascontiguousarray(bary_x)   # [nv1, Q]
        self.bary_y = np.ascontiguousarray(bary_y)   # [nv2, Q]
        self.w = np.ascontiguousarray(w)             # [Q]
        self.name = name
        self.lnEta = lnEta
        self.cw1 = cw1
        self.cw2 = cw2


    @property
    def num_nodes(self):
        return self.w.shape[0]

    @staticmethod
    def sharedDofMask(dm, nSharedVertices):
        """Boolean mask over the permuted element's local dofs whose
        interpolation node lies ON the shared sub-simplex spanned by the first
        ``nSharedVertices`` permuted vertices (those dofs are identical global
        dofs in both cells)."""
        nodes = dm.localNodes
        if nSharedVertices == 0:
            return np.zeros(nodes.shape[0], dtype=bool)
        return np.abs(nodes[:, nSharedVertices:]).max(axis=1) < 1e-12 \
            if nSharedVertices < nodes.shape[1] else \
            np.ones(nodes.shape[0], dtype=bool)

    def buildPSI(self, dm, nSharedVertices=0, boundary=False):
        """PSI [nPSI, Q] for a DoFMap's element.  ``nSharedVertices`` =
        number of leading permuted vertices shared between the two cells
        (0 distant, 1 vertex panel, 2 edge panel 2D, m+1 identical)."""
        phi_x = dm.evalPhi(self.bary_x.T)   # [dpe, Q]
        if boundary:
            return phi_x
        phi_y = dm.evalPhi(self.bary_y.T)   # [dpe, Q]
        dpe = phi_x.shape[0]
        mask = self.sharedDofMask(dm, nSharedVertices)
        if mask.all():
            # identical cells: every dof shared
            return phi_x - phi_y
        nPSI = 2 * dpe
        PSI = np.zeros((nPSI, self.num_nodes))
        PSI[:dpe] = phi_x
        PSI[dpe:] = -phi_y
        if mask.any():
            PSI[:dpe][mask] = phi_x[mask] - phi_y[mask]
            PSI[dpe:][mask] = 0.0
        return PSI

    def buildPHI(self, dm, nSharedVertices=0):
        """(PHIx, PHIy) [nPSI, Q] of the nonsymmetric local matrix
        (pynucleus_tpu/nl/quad_singular.py _buildPHI):
          contrib[I,J] = sum_q w [g1(q) PHIx[I,q] - g2(q) PHIy[I,q]]
                                 * (PHIx[J,q] - PHIy[J,q])
        in buildPSI's row order (cell1 dofs, then cell2 dofs; shared dofs on
        the cell1 row, cell2 duplicates zero)."""
        phi_x = dm.evalPhi(self.bary_x.T)
        phi_y = dm.evalPhi(self.bary_y.T)
        dpe = phi_x.shape[0]
        mask = self.sharedDofMask(dm, nSharedVertices)
        if mask.all():
            return phi_x, phi_y
        PHIx = np.zeros((2 * dpe, self.num_nodes))
        PHIy = np.zeros((2 * dpe, self.num_nodes))
        PHIx[:dpe] = phi_x
        PHIy[dpe:] = phi_y
        if mask.any():
            PHIy[:dpe][mask] = phi_y[mask]
            PHIy[dpe:][mask] = 0.0
        return PHIx, PHIy


# --------------------------------------------------------------------- 1D --

def sameCellRule1D(singularity, order):
    """Identical-cell panel, 1D (ref fractionalLaplacian1D.pyx:48-82).
    ``singularity`` is the kernel exponent (-1-2s); the integrand cancels 2
    orders, sigma = 2 + singularity."""
    sigma = 2.0 + singularity
    x0, w0 = gaussJacobi01(order, 1.0 + sigma, 0.0)
    x1, w1 = gaussJacobi01(order, sigma, 0.0)
    nodes, w = tensorRule((x0, w0), (x1, w1))
    eta0, eta1 = nodes[:, 0], nodes[:, 1]
    x = eta0 * (1 - eta1)
    y = eta0
    bary_x = np.stack([1 - x, x], axis=0)
    bary_y = np.stack([1 - y, y], axis=0)
    comp = (eta0 * eta1) ** (-sigma)
    weights = 2.0 * w * comp
    # log-correction tables: |x-y| = eta0*eta1*h, weight exponents
    # (1+sigma, sigma) per axis
    u0 = logWeights(x0, 1.0 + sigma, 1)
    u1 = logWeights(x1, sigma, 1)
    v0 = logWeights(x0, 1.0 + sigma, 2)
    v1 = logWeights(x1, sigma, 2)
    lnEta = np.log(eta0) + np.log(eta1)
    wlog1 = _tensorW((x0, u0), (x1, w1)) + _tensorW((x0, w0), (x1, u1))
    wlog2 = (_tensorW((x0, v0), (x1, w1)) + 2.0 * _tensorW((x0, u0), (x1, u1))
             + _tensorW((x0, w0), (x1, v1)))
    cw1 = 2.0 * wlog1 * comp - weights * lnEta
    cw2 = 2.0 * wlog2 * comp - weights * lnEta ** 2
    return PanelRule(bary_x, bary_y, weights, 'sameCell1D',
                     lnEta=lnEta, cw1=cw1, cw2=cw2)


def _tensorW(*rules):
    """Tensor-product weights only (same node ordering as tensorRule)."""
    w = np.ones(1)
    wg = np.meshgrid(*[r[1] for r in rules], indexing='ij')
    w = np.ones(wg[0].size)
    for g in wg:
        w = w * g.ravel()
    return w


def vertexRule1D(singularity, order_sing, order_reg, continuous=True,
                 cancellation=None):
    """Common-vertex panel, 1D (ref fractionalLaplacian1D.pyx:83-141).
    Shared vertex is local 0 of BOTH permuted simplices.  sigma = 2+sing for
    continuous elements, 0+sing for P0.

    ``cancellation`` overrides the vanishing-order count: the one-sided
    terms of a nonsym kernel whose two orderings have DIFFERENT singular
    exponents (variable order with a jump interface) only carry ONE
    vanishing factor (the trial difference), so their split evaluation uses
    cancellation=1 (the reference's combined rule assumes 2 across elements,
    fractionalLaplacian1D.pyx:216, which under-resolves such panels)."""
    if cancellation is None:
        cancellation = 2.0 if continuous else 0.0
    sigma = cancellation + singularity
    x0, w0 = gaussJacobi01(order_reg, 1.0 + sigma, 0.0)
    x1, w1 = gauss01(order_sing)
    nodes, w = tensorRule((x0, w0), (x1, w1))
    eta0, eta1 = nodes[:, 0], nodes[:, 1]
    xs, ys, ws = [], [], []
    # subdomain 1: x = eta0*eta1, y = eta0;  subdomain 2: swapped
    for (x, y) in ((eta0 * eta1, eta0), (eta0, eta0 * eta1)):
        xs.append(np.stack([1 - x, x], axis=0))
        ys.append(np.stack([1 - y, y], axis=0))
        ws.append(w * eta0 ** (-sigma))
    bary_x = np.concatenate(xs, axis=1)
    bary_y = np.concatenate(ys, axis=1)
    weights = np.concatenate(ws)
    # log correction: |x-y| scales with eta0 only (radial variable)
    u0 = logWeights(x0, 1.0 + sigma, 1)
    v0 = logWeights(x0, 1.0 + sigma, 2)
    comp = eta0 ** (-sigma)
    lnEta1 = np.log(eta0)
    cw1s = _tensorW((x0, u0), (x1, w1)) * comp - w * comp * lnEta1
    cw2s = _tensorW((x0, v0), (x1, w1)) * comp - w * comp * lnEta1 ** 2
    lnEta = np.concatenate([lnEta1, lnEta1])
    cw1 = np.concatenate([cw1s, cw1s])
    cw2 = np.concatenate([cw2s, cw2s])
    return PanelRule(bary_x, bary_y, weights, 'vertex1D',
                     lnEta=lnEta, cw1=cw1, cw2=cw2)


def distantRule(order, mdim1, mdim2=None, compact=True):
    """Tensor product of two compact symmetric simplex rules; the point
    count enters the pair cost as Q1*Q2.  ``compact=False`` takes the
    simplexDuffy tensor rules instead (pynucleus_tpu/nl/quad_singular.py
    distantRule): the pairs of the indicator fallback, whose integrand
    carries the discontinuous horizon indicator, where the point count sets
    the accuracy."""
    if mdim2 is None:
        mdim2 = mdim1
    rule = simplexCompact if compact else simplexDuffy
    b1, w1 = rule(order, mdim1)
    b2, w2 = rule(order, mdim2)
    Q1, Q2 = w1.shape[0], w2.shape[0]
    bary_x = np.repeat(b1.T, Q2, axis=1)                  # [nv1, Q1*Q2]
    bary_y = np.tile(b2.T, (1, Q1))                       # [nv2, Q1*Q2]
    w = (w1[:, None] * w2[None, :]).ravel()
    return PanelRule(bary_x, bary_y, w, f'distant{order}')


def boundaryVertexRule1D(singularity, order):
    """Cell x touching-boundary-vertex panel (ref
    fractionalLaplacian1D.pyx:144-179,671-709).  singularity here is the
    BOUNDARY kernel exponent (1-d-2s = -2s in 1D)."""
    if singularity > -1.0 + 1e-3:
        sigma = singularity
    else:
        sigma = 2.0 + singularity
    # floor: the moment-matched log-correction weights (cw1/cw2) only
    # integrate smooth factors up to degree n-1, so tiny-mesh diagonal
    # orders (the reference formula can give 2) would break s-derivative
    # kernels; a handful of extra nodes on the few boundary panels is free
    eta, w = gaussJacobi01(max(order, 8), sigma, 0.0)
    bary_x = np.stack([1 - eta, eta], axis=0)
    bary_y = np.ones((1, len(eta)))
    comp = eta ** (-sigma)
    weights = w * comp
    lnEta = np.log(eta)
    cw1 = logWeights(eta, sigma, 1) * comp - weights * lnEta
    cw2 = logWeights(eta, sigma, 2) * comp - weights * lnEta ** 2
    return PanelRule(bary_x, bary_y, weights, 'bndVertex1D',
                     lnEta=lnEta, cw1=cw1, cw2=cw2)


def boundaryDistantRule(order, mdim1, mdim2):
    """Cell x distant-surface-simplex rule."""
    b1, w1 = simplexCompact(order, mdim1)
    if mdim2 == 0:
        b2, w2 = np.ones((1, 1)), np.ones(1)
    else:
        b2, w2 = simplexCompact(order, mdim2)
    Q1, Q2 = w1.shape[0], w2.shape[0]
    bary_x = np.repeat(b1.T, Q2, axis=1)
    bary_y = np.tile(b2.T, (1, Q1))
    w = (w1[:, None] * w2[None, :]).ravel()
    return PanelRule(bary_x, bary_y, w, f'bndDistant{order}')

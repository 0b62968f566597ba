"""Singularity-cancelling quadrature rules for element pairs (host build).

Carried over from pynucleus_tpu/nl/quad_singular.py (1D singular rules and
the distant tensor rules, and the nonsymmetric tables buildPHI), without
the log-correction tables of the s-derivative kernels, which the port does
not assemble yet.

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

from ..fem.quadrature import gauss01, gaussJacobi01, tensorRule, simplexCompact

__all__ = ['PanelRule', 'sameCellRule1D', 'vertexRule1D', 'distantRule',
           'boundaryVertexRule1D', 'boundaryDistantRule']


class PanelRule:
    """Static tables for one panel class."""

    def __init__(self, bary_x, bary_y, w, name=''):
        self.bary_x = np.ascontiguousarray(bary_x)   # [nv1, Q]
        self.bary_y = np.ascontiguousarray(bary_y)   # [nv2, Q]
        self.w = np.ascontiguousarray(w)             # [Q]
        self.name = name

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
    """Identical-cell panel, 1D.  ``singularity`` is the kernel exponent
    (-1-2s); the integrand cancels 2 orders, sigma = 2 + singularity."""
    sigma = 2.0 + singularity
    x0, w0 = gaussJacobi01(order, 1.0 + sigma, 0.0)
    x1, w1 = gaussJacobi01(order, sigma, 0.0)
    nodes, w = tensorRule((x0, w0), (x1, w1))
    eta0, eta1 = nodes[:, 0], nodes[:, 1]
    x = eta0 * (1 - eta1)
    y = eta0
    bary_x = np.stack([1 - x, x], axis=0)
    bary_y = np.stack([1 - y, y], axis=0)
    weights = 2.0 * w * (eta0 * eta1) ** (-sigma)
    return PanelRule(bary_x, bary_y, weights, 'sameCell1D')


def vertexRule1D(singularity, order_sing, order_reg, continuous=True,
                 cancellation=None):
    """Common-vertex panel, 1D.  Shared vertex is local 0 of BOTH permuted
    simplices.  sigma = 2+sing for continuous elements, 0+sing for P0.

    ``cancellation`` overrides the vanishing-order count: the one-sided
    terms of a nonsymmetric kernel whose two orderings have different
    singular exponents carry one vanishing factor only, so their split
    evaluation uses cancellation=1 (pynucleus_tpu/nl/quad_singular.py
    vertexRule1D)."""
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
    return PanelRule(np.concatenate(xs, axis=1), np.concatenate(ys, axis=1),
                     np.concatenate(ws), 'vertex1D')


def distantRule(order, mdim1, mdim2=None):
    """Tensor product of two compact symmetric simplex rules; the point
    count enters the pair cost as Q1*Q2."""
    if mdim2 is None:
        mdim2 = mdim1
    b1, w1 = simplexCompact(order, mdim1)
    b2, w2 = simplexCompact(order, mdim2)
    Q1, Q2 = w1.shape[0], w2.shape[0]
    bary_x = np.repeat(b1.T, Q2, axis=1)                  # [nv1, Q1*Q2]
    bary_y = np.tile(b2.T, (1, Q1))                       # [nv2, Q1*Q2]
    w = (w1[:, None] * w2[None, :]).ravel()
    return PanelRule(bary_x, bary_y, w, f'distant{order}')


def boundaryVertexRule1D(singularity, order):
    """Cell x touching-boundary-vertex panel.  singularity here is the
    BOUNDARY kernel exponent (1-d-2s = -2s in 1D)."""
    if singularity > -1.0 + 1e-3:
        sigma = singularity
    else:
        sigma = 2.0 + singularity
    # at least 8 nodes: the JAX package raises tiny-mesh diagonal orders
    # the same way, and the node tables must agree
    eta, w = gaussJacobi01(max(order, 8), sigma, 0.0)
    bary_x = np.stack([1 - eta, eta], axis=0)
    bary_y = np.ones((1, len(eta)))
    return PanelRule(bary_x, bary_y, w * eta ** (-sigma), 'bndVertex1D')


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

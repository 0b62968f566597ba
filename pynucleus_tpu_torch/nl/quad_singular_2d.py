"""2D singularity-cancelling quadrature rules for triangle pairs.

Carried over from pynucleus_tpu/nl/quad_singular_2d.py (numpy host code,
with the one-sided cancellation option of the nonsymmetric kernels'
mixed-singularity panels).  The
transformations are the classical Sauter-Schwab-type collapsed-coordinate
decompositions of the 4D product domain T x T:
  - COMMON_FACE: 3 subdomains (x6 symmetry -> weight 2), Jacobian
    eta0^3 eta1^2 eta2, singular distance r = eta0*eta1*eta2 * rho(eta3)
  - COMMON_EDGE: 4 subdomains, Jacobians eta0^3 eta1^2 (,*eta2), r ~ eta0*eta1
  - COMMON_VERTEX: 2 subdomains, Jacobian eta0^3, r ~ eta0
The Gauss-Jacobi weights absorb the Jacobian powers plus ``sigma`` orders of
the kernel singularity (sigma = 2 + kernel singularity for elements that
cancel 2 orders; 0 + ... for P0 across elements), and the node weights carry
the compensation factor r^{-sigma} evaluated analytically.

Convention: shared vertices come FIRST in both permuted simplices, matched in
order.  Barycentric layout is (1-x1, x1-x2, x2).
"""
from __future__ import annotations

import numpy as np

from ..fem.quadrature import gaussJacobi01, tensorRule
from .quad_singular import PanelRule

__all__ = ['sameCellRule2DSS', 'edgeRule2DSS', 'vertexRule2DSS',
           'boundaryEdgeRule2DSS', 'boundaryVertexRule2DSS']


def _bary3(x1, x2):
    return np.stack([1 - x1, x1 - x2, x2], axis=0)


def _bary2(y1):
    return np.stack([1 - y1, y1], axis=0)


def sameCellRule2DSS(singularity, order_unused, quad_order_diagonal,
                     radialOrder=1):
    """Identical-triangle panel (ref fractionalLaplacian2D.pyx:53-172).
    ``singularity`` is the kernel exponent; cancellation sigma = 2 + it.
    radialOrder=1 matches the reference (exact for P1); raise for P2/P3."""
    sigma = 2.0 + singularity
    r0 = gaussJacobi01(radialOrder, 3.0 + sigma, 0.0)
    r1 = gaussJacobi01(radialOrder, 2.0 + sigma, 0.0)
    r2 = gaussJacobi01(radialOrder, 1.0 + sigma, 0.0)
    r3 = gaussJacobi01(quad_order_diagonal, 0.0, 0.0)
    nodes, w = tensorRule(r0, r1, r2, r3)
    e0, e1, e2, e3 = nodes.T
    maps = [
        # (x1, x2, y1, y2) per subdomain
        (e0, e0 * e1 * (1 - e2 + e2 * e3), e0 * (1 - e1 * e2), e0 * e1 * (1 - e2)),
        (e0, e0 * e1, e0 * (1 - e1 * e2 * e3), e0 * e1 * (1 - e2)),
        (e0, e0 * e1 * (1 - e2), e0 * (1 - e1 * e2 * e3), e0 * e1 * (1 - e2 * e3)),
    ]
    bxs, bys, ws = [], [], []
    comp = (e0 * e1 * e2) ** (-sigma)
    for (x1, x2, y1, y2) in maps:
        bxs.append(_bary3(x1, x2))
        bys.append(_bary3(y1, y2))
        ws.append(2.0 * w * comp)
    return PanelRule(np.concatenate(bxs, axis=1), np.concatenate(bys, axis=1),
                     np.concatenate(ws), 'sameCell2D')


def edgeRule2DSS(singularity, order_unused, quad_order_diagonal,
                 continuous=True, radialOrder=1, cancellation=None):
    """Common-edge panel (ref fractionalLaplacian2D.pyx:173-320).  Shared edge
    = permuted vertices (0, 1) of both triangles, matched in order.
    ``cancellation`` overrides the vanishing-order count (see
    quad_singular.vertexRule1D: one-sided terms of mixed-singularity nonsym
    panels use 1)."""
    if cancellation is None:
        cancellation = 2.0 if continuous else 0.0
    sigma = cancellation + singularity
    rA0 = gaussJacobi01(radialOrder, 3.0 + sigma, 0.0)
    rA1 = gaussJacobi01(radialOrder, 2.0 + sigma, 0.0)
    qd = quad_order_diagonal
    rQ0 = gaussJacobi01(qd, 0.0, 0.0)
    rQ1 = gaussJacobi01(qd, 1.0, 0.0)

    bxs, bys, ws = [], [], []

    # subdomains 0, 1 (Jacobian eta0^3 eta1^2)
    nodes, w = tensorRule(rA0, rA1, rQ0, rQ0)
    e0, e1, e2, e3 = nodes.T
    comp = (e0 * e1) ** (-sigma)
    for (x1, x2, y1, y2) in [
            (e0 * (1 - e1 * e2), e0 * e1 * (1 - e2), e0, e0 * e1 * e3),
            (e0, e0 * e1 * e3, e0 * (1 - e1 * e2), e0 * e1 * (1 - e2))]:
        bxs.append(_bary3(x1, x2))
        bys.append(_bary3(y1, y2))
        ws.append(w * comp)

    # subdomains 2, 3 (extra eta2 in Jacobian -> eta2-weighted rule)
    nodes, w = tensorRule(rA0, rA1, rQ1, rQ0)
    e0, e1, e2, e3 = nodes.T
    comp = (e0 * e1) ** (-sigma)
    for (x1, x2, y1, y2) in [
            (e0 * (1 - e1 * e2 * e3), e0 * e1 * e2 * (1 - e3), e0, e0 * e1),
            (e0, e0 * e1, e0 * (1 - e1 * e2 * e3), e0 * e1 * e2 * (1 - e3))]:
        bxs.append(_bary3(x1, x2))
        bys.append(_bary3(y1, y2))
        ws.append(w * comp)

    return PanelRule(np.concatenate(bxs, axis=1), np.concatenate(bys, axis=1),
                     np.concatenate(ws), 'edge2D')


def vertexRule2DSS(singularity, order_unused, quad_order_diagonalV,
                   continuous=True, radialOrder=1, cancellation=None):
    """Common-vertex panel (ref fractionalLaplacian2D.pyx:321-401).  Shared
    vertex = permuted vertex 0 of both triangles.  ``cancellation``: see
    edgeRule2DSS."""
    if cancellation is None:
        cancellation = 2.0 if continuous else 0.0
    sigma = cancellation + singularity
    r0 = gaussJacobi01(radialOrder, 3.0 + sigma, 0.0)
    qv = quad_order_diagonalV
    rQ0 = gaussJacobi01(qv, 0.0, 0.0)
    rQ1 = gaussJacobi01(qv, 1.0, 0.0)
    nodes, w = tensorRule(r0, rQ0, rQ1, rQ0)
    e0, e1, e2, e3 = nodes.T
    comp = e0 ** (-sigma)
    bxs, bys, ws = [], [], []
    for (x1, x2, y1, y2) in [
            (e0, e0 * e1, e0 * e2, e0 * e2 * e3),
            (e0 * e2, e0 * e2 * e3, e0, e0 * e1)]:
        bxs.append(_bary3(x1, x2))
        bys.append(_bary3(y1, y2))
        ws.append(w * comp)
    return PanelRule(np.concatenate(bxs, axis=1), np.concatenate(bys, axis=1),
                     np.concatenate(ws), 'vertex2D')


def boundaryEdgeRule2DSS(singularity, quad_order_diagonal, order_regular):
    """Cell x its-own-boundary-edge panel for the zeroExterior surface term
    (ref fractionalLaplacian2D.pyx:417-501).  ``singularity`` is the BOUNDARY
    kernel exponent, shifted by +2 by the caller when <= -1 (the PHI products
    of interior dofs supply the cancellation).  Shared edge = permuted
    vertices (0,1) of the cell = the surface simplex (matched order)."""
    sigma = singularity
    r0 = gaussJacobi01(order_regular, 1.0 + sigma, 1.0)
    rQ = gaussJacobi01(quad_order_diagonal, 0.0, 0.0)
    nodes, w = tensorRule(r0, rQ, rQ)
    e0, e1, e2 = nodes.T
    comp = e0 ** (-sigma)
    bxs, bys, ws = [], [], []
    # three subdomains (ref ints 0-2)
    x1 = 1 - (1 - e0) * (1 - e2)
    bx0 = np.stack([(1 - e0) * (1 - e2),
                    e0 + (1 - e0) * e2 - e0 * e1,
                    e0 * e1], axis=0)
    by0 = _bary2(e2 * (1 - e0))
    bxs.append(bx0); bys.append(by0); ws.append(w * comp)

    bx1 = np.stack([1 - e0 - e2 + e0 * e2,
                    e2 - e0 * e2,
                    e0], axis=0)
    by1 = _bary2(e2 - e0 * e2 - e0 * e1 + e0)
    bxs.append(bx1); bys.append(by1); ws.append(w * comp)

    bx2 = np.stack([1 - e2 + e0 * e2 - e0 * e1,
                    e2 - e0 * e2,
                    e0 * e1], axis=0)
    by2 = _bary2(e2 - e0 * e2 + e0)
    bxs.append(bx2); bys.append(by2); ws.append(w * comp)

    return PanelRule(np.concatenate(bxs, axis=1), np.concatenate(bys, axis=1),
                     np.concatenate(ws), 'bndEdge2D')


def boundaryVertexRule2DSS(singularity, quad_order_diagonal, order_regular):
    """Cell x boundary-edge sharing one vertex
    (ref fractionalLaplacian2D.pyx:502-563)."""
    sigma = singularity
    rA0 = gaussJacobi01(order_regular, 2.0 + sigma, 0.0)
    rQ0 = gaussJacobi01(quad_order_diagonal, 0.0, 0.0)
    rQ1 = gaussJacobi01(quad_order_diagonal, 1.0, 0.0)
    bxs, bys, ws = [], [], []

    nodes, w = tensorRule(rA0, rQ0, rQ0)
    e0, e1, e2 = nodes.T
    bxs.append(_bary3(e0, e0 * e1))
    bys.append(_bary2(e0 * e2))
    ws.append(w * e0 ** (-sigma))

    nodes, w = tensorRule(rA0, rQ1, rQ0)
    e0, e1, e2 = nodes.T
    bxs.append(_bary3(e0 * e1, e0 * e1 * e2))
    bys.append(_bary2(e0))
    ws.append(w * e0 ** (-sigma))

    return PanelRule(np.concatenate(bxs, axis=1), np.concatenate(bys, axis=1),
                     np.concatenate(ws), 'bndVertex2D')

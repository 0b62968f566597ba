"""Local FEM assembly: mass matrix and load vector (host numpy).

Port of assembleMass / assembleRHS of pynucleus_tpu/fem/assembly.py.  Both
are set-up work outside the slice's device kernels: the load vector goes to
the dofmap's device, the mass matrix stays a host scipy CSR matrix because
only the error report (host float64) applies it.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..config import REAL
from .dofmaps import DoFMap, fe_vector
from .quadrature import simplexDuffy

__all__ = ['assembleMass', 'assembleRHS']


def _volumes(mesh):
    V = mesh.vertices[mesh.cells]              # [C, m+1, dim]
    m = mesh.manifold_dim
    assert m == mesh.dim
    fac = {1: 1.0, 2: 0.5, 3: 1.0 / 6.0}[m]
    return np.abs(np.linalg.det(V[:, 1:, :] - V[:, :1, :])) * fac


def assembleMass(dm: DoFMap):
    """Mass matrix of the interior dofs as a host CSR matrix."""
    m = dm.mesh.manifold_dim
    p = max(dm.polynomialOrder, 1)
    bary, w = simplexDuffy(2 * p + 2, m)
    PHI = dm.evalPhi(bary)                     # [dpe, Q]
    Mref = np.einsum('q,iq,jq->ij', w, PHI, PHI)
    Mloc = _volumes(dm.mesh)[:, None, None] * Mref[None, :, :]
    d = dm.dofs
    rows = np.broadcast_to(d[:, :, None], Mloc.shape)
    cols = np.broadcast_to(d[:, None, :], Mloc.shape)
    keep = (rows >= 0) & (cols >= 0)
    N = dm.num_dofs
    return sp.csr_matrix((Mloc[keep], (rows[keep], cols[keep])), shape=(N, N))


def assembleRHS(dm: DoFMap, fun, qOrder=None):
    """Load vector b_i = int f phi_i, on the dofmap's device.  The default
    quadrature orders are the JAX package's (1D P1 -> 3, 2D P1 -> 2)."""
    mesh = dm.mesh
    m = mesh.manifold_dim
    if qOrder is None:
        qOrder = {1: 3, 2: 2}[m] if dm.polynomialOrder <= 1 else \
            2 * dm.polynomialOrder + 2
    bary, w = simplexDuffy(qOrder, m)
    PHI = dm.evalPhi(bary)                     # [dpe, Q]
    X = np.einsum('qk,ckd->cqd', bary, mesh.vertices[mesh.cells])
    fvals = np.asarray(fun(X.reshape(-1, mesh.dim))).reshape(X.shape[:2])
    bloc = np.einsum('c,q,cq,iq->ci', _volumes(mesh), w, fvals, PHI)
    b = np.zeros(dm.num_dofs, dtype=REAL)
    d = dm.dofs
    mask = d >= 0
    np.add.at(b, d[mask], bloc[mask])
    return fe_vector(torch.as_tensor(b, device=dm.device), dm)

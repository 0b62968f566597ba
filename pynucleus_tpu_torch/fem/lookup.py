"""Point location and FE-vector-backed functions.

Port of pynucleus_tpu/fem/lookup.py: ``cellFinder`` (a k-d tree over the
cell centres with a barycentric membership test) and ``lookupFunction``
(a finite-element vector evaluated at arbitrary points, such as the
weight w of nl.kernels.lookupTwoPoint).  Host numpy, as in the JAX
package: the points are located one by one.
"""
from __future__ import annotations

import numpy as np

from .functions import function

__all__ = ['cellFinder', 'lookupFunction']


class cellFinder:
    """Point -> cell lookup: the numCandidates nearest cell centres (a
    scipy cKDTree), then the barycentric membership test of each."""

    def __init__(self, mesh, numCandidates=None):
        from scipy.spatial import cKDTree
        self.mesh = mesh
        self.centers = mesh.vertices[mesh.cells].mean(axis=1)
        self.tree = cKDTree(self.centers)
        self.numCandidates = numCandidates or min(24, mesh.num_cells)
        # barycentric transform per cell
        V = mesh.vertices[mesh.cells]            # [C, m+1, dim]
        self.v0 = V[:, 0, :]
        span = np.transpose(V[:, 1:, :] - V[:, :1, :], (0, 2, 1))  # [C,dim,m]
        self.spanInv = np.linalg.inv(span)       # [C, m, dim]

    def bary(self, cellNo, x):
        xi = self.spanInv[cellNo] @ (np.asarray(x) - self.v0[cellNo])
        return np.concatenate([[1.0 - xi.sum()], xi])

    def find(self, x, tol=1e-10):
        """Return (cellNo, bary) of the cell containing x, or (-1, None)."""
        _, idx = self.tree.query(np.asarray(x), k=self.numCandidates)
        idx = np.atleast_1d(idx)
        best, bestBary, bestViol = -1, None, np.inf
        for c in idx:
            if c >= self.mesh.num_cells:
                continue
            lam = self.bary(int(c), x)
            viol = -min(lam.min(), 0.0)
            if viol <= tol:
                return int(c), lam
            if viol < bestViol:
                best, bestBary, bestViol = int(c), lam, viol
        if bestViol < 1e-5:
            # x is (numerically) on a facet/outside by rounding
            return best, np.clip(bestBary, 0.0, None)
        return -1, None


class lookupFunction(function):
    """function backed by an FE vector: f(x) = u_h(x), ``fallback`` at
    points outside the mesh."""

    def __init__(self, mesh, dm, u, fallback=0.0):
        self.mesh = mesh
        self.dm = dm
        data = u.data if hasattr(u, 'data') else u
        if hasattr(data, 'detach'):
            data = data.detach().cpu().numpy()
        self.u = np.asarray(data)
        self.finder = cellFinder(mesh)
        self.fallback = fallback

    def eval(self, X):
        X = np.atleast_2d(np.asarray(X))
        out = np.full(X.shape[0], self.fallback, dtype=np.float64)
        d = self.dm.dofs
        for p in range(X.shape[0]):
            c, lam = self.finder.find(X[p])
            if c < 0:
                continue
            phi = np.asarray(self.dm.evalPhi(lam[None, :]))[:, 0]
            dofs = d[c]
            vals = np.where(dofs >= 0, self.u[np.clip(dofs, 0, None)], 0.0)
            out[p] = float(phi @ vals)
        return out

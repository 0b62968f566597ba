"""P1 Lagrange DoF map and finite-element vectors.

Port of pynucleus_tpu/fem/dofmaps.py for the slice's element.  Conventions
are the JAX package's: interior dofs are numbered >= 0 in cell-traversal
order, boundary dofs (on the PHYSICAL boundary, or outside the indicator
function given as the tag) are encoded as -dof-1, and
shape functions are evaluated on the host from barycentric coordinates.
``fe_vector`` holds a tensor on the dofmap's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import getDevice
from .meshes import simplexMesh, PHYSICAL, NO_BOUNDARY

__all__ = ['DoFMap', 'P1_DoFMap', 'fe_vector', 'str2DoFMap']


class DoFMap:
    """Maps (cell, local dof) -> global dof; interior >= 0, boundary < 0.

    ``device`` is where the dofmap's vectors (``interpolate``, the load
    vector) live, the card unless the caller asks for the CPU; the
    numbering itself is host numpy."""

    polynomialOrder = None

    def __init__(self, mesh: simplexMesh, tag=PHYSICAL, device='cuda'):
        self.mesh = mesh
        self.dim = mesh.dim
        self.tag = tag
        self.device = getDevice(device)
        self._buildDofNumbering()

    def evalPhi(self, bary):
        """Shape functions at barycentric points bary [Q, m+1] -> [dpe, Q]."""
        raise NotImplementedError()

    def getDoFCoordinates(self):
        """Physical coordinates of interior dofs [num_dofs, dim]."""
        mesh = self.mesh
        coords = np.zeros((self.num_dofs, mesh.dim))
        pos = np.einsum('jk,ckd->cjd', self.localNodes, mesh.vertices[mesh.cells])
        cc, jj = np.nonzero(self.dofs >= 0)
        coords[self.dofs[cc, jj]] = pos[cc, jj]
        return coords

    def interpolate(self, fun):
        vals = np.asarray(fun(self.getDoFCoordinates()), dtype=np.float64)
        return fe_vector(torch.as_tensor(vals, device=self.device), self)

    def getComplementDoFMap(self):
        """DoFMap over the complement: boundary dofs become the interior."""
        comp = object.__new__(type(self))
        comp.__dict__.update(self.__dict__)
        comp.dofs = -self.dofs - 1  # swap roles
        comp.num_dofs, comp.num_boundary_dofs = \
            self.num_boundary_dofs, self.num_dofs
        return comp

    def __repr__(self):
        return (f'<{type(self).__name__} N={self.num_dofs} '
                f'NB={self.num_boundary_dofs} mesh={self.mesh!r}>')


class P1_DoFMap(DoFMap):
    polynomialOrder = 1

    def __init__(self, mesh, tag=PHYSICAL, device='cuda'):
        mdim = mesh.manifold_dim
        self.localNodes = np.eye(mdim + 1)
        self.dofs_per_element = mdim + 1
        super().__init__(mesh, tag, device)

    def evalPhi(self, bary):
        # P1 shape functions are the barycentric coordinates themselves
        return np.ascontiguousarray(np.asarray(bary, dtype=np.float64).T)

    def evalGradPhi(self, bary):
        """Derivatives of the shape functions with respect to the
        barycentric coordinates at bary [Q, m+1] -> [dpe, Q, m+1]: the
        identity at every point."""
        Q = np.asarray(bary).shape[0]
        eye = np.eye(self.dofs_per_element)
        return np.ascontiguousarray(np.broadcast_to(
            eye[:, None, :], (self.dofs_per_element, Q,
                              self.dofs_per_element)))

    def _buildDofNumbering(self):
        """Vertex dofs numbered in order of first appearance in the cell
        list (ref DoFMaps.pyx cell traversal); boundary vertices of the
        tag get -1, -2, ... in the same order.  The tag is PHYSICAL (the
        mesh boundary), NO_BOUNDARY, a function object whose value > 0.5
        marks the interior vertices (pynucleus_tpu/fem/dofmaps.py
        _buildDofNumbering with a function tag), or a boolean vertex mask
        of the interior vertices."""
        mesh = self.mesh
        flat = mesh.cells.reshape(-1).astype(np.int64)
        verts, first = np.unique(flat, return_index=True)
        order = verts[np.argsort(first, kind='stable')]
        tag = self.tag
        if callable(tag) and not isinstance(tag, (int, np.integer)):
            # a function tag: a dof is interior iff tag(node) > 0.5 (volume
            # constraints on an interaction collar)
            isB = ~(np.asarray(tag(mesh.vertices[order])) > 0.5)
        elif isinstance(tag, np.ndarray):
            # a vertex mask: True for the interior vertices
            isB = ~tag.astype(bool)[order]
        elif tag == NO_BOUNDARY:
            isB = np.zeros(len(order), dtype=bool)
        elif tag == PHYSICAL:
            isB = np.isin(order, mesh.boundaryVertices)
        else:
            raise NotImplementedError(f'tag {tag!r}')
        num = np.empty(mesh.num_vertices, dtype=np.int64)
        num[order[~isB]] = np.arange((~isB).sum())
        num[order[isB]] = -1 - np.arange(isB.sum())
        self.dofs = num[mesh.cells.astype(np.int64)]
        self.num_dofs = int((~isB).sum())
        self.num_boundary_dofs = int(isB.sum())


str2DoFMap = {'P1': P1_DoFMap}


class fe_vector:
    """A finite-element coefficient vector (tensor) bound to its DoFMap."""

    def __init__(self, data, dm):
        self.data = torch.as_tensor(data)
        self.dm = dm

    def toarray(self):
        return self.data.detach().cpu().numpy()

    def __repr__(self):
        return f'<fe_vector n={self.data.shape[0]} dm={type(self.dm).__name__}>'

"""Build the port's objects from plain arrays.

The state of this system is the mesh, the dofmap and the kernel
parameters.  ``fromArrays`` builds the port's mesh, P1 dofmap and kernel
from numpy arrays, such as the ``vertices``/``cells`` of a JAX package
mesh, so that both packages assemble on the identical mesh.
"""
from __future__ import annotations

import numpy as np

from .fem.meshes import simplexMesh, PHYSICAL
from .fem.dofmaps import P1_DoFMap
from .nl.kernels import getFractionalKernel

__all__ = ['fromArrays']


def fromArrays(vertices, cells, s, dim, scaling=None, device='cpu'):
    """(mesh, dm, kernel) of the port: simplexMesh(vertices, cells),
    P1_DoFMap on the PHYSICAL boundary tag, and the fractional kernel of
    order s (normalized unless ``scaling`` is given)."""
    mesh = simplexMesh(np.asarray(vertices), np.asarray(cells), dim=dim)
    dm = P1_DoFMap(mesh, PHYSICAL, device=device)
    return mesh, dm, getFractionalKernel(dim, s, scaling=scaling)

"""Build the port's objects from plain arrays.

The state of this system is the mesh, the dofmap (with its interior
vertices) and the kernel parameters (type, horizon, interaction, scaling,
order), and for an assembled H2 operator its tree-ordered near field,
leaf data and per-level far-field data.  ``fromArrays`` builds the port's
mesh, P1 dofmap and kernel from numpy arrays, such as the
``vertices``/``cells`` of a JAX package mesh, so that both packages
assemble on the identical mesh (the kernel parameters include the complex
Greens kernels' type and greensLambda); ``h2FromArrays`` builds the port's
H2Matrix from the arrays of an H2 operator, such as those of a JAX package
H2Matrix, so that its apply can be checked on its own; ``csrFromArrays``
builds the port's CSR operator, such as a JAX package prolongation, so
that a multigrid cycle can run on operators identical to the JAX
package's; ``csrHierarchyFromArrays`` builds a level list of CSR
operators and prolongations, such as a JAX package stiffness hierarchy or
a complex-shifted Helmholtz one (complex128 data), for the port's
multigrid and Krylov solvers; ``denseVectorFromArrays``
builds the port's dense vector operator from the data of one, such as a
JAX package Dense_VectorLinearOperator, so that its apply can be checked on
its own.  Like every entry point of the port they build on the card
unless the caller asks for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import getDevice

from .fem.meshes import simplexMesh, PHYSICAL
from .fem.dofmaps import P1_DoFMap
from .nl.kernels import (getFractionalKernel, getIntegrableKernel,
                         getComplexKernel, interactionFactory,
                         leftRightFractionalOrder, GREENS_2D, GREENS_3D)
from .nl.h2 import TreeNearMeta, TreeNearOperator, H2Matrix
from .nl.problems import parseFractionalOrder
from .base.linear_operators import (CSR_LinearOperator,
                                    Dense_VectorLinearOperator)

__all__ = ['fromArrays', 'h2FromArrays', 'csrFromArrays',
           'csrHierarchyFromArrays', 'denseVectorFromArrays']


def fromArrays(vertices, cells, s, dim, scaling=None, device='cuda',
               kernelType='fractional', horizon=np.inf, interaction='ball2',
               normalized=True, interior=None, gaussianVariance=1.0,
               exponentialRate=1.0, derivative=0, greensLambda=1.0j):
    """(mesh, dm, kernel) of the port: simplexMesh(vertices, cells), a
    P1_DoFMap and a kernel.  The dofmap's tag is the PHYSICAL boundary, or
    with ``interior`` (a boolean mask of the vertices) the interior
    vertices of a volume constraint, as a function tag of the JAX package
    marks them.  The kernel: of an infinite horizon the fractional kernel
    of order s (normalized unless ``scaling`` is given), the gaussian one
    of variance ``gaussianVariance`` or the exponential one of rate
    ``exponentialRate``; of a finite ``horizon`` the fractional, indicator
    ('constant') or peridynamic ('inverseDistance') kernel with the ball2
    or ballInf ``interaction`` (nl.problems processKernel).  The order s is
    a number, a string of nl.problems.parseFractionalOrder
    ('twoDomainNonSym(0.25,0.75)', 'constantNonSym(0.25)', ...) or the
    parameters (sll, srr[, slr, srl]) of a leftRight order.  With
    ``derivative`` (1 or 2) the fractional kernel of an infinite horizon is
    its s-derivative (normalized as given): a vector kernel for an order of
    several parameters.  ``kernelType`` 'greens2D' or 'greens3D' is the
    complex Greens kernel of ``greensLambda`` (s unused; scaling 1 unless
    given), of an infinite or a finite ``horizon`` (ball2 unless
    ``interaction`` names another ball)."""
    if isinstance(s, str):
        s = parseFractionalOrder(s)
    elif isinstance(s, (tuple, list)):
        s = leftRightFractionalOrder(*s)
    mesh = simplexMesh(np.asarray(vertices), np.asarray(cells), dim=dim)
    dm = P1_DoFMap(mesh, PHYSICAL if interior is None else
                   np.asarray(interior, dtype=bool), device=device)
    if kernelType in (GREENS_2D, GREENS_3D):
        return mesh, dm, getComplexKernel(
            dim, kernel=kernelType, greensLambda=greensLambda,
            horizon=horizon, scaling=1.0 if scaling is None else scaling,
            interaction=None if horizon == np.inf
            else interactionFactory[interaction]())
    if horizon == np.inf:
        if kernelType in ('gaussian', 'exponential'):
            return mesh, dm, getIntegrableKernel(
                dim, kernelType, horizon, scaling=scaling,
                normalized=normalized, gaussian_variance=gaussianVariance,
                exponentialRate=exponentialRate)
        if kernelType != 'fractional':
            raise NotImplementedError(f'{kernelType} with an infinite '
                                      'horizon')
        if derivative:
            return mesh, dm, getFractionalKernel(dim, s, normalized=normalized,
                                                 derivative=derivative)
        return mesh, dm, getFractionalKernel(dim, s, scaling=scaling)
    inter = interactionFactory[interaction]()
    if kernelType == 'fractional':
        kernel = getFractionalKernel(dim, s, horizon=horizon,
                                     interaction=inter, scaling=scaling,
                                     normalized=normalized)
    else:
        kernel = getIntegrableKernel(
            dim, {'constant': 'indicator', 'inverseDistance': 'peridynamic'}
            .get(kernelType, kernelType), horizon, interaction=inter,
            scaling=scaling, normalized=normalized)
    return mesh, dm, kernel


def h2FromArrays(dataT, indptrT, tmplAll, tmplStart, tStartRow, tLen, rowLen,
                 perm, N, leafDofs, leafPhi, leafLvl, leafPos, levels,
                 device='cuda', symmetric=True):
    """The port's H2Matrix from numpy arrays.

    Near field: the tree-ordered data [nnz] and its structure (the fields
    of pynucleus_tpu/nl/h2.py _TreeNearMeta: indptrT, tmplAll, tmplStart,
    tStartRow, tLen, rowLen, perm, N).  Leaves: leafDofs [L, nbar] (pad
    -1), leafPhi [L, nbar, M], each leaf's level and position.  levels:
    one mapping per level with 'size' and, where present, 'T' [size, M, M],
    'parentIdx' [size], 'K' [p, M, M] (with the -2 factor), 'src' and
    'dst' [p], as the JAX package's H2Matrix.levels hold them.
    ``symmetric`` as the JAX operator's flag: a nonsymmetric operator's
    ``.T`` applies the transpose (K20)."""
    dev = getDevice(device)
    dataT = np.array(dataT, dtype=np.float64)
    dataZ = torch.zeros(len(dataT) + 1, dtype=torch.float64, device=dev)
    dataZ[:-1] = torch.as_tensor(dataT, device=dev)
    near = TreeNearOperator(dataZ, TreeNearMeta(
        indptrT, tmplAll, tmplStart, tStartRow, tLen, rowLen, perm, N))
    lv, Ks, off = [], [], 0
    for level in levels:
        entry = {'size': int(level['size'])}
        for name in ('T', 'parentIdx'):
            if level.get(name) is not None:
                entry[name] = np.asarray(level[name])
        if level.get('K') is not None:
            K = np.asarray(level['K'], dtype=np.float64)
            entry.update(farOff=off, farCount=K.shape[0],
                         src=np.asarray(level['src']),
                         dst=np.asarray(level['dst']))
            Ks.append(K)
            off += K.shape[0]
        lv.append(entry)
    M = np.asarray(leafPhi).shape[2]
    Kall = torch.as_tensor(np.concatenate(Ks) if Ks else
                           np.zeros((0, M, M)), device=dev)
    return H2Matrix(near, torch.as_tensor(np.asarray(leafPhi,
                                                     dtype=np.float64),
                                          device=dev),
                    (leafLvl, leafPos), lv, Kall, N, leafDofs,
                    symmetric=symmetric)


def csrFromArrays(indptr, indices, data, shape, device='cuda'):
    """The port's CSR_LinearOperator of shape (rows, columns) from the CSR
    arrays indptr [rows+1], indices and data [nnz] (float64, or complex128
    for complex data, such as a complex-shifted Helmholtz level)."""
    if len(indptr) != shape[0] + 1:
        raise ValueError('csrFromArrays: indptr must have rows + 1 entries')
    return CSR_LinearOperator(indptr, indices, data, num_columns=shape[1],
                              device=device)


def csrHierarchyFromArrays(As, Ps, device='cuda'):
    """The port's level list [{'A'}, {'A', 'P', 'R'}, ...], coarse to fine,
    from CSR arrays: As[l] and Ps[l] (l >= 1; Ps[0] is ignored) each a
    tuple (indptr, indices, data, shape) as for :func:`csrFromArrays`; R is
    the CSR of P's transpose.  The operators keep their data's type: real
    prolongations between complex128 levels make a complex hierarchy."""
    hierarchy = []
    for lvl, A in enumerate(As):
        entry = {'A': csrFromArrays(*A, device=device)}
        if lvl > 0:
            entry['P'] = csrFromArrays(*Ps[lvl], device=device)
            entry['R'] = entry['P'].T
        hierarchy.append(entry)
    return hierarchy


def denseVectorFromArrays(data, device='cuda'):
    """The port's Dense_VectorLinearOperator of data [N, M, V] (float64)."""
    return Dense_VectorLinearOperator(torch.as_tensor(
        np.array(data, dtype=np.float64), device=getDevice(device)))

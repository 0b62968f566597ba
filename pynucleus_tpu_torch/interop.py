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
multigrid and Krylov solvers; ``sssFromArrays`` builds the port's SSS
operator from the arrays of one, such as a JAX package
SSS_LinearOperator; ``denseVectorFromArrays``
builds the port's dense vector operator from the data of one, such as a
JAX package Dense_VectorLinearOperator, so that its apply can be checked on
its own; ``builderFromArrays`` gives the port's nonlocalBuilder on the mesh
and kernel of ``fromArrays`` in a value type (float64, or float32 for the
float32 dense and H2 paths), so that both packages build the same
operator in the same dtype (``h2FromArrays`` takes the dtype too).  Like every entry point of the port they build on the card
unless the caller asks for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import getDevice, realType

from .fem.meshes import simplexMesh, PHYSICAL
from .fem.dofmaps import P1_DoFMap, fe_vector
from .nl.kernels import (getFractionalKernel, getIntegrableKernel,
                         getComplexKernel, interactionFactory, horizonFunction,
                         leftRightFractionalOrder, feFractionalOrder,
                         FractionalKernel, Kernel,
                         twoPointFunctionFactory, lookupTwoPoint, GREENS_2D,
                         GREENS_3D, LOGINVERSEDISTANCE, MONOMIAL, POLYNOMIAL)
from .nl.h2 import TreeNearMeta, TreeNearOperator, H2Matrix
from .nl.problems import parseFractionalOrder
from .base.linear_operators import (CSR_LinearOperator, SSS_LinearOperator,
                                    Dense_VectorLinearOperator)

__all__ = ['fromArrays', 'builderFromArrays', 'h2FromArrays',
           'csrFromArrays',
           'csrHierarchyFromArrays', 'sssFromArrays', 'denseVectorFromArrays']


def _twoPoint(phi, dm):
    """The two-point weight of a tuple that names a factory entry and its
    numbers: ('tempered', lambda), ('constant', value), ('leftRight', vll,
    vrr, vlr, vrl, interface), ('interface', horizon1, horizon2, left,
    interface) or ('lookup', w) with w the dof values of the weight on
    ``dm``; None stays None."""
    if phi is None:
        return None
    name, *args = phi
    if name == 'lookup':
        return lookupTwoPoint(fe_vector(torch.tensor(
            np.asarray(args[0], dtype=np.float64), device=dm.device), dm))
    return twoPointFunctionFactory(name, *args)


def fromArrays(vertices, cells, s, dim, scaling=None, device='cuda',
               kernelType='fractional', horizon=np.inf, interaction='ball2',
               normalized=True, interior=None, gaussianVariance=1.0,
               exponentialRate=1.0, derivative=0, greensLambda=1.0j,
               phi=None, temperedLambda=0.0, monomialPower=0.0,
               polynomialRadius=None, manifold=False):
    """(mesh, dm, kernel) of the port: simplexMesh(vertices, cells), a
    P1_DoFMap and a kernel.  The dofmap's tag is the PHYSICAL boundary, or
    with ``interior`` (a boolean mask of the vertices) the interior
    vertices of a volume constraint, as a function tag of the JAX package
    marks them.  The kernel: of an infinite horizon the fractional kernel
    of order s (normalized unless ``scaling`` is given), the gaussian one
    of variance ``gaussianVariance`` or the exponential one of rate
    ``exponentialRate``; of a finite ``horizon`` the fractional, indicator
    ('constant') or peridynamic ('inverseDistance') kernel with the
    ``interaction`` ball2, ballInf, ball1 or the ellipse as ('ellipse',
    aFac, bFac, theta) (nl.kernels.interactionFactory); a ``horizon``
    (c0, c, min, max) makes the fractional kernel's horizon the affine
    delta(x) = clip(c0 + c x_0, min, max) (nl.kernels.horizonFunction).
    The order s is
    a number, a string of nl.problems.parseFractionalOrder
    ('twoDomainNonSym(0.25,0.75)', 'constantNonSym(0.25)',
    'innerOuter(2,0.75,0.25,0.5)', ...), ('fe', values[, smin, smax]) for
    the feFractionalOrder of the P1 vector of those dof values on the
    dofmap (such as a JAX package FE vector's numpy data), or the
    parameters (sll, srr[, slr, srl]) of a leftRight order.  With
    ``manifold`` the mesh is a closed (dim-1)-manifold in R^dim (cells of
    dim vertices, such as a JAX package surface mesh) and the kernel the
    manifold fractional kernel of the constant order s.  With
    ``derivative`` (1 or 2) the fractional kernel of an infinite horizon is
    its s-derivative (normalized as given): a vector kernel for an order of
    several parameters.  ``kernelType`` 'greens2D' or 'greens3D' is the
    complex Greens kernel of ``greensLambda`` (s unused; scaling 1 unless
    given), of an infinite or a finite ``horizon`` (ball2 unless
    ``interaction`` names another ball).  ``phi`` is a two-point weight
    as a tuple of a factory name and its numbers (:func:`_twoPoint`:
    ('tempered', lambda), ('leftRight', vll, vrr, vlr, vrl, interface),
    ('interface', horizon1, horizon2, left, interface), ('lookup', dof
    values), ('constant', value)); ``temperedLambda`` makes the fractional
    kernel of a constant order tempered (FractionalKernel).  The gaussian
    and exponential kernels take a finite horizon too.  ``kernelType``
    'logInverseDistance' (scaling 1 unless given), 'monomial' (C
    r^monomialPower, singularity monomialPower, scaling 1/2 unless given)
    and 'polynomial' (C (1 - r^2/polynomialRadius^2)^2, scaling 1/2
    unless given) are Kernel objects of those types."""
    mesh = simplexMesh(np.asarray(vertices), np.asarray(cells), dim=dim)
    dm = P1_DoFMap(mesh, PHYSICAL if interior is None else
                   np.asarray(interior, dtype=bool), device=device)
    if isinstance(s, str):
        s = parseFractionalOrder(s)
    elif isinstance(s, (tuple, list)) and s and s[0] == 'fe':
        s = feFractionalOrder(fe_vector(torch.tensor(
            np.asarray(s[1], dtype=np.float64), device=dm.device), dm),
            *s[2:])
    elif isinstance(s, (tuple, list)):
        s = leftRightFractionalOrder(*s)
    if manifold:
        if kernelType != 'fractional' or horizon != np.inf or derivative \
                or phi is not None:
            raise NotImplementedError('manifold: the fractional kernel of '
                                      'an infinite horizon only')
        return mesh, dm, getFractionalKernel(dim, s, scaling=scaling,
                                             manifold=True)
    w = _twoPoint(phi, dm)
    if kernelType in (GREENS_2D, GREENS_3D):
        return mesh, dm, getComplexKernel(
            dim, kernel=kernelType, greensLambda=greensLambda,
            horizon=horizon, scaling=1.0 if scaling is None else scaling,
            interaction=None if horizon == np.inf
            else interactionFactory[interaction]()).setTwoPoint(w)
    if kernelType in (LOGINVERSEDISTANCE, MONOMIAL, POLYNOMIAL):
        inter = None if horizon == np.inf else \
            interactionFactory[interaction]()
        C = {LOGINVERSEDISTANCE: 1.0}.get(kernelType, 0.5) \
            if scaling is None else scaling
        sing = monomialPower if kernelType == MONOMIAL else 0.0
        return mesh, dm, Kernel(
            dim, kernelType, horizon, inter, C, sing,
            exponentParam=polynomialRadius or 0.0,
            monomialPower=monomialPower).setTwoPoint(w)
    if temperedLambda != 0.0:
        if kernelType != 'fractional' or derivative:
            raise NotImplementedError('temperedLambda: the fractional '
                                      'kernel only')
        inter = None if horizon == np.inf else \
            interactionFactory[interaction]()
        return mesh, dm, FractionalKernel(
            dim, s, horizon, inter, scaling, normalized=normalized,
            temperedLambda=temperedLambda).setTwoPoint(w)
    if horizon == np.inf:
        if kernelType in ('gaussian', 'exponential'):
            return mesh, dm, getIntegrableKernel(
                dim, kernelType, horizon, scaling=scaling,
                normalized=normalized, gaussian_variance=gaussianVariance,
                exponentialRate=exponentialRate, phi=w)
        if kernelType != 'fractional':
            raise NotImplementedError(f'{kernelType} with an infinite '
                                      'horizon')
        if derivative:
            return mesh, dm, getFractionalKernel(dim, s, normalized=normalized,
                                                 derivative=derivative, phi=w)
        return mesh, dm, getFractionalKernel(dim, s, scaling=scaling, phi=w)
    if isinstance(horizon, (tuple, list)):
        if kernelType != 'fractional' or w is not None:
            raise NotImplementedError('a variable horizon of the '
                                      f'{kernelType} kernel')
        return mesh, dm, getFractionalKernel(
            dim, s, horizon=horizonFunction(*horizon), normalized=normalized)
    name, *iargs = (interaction,) if isinstance(interaction, str) \
        else interaction
    inter = interactionFactory[name](*iargs)
    if kernelType == 'fractional':
        kernel = getFractionalKernel(dim, s, horizon=horizon,
                                     interaction=inter, scaling=scaling,
                                     normalized=normalized, phi=w)
    else:
        kernel = getIntegrableKernel(
            dim, {'constant': 'indicator', 'inverseDistance': 'peridynamic'}
            .get(kernelType, kernelType), horizon, interaction=inter,
            scaling=scaling, normalized=normalized, phi=w,
            gaussian_variance=gaussianVariance,
            exponentialRate=exponentialRate)
    return mesh, dm, kernel


def builderFromArrays(vertices, cells, s, dim, dtype=None, params=None,
                      device='cuda', zeroExterior=True, **kw):
    """The port's nonlocalBuilder of the dofmap and kernel of
    ``fromArrays(vertices, cells, s, dim, device=device, **kw)`` with
    ``params`` and the value type ``dtype`` as ``params['dtype']``
    (np.float32, 'float32' or torch.float32 for the float32 dense and H2
    paths;
    None keeps float64), as a JAX package builder takes
    ``params={'dtype': dtype}``."""
    from .nl.assembly import nonlocalBuilder
    _, dm, kernel = fromArrays(vertices, cells, s, dim, device=device, **kw)
    params = dict(params or {})
    if dtype is not None:
        params['dtype'] = dtype
    return nonlocalBuilder(dm, kernel, params=params,
                           zeroExterior=zeroExterior)


def h2FromArrays(dataT, indptrT, tmplAll, tmplStart, tStartRow, tLen, rowLen,
                 perm, N, leafDofs, leafPhi, leafLvl, leafPos, levels,
                 device='cuda', symmetric=True, dtype=None):
    """The port's H2Matrix from numpy arrays.

    Near field: the tree-ordered data [nnz] and its structure (the fields
    of pynucleus_tpu/nl/h2.py _TreeNearMeta: indptrT, tmplAll, tmplStart,
    tStartRow, tLen, rowLen, perm, N).  Leaves: leafDofs [L, nbar] (pad
    -1), leafPhi [L, nbar, M], each leaf's level and position.  levels:
    one mapping per level with 'size' and, where present, 'T' [size, M, M],
    'parentIdx' [size], 'K' [p, M, M] (with the -2 factor), 'src' and
    'dst' [p], as the JAX package's H2Matrix.levels hold them.
    ``symmetric`` as the JAX operator's flag: a nonsymmetric operator's
    ``.T`` applies the transpose (K20).  ``dtype`` the operator's value
    type (None or float64; np.float32, 'float32' or torch.float32 for a
    float32 operator, as a JAX package getH2 with params={'dtype':
    float32} makes it): every value array is cast to it."""
    dev = getDevice(device)
    real = realType(dtype)
    dataT = np.array(dataT, dtype=np.float64)
    dataZ = torch.zeros(len(dataT) + 1, dtype=real, device=dev)
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
                           np.zeros((0, M, M)), device=dev, dtype=real)
    return H2Matrix(near, torch.as_tensor(np.asarray(leafPhi,
                                                     dtype=np.float64),
                                          device=dev, dtype=real),
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


def sssFromArrays(indices, indptr=None, data=None, diagonal=None, *,
                  rowids=None, num_rows=None, device='cuda'):
    """The port's SSS_LinearOperator (diagonal + strictly lower triangle L,
    applied as diag x + L x + L^T x) from L's column ``indices`` and
    ``data`` [nnz] with its CSR row pointers ``indptr`` or its row ids
    ``rowids`` and ``num_rows``, and the ``diagonal`` [n]: the arrays of a
    JAX package SSS_LinearOperator (its ``indptr`` when it has one, else
    its ``rowids``)."""
    return SSS_LinearOperator(indices, indptr, data, diagonal, rowids=rowids,
                              num_rows=num_rows, device=device)


def denseVectorFromArrays(data, device='cuda'):
    """The port's Dense_VectorLinearOperator of data [N, M, V] (float64)."""
    return Dense_VectorLinearOperator(torch.as_tensor(
        np.array(data, dtype=np.float64), device=getDevice(device)))

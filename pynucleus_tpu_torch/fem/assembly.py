"""Local FEM assembly: stiffness and mass in CSR, load vector, the
matrix-free operator; kernels K16 and K25.

Port of _geometry, buildSparsityPattern, scatterToCSR, assembleMass,
assembleStiffness and assembleRHS of pynucleus_tpu/fem/assembly.py (P1,
no coefficient).  The local matrices [C, dpe, dpe] are host einsums,
code-identical to the JAX package's, and so is the sparsity pattern with
the nnz slot of every local entry.  The sum of the local values into CSR
data runs on the dofmap's device: kernel K16 :func:`csr_scatter` replaces
scatterToCSR's segment sum.  It reads the contributions in an order the
host makes once per dofmap (:func:`scatterPlan`): the kept ones sorted by
slot, stably, with each slot's range in ``offsets``.  The load vector
(complex for a complex right-hand side), the boundary mass matrix and the
boundary load vector (assembleSurfaceMass, assembleSurfaceRHS: the
impedance condition of runHelmholtz) are host sums, as in the JAX
package.  :class:`matrixFreeOperator` (mass or stiffness, with an optional
coefficient averaged per cell) keeps the local matrices on the device and
applies them with kernel K25 :func:`matfree_apply`, which replaces the
gather, per-cell einsum and segment sum of the JAX package's jitted
apply.
"""
from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch

from .. import kernels
from ..config import REAL, INDEX
from ..base.linear_operators import CSR_LinearOperator, LinearOperator
from .dofmaps import DoFMap, fe_vector
from .quadrature import simplexDuffy

__all__ = ['assembleMass', 'assembleStiffness', 'localStiffness',
           'assembleRHS', 'assembleSurfaceMass', 'assembleSurfaceRHS',
           'buildSparsityPattern', 'scatterPlan', 'scatterToCSR',
           'csr_scatter', 'matrixFreeOperator', 'matfree_apply']


def _geometry(mesh):
    """Simplex volumes and barycentric gradients.
    Returns vol [C], gradLam [C, m+1, dim]."""
    V = mesh.vertices[mesh.cells]              # [C, m+1, dim]
    m = mesh.manifold_dim
    span = V[:, 1:, :] - V[:, :1, :]           # [C, m, dim]
    if m == mesh.dim:
        det = np.linalg.det(span)
        fac = {1: 1.0, 2: 0.5, 3: 1.0 / 6.0}[m]
        vol = np.abs(det) * fac
        inv = np.linalg.inv(span)              # [C, dim, m] == inv of span rows
        # x = v0 + xi @ span  =>  dxi/dx = inv(span) with xi row vec:
        # grad xi_k = inv[:, :, k]
        gradLam = np.zeros((V.shape[0], m + 1, mesh.dim))
        gradLam[:, 1:, :] = np.transpose(inv, (0, 2, 1))
        gradLam[:, 0, :] = -gradLam[:, 1:, :].sum(axis=1)
    else:
        G = np.einsum('cid,cjd->cij', span, span)
        det = np.linalg.det(G) if m > 1 else G[:, :, 0]
        fac = {1: 1.0, 2: 0.5, 3: 1.0 / 6.0}[m]
        vol = np.sqrt(np.abs(det)).reshape(-1) * fac
        gradLam = None
    return vol, gradLam


def buildSparsityPattern(dm: DoFMap, dm2: DoFMap = None):
    """Sparsity of sum_c outer(dofs_c, dofs_c); returns (csr_pattern, slotIdx)
    where slotIdx [C, dpe, dpe] maps each local contribution to its nnz slot
    (or -1 for dropped boundary rows/cols).  Host-side, built once
    (ref base sparsityPattern.pyx freeze)."""
    dofs1 = dm.dofs
    dofs2 = dofs1 if dm2 is None else dm2.dofs
    C, dpe1 = dofs1.shape
    dpe2 = dofs2.shape[1]
    I = np.repeat(dofs1, dpe2, axis=1).reshape(C, dpe1, dpe2)
    J = np.tile(dofs2, (1, dpe1)).reshape(C, dpe1, dpe2)
    mask = (I >= 0) & (J >= 0)
    rows = I[mask]
    cols = J[mask]
    n1 = dm.num_dofs
    n2 = n1 if dm2 is None else dm2.num_dofs
    # unique (r, c) pairs in lexicographic order == CSR order with sorted
    # per-row indices; 'inverse' gives each contribution its nnz slot.
    key = rows.astype(np.int64) * n2 + cols.astype(np.int64)
    uniq, inverse = np.unique(key, return_inverse=True)
    u_rows = (uniq // n2).astype(INDEX)
    u_cols = (uniq % n2).astype(INDEX)
    indptr = np.zeros(n1 + 1, dtype=np.int64)
    np.add.at(indptr, u_rows + 1, 1)
    indptr = np.cumsum(indptr)
    pat = sp.csr_matrix((np.zeros(len(uniq)), u_cols, indptr), shape=(n1, n2))
    slot = np.full((C, dpe1, dpe2), -1, dtype=np.int64)
    slot[mask] = inverse
    return pat, slot


def scatterPlan(dm: DoFMap, timers=None):
    """(pat, slot, order, offsets) of the dofmap's CSR assembly, made once
    and kept on the dofmap: the pattern and slots of
    :func:`buildSparsityPattern`, and K16's gather order on the device --
    ``order`` [K] int32, the flat indices of the K kept contributions
    sorted stably by slot; ``offsets`` [nnz+1] int32, slot s's range of
    ``order``.  ``timers``, if a dict, receives the host seconds of the
    pattern ('pattern') and of the order ('scatter order') when made."""
    cached = getattr(dm, '_scatterPlan', None)
    # kept with the numbering it was made for (a complement dofmap copies
    # the attributes but not the numbering)
    if cached is not None and cached[0] is dm.dofs:
        return cached[1]
    t0 = time.perf_counter()
    pat, slot = buildSparsityPattern(dm)
    t1 = time.perf_counter()
    nnz = int(pat.indptr[-1])
    flat = slot.reshape(-1)
    if flat.shape[0] >= 2 ** 31:
        raise ValueError('scatterPlan: more than 2^31 - 1 local entries')
    kept = np.nonzero(flat >= 0)[0]
    order = kept[np.argsort(flat[kept], kind='stable')]
    offsets = np.zeros(nnz + 1, dtype=np.int64)
    np.cumsum(np.bincount(flat[kept], minlength=nnz), out=offsets[1:])
    dev = dm.device
    plan = (pat, slot,
            torch.as_tensor(order.astype(np.int32), device=dev),
            torch.as_tensor(offsets.astype(np.int32), device=dev))
    if timers is not None:
        timers['pattern'] = t1 - t0
        timers['scatter order'] = time.perf_counter() - t1
    dm._scatterPlan = (dm.dofs, plan)
    return plan


# ----------------------------------------------------------------- K16 ----

def csr_scatter(vals, order, offsets, out=None):
    """CSR data [nnz] of the flat local values ``vals`` [C*dpe*dpe]
    float64: slot s is the sum, from 0 in this order, of vals[order[k]]
    for offsets[s] <= k < offsets[s+1] (``order`` and ``offsets`` int32,
    from :func:`scatterPlan`).  Writes into ``out`` [nnz] when given.

    Kernel K16 (kernels/csrc/csr_scatter.cu) on CUDA tensors, the plain
    version on CPU tensors.  Replaces the segment sum of
    pynucleus_tpu/fem/assembly.py:87 scatterToCSR."""
    dev = vals.device
    for t, dt in ((vals, torch.float64), (order, torch.int32),
                  (offsets, torch.int32)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous() \
                or t.dim() != 1:
            raise ValueError(f'csr_scatter: expected a contiguous {dt} '
                             f'vector on {dev}, got {t.dtype} '
                             f'{tuple(t.shape)} on {t.device}')
    nnz = offsets.shape[0] - 1
    if out is None:
        out = torch.empty(nnz, dtype=torch.float64, device=dev)
    elif out.dtype != torch.float64 or out.shape != (nnz,) \
            or not out.is_contiguous() or out.device != dev:
        raise ValueError(f'csr_scatter: out must be a contiguous float64 '
                         f'[{nnz}] on {dev}')
    if dev.type == 'cpu':
        return _csr_scatter_plain(vals, order, offsets, out)
    if dev.type != 'cuda':
        raise ValueError(f'csr_scatter: unsupported device {dev}')
    if nnz == 0:
        return out
    lib = kernels.library()
    kernels.launches['csr_scatter'] += 1
    kernels.deviceLaunches['csr_scatter'] += 1
    p = kernels.ptr
    kernels.check(lib.csr_scatter(p(out), p(vals), p(order), p(offsets), nnz,
                                  kernels.stream()))
    return out


def _csr_scatter_plain(vals, order, offsets, out):
    """Plain PyTorch version of :func:`csr_scatter` (any device): the
    contributions of every slot added in order, the k-th of all slots at
    once."""
    start = offsets[:-1].long()
    counts = offsets[1:].long() - start
    out.zero_()
    width = int(counts.max()) if counts.numel() else 0
    for k in range(width):
        has = counts > k
        idx = order[torch.where(has, start + k, 0)].long()
        out.add_(torch.where(has, vals[idx], 0.0))
    return out


def scatterToCSR(dm: DoFMap, vals, timers=None):
    """Local values [C, dpe, dpe] (host) -> CSR_LinearOperator on the
    dofmap's device, its data summed there by K16.  ``timers``, if a dict,
    receives the plan's host seconds (when made) and the sum's seconds
    ('scatter'; CUDA events on the card)."""
    pat, _, order, offsets = scatterPlan(dm, timers)
    dev = dm.device
    v = torch.as_tensor(np.ascontiguousarray(vals, dtype=REAL).reshape(-1),
                        device=dev)
    data = torch.empty(offsets.shape[0] - 1, dtype=torch.float64, device=dev)
    if dev.type == 'cuda':
        # the upload done first, so that the events time the sum alone
        torch.cuda.synchronize(dev)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        csr_scatter(v, order, offsets, out=data)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        csr_scatter(v, order, offsets, out=data)
        seconds = time.perf_counter() - t0
    if timers is not None:
        timers['scatter'] = seconds
    return CSR_LinearOperator.fromDevice(pat.indptr, pat.indices, data,
                                         num_columns=pat.shape[1])


def assembleMass(dm: DoFMap):
    """Mass matrix of the interior dofs (ref DoFMaps.assembleMass -> femCy
    mass tables) as a CSR operator on the dofmap's device."""
    mesh = dm.mesh
    m = mesh.manifold_dim
    p = max(dm.polynomialOrder, 1)
    bary, w = simplexDuffy(2 * p + 2, m)
    PHI = dm.evalPhi(bary)                     # [dpe, Q]
    vol, _ = _geometry(mesh)
    Mref = np.einsum('q,iq,jq->ij', w, PHI, PHI)
    Mloc = vol[:, None, None] * Mref[None, :, :]
    return scatterToCSR(dm, Mloc)


def assembleStiffness(dm: DoFMap, timers=None):
    """Stiffness matrix int grad(phi_i).grad(phi_j) (ref
    DoFMaps.assembleStiffness -> femCy stiffness tables) as a CSR operator
    on the dofmap's device.  ``timers``, if a dict, receives the host
    seconds of the local matrices ('local') and those of
    :func:`scatterToCSR`."""
    t0 = time.perf_counter()
    Kloc = localStiffness(dm)
    if timers is not None:
        timers['local'] = time.perf_counter() - t0
    return scatterToCSR(dm, Kloc, timers)


def localStiffness(dm: DoFMap):
    """The local stiffness matrices [C, dpe, dpe] (host)."""
    mesh = dm.mesh
    m = mesh.manifold_dim
    assert m == mesh.dim, 'stiffness on manifold meshes not supported'
    p = max(dm.polynomialOrder, 1)
    order = max(2 * (p - 1) + 2, 2)
    bary, w = simplexDuffy(order, m)
    DPHI = dm.evalGradPhi(bary)                # [dpe, Q, m+1]
    vol, gradLam = _geometry(mesh)             # [C], [C, m+1, dim]
    # grad phi_i(x_q) in cell c: sum_k DPHI[i,q,k] gradLam[c,k,:]
    return np.einsum('c,q,iqk,ckd,jql,cld->cij', vol, w,
                     DPHI, gradLam, DPHI, gradLam, optimize=True)


def assembleRHS(dm: DoFMap, fun, qOrder=None):
    """Load vector b_i = int f phi_i, on the dofmap's device, complex128
    for a complex f, else float64.  The default quadrature orders are the
    JAX package's (1D P1 -> 3, 2D P1 -> 2)."""
    mesh = dm.mesh
    m = mesh.manifold_dim
    if qOrder is None:
        qOrder = {1: 3, 2: 2}[m] if dm.polynomialOrder <= 1 else \
            2 * dm.polynomialOrder + 2
    bary, w = simplexDuffy(qOrder, m)
    PHI = dm.evalPhi(bary)                     # [dpe, Q]
    X = np.einsum('qk,ckd->cqd', bary, mesh.vertices[mesh.cells])
    fvals = np.asarray(fun(X.reshape(-1, mesh.dim))).reshape(X.shape[:2])
    vol, _ = _geometry(mesh)
    bloc = np.einsum('c,q,cq,iq->ci', vol, w, fvals, PHI)
    b = np.zeros(dm.num_dofs,
                 dtype=np.complex128 if np.iscomplexobj(fvals) else REAL)
    d = dm.dofs
    mask = d >= 0
    np.add.at(b, d[mask], bloc[mask])
    return fe_vector(torch.as_tensor(b, device=dm.device), dm)


# ----------------------------------------------------------------- K25 ----

class matrixFreeOperator(LinearOperator):
    """Matrix-free mass or stiffness operator: y = A x without assembling A
    (pynucleus_tpu/fem/assembly.py:284 matrixFreeOperator, ref
    femCy.matrixFreeOperator:3403).  The local matrices [C, dpe, dpe] are
    made on the host as the JAX package makes them and kept on the
    dofmap's device with the cells' dofs and K25's gather order (the kept
    local rows sorted stably by dof, each dof's range in ``offsets``);
    :meth:`matvec` and :attr:`diagonal` are kernel K25."""

    def __init__(self, dm: DoFMap, kind='stiffness', coefficient=None,
                 qOrder=None):
        mesh = dm.mesh
        m = mesh.manifold_dim
        p = max(dm.polynomialOrder, 1)
        order = qOrder if qOrder is not None else 2 * p + 2
        bary, w = simplexDuffy(order, m)
        vol, gradLam = _geometry(mesh)
        N = dm.num_dofs
        self.num_rows = self.num_columns = N
        if kind == 'mass':
            PHI = dm.evalPhi(bary)
            Mref = np.einsum('q,iq,jq->ij', w, PHI, PHI)
            Aloc = vol[:, None, None] * Mref[None, :, :]
        elif kind == 'stiffness':
            DPHI = dm.evalGradPhi(bary)
            Aloc = np.einsum('c,q,iqk,ckd,jql,cld->cij', vol, w,
                             DPHI, gradLam, DPHI, gradLam, optimize=True)
        else:
            raise NotImplementedError(kind)
        if coefficient is not None:
            V = mesh.vertices[mesh.cells]
            X = np.einsum('qk,ckd->cqd', bary, V)
            cv = np.asarray(coefficient(
                X.reshape(-1, mesh.dim))).reshape(X.shape[0], -1).mean(axis=1)
            Aloc = Aloc * cv[:, None, None]
        dofs = dm.dofs.reshape(-1)
        if dofs.shape[0] >= 2 ** 31:
            raise ValueError('matrixFreeOperator: more than 2^31 - 1 local '
                             'dofs')
        kept = np.nonzero(dofs >= 0)[0]
        rows = kept[np.argsort(dofs[kept], kind='stable')]
        offsets = np.zeros(N + 1, dtype=np.int64)
        np.cumsum(np.bincount(dofs[kept], minlength=N), out=offsets[1:])
        dev = dm.device
        self._Aloc = torch.as_tensor(np.ascontiguousarray(Aloc, dtype=REAL),
                                     device=dev)
        self._dofs = torch.as_tensor(np.where(dm.dofs >= 0, dm.dofs, -1)
                                     .astype(np.int32), device=dev)
        self._order = torch.as_tensor(rows.astype(np.int32), device=dev)
        self._offsets = torch.as_tensor(offsets.astype(np.int32), device=dev)

    @property
    def device(self):
        return self._Aloc.device

    def matvec(self, x, out=None):
        return matfree_apply(self._Aloc, self._dofs, self._order,
                             self._offsets, x, out=out)

    @property
    def diagonal(self):
        return matfree_apply(self._Aloc, self._dofs, self._order,
                             self._offsets, diagonal=True)


def matfree_apply(Aloc, dofs, order, offsets, x=None, out=None,
                  diagonal=False):
    """y [N] with y[i] = sum over the local rows (c, a) of dof i (the
    entries order[offsets[i]:offsets[i+1]] = c dpe + a) of
    sum_b Aloc[c, a, b] x[dofs[c, b]] (a dof < 0 gives 0); ``diagonal``:
    of Aloc[c, a, a], x not read.  Aloc [C, dpe, dpe] and x [N] float64,
    dofs [C, dpe], order and offsets [N+1] int32, all contiguous on one
    device.  Writes into ``out`` [N] when given.

    Kernel K25 (kernels/csrc/matfree_apply.cu) on CUDA tensors, the plain
    version on CPU tensors.  Replaces pynucleus_tpu/fem/assembly.py:321-328
    (matrixFreeOperator's mv) and its diagonal (:333-339)."""
    if Aloc.dim() != 3 or Aloc.dtype != torch.float64 \
            or not Aloc.is_contiguous() or Aloc.shape[1] != Aloc.shape[2]:
        raise ValueError('matfree_apply: Aloc must be a contiguous float64 '
                         '[C, dpe, dpe] tensor')
    C, dpe, _ = Aloc.shape
    dev = Aloc.device
    N = offsets.shape[0] - 1
    checks = [('dofs', dofs, torch.int32, (C, dpe)),
              ('order', order, torch.int32, (order.shape[0],)),
              ('offsets', offsets, torch.int32, (N + 1,))]
    if not diagonal:
        checks.append(('x', x, torch.float64, (N,)))
    for name, t, dt, shape in checks:
        if not isinstance(t, torch.Tensor) or t.dtype != dt \
                or t.shape != shape or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f'matfree_apply: {name} must be a contiguous '
                             f'{dt} {list(shape)} on {dev}')
    if out is None:
        out = torch.empty(N, dtype=torch.float64, device=dev)
    elif out.dtype != torch.float64 or out.shape != (N,) \
            or not out.is_contiguous() or out.device != dev:
        raise ValueError(f'matfree_apply: out must be a contiguous float64 '
                         f'[{N}] on {dev}')
    if dev.type == 'cpu':
        return _matfree_apply_plain(Aloc, dofs, order, offsets, x, out,
                                    diagonal)
    if dev.type != 'cuda':
        raise ValueError(f'matfree_apply: unsupported device {dev}')
    lib = kernels.library()
    kernels.launches['matfree_apply'] += 1
    kernels.deviceLaunches['matfree_apply'] += 1
    kernels.launches['matfree_apply:diagonal' if diagonal else
                     'matfree_apply:apply'] += 1
    p = kernels.ptr
    kernels.check(lib.matfree_apply(p(out), p(Aloc), p(dofs), p(order),
                                    p(offsets), p(out if diagonal else x), N,
                                    dpe, int(diagonal), kernels.stream()))
    return out


def _matfree_apply_plain(Aloc, dofs, order, offsets, x, out, diagonal):
    """Plain PyTorch version of :func:`matfree_apply` (any device): each
    local row's value (its product with the gathered x, summed in b order,
    or its diagonal entry), then each dof's rows added in order as K16's
    plain version adds a slot's contributions."""
    C, dpe, _ = Aloc.shape
    if diagonal:
        vals = torch.diagonal(Aloc, dim1=1, dim2=2)
    else:
        xg = torch.where(dofs >= 0, x[dofs.clamp(min=0).long()], 0.0)
        vals = torch.zeros((C, dpe), dtype=torch.float64, device=Aloc.device)
        for b in range(dpe):
            vals = vals + Aloc[:, :, b] * xg[:, b:b + 1]
    return _csr_scatter_plain(vals.reshape(-1).contiguous(), order, offsets,
                              out)


# -------------------------------------------------- the physical boundary --

def _vertexDofMap(dm: DoFMap):
    """vertex id -> volume dof (interior >= 0; boundary < 0): P1 keeps the
    vertex dofs in the leading local slots."""
    nv = dm.mesh.manifold_dim + 1
    vdof = np.full(dm.mesh.num_vertices, np.iinfo(np.int64).min,
                   dtype=np.int64)
    vdof[dm.mesh.cells[:, :nv].reshape(-1)] = dm.dofs[:, :nv].reshape(-1)
    return vdof


def _boundaryFacets(mesh):
    """The boundary facets: vertices [F, 1] of an interval, edges [F, 2]
    of a 2D mesh (the port has no 3D mesh)."""
    m = mesh.manifold_dim
    if m == 1:
        return mesh.boundaryVertices.reshape(-1, 1)
    if m == 2:
        return mesh.boundaryEdges
    raise NotImplementedError(f'boundary facets of a {m}D mesh')


def assembleSurfaceMass(dm: DoFMap, facets=None):
    """Boundary mass matrix MB_ij = int_{boundary} phi_i phi_j over the
    physical boundary facets, in volume dof numbering (P1), as a scipy CSR
    matrix on the host.  Port of pynucleus_tpu/fem/assembly.py:363."""
    assert dm.polynomialOrder == 1, 'surface mass implemented for P1'
    mesh = dm.mesh
    m = mesh.manifold_dim
    if facets is None:
        facets = _boundaryFacets(mesh)
    vdof = _vertexDofMap(dm)
    N = dm.num_dofs
    if m == 1:
        # the boundary of an interval: point masses
        ii = vdof[facets.reshape(-1)]
        ii = ii[ii >= 0]
        return sp.coo_matrix((np.ones(len(ii)), (ii, ii)),
                             shape=(N, N)).tocsr()
    if m != 2:
        raise NotImplementedError(f'surface mass of a {m}D mesh')
    V = mesh.vertices[facets]                     # [F, m, dim]
    meas = np.linalg.norm(V[:, 1] - V[:, 0], axis=1)
    loc = np.array([[2.0, 1.0], [1.0, 2.0]]) / 6.0
    dr = vdof[facets]                             # [F, m]
    rows, cols, vals = [], [], []
    for a in range(facets.shape[1]):
        for b_ in range(facets.shape[1]):
            r, c = dr[:, a], dr[:, b_]
            keep = (r >= 0) & (c >= 0)
            rows.append(r[keep])
            cols.append(c[keep])
            vals.append(meas[keep] * loc[a, b_])
    return sp.coo_matrix((np.concatenate(vals),
                          (np.concatenate(rows), np.concatenate(cols))),
                         shape=(N, N)).tocsr()


def assembleSurfaceRHS(dm: DoFMap, fun, facets=None, qOrder=3):
    """Boundary load vector b_i = int_{boundary} g phi_i (P1; g evaluated
    one point at a time, complex values kept) as a complex128 host array.
    Port of pynucleus_tpu/fem/assembly.py:404."""
    assert dm.polynomialOrder == 1
    mesh = dm.mesh
    m = mesh.manifold_dim
    if facets is None:
        facets = _boundaryFacets(mesh)
    vdof = _vertexDofMap(dm)
    b = np.zeros(dm.num_dofs, dtype=np.complex128)

    def ev(x):
        return complex(np.asarray(fun(x)).ravel()[0])

    if m == 1:
        for v in facets.reshape(-1):
            i = vdof[v]
            if i >= 0:
                b[i] += ev(mesh.vertices[v])
        return b
    if m != 2:
        raise NotImplementedError(f'surface load of a {m}D mesh')
    bary, w = simplexDuffy(qOrder, m - 1)         # facet simplex
    V = mesh.vertices[facets]                     # [F, m, dim]
    X = np.einsum('qk,fkd->fqd', bary, V)
    gv = np.asarray([ev(x) for x in X.reshape(-1, mesh.dim)],
                    dtype=np.complex128).reshape(X.shape[0], X.shape[1])
    meas = np.linalg.norm(V[:, 1] - V[:, 0], axis=1)
    # P1 facet shape functions = barycentric coordinates
    bloc = np.einsum('f,q,fq,qk->fk', meas, w, gv, bary)
    dr = vdof[facets]
    keep = dr >= 0
    np.add.at(b, dr[keep], bloc[keep])
    return b

"""Local FEM assembly: stiffness and mass in CSR, load vector; kernel K16.

Port of _geometry, buildSparsityPattern, scatterToCSR, assembleMass,
assembleStiffness and assembleRHS of pynucleus_tpu/fem/assembly.py (P1,
no coefficient).  The local matrices [C, dpe, dpe] are host einsums,
code-identical to the JAX package's, and so is the sparsity pattern with
the nnz slot of every local entry.  The sum of the local values into CSR
data runs on the dofmap's device: kernel K16 :func:`csr_scatter` replaces
scatterToCSR's segment sum.  It reads the contributions in an order the
host makes once per dofmap (:func:`scatterPlan`): the kept ones sorted by
slot, stably, with each slot's range in ``offsets``.  The load vector is a
host sum, as in the JAX package.
"""
from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp
import torch

from .. import kernels
from ..config import REAL, INDEX
from ..base.linear_operators import CSR_LinearOperator
from .dofmaps import DoFMap, fe_vector
from .quadrature import simplexDuffy

__all__ = ['assembleMass', 'assembleStiffness', 'localStiffness',
           'assembleRHS', 'buildSparsityPattern', 'scatterPlan',
           'scatterToCSR', 'csr_scatter']


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
    vol, _ = _geometry(mesh)
    bloc = np.einsum('c,q,cq,iq->ci', vol, w, fvals, PHI)
    b = np.zeros(dm.num_dofs, dtype=REAL)
    d = dm.dofs
    mask = d >= 0
    np.add.at(b, d[mask], bloc[mask])
    return fe_vector(torch.as_tensor(b, device=dm.device), dm)

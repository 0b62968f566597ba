"""Hierarchical (H2) operator of the port; kernel K8.

Port of pynucleus_tpu/nl/h2.py for the infinite-horizon kernels, with the
split of the tree at a variable order's jumps and the transposed apply of
a nonsymmetric operator:

  host (numpy, carried over unchanged so both packages build the same tree,
  the same admissible pairs and the same tree-ordered near-field layout):
      chebyshevPoints, batchedChebyshevGrids, _chebLagrange01,
      batchedLagrangeEval, treeNode, dofSupportBoxes, buildClusterTree,
      splitLeavesByKernelBlocks, admissibleClusters
  device (tensors):
      TreeNearOperator   the tree-ordered near field: data [nnz+1] float64
                         (slot nnz is the dump slot of the assembly) and the
                         index tables of its apply
      H2Matrix           near field + Chebyshev far field, level-major
      h2_matvec          the whole H2 apply, kernel K8
                         (kernels/csrc/h2_matvec.cu), beside its plain
                         PyTorch version
      h2_matvec_T        the transposed apply of a nonsymmetric H2Matrix
                         (H.T), kernel K20 (kernels/csrc/h2_matvec.cu),
                         beside its plain version

Node numbering of the device arrays: the tree's nodes are stored level-major
(level 0 first), so node ``pos`` of level ``ell`` is row
``levelOff[ell] + pos`` of the coefficient arrays [nodes, M].  The H2
operator requires the FUSED tree layout of the JAX package (h2.py:765-777):
the near field's node list is the leaf list and every dof lies in exactly
one leaf, so one global->tree gather and one tree->global scatter serve
both the far and the near field.  The layout still holds once a variable
order's leaves are split (the near nodes are then the new leaves, in node
order; the JAX package's fusedTree flag is True for them, checked in
tests/test_torch_varorder.py); H2Matrix raises where it does not.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import kernels
from ..base.linear_operators import LinearOperator

__all__ = ['chebyshevPoints', 'batchedChebyshevGrids', 'batchedLagrangeEval',
           'treeNode', 'dofSupportBoxes', 'buildClusterTree',
           'splitLeavesByKernelBlocks', 'admissibleClusters', 'TreeNearMeta',
           'TreeNearOperator', 'H2Matrix', 'h2_matvec', 'h2_matvec_T']


# ------------------------------------------------------------- Chebyshev ---

def chebyshevPoints(m, a=0.0, b=1.0):
    """First-kind Chebyshev points mapped to [a, b]
    (ref clusterMethodCy assembleFarFieldInteractions:2178)."""
    eta = np.cos((2.0 * np.arange(m, 0, -1) - 1.0) / (2.0 * m) * np.pi)
    return (b - a) * 0.5 * (eta + 1.0) + a


def _tensorDigits(m, dim):
    """[M, dim] digit table: index k of the axis0-major tensor grid has
    digit I[k, d] along axis d."""
    M = m ** dim
    k = np.arange(M)
    I = np.zeros((M, dim), dtype=np.int64)
    for d in range(dim - 1, -1, -1):
        I[:, d] = k % m
        k = k // m
    return I


def batchedChebyshevGrids(m, boxes):
    """boxes [B, dim, 2] -> [B, M, dim] tensor Chebyshev grids."""
    boxes = np.asarray(boxes)
    B, dim, _ = boxes.shape
    eta = chebyshevPoints(m)                         # [m] on [0, 1]
    I = _tensorDigits(m, dim)                        # [M, dim]
    lo = boxes[:, :, 0]                              # [B, dim]
    wid = boxes[:, :, 1] - boxes[:, :, 0]
    return lo[:, None, :] + wid[:, None, :] * eta[I][None, :, :]


def _chebLagrange01(m, t):
    """Standard Chebyshev-Lagrange basis on [0,1] at t [...]-> [..., m]
    (barycentric; exact at nodes)."""
    nodes = chebyshevPoints(m)
    k = np.arange(m)
    wbar = (-1.0) ** k * np.sin((2 * k + 1) * np.pi / (2 * m))
    diff = t[..., None] - nodes                      # [..., m]
    exact = np.abs(diff) < 1e-14
    diff = np.where(exact, 1.0, diff)
    terms = wbar / diff
    L = terms / terms.sum(axis=-1, keepdims=True)
    hit = exact.any(axis=-1)
    if hit.any():
        L[hit] = exact[hit].astype(np.float64)
    return L


def batchedLagrangeEval(m, boxes, X):
    """boxes [B, dim, 2], X [B, n, dim] -> [B, M, n] tensor Chebyshev-Lagrange
    basis values (basis axis0-major, matching batchedChebyshevGrids)."""
    boxes = np.asarray(boxes)
    X = np.asarray(X)
    B, n, dim = X.shape
    lo = boxes[:, None, :, 0]
    wid = boxes[:, None, :, 1] - boxes[:, None, :, 0]
    t = (X - lo) / wid                               # [B, n, dim]
    out = None
    for d in range(dim):
        Ld = _chebLagrange01(m, t[:, :, d]).transpose(0, 2, 1)  # [B, m, n]
        out = Ld if out is None else \
            (out[:, :, None, :] * Ld[:, None, :, :]).reshape(B, -1, n)
    return out


# ------------------------------------------------------------------ tree ---

@dataclass
class treeNode:
    id: int
    level: int
    dofs: np.ndarray          # global dof indices owned by this node
    box: np.ndarray           # [dim, 2]
    parent: int = -1
    children: list = field(default_factory=list)
    mixed: bool = False       # an order jump in its box: never far field

    @property
    def isLeaf(self):
        return len(self.children) == 0


def dofSupportBoxes(dm):
    """Bounding box of each dof's support (ref clusterMethodCy
    getDoFBoxesAndCells:3922)."""
    mesh = dm.mesh
    N = dm.num_dofs
    lo = np.full((N, mesh.dim), np.inf)
    hi = np.full((N, mesh.dim), -np.inf)
    V = mesh.vertices[mesh.cells]        # [C, m+1, dim]
    cl = V.min(axis=1)
    ch = V.max(axis=1)
    d = dm.dofs
    for l in range(d.shape[1]):
        ii = d[:, l]
        mask = ii >= 0
        np.minimum.at(lo, ii[mask], cl[mask])
        np.maximum.at(hi, ii[mask], ch[mask])
    return lo, hi


def buildClusterTree(dm, minSize, maxLevels=200):
    """MEDIAN-split binary tree over dofs (ref tree_node.refine,
    clusterMethodCy.pyx:354)."""
    lo, hi = dofSupportBoxes(dm)
    centers = 0.5 * (lo + hi)
    nodes = []

    def makeBox(idx):
        return np.stack([lo[idx].min(axis=0), hi[idx].max(axis=0)], axis=1)

    def rec(idx, level, parent):
        nid = len(nodes)
        node = treeNode(nid, level, np.sort(idx), makeBox(idx), parent)
        nodes.append(node)
        if len(idx) > minSize and level < maxLevels:
            c = centers[idx]
            ext = c.max(axis=0) - c.min(axis=0)
            axis = int(np.argmax(ext))
            med = np.median(c[:, axis])
            maskL = c[:, axis] <= med
            # guard degenerate splits
            if maskL.all() or not maskL.any():
                order = np.argsort(c[:, axis])
                half = len(idx) // 2
                maskL = np.zeros(len(idx), dtype=bool)
                maskL[order[:half]] = True
            left = idx[maskL]
            right = idx[~maskL]
            if len(left) and len(right):
                node.children = [rec(left, level + 1, nid),
                                 rec(right, level + 1, nid)]
        return nid

    rec(np.arange(dm.num_dofs), 0, -1)
    return nodes


def splitLeavesByKernelBlocks(nodes, dm, kernel):
    """For a spatially varying order, split each leaf into sub-leaves of
    constant order so far-field boxes never straddle an order jump; dofs
    whose support spans the jump form 'mixed' interface nodes that stay in
    the near field (pynucleus_tpu/nl/h2.py:243-300, code-identical)."""
    mesh = dm.mesh
    centers = mesh.vertices[mesh.cells].mean(axis=1)
    sDiag = np.round(np.asarray(kernel.s(centers, centers)).reshape(-1), 12)
    if np.unique(sDiag).shape[0] <= 1:
        return nodes
    N = dm.num_dofs
    INTERFACE = np.nan
    dofOrder = np.full(N, np.inf)
    isInterface = np.zeros(N, dtype=bool)
    d = dm.dofs
    for c in range(mesh.num_cells):
        for l in range(d.shape[1]):
            i = d[c, l]
            if i < 0:
                continue
            if dofOrder[i] == np.inf:
                dofOrder[i] = sDiag[c]
            elif dofOrder[i] != sDiag[c]:
                isInterface[i] = True
    lo, hi = dofSupportBoxes(dm)

    def makeBox(idx):
        return np.stack([lo[idx].min(axis=0), hi[idx].max(axis=0)], axis=1)

    # an s-impure box (dofs of several order blocks, or interface dofs)
    # is never far-field admissible, at any level
    for nd in nodes:
        dKeys = np.where(isInterface[nd.dofs], INTERFACE, dofOrder[nd.dofs])
        nd.mixed = bool(isInterface[nd.dofs].any()
                        or np.unique(dKeys[~np.isnan(dKeys)]).shape[0] > 1)

    for nid in range(len(nodes)):
        nd = nodes[nid]
        if not nd.isLeaf:
            continue
        keys = np.where(isInterface[nd.dofs], INTERFACE, dofOrder[nd.dofs])
        uniqKeys = sorted(set(keys.tolist()), key=lambda v: (np.isnan(v), v))
        if len(uniqKeys) <= 1:
            nd.mixed = bool(isInterface[nd.dofs].any())
            continue
        children = []
        for key in uniqKeys:
            sel = np.isnan(keys) if np.isnan(key) else (keys == key)
            sub = nd.dofs[sel]
            child = treeNode(len(nodes), nd.level + 1, sub, makeBox(sub),
                             nd.id, mixed=bool(np.isnan(key)))
            nodes.append(child)
            children.append(child.id)
        nd.children = children
    return nodes


def _aranges(reps):
    """Concatenated [0..r) ranges for each r in reps (ragged arange)."""
    reps = np.asarray(reps)
    total = int(reps.sum())
    starts = np.repeat(np.cumsum(reps) - reps, reps)
    return np.arange(total) - starts


def admissibleClusters(nodes, eta, interpolation_order, dim,
                       minFarFieldBlockSize=None):
    """Dual-tree traversal -> (Pfar per level, Pnear leaf pairs)
    (ref getAdmissibleClusters clusterMethodCy.pyx:4046, queryAdmissibility
    :4008) for infinite-horizon kernels (the JAX package's horizon screening
    does not arise); a 'mixed' node (an order jump in its box,
    :func:`splitLeavesByKernelBlocks`) is never far.  Far pairs need equal
    levels (the level-batched far apply indexes both coefficients within
    one level)."""
    M = interpolation_order ** dim
    ffSize = minFarFieldBlockSize if minFarFieldBlockSize is not None \
        else M * M

    nN = len(nodes)
    lo = np.stack([nd.box[:, 0] for nd in nodes])
    hi = np.stack([nd.box[:, 1] for nd in nodes])
    diam = np.linalg.norm(hi - lo, axis=1)
    nDofs = np.fromiter((len(nd.dofs) for nd in nodes), np.int64, nN)
    isLeaf = np.fromiter((nd.isLeaf for nd in nodes), bool, nN)
    mixed = np.fromiter((nd.mixed for nd in nodes), bool, nN)
    level = np.fromiter((nd.level for nd in nodes), np.int64, nN)
    cnt = np.fromiter((len(nd.children) for nd in nodes), np.int64, nN)
    childArr = np.concatenate(
        [np.asarray(nd.children, dtype=np.int64) for nd in nodes
         if nd.children] or [np.empty(0, dtype=np.int64)])
    childOff = np.zeros(nN + 1, dtype=np.int64)
    childOff[1:] = np.cumsum(cnt)

    def childrenOf(v):
        """Flattened children of each node in v (ragged, v-major order)."""
        reps = cnt[v]
        idx = np.repeat(childOff[v], reps) + _aranges(reps)
        return childArr[idx]

    farI, farJ = [], []
    nearI, nearJ = [], []
    ii = np.array([0], dtype=np.int64)
    jj = np.array([0], dtype=np.int64)
    while len(ii):
        dvec = np.maximum(np.maximum(lo[ii] - hi[jj], lo[jj] - hi[ii]), 0.0)
        dist = np.linalg.norm(dvec, axis=1)
        sizeProd = nDofs[ii] * nDofs[jj]
        # pairs below the (m^dim)^2 block size need strong separation
        etaEff = np.where(sizeProd >= M * M, eta, 0.5)
        admissible = (etaEff * dist >= np.maximum(diam[ii], diam[jj])) \
            & (ffSize <= sizeProd) & ~mixed[ii] & ~mixed[jj] \
            & (level[ii] == level[jj])
        farI.append(ii[admissible])
        farJ.append(jj[admissible])
        bothLeaf = isLeaf[ii] & isLeaf[jj]
        near = ~admissible & bothLeaf
        nearI.append(ii[near])
        nearJ.append(jj[near])
        ref = ~admissible & ~bothLeaf
        iR, jR = ii[ref], jj[ref]
        # split non-leaves: i leaf -> (i, ch(j)); j leaf -> (ch(i), j);
        # neither -> ch(i) x ch(j)
        A = isLeaf[iR]
        B = isLeaf[jR] & ~A
        Cm = ~isLeaf[iR] & ~isLeaf[jR]
        nxtI = [np.repeat(iR[A], cnt[jR[A]]), childrenOf(iR[B])]
        nxtJ = [childrenOf(jR[A]), np.repeat(jR[B], cnt[iR[B]])]
        iC, jC = iR[Cm], jR[Cm]
        if len(iC):
            ciFlat = childrenOf(iC)                       # i-child, i-major
            repsJ = cnt[np.repeat(jC, cnt[iC])]           # per i-child
            nxtI.append(np.repeat(ciFlat, repsJ))
            nxtJ.append(childrenOf(np.repeat(jC, cnt[iC])))
        ii = np.concatenate(nxtI)
        jj = np.concatenate(nxtJ)

    farI = np.concatenate(farI)
    farJ = np.concatenate(farJ)
    Pfar = {}
    for ell in np.unique(level[farI]):
        sel = level[farI] == ell
        Pfar[int(ell)] = list(zip(farI[sel].tolist(), farJ[sel].tolist()))
    Pnear = list(zip(np.concatenate(nearI).tolist(),
                     np.concatenate(nearJ).tolist()))
    return Pfar, Pnear


# ------------------------------------------------------------ near field ---

class TreeNearMeta:
    """Host structure of the tree-ordered near field (numpy; the names of
    pynucleus_tpu/nl/h2.py _TreeNearMeta).  Every row of near node r has the
    same column template, the concatenation of its partners' tree ranges
    tmplAll[tmplStart[r] : tmplStart[r] + rowLen[r]], so node r's block is
    data[indptrT[tStartRow[r]] :].reshape(tLen[r], rowLen[r])."""

    def __init__(self, indptrT, tmplAll, tmplStart, tStartRow, tLen, rowLen,
                 perm, N):
        self.indptrT = np.asarray(indptrT, dtype=np.int64)    # [Nt+1]
        self.tmplAll = np.asarray(tmplAll, dtype=np.int64)
        self.tmplStart = np.asarray(tmplStart, dtype=np.int64)  # [nNear]
        self.tStartRow = np.asarray(tStartRow, dtype=np.int64)  # [nNear+1]
        self.tLen = np.asarray(tLen, dtype=np.int64)            # [nNear]
        self.rowLen = np.asarray(rowLen, dtype=np.int64)        # [nNear]
        self.perm = np.asarray(perm, dtype=np.int64)  # tree pos -> dof
        self.N = int(N)

    @property
    def nnz(self):
        return int(self.indptrT[-1])


class TreeNearOperator:
    """Near field of the H2 operator in tree order (port of
    pynucleus_tpu/nl/h2.py TreeNearOperator without the padded block copies,
    the global CSR view and an apply of its own: K8 reads each node's block
    in place).

    dataZ [nnz+1] float64 on the device, or float32 (the float32 H2 path:
    pynucleus_tpu/nl/h2.py TreeNearOperator with dtype); slot nnz is the
    assembly's dump slot and is zeroed here."""

    def __init__(self, dataZ, meta):
        m = meta
        nnz = m.nnz
        if dataZ.dtype not in (torch.float64, torch.float32) \
                or dataZ.shape != (nnz + 1,):
            raise ValueError('TreeNearOperator: data must be float64 or '
                             f'float32 [nnz+1] = [{nnz + 1}]')
        if nnz >= (1 << 31):
            raise ValueError('TreeNearOperator: int32 slots need nnz < 2^31')
        self.meta = m
        self.dataZ = dataZ
        dataZ[nnz] = 0.0
        dev = dataZ.device
        Nt = len(m.perm)
        rowNode = np.repeat(np.arange(len(m.tLen)), m.tLen)

        def i32(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                                   device=dev)
        # device tables of the apply (int32: nnz < 2^31 and N < 2^31)
        self.perm = i32(m.perm)
        self.rowNode = i32(rowNode)
        self.indptrT = i32(m.indptrT)
        self.tStartRow = i32(m.tStartRow)
        self.tLen = i32(m.tLen)
        self.rowLen = i32(m.rowLen)
        self.tmplStart = i32(m.tmplStart)
        self.tmplAll = i32(m.tmplAll)
        self.Nt = Nt
        self._diag = None
        self._rowsCols = None

    @property
    def device(self):
        return self.dataZ.device

    @property
    def dtype(self):
        return self.dataZ.dtype

    @property
    def nnz(self):
        return self.meta.nnz

    @property
    def dataT(self):
        return self.dataZ[:self.meta.nnz]

    @property
    def diagonal(self):
        """Diagonal in global dof order: row t's own column sits in node
        r's template at the position of tree index t."""
        if self._diag is None:
            m = self.meta
            slots = np.full(m.N, m.nnz, dtype=np.int64)
            for r in range(len(m.tLen)):
                n, L = int(m.tLen[r]), int(m.rowLen[r])
                if n == 0 or L == 0:
                    continue
                tmpl = m.tmplAll[m.tmplStart[r]:m.tmplStart[r] + L]
                t0 = int(m.tStartRow[r])
                tsel = np.arange(t0, t0 + n)
                pos = np.searchsorted(tmpl, tsel)
                ok = pos < L
                okp = np.where(ok, pos, 0)
                ok &= tmpl[okp] == tsel
                slots[m.perm[tsel[ok]]] = m.indptrT[tsel[ok]] + pos[ok]
            self._diag = self.dataZ[torch.as_tensor(slots,
                                                    device=self.device)]
        return self._diag

    def rowsCols(self):
        """(tree row, tree column) of every stored entry, [nnz] int64 each,
        built on first use (plain apply only)."""
        if self._rowsCols is None:
            m = self.meta
            dev = self.device
            rowlens = np.repeat(m.rowLen, m.tLen)              # [Nt]
            rows = np.repeat(np.arange(len(rowlens)), rowlens)
            rowNode = np.repeat(np.arange(len(m.tLen)), m.tLen)
            cols = m.tmplAll[np.repeat(m.tmplStart[rowNode], rowlens)
                             + _aranges(rowlens)]
            self._rowsCols = (torch.as_tensor(rows, device=dev),
                              torch.as_tensor(cols, device=dev))
        return self._rowsCols

    def __repr__(self):
        return (f'<TreeNearOperator N={self.meta.N} nnz={self.nnz} '
                f'nodes={len(self.meta.tLen)}>')


# ------------------------------------------------------------ H2 operator --

class H2Matrix(LinearOperator):
    """Level-major symmetric H2 operator on the device (port of
    pynucleus_tpu/nl/h2.py H2Matrix in its fused tree layout).

      Anear       TreeNearOperator (node list == leaf list); its data's type
                  (float64, or float32 on the float32 H2 path) is the
                  operator's: leafPhi, T and Kall are cast to it once
      leafPhi     [L, nbar, M]: leaf integrals, row i of leaf l is its i-th
                  dof in tree order
      leafLevelPos (lvlIdx, posIdx) of each leaf
      levels      list over levels of dicts: 'size', and for ell > 0 'T'
                  [size, M, M] (child -> parent transfer, kept as ``Ttr``:
                  ``T`` is the transpose) and 'parentIdx'
                  [size]; far pairs of the level are rows
                  farOff : farOff + farCount of Kall with 'src'/'dst'
                  positions (numpy or tensors)
      Kall        [Pfar, M, M] far blocks (with the -2 factor), level by
                  level
      leafDofs    [L, nbar] host array (pad -1), to check the fused layout
      symmetric   False for a nonsymmetric kernel: ``.T`` is then the
                  transposed operator (K20), else the operator itself

    Raises if the near field's tree layout is not the leaf layout."""

    def __init__(self, Anear, leafPhi, leafLevelPos, levels, Kall, num_rows,
                 leafDofs, symmetric=True):
        dev = Anear.device
        self.symmetric = bool(symmetric)
        self._T = None
        m = Anear.meta
        self.Anear = Anear
        self.num_rows = self.num_columns = int(num_rows)
        L, nbar, M = leafPhi.shape
        leafDofs = np.asarray(leafDofs)
        nNear = len(m.tLen)
        permPad = np.full(nNear * nbar, num_rows, dtype=np.int64)
        permPad[np.repeat(np.arange(nNear), m.tLen) * nbar
                + _aranges(m.tLen)] = m.perm
        fused = (nNear == L and leafDofs.shape == (L, nbar)
                 and int(m.tLen.max()) == nbar and len(m.perm) == num_rows
                 and bool((permPad == np.where(leafDofs >= 0, leafDofs,
                                               num_rows).reshape(-1)).all()))
        if not fused:
            raise ValueError('H2Matrix: the near field tree layout does not '
                             'coincide with the leaf layout; the fused apply '
                             'needs node list == leaf list and one leaf per '
                             'dof')
        self.L, self.nbar, self.M = L, nbar, M
        dt = Anear.dtype
        self.leafPhi = leafPhi.to(device=dev, dtype=dt).contiguous()
        sizes = [int(lv['size']) for lv in levels]
        self.nLvl = len(sizes)
        levelOff = np.zeros(self.nLvl + 1, dtype=np.int64)
        levelOff[1:] = np.cumsum(sizes)
        self.levelOff = levelOff
        nNodes = int(levelOff[-1])
        self.nNodes = nNodes
        lvlIdx, posIdx = (np.asarray(a, dtype=np.int64) for a in leafLevelPos)

        def i32(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                                   device=dev)
        self.leafNode = i32(levelOff[lvlIdx] + posIdx)
        Tall = torch.zeros((nNodes, M, M), dtype=dt, device=dev)
        parent = np.full(nNodes, -1, dtype=np.int64)
        src, dst = [], []
        for ell, lv in enumerate(levels):
            a, b = levelOff[ell], levelOff[ell + 1]
            if ell > 0:
                Tall[a:b] = torch.as_tensor(lv['T'], dtype=dt, device=dev)
                parent[a:b] = levelOff[ell - 1] + _np(lv['parentIdx'])
            if lv.get('farCount', 0):
                if int(lv['farOff']) != sum(len(s_) for s_ in src):
                    raise ValueError('H2Matrix: far blocks must be stored '
                                     'level by level in Kall')
                src.append(a + _np(lv['src']))
                dst.append(a + _np(lv['dst']))
        self.Ttr = Tall
        self.parent = i32(parent)
        self.src = i32(np.concatenate(src) if src else np.zeros(0))
        self.dst = i32(np.concatenate(dst) if dst else np.zeros(0))
        self.Kall = Kall.to(device=dev, dtype=dt).contiguous()
        if self.Kall.shape != (len(self.src), M, M):
            raise ValueError('H2Matrix: Kall must hold one [M, M] block per '
                             'far pair')
        self._work = None       # K8's xt, coef, far, made at its first apply
        self._workT = None      # K20's yt

    @property
    def device(self):
        return self.Anear.device

    @property
    def dtype(self):
        return self.Anear.dtype

    def matvec(self, x, out=None):
        return h2_matvec(self, x, out=out)

    @property
    def diagonal(self):
        return self.Anear.diagonal

    @property
    def T(self):
        """The transpose: the operator itself if symmetric, else its
        transposed apply (pynucleus_tpu/nl/h2.py H2Matrix.T), with
        ``H.T.T is H``."""
        if self.symmetric:
            return self
        if self._T is None:
            self._T = _H2Transpose(self)
        return self._T

    def __repr__(self):
        return (f'<H2Matrix {self.num_rows}x{self.num_columns} '
                f'nnz_near={self.Anear.nnz} farPairs={self.Kall.shape[0]} '
                f'levels={self.nLvl} M={self.M}>')


class _H2Transpose(LinearOperator):
    """Transposed apply of a nonsymmetric H2 operator (pynucleus_tpu/nl/
    h2.py _H2Transpose): the same arrays, applied by K20."""

    def __init__(self, op):
        self.op = op
        self.num_rows = op.num_columns
        self.num_columns = op.num_rows

    @property
    def device(self):
        return self.op.device

    def matvec(self, x, out=None):
        return h2_matvec_T(self.op, x, out=out)

    @property
    def T(self):
        return self.op

    @property
    def diagonal(self):
        return self.op.diagonal


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy().astype(np.int64)
    return np.asarray(a, dtype=np.int64)


# ------------------------------------------------------------------ K8 ----

def _checkApply(name, op, x, out):
    """x and out contiguous [N] of the operator's type (float64, or float32
    with a float32 operator) on its device; a mixed type raises."""
    N, dt = op.num_rows, op.Anear.dtype
    kind = str(dt).split('.')[-1]
    if x.dtype != dt or x.shape != (N,) or not x.is_contiguous() \
            or x.device != op.device:
        raise ValueError(f'{name}: x must be contiguous {kind} [{N}] on '
                         f'{op.device}')
    if out is None:
        out = torch.empty_like(x)
    elif out.dtype != dt or out.shape != (N,) \
            or not out.is_contiguous() or out.device != x.device:
        raise ValueError(f'{name}: out must match x')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name}: unsupported device {x.device}')
    return out


def _work(op, dev):
    if op._work is None:
        dt = op.Anear.dtype
        op._work = (torch.empty(op.Anear.Nt, dtype=dt, device=dev),
                    torch.empty((op.nNodes, op.M), dtype=dt, device=dev),
                    torch.empty((op.nNodes, op.M), dtype=dt, device=dev))
    return op._work


def h2_matvec(op, x, out=None):
    """y = A x for an H2Matrix in its fused tree layout:

      xt = x[perm]                                       global -> tree
      c[leaf] = leafPhi[l]^T xt[leaf rows]               leaf moments
      c[parent(n)] += T[n] c[n]          level by level, finest first
      o[dst(p)] += Kall[p] c[src(p)]                     far field
      o[n] += T[n]^T o[parent(n)]        level by level, coarsest first
      y[perm[t]] = leafPhi[l, i] . o[leaf] + sum_c data[t, c] xt[tmpl(c)]

    (t = tree row i of leaf l; the near block of leaf l is read in place in
    the tree CSR.)  Kernel K8 (kernels/csrc/h2_matvec.cu, one launch per pass
    and level that has work) on CUDA tensors, the plain version on CPU tensors.  Replaces
    pynucleus_tpu/nl/h2.py:_h2_matvec with TreeNearOperator._x2,
    _matvec_tree and _scatter_tree.  A float32 operator (the float32 H2
    path) takes float32 x and out and runs K8's float32 instance (counted
    also as ``h2_matvec:float32``), as _h2_matvec on float32 arrays."""
    out = _checkApply('h2_matvec', op, x, out)
    if x.device.type == 'cpu':
        out.copy_(_h2_matvec_plain(op, x))
        return out
    A = op.Anear
    M = op.M
    xt, coef, far = _work(op, x.device)
    lib = kernels.library()
    kernels.launches['h2_matvec'] += 1
    P = kernels.ptr
    launched = ctypes.c_int(0)
    f32 = x.dtype == torch.float32
    err = (lib.h2_matvec_f32 if f32 else lib.h2_matvec)(
        P(out), P(x), P(xt), P(coef), P(far), A.Nt, op.L, op.nbar, M,
        P(A.perm), P(A.rowNode), P(A.indptrT), P(A.tStartRow), P(A.tLen),
        P(A.rowLen), P(A.tmplStart), P(A.tmplAll), P(A.dataZ),
        P(op.leafPhi), P(op.leafNode), P(op.Ttr), P(op.parent),
        kernels.i64array(op.levelOff), op.nLvl, P(op.Kall), P(op.src),
        P(op.dst), op.Kall.shape[0], ctypes.byref(launched),
        kernels.stream())
    kernels.deviceLaunches['h2_matvec'] += launched.value
    if f32:
        kernels.countVariant('h2_matvec:float32', launched.value)
    kernels.check(err)
    return out


def _h2_matvec_plain(op, x):
    """Plain PyTorch version of :func:`h2_matvec` (any device)."""
    A = op.Anear
    M, nbar = op.M, op.nbar
    perm = A.perm.long()
    xt = x[perm]
    rowNode = A.rowNode.long()
    padIdx = rowNode * nbar + (torch.arange(A.Nt, device=x.device)
                               - A.tStartRow.long()[rowNode])
    x2 = torch.zeros(op.L * nbar, dtype=x.dtype, device=x.device)
    x2[padIdx] = xt
    cLeaf = torch.einsum('lnm,ln->lm', op.leafPhi, x2.view(op.L, nbar))
    coef = torch.zeros((op.nNodes, M), dtype=x.dtype, device=x.device)
    leafNode = op.leafNode.long()
    coef[leafNode] = cLeaf
    parent = op.parent.long()
    off = op.levelOff
    for ell in range(op.nLvl - 1, 0, -1):
        a, b = int(off[ell]), int(off[ell + 1])
        up = torch.einsum('nij,nj->ni', op.Ttr[a:b], coef[a:b])
        coef.index_add_(0, parent[a:b], up)
    far = torch.zeros_like(coef)
    if op.Kall.shape[0]:
        far.index_add_(0, op.dst.long(),
                       torch.einsum('pij,pj->pi', op.Kall,
                                    coef[op.src.long()]))
    for ell in range(1, op.nLvl):
        a, b = int(off[ell]), int(off[ell + 1])
        far[a:b] += torch.einsum('nji,nj->ni', op.Ttr[a:b], far[parent[a:b]])
    yvals = torch.einsum('lnm,lm->ln', op.leafPhi, far[leafNode])
    rows, cols = A.rowsCols()
    yt = yvals.reshape(-1)[padIdx]
    yt.index_add_(0, rows, A.dataT * xt[cols])
    y = torch.empty_like(x)
    y[perm] = yt
    return y


# ------------------------------------------------------------------ K20 ---

def h2_matvec_T(op, x, out=None):
    """y = A^T x for an H2Matrix in its fused tree layout (a nonsymmetric
    operator's transpose; on a symmetric one it equals :func:`h2_matvec`):
    K8's moments and up sweep, then

      o[src(p)] += Kall[p]^T c[dst(p)]       far field, src and dst swapped
      o[n] += T[n]^T o[parent(n)]            level by level, coarsest first
      yt[tmpl(c)] += data[t, c] xt[t]        the near field by columns
      y[perm[t]] = yt[t] + leafPhi[l, i] . o[leaf]

    Kernel K20 (kernels/csrc/h2_matvec.cu h2_matvec_T: K8's near data read
    in place and scattered by column with atomics) on CUDA tensors, the
    plain version on CPU tensors.  Replaces pynucleus_tpu/nl/h2.py
    :_h2_matvec_T with TreeNearOperator.rmatvec.  Float64 alone: a float32
    operator is symmetric (the float32 H2 path's kernel), its ``.T`` is
    itself."""
    if op.Anear.dtype == torch.float32:
        raise NotImplementedError('h2_matvec_T: float64 operators only (the '
                                  'float32 H2 path is symmetric)')
    out = _checkApply('h2_matvec_T', op, x, out)
    if x.device.type == 'cpu':
        out.copy_(_h2_matvec_T_plain(op, x))
        return out
    A = op.Anear
    xt, coef, far = _work(op, x.device)
    if op._workT is None:
        op._workT = torch.empty(A.Nt, dtype=torch.float64, device=x.device)
    lib = kernels.library()
    kernels.launches['h2_matvec_T'] += 1
    P = kernels.ptr
    launched = ctypes.c_int(0)
    err = lib.h2_matvec_T(
        P(out), P(x), P(xt), P(coef), P(far), P(op._workT), A.Nt, op.L,
        op.nbar, op.M, P(A.perm), P(A.rowNode), P(A.indptrT),
        P(A.tStartRow), P(A.tLen), P(A.rowLen), P(A.tmplStart),
        P(A.tmplAll), P(A.dataZ), P(op.leafPhi), P(op.leafNode), P(op.Ttr),
        P(op.parent), kernels.i64array(op.levelOff), op.nLvl, P(op.Kall),
        P(op.src), P(op.dst), op.Kall.shape[0], ctypes.byref(launched),
        kernels.stream())
    kernels.deviceLaunches['h2_matvec_T'] += launched.value
    kernels.check(err)
    return out


def _h2_matvec_T_plain(op, x):
    """Plain PyTorch version of :func:`h2_matvec_T` (any device)."""
    A = op.Anear
    M, nbar = op.M, op.nbar
    perm = A.perm.long()
    xt = x[perm]
    rowNode = A.rowNode.long()
    padIdx = rowNode * nbar + (torch.arange(A.Nt, device=x.device)
                               - A.tStartRow.long()[rowNode])
    x2 = torch.zeros(op.L * nbar, dtype=x.dtype, device=x.device)
    x2[padIdx] = xt
    cLeaf = torch.einsum('lnm,ln->lm', op.leafPhi, x2.view(op.L, nbar))
    coef = torch.zeros((op.nNodes, M), dtype=x.dtype, device=x.device)
    leafNode = op.leafNode.long()
    coef[leafNode] = cLeaf
    parent = op.parent.long()
    off = op.levelOff
    for ell in range(op.nLvl - 1, 0, -1):
        a, b = int(off[ell]), int(off[ell + 1])
        up = torch.einsum('nij,nj->ni', op.Ttr[a:b], coef[a:b])
        coef.index_add_(0, parent[a:b], up)
    far = torch.zeros_like(coef)
    if op.Kall.shape[0]:
        # A^T: pair (dst, src, K) acts as (src, dst, K^T)
        far.index_add_(0, op.src.long(),
                       torch.einsum('pji,pj->pi', op.Kall,
                                    coef[op.dst.long()]))
    for ell in range(1, op.nLvl):
        a, b = int(off[ell]), int(off[ell + 1])
        far[a:b] += torch.einsum('nji,nj->ni', op.Ttr[a:b], far[parent[a:b]])
    yvals = torch.einsum('lnm,lm->ln', op.leafPhi, far[leafNode])
    rows, cols = A.rowsCols()
    yt = yvals.reshape(-1)[padIdx]
    yt.index_add_(0, cols, A.dataT * xt[rows])
    y = torch.empty_like(x)
    y[perm] = yt
    return y

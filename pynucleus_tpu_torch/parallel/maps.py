"""Distributed index maps and import (Trilinos-style).

Port of pynucleus_tpu/parallel/maps.py: ``Map`` (a partition of [0, n)
over parts, owned index sets padded to a common length with -1),
``DistVector`` (per-part blocks [nParts, maxOwned] as a tensor),
``Import`` (a static gather (part, slot) per target slot, one launch of
K29's 2D gather) and ``DistMatrix`` (a row-distributed operator: a CSR
operator stays sparse, one CSR of each part's rows sorted at set-up and
applied by K9; a dense one is stored in row blocks and applied by a plain
product, as the JAX package's einsum).  The host set-up is the JAX
package's numpy code.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import getDevice

__all__ = ['Map', 'Import', 'DistVector', 'DistMatrix']


class Map:
    """Partition of [0, numGlobal) over nParts owners.  ownedIdx is a
    padded [nParts, maxOwned] int array with -1 fill."""

    def __init__(self, ownedIdx, numGlobal):
        self.nParts = len(ownedIdx)
        self.numGlobal = numGlobal
        self.counts = np.array([len(o) for o in ownedIdx])
        self.maxOwned = int(self.counts.max()) if self.nParts else 0
        self.ownedIdx = np.full((self.nParts, self.maxOwned), -1,
                                dtype=np.int64)
        for p, o in enumerate(ownedIdx):
            self.ownedIdx[p, :len(o)] = np.sort(np.asarray(o))
        # owner and local slot of each global index (vectorized fill)
        self.owner = np.full(numGlobal, -1, dtype=np.int64)
        self.slot = np.full(numGlobal, -1, dtype=np.int64)
        valid = self.ownedIdx >= 0
        rows = np.broadcast_to(np.arange(self.nParts)[:, None],
                               self.ownedIdx.shape)
        slots = np.broadcast_to(np.arange(self.maxOwned)[None, :],
                                self.ownedIdx.shape)
        self.owner[self.ownedIdx[valid]] = rows[valid]
        self.slot[self.ownedIdx[valid]] = slots[valid]

    @staticmethod
    def blockDistribution(numGlobal, nParts):
        """Contiguous block partition."""
        bounds = np.linspace(0, numGlobal, nParts + 1).astype(np.int64)
        return Map([np.arange(bounds[p], bounds[p + 1])
                    for p in range(nParts)], numGlobal)

    def getLocalNumElements(self, part):
        return int(self.counts[part])

    def getGlobalElement(self, part, lid):
        return int(self.ownedIdx[part, lid])

    def getLocalElement(self, part, gid):
        if self.owner[gid] == part:
            return int(self.slot[gid])
        return -1

    def __repr__(self):
        return '<Map {} over {} parts>'.format(self.numGlobal, self.nParts)


class DistVector:
    """Vector laid out as padded per-part blocks [nParts, maxOwned] (a
    float64 tensor)."""

    def __init__(self, map_, data=None, device='cuda'):
        self.map = map_
        if data is None:
            data = torch.zeros((map_.nParts, map_.maxOwned),
                               dtype=torch.float64, device=getDevice(device))
        self.data = data

    @staticmethod
    def fromGlobal(map_, x, device='cuda'):
        """The blocks of a global vector x (a tensor keeps its device; an
        array goes to ``device``)."""
        dev = x.device if torch.is_tensor(x) else getDevice(device)
        x = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        valid = map_.ownedIdx >= 0
        out = np.zeros((map_.nParts, map_.maxOwned), dtype=np.float64)
        out[valid] = x[map_.ownedIdx[valid]]
        return DistVector(map_, torch.as_tensor(out, device=dev))

    def toGlobal(self):
        x = np.zeros(self.map.numGlobal)
        d = self.data.detach().cpu().numpy()
        valid = self.map.ownedIdx >= 0
        x[self.map.ownedIdx[valid]] = d[valid]
        return x


class Import:
    """Import values for a target map from a source-distributed vector:
    the exchange pattern is a static gather (srcPart, srcSlot) per target
    slot, built once; the apply is one launch of K29's 2D gather (the
    padding slots read the source's first slot, as the JAX package's
    take)."""

    def __init__(self, sourceMap, targetMap):
        assert sourceMap.numGlobal == targetMap.numGlobal
        self.sourceMap = sourceMap
        self.targetMap = targetMap
        T, S = targetMap, sourceMap
        g = T.ownedIdx
        valid = g >= 0
        gc = np.clip(g, 0, S.numGlobal - 1)
        self.gatherPartH = np.where(valid, S.owner[gc], 0)
        self.gatherSlotH = np.where(valid, S.slot[gc], 0)
        self._dev = {}

    def _tables(self, dev):
        """The gather plan on ``dev`` (moved there at its first use)."""
        if dev not in self._dev:
            self._dev[dev] = (
                torch.as_tensor(self.gatherPartH, device=dev),
                torch.as_tensor(self.gatherSlotH, device=dev),
                torch.ones(self.gatherPartH.shape, dtype=torch.float64,
                           device=dev))
        return self._dev[dev]

    def apply(self, distVec):
        """DistVector on sourceMap -> DistVector on targetMap."""
        from ..kernels.outbox import outbox_gather2d
        data = distVec.data.contiguous()
        gp, gs, ones = self._tables(data.device)
        return DistVector(self.targetMap, outbox_gather2d(data, gp, gs, ones))

    __call__ = apply


class DistMatrix:
    """Row-distributed matrix: per-part row blocks, y_p = A_p x_global.

    A CSR operator (the port's CSR_LinearOperator, or a scipy sparse
    matrix) stays sparse: each part's entries, sorted by their owned row
    slot at set-up (stable, so a row keeps its entry order), make a CSR
    [maxOwned, N] applied by K9.  Any other operator is stored in dense row
    blocks [nParts, maxOwned, N]."""

    def __init__(self, A, rowMap, device=None):
        import scipy.sparse as sp
        from ..base.linear_operators import CSR_LinearOperator
        self.rowMap = rowMap
        P, R = rowMap.nParts, rowMap.maxOwned
        if device is None:
            device = A.device if hasattr(A, 'device') and isinstance(
                A.device, torch.device) else 'cuda'
        dev = getDevice(device)
        self.device = dev
        csr = None
        if isinstance(A, CSR_LinearOperator):
            csr = sp.csr_matrix((A.dataH, A.indicesH, A.indptrH),
                                shape=A.shape)
        elif sp.issparse(A):
            csr = A.tocsr()
        if csr is not None:
            rowids = np.repeat(np.arange(csr.shape[0]), np.diff(csr.indptr))
            cols = csr.indices.astype(np.int64)
            data = np.asarray(csr.data, dtype=np.float64)
            pOf = rowMap.owner[rowids]
            slotOf = rowMap.slot[rowids]
            self._parts = []
            for p in range(P):
                sel = np.nonzero(pOf == p)[0]
                order = np.argsort(slotOf[sel], kind='stable')
                sel = sel[order]
                indptr = np.zeros(R + 1, dtype=np.int64)
                np.cumsum(np.bincount(slotOf[sel], minlength=R),
                          out=indptr[1:])
                self._parts.append(CSR_LinearOperator(
                    indptr, cols[sel], data[sel], num_columns=csr.shape[1],
                    device=dev))
            self.blocks = None
        else:
            arr = np.asarray(A.toarray() if hasattr(A, 'toarray') else
                             (A.detach().cpu().numpy() if torch.is_tensor(A)
                              else A))
            valid = rowMap.ownedIdx >= 0
            blocks = np.zeros((P, R, arr.shape[1]), dtype=arr.dtype)
            blocks[valid] = arr[rowMap.ownedIdx[valid]]
            self.blocks = torch.as_tensor(blocks, device=dev)
            self._parts = None

    def matvec(self, xGlobal):
        """Global x -> DistVector of owned row results."""
        x = torch.as_tensor(xGlobal, dtype=torch.float64, device=self.device)
        if self._parts is not None:
            y = torch.stack([A.matvec(x) for A in self._parts])
        else:
            y = torch.matmul(self.blocks, x)
        return DistVector(self.rowMap, y)

"""Overlapping dof decompositions: mesh overlaps and the algebraic
accumulate, distribute and unique.

Port of pynucleus_tpu/parallel/overlaps.py.  The host set-up (the cell
overlap layers, the overlapping dof partition, the outbox and receive plans
of the overlap manager, the repartition gather plan) is the JAX package's
numpy code, so both packages decompose alike; ``accumulate``,
``distribute`` and ``unique`` keep its host path.  The shard programs run
on a :class:`~pynucleus_tpu_torch.parallel.dist.ShardMesh`:
``shardmapAccumulate`` packs each shard's shared-dof values into its
outbox (K29 pack), all-gathers the outboxes and adds the other copies at
the static receive positions (K29 receive-add); ``Repartitioner.apply``
and ``deviceApply`` gather the target slots from the (all-gathered)
source blocks with K29's masked 2D gather.
"""
from __future__ import annotations

import numpy as np
import torch

from . import collectives as coll

__all__ = ['buildCellOverlap', 'OverlappingDofPartition',
           'AlgebraicOverlapManager', 'Repartitioner',
           'repartitionConnector']


def buildCellOverlap(mesh, cellPartition, depth=1):
    """Per-part local cell lists: own cells plus ``depth`` layers of ghost
    cells from neighboring parts (vertex-adjacency layers, matching the
    reference's overlap regions, meshOverlaps.pyx:1032 getMeshOverlaps
    with the same layer semantics as boundaryLayerCy).

    Returns ``localCells``: list over parts of int64 arrays — own cells
    first (in global order), then ghost cells ordered by layer.
    """
    import scipy.sparse as sp
    cellPartition = np.asarray(cellPartition)
    C = mesh.num_cells
    nv = mesh.cells.shape[1]
    cells = np.asarray(mesh.cells)
    X = sp.coo_matrix((np.ones(C * nv),
                       (np.repeat(np.arange(C), nv), cells.ravel())),
                      shape=(C, mesh.num_vertices)).tocsr()
    Adj = (X @ X.T).tocsr()
    nParts = int(cellPartition.max()) + 1
    localCells = []
    for p in range(nParts):
        own = np.nonzero(cellPartition == p)[0]
        inSet = np.zeros(C, dtype=bool)
        inSet[own] = True
        ghost = []
        cur = inSet.copy()
        for _ in range(depth):
            # all cells vertex-adjacent to the current set, not yet in it
            nxt = np.zeros(C, dtype=bool)
            idx = np.nonzero(cur)[0]
            for c in idx:
                nxt[Adj.indices[Adj.indptr[c]:Adj.indptr[c + 1]]] = True
            nxt &= ~inSet
            ghost.append(np.nonzero(nxt)[0])
            inSet |= nxt
            cur = nxt
        localCells.append(np.concatenate([own] + ghost).astype(np.int64))
    return localCells


class OverlappingDofPartition:
    """Overlapping dof decomposition induced by per-part cell lists.

    For each part: local dofs = union of the dofs of its local cells,
    own-cell dofs first.  Global metadata: ``multiplicity`` (how many parts
    hold each dof), ``ownerOf`` (lowest part whose OWN cells touch the dof
    — the reference's convention that the subdomain containing the dof in
    its non-overlapping region owns it).
    """

    def __init__(self, dm, localCells, numOwnCells=None):
        self.dm = dm
        nParts = len(localCells)
        self.nParts = nParts
        c2d = np.asarray(dm.dofs)                   # [C, dofs_per_element]
        nd = dm.num_dofs
        l2gList = []
        ownDofMask = np.zeros((nParts, nd), dtype=bool)
        holds = np.zeros((nParts, nd), dtype=bool)
        for p, lc in enumerate(localCells):
            nOwn = numOwnCells[p] if numOwnCells is not None else len(lc)
            dAll = c2d[lc].ravel()
            dAll = dAll[dAll >= 0]
            dOwnSet = c2d[lc[:nOwn]].ravel()
            dOwnSet = np.unique(dOwnSet[dOwnSet >= 0])
            dRest = np.setdiff1d(np.unique(dAll), dOwnSet)
            l2g = np.concatenate([dOwnSet, dRest])
            l2gList.append(l2g)
            ownDofMask[p, dOwnSet] = True
            holds[p, l2g] = True
        self.multiplicity = holds.sum(axis=0).astype(np.int64)
        # owner: lowest part with the dof in its own-cell set; fall back to
        # lowest holder (dofs only reached through ghost cells)
        ownerOf = np.full(nd, -1, dtype=np.int64)
        for p in range(nParts - 1, -1, -1):
            ownerOf[ownDofMask[p]] = p
        for p in range(nParts - 1, -1, -1):
            unset = ownerOf < 0
            ownerOf[unset & holds[p]] = p
        self.ownerOf = ownerOf
        self.counts = np.asarray([len(l) for l in l2gList], dtype=np.int64)
        self.maxLocal = max(int(self.counts.max()), 1)
        self.l2g = np.full((nParts, self.maxLocal), -1, dtype=np.int64)
        for p, l in enumerate(l2gList):
            self.l2g[p, :len(l)] = l
        # local slot of each (part, global dof)
        self.slotOf = np.full((nParts, nd), -1, dtype=np.int64)
        for p, l in enumerate(l2gList):
            self.slotOf[p, l] = np.arange(len(l))

    # ---- host-side global <-> local -------------------------------------
    def fromGlobal(self, x):
        x = np.asarray(x)
        out = np.zeros((self.nParts, self.maxLocal), dtype=x.dtype)
        valid = self.l2g >= 0
        out[valid] = x[self.l2g[valid]]
        return out

    def toGlobal(self, X):
        """Owner copy wins (reference 'unique' gather)."""
        X = np.asarray(X)
        x = np.zeros(self.dm.num_dofs, dtype=X.dtype)
        for p in range(self.nParts):
            l = self.l2g[p, :self.counts[p]]
            sel = self.ownerOf[l] == p
            x[l[sel]] = X[p, :self.counts[p]][sel]
        return x


class AlgebraicOverlapManager:
    """accumulate/distribute/unique over an :class:`OverlappingDofPartition`
    (ref algebraicOverlaps.pyx:516 ``algebraicOverlapManager``;
    ``accumulate`` :794, ``distribute`` :1013, ``prepareDistribute`` :558).

    Device path: ``accumulate`` runs inside ``shard_map`` over a device
    mesh axis — each device packs its shared-dof values into a static
    outbox, one ``all_gather`` moves all outboxes, each device adds the
    copies of its shared dofs from the flattened buffer at precomputed
    static positions (a zero pad slot absorbs unused lanes).
    """

    def __init__(self, part: OverlappingDofPartition):
        self.part = part
        nParts, maxLocal = part.nParts, part.maxLocal
        mult = part.multiplicity
        # shared dofs: multiplicity > 1
        sharedPerPart = []
        for p in range(nParts):
            l = part.l2g[p, :part.counts[p]]
            sharedPerPart.append(l[mult[l] > 1])
        maxShared = max([len(s) for s in sharedPerPart] + [1])
        # outbox: device p packs its copies of its shared dofs
        self.packSlot = np.zeros((nParts, maxShared), dtype=np.int64)
        outPos = {}                     # (part, gdof) -> flattened buf pos
        for p, s in enumerate(sharedPerPart):
            self.packSlot[p, :len(s)] = part.slotOf[p, s]
            for j, g in enumerate(s):
                outPos[(p, int(g))] = p * maxShared + j
        # receive plan: for each device's shared dofs, positions of the
        # OTHER parts' copies in the flattened [nParts*maxShared] buffer
        maxCross = max(int(mult.max()) - 1, 1)
        # pad position: point at a slot that is always zero -> use a
        # dedicated zero lane appended to the buffer
        padPos = nParts * maxShared
        self.recvPos = np.full((nParts, maxShared, maxCross), padPos,
                               dtype=np.int64)
        self.recvSlot = np.zeros((nParts, maxShared), dtype=np.int64)
        for p, s in enumerate(sharedPerPart):
            self.recvSlot[p, :len(s)] = part.slotOf[p, s]
            for j, g in enumerate(s):
                k = 0
                for q in range(nParts):
                    if q != p and part.slotOf[q, g] >= 0:
                        self.recvPos[p, j, k] = outPos[(q, int(g))]
                        k += 1
        self.maxShared = maxShared
        # distribute weights: inverse multiplicity partition of unity
        w = np.zeros((nParts, maxLocal))
        valid = part.l2g >= 0
        w[valid] = 1.0 / mult[part.l2g[valid]]
        self.weights = w
        # unique mask: 1 on the owner's copy only
        m = np.zeros((nParts, maxLocal))
        own = valid & (part.ownerOf[np.clip(part.l2g, 0, None)]
                       == np.arange(nParts)[:, None])
        m[own & valid] = 1.0
        self.ownerMask = m

    # ---- host path ------------------------------------------------------
    def accumulate(self, X):
        """X [nParts, maxLocal] -> every copy of a shared dof holds the sum
        of all copies."""
        X = np.asarray(X)
        buf = np.concatenate(
            [X[np.arange(self.part.nParts)[:, None],
               self.packSlot].ravel(), [0.0]])
        add = buf[self.recvPos].sum(axis=-1)       # [nParts, maxShared]
        out = X.copy()
        np.add.at(out, (np.arange(self.part.nParts)[:, None],
                        self.recvSlot), add)
        return out

    def distribute(self, X):
        return np.asarray(X) * self.weights

    def unique(self, X):
        return np.asarray(X) * self.ownerMask

    # ---- device path ----------------------------------------------------
    def shardmapAccumulate(self, mesh, axis='d'):
        """The sharded accumulate on ``mesh`` (a ShardMesh of nParts
        shards): returns run(X), X [nParts, maxLocal] float64 in shard
        order on the mesh's device, which returns the accumulated blocks.
        Each shard packs its shared-dof values into its outbox (K29 pack),
        one all_gather moves the outboxes, and each shard adds the other
        copies of its shared dofs from the flattened buffer at the static
        receive positions (K29 receive-add; the position nParts * maxShared
        is the zero pad lane)."""
        from ..kernels.outbox import outbox_pack, outbox_recv_add
        if mesh.size != self.part.nParts:
            raise ValueError('shardmapAccumulate: the mesh must have one '
                             'shard per part')
        tabs = [(torch.as_tensor(self.packSlot[g.shardsH], device=g.device),
                 torch.as_tensor(self.recvPos[g.shardsH], device=g.device),
                 torch.as_tensor(self.recvSlot[g.shardsH], device=g.device))
                for g in mesh.groups]

        def run(X):
            Xs = mesh.split(X)
            boxes = [outbox_pack(x[:, :, None].contiguous(), ps)[..., 0]
                     for x, (ps, _, _) in zip(Xs, tabs)]
            bufs = coll.all_gather(mesh, boxes)
            outs = [outbox_recv_add(x.clone(), b.reshape(-1), rp, rs)
                    for x, b, (_, rp, rs) in zip(Xs, bufs, tabs)]
            return mesh.join(outs)
        return run


class Repartitioner:
    """Re-shard vectors between two overlapping dof partitions of the same
    dof space (ref repartitioner.pyx:34 ``Repartitioner``: moves a
    subdomain decomposition from one communicator to another; on a device
    mesh this reduces to a STATIC owner-copy gather between the two
    padded layouts — no communicators, one gather plan built once).
    """

    def __init__(self, src: OverlappingDofPartition,
                 tgt: OverlappingDofPartition):
        assert src.dm.num_dofs == tgt.dm.num_dofs
        self.src, self.tgt = src, tgt
        # for each tgt (p, slot): the src owner's (part, slot) of that dof
        g = np.clip(tgt.l2g, 0, None)
        owner = src.ownerOf[g]                          # [ndT, maxLocalT]
        slot = src.slotOf[owner, g]
        valid = tgt.l2g >= 0
        self.gatherPart = np.where(valid, owner, 0).astype(np.int64)
        self.gatherSlot = np.where(valid, np.maximum(slot, 0),
                                   0).astype(np.int64)
        self.validMask = valid

    def _tables(self, dev, rows=None):
        sel = slice(None) if rows is None else rows
        return (torch.as_tensor(self.gatherPart[sel], device=dev),
                torch.as_tensor(self.gatherSlot[sel], device=dev),
                torch.as_tensor(self.validMask[sel], dtype=torch.float64,
                                device=dev))

    def apply(self, X):
        """X [srcParts, srcMaxLocal] (copies of shared dofs must agree,
        i.e. 'accumulated' state) -> [tgtParts, tgtMaxLocal]: the owner
        copies gathered by K29's masked 2D gather (an array gives an array,
        a tensor a tensor on its device)."""
        from ..kernels.outbox import outbox_gather2d
        asArray = not torch.is_tensor(X)
        Xt = torch.as_tensor(np.asarray(X, dtype=np.float64)) if asArray \
            else X.contiguous()
        out = outbox_gather2d(Xt, *self._tables(Xt.device))
        return out.numpy() if asArray else out

    def deviceApply(self, mesh, axis='d'):
        """The sharded re-shard for equal part counts on ``mesh``: returns
        run(X), X [nParts, srcMaxLocal] in shard order on the mesh's
        device: the source blocks move once (all_gather), each shard
        gathers its target slots with static indices (K29's masked 2D
        gather)."""
        from ..kernels.outbox import outbox_gather2d
        if not (mesh.size == self.src.nParts == self.tgt.nParts):
            raise ValueError('deviceApply: equal part counts, one shard '
                             'each')
        tabs = [self._tables(g.device, g.shardsH) for g in mesh.groups]

        def run(X):
            bufs = coll.all_gather(mesh, mesh.split(X))
            return mesh.join([outbox_gather2d(b.contiguous(), *t)
                              for b, t in zip(bufs, tabs)])
        return run


def repartitionConnector(dm, mesh, srcCellPartition, tgtCellPartition,
                         depth=1):
    """Build the (srcPartition, tgtPartition, Repartitioner) triple that
    connects two decompositions of one level — the single-program analogue
    of ref connectors.py:151 ``repartitionConnector.getNewHierarchy``
    (partition the current finest mesh with a new partitioner, move the
    level across, rebuild overlaps on the new decomposition)."""
    srcLocal = buildCellOverlap(mesh, srcCellPartition, depth)
    tgtLocal = buildCellOverlap(mesh, tgtCellPartition, depth)
    nOwnS = [int((np.asarray(srcCellPartition) == p).sum())
             for p in range(len(srcLocal))]
    nOwnT = [int((np.asarray(tgtCellPartition) == p).sum())
             for p in range(len(tgtLocal))]
    srcPart = OverlappingDofPartition(dm, srcLocal, numOwnCells=nOwnS)
    tgtPart = OverlappingDofPartition(dm, tgtLocal, numOwnCells=nOwnT)
    return srcPart, tgtPart, Repartitioner(srcPart, tgtPart)

"""Distributed H2 operator with the H2 structure intact, and the
distributed CSR operator.

Port of pynucleus_tpu/parallel/dist_h2.py on a
:class:`~pynucleus_tpu_torch.parallel.dist.ShardMesh`.  The host set-up is
the JAX package's code: the leaves in tree (DFS) order split into nd
contiguous dof-balanced groups, a node owned by a shard iff all its leaves
live there (the others shared, replicated, O(nd depth) of them), the
packed-outbox exchange plans (point to point: one outbox row per owner and
destination swapped by an all_to_all; ``bcast=True``: one row per owner,
all-gathered), far pairs on the destination's shard (A), on the source's
with a psum for shared destinations (C), or replicated (D).  So both
packages give every shard the same dofs, nodes and pairs: ``_sh`` and
``_rp`` hold the JAX program's shard arrays (numpy, its padding).

The apply runs each phase of the JAX program's body
(pynucleus_tpu/parallel/dist_h2.py:571-710) for all shards of a card in
one launch of K28 (kernels/dist_h2.py), with K29's outboxes
(kernels/outbox.py) for x and the level coefficients and the collectives
of parallel/collectives.py between them; the arrays are the JAX ones with
every pair list sorted by its target into a CSR at set-up, so each output
row is summed by one thread without atomics.

``DistributedCSROperator`` is the row-sharded CSR with the packed-outbox
halo of x (K29), its shards' rows applied by K9 as one block-diagonal CSR
per card.
"""
from __future__ import annotations

import numpy as np
import torch

from . import collectives as coll

__all__ = ['DistributedH2Matrix', 'DistributedCSROperator',
           'dryrunDistributedH2']


def _balancedContiguousPartition(weights, nd):
    """Split ``len(weights)`` items into nd contiguous groups with roughly
    equal weight; returns boundaries [nd+1]."""
    w = np.asarray(weights, dtype=np.float64)
    cw = np.concatenate([[0.0], np.cumsum(w)])
    total = cw[-1]
    bounds = [0]
    for k in range(1, nd):
        b = int(np.searchsorted(cw, total * k / nd))
        bounds.append(min(max(b, bounds[-1]), len(w)))
    bounds.append(len(w))
    return np.asarray(bounds, dtype=np.int64)


def _buildHaloExchange(needPerDev, ownerOf, slotOf, nd, bcast=False):
    """Static packed-outbox exchange plan.

    needPerDev[k]: global ids device k must read but does not own.
    ownerOf[g], slotOf[g]: owning device / local slot of global id g.

    Two modes (the ICI analogues of the reference's communicateNear /
    communicateFar, clusterMethodCy.pyx:3487,3610-3648):

    * point-to-point (default): owner j packs a SEPARATE outbox row per
      destination k; one ``all_to_all`` moves exactly the (j→k) rows, so
      each device receives O(nd * maxPairSend) — the padded analogue of
      the reference's Alltoallv, not a broadcast.  ``sendSlot`` has shape
      [nd, nd, maxPair] (owner, dest, slot; -1 = padding) and ``recvPos``
      is a per-destination list of dicts {globalId -> index into the
      flattened [nd, maxPair] receive buffer of that destination}.
    * ``bcast=True``: every owner packs everything it owns that ANY device
      requested into one row and an ``all_gather`` replicates it — the
      global-vector 'Bcast' semantics of the reference's
      DistributedH2Matrix_globalData (clusterMethodCy.pyx:3127).
      ``sendSlot`` is [nd, maxSend], ``recvPos`` a single shared dict.

    Returns (sendSlot, recvPos, maxSend)."""
    if bcast:
        sendSets = [set() for _ in range(nd)]
        for k in range(nd):
            for g in needPerDev[k]:
                sendSets[int(ownerOf[g])].add(int(g))
        union = set()
        for s in sendSets:
            union |= s
        sendLists = [np.asarray(sorted(g for g in union
                                       if int(ownerOf[g]) == j),
                                dtype=np.int64) for j in range(nd)]
        maxSend = max([len(s) for s in sendLists] + [1])
        sendSlot = np.full((nd, maxSend), -1, dtype=np.int64)
        recvPos = {}
        for j in range(nd):
            ls = sendLists[j]
            if len(ls):
                sendSlot[j, :len(ls)] = slotOf[ls]
            for p, g in enumerate(ls):
                recvPos[int(g)] = j * maxSend + p
        return sendSlot, recvPos, maxSend

    # point-to-point: per-(owner, dest) lists
    pairLists = [[None] * nd for _ in range(nd)]
    maxPair = 1
    for k in range(nd):
        need = np.asarray(sorted(set(int(g) for g in needPerDev[k])),
                          dtype=np.int64)
        owners = ownerOf[need] if len(need) else np.zeros(0, dtype=np.int64)
        for j in range(nd):
            ls = need[owners == j]
            pairLists[j][k] = ls
            maxPair = max(maxPair, len(ls))
    sendSlot = np.full((nd, nd, maxPair), -1, dtype=np.int64)
    recvPos = [dict() for _ in range(nd)]
    for j in range(nd):
        for k in range(nd):
            ls = pairLists[j][k]
            if len(ls):
                sendSlot[j, k, :len(ls)] = slotOf[ls]
            for p, g in enumerate(ls):
                recvPos[k][int(g)] = j * maxPair + p
    return sendSlot, recvPos, maxPair


class DistributedH2Matrix:
    """S4 distributed H2: sharded level-major arrays, halo and cluster
    coefficient exchange, the apply in K28's phases.

    Two construction paths, as in the JAX package:

    * ``DistributedH2Matrix(op, mesh)`` re-shards a built H2Matrix of the
      port (its near rows and columns from ``TreeNearOperator.rowsCols``).
    * ``DistributedH2Matrix.assemble(dm, kernel, mesh)`` partitions first
      and assembles each shard's near-field rows (the 'csr' near format of
      ``_assembleNearField`` on the cluster pairs touching the shard) and
      its far blocks (K7) directly into the sharded layout.

    Vectors are global, on the mesh's device; the apply is float64.  A
    float32 H2 (``params={'dtype': float32}``) is applied in float64 too,
    as the JAX package applies it: every coefficient it shards (near data,
    leaf integrals, transfers, far blocks) upcast to float64 at set-up, the
    float64 K28 and K29, a float32 x taken and a float64 y returned
    (pynucleus_tpu/parallel/dist_h2.py:549-554 shards float64 arrays)."""

    def __init__(self, op, mesh, axis='d', bcast=False):
        from ..nl.h2 import H2Matrix
        assert isinstance(op, H2Matrix), type(op)
        nLvl = op.nLvl
        off = op.levelOff
        parent = op.parent.cpu().numpy().astype(np.int64)
        Ttr = op.Ttr.cpu().numpy().astype(np.float64)
        src = op.src.cpu().numpy().astype(np.int64)
        dst = op.dst.cpu().numpy().astype(np.int64)
        Kall = op.Kall.cpu().numpy().astype(np.float64)
        farLvl = np.searchsorted(off, src, side='right') - 1
        farStart = {}
        farSrcDst = {}
        for ell in range(nLvl):
            sel = np.nonzero(farLvl == ell)[0]
            if len(sel):
                farStart[ell] = int(sel[0])
                farSrcDst[ell] = (src[sel] - off[ell], dst[sel] - off[ell])
        meta = dict(
            N=op.num_rows, symmetric=op.symmetric,
            leafDofs=np.asarray(op.leafDofs),
            leafPhi=op.leafPhi.cpu().numpy().astype(np.float64),
            lvlIdx=np.asarray(op.leafLevelPos[0]),
            posIdx=np.asarray(op.leafLevelPos[1]),
            sizes=[int(off[l + 1] - off[l]) for l in range(nLvl)],
            parentIdx=[None] + [parent[off[l]:off[l + 1]] - off[l - 1]
                                for l in range(1, nLvl)],
            Thost=[None] + [Ttr[off[l]:off[l + 1]] for l in range(1, nLvl)],
            farSrcDst=farSrcDst,
        )

        def getK(ell, idx):
            return Kall[farStart.get(ell, 0) + np.asarray(idx, dtype=np.int64)]

        An = op.Anear
        perm = An.meta.perm
        rows, cols = An.rowsCols()
        rowidsG = perm[rows.cpu().numpy()]
        colsG = perm[cols.cpu().numpy()]
        dataG = An.dataT.cpu().numpy().astype(np.float64)

        def nearRowsFor(k, dofDev):
            sel = dofDev[rowidsG] == k
            return rowidsG[sel], colsG[sel], dataG[sel]

        self._setup(meta, mesh, axis, bcast, getK, nearRowsFor)

    @classmethod
    def assemble(cls, dm, kernel, mesh, axis='d', bcast=False, params=None,
                 zeroExterior=True):
        """Partition-first distributed assembly: the dof partition from the
        cluster tree alone, then each shard's near-field rows and its far
        blocks assembled directly into the sharded layout; no global near
        field and no global far blocks are built (ref nonlocalAssembly
        pxi:2162 reduceNearOp, :2232 drop off-rank, :2401 partitionDoFs,
        :2424 createLocalStuff).  With ``params={'dtype': float32}`` the
        near rows and far blocks are the float32 builder's (K1's, K6's or
        K12's and K7's float32 instances), upcast to float64 for the
        apply."""
        from ..nl.assembly import nonlocalBuilder, far_field, _upload
        # each shard reads its near rows in the 'csr' near format
        builder = nonlocalBuilder(dm, kernel,
                                  params={**(params or {}),
                                          'nearFormat': 'csr'},
                                  zeroExterior=zeroExterior,
                                  device=mesh.device)
        if kernel.finiteHorizon:
            raise NotImplementedError(
                'finite-horizon distributed operators go through '
                'DistributedCSROperator')
        plan = builder.planH2()
        nodes = plan['nodes']
        PnearAll = plan['Pnear']
        dtp = plan['dt']
        gridsAll = plan['gridsAll']
        meta = dict(
            N=dm.num_dofs, symmetric=kernel.symmetric,
            leafDofs=plan['leafDofs'], leafPhi=plan['leafPhi'],
            lvlIdx=plan['lvlIdx'], posIdx=plan['posIdx'],
            sizes=plan['sizes'], parentIdx=plan['parentIdxH'],
            Thost=plan['Thost'], farSrcDst=plan['farSrcDst'],
        )
        prof = kernel.profileParams()

        def getK(ell, idx):
            idx = np.asarray(idx, dtype=np.int64)
            M = plan['M']
            if len(idx) == 0:
                return np.zeros((0, M, M))
            ri, rj = plan['farRows'][ell]
            # the grids in the builder's type (float32: K7's float32
            # instance), the blocks scaled in it and upcast
            gi = _upload(gridsAll[ri[idx]], mesh.device, builder.real)
            gj = _upload(gridsAll[rj[idx]], mesh.device, builder.real)
            return (-2.0 * far_field(gi, gj, prof)).cpu().numpy().astype(
                dtp).astype(np.float64)

        POrdA = np.asarray(PnearAll, dtype=np.int64).reshape(-1, 2)
        firstDof = np.fromiter((nd.dofs[0] for nd in nodes),
                               dtype=np.int64, count=len(nodes))

        def nearRowsFor(k, dofDev):
            # pairs touching shard k (both orderings are in Pnear);
            # cross-shard pairs are assembled on both owners, each keeping
            # its own rows
            devP = dofDev[firstDof[POrdA]]
            Pk = [tuple(p) for p in POrdA[(devP == k).any(axis=1)]]
            sub = builder._assembleNearField(Pk, nodes)
            rows = np.repeat(np.arange(sub.num_rows), np.diff(sub.indptrH))
            cols = sub.indicesH.astype(np.int64)
            data = sub.dataH
            sel = dofDev[rows] == k
            return rows[sel], cols[sel], data[sel]

        self = cls.__new__(cls)
        self._setup(meta, mesh, axis, bcast, getK, nearRowsFor)
        return self

    def _setup(self, meta, mesh, axis, bcast, getK, nearRowsFor):
        self.mesh = mesh
        self.axis = axis
        self.bcast = bcast
        nd = int(mesh.devices.size)
        self.nd = nd
        N = meta['N']
        self.num_rows = self.num_columns = N
        self.symmetric = meta['symmetric']
        M = meta['leafPhi'].shape[2]
        nLvl = len(meta['sizes'])

        leafDofs = meta['leafDofs']
        leafPhi = meta['leafPhi']
        lvlIdx = meta['lvlIdx']
        posIdx = meta['posIdx']
        L, maxLeafN = leafDofs.shape
        sizes = meta['sizes']
        parentIdx = meta['parentIdx']

        # ---- 1. leaf partition (contiguous in DFS order, dof-balanced)
        leafCnt = (leafDofs >= 0).sum(axis=1)
        bounds = _balancedContiguousPartition(leafCnt, nd)
        leafDev = np.zeros(L, dtype=np.int64)
        for k in range(nd):
            leafDev[bounds[k]:bounds[k + 1]] = k

        # ---- 2. node ownership: owned iff all descendant leaves on one dev
        devMin = [np.full(s, nd, dtype=np.int64) for s in sizes]
        devMax = [np.full(s, -1, dtype=np.int64) for s in sizes]
        for ell in range(nLvl):
            sel = lvlIdx == ell
            np.minimum.at(devMin[ell], posIdx[sel], leafDev[sel])
            np.maximum.at(devMax[ell], posIdx[sel], leafDev[sel])
        for ell in range(nLvl - 1, 0, -1):
            np.minimum.at(devMin[ell - 1], parentIdx[ell], devMin[ell])
            np.maximum.at(devMax[ell - 1], parentIdx[ell], devMax[ell])
        owned = [(devMin[l] == devMax[l]) & (devMax[l] >= 0)
                 for l in range(nLvl)]
        posDev = devMin

        # ---- 3. per-level slot maps
        ownSlot = [np.full(s, -1, dtype=np.int64) for s in sizes]
        shrSlot = [np.full(s, -1, dtype=np.int64) for s in sizes]
        maxOwn = []
        ownMap = []
        shrList = []
        for ell in range(nLvl):
            cnt = np.zeros(nd, dtype=np.int64)
            for p in range(sizes[ell]):
                if owned[ell][p]:
                    k = posDev[ell][p]
                    ownSlot[ell][p] = cnt[k]
                    cnt[k] += 1
            mo = int(cnt.max()) if sizes[ell] else 0
            maxOwn.append(mo)
            om = np.full((nd, max(mo, 1)), -1, dtype=np.int64)
            c2 = np.zeros(nd, dtype=np.int64)
            sl = []
            for p in range(sizes[ell]):
                if owned[ell][p]:
                    k = posDev[ell][p]
                    om[k, c2[k]] = p
                    c2[k] += 1
                else:
                    shrSlot[ell][p] = len(sl)
                    sl.append(p)
            ownMap.append(om)
            shrList.append(np.asarray(sl, dtype=np.int64))
        nShr = [len(s) for s in shrList]

        # ---- 4. dof permutation: device-major, then leaf DFS order
        dofDev = np.full(N, -1, dtype=np.int64)
        dofSlot = np.full(N, -1, dtype=np.int64)
        rowsPer = np.zeros(nd, dtype=np.int64)
        leafOrderPerDev = [[] for _ in range(nd)]
        for li in range(L):
            leafOrderPerDev[leafDev[li]].append(li)
        for k in range(nd):
            slot = 0
            for li in leafOrderPerDev[k]:
                ds = leafDofs[li][leafDofs[li] >= 0]
                for g in ds:
                    dofDev[g] = k
                    dofSlot[g] = slot
                    slot += 1
            rowsPer[k] = slot
        assert (dofDev >= 0).all(), 'leaves must partition the dofs'
        R = int(rowsPer.max())
        self.R = R
        localDof = np.full((nd, R), -1, dtype=np.int64)
        localDof[dofDev, dofSlot] = np.arange(N)
        self._localDofFlat = localDof.reshape(-1)

        # ---- 5. leaf arrays per device
        LP = max(max(len(l) for l in leafOrderPerDev), 1)
        lfPhiD = np.zeros((nd, LP, maxLeafN, M))
        lfXslot = np.full((nd, LP, maxLeafN), R, dtype=np.int64)  # ghost=R
        lfLvl = np.full((nd, LP), -1, dtype=np.int64)
        lfSlot = np.zeros((nd, LP), dtype=np.int64)
        for k in range(nd):
            for q, li in enumerate(leafOrderPerDev[k]):
                lfPhiD[k, q] = leafPhi[li]
                sel = leafDofs[li] >= 0
                lfXslot[k, q, sel] = dofSlot[leafDofs[li][sel]]
                ell, p = int(lvlIdx[li]), int(posIdx[li])
                lfLvl[k, q] = ell
                lfSlot[k, q] = ownSlot[ell][p]
                assert owned[ell][p], 'leaves are always owned'

        # ---- 6. transfer arrays per level
        Town, parOwnS, parShrS, Tshr, parShr = [None], [None], [None], \
            [None], [None]
        for ell in range(1, nLvl):
            T = meta['Thost'][ell]
            par = parentIdx[ell]
            mo, moP = maxOwn[ell], maxOwn[ell - 1]
            to = np.zeros((nd, max(mo, 1), M, M))
            po = np.full((nd, max(mo, 1)), moP, dtype=np.int64)      # ghost
            ps = np.full((nd, max(mo, 1)), nShr[ell - 1],
                         dtype=np.int64)                             # ghost
            for k in range(nd):
                for s in range(mo):
                    p = ownMap[ell][k, s]
                    if p < 0:
                        continue
                    to[k, s] = T[p]
                    pp = int(par[p])
                    if owned[ell - 1][pp]:
                        po[k, s] = ownSlot[ell - 1][pp]
                    else:
                        ps[k, s] = shrSlot[ell - 1][pp]
            Town.append(to)
            parOwnS.append(po)
            parShrS.append(ps)
            sl = shrList[ell]
            Tshr.append(T[sl] if len(sl) else np.zeros((0, M, M)))
            pshr = np.zeros(len(sl), dtype=np.int64)
            for q, p in enumerate(sl):
                pp = int(par[p])
                assert not owned[ell - 1][pp], \
                    'a shared node cannot have an owned parent'
                pshr[q] = shrSlot[ell - 1][pp]
            parShr.append(pshr)

        # ---- 7. far pairs per level: A (owned dst), C (shared dst, owned
        # src, on src's device + psum), D (both shared, replicated)
        farMeta = {}
        for ell in range(nLvl):
            if ell not in meta['farSrcDst']:
                continue
            src, dst = meta['farSrcDst'][ell]
            src = np.asarray(src)
            dst = np.asarray(dst)
            sOwn = owned[ell][src]
            dOwn = owned[ell][dst]
            isA = dOwn
            isC = ~dOwn & sOwn
            isD = ~dOwn & ~sOwn
            devA = posDev[ell][dst[isA]]
            devC = posDev[ell][src[isC]]
            # coefficient outbox: remote owned srcs needed by A pairs
            needC = [[] for _ in range(nd)]
            srcA, dstA = src[isA], dst[isA]
            for p in range(len(srcA)):
                k = int(devA[p])
                sp = int(srcA[p])
                if owned[ell][sp] and posDev[ell][sp] != k:
                    needC[k].append(sp)
            ownerOf = posDev[ell]
            sendSlotC, recvPosC, maxSendC = _buildHaloExchange(
                needC, ownerOf, ownSlot[ell], nd, bcast=bcast)

            def _rposC(k, g, recvPosC=recvPosC, bcast=bcast):
                return recvPosC[g] if bcast else recvPosC[k][g]
            mo = maxOwn[ell]
            ceLen = mo + nShr[ell] + nd * maxSendC
            cntA = np.bincount(devA, minlength=nd) if len(devA) else \
                np.zeros(nd, dtype=np.int64)
            mpa = max(int(cntA.max()) if len(devA) else 0, 1)
            KA = np.zeros((nd, mpa, M, M))
            srcIA = np.full((nd, mpa), ceLen, dtype=np.int64)        # ghost
            dstIA = np.full((nd, mpa), max(mo, 1), dtype=np.int64)   # ghost
            fill = np.zeros(nd, dtype=np.int64)
            Ka = getK(ell, np.nonzero(isA)[0])
            for p in range(len(srcA)):
                k = int(devA[p])
                q = fill[k]
                fill[k] += 1
                KA[k, q] = Ka[p]
                dstIA[k, q] = ownSlot[ell][dstA[p]]
                sp = int(srcA[p])
                if owned[ell][sp]:
                    if posDev[ell][sp] == k:
                        srcIA[k, q] = ownSlot[ell][sp]
                    else:
                        srcIA[k, q] = mo + nShr[ell] + _rposC(k, sp)
                else:
                    srcIA[k, q] = mo + shrSlot[ell][sp]
            # C pairs
            srcC, dstC = src[isC], dst[isC]
            cntC = np.bincount(devC, minlength=nd) if len(devC) else \
                np.zeros(nd, dtype=np.int64)
            mpc = max(int(cntC.max()) if len(devC) else 0, 1)
            KC = np.zeros((nd, mpc, M, M))
            srcIC = np.full((nd, mpc), max(mo, 1), dtype=np.int64)   # ghost
            dstIC = np.full((nd, mpc), nShr[ell], dtype=np.int64)    # ghost
            fill = np.zeros(nd, dtype=np.int64)
            Kc = getK(ell, np.nonzero(isC)[0])
            for p in range(len(srcC)):
                k = int(devC[p])
                q = fill[k]
                fill[k] += 1
                KC[k, q] = Kc[p]
                srcIC[k, q] = ownSlot[ell][srcC[p]]
                dstIC[k, q] = shrSlot[ell][dstC[p]]
            # D pairs (replicated)
            KD = getK(ell, np.nonzero(isD)[0])
            srcID = shrSlot[ell][src[isD]]
            dstID = shrSlot[ell][dst[isD]]
            farMeta[ell] = dict(maxSendC=maxSendC, ceLen=ceLen,
                                hasD=len(KD) > 0)
            self.__dict__.setdefault('_farArrs', {})[ell] = dict(
                KA=KA, srcIA=srcIA, dstIA=dstIA, KC=KC, srcIC=srcIC,
                dstIC=dstIC, sendSlotC=sendSlotC,
                KD=KD, srcID=srcID, dstID=dstID)
        self._farMeta = farMeta

        # ---- 8. near-field CSR row blocks + halo plan (per-device rows
        # come from nearRowsFor: global-CSR slices in wrap mode, directly
        # assembled shards in assemble mode)
        perK = [nearRowsFor(k, dofDev) for k in range(nd)]
        needX = [np.unique(c[dofDev[c] != k]).tolist()
                 for k, (_, c, _) in enumerate(perK)]
        sendSlotX, recvPosX, maxSendX = _buildHaloExchange(
            needX, dofDev, dofSlot, nd, bcast=bcast)
        xeLen = R + nd * maxSendX
        maxNnz = max(max(len(r) for (r, _, _) in perK), 1)
        nearRow = np.full((nd, maxNnz), R, dtype=np.int64)           # ghost
        nearCol = np.full((nd, maxNnz), xeLen, dtype=np.int64)       # ghost
        nearDat = np.zeros((nd, maxNnz))
        for k, (rk, ck, dk) in enumerate(perK):
            nk = len(rk)
            nearRow[k, :nk] = dofSlot[rk]
            loc = dofDev[ck] == k
            ci = np.empty(nk, dtype=np.int64)
            ci[loc] = dofSlot[ck[loc]]
            if (~loc).any():
                rpk = recvPosX if bcast else recvPosX[k]
                ci[~loc] = [R + rpk[int(g)] for g in ck[~loc]]
            nearCol[k, :nk] = ci
            nearDat[k, :nk] = dk

        # ---- 9. the shard arrays in the JAX program's layout (host numpy,
        # its padding), then the kernels' layout on every shard group
        sh = dict(
            lfPhi=lfPhiD, lfXslot=lfXslot, lfLvl=lfLvl, lfSlot=lfSlot,
            nearRow=nearRow, nearCol=nearCol, nearDat=nearDat,
            # [nd, maxSend]: shard k packs ITS outbox row
            sendSlotX=sendSlotX,
        )
        rp = {}
        for ell in range(1, nLvl):
            sh[f'Town{ell}'] = Town[ell]
            sh[f'parOwnS{ell}'] = parOwnS[ell]
            sh[f'parShrS{ell}'] = parShrS[ell]
            rp[f'Tshr{ell}'] = Tshr[ell]
            rp[f'parShr{ell}'] = parShr[ell]
        for ell, arrs in getattr(self, '_farArrs', {}).items():
            for nm in ('KA', 'srcIA', 'dstIA', 'KC', 'srcIC', 'dstIC',
                       'sendSlotC'):
                sh[f'far{nm}{ell}'] = arrs[nm]
            if farMeta[ell]['hasD']:
                for nm in ('KD', 'srcID', 'dstID'):
                    rp[f'far{nm}{ell}'] = arrs[nm]
        self._meta = dict(nLvl=nLvl, M=M, R=R, LP=LP, maxLeafN=maxLeafN,
                          maxOwn=tuple(maxOwn), nShr=tuple(nShr),
                          maxSendX=maxSendX, xeLen=xeLen, N=N)
        self._sh, self._rp = sh, rp
        self._localDof = localDof
        if hasattr(self, '_farArrs'):
            del self._farArrs
        self._build()

    # ------------------------------------------------- the kernels' layout --
    def _build(self):
        """Per shard group, the tensors of K28's phases: the level
        coefficients in one array of rows (level l's owned nodes at
        ownOff[l], at least one row each; its shared ones at shrOff[l]),
        the near rows and every pair list as CSRs by target."""
        m, sh, rp, nd = self._meta, self._sh, self._rp, self.nd
        nLvl, M, R = m['nLvl'], m['M'], m['R']
        maxOwn, nShr = m['maxOwn'], m['nShr']
        ownRows = [max(mo, 1) for mo in maxOwn]
        ownOff = np.concatenate([[0], np.cumsum(ownRows)]).astype(np.int64)
        shrOff = np.concatenate([[0], np.cumsum(nShr)]).astype(np.int64)
        ownTot, shrTot = int(ownOff[-1]), max(int(shrOff[-1]), 1)
        self._ownOff, self._shrOff = ownOff, shrOff
        self._ownTot, self._shrTot = ownTot, shrTot

        def csrBy(tgt, n):
            """(order, ptr) of a stable sort by target, n targets."""
            order = np.argsort(tgt, kind='stable')
            ptr = np.zeros(n + 1, dtype=np.int64)
            np.cumsum(np.bincount(tgt, minlength=n), out=ptr[1:])
            return order, ptr

        def padStack(lists, fill):
            """The int64 arrays of each shard padded with fill."""
            n = max([len(a) for a in lists] + [1])
            out = np.full((len(lists), n), fill, dtype=np.int64)
            for k, a in enumerate(lists):
                out[k, :len(a)] = a
            return out

        lfLvl, lfSlot = sh['lfLvl'], sh['lfSlot']
        H = dict(lfPhi=sh['lfPhi'], lfXslot=sh['lfXslot'],
                 lfRow=np.where(lfLvl >= 0, ownOff[np.maximum(lfLvl, 0)]
                                + lfSlot, -1),
                 localDof=self._localDof,
                 sendSlotX=sh['sendSlotX'].reshape(nd, -1))
        # near rows: each shard's entries sorted by row (stable)
        ptrs, cols, dats = [], [], []
        for k in range(nd):
            real = sh['nearRow'][k] < R
            r = sh['nearRow'][k][real]
            order, ptr = csrBy(r, R)
            ptrs.append(ptr)
            cols.append(sh['nearCol'][k][real][order])
            dats.append(sh['nearDat'][k][real][order])
        H['nearPtr'] = np.stack(ptrs)
        H['nearCol'] = padStack(cols, m['xeLen'])
        H['nearDat'] = _padFloat(dats)
        # transfers and parents, level by level
        Town = np.zeros((nd, ownTot, M, M))
        parOwnRow = np.full((nd, ownTot), -1, dtype=np.int64)
        parShrRow = np.full((nd, ownTot), -1, dtype=np.int64)
        Tshr = np.zeros((shrTot, M, M))
        shrParRow = np.full(shrTot, -1, dtype=np.int64)
        up = {}
        for ell in range(1, nLvl):
            o, n = ownOff[ell], ownRows[ell]
            Town[:, o:o + n] = sh[f'Town{ell}']
            po, ps = sh[f'parOwnS{ell}'], sh[f'parShrS{ell}']
            moP, nShrP = maxOwn[ell - 1], nShr[ell - 1]
            parOwnRow[:, o:o + n] = np.where(po < moP, ownOff[ell - 1] + po,
                                             -1)
            parShrRow[:, o:o + n] = np.where(ps < nShrP,
                                             shrOff[ell - 1] + ps, -1)
            if nShr[ell]:
                s0 = shrOff[ell]
                Tshr[s0:s0 + nShr[ell]] = rp[f'Tshr{ell}']
                shrParRow[s0:s0 + nShr[ell]] = shrOff[ell - 1] \
                    + rp[f'parShr{ell}']
            # the children of each parent of level ell - 1: the owned
            # parents first, then the shared ones
            ptrs, idxs = [], []
            for k in range(nd):
                real = (po[k] < moP) | (ps[k] < nShrP)
                s = np.nonzero(real)[0]
                tgt = np.where(po[k][s] < moP, po[k][s], moP + ps[k][s])
                order, ptr = csrBy(tgt, moP + nShrP)
                ptrs.append(ptr)
                idxs.append(s[order])
            order, sptr = csrBy(rp[f'parShr{ell}'], nShrP)
            up[ell] = dict(ptr=np.stack(ptrs), idx=padStack(idxs, 0),
                           sptr=sptr, sidx=order.astype(np.int64))
        H.update(Town=Town, parOwnRow=parOwnRow, parShrRow=parShrRow)
        R_ = dict(Tshr=Tshr, shrParRow=shrParRow)
        # far pairs per level: A by owned destination, C by shared
        # destination (this shard's owned sources), D by shared destination
        far = {}
        for ell, fm in self._farMeta.items():
            mo, ns = maxOwn[ell], nShr[ell]
            KA, srcIA, dstIA = (sh[f'far{nm}{ell}'] for nm in
                                ('KA', 'srcIA', 'dstIA'))
            KC, srcIC, dstIC = (sh[f'far{nm}{ell}'] for nm in
                                ('KC', 'srcIC', 'dstIC'))
            f = {}
            for nmK, nmS, nmP, K_, s_, d_, nT, fill in (
                    ('KA', 'srcA', 'ptrA', KA, srcIA, dstIA, mo, fm['ceLen']),
                    ('KC', 'srcC', 'ptrC', KC, srcIC, dstIC, ns, 0)):
                ptrs, srcs, Ks = [], [], []
                for k in range(nd):
                    e = np.nonzero(d_[k] < nT)[0]
                    order, ptr = csrBy(d_[k][e], nT)
                    ptrs.append(ptr)
                    srcs.append(s_[k][e[order]])
                    Ks.append(K_[k][e[order]])
                f[nmP] = np.stack(ptrs)
                f[nmS] = padStack(srcs, fill)
                f[nmK] = _padFloat(Ks, (M, M))
            if fm['hasD']:
                order, ptrD = csrBy(rp[f'fardstID{ell}'], ns)
                f.update(ptrD=ptrD, srcD=rp[f'farsrcID{ell}'][order],
                         KD=rp[f'farKD{ell}'][order])
            else:
                f.update(ptrD=np.zeros(ns + 1, dtype=np.int64),
                         srcD=np.zeros(0, dtype=np.int64),
                         KD=np.zeros((0, M, M)))
            slotC = sh[f'farsendSlotC{ell}']
            f['sendSlotC'] = np.where(slotC >= 0, slotC + ownOff[ell],
                                      -1).reshape(nd, -1)
            far[ell] = f
        self._groups = []
        for g in self.mesh.groups:
            dev = g.device

            def S(a, g=g, dev=dev):     # the group's shards of an array
                return torch.as_tensor(np.ascontiguousarray(a[g.shardsH]),
                                       device=dev)

            def T(a, dev=dev):          # one copy for every shard
                return torch.as_tensor(np.ascontiguousarray(a), device=dev)
            G = {k: S(v) for k, v in H.items()}
            G.update({k: T(v) for k, v in R_.items()})
            G['up'] = {ell: dict(ptr=S(u['ptr']), idx=S(u['idx']),
                                 sptr=T(u['sptr']), sidx=T(u['sidx']))
                       for ell, u in up.items()}
            G['far'] = {ell: {k: (T(v) if k in ('ptrD', 'srcD', 'KD')
                                  else S(v)) for k, v in f.items()}
                        for ell, f in far.items()}
            valid = self._localDof[g.shardsH].reshape(-1) >= 0
            G['yFrom'] = torch.as_tensor(np.nonzero(valid)[0], device=dev)
            G['yTo'] = torch.as_tensor(
                self._localDof[g.shardsH].reshape(-1)[valid],
                device=self.mesh.device)
            G['nk'] = g.size
            self._groups.append(G)

    # -------------------------------------------------------------- apply --
    @property
    def device(self):
        return self.mesh.device

    @property
    def dtype(self):
        return torch.float64

    def matvec(self, x, out=None):
        """y = A x, float64, for a global float64 or float32 x [N] on the
        mesh's device (float32: upcast, as the JAX program takes it)."""
        from ..kernels.outbox import outbox_pack
        from ..kernels import dist_h2 as K
        mesh, m = self.mesh, self._meta
        nLvl, M, R = m['nLvl'], m['M'], m['R']
        maxOwn, nShr = m['maxOwn'], m['nShr']
        ownOff, shrOff = self._ownOff, self._shrOff
        N = self.num_rows
        if x.dtype not in (torch.float64, torch.float32) or x.shape != (N,) \
                or x.device != mesh.device:
            raise ValueError(f'DistributedH2Matrix: x must be float64 or '
                             f'float32 [{N}] on {mesh.device}')
        Gs = self._groups
        xc = x.contiguous().to(torch.float64)
        # communicateNear: the shards' rows of x, their outboxes, the swap
        xl = [outbox_pack(xc.to(G['lfPhi'].device)[None, :, None],
                          G['localDof'])[..., 0] for G in Gs]
        box = [outbox_pack(a[:, :, None], G['sendSlotX'])[..., 0]
               for a, G in zip(xl, Gs)]
        if self.bcast:
            bufX = [b.reshape(1, -1) for b in coll.all_gather(mesh, box)]
        else:
            bufX = [b.reshape(G['nk'], -1) for b, G in zip(
                coll.all_to_all(mesh, [b.reshape(G['nk'], self.nd, -1)
                                       for b, G in zip(box, Gs)]), Gs)]
        ys, own, shr = [], [], []
        for a, b, G in zip(xl, bufX, Gs):
            dev, nk = a.device, G['nk']
            y = torch.empty((nk, R), dtype=torch.float64, device=dev)
            ys.append(K.dist_h2_near(y, a, b, G['nearPtr'], G['nearCol'],
                                     G['nearDat']))
            o = torch.zeros((nk, self._ownTot, M), dtype=torch.float64,
                            device=dev)
            own.append(K.dist_h2_moments(o, a, G['lfPhi'], G['lfXslot'],
                                         G['lfRow']))
            shr.append(torch.zeros((nk, self._shrTot, M),
                                   dtype=torch.float64, device=dev))
        # upward pass
        for ell in range(nLvl - 1, 0, -1):
            part = [K.dist_h2_up(o, G['Town'], G['up'][ell]['ptr'],
                                 G['up'][ell]['idx'], maxOwn[ell - 1],
                                 nShr[ell - 1], int(ownOff[ell]),
                                 int(ownOff[ell - 1]))
                    for o, G in zip(own, Gs)]
            if nShr[ell - 1]:
                for s, p, G in zip(shr, coll.psum(mesh, part), Gs):
                    u = G['up'][ell]
                    K.dist_h2_up_shared(s, p.contiguous(), G['Tshr'],
                                        u['sptr'], u['sidx'],
                                        int(shrOff[ell]),
                                        int(shrOff[ell - 1]))
        # far field
        outOwn = [torch.zeros_like(o) for o in own]
        outShr = [torch.zeros_like(s) for s in shr]
        for ell in sorted(self._farMeta):
            level = (int(ownOff[ell]), int(shrOff[ell]), maxOwn[ell],
                     nShr[ell])
            cbox = [outbox_pack(o, G['far'][ell]['sendSlotC'])
                    for o, G in zip(own, Gs)]
            if self.bcast:
                bufC = [b.reshape(1, -1, M) for b in
                        coll.all_gather(mesh, cbox)]
            else:
                bufC = [b.reshape(G['nk'], -1, M) for b, G in zip(
                    coll.all_to_all(mesh, [c.reshape(G['nk'], self.nd, -1, M)
                                           for c, G in zip(cbox, Gs)]), Gs)]
            partC = []
            for oo, o, s, b, G in zip(outOwn, own, shr, bufC, Gs):
                f = G['far'][ell]
                partC.append(K.dist_h2_far(
                    oo, o, s, b.contiguous(), level, f['ptrA'], f['srcA'],
                    f['KA'], f['ptrC'], f['srcC'], f['KC']))
            if nShr[ell]:
                for os_, s, p, G in zip(outShr, shr, coll.psum(mesh, partC),
                                        Gs):
                    f = G['far'][ell]
                    K.dist_h2_far_shared(os_, s, p.contiguous(),
                                         int(shrOff[ell]), f['ptrD'],
                                         f['srcD'], f['KD'])
        # downward pass
        for ell in range(1, nLvl):
            level = (int(ownOff[ell]), int(shrOff[ell]), maxOwn[ell],
                     nShr[ell])
            for oo, os_, G in zip(outOwn, outShr, Gs):
                K.dist_h2_down(oo, os_, G['Town'], G['parOwnRow'],
                               G['parShrRow'], G['Tshr'], G['shrParRow'],
                               level)
        # leaves to local dofs, local dofs to the global vector
        if out is None:
            out = torch.empty_like(xc)
        for y, oo, G in zip(ys, outOwn, Gs):
            K.dist_h2_leaf(y, oo, G['lfPhi'], G['lfXslot'], G['lfRow'])
            out[G['yTo']] = y.reshape(-1)[G['yFrom']].to(out.device)
        return out

    def __matmul__(self, x):
        return self.matvec(x)

    def exchangeBytes(self):
        """Bytes that the shards receive per apply: the x halo, each far
        level's coefficient outboxes and the psum-ed shared partials (each
        shard's nd copies)."""
        m, nd, M = self._meta, self.nd, self._meta['M']
        halo = nd * nd * m['maxSendX'] * 8
        coef = sum(nd * nd * f['maxSendC'] * M * 8
                   for f in self._farMeta.values())
        nS = m['nShr']
        psum = nd * nd * 8 * M * (sum(nS[l - 1] for l in range(1, m['nLvl']))
                                  + sum(nS[l] for l in self._farMeta))
        return {'x halo': halo, 'coefficients': coef, 'psum': psum,
                'total': halo + coef + psum}

    @property
    def diagonal(self):
        # the H2 diagonal is the near-field diagonal: far pairs never touch
        # (i, i)
        sh, R = self._sh, self.R
        dSlot = np.where(sh['nearRow'] == sh['nearCol'], sh['nearDat'], 0.0)
        perDev = np.zeros((self.nd, R + 1))
        for k in range(self.nd):
            np.add.at(perDev[k], sh['nearRow'][k], dSlot[k])
        flat = perDev[:, :R].reshape(-1)
        g2l = self._localDofFlat
        out = np.zeros(self.num_rows)
        valid = g2l >= 0
        out[g2l[valid]] = flat[valid]
        return torch.as_tensor(out, device=self.mesh.device)

    def __repr__(self):
        return (f'<DistributedH2Matrix {self.num_rows}x{self.num_columns} '
                f'on {self.nd} shards>')


def _padFloat(lists, tail=()):
    """The float64 arrays of each shard padded with zeros to one length."""
    n = max([len(a) for a in lists] + [1])
    out = np.zeros((len(lists), n) + tuple(tail))
    for k, a in enumerate(lists):
        out[k, :len(a)] = a
    return out


class DistributedCSROperator:
    """Row-sharded CSR with the packed-outbox halo exchange of x (the
    reference's CSR_DistributedLinearOperator, clusterMethodCy.pyx:3157):
    rows in nd contiguous nnz-balanced blocks, only halo entries of x move.
    The set-up is the JAX package's; the apply packs every shard's outbox
    (K29), swaps them (all_to_all), and applies the shards' rows, sorted
    into CSR at set-up (a row keeps its entry order), as one
    block-diagonal CSR per card on the shards' [x, halo, 0] (K9)."""

    def __init__(self, A, mesh, axis='d'):
        from ..base.linear_operators import CSR_LinearOperator
        self.mesh = mesh
        self.axis = axis
        nd = int(mesh.devices.size)
        self.nd = nd
        rowids = np.repeat(np.arange(A.num_rows), np.diff(A.indptrH))
        colsG = A.indicesH.astype(np.int64)
        dataN = np.asarray(A.dataH, dtype=np.float64)
        N = A.num_rows
        self.num_rows = self.num_columns = N

        nnzPerRow = np.bincount(rowids, minlength=N)
        bounds = _balancedContiguousPartition(nnzPerRow + 1, nd)
        dofDev = np.zeros(N, dtype=np.int64)
        dofSlot = np.zeros(N, dtype=np.int64)
        rowsPer = np.zeros(nd, dtype=np.int64)
        for k in range(nd):
            r0, r1 = bounds[k], bounds[k + 1]
            dofDev[r0:r1] = k
            dofSlot[r0:r1] = np.arange(r1 - r0)
            rowsPer[k] = r1 - r0
        R = int(max(rowsPer.max(), 1))
        self.R = R
        localDof = np.full((nd, R), -1, dtype=np.int64)
        for k in range(nd):
            r0, r1 = bounds[k], bounds[k + 1]
            localDof[k, :r1 - r0] = np.arange(r0, r1)
        self._localDofFlat = localDof.reshape(-1)

        rdev = dofDev[rowids]
        needX = [[] for _ in range(nd)]
        for k in range(nd):
            ck = colsG[rdev == k]
            needX[k] = np.unique(ck[dofDev[ck] != k]).tolist()
        sendSlotX, recvPosX, maxSendX = _buildHaloExchange(
            needX, dofDev, dofSlot, nd)
        xeLen = R + nd * maxSendX
        cntN = np.bincount(rdev, minlength=nd)
        maxNnz = max(int(cntN.max()), 1)
        nearRow = np.full((nd, maxNnz), R, dtype=np.int64)
        nearCol = np.full((nd, maxNnz), xeLen, dtype=np.int64)
        nearDat = np.zeros((nd, maxNnz))
        for k in range(nd):
            sel = rdev == k
            nk = int(sel.sum())
            nearRow[k, :nk] = dofSlot[rowids[sel]]
            ck = colsG[sel]
            locm = dofDev[ck] == k
            ci = np.empty(nk, dtype=np.int64)
            ci[locm] = dofSlot[ck[locm]]
            if (~locm).any():
                ci[~locm] = [R + recvPosX[k][int(g)] for g in ck[~locm]]
            nearCol[k, :nk] = ci
            nearDat[k, :nk] = dataN[sel]
        self._sh = dict(nearRow=nearRow, nearCol=nearCol, nearDat=nearDat,
                        sendSlotX=sendSlotX)
        self.maxSendX = maxSendX
        self.xeLen = xeLen

        # per group: the shards' rows as one block-diagonal CSR over the
        # stacked [x, halo, 0] of each shard (xeLen + 1 columns a shard)
        self._groups = []
        for g in mesh.groups:
            indptr = [np.zeros(1, dtype=np.int64)]
            cols, dats = [], []
            base = 0
            for j, k in enumerate(g.shardsH):
                real = nearRow[k] < R
                r = nearRow[k][real]
                order = np.argsort(r, kind='stable')
                cnt = np.bincount(r, minlength=R)
                indptr.append(base + np.cumsum(cnt))
                base += int(cnt.sum())
                cols.append(nearCol[k][real][order] + j * (xeLen + 1))
                dats.append(nearDat[k][real][order])
            op = CSR_LinearOperator(
                np.concatenate(indptr), np.concatenate(cols),
                np.concatenate(dats), num_columns=g.size * (xeLen + 1),
                device=g.device)
            valid = localDof[g.shardsH].reshape(-1) >= 0
            self._groups.append(dict(
                op=op, nk=g.size,
                localDof=torch.as_tensor(localDof[g.shardsH],
                                         device=g.device),
                sendSlotX=torch.as_tensor(sendSlotX[g.shardsH]
                                          .reshape(g.size, -1),
                                          device=g.device),
                yFrom=torch.as_tensor(np.nonzero(valid)[0], device=g.device),
                yTo=torch.as_tensor(localDof[g.shardsH].reshape(-1)[valid],
                                    device=mesh.device)))

    @property
    def device(self):
        return self.mesh.device

    def matvec(self, x, out=None):
        from ..kernels.outbox import outbox_pack
        mesh, R = self.mesh, self.R
        Gs = self._groups
        xc = x.contiguous()
        xl = [outbox_pack(xc.to(G['localDof'].device)[None, :, None],
                          G['localDof'])[..., 0] for G in Gs]
        box = [outbox_pack(a[:, :, None], G['sendSlotX'])[..., 0]
               .reshape(G['nk'], self.nd, -1) for a, G in zip(xl, Gs)]
        bufX = coll.all_to_all(mesh, box)
        if out is None:
            out = torch.empty_like(xc)
        for a, b, G in zip(xl, bufX, Gs):
            xe = torch.cat([a, b.reshape(G['nk'], -1),
                            a.new_zeros(G['nk'], 1)], 1).reshape(-1)
            y = G['op'].matvec(xe)
            out[G['yTo']] = y[G['yFrom']].to(out.device)
        return out

    def __matmul__(self, x):
        return self.matvec(x)

    @property
    def diagonal(self):
        sh, R = self._sh, self.R
        dSlot = np.where(sh['nearRow'] == sh['nearCol'], sh['nearDat'], 0.0)
        perDev = np.zeros((self.nd, R + 1))
        for k in range(self.nd):
            np.add.at(perDev[k], sh['nearRow'][k], dSlot[k])
        g2l = self._localDofFlat
        out = np.zeros(self.num_rows)
        flat = perDev[:, :R].reshape(-1)
        valid = g2l >= 0
        out[g2l[valid]] = flat[valid]
        return torch.as_tensor(out, device=self.mesh.device)


def dryrunDistributedH2(mesh, noRef=14, maxiter=2000):
    """Smoke of the S4 path on ``mesh``: the distributed H2 apply against
    the H2Matrix it wraps (1e-10 relative), a CG-Jacobi solve (K4) on the
    distributed operator that must converge (tolerance 1e-8 on sqrt(r.M.r)
    within ``maxiter`` iterations; the JAX dry run stops at 200 without
    asserting it), and the partition-first assembly against the wrap at
    noRef 10.  Prints one line each and returns their numbers."""
    from ..fem import simpleInterval, P1_DoFMap
    from ..nl import getFractionalKernel
    from ..nl.assembly import nonlocalBuilder
    from ..base.solvers import cg_solver
    from ..base.linear_operators import Diagonal_LinearOperator

    dev = mesh.device
    m = simpleInterval(-1.0, 1.0)
    for _ in range(noRef):
        m = m.refine()
    dm = P1_DoFMap(m, device=dev)
    kernel = getFractionalKernel(1, 0.5)
    H = nonlocalBuilder(dm, kernel).getH2()
    Ad = DistributedH2Matrix(H, mesh)
    x = torch.as_tensor(np.sin(np.pi * np.linspace(-1, 1, dm.num_dofs)),
                        device=dev)
    ref = H.matvec(x)
    err = float(torch.linalg.norm(ref - Ad.matvec(x))
                / torch.linalg.norm(ref))
    assert err < 1e-10, err
    b = torch.ones(dm.num_dofs, dtype=torch.float64, device=dev) * float(m.h)
    cg = cg_solver(Ad)
    cg.setPreconditioner(Diagonal_LinearOperator(1.0 / Ad.diagonal))
    cg.tolerance = 1e-8
    cg.maxIter = maxiter
    u = cg.solve(b)
    rn = float(torch.linalg.norm(b - Ad.matvec(u)))
    converged = cg.residuals[-1] <= cg.tolerance
    print(f'dryrunDistributedH2: dofs={dm.num_dofs}, '
          f'|H2 - distH2|x rel = {err:.2e}, '
          f'CG iters={int(cg.iterations)}, residual={rn:.2e}', flush=True)
    assert converged, ('distributed CG did not converge', cg.iterations,
                       cg.residuals[-1])

    # partition-first distributed assembly (no global operator build)
    m2 = simpleInterval(-1.0, 1.0)
    for _ in range(10):
        m2 = m2.refine()
    dm2 = P1_DoFMap(m2, device=dev)
    H2s = nonlocalBuilder(dm2, kernel).getH2()
    Aw = DistributedH2Matrix(H2s, mesh)
    Aa = DistributedH2Matrix.assemble(dm2, kernel, mesh)
    x2 = torch.as_tensor(np.sin(np.pi * np.linspace(-1, 1, dm2.num_dofs)),
                         device=dev)
    ref2 = Aw.matvec(x2)
    errA = float(torch.linalg.norm(ref2 - Aa.matvec(x2))
                 / torch.linalg.norm(ref2))
    assert errA < 1e-10, errA
    print(f'distributed assemble (partition-first): dofs={dm2.num_dofs}, '
          f'|wrap - assemble|x rel = {errA:.2e}', flush=True)
    return {'dofs': dm.num_dofs, 'err': err, 'iterations': int(cg.iterations),
            'residual': rn, 'cg_residual': cg.residuals[-1],
            'assemble_dofs': dm2.num_dofs, 'assemble_err': errA}

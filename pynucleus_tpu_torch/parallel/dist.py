"""Shard meshes, sharded dense assembly and row-sharded operators.

Port of pynucleus_tpu/parallel/dist.py.  The JAX package runs one
``shard_map`` program over the devices of a ``jax.sharding.Mesh``; the port
keeps that single-controller model on a :class:`ShardMesh`: n shards, shard
k on the slot k mod nSlots (one slot per card, or the CPU), the shards of a
slot stacked along a leading axis and served together, and the collectives
of parallel/collectives.py between the steps.  So one card runs four
shards with real halo and coefficient exchanges.

  shardedDenseAssembly     the distant cell pairs split over the shards,
                           each shard's pairs through K1's dense target into
                           its partial, then psum; the near part once
  rowShardedOperator       a dense operator in row blocks, one per shard
  distributedSolveStep     CG-Jacobi (K4) on a row-sharded operator
  DistributedRowBlockOperator   dense row blocks, x all-gathered
  DistributedHaloOperator  dense row windows, x sharded with a halo (K29)
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import getDevice
from . import collectives as coll

__all__ = ['ShardMesh', 'makeDeviceMesh', 'shardedDenseAssembly',
           'rowShardedOperator', 'distributedSolveStep',
           'DistributedRowBlockOperator', 'DistributedHaloOperator']


class _Group:
    """The shards of one slot: their indices (ascending) and device."""

    def __init__(self, device, shards):
        self.device = device
        self.shards = torch.as_tensor(shards, dtype=torch.int64)
        self.shardsH = np.asarray(shards, dtype=np.int64)

    @property
    def size(self):
        return len(self.shardsH)


class ShardMesh:
    """n shards over the devices ``slots``: shard k on slots[k % nSlots].

    ``devices`` is the array of each shard's torch device (so
    ``devices.size`` is the shard count, as a jax Mesh's), ``device`` the
    first slot's, where global vectors live; ``groups`` the shards of each
    slot."""

    def __init__(self, n, slots, axis='d'):
        if n < 1:
            raise ValueError('a shard mesh needs at least one shard')
        self.axis = axis
        self.slots = [torch.device(s) for s in slots]
        shardDev = [self.slots[k % len(self.slots)] for k in range(n)]
        self.devices = np.empty(n, dtype=object)
        self.devices[:] = shardDev
        self.device = self.slots[0]
        self.groups = [_Group(self.slots[s], np.arange(s, n, len(self.slots)))
                       for s in range(min(len(self.slots), n))]
        order = np.concatenate([g.shardsH for g in self.groups])
        inv = np.empty(n, dtype=np.int64)
        inv[order] = np.arange(n)
        # rows of the groups' concatenation in shard order
        self.fromGroupOrder = torch.as_tensor(inv, device=self.device)

    @property
    def size(self):
        return self.devices.size

    def split(self, full):
        """A tensor [nd, ...] in shard order as the groups' stacks."""
        return coll.scatterGroups(self, full)

    def join(self, parts):
        """The groups' stacks as one tensor [nd, ...] in shard order."""
        return coll.shardOrder(self, parts)

    def __repr__(self):
        return f'<ShardMesh {self.size} shards on {self.slots}>'


def makeDeviceMesh(n_devices=None, axis='d', device=None):
    """A :class:`ShardMesh` of ``n_devices`` shards (default: one per card)
    on the cards, shard k on cuda:(k mod device_count), or on the CPU with
    ``device='cpu'`` (one slot: every shard stacked there).  Without a card
    and without ``device='cpu'`` it raises."""
    if device is None or torch.device(device).type == 'cuda':
        getDevice('cuda')
        slots = [torch.device('cuda', i)
                 for i in range(torch.cuda.device_count())]
        if device is not None and torch.device(device).index is not None:
            slots = [torch.device(device)]
    else:
        slots = [getDevice(device)]
    if n_devices is None:
        n_devices = len(slots)
    return ShardMesh(int(n_devices), slots, axis)


# --------------------------------------------------------- S1 assembly --

def shardedDenseAssembly(dm, kernel, mesh, axis='d'):
    """S1: the distant cell pairs split over the shards, each shard's pairs
    assembled into a dense partial of its own (K1's dense target, factor 2,
    the distant rule of each order), then psum (the reference's row-sliced
    assembly with an Allreduce).  The identical, touching and cut pairs and
    the zero-exterior term are assembled once (the builder's pair buckets
    and _addZeroExterior), as in pynucleus_tpu/parallel/dist.py:37-64.
    Returns a Dense_LinearOperator on the mesh's device."""
    from ..nl.assembly import (nonlocalBuilder, DeviceDenseAccumulator,
                               _BucketRunner)
    from ..nl.quad_singular import distantRule
    from ..base.linear_operators import Dense_LinearOperator

    nd = mesh.size
    # the per-pair path throughout (the zero-exterior term too), as the
    # JAX package's CPU default
    builder = nonlocalBuilder(dm, kernel, params={'denseGrid': False},
                              device=mesh.device)
    meshM = dm.mesh
    N = dm.num_dofs
    info = builder._classifyAll()

    # near/singular part, once
    acc = DeviceDenseAccumulator(N, mesh.device)
    infoNear = dict(info)
    infoNear['distant'] = (np.zeros(0, dtype=np.int64),
                           np.zeros(0, dtype=np.int64),
                           np.zeros(0, dtype=np.int64))
    builder._runPairBuckets(acc, infoNear)
    if builder.zeroExterior:
        builder._addZeroExterior(acc)

    # distant part: the pairs of each order split into nd contiguous chunks
    # (the JAX program pads them to a multiple of nd with zero-weight pairs)
    di, dj, orders = info['distant']
    parts = []
    for g in mesh.groups:
        runner = _BucketRunner(meshM, dm, kernel, g.device)
        accs = [DeviceDenseAccumulator(N, g.device) for _ in g.shardsH]
        for order in np.unique(orders):
            sel = orders == order
            ii, jj = di[sel], dj[sel]
            rule = distantRule(int(order), meshM.manifold_dim)
            PSI = rule.buildPSI(dm, nSharedVertices=0)
            per = -(-len(ii) // nd)
            for a, k in zip(accs, g.shardsH):
                lo, hi = k * per, min((k + 1) * per, len(ii))
                if hi > lo:
                    runner.runNatural(a, rule, PSI, ii[lo:hi], jj[lo:hi], 2.0)
        parts.append(torch.stack([a.A for a in accs]))
    A = coll.psum(mesh, parts)[0].to(mesh.device)
    return Dense_LinearOperator(A + acc.A)


# ----------------------------------------------------- S3 row sharding --

def _denseData(A):
    """The [N, N] float64 tensor of a dense operator (its data) or of any
    operator with ``toarray``."""
    if hasattr(A, 'data') and torch.is_tensor(A.data) and A.data.dim() == 2:
        return A.data
    return torch.as_tensor(np.asarray(A.toarray()), dtype=torch.float64)


def rowShardedOperator(A, mesh, axis='d'):
    """A dense operator placed in row blocks, one per shard (S3: each shard
    owns a row block; the apply all-gathers x): a
    DistributedRowBlockOperator of the operator padded to a multiple of
    the shard count with an identity block, which keeps it invertible.
    Returns (operator, pad)."""
    from ..base.linear_operators import Dense_LinearOperator
    data = _denseData(A).to(mesh.device)
    N = data.shape[0]
    pad = (-N) % mesh.size
    if pad:
        data = torch.nn.functional.pad(data, (0, pad, 0, pad))
        idx = torch.arange(N, N + pad, device=data.device)
        data[idx, idx] = 1.0
    return DistributedRowBlockOperator(Dense_LinearOperator(data), mesh,
                                       axis), pad


def distributedSolveStep(mesh, A_sharded, b, pad, axis='d', tol=1e-8,
                         maxiter=50):
    """CG-Jacobi (K4) on the row-sharded operator, from x = 0 to the
    absolute tolerance on sqrt(r.M.r) (pynucleus_tpu/parallel/dist.py
    distributedSolveStep with _cg_core).  Returns (x[:N], iterations)."""
    from ..base.solvers import cg_solver
    from ..base.linear_operators import Diagonal_LinearOperator
    N = b.shape[0]
    bP = torch.nn.functional.pad(b, (0, pad)) if pad else b
    diag = A_sharded.diagonal
    diag = torch.where(diag != 0, diag, torch.ones_like(diag))
    cg = cg_solver(A_sharded)
    cg.setPreconditioner(Diagonal_LinearOperator(1.0 / diag))
    cg.tolerance = tol
    cg.maxIter = maxiter
    x = cg.solve(bP.contiguous())
    return x[:N], cg.iterations


# ------------------------------------------------- distributed operators --

class DistributedRowBlockOperator:
    """S3 'bcast' mode (pynucleus_tpu/parallel/dist.py:129-204): each shard
    owns a contiguous dense row block, x is all-gathered (the reference's
    Bcast), the result comes back row-sharded.  The block product is a
    plain product (torch.matmul), as the JAX program's."""

    def __init__(self, A, mesh, axis='d'):
        self.mesh = mesh
        self.axis = axis
        data = _denseData(A).to(mesh.device)
        N = data.shape[0]
        nd = mesh.size
        self.N = N
        self.pad = (-N) % nd
        if self.pad:
            data = torch.nn.functional.pad(data, (0, self.pad, 0, self.pad))
        self.num_rows = self.num_columns = N
        self.per = (N + self.pad) // nd
        self.blocks = mesh.split(data.reshape(nd, self.per, N + self.pad)
                                 .contiguous())

    @property
    def device(self):
        return self.mesh.device

    def matvec(self, x, out=None):
        xP = torch.nn.functional.pad(x, (0, self.pad)) if self.pad else x
        ys = [torch.matmul(b, xg) for b, xg in
              zip(self.blocks, coll.replicate(self.mesh, xP))]
        y = self.mesh.join(ys).reshape(-1)[:self.N]
        return y if out is None else out.copy_(y)

    def __matmul__(self, x):
        return self.matvec(x)

    @property
    def diagonal(self):
        full = self.mesh.join(self.blocks).reshape(self.N + self.pad, -1)
        r = torch.arange(self.N, device=full.device)
        return full[r, r]


class DistributedHaloOperator:
    """S4 'halo' mode for banded operators (pynucleus_tpu/parallel/dist.py
    :207-290): rows and x sharded; each shard receives the halo strips of x
    from its two neighbours: each shard packs its first and last H entries
    (K29), a permutation moves them (ppermute), and the window [left, own,
    right] multiplies the shard's dense window block.  A bandwidth wider
    than a block all-gathers x instead."""

    def __init__(self, A, mesh, axis='d', halo=None):
        self.mesh = mesh
        self.axis = axis
        data = np.asarray(A.toarray())
        N = data.shape[0]
        nd = mesh.size
        self.N = N
        self.pad = (-N) % nd
        NP = N + self.pad
        per = NP // nd
        self.per = per
        if self.pad:
            data = np.pad(data, ((0, self.pad), (0, self.pad)))
        if halo is None:
            rr, cc = np.nonzero(data)
            halo = int(np.abs(rr - cc).max()) if len(rr) else 0
        self.fullGather = halo > per
        self.halo = 0 if self.fullGather else max(halo, 0)
        H = self.halo
        if self.fullGather:
            blocks = data.reshape(nd, per, NP)
        else:
            blocks = np.zeros((nd, per, per + 2 * H))
            for k in range(nd):
                r0, r1 = k * per, (k + 1) * per
                lo, hi = r0 - H, r1 + H
                slo, shi = max(lo, 0), min(hi, NP)
                blocks[k, :, slo - lo:(slo - lo) + (shi - slo)] = \
                    data[r0:r1, slo:shi]
        self.num_rows = self.num_columns = N
        self.blocks = mesh.split(torch.as_tensor(blocks, device=mesh.device))
        # outbox rows of every shard: its last H entries (to the right
        # neighbour's left halo) and its first H (to the left one's right)
        slots = np.concatenate([np.arange(per - H, per), np.arange(H)])
        self._slots = [torch.as_tensor(np.tile(slots, (g.size, 1)),
                                       device=g.device) for g in mesh.groups]

    @property
    def device(self):
        return self.mesh.device

    def matvec(self, x, out=None):
        from ..kernels.outbox import outbox_pack
        mesh, per, H = self.mesh, self.per, self.halo
        xP = torch.nn.functional.pad(x, (0, self.pad)) if self.pad else x
        xblk = mesh.split(xP.reshape(mesh.size, per))
        if self.fullGather:
            xs = coll.all_gather(mesh, xblk)
            ys = [torch.matmul(b, xg.reshape(-1)[None, :, None])[..., 0]
                  for b, xg in zip(self.blocks, xs)]
        else:
            boxes = [outbox_pack(xb[:, :, None].contiguous(), s)[..., 0]
                     for xb, s in zip(xblk, self._slots)]
            nd = mesh.size
            left = coll.ppermute(mesh, [b[:, :H] for b in boxes],
                                 [(i, i + 1) for i in range(nd - 1)])
            right = coll.ppermute(mesh, [b[:, H:] for b in boxes],
                                  [(i, i - 1) for i in range(1, nd)])
            ys = [torch.matmul(b, torch.cat([lf, xb, rt], 1)[:, :, None])
                  [..., 0] for b, lf, xb, rt in zip(self.blocks, left, xblk,
                                                    right)]
        y = mesh.join(ys).reshape(-1)[:self.N]
        return y if out is None else out.copy_(y)

    def __matmul__(self, x):
        return self.matvec(x)

    @property
    def diagonal(self):
        blocks = self.mesh.join(self.blocks)
        d = []
        for k in range(self.mesh.size):
            off = k * self.per if self.fullGather else self.halo
            d.append(torch.diagonal(blocks[k, :, off:off + self.per]))
        return torch.cat(d)[:self.N]

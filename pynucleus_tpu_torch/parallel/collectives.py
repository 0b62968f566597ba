"""Collectives over the shard axis of a :class:`ShardMesh`.

The counterparts of ``jax.lax.psum``, ``all_gather``, ``all_to_all`` and
``ppermute`` inside the JAX package's ``shard_map`` programs
(pynucleus_tpu/parallel/).  The port is single-controller, as shard_map
is: one process drives every shard.  Shard k lives on the mesh's slot
k mod nSlots (one slot per card, or the CPU), and the shards of one slot
are stacked along a leading axis, so a sharded array is a list over the
mesh's groups of tensors [nk, ...] (nk shards each, in ascending shard
order).  On one card these are tensor glue: a sum over the shard axis, a
transpose of the [nd, nd, ...] outboxes, copies between cards otherwise.
"""
from __future__ import annotations

import torch

__all__ = ['shardOrder', 'scatterGroups', 'replicate', 'psum',
           'all_gather', 'all_to_all', 'ppermute']


def shardOrder(mesh, parts):
    """The per-group tensors [nk, ...] as one tensor [nd, ...] in shard
    order, on the mesh's first device."""
    if len(parts) == 1:
        return parts[0].to(mesh.device)
    full = torch.cat([p.to(mesh.device) for p in parts])
    return full[mesh.fromGroupOrder]


def scatterGroups(mesh, full):
    """A tensor [nd, ...] in shard order as the per-group tensors
    [nk, ...] on their devices."""
    if len(mesh.groups) == 1:
        return [full.to(mesh.groups[0].device)]
    return [full[g.shards].to(g.device) for g in mesh.groups]


def replicate(mesh, x):
    """A global tensor on every group's device (the replicated input of
    a shard program)."""
    return [x.to(g.device) for g in mesh.groups]


def psum(mesh, parts):
    """The sum over every shard of the per-shard values (parts: [nk, ...]
    per group): one tensor [...] per group, on the group's device."""
    if len(parts) == 1:
        return [parts[0].sum(0)]
    total = sum(p.sum(0).to(mesh.device) for p in parts)
    return [total.to(g.device) for g in mesh.groups]


def all_gather(mesh, parts):
    """Every shard's value on every shard: one tensor [nd, ...] (shard
    order) per group, on the group's device (jax.lax.all_gather with the
    gathered axis first)."""
    full = shardOrder(mesh, parts)
    return [full.to(g.device) for g in mesh.groups]


def all_to_all(mesh, parts):
    """The point-to-point swap of packed outboxes (jax.lax.all_to_all with
    split_axis=0, concat_axis=0): parts [nk, nd, ...] hold each shard's
    outbox row per destination; shard k receives [nd, ...], row j being
    shard j's outbox for k.  Returns [nk, nd, ...] per group."""
    if len(parts) == 1:
        return [parts[0].transpose(0, 1).contiguous()]
    full = shardOrder(mesh, parts)                 # [nd_src, nd_dst, ...]
    recv = full.transpose(0, 1)                    # [nd_dst, nd_src, ...]
    return [recv[g.shards].contiguous().to(g.device) for g in mesh.groups]


def ppermute(mesh, parts, perm):
    """jax.lax.ppermute: shard dst receives shard src's value for each
    (src, dst) of ``perm``; a shard that receives nothing gets zeros."""
    full = shardOrder(mesh, parts)
    out = torch.zeros_like(full)
    if perm:
        src = torch.tensor([s for s, _ in perm], device=full.device)
        dst = torch.tensor([d for _, d in perm], device=full.device)
        out[dst] = full[src]
    return scatterGroups(mesh, out)

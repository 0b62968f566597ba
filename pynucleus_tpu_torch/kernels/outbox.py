"""Kernel K29 ``outbox``: the packed-outbox gathers of the sharded programs.

Three entry points, each beside its plain PyTorch version with the same
contract (kernels/csrc/outbox.cu; float64 values, int64 or int32 index
arrays; the shards of one device stacked on the leading axis, served by
one launch):

  :func:`outbox_pack`       out[k, p, :] = src[k, slot[k, p], :] or 0 where
                            slot < 0: the x halo and coefficient outboxes
                            of parallel/dist_h2.py, the CSR halo, the halo
                            strips of parallel/dist.py, and the global
                            vector gathered into the shards' rows
  :func:`outbox_recv_add`   X[k, rs[k, i]] += sum_c buf[rp[k, i, c]]: the
                            receive side of the overlap accumulate
  :func:`outbox_gather2d`   out[k, i] = buf[gp[k, i], gs[k, i]] * vm[k, i]:
                            the repartition gather

A wrapper runs the plain version only for tensors on the CPU; on CUDA
tensors it launches the kernel or raises.  Launches count under
``outbox`` and ``outbox:pack``, ``:recv_add``, ``:gather2d``.
"""
from __future__ import annotations

import torch

from .. import kernels

__all__ = ['outbox_pack', 'outbox_recv_add', 'outbox_gather2d']

_IDX = (torch.int64, torch.int32)


def _launch(variant):
    kernels.launches['outbox'] += 1
    kernels.deviceLaunches['outbox'] += 1
    kernels.launches[f'outbox:{variant}'] += 1
    return kernels.library()


def _check(name, dev, vals=(), idx=()):
    for t in vals:
        if t.dtype != torch.float64 or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f'{name}: expected contiguous float64 tensors '
                             f'on {dev}, got {t.dtype} on {t.device}')
    for t in idx:
        if t.dtype not in _IDX or not t.is_contiguous() or t.device != dev:
            raise ValueError(f'{name}: expected contiguous int64 or int32 '
                             f'index tensors on {dev}')
    if len({t.dtype for t in idx}) > 1:
        raise ValueError(f'{name}: the index tensors differ in type')
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name}: unsupported device {dev}')


def outbox_pack(src, slot, out=None):
    """out [nk, P, W] with out[k, p] = src[k, slot[k, p]] (a row of width
    W), 0 where slot[k, p] < 0 (or >= S).  src [nk or 1, S, W] float64 (one
    array read by every shard when its leading size is 1), slot [nk, P]
    int64 or int32."""
    nk, P = slot.shape
    ns, S, W = src.shape
    if ns not in (1, nk):
        raise ValueError('outbox_pack: src must hold one array per shard or '
                         'one for all')
    dev = slot.device
    if out is None:
        out = torch.empty((nk, P, W), dtype=torch.float64, device=dev)
    elif out.shape != (nk, P, W):
        raise ValueError(f'outbox_pack: out must be [{nk}, {P}, {W}]')
    _check('outbox_pack', dev, (src, out), (slot,))
    if dev.type == 'cpu':
        out.copy_(_outbox_pack_plain(src, slot))
        return out
    lib = _launch('pack')
    p = kernels.ptr
    kernels.check(lib.outbox_pack(
        p(out), p(src), 0 if ns == 1 else S * W, S, p(slot),
        int(slot.dtype == torch.int64), nk, P, W, kernels.stream()))
    return out


def _outbox_pack_plain(src, slot):
    """Plain PyTorch version of :func:`outbox_pack`."""
    nk = slot.shape[0]
    S = src.shape[1]
    s = slot.long()
    ok = (s >= 0) & (s < S)
    srcK = src.expand(nk, -1, -1)
    vals = torch.gather(srcK, 1, torch.where(ok, s, 0)[:, :, None]
                        .expand(-1, -1, src.shape[2]))
    return torch.where(ok[:, :, None], vals, torch.zeros((), dtype=src.dtype,
                                                         device=src.device))


def outbox_recv_add(X, buf, recvPos, recvSlot):
    """In place on X [nk, L]: X[k, recvSlot[k, i]] += sum_c
    buf[recvPos[k, i, c]], buf [nbuf] float64 the flattened all-gathered
    outboxes; a position >= nbuf reads the zero pad lane, and a row whose
    every position is the pad adds nothing.  recvPos [nk, nI, C] and
    recvSlot [nk, nI] int64 or int32.  Returns X."""
    nk, nI, C = recvPos.shape
    dev = X.device
    _check('outbox_recv_add', dev, (X, buf), (recvPos, recvSlot))
    if recvSlot.shape != (nk, nI) or X.shape[0] != nk:
        raise ValueError('outbox_recv_add: shapes of X, recvPos and '
                         'recvSlot disagree')
    if dev.type == 'cpu':
        X.copy_(_outbox_recv_add_plain(X, buf, recvPos, recvSlot))
        return X
    lib = _launch('recv_add')
    p = kernels.ptr
    kernels.check(lib.outbox_recv_add(
        p(X), X.shape[1], p(buf), buf.shape[0], p(recvPos), p(recvSlot),
        int(recvPos.dtype == torch.int64), nk, nI, C, kernels.stream()))
    return X


def _outbox_recv_add_plain(X, buf, recvPos, recvSlot):
    """Plain PyTorch version of :func:`outbox_recv_add` (the JAX package's
    gather from the buffer with its zero lane, then the add at the
    slots)."""
    nbuf = buf.shape[0]
    bufZ = torch.cat([buf, buf.new_zeros(1)])
    rp = recvPos.long()
    rp = torch.where((rp >= 0) & (rp < nbuf), rp, nbuf)
    add = bufZ[rp].sum(-1)                                   # [nk, nI]
    live = (rp < nbuf).any(-1)
    out = X.clone()
    rows = torch.arange(X.shape[0], device=X.device)[:, None].expand_as(add)
    out.index_put_((rows[live], recvSlot.long()[live]), add[live],
                   accumulate=True)
    return out


def outbox_gather2d(buf, gatherPart, gatherSlot, validMask, out=None):
    """out [nk, nI] = buf[gatherPart, gatherSlot] * validMask from the
    all-gathered buffer buf [nd, L] float64; gatherPart and gatherSlot
    [nk, nI] int64 or int32, validMask [nk, nI] float64 (1 or 0)."""
    nk, nI = gatherPart.shape
    dev = gatherPart.device
    if out is None:
        out = torch.empty((nk, nI), dtype=torch.float64, device=dev)
    _check('outbox_gather2d', dev, (buf, validMask, out),
           (gatherPart, gatherSlot))
    if gatherSlot.shape != (nk, nI) or validMask.shape != (nk, nI) \
            or out.shape != (nk, nI):
        raise ValueError('outbox_gather2d: shapes disagree')
    if dev.type == 'cpu':
        out.copy_(_outbox_gather2d_plain(buf, gatherPart, gatherSlot,
                                         validMask))
        return out
    lib = _launch('gather2d')
    p = kernels.ptr
    kernels.check(lib.outbox_gather2d(
        p(out), p(buf), buf.shape[1], p(gatherPart), p(gatherSlot),
        p(validMask), int(gatherPart.dtype == torch.int64), nk, nI,
        kernels.stream()))
    return out


def _outbox_gather2d_plain(buf, gatherPart, gatherSlot, validMask):
    """Plain PyTorch version of :func:`outbox_gather2d`."""
    return buf[gatherPart.long(), gatherSlot.long()] * validMask

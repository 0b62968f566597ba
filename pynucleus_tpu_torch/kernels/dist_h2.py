"""Kernel K28 ``dist_h2_matvec``: the per-shard phases of the distributed
H2 apply (pynucleus_tpu/parallel/dist_h2.py:571-710), split at its
collectives (kernels/csrc/dist_h2.cu; float64, int64 index arrays, the
shards of one device stacked on the leading axis and served by one launch
per phase).  parallel/dist_h2.py DistributedH2Matrix sequences them with
the collectives and K29's outboxes:

  :func:`dist_h2_near`        near product of the shard's rows (CSR, rows
                              sorted at set-up) on xe = [x, halo, 0]
  :func:`dist_h2_moments`     leaf moments lfPhi^T x into the owned leaf rows
  :func:`dist_h2_up`          one level of the upward transfer into owned
                              parents; returns the shared parents' partial
  :func:`dist_h2_up_shared`   the shared parents: psum(partial) plus the
                              replicated shared transfers
  :func:`dist_h2_far`         one level's far field into owned targets (A
                              pairs); returns the shared targets' partial (C)
  :func:`dist_h2_far_shared`  the shared targets: psum(partial) plus the
                              replicated D pairs
  :func:`dist_h2_down`        one level of the downward transfer, owned and
                              shared nodes
  :func:`dist_h2_leaf`        y += lfPhi . outOwn[leaf] for each local dof

Each beside its plain PyTorch version with the same contract; a wrapper
runs the plain version only for tensors on the CPU, and on CUDA tensors
launches the kernel or raises.  Launches count under ``dist_h2_matvec``
and ``dist_h2_matvec:<phase>``.

Arrays of a shard group (nk shards): own, outOwn [nk, ownTot, M]; shr,
outShr [nk, shrTot, M]; Town [nk, ownTot, M, M]; Tshr [shrTot, M, M]; the
per-level pair lists CSRs by target (ptr [nk, nTargets + 1], sources and
blocks [nk, n, ...]; the replicated D pairs without the shard axis).
"""
from __future__ import annotations

import torch

from .. import kernels

__all__ = ['PLAIN', 'dist_h2_near', 'dist_h2_moments', 'dist_h2_up',
           'dist_h2_up_shared', 'dist_h2_far', 'dist_h2_far_shared',
           'dist_h2_down', 'dist_h2_leaf']


def _launch(phase):
    kernels.launches['dist_h2_matvec'] += 1
    kernels.deviceLaunches['dist_h2_matvec'] += 1
    kernels.launches[f'dist_h2_matvec:{phase}'] += 1
    return kernels.library()


def _check(name, dev, vals, idx):
    for t in vals:
        if t.dtype != torch.float64 or not t.is_contiguous() \
                or t.device != dev:
            raise ValueError(f'{name}: expected contiguous float64 tensors '
                             f'on {dev}, got {t.dtype} on {t.device}')
    for t in idx:
        if t.dtype != torch.int64 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f'{name}: expected contiguous int64 index '
                             f'tensors on {dev}')
    if dev.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name}: unsupported device {dev}')
    return dev.type == 'cpu'


def _rowsOf(ptr, n):
    """Row id of each entry of each shard's CSR (ptr [nk, R+1]), padded
    with R up to n entries: [nk, n]."""
    nk, R1 = ptr.shape
    rows = torch.full((nk, n), R1 - 1, dtype=torch.int64, device=ptr.device)
    ar = torch.arange(R1 - 1, device=ptr.device)
    for k in range(nk):
        r = torch.repeat_interleave(ar, ptr[k, 1:] - ptr[k, :-1])
        rows[k, :r.shape[0]] = r
    return rows


def _segmentSum(vals, seg, nSeg):
    """[nk, n, ...] summed by seg [nk, n] into [nk, nSeg, ...] (seg ==
    nSeg drops the entry)."""
    nk = vals.shape[0]
    out = vals.new_zeros((nk, nSeg + 1) + tuple(vals.shape[2:]))
    out.scatter_add_(1, seg.reshape(seg.shape + (1,) * (vals.dim() - 2))
                     .expand_as(vals), vals)
    return out[:, :nSeg]


# ---------------------------------------------------------------- near --

def dist_h2_near(y, xl, buf, ptr, col, dat):
    """y [nk, R] = the near product of each shard's rows: y[k, r] =
    sum_e dat[k, e] xe[k, col[k, e]] over e in ptr[k, r] .. ptr[k, r+1],
    xe[k] = [xl[k] (R), buf[k] or buf[0] (B: the received halo), 0]."""
    nk, R = xl.shape
    nb, B = buf.shape
    dev = y.device
    if y.shape != (nk, R) or ptr.shape != (nk, R + 1) or nb not in (1, nk) \
            or col.shape != dat.shape or col.shape[0] != nk:
        raise ValueError('dist_h2_near: shapes disagree')
    if _check('dist_h2_near', dev, (y, xl, buf, dat), (ptr, col)):
        return _dist_h2_near_plain(y, xl, buf, ptr, col, dat)
    lib = _launch('near')
    p = kernels.ptr
    kernels.check(lib.dist_h2_near(
        p(y), R, p(xl), p(buf), 0 if nb == 1 else B, B, p(ptr), p(col),
        p(dat), col.shape[1], nk, kernels.stream()))
    return y


def _dist_h2_near_plain(y, xl, buf, ptr, col, dat):
    """Plain PyTorch version of :func:`dist_h2_near` (the JAX program's
    gather and segment sum)."""
    nk, R = xl.shape
    B = buf.shape[1]
    xe = torch.cat([xl, buf.expand(nk, B), xl.new_zeros(nk, 1)], 1)
    c = torch.where(col < R + B, col, R + B)
    prod = dat * torch.gather(xe, 1, c)
    return y.copy_(_segmentSum(prod, _rowsOf(ptr, col.shape[1]), R))


# ------------------------------------------------------------- moments --

def dist_h2_moments(own, xl, lfPhi, lfXslot, lfRow):
    """own[k, lfRow[k, q]] = sum_n lfPhi[k, q, n] xl[k, lfXslot[k, q, n]]
    (lfXslot outside [0, R) reads 0; lfRow < 0: a padding leaf).  own
    [nk, ownTot, M], lfPhi [nk, LP, nbar, M], lfXslot [nk, LP, nbar], lfRow
    [nk, LP]."""
    nk, ownTot, M = own.shape
    _, LP, nbar, _ = lfPhi.shape
    dev = own.device
    if _check('dist_h2_moments', dev, (own, xl, lfPhi), (lfXslot, lfRow)):
        return _dist_h2_moments_plain(own, xl, lfPhi, lfXslot, lfRow)
    lib = _launch('moments')
    p = kernels.ptr
    kernels.check(lib.dist_h2_moments(
        p(own), ownTot, M, p(xl), xl.shape[1], p(lfPhi), p(lfXslot), p(lfRow),
        LP, nbar, nk, kernels.stream()))
    return own


def _dist_h2_moments_plain(own, xl, lfPhi, lfXslot, lfRow):
    """Plain PyTorch version of :func:`dist_h2_moments`."""
    nk, R = xl.shape
    xlp = torch.cat([xl, xl.new_zeros(nk, 1)], 1)
    xs = torch.where((lfXslot >= 0) & (lfXslot < R), lfXslot, R)
    xg = torch.gather(xlp, 1, xs.reshape(nk, -1)).reshape(lfXslot.shape)
    vals = torch.einsum('kpnm,kpn->kpm', lfPhi, xg)
    for k in range(nk):
        ok = lfRow[k] >= 0
        own[k, lfRow[k][ok]] = vals[k][ok]
    return own


# ------------------------------------------------------------------ up --

def dist_h2_up(own, Town, ptr, idx, moP, nShrP, rowOffChild, rowOffParent):
    """One level of the upward pass: for each owned parent slot t < moP,
    own[k, rowOffParent + t] += sum over its children c (idx[k, ptr[k, t]
    .. ptr[k, t+1]]) of Town[k, rowOffChild + c] own[k, rowOffChild + c];
    returns partial [nk, nShrP, M], the same sums for the shared parents
    (targets moP .. moP + nShrP), to be psum-ed."""
    nk, ownTot, M = own.shape
    dev = own.device
    if ptr.shape != (nk, moP + nShrP + 1):
        raise ValueError('dist_h2_up: ptr must be [nk, moP + nShrP + 1]')
    if _check('dist_h2_up', dev, (own, Town), (ptr, idx)):
        return _dist_h2_up_plain(own, Town, ptr, idx, moP, nShrP,
                                 rowOffChild, rowOffParent)
    partial = torch.empty((nk, nShrP, M), dtype=own.dtype, device=dev)
    lib = _launch('up')
    p = kernels.ptr
    kernels.check(lib.dist_h2_up(
        p(own), p(partial), ownTot, M, p(Town), p(ptr), p(idx),
        idx.shape[1], moP, nShrP, rowOffChild, rowOffParent, nk,
        kernels.stream()))
    return partial


def _dist_h2_up_plain(own, Town, ptr, idx, moP, nShrP, rowOffChild,
                      rowOffParent):
    """Plain PyTorch version of :func:`dist_h2_up`."""
    up = _transferTargets(own, Town, ptr, idx, rowOffChild)
    own[:, rowOffParent:rowOffParent + moP] += up[:, :moP]
    return up[:, moP:].contiguous()


def _transferTargets(v, T, ptr, idx, rowOff):
    """Plain: for each target t of each shard, sum over the CSR range's
    rows c of T[k, rowOff + c] v[k, rowOff + c]: [nk, nT, M]."""
    nk, nT1 = ptr.shape
    nT = nT1 - 1
    rows = idx + rowOff
    Tg = torch.gather(T, 1, rows[:, :, None, None].expand(
        -1, -1, T.shape[2], T.shape[3]))
    vg = torch.gather(v, 1, rows[:, :, None].expand(-1, -1, v.shape[2]))
    vals = torch.einsum('knij,knj->kni', Tg, vg)
    return _segmentSum(vals, _rowsOf(ptr, idx.shape[1]), nT)


def dist_h2_up_shared(shr, psum, Tshr, ptr, idx, shrOffChild, shrOffParent):
    """The shared parents of one level, on every shard alike:
    shr[k, shrOffParent + q] += psum[q] + sum over the shared children c
    (idx[ptr[q] .. ptr[q+1]]) of Tshr[shrOffChild + c] shr[k, shrOffChild
    + c].  psum [nShrP, M], ptr [nShrP + 1] (one copy for every shard)."""
    nk, shrTot, M = shr.shape
    nShrP = ptr.shape[0] - 1
    dev = shr.device
    if _check('dist_h2_up_shared', dev, (shr, psum, Tshr), (ptr, idx)):
        return _dist_h2_up_shared_plain(shr, psum, Tshr, ptr, idx,
                                        shrOffChild, shrOffParent)
    lib = _launch('up_shared')
    p = kernels.ptr
    kernels.check(lib.dist_h2_up_shared(
        p(shr), shrTot, M, p(psum), p(Tshr), p(ptr), p(idx), nShrP,
        shrOffChild, shrOffParent, nk, kernels.stream()))
    return shr


def _dist_h2_up_shared_plain(shr, psum, Tshr, ptr, idx, shrOffChild,
                             shrOffParent):
    """Plain PyTorch version of :func:`dist_h2_up_shared`."""
    nk = shr.shape[0]
    nShrP = ptr.shape[0] - 1
    rows = idx + shrOffChild
    vals = torch.einsum('nij,knj->kni', Tshr[rows], shr[:, rows])
    seg = _rowsOf(ptr[None], idx.shape[0]).expand(nk, -1)
    add = _segmentSum(vals, seg, nShrP)
    shr[:, shrOffParent:shrOffParent + nShrP] += psum[None] + add
    return shr


# ----------------------------------------------------------------- far --

def dist_h2_far(outOwn, own, shr, buf, level, ptrA, srcA, KA, ptrC, srcC,
                KC):
    """One level's far field.  level = (rowOff, shrOff, mo, nShr): the
    level's first own row and shared row and its own and shared node
    counts.  For each owned target t < mo: outOwn[k, rowOff + t] += sum
    over its A pairs e of KA[k, e] ce[k, srcA[k, e]], ce[k] = [own rows of
    the level (mo), shr rows of the level (nShr), buf[k] (or buf[0]) rows
    (the received coefficients), 0].  Returns partC [nk, nShr, M], for
    each shared target q the sum over its C pairs of KC[k, e]
    own[k, rowOff + srcC[k, e]], to be psum-ed.  buf [nb, nBufRows, M]."""
    nk, ownTot, M = outOwn.shape
    rowOff, shrOff, mo, nShr = level
    nb, nBufRows = buf.shape[0], buf.shape[1]
    dev = outOwn.device
    if ptrA.shape != (nk, mo + 1) or ptrC.shape != (nk, nShr + 1) \
            or nb not in (1, nk):
        raise ValueError('dist_h2_far: shapes disagree')
    if _check('dist_h2_far', dev, (outOwn, own, shr, buf, KA, KC),
              (ptrA, srcA, ptrC, srcC)):
        return _dist_h2_far_plain(outOwn, own, shr, buf, level, ptrA, srcA,
                                  KA, ptrC, srcC, KC)
    partC = torch.empty((nk, nShr, M), dtype=own.dtype, device=dev)
    lib = _launch('far')
    p = kernels.ptr
    kernels.check(lib.dist_h2_far(
        p(outOwn), p(partC), p(own), p(shr), p(buf),
        0 if nb == 1 else nBufRows * M, nBufRows, ownTot, shr.shape[1], M,
        rowOff, shrOff, mo, nShr, p(ptrA), p(srcA), p(KA), srcA.shape[1],
        p(ptrC), p(srcC), p(KC), srcC.shape[1], nk, kernels.stream()))
    return partC


def _dist_h2_far_plain(outOwn, own, shr, buf, level, ptrA, srcA, KA, ptrC,
                       srcC, KC):
    """Plain PyTorch version of :func:`dist_h2_far`."""
    nk, _, M = outOwn.shape
    rowOff, shrOff, mo, nShr = level
    ce = torch.cat([own[:, rowOff:rowOff + mo], shr[:, shrOff:shrOff + nShr],
                    buf.expand(nk, -1, -1), own.new_zeros(nk, 1, M)], 1)
    s = torch.where(srcA < ce.shape[1] - 1, srcA, ce.shape[1] - 1)
    vals = torch.einsum('knij,knj->kni', KA, torch.gather(
        ce, 1, s[:, :, None].expand(-1, -1, M)))
    outOwn[:, rowOff:rowOff + mo] += _segmentSum(
        vals, _rowsOf(ptrA, srcA.shape[1]), mo)
    vc = torch.einsum('knij,knj->kni', KC, torch.gather(
        own, 1, (srcC + rowOff)[:, :, None].expand(-1, -1, M)))
    return _segmentSum(vc, _rowsOf(ptrC, srcC.shape[1]), nShr)


def dist_h2_far_shared(outShr, shr, psum, shrOff, ptrD, srcD, KD):
    """The shared targets of one level, on every shard alike:
    outShr[k, shrOff + q] += psum[q] + sum over its D pairs e of KD[e]
    shr[k, shrOff + srcD[e]] (ptrD [nShr + 1], srcD, KD one copy for every
    shard)."""
    nk, shrTot, M = outShr.shape
    nShr = ptrD.shape[0] - 1
    dev = outShr.device
    if _check('dist_h2_far_shared', dev, (outShr, shr, psum, KD),
              (ptrD, srcD)):
        return _dist_h2_far_shared_plain(outShr, shr, psum, shrOff, ptrD,
                                         srcD, KD)
    lib = _launch('far_shared')
    p = kernels.ptr
    kernels.check(lib.dist_h2_far_shared(
        p(outShr), p(shr), shrTot, M, shrOff, nShr, p(psum), p(ptrD),
        p(srcD), p(KD), nk, kernels.stream()))
    return outShr


def _dist_h2_far_shared_plain(outShr, shr, psum, shrOff, ptrD, srcD, KD):
    """Plain PyTorch version of :func:`dist_h2_far_shared`."""
    nk = outShr.shape[0]
    nShr = ptrD.shape[0] - 1
    vals = torch.einsum('nij,knj->kni', KD, shr[:, srcD + shrOff])
    seg = _rowsOf(ptrD[None], srcD.shape[0]).expand(nk, -1)
    outShr[:, shrOff:shrOff + nShr] += psum[None] + _segmentSum(
        vals, seg, nShr)
    return outShr


# ---------------------------------------------------------------- down --

def dist_h2_down(outOwn, outShr, Town, parOwnRow, parShrRow, Tshr,
                 shrParRow, level):
    """One level of the downward pass, level = (rowOff, shrOff, mo, nShr):
    for each owned node t < mo, outOwn[k, rowOff + t] += Town[k, rowOff +
    t]^T (outOwn[k, parOwnRow] + outShr[k, parShrRow]) (a row < 0 reads
    0); for each shared node q < nShr, outShr[k, shrOff + q] +=
    Tshr[shrOff + q]^T outShr[k, shrParRow[shrOff + q]].  parOwnRow,
    parShrRow [nk, ownTot]; shrParRow [shrTot]."""
    nk, ownTot, M = outOwn.shape
    rowOff, shrOff, mo, nShr = level
    dev = outOwn.device
    if _check('dist_h2_down', dev, (outOwn, outShr, Town, Tshr),
              (parOwnRow, parShrRow, shrParRow)):
        return _dist_h2_down_plain(outOwn, outShr, Town, parOwnRow,
                                   parShrRow, Tshr, shrParRow, level)
    lib = _launch('down')
    p = kernels.ptr
    kernels.check(lib.dist_h2_down(
        p(outOwn), p(outShr), ownTot, outShr.shape[1], M, p(Town),
        p(parOwnRow), p(parShrRow), p(Tshr), p(shrParRow), rowOff, mo,
        shrOff, nShr, nk, kernels.stream()))
    return outOwn


def _dist_h2_down_plain(outOwn, outShr, Town, parOwnRow, parShrRow, Tshr,
                        shrParRow, level):
    """Plain PyTorch version of :func:`dist_h2_down`."""
    M = outOwn.shape[2]
    rowOff, shrOff, mo, nShr = level
    sl = slice(rowOff, rowOff + mo)
    po, ps = parOwnRow[:, sl], parShrRow[:, sl]
    par = torch.where((po >= 0)[:, :, None], torch.gather(
        outOwn, 1, po.clamp(min=0)[:, :, None].expand(-1, -1, M)), 0.0) \
        + torch.where((ps >= 0)[:, :, None], torch.gather(
            outShr, 1, ps.clamp(min=0)[:, :, None].expand(-1, -1, M)), 0.0)
    outOwn[:, sl] += torch.einsum('knji,knj->kni', Town[:, sl], par)
    if nShr:
        ss = slice(shrOff, shrOff + nShr)
        outShr[:, ss] += torch.einsum('nji,knj->kni', Tshr[ss],
                                      outShr[:, shrParRow[ss]])
    return outOwn


# ---------------------------------------------------------------- leaf --

def dist_h2_leaf(y, outOwn, lfPhi, lfXslot, lfRow):
    """y[k, lfXslot[k, q, n]] += lfPhi[k, q, n] . outOwn[k, lfRow[k, q]]
    for each local dof (lfXslot in [0, R), lfRow >= 0)."""
    nk, R = y.shape
    _, ownTot, M = outOwn.shape
    _, LP, nbar, _ = lfPhi.shape
    dev = y.device
    if _check('dist_h2_leaf', dev, (y, outOwn, lfPhi), (lfXslot, lfRow)):
        return _dist_h2_leaf_plain(y, outOwn, lfPhi, lfXslot, lfRow)
    lib = _launch('leaf')
    p = kernels.ptr
    kernels.check(lib.dist_h2_leaf(
        p(y), R, p(outOwn), ownTot, M, p(lfPhi), p(lfXslot), p(lfRow), LP,
        nbar, nk, kernels.stream()))
    return y


def _dist_h2_leaf_plain(y, outOwn, lfPhi, lfXslot, lfRow):
    """Plain PyTorch version of :func:`dist_h2_leaf`."""
    nk, R = y.shape
    M = outOwn.shape[2]
    rows = lfRow.clamp(min=0)
    v = torch.gather(outOwn, 1, rows[:, :, None].expand(-1, -1, M))
    yv = torch.einsum('kpnm,kpm->kpn', lfPhi, v)
    ok = (lfRow >= 0)[:, :, None] & (lfXslot >= 0) & (lfXslot < R)
    seg = torch.where(ok, lfXslot, R).reshape(nk, -1)
    y += _segmentSum(yv.reshape(nk, -1), seg, R)
    return y


# each phase's plain version, of the wrapper's signature and effect (on
# any device: chip_smoke.py holds the kernels against them on the card)
PLAIN = {'dist_h2_near': _dist_h2_near_plain,
         'dist_h2_moments': _dist_h2_moments_plain,
         'dist_h2_up': _dist_h2_up_plain,
         'dist_h2_up_shared': _dist_h2_up_shared_plain,
         'dist_h2_far': _dist_h2_far_plain,
         'dist_h2_far_shared': _dist_h2_far_shared_plain,
         'dist_h2_down': _dist_h2_down_plain,
         'dist_h2_leaf': _dist_h2_leaf_plain}

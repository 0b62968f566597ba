"""The port's partitioning, shard mesh, collectives, maps, overlaps and
row-sharded operators against the JAX package (its 8-device CPU mesh), on
the same seeded inputs.

  partitioning   the partitions and boundary layers of fem/partitioning.py
                 on uniformSquare(9) and (10): equal (the same numpy code);
                 the two packages' uniformSquare meshes equal
  overlaps       buildCellOverlap, the overlapping dof partition and the
                 overlap manager's plans: equal; accumulate, distribute,
                 unique, shardmapAccumulate (K29 pack and receive-add),
                 Repartitioner.apply and deviceApply (K29's 2D gather):
                 1e-14 of the JAX results
  maps           Map, Import (K29's 2D gather) and DistMatrix (dense; CSR
                 parts through K9): 1e-14
  K29            the plain pack, receive-add and 2D gather against numpy
  S1, S3         shardedDenseAssembly at 4 and 8 shards: 1e-12 of the
                 largest entry of the JAX one; the row-sharded operator,
                 CG-Jacobi on it, the row-block and halo operators: 1e-12
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
import pynucleus_tpu.fem.partitioning as jpart
import pynucleus_tpu.parallel.overlaps as jov
import pynucleus_tpu.parallel.maps as jmaps
import pynucleus_tpu.parallel.dist as jdist
from pynucleus_tpu.nl import getFractionalKernel as jKernel
from pynucleus_tpu.base.linear_operators import Dense_LinearOperator as jDense

from pynucleus_tpu_torch.fem import uniformSquare, simpleInterval, P1_DoFMap
import pynucleus_tpu_torch.fem.partitioning as tpart
import pynucleus_tpu_torch.parallel.overlaps as tov
import pynucleus_tpu_torch.parallel.maps as tmaps
import pynucleus_tpu_torch.parallel.dist as tdist
from pynucleus_tpu_torch.parallel import collectives as coll
from pynucleus_tpu_torch.parallel.dist import ShardMesh, makeDeviceMesh
from pynucleus_tpu_torch.kernels.outbox import (outbox_pack, outbox_recv_add,
                                                outbox_gather2d)
from pynucleus_tpu_torch.nl import getFractionalKernel
from pynucleus_tpu_torch.nl.kernels import getIntegrableKernel
from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
from pynucleus_tpu_torch.fem.assembly import assembleRHS
from pynucleus_tpu_torch.fem.functions import constant


@pytest.fixture(autouse=True, scope='module')
def _oneTorchThread():
    """One torch thread for this module's tests: their tensors are small,
    and the workers of a parallel test run share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module', params=[9, 10], ids=['N9', 'N10'])
def squares(request):
    jm, tm = jfem.uniformSquare(request.param), uniformSquare(request.param)
    return jm, tm


def test_uniform_square_matches_jax(squares):
    jm, tm = squares
    np.testing.assert_array_equal(tm.vertices, jm.vertices)
    np.testing.assert_array_equal(tm.cells, jm.cells)


@pytest.mark.parametrize('nParts', [2, 4, 6])
def test_partitions_match_jax(squares, nParts):
    jm, tm = squares
    jdm, tdm = jfem.P1_DoFMap(jm), P1_DoFMap(tm, device='cpu')
    for fj, ft, a, b in (
            (jpart.regularVertexPartitioner, tpart.regularVertexPartitioner,
             jm, tm),
            (jpart.regularMeshPartitioner, tpart.regularMeshPartitioner,
             jm, tm),
            (jpart.partitionCellsRecursiveBisection,
             tpart.partitionCellsRecursiveBisection, jm, tm),
            (jpart.regularDofPartitioner, tpart.regularDofPartitioner,
             jdm, tdm),
            (jpart.metisDofPartitioner, tpart.metisDofPartitioner,
             jdm, tdm)):
        np.testing.assert_array_equal(ft(b, nParts), fj(a, nParts))
    part = tpart.regularMeshPartitioner(tm, nParts)
    lt = tpart.boundaryLayers(tm, part, numLayers=2)
    lj = jpart.boundaryLayers(jm, np.asarray(part), numLayers=2)
    assert lt.keys() == lj.keys()
    for p in lt:
        for a, b in zip(lt[p], lj[p]):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------- overlaps --

@pytest.fixture(scope='module')
def overlaps():
    """tests/test_overlaps.py's set-up in both packages."""
    jm, tm = jfem.uniformSquare(N=10).refine(), uniformSquare(N=10).refine()
    jdm, tdm = jfem.P1_DoFMap(jm, tag=None), P1_DoFMap(tm, tag=None,
                                                       device='cpu')
    cellPart = tpart.regularMeshPartitioner(tm, 4)
    out = {}
    for name, ov, m, dm in (('jax', jov, jm, jdm), ('port', tov, tm, tdm)):
        localCells = ov.buildCellOverlap(m, cellPart, depth=1)
        numOwn = [int((cellPart == p).sum()) for p in range(4)]
        part = ov.OverlappingDofPartition(dm, localCells, numOwnCells=numOwn)
        out[name] = (m, dm, localCells, part, ov.AlgebraicOverlapManager(part))
    return cellPart, out


def test_overlap_plans_match_jax(overlaps):
    _, out = overlaps
    (_, _, lj, pj, mj), (_, _, lt, pt, mt) = out['jax'], out['port']
    for a, b in zip(lt, lj):
        np.testing.assert_array_equal(a, b)
    for attr in ('multiplicity', 'ownerOf', 'counts', 'l2g', 'slotOf'):
        np.testing.assert_array_equal(getattr(pt, attr), getattr(pj, attr))
    for attr in ('packSlot', 'recvPos', 'recvSlot', 'weights', 'ownerMask'):
        np.testing.assert_array_equal(getattr(mt, attr), getattr(mj, attr))


def test_accumulate_distribute_unique_match_jax(overlaps):
    _, out = overlaps
    pt, mt = out['port'][3], out['port'][4]
    mj = out['jax'][4]
    rng = np.random.default_rng(3)
    X = rng.standard_normal((pt.nParts, pt.maxLocal))
    for f in ('accumulate', 'distribute', 'unique'):
        np.testing.assert_allclose(getattr(mt, f)(X), getattr(mj, f)(X),
                                   rtol=0, atol=1e-14)
    # the shard program: K29 pack, all_gather, K29 receive-add; one group
    # and two groups of shards
    devs = np.array(jax.devices()[:4])
    jmesh = jax.sharding.Mesh(devs, ('d',))
    ref = np.asarray(mj.shardmapAccumulate(jmesh)(jax.device_put(
        jnp.asarray(X), jax.sharding.NamedSharding(
            jmesh, jax.sharding.PartitionSpec('d')))))
    for mesh in (makeDeviceMesh(4, device='cpu'), ShardMesh(4, ['cpu'] * 2)):
        got = mt.shardmapAccumulate(mesh)(torch.as_tensor(X)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-14)
        np.testing.assert_allclose(got, mt.accumulate(X), rtol=0,
                                   atol=1e-14)


def test_repartition_matches_jax(overlaps):
    cellPart, out = overlaps
    jm, jdm = out['jax'][0], out['jax'][1]
    tm, tdm = out['port'][0], out['port'][1]
    bc = tm.vertices[tm.cells].mean(axis=1)
    tgt = np.minimum((bc[:, 1] * 4).astype(np.int64), 3)
    sj, gj, rj = jov.repartitionConnector(jdm, jm, cellPart, tgt)
    st, gt, rt = tov.repartitionConnector(tdm, tm, cellPart, tgt)
    for a in ('gatherPart', 'gatherSlot', 'validMask'):
        np.testing.assert_array_equal(getattr(rt, a), getattr(rj, a))
    rng = np.random.default_rng(5)
    x = rng.standard_normal(tdm.num_dofs)
    Xs = st.fromGlobal(x)
    ref = rj.apply(Xs)
    np.testing.assert_allclose(rt.apply(Xs), ref, rtol=0, atol=1e-14)
    np.testing.assert_allclose(gt.toGlobal(rt.apply(Xs)), x, rtol=0,
                               atol=1e-14)
    for mesh in (makeDeviceMesh(4, device='cpu'), ShardMesh(4, ['cpu'] * 2)):
        got = rt.deviceApply(mesh)(torch.as_tensor(Xs)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-14)


# ----------------------------------------------------------------- maps --

def test_maps_import_and_dist_matrix_match_jax():
    m = tmaps.Map.blockDistribution(17, 4)
    x = np.random.RandomState(0).rand(17)
    dv = tmaps.DistVector.fromGlobal(m, x, device='cpu')
    np.testing.assert_array_equal(dv.toGlobal(), x)
    perm = np.random.RandomState(1).permutation(17)
    own = [perm[:5], perm[5:9], perm[9:14], perm[14:]]
    m2 = tmaps.Map(own, 17)
    dv2 = tmaps.Import(m, m2)(dv)
    np.testing.assert_array_equal(dv2.toGlobal(), x)
    jdv2 = jmaps.Import(jmaps.Map.blockDistribution(17, 4), jmaps.Map(
        own, 17))(jmaps.DistVector.fromGlobal(
            jmaps.Map.blockDistribution(17, 4), x))
    np.testing.assert_array_equal(dv2.data.numpy(), np.asarray(jdv2.data))
    # dense rows, and a CSR operator kept sparse (K9 per part)
    n = 12
    A = np.random.RandomState(2).rand(n, n)
    xm = np.random.RandomState(3).rand(n)
    mb = tmaps.Map.blockDistribution(n, 3)
    y = tmaps.DistMatrix(torch.as_tensor(A), mb).matvec(xm)
    np.testing.assert_allclose(y.toGlobal(), A @ xm, rtol=1e-12)
    dm = P1_DoFMap(simpleInterval(-1.0, 1.0).refine().refine().refine()
                   .refine(), device='cpu')
    S = nonlocalBuilder(dm, getIntegrableKernel(1, 'indicator', 0.3)) \
        .getSparse()
    mS = tmaps.Map([np.arange(k, S.num_rows, 3) for k in range(3)],
                   S.num_rows)
    xs = np.random.RandomState(4).rand(S.num_rows)
    yS = tmaps.DistMatrix(S, mS).matvec(xs).toGlobal()
    np.testing.assert_allclose(yS, S.toarray() @ xs, rtol=0, atol=1e-14)


# ------------------------------------------------------------------ K29 --

def test_outbox_plain_versions():
    rng = np.random.default_rng(7)
    src = rng.standard_normal((3, 11, 4))
    slot = rng.integers(-1, 11, size=(3, 6))
    for dtype in (torch.int64, torch.int32):
        s = torch.as_tensor(slot, dtype=dtype)
        got = outbox_pack(torch.as_tensor(src), s).numpy()
        ref = np.where(slot[:, :, None] >= 0,
                       src[np.arange(3)[:, None], np.maximum(slot, 0)], 0.0)
        np.testing.assert_array_equal(got, ref)
        # one source for every shard
        got1 = outbox_pack(torch.as_tensor(src[:1]), s).numpy()
        np.testing.assert_array_equal(
            got1, np.where(slot[:, :, None] >= 0,
                           src[0][np.maximum(slot, 0)], 0.0))
    buf = rng.standard_normal(9)
    rp = rng.integers(0, 10, size=(3, 5, 2))         # 9: the zero lane
    rp[:, 4] = 9                                     # padding rows
    rs = np.stack([rng.permutation(8)[:5] for _ in range(3)])
    rs[:, 4] = 0
    X = rng.standard_normal((3, 8))
    got = outbox_recv_add(torch.as_tensor(X.copy()), torch.as_tensor(buf),
                          torch.as_tensor(rp), torch.as_tensor(rs)).numpy()
    ref = X.copy()
    bz = np.concatenate([buf, [0.0]])
    for k in range(3):
        for i in range(4):
            ref[k, rs[k, i]] += bz[rp[k, i]].sum()
    np.testing.assert_array_equal(got, ref)
    B = rng.standard_normal((4, 6))
    gp, gs = rng.integers(0, 4, (3, 5)), rng.integers(0, 6, (3, 5))
    vm = (rng.random((3, 5)) > 0.3).astype(np.float64)
    got = outbox_gather2d(torch.as_tensor(B), torch.as_tensor(gp),
                          torch.as_tensor(gs), torch.as_tensor(vm)).numpy()
    np.testing.assert_array_equal(got, B[gp, gs] * vm)
    with pytest.raises(ValueError, match='float64'):
        outbox_pack(torch.as_tensor(src, dtype=torch.float32),
                    torch.as_tensor(slot))


def test_collectives_and_mesh():
    mesh = ShardMesh(5, ['cpu', 'cpu'])
    assert mesh.devices.size == 5
    assert [g.shardsH.tolist() for g in mesh.groups] == [[0, 2, 4], [1, 3]]
    full = torch.arange(5 * 5 * 2, dtype=torch.float64).reshape(5, 5, 2)
    parts = mesh.split(full)
    assert torch.equal(mesh.join(parts), full)
    assert torch.equal(coll.psum(mesh, parts)[1], full.sum(0))
    assert torch.equal(coll.all_gather(mesh, parts)[0], full)
    recv = mesh.join(coll.all_to_all(mesh, parts))
    assert torch.equal(recv, full.transpose(0, 1))
    got = mesh.join(coll.ppermute(mesh, parts, [(0, 1), (3, 0)]))
    assert torch.equal(got[1], full[0]) and torch.equal(got[0], full[3])
    assert not got[2].any()
    m = makeDeviceMesh(3, device='cpu')
    assert m.devices.size == 3 and len(m.groups) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='cuda'):
            makeDeviceMesh(4)


# --------------------------------------------------------------- S1, S3 --

@pytest.mark.parametrize('nd', [4, 8])
def test_sharded_dense_assembly_matches_jax(nd):
    jm = jfem.simpleInterval(-1.0, 1.0).refine()
    tm = simpleInterval(-1.0, 1.0).refine()
    for _ in range(5):
        jm, tm = jm.refine(), tm.refine()
    jdm, tdm = jfem.P1_DoFMap(jm), P1_DoFMap(tm, device='cpu')
    Aj = np.asarray(jdist.shardedDenseAssembly(
        jdm, jKernel(1, 0.25), jdist.makeDeviceMesh(nd)).data)
    At = tdist.shardedDenseAssembly(tdm, getFractionalKernel(1, 0.25),
                                    makeDeviceMesh(nd, device='cpu'))
    np.testing.assert_allclose(At.data.numpy(), Aj, rtol=0,
                               atol=1e-12 * np.abs(Aj).max())
    # the row-sharded operator and CG-Jacobi on it (K4)
    b = assembleRHS(tdm, constant(1.0)).data
    mesh = makeDeviceMesh(nd, device='cpu')
    Ash, pad = tdist.rowShardedOperator(At, mesh)
    assert (Ash.num_rows - tdm.num_dofs) == pad
    x, its = tdist.distributedSolveStep(mesh, Ash, b, pad, tol=1e-10,
                                        maxiter=500)
    jmesh = jdist.makeDeviceMesh(nd)
    Ajs, padj = jdist.rowShardedOperator(jDense(jnp.asarray(Aj)), jmesh)
    xj, itj = jdist.distributedSolveStep(jmesh, Ajs, jnp.asarray(b.numpy()),
                                         padj, tol=1e-10, maxiter=500)
    # _cg_core counts the steps, cg_solver one less when converged
    assert its + 1 == int(itj)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-8)
    res = float(torch.linalg.norm(b - At.matvec(x)))
    assert res < 1e-8 * float(torch.linalg.norm(b))


@pytest.mark.parametrize('nd', [3, 8])
def test_row_block_and_halo_operators(nd):
    """tests/test_distop.py's dense bases on the port: a banded operator
    takes the halo exchange (K29 pack, ppermute), the fractional one's full
    bandwidth the all_gather; both modes against the JAX operators."""
    from pynucleus_tpu_torch.base.linear_operators import \
        Dense_LinearOperator
    rng = np.random.default_rng(11)
    n = 61
    B = np.triu(np.tril(rng.standard_normal((n, n)), 4), -4)
    tm = simpleInterval(-1.0, 1.0)
    for _ in range(6):
        tm = tm.refine()
    dm = P1_DoFMap(tm, device='cpu')
    D = nonlocalBuilder(dm, getFractionalKernel(1, 0.75)).getDense()
    jmesh = jdist.makeDeviceMesh(nd)
    for mesh in (makeDeviceMesh(nd, device='cpu'),
                 ShardMesh(nd, ['cpu'] * 2)):
        for A in (Dense_LinearOperator(torch.as_tensor(B)), D):
            x = np.sin(np.pi * np.linspace(-1, 1, A.num_rows))
            xt = torch.as_tensor(x)
            Aj = jDense(jnp.asarray(A.toarray()))
            for op, opj in ((tdist.DistributedRowBlockOperator(A, mesh),
                             jdist.DistributedRowBlockOperator(Aj, jmesh)),
                            (tdist.DistributedHaloOperator(A, mesh),
                             jdist.DistributedHaloOperator(Aj, jmesh))):
                y = op.matvec(xt).numpy()
                yj = np.asarray(opj.matvec(jnp.asarray(x)))
                assert np.abs(y - yj).max() <= 1e-12 * np.abs(yj).max()
                np.testing.assert_array_equal(op.diagonal.numpy(),
                                              np.diag(A.toarray()))
        halo = tdist.DistributedHaloOperator(
            Dense_LinearOperator(torch.as_tensor(B)), mesh)
        assert not halo.fullGather and halo.halo == 4
        assert tdist.DistributedHaloOperator(D, mesh).fullGather

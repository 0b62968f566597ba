"""The port's distributed H2 and CSR operators against the JAX package.

The same meshes go through the JAX package on its 8-device CPU mesh and
through the port on a shard mesh of 'cpu' shards, at the JAX tests' shard
counts (tests/test_dist_h2.py: 8; tests/test_dist_assemble.py: 4).

  _setup            the shard metadata (dof, node and pair assignment,
                    the outbox plans sendSlotX and the far send slots,
                    lfSlot, parOwnS/parShrS, the far pair lists): the JAX
                    arrays exactly; the transfers and blocks to 1e-13
  the apply         K28's phases and K29's outboxes (their plain versions
                    here): 1e-12 relative to the JAX distributed apply,
                    1e-11 to the port's own H2 (the bar of
                    tests/test_dist_h2.py), in halo and bcast mode, 1D and
                    2D; two shard groups give the same bits as one
  assemble          the partition-first build against the wrapped operator
                    1e-10 relative, its diagonal 1e-9
                    (tests/test_dist_assemble.py's bars)
  the CSR operator  the indicator interval to 1e-12
  distributed CG    iterations equal to the JAX CG's on its H2 operator
                    (equal to its distributed CG's, tests/test_dist_h2.py),
                    the solutions within 1e-8
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.nl import getFractionalKernel as jKernel, \
    getIntegrableKernel as jIntegrable
from pynucleus_tpu.nl.assembly import nonlocalBuilder as jBuilder
from pynucleus_tpu.parallel import makeDeviceMesh as jMesh
from pynucleus_tpu.parallel.dist_h2 import (
    DistributedH2Matrix as jDistH2, DistributedCSROperator as jDistCSR)
from pynucleus_tpu.base.solvers import _cg_core
from pynucleus_tpu.base.linear_operators import Diagonal_LinearOperator as jD

from pynucleus_tpu_torch.fem import simpleInterval, uniformSquare, circle, \
    P1_DoFMap
from pynucleus_tpu_torch.nl import getFractionalKernel
from pynucleus_tpu_torch.nl.kernels import getIntegrableKernel
from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
from pynucleus_tpu_torch.parallel import (makeDeviceMesh, DistributedH2Matrix,
                                          DistributedCSROperator)
from pynucleus_tpu_torch.parallel.dist import ShardMesh
from pynucleus_tpu_torch.base.solvers import cg_solver
from pynucleus_tpu_torch.base.linear_operators import Diagonal_LinearOperator


@pytest.fixture(autouse=True, scope='module')
def _oneTorchThread():
    """One torch thread for this module's tests: their tensors are small,
    and the workers of a parallel test run share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _refined(m, n):
    for _ in range(n):
        m = m.refine()
    return m


def _case(name):
    """(JAX dofmap, port dofmap, dim, s) of a test mesh."""
    if name.startswith('interval'):
        n = int(name[8:])
        jm, tm = _refined(jfem.simpleInterval(-1.0, 1.0), n), \
            _refined(simpleInterval(-1.0, 1.0), n)
        return jfem.P1_DoFMap(jm), P1_DoFMap(tm, device='cpu'), 1
    jm, tm = jfem.uniformSquare(9), uniformSquare(9)
    return jfem.P1_DoFMap(jm), P1_DoFMap(tm, device='cpu'), 2


_OPS = {}


def _h2(name, s):
    """The JAX and the port's H2 operators of a case (built once)."""
    key = (name, s)
    if key not in _OPS:
        jdm, tdm, dim = _case(name)
        _OPS[key] = (jBuilder(jdm, jKernel(dim, s)).getH2(),
                     nonlocalBuilder(tdm, getFractionalKernel(dim, s))
                     .getH2(), jdm, tdm)
    return _OPS[key]


def _probe(tdm):
    return np.sin(np.pi * tdm.getDoFCoordinates()[:, 0])


INT_KEYS = ('lfLvl', 'lfSlot', 'lfXslot', 'sendSlotX')
INT_PREFIX = ('parOwnS', 'parShrS', 'farsendSlotC', 'farsrcIA', 'fardstIA',
              'farsrcIC', 'fardstIC')
RP_INT_PREFIX = ('parShr', 'farsrcID', 'fardstID')


def _checkSetup(Aj, At):
    for k in ('maxOwn', 'nShr', 'R', 'LP', 'maxSendX', 'xeLen', 'nLvl', 'M'):
        assert At._meta[k] == Aj._meta[k], k
    assert set(At._farMeta) <= set(Aj._farMeta)
    for ell in set(Aj._farMeta) - set(At._farMeta):
        # a level the JAX plan lists with no far pair
        assert not (np.asarray(Aj._sh[f'fardstIA{ell}'])
                    < Aj._meta['maxOwn'][ell]).any()
    np.testing.assert_array_equal(At._localDofFlat, Aj._localDofFlat)
    for k, v in Aj._sh.items():
        if k.startswith('far') and int(''.join(
                c for c in k if c.isdigit())) not in At._farMeta:
            continue
        v = np.asarray(v)
        if k in INT_KEYS or k.startswith(INT_PREFIX):
            np.testing.assert_array_equal(At._sh[k], v, err_msg=k)
        elif not k.startswith('near'):
            np.testing.assert_allclose(At._sh[k], v, rtol=0,
                                       atol=1e-13 * max(np.abs(v).max(), 1),
                                       err_msg=k)
    for k, v in Aj._rp.items():
        if k.startswith(RP_INT_PREFIX):
            np.testing.assert_array_equal(At._rp[k], np.asarray(v),
                                          err_msg=k)
    # the near rows hold the same entries (each shard's rows in its order)
    for k in range(At.nd):
        a = sorted(zip(At._sh['nearRow'][k], At._sh['nearCol'][k]))
        b = sorted(zip(np.asarray(Aj._sh['nearRow'])[k],
                       np.asarray(Aj._sh['nearCol'])[k]))
        assert a == b


@pytest.mark.parametrize('name,s,bcast,nd', [
    ('interval8', 0.5, False, 8), ('interval7', 0.75, True, 8),
    ('square9', 0.5, False, 8), ('square9', 0.5, True, 4)],
    ids=['interval8-halo', 'interval7-bcast', 'square9-halo',
         'square9-bcast-4'])
def test_apply_and_setup_match_jax(name, s, bcast, nd):
    Hj, Ht, jdm, tdm = _h2(name, s)
    Aj = jDistH2(Hj, jMesh(nd), bcast=bcast)
    At = DistributedH2Matrix(Ht, makeDeviceMesh(nd, device='cpu'),
                             bcast=bcast)
    _checkSetup(Aj, At)
    x = _probe(tdm)
    yj = np.asarray(Aj.matvec(jnp.asarray(x)))
    yt = At.matvec(torch.as_tensor(x)).numpy()
    yh = Ht.matvec(torch.as_tensor(x)).numpy()
    scale = np.linalg.norm(yj)
    assert np.linalg.norm(yt - yj) <= 1e-12 * scale
    assert np.linalg.norm(yt - yh) <= 1e-11 * max(scale, 1.0)
    np.testing.assert_allclose(At.diagonal.numpy(), Ht.diagonal.numpy(),
                               rtol=0, atol=1e-12)


def test_two_shard_groups_give_the_same_bits():
    """Shards stacked in two groups (k mod 2), the collectives moving
    between them, apply exactly as one group."""
    _, Ht, _, tdm = _h2('square9', 0.5)
    x = torch.as_tensor(_probe(tdm))
    one = DistributedH2Matrix(Ht, makeDeviceMesh(8, device='cpu'))
    two = DistributedH2Matrix(Ht, ShardMesh(8, ['cpu', 'cpu']))
    assert len(two.mesh.groups) == 2
    assert torch.equal(one.matvec(x), two.matvec(x))
    assert torch.equal(one.diagonal, two.diagonal)


@pytest.mark.parametrize('dim,noRef,s', [(1, 9, 0.75), (2, 3, 0.25)],
                         ids=['1d', '2d'])
def test_assemble_matches_wrap(dim, noRef, s):
    """tests/test_dist_assemble.py on the port (its 2D disc one
    refinement coarser: circle(n=8) at noRef 3, 545 dofs): the
    partition-first build (the 'csr' near format per shard, K7 on the
    shard's far rows) against the wrapped H2Matrix and the H2Matrix
    itself."""
    m = _refined(simpleInterval(-1.0, 1.0) if dim == 1 else circle(n=8),
                 noRef)
    dm = P1_DoFMap(m, device='cpu')
    kernel = getFractionalKernel(dim, s)
    mesh = makeDeviceMesh(4, device='cpu')
    H = nonlocalBuilder(dm, kernel).getH2()
    Awrap = DistributedH2Matrix(H, mesh)
    Adir = DistributedH2Matrix.assemble(dm, kernel, mesh)
    for k in ('sendSlotX', 'lfSlot', 'lfXslot'):
        np.testing.assert_array_equal(Adir._sh[k], Awrap._sh[k])
    x = torch.as_tensor(np.random.RandomState(0).rand(dm.num_dofs))
    yw, yd, ys = Awrap.matvec(x), Adir.matvec(x), H.matvec(x)
    scale = float(torch.linalg.norm(ys))
    assert float(torch.linalg.norm(yd - yw)) / scale < 1e-10
    assert float(torch.linalg.norm(yd - ys)) / scale < 1e-10
    dw, dd = Awrap.diagonal, Adir.diagonal
    assert float((dw - dd).abs().max() / dw.abs().max()) < 1e-9


def test_csr_near_format_is_the_global_csr():
    """_assembleNearField's 'csr' format: the blocks format's entries in
    global dof order, each row's columns sorted."""
    _, tdm, _ = _case('interval7')
    b = nonlocalBuilder(tdm, getFractionalKernel(1, 0.75))
    plan = b.planH2()
    near = b._assembleNearField(plan['Pnear'], plan['nodes'])
    b.params['nearFormat'] = 'csr'
    csr = b._assembleNearField(plan['Pnear'], plan['nodes'])
    rows, cols = near.rowsCols()
    perm = near.meta.perm
    dense = np.zeros((tdm.num_dofs, tdm.num_dofs))
    np.add.at(dense, (perm[rows.numpy()], perm[cols.numpy()]),
              near.dataT.numpy())
    np.testing.assert_array_equal(csr.toarray(), dense)
    for r in range(tdm.num_dofs):
        c = csr.indicesH[csr.indptrH[r]:csr.indptrH[r + 1]]
        assert (np.diff(c) > 0).all()
    b.params['nearFormat'] = 'tree'
    with pytest.raises(ValueError, match='nearFormat'):
        b._assembleNearField(plan['Pnear'], plan['nodes'])


def test_dist_csr_finite_horizon():
    """tests/test_dist_h2.py::test_dist_csr_finite_horizon on the port,
    with the JAX operator's halo plan."""
    jm = _refined(jfem.simpleInterval(-1.0, 1.0), 8)
    tm = _refined(simpleInterval(-1.0, 1.0), 8)
    Aj = jBuilder(jfem.P1_DoFMap(jm), jIntegrable(1, 'indicator', 0.2)) \
        .getSparse()
    tdm = P1_DoFMap(tm, device='cpu')
    A = nonlocalBuilder(tdm, getIntegrableKernel(1, 'indicator', 0.2)) \
        .getSparse()
    Dj = jDistCSR(Aj, jMesh(8))
    Ad = DistributedCSROperator(A, makeDeviceMesh(8, device='cpu'))
    np.testing.assert_array_equal(Ad._sh['sendSlotX'],
                                  np.asarray(Dj._sh['sendSlotX']))
    x = torch.as_tensor(np.sin(np.pi * np.linspace(-1.0, 1.0,
                                                   tdm.num_dofs)))
    assert float(torch.linalg.norm(A.matvec(x) - Ad.matvec(x))) < 1e-12
    assert float(torch.linalg.norm(Ad.diagonal - A.diagonal)) < 1e-12
    yj = np.asarray(Dj.matvec(jnp.asarray(x.numpy())))
    assert np.linalg.norm(Ad.matvec(x).numpy() - yj) < 1e-12


def test_dist_cg_matches_jax():
    """tests/test_dist_h2.py::test_dist_h2_cg_solve on the port: CG-Jacobi
    (K4) on the distributed operator against the JAX package's CG-Jacobi
    on its H2 operator (which tests/test_dist_h2.py holds equal to its
    distributed one)."""
    Hj, Ht, jdm, tdm = _h2('interval8', 0.75)
    At = DistributedH2Matrix(Ht, makeDeviceMesh(8, device='cpu'))
    bj = jnp.asarray(jfem.assembleRHS(jdm, jfem.constant(1.0)).data)
    uj, itj, _ = _cg_core(Hj, jD(1.0 / Hj.diagonal), bj, jnp.zeros_like(bj),
                          1e-10, 300, use_prec=True)
    b = torch.as_tensor(np.array(bj))
    cg = cg_solver(At)
    cg.setPreconditioner(Diagonal_LinearOperator(1.0 / At.diagonal))
    cg.tolerance = 1e-10
    cg.maxIter = 300
    u = cg.solve(b)
    # _cg_core counts the steps; cg_solver's iterations are one less when
    # it converged (the reference's convention)
    assert len(cg.residuals) - 1 == int(itj) == cg.iterations + 1
    assert float(np.linalg.norm(u.numpy() - np.asarray(uj))) < 1e-8
    assert cg.residuals[-1] <= 1e-10

"""The port's distributed drivers and the sharded multigrid against the JAX
package (its 8-device CPU mesh), the shards on the CPU.

  testDistOp       tests/test_distop.py::test_interval_s025's line: 8 CG
                   iterations, residual and L2 error within rtol 1e-6 of
                   the JAX driver and inside the reference cache's
                   tolerances, the distributed applies within 1e-12 of the
                   H2 one; a finite-horizon line (sparse base: the CSR halo
                   operator and the row blocks) and a dense base (row
                   blocks, the halo operator) within 1e-12
  runParallelGMG   tests/test_parallel_gmg.py::
                   test_sharded_vs_serial_residual_history on the port:
                   --ranks 8 repeats --ranks 1's residual histories (rtol
                   1e-10, atol 1e-12), the iterations and histories those
                   of the JAX driver's serial line; the multigrid shards
                   its levels of at least 2000 rows
  dry run          dryrunDistributedH2 at noRef 8: its apply, its CG
                   converged (asserted, unlike the JAX dry run), the
                   partition-first build
"""
import numpy as np
import pytest
import torch

from drivers.testDistOp import main as jDistOp
from drivers.runParallelGMG import main as jParallelGMG

from pynucleus_tpu_torch.drivers.testDistOp import main as tDistOp
from pynucleus_tpu_torch.drivers.runParallelGMG import main as tParallelGMG
from pynucleus_tpu_torch.parallel import makeDeviceMesh
from pynucleus_tpu_torch.parallel.dist import (DistributedRowBlockOperator,
                                               DistributedHaloOperator)
from pynucleus_tpu_torch.parallel.dist_h2 import (DistributedH2Matrix,
                                                  DistributedCSROperator,
                                                  dryrunDistributedH2)

@pytest.fixture(autouse=True, scope='module')
def _oneTorchThread():
    """One torch thread for this module's tests: their tensors are small,
    and the workers of a parallel test run share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


INF_FLAGS = ['--horizon', 'inf', '--problem', 'constant',
             '--buildDense', '--buildH2', '--buildH2Reduced',
             '--buildDistributedH2Bcast', '--buildDistributedH2', '--doSolve']


def _jaxGroups(d):
    out = {}
    for g in ('matvec errors', 'solve'):
        if g in d.outputGroups:
            out.update(d.outputGroups[g].toDict())
    return out


def _portGroups(d):
    out = {}
    for g in ('matvec errors', 'solve'):
        if g in d:
            out.update(d[g].toDict())
    return out


def test_testDistOp_interval_s025_matches_jax():
    argv = ['--domain', 'interval', '--s', 'const(0.25)', '--noRef', '6'] \
        + INF_FLAGS
    j = _jaxGroups(jDistOp(argv))
    d = tDistOp(argv + ['--device', 'cpu'], quiet=True)
    t = _portGroups(d)
    assert isinstance(d['ops']['A_distributed_halo'], DistributedH2Matrix)
    assert d['ops']['A_distributed_bcast'].bcast
    assert t['CG iterations'] == j['CG iterations'] == 8
    for k in ('residual norm', 'L2 error'):
        assert np.isclose(t[k], j[k], rtol=1e-6, atol=0), k
    # the reference cache (tests/test_distop.py)
    assert np.isclose(t['residual norm'], 3.2398173668907127e-06, rtol=2e-1)
    assert np.isclose(t['L2 error'], 0.008022633603074793, rtol=1e-1)
    assert t['|(A_dense - A_h2) * x |'] < 1e-5
    assert np.isclose(t['|(A_dense - A_h2) * x |'],
                      j['|(A_dense - A_h2) * x |'], rtol=1e-6)
    assert t['|(A_h2 - A_distributed_bcast) * x|'] < 1e-12
    assert t['|(A_h2 - A_distributed_halo) * x|'] < 1e-12


@pytest.mark.parametrize('flags,ops', [
    (['--horizon', '0.2', '--noRef', '6', '--buildSparse'],
     (DistributedRowBlockOperator, DistributedCSROperator)),
    (['--noRef', '5', '--buildDense'],
     (DistributedRowBlockOperator, DistributedHaloOperator))],
    ids=['sparse-finite-horizon', 'dense'])
def test_testDistOp_other_bases(flags, ops):
    argv = ['--domain', 'interval', '--s', 'const(0.25)', '--ranks', '8',
            '--buildDistributedH2Bcast', '--buildDistributedH2'] + flags
    d = tDistOp(argv + ['--device', 'cpu'], quiet=True)
    assert isinstance(d['ops']['A_distributed_bcast'], ops[0])
    assert isinstance(d['ops']['A_distributed_halo'], ops[1])
    base = d['ops'].get('A_sparse', d['ops'].get('A_dense'))
    scale = float(torch.linalg.norm(base.matvec(d['x'])))
    errs = d['matvec errors'].toDict()
    assert len(errs) == 2
    for v in errs.values():
        assert v < 1e-12 * scale
    j = _jaxGroups(jDistOp(argv))
    for k, v in errs.items():
        assert k in j and j[k] < 1e-9


def test_runParallelGMG_sharded_matches_serial_and_jax():
    argv = ['--domain', 'interval', '--element', 'P1', '--noRef', '12']
    d1 = tParallelGMG(argv + ['--ranks', '1', '--device', 'cpu'], quiet=True)
    d8 = tParallelGMG(argv + ['--ranks', '8', '--device', 'cpu'], quiet=True)
    As = d8['ml'].levels.As
    assert [type(A).__name__ for A in As] == \
        ['CSR_LinearOperator'] + ['DistributedCSROperator'] * (len(As) - 1)
    assert all(A.num_rows >= 2000 for A in As[1:])
    assert d8['deviceMesh'].devices.size == 8
    h1, h8 = d1['resHist'].toDict(), d8['resHist'].toDict()
    assert set(h1) == set(h8)
    for k in h1:
        a, b = np.asarray(h1[k]), np.asarray(h8[k])
        assert a.shape == b.shape, k
        assert np.allclose(a, b, rtol=1e-10, atol=1e-12), (k, a, b)
    # the JAX driver's serial line (tests/test_parallel_gmg.py holds its
    # --ranks 8 to it)
    jd = jParallelGMG(argv + ['--ranks', '1'])
    jits = jd.outputGroups['iterations'].toDict()
    assert d8['iterations'].toDict() == jits
    jh = jd.outputGroups['resHist'].toDict()
    for k in h8:
        # the last residuals sit at the rounding floor, where the two
        # packages' sums differ: 1e-10 of the first residual
        np.testing.assert_allclose(h8[k], jh[k], rtol=1e-6,
                                   atol=1e-10 * jh[k][0])


def test_dryrun_converges():
    out = dryrunDistributedH2(makeDeviceMesh(4, device='cpu'), noRef=8)
    assert out['err'] < 1e-10 and out['assemble_err'] < 1e-10
    assert out['cg_residual'] <= 1e-8
    assert out['dofs'] == 255 and out['assemble_dofs'] == 1023

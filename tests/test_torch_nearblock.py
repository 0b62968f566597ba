"""The H2 near field's block and host-enumeration engines of the port
against the JAX package.

The JAX side is pynucleus_tpu's getH2 with the device-CSR accumulator
(``params={'forceDeviceCSR': True}``), run on the CPU: with its default
engine (the block engine for orders up to 8, the flat engine on the pairs
that also hold higher orders) and with ``PYNUCLEUS_TPU_HOST_ENUM=1`` (the
host enumeration).  Its device programs are recorded with their inputs;
each kernel's plain version gets the same inputs (into zeroed data) and is
held to the program it replaces:

  K11  _block_mask_order + _block_near_count   counts equal
  K12  _block_near_quad (one order a call)     1e-12 of max|data|
  K13  _bucket_tree_csr_scan                   1e-12 of max|data|

(1e-12: the same float64 quadrature summed in another order.)  The port's
default near data equals the JAX default engine's entry by entry, and its
'host' data the JAX host engine's, to 1e-12 of max|data|; the pairs it
sends to the flat engine are JAX's; its three engines agree with the JAX
host-path H2 apply to 1e-10, the bar the JAX package sets between its own
engines (tests/test_devicecsr_nearfield.py::test_near_engines_agree).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.nl import getFractionalKernel as jKernel
from pynucleus_tpu.nl import assembly as jasm

from pynucleus_tpu_torch.interop import fromArrays
from pynucleus_tpu_torch.nl import assembly as tasm
from pynucleus_tpu_torch.nl.quad_singular import distantRule

TOL = 1e-12
MESHES = ('circle8', 'disc')


def _mesh(name):
    m = jfem.circle(n=8) if name == 'circle8' else \
        jfem.circle(h=0.78, radius=1.0)
    for _ in range(2):
        m = m.refine()
    return m


def _buildJax(m, env, record, names):
    """JAX getH2 (forceDeviceCSR) under the engine environment ``env``,
    with the inputs of its device programs ``names`` and the flat engine's
    pair selection of the block engine recorded into ``record``."""
    dm = jfem.P1_DoFMap(m)
    with pytest.MonkeyPatch.context() as mp:
        for k in ('PYNUCLEUS_TPU_BLOCK_NEAR', 'PYNUCLEUS_TPU_HOST_ENUM'):
            mp.delenv(k, raising=False)
        for k, v in env.items():
            mp.setenv(k, v)
        launch = jasm._launch

        def rec(fn, *args, _statics=None, _force=False, **kw):
            name = getattr(fn, '__name__', '')
            if name in names:
                record.setdefault(name, []).append(
                    ([a if isinstance(a, (int, float)) else np.asarray(a)
                      for a in args], dict(_statics or {})))
            return launch(fn, *args, _statics=_statics, _force=_force, **kw)
        blocks = jasm.nonlocalBuilder._runNearBlocks

        def recBlocks(self, acc, runner, IJ, *a):
            highSel = blocks(self, acc, runner, IJ, *a)
            record['highSel'] = (np.array(IJ), np.array(highSel))
            return highSel
        mp.setattr(jasm, '_launch', rec)
        mp.setattr(jasm.nonlocalBuilder, '_runNearBlocks', recBlocks)
        H = jasm.nonlocalBuilder(dm, jKernel(2, 0.75),
                                 params={'forceDeviceCSR': True}).getH2()
    return dm, H


@pytest.fixture(scope='module', params=MESHES)
def jax(request):
    """Per mesh: the JAX default and host-engine builds with their
    recorded calls, and the port's dofmap and kernel."""
    m = _mesh(request.param)
    block, host = {}, {}
    dm, H = _buildJax(m, {}, block, ('_block_near_count', '_block_near_quad'))
    _, Hh = _buildJax(m, {'PYNUCLEUS_TPU_HOST_ENUM': '1'}, host,
                      ('_bucket_tree_csr_scan',))
    for rec, name in ((block, '_block_near_count'),
                      (block, '_block_near_quad'),
                      (host, '_bucket_tree_csr_scan')):
        assert rec.get(name), name
    _, tdm, tk = fromArrays(m.vertices, m.cells, 0.75, 2, device='cpu')
    return dict(m=m, dm=dm, H=H, Hhost=Hh, block=block, host=host, tdm=tdm,
                tk=tk)


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _i32(a):
    return _t(a, torch.int32)


def _assertData(got, ref):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(np.asarray(got) - ref).max() <= TOL * scale


def _cellNodes(dofs, dofNode):
    return np.where(dofs >= 0, dofNode[np.where(dofs >= 0, dofs, 0)], -1)


def test_block_near_count_vs_jax(jax):
    tot = np.zeros(tasm.N_CLASSES, dtype=np.int64)
    for args, statics in jax['block']['_block_near_count']:
        (offI, offJ, n1, n2, I, J, cells, dofs, dofNode, ncArr, centers, logh,
         cA, cB, cC) = args
        ref = np.asarray(jasm._block_near_count(*args, **statics))
        ref = ref.reshape(-1, tasm.N_CLASSES)
        got = tasm.block_near_count(
            *(_i32(a.reshape(-1)) for a in (offI, offJ, n1, n2, I, J)),
            _i32(ncArr), _i32(cells), _i32(_cellNodes(dofs, dofNode)),
            _t(centers, torch.float32), _t(logh, torch.float32),
            (cA, cB, cC))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
        tot += ref.sum(axis=0)
    # two low-order classes at least, and the remainder class
    assert (tot[:4] > 0).sum() >= 2 and tot[4] > 0


def _blockArgs(args, jax):
    """The port's pairs, tables and rule of one recorded _block_near_quad
    call (its padding pairs, I = -1, left out)."""
    (data, vertices, cells, vols, dofs, treePos, dofNode, ncArr, centers,
     logh, offI, offJ, n1, n2, I, J, tSI, tSJ, baseF, baseB, LI, LJ, cA, cB,
     cC, *_) = args
    real = I.reshape(-1) >= 0
    tLen = np.bincount(dofNode[dofNode >= 0])
    Ir, Jr = I.reshape(-1)[real], J.reshape(-1)[real]
    pairs = tuple(_i32(a.reshape(-1)[real]) for a in (
        offI, offJ, n1, n2, I, J, tSI, tSJ, baseF, baseB, LI, LJ)) \
        + (_i32(tLen[Ir]), _i32(tLen[Jr]))
    tabs = (_i32(ncArr), _i32(cells), _i32(_cellNodes(dofs, dofNode)),
            _t(centers, torch.float32), _t(logh, torch.float32),
            (cA, cB, cC), _t(vertices), _t(vols), _t(dofs, torch.int64),
            _i32(treePos))
    return data.shape[0], pairs, tabs


def _rules(orders, tdm):
    out = {}
    for o in orders:
        rule = distantRule(o, 2)
        PSI = rule.buildPSI(tdm, nSharedVertices=0)
        out[o] = (_t(rule.bary_x), _t(rule.bary_y), _t(rule.w),
                  _t(tasm._psi_prod(PSI)))
    return out


def test_block_near_quad_vs_jax(jax):
    prof = jax['tk'].profileParams()
    orders = set()
    for args, statics in jax['block']['_block_near_quad']:
        ref = np.asarray(jasm._block_near_quad(
            jnp.zeros_like(args[0]), *args[1:], **statics))
        n, pairs, tabs = _blockArgs(args, jax)
        o = statics['order']
        orders.add(o)
        got = torch.zeros(n, dtype=torch.float64)
        tasm.block_near_quad(got, pairs, *tabs, _rules([o], jax['tdm']),
                             prof)
        _assertData(got.numpy()[:-1], ref[:-1])
    assert len(orders) >= 2


def test_block_near_quad_orders_in_one_call(jax):
    """All orders of a recorded pair set in one call, as the build makes
    it, equal the per-order calls."""
    prof = jax['tk'].profileParams()
    args, _ = max(jax['block']['_block_near_quad'],
                  key=lambda c: int((c[0][14] >= 0).sum()))
    n, pairs, tabs = _blockArgs(args, jax)
    one = torch.zeros(n, dtype=torch.float64)
    tasm.block_near_quad(one, pairs, *tabs, _rules(tasm.BLOCK_ORDERS,
                                                   jax['tdm']), prof)
    each = torch.zeros(n, dtype=torch.float64)
    for o in tasm.BLOCK_ORDERS:
        tasm.block_near_quad(each, pairs, *tabs, _rules([o], jax['tdm']),
                             prof)
    _assertData(one.numpy()[:-1], each.numpy()[:-1])


def test_tree_csr_scan_vs_tree_csr_quad(jax):
    prof = jax['tk'].profileParams()
    calls = jax['host']['_bucket_tree_csr_scan']
    for args, statics in calls:
        (data, vertices, cells, vols, dofs, treePos, dofNode, indptrT,
         tStart, c1, c2, I, J, offF, offB, sf, bx, by, w, PSIP) = args
        ref = np.asarray(jasm._bucket_tree_csr_scan(
            jnp.zeros_like(data), *args[1:], **statics))
        real = sf.reshape(-1) != 0
        got = torch.zeros(data.shape[0], dtype=torch.float64)
        tasm.tree_csr_quad(
            got, *(_i32(a.reshape(-1)[real]) for a in (c1, c2, I, J, offF,
                                                        offB)),
            _t(sf.reshape(-1)[real]), _t(vertices), _t(cells, torch.int64),
            _t(vols), _t(dofs, torch.int64),
            tuple(_i32(a) for a in (dofNode, treePos, indptrT, tStart)),
            _t(bx), _t(by), _t(w), _t(PSIP), prof)
        _assertData(got.numpy()[:-1], ref[:-1])
    assert len(calls) >= 2


def _portBuild(jax, engine, record=None):
    """The port's getH2 with ``engine``; with ``record`` (a dict) the
    block engine's pairs and remainder mask are recorded."""
    b = tasm.nonlocalBuilder(jax['tdm'], jax['tk'],
                             params={'nearEngine': engine})
    if record is None:
        return b.getH2()
    orig = tasm.nonlocalBuilder._runNearBlocks

    def rec(self, acc, nf, enum):
        highSel = orig(self, acc, nf, enum)
        record['highSel'] = (nf.IJ, highSel)
        return highSel
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tasm.nonlocalBuilder, '_runNearBlocks', rec)
        return b.getH2()


@pytest.fixture(scope='module')
def port(jax):
    rec = {}
    return dict(block=_portBuild(jax, 'block', rec), rec=rec,
                host=_portBuild(jax, 'host'))


def test_default_near_data_matches_jax_block_engine(jax, port):
    Ht, H = port['block'], jax['H']
    np.testing.assert_array_equal(Ht.Anear.meta.indptrT,
                                  H.Anear.meta.indptrT)
    np.testing.assert_array_equal(Ht.Anear.meta.perm, H.Anear.meta.perm)
    _assertData(Ht.Anear.dataT.numpy(), H.Anear.dataZ[:-1])


def test_host_near_data_matches_jax_host_engine(jax, port):
    _assertData(port['host'].Anear.dataT.numpy(),
                jax['Hhost'].Anear.dataZ[:-1])


def test_flat_engine_pairs_match_jax_highSel(jax, port):
    IJj, selJ = jax['block']['highSel']
    IJt, selT = port['rec']['highSel']
    np.testing.assert_array_equal(IJt, IJj)
    np.testing.assert_array_equal(selT, selJ)
    assert 0 < selT.sum() < len(selT)


@pytest.mark.parametrize('engine', tasm.NEAR_ENGINES)
def test_near_engines_agree(jax, engine):
    """Mirrors the JAX package's test_near_engines_agree: each engine's
    H2 apply against the JAX host-path H2 to 1e-10."""
    Ht = _portBuild(jax, engine)
    Hhost = jasm.nonlocalBuilder(jax['dm'], jKernel(2, 0.75)).getH2()
    x = np.random.default_rng(0).normal(size=jax['dm'].num_dofs)
    ref = np.asarray(Hhost.matvec(jnp.asarray(x)))
    got = Ht.matvec(torch.as_tensor(x)).numpy()
    assert np.linalg.norm(got - ref) <= 1e-10 * np.linalg.norm(ref)


def test_unknown_near_engine_raises(jax):
    with pytest.raises(ValueError, match='nearEngine'):
        tasm.nonlocalBuilder(jax['tdm'], jax['tk'],
                             params={'nearEngine': 'native'})


def test_block_near_quad_validates_inputs(jax):
    z = torch.zeros(3, dtype=torch.int32)
    f32 = torch.zeros((2, 1), dtype=torch.float32)
    args = (torch.zeros(4, dtype=torch.float64), (z,) * 14, z,
            torch.zeros((1, 3), dtype=torch.int32),
            torch.zeros((1, 3), dtype=torch.int32), f32,
            torch.zeros(1, dtype=torch.float32), (0.75, 1.0, 0.0),
            torch.zeros((3, 2), dtype=torch.float64),
            torch.zeros(1, dtype=torch.float64),
            torch.zeros((1, 3), dtype=torch.int64), z)
    with pytest.raises(ValueError, match='orders'):
        tasm.block_near_quad(*args, _rules([16], jax['tdm']),
                             jax['tk'].profileParams())
    with pytest.raises(ValueError, match='14'):
        tasm.block_near_quad(args[0], (z,) * 12, *args[2:], {},
                             jax['tk'].profileParams())


def test_driver_passes_params_to_every_level(monkeypatch):
    from pynucleus_tpu_torch.drivers.runFractional import main
    engines = []
    init = tasm.nonlocalBuilder.__init__

    def rec(self, *a, **kw):
        init(self, *a, **kw)
        engines.append(self.nearEngine)
    monkeypatch.setattr(tasm.nonlocalBuilder, '__init__', rec)
    out = main(['--domain', 'disc', '--noRef', '2', '--matrixFormat', 'H2',
                '--solverType', 'cg-mg', '--device', 'cpu'], quiet=True,
               params={'nearEngine': 'host'})
    assert engines == ['host'] * 3
    assert out['results'].toDict()['iterations'] > 0

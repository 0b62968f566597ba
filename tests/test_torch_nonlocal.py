"""The port's finite-horizon path (runNonlocal) against the JAX package.

Same meshes (the JAX package's, handed over as arrays, or built by both
packages and checked equal), same kernels; on the CPU the port's kernel
wrappers run their plain versions:

  K14 cut1d          _bucket_cut1d on every cut pair of the interval at
                     noRef 3 (constant, inverseDistance, fractional s = 0.4
                     kernels): 1e-13 of max|M|
  K15 cut2d_polar    _bucket_cut2d_polar on the square's noRef 0 cut pairs
                     (ball2, ballInf): 1e-13 of max|M| (the JAX program's
                     TPU clamp of the barycentrics moves M at roundoff)
  getDense           the JAX getDense: interval noRef 4 (three kernels),
                     square noRef 0 (constant; ball2 and ballInf): 1e-12
                     of max|A|
  getSparse          the JAX getSparse (square noRef 1): same pattern, data
                     to 1e-12 of max|data|
  getDenseCross      the JAX A_BC: 1e-12 of max|A_BC|
  the driver         the interval patch tests of tests/test_nonlocal_driver.py
                     to their bounds; the square at noRef 1 (sparse, cg-mg)
                     against the JAX driver's pinned outputs
"""
import numpy as np
import pytest
import torch

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.fem.quadrature import gauss01 as jGauss01, \
    simplexDuffy as jDuffy
from pynucleus_tpu.nl.assembly import (nonlocalBuilder as jBuilder,
                                       _bucket_cut1d, _bucket_cut2d_polar)
from pynucleus_tpu.nl.kernels import (getIntegrableKernel as jIntegrable,
                                      getFractionalKernel as jFractional,
                                      ball2 as jBall2, ballInf as jBallInf)
from pynucleus_tpu.nl.panels import classifyPairsDense as jClassify
from pynucleus_tpu.nl.problems import nonlocalMeshFactory, DIRICHLET

from pynucleus_tpu_torch.interop import fromArrays
from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
from pynucleus_tpu_torch.fem.meshes import uniformSquare
from pynucleus_tpu_torch.fem.quadrature import gauss01, simplexDuffy
from pynucleus_tpu_torch.nl.assembly import (
    nonlocalBuilder as tBuilder, _cut1dMatrices, _cut2dMatrices,
    assembleNonlocal)
from pynucleus_tpu_torch.nl.panels import classifyPairsDense
from pynucleus_tpu_torch.nl.problems import nonlocalPoissonProblem
from pynucleus_tpu_torch.drivers.runNonlocal import main as tMain

HORIZON = 0.2
KERNELS = ('constant', 'inverseDistance', 'fractional')


def jaxKernel(dim, kernelType, interaction='ball2'):
    inter = {'ball2': jBall2, 'ballInf': jBallInf}[interaction]()
    if kernelType == 'fractional':
        return jFractional(dim, 0.4, horizon=HORIZON, interaction=inter)
    return jIntegrable(dim, {'constant': 'indicator',
                             'inverseDistance': 'peridynamic'}[kernelType],
                       HORIZON, interaction=inter)


def jaxProblem(domain, noRef, kernelType='constant', interaction='ball2'):
    """The JAX package's (mesh, dofmap, kernel) of runNonlocal's
    poly-Dirichlet problem at noRef, and the port's on the same arrays."""
    dim = {'interval': 1, 'square': 2}[domain]
    k = jaxKernel(dim, kernelType, interaction)
    mesh, info = nonlocalMeshFactory.build(domain, kernel=k,
                                           boundaryCondition=DIRICHLET)
    for _ in range(noRef):
        mesh = mesh.refine()
    dm = jfem.P1_DoFMap(mesh, tag=info['domain'])
    interior = np.zeros(mesh.num_vertices, dtype=bool)
    c, loc = np.nonzero(dm.dofs >= 0)
    interior[mesh.cells[c, loc]] = True
    _, tdm, tk = fromArrays(mesh.vertices, mesh.cells, 0.4, dim,
                            device='cpu', kernelType=kernelType,
                            horizon=HORIZON, interaction=interaction,
                            interior=interior)
    return mesh, dm, k, tdm, tk


def t(a, dtype=torch.float64):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


@pytest.mark.parametrize('domain,noRef', [('interval', 3), ('square', 1)])
def test_meshes_dofmaps_classification_match_jax(domain, noRef):
    """The port's collar mesh, dofmap and horizon classification equal the
    JAX package's (the pair partition decides where each pair goes)."""
    mesh, dm, k, tdm, tk = jaxProblem(domain, noRef)
    prob = nonlocalPoissonProblem(domain)
    tmesh = prob['mesh']
    for _ in range(noRef):
        tmesh = tmesh.refine()
    np.testing.assert_array_equal(tmesh.vertices, mesh.vertices)
    np.testing.assert_array_equal(tmesh.cells, mesh.cells)
    if domain == 'square':
        ju, tu = jfem.uniformSquare(5, 4, -1, -1, 1, 1), \
            uniformSquare(5, 4, -1, -1, 1, 1)
        np.testing.assert_array_equal(tu.vertices, ju.vertices)
        np.testing.assert_array_equal(tu.cells, ju.cells)
    np.testing.assert_array_equal(
        P1_DoFMap(tmesh, prob['tag'], device='cpu').dofs, dm.dofs)
    np.testing.assert_array_equal(tdm.dofs, dm.dofs)
    assert repr(prob['kernel']) == repr(k)
    ij, it = jClassify(dm, k), classifyPairsDense(tdm, tk)
    np.testing.assert_array_equal(it['id'], ij['id'])
    np.testing.assert_array_equal(it['touching'][0], ij['touching'][0])
    for key in ('distant', 'cut'):
        for a, b in zip(it[key], ij[key]):
            np.testing.assert_array_equal(a, b)
    assert len(it['cut'][0]) > 0


@pytest.mark.parametrize('kernelType', KERNELS)
def test_cut1d_matches_jax(kernelType):
    """K14's plain version against _bucket_cut1d on every cut pair of the
    interval at noRef 3 (both orderings, as _runCutPairs passes them)."""
    mesh, dm, k, tdm, tk = jaxProblem('interval', 3, kernelType)
    ci, cj, orders = jClassify(dm, k)['cut']
    prof = tk.profileParams()
    vols = mesh.simplexVolumes()
    total = 0
    for order in np.unique(orders):
        sel = orders == order
        iiA = np.concatenate([ci[sel], cj[sel]])
        jjA = np.concatenate([cj[sel], ci[sel]])
        tq, wq = jGauss01(int(order))
        Mj = np.asarray(_bucket_cut1d(
            mesh.vertices, mesh.cells[iiA], mesh.cells[jjA], vols[iiA], tq,
            wq, tq, wq, dm.evalPhi.monomialExps, dm.evalPhi.Vinv, HORIZON,
            kernel=k, dpe=2))
        tq2, wq2 = gauss01(int(order))
        Mt = _cut1dMatrices(t(mesh.vertices), t(mesh.cells[iiA], torch.int64),
                            t(mesh.cells[jjA], torch.int64), t(vols[iiA]),
                            t(tq2), t(wq2), t(tq2), t(wq2), HORIZON,
                            prof).numpy()
        assert np.abs(Mt - Mj).max() <= 1e-13 * np.abs(Mj).max()
        total += len(iiA)
    assert total > 0


@pytest.mark.parametrize('interaction', ['ball2', 'ballInf'])
def test_cut2d_polar_matches_jax(interaction):
    """K15's plain version against _bucket_cut2d_polar on the square's
    noRef 0 cut pairs, order by order with the rules of _runCutPairs."""
    mesh, dm, k, tdm, tk = jaxProblem('square', 0, 'constant', interaction)
    ci, cj, orders = jClassify(dm, k)['cut']
    prof = tk.profileParams()
    vols = mesh.simplexVolumes()
    for order in np.unique(orders):
        sel = orders == order
        ii, jj = ci[sel], cj[sel]
        oX = max(int(order) // 2, 4)
        rules = [jDuffy(oX, 2), jGauss01(max(int(order) // 2 + 2, 6)),
                 jGauss01(max(int(order) // 2, 4))]
        (bx, wx), (th, wth), (rq, wr) = rules
        Mj = np.asarray(_bucket_cut2d_polar(
            mesh.vertices, mesh.cells[ii], mesh.cells[jj], vols[ii],
            bx.T.copy(), wx, th, wth, rq, wr, dm.evalPhi.monomialExps,
            dm.evalPhi.Vinv, HORIZON, kernel=k, dpe=3))
        tbx, twx = simplexDuffy(oX, 2)
        np.testing.assert_array_equal(tbx, bx)
        Mt = _cut2dMatrices(t(mesh.vertices), t(mesh.cells[ii], torch.int64),
                            t(mesh.cells[jj], torch.int64), t(vols[ii]),
                            t(tbx.T), t(twx), t(th), t(wth), t(rq), t(wr),
                            HORIZON, tk.interaction.code, prof).numpy()
        assert np.abs(Mt - Mj).max() <= 1e-13 * np.abs(Mj).max(), order


@pytest.mark.parametrize('domain,noRef,kernelType,interaction', [
    ('interval', 4, 'constant', 'ball2'),
    ('interval', 4, 'inverseDistance', 'ball2'),
    ('interval', 4, 'fractional', 'ball2'),
    ('square', 0, 'constant', 'ball2'), ('square', 0, 'constant', 'ballInf')])
def test_getDense_matches_jax(domain, noRef, kernelType, interaction):
    mesh, dm, k, tdm, tk = jaxProblem(domain, noRef, kernelType, interaction)
    Aj = np.asarray(jBuilder(dm, k).getDense().toarray())
    At = tBuilder(tdm, tk).getDense().toarray()
    assert np.abs(At - Aj).max() <= 1e-12 * np.abs(Aj).max()
    assert np.abs(At - At.T).max() <= 1e-12 * np.abs(At).max()


def test_getSparse_matches_jax():
    mesh, dm, k, tdm, tk = jaxProblem('square', 1)
    Sj = jBuilder(dm, k).getSparse()
    St = assembleNonlocal(tdm, tk, matrixFormat='sparse', device='cpu')
    np.testing.assert_array_equal(St.indptrH, np.asarray(Sj.indptr))
    np.testing.assert_array_equal(St.indicesH, np.asarray(Sj.indices))
    dj = np.asarray(Sj.data)
    assert np.abs(St.dataH - dj).max() <= 1e-12 * np.abs(dj).max()
    # H2 delegates to the sparse format for a finite horizon
    Ht = assembleNonlocal(tdm, tk, matrixFormat='H2', device='cpu')
    np.testing.assert_array_equal(Ht.dataH, St.dataH)


@pytest.mark.parametrize('domain,noRef', [('interval', 4), ('square', 0)])
def test_getDenseCross_matches_jax(domain, noRef):
    mesh, dm, k, tdm, tk = jaxProblem(domain, noRef)
    dmBC = dm.getComplementDoFMap()
    Bj = np.asarray(jBuilder(dm, k, zeroExterior=False,
                             dm2=dmBC).getDenseCross().toarray())
    Bt = tBuilder(tdm, tk).getDenseCross().toarray()
    assert Bt.shape == Bj.shape == (dm.num_dofs, dm.num_boundary_dofs)
    assert np.abs(Bt - Bj).max() <= 1e-12 * np.abs(Bj).max()


# tests/test_nonlocal_driver.py INTERVAL_CONFIGS: the patch test reaches
# machine precision (fractional: 1e-8)
INTERVAL_CONFIGS = [
    (['--kernelType', 'constant', '--matrixFormat', 'dense'], 1e-12),
    (['--kernelType', 'constant', '--matrixFormat', 'H2'], 1e-12),
    (['--kernelType', 'constant', '--matrixFormat', 'sparse'], 1e-12),
    (['--kernelType', 'inverseDistance', '--matrixFormat', 'dense'], 1e-12),
    (['--kernelType', 'fractional', '--matrixFormat', 'dense'], 1e-8),
]


@pytest.mark.parametrize('argv,bound', INTERVAL_CONFIGS,
                         ids=['const-dense', 'const-H2', 'const-sparse',
                              'invDist-dense', 'frac-dense'])
def test_interval_patch(argv, bound):
    out = tMain(['--domain', 'interval', '--problem', 'poly-Dirichlet',
                 '--element', 'P1', '--solverType', 'lu', '--noRef', '6',
                 '--device', 'cpu'] + argv, quiet=True)
    errs = out['errors'].toDict()
    assert out['results'].toDict()['dofs'] == 639
    assert errs['L2 error interpolated'] < bound, errs


# JAX driver outputs of `drivers/runNonlocal.py --domain square --kernelType
# constant --problem poly-Dirichlet --element P1 --solverType cg-mg
# --matrixFormat sparse --noRef 1`, run on the CPU in float64 (the same in
# dense, sparse and H2)
JAX_SQUARE_NOREF1 = {'dofs': 361, 'iterations': 7,
                     'L2 error interpolated': 1.3192519e-02}


def test_square_sparse_cgmg_matches_jax_driver(capsys):
    out = tMain(['--domain', 'square', '--kernelType', 'constant',
                 '--problem', 'poly-Dirichlet', '--element', 'P1',
                 '--solverType', 'cg-mg', '--matrixFormat', 'sparse',
                 '--noRef', '1', '--device', 'cpu'])
    res = out['results'].toDict()
    errs = out['errors'].toDict()
    assert res['dofs'] == JAX_SQUARE_NOREF1['dofs']
    assert res['iterations'] == JAX_SQUARE_NOREF1['iterations']
    ref = JAX_SQUARE_NOREF1['L2 error interpolated']
    assert abs(errs['L2 error interpolated'] - ref) <= 1e-6 * ref
    assert set(errs) == {'L2 error interpolated',
                         'relative interpolated L2 error',
                         'Linf error interpolated',
                         'relative interpolated Linf error'}
    # every level sparse, and the collar's A_BC built
    assert all(type(lv['A']).__name__ == 'CSR_LinearOperator'
               for lv in out['hierarchy'])
    assert out['A_BC'].num_columns == out['dm'].num_boundary_dofs
    text = capsys.readouterr().out
    for label in ('results:', 'errors:', 'timers:',
                  'assembly level 1 quadrature seconds:'):
        assert label in text

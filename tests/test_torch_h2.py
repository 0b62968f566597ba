"""The port's H2 operator against the JAX package.

  planH2         tree (dofs, boxes, levels), admissible pairs, transfer
                 matrices, leaf integrals, far grids: equal, floats to
                 1e-14 (the same numpy code)
  K7 far_field   _farFieldBlocks on the plan's grids: 1e-14 relative (one
                 pow per entry)
  K8 h2_matvec   _h2_matvec on an operator carried over from a JAX getH2
                 (interop.h2FromArrays): 1e-12 relative (the same sums in
                 another order)
  the slice      H2 against the port's dense operator: 1e-5 relative, the
                 bar of tests/test_devicecsr_nearfield.py (Chebyshev far
                 field); CG-Jacobi on both takes the same iterations (+-1);
                 the H2 driver against the JAX H2 driver: errors to rtol
                 3e-2 and iterations within +-1, as for the dense driver
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.nl import getFractionalKernel as jKernel
from pynucleus_tpu.nl import assembly as jasm
from pynucleus_tpu.nl import h2 as jh2

from pynucleus_tpu_torch.interop import fromArrays, h2FromArrays
from pynucleus_tpu_torch.nl import assembly as tasm
from pynucleus_tpu_torch.nl import h2 as th2
from pynucleus_tpu_torch.base.solvers import solverFactory
from pynucleus_tpu_torch.drivers.runFractional import main as tMain


def _mesh(name, noRef):
    m = jfem.circle(n=8) if name == 'circle8' else \
        jfem.circle(h=0.78, radius=1.0)
    for _ in range(noRef):
        m = m.refine()
    return m


@pytest.fixture(scope='module', params=[('disc', 3), ('circle8', 3)],
                ids=['disc-noRef3', 'circle8-noRef3'])
def plans(request):
    m = _mesh(*request.param)
    dm = jfem.P1_DoFMap(m)
    pj = jasm.nonlocalBuilder(dm, jKernel(2, 0.75)).planH2()
    _, tdm, tk = fromArrays(m.vertices, m.cells, 0.75, 2, device='cpu')
    pt = tasm.nonlocalBuilder(tdm, tk).planH2()
    return pj, pt, tk


def test_plan_matches_jax(plans):
    pj, pt, _ = plans
    assert (pt['m'], pt['M'], pt['nLvl'], pt['sizes']) == \
        (pj['m'], pj['M'], pj['nLvl'], pj['sizes'])
    assert len(pt['nodes']) == len(pj['nodes'])
    for a, b in zip(pt['nodes'], pj['nodes']):
        assert (a.id, a.level, a.parent, a.children) == \
            (b.id, b.level, b.parent, b.children)
        np.testing.assert_array_equal(a.dofs, b.dofs)
        np.testing.assert_array_equal(a.box, b.box)
    assert pt['Pfar'] == pj['Pfar'] and pt['Pnear'] == pj['Pnear']
    assert pt['farOffs'] == pj['farOffs'] and pt['farOffs']
    for ell in range(1, pj['nLvl']):
        np.testing.assert_allclose(pt['Thost'][ell], pj['Thost'][ell],
                                   rtol=0, atol=1e-14)
        np.testing.assert_array_equal(pt['parentIdxH'][ell],
                                      pj['parentIdxH'][ell])
    for ell, (s, d) in pj['farSrcDst'].items():
        np.testing.assert_array_equal(pt['farSrcDst'][ell][0], s)
        np.testing.assert_array_equal(pt['farSrcDst'][ell][1], d)
    P = pt['farGi'].shape[0]
    np.testing.assert_allclose(pt['farGi'], pj['farGi'][:P], rtol=0,
                               atol=1e-14)
    np.testing.assert_allclose(pt['farGj'], pj['farGj'][:P], rtol=0,
                               atol=1e-14)
    for key in ('leafDofs', 'lvlIdx', 'posIdx'):
        np.testing.assert_array_equal(pt[key], pj[key])
    np.testing.assert_allclose(pt['leafPhi'], pj['leafPhi'], rtol=0,
                               atol=1e-14 * np.abs(pj['leafPhi']).max())


def test_far_field_plain_matches_jax(plans):
    pj, pt, tk = plans
    K = np.asarray(jasm._farFieldBlocks(jnp.asarray(pj['farGi']),
                                        jnp.asarray(pj['farGj']),
                                        kernel=jKernel(2, 0.75)))
    C, e = tk.radialParams()
    got = tasm.far_field(torch.as_tensor(pt['farGi']),
                         torch.as_tensor(pt['farGj']), C, e).numpy()
    P = got.shape[0]
    np.testing.assert_allclose(got, K[:P], rtol=1e-14, atol=0)


def _carry(H, device='cpu'):
    """The port's H2Matrix from the arrays of a JAX H2Matrix."""
    A, mt = H.Anear, H.Anear.meta

    def arr(v):
        return None if v is None else np.asarray(v)
    levels = [dict(size=lv.size, T=arr(lv.T), parentIdx=arr(lv.parentIdx),
                   K=arr(lv.K), src=arr(lv.src), dst=arr(lv.dst))
              for lv in H.levels]
    return h2FromArrays(np.asarray(A.dataZ[:-1]), mt.indptrT, mt.tmplAll,
                        mt.tmplStart, mt.tStartRow, mt.tLen, mt.rowLen,
                        mt.perm, mt.N, np.asarray(H.leafDofs),
                        np.asarray(H.leafPhi), *H.leafLevelPos, levels,
                        device=device)


@pytest.fixture(scope='module')
def jaxH2():
    m = _mesh('disc', 3)
    dm = jfem.P1_DoFMap(m)
    H = jasm.nonlocalBuilder(dm, jKernel(2, 0.75)).getH2()
    assert H.fusedTree and any(lv.K is not None for lv in H.levels)
    return m, dm, H


def test_h2_matvec_plain_matches_jax(jaxH2):
    m, dm, H = jaxH2
    op = _carry(H)
    rng = np.random.default_rng(0)
    for _ in range(2):
        x = rng.normal(size=dm.num_dofs)
        ref = np.asarray(jh2._h2_matvec(H, jnp.asarray(x)))
        out = torch.empty(dm.num_dofs, dtype=torch.float64)
        got = op.matvec(torch.as_tensor(x), out=out)
        assert got is out
        assert np.linalg.norm(got.numpy() - ref) <= \
            1e-12 * np.linalg.norm(ref)
    np.testing.assert_allclose(op.diagonal.numpy(), np.asarray(H.diagonal),
                               rtol=1e-14, atol=0)


def test_h2matrix_requires_fused_layout(jaxH2):
    m, dm, H = jaxH2
    A, mt = H.Anear, H.Anear.meta
    leafDofs = np.asarray(H.leafDofs).copy()
    leafDofs[[0, 1]] = leafDofs[[1, 0]]
    near = th2.TreeNearOperator(
        torch.as_tensor(np.asarray(A.dataZ)).clone(),
        th2.TreeNearMeta(mt.indptrT, mt.tmplAll, mt.tmplStart, mt.tStartRow,
                         mt.tLen, mt.rowLen, mt.perm, mt.N))
    with pytest.raises(ValueError, match='leaf layout'):
        th2.H2Matrix(near, torch.as_tensor(np.asarray(H.leafPhi)),
                     H.leafLevelPos, [dict(size=lv.size) for lv in H.levels],
                     torch.zeros((0, 16, 16), dtype=torch.float64), mt.N,
                     leafDofs)


@pytest.fixture(scope='module')
def portOps():
    m = _mesh('circle8', 3)
    _, tdm, tk = fromArrays(m.vertices, m.cells, 0.75, 2, device='cpu')
    H = tasm.nonlocalBuilder(tdm, tk).getH2()
    D = tasm.nonlocalBuilder(tdm, tk).getDense()
    return tdm, H, D


def test_h2_matches_dense(portOps):
    tdm, H, D = portOps
    x = torch.as_tensor(np.random.default_rng(0).normal(size=tdm.num_dofs))
    ref = D.matvec(x)
    assert float(torch.linalg.norm(H.matvec(x) - ref)
                 / torch.linalg.norm(ref)) < 1e-5
    assert float((H.diagonal - D.diagonal).abs().max()
                 / D.diagonal.abs().max()) < 1e-5


def test_cg_jacobi_h2_and_dense_iterations():
    """CG-Jacobi on the H2 and dense operators of the driver's disc at
    noRef 3 takes the same iterations (+-1) at the driver's tolerance 1e-6
    (much below it the residual meets the far field's 1e-5-level
    approximation and the counts part)."""
    from pynucleus_tpu_torch.nl.problems import fractionalLaplacianProblem
    from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    prob = fractionalLaplacianProblem('disc', 'const(0.75)')
    mesh = prob['mesh']
    for _ in range(3):
        mesh = mesh.refine()
    dm = P1_DoFMap(mesh, prob['tag'], device='cpu')
    b = assembleRHS(dm, prob['rhs'], qOrder=3).data
    its, sols = [], []
    for fmt in ('dense', 'H2'):
        A = tasm.assembleNonlocal(dm, prob['kernel'], matrixFormat=fmt)
        s = solverFactory.build('cg-jacobi', A=A, setup=True)
        s.tolerance, s.maxIter = 1e-6, 100
        sols.append(s.solve(b))
        its.append(s.iterations)
        assert s.residuals[-1] <= s.tolerance
    assert abs(its[0] - its[1]) <= 1
    assert float(torch.linalg.norm(sols[0] - sols[1])
                 / torch.linalg.norm(sols[0])) < 1e-3


@pytest.mark.parametrize('noRef', [2, 3])
def test_h2_driver_matches_jax_driver(noRef):
    from drivers.runFractional import main as jMain
    flags = ['--domain', 'disc', '--s', 'const(0.75)', '--problem',
             'constant', '--element', 'P1', '--solverType', 'cg-jacobi',
             '--matrixFormat', 'H2', '--noRef', str(noRef)]
    d, _ = jMain(flags)
    out = tMain(flags + ['--device', 'cpu'], quiet=True)
    ej = d.outputGroups['errors'].toDict()
    et = out['errors'].toDict()
    assert set(et) == set(ej)
    for label, val in ej.items():
        assert np.isclose(et[label], val, rtol=3e-2, atol=1e-8), \
            (label, et[label], val)
    rj = d.outputGroups['results'].toDict()
    rt = out['results'].toDict()
    assert rt['dofs'] == rj['dofs']
    assert abs(rt['iterations'] - rj['iterations']) <= 1
    tim = out['timers'].toDict()
    for part in ('plan', 'singular', 'enumeration', 'surfaces', 'far field',
                 'near operator set-up'):
        assert tim[f'assembly {part} seconds'] >= 0.0


def test_h2_interval_raises():
    with pytest.raises(NotImplementedError):
        tMain(['--domain', 'interval', '--matrixFormat', 'H2', '--noRef',
               '3', '--device', 'cpu'], quiet=True)

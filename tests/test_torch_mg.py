"""The port's multigrid against the JAX package, on the CPU in float64.

  buildProlongation  the JAX package's on the same meshes: indptr, indices
                     and data equal (the same numpy/scipy code)
  K9 csr_spmv        P x, P^T x and x += P xc against the JAX
                     CSR_LinearOperator's matvec/rmatvec: 1e-14 relative
                     (the same sums, in another order)
  K10 jacobi_smooth  the three modes against the JAX expressions of
                     _vcycle: 1e-15 relative
  _mg_apply          one V-cycle on a hierarchy carried over from the JAX
                     package (its H2 levels through interop.h2FromArrays,
                     its P through interop.csrFromArrays): 1e-12 relative
  K4, general form   10 CG-MG steps against _cg_core(use_prec=True) with
                     the JAX mgPreconditioner: residual history to 1e-10
                     relative
  the driver         cg-mg and mg against the JAX driver: errors within
                     rtol 3e-2 (the repo's regression tolerance; the JAX
                     driver takes its host near-field engine and per-pair
                     dense path), iterations equal
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.nl import getFractionalKernel as jKernel
from pynucleus_tpu.nl import assembly as jasm
from pynucleus_tpu.multilevel import gmg as jgmg
from pynucleus_tpu.base.solvers import _cg_core

from pynucleus_tpu_torch.interop import csrFromArrays
from pynucleus_tpu_torch.fem.meshes import simplexMesh
from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
from pynucleus_tpu_torch.base.linear_operators import Dense_LinearOperator
from pynucleus_tpu_torch.base.solvers import solverFactory
from pynucleus_tpu_torch.multilevel import gmg as tgmg
from pynucleus_tpu_torch.drivers.runFractional import main as tMain

from test_torch_h2 import _carry


def _jaxMeshes(domain, noRef):
    m = jfem.circle(h=0.78, radius=1.0) if domain == 'disc' else \
        jfem.simpleInterval(-1.0, 1.0).refine()
    meshes = [m]
    for _ in range(noRef):
        meshes.append(meshes[-1].refine())
    return meshes


def _portDM(mj):
    return P1_DoFMap(simplexMesh(mj.vertices, mj.cells, dim=mj.dim),
                     device='cpu')


@pytest.mark.parametrize('domain,lvl', [('disc', 1), ('disc', 2),
                                        ('disc', 3), ('interval', 3)])
def test_prolongation_matches_jax(domain, lvl):
    mC, mF = _jaxMeshes(domain, lvl)[-2:]
    Pj = jgmg.buildProlongation(jfem.P1_DoFMap(mC), jfem.P1_DoFMap(mF))
    Pt = tgmg.buildProlongation(_portDM(mC), _portDM(mF))
    assert Pt.shape == Pj.shape and Pt.data.device.type == 'cpu'
    np.testing.assert_array_equal(Pt.indptrH, np.asarray(Pj.indptr))
    np.testing.assert_array_equal(Pt.indicesH, np.asarray(Pj.indices))
    np.testing.assert_array_equal(Pt.dataH, np.asarray(Pj.data))
    # the device triple holds the same arrays, int32 indices
    assert Pt.indptr.dtype == Pt.indices.dtype == torch.int32
    np.testing.assert_array_equal(Pt.data.numpy(), Pt.dataH)


def _carryCSR(P):
    return csrFromArrays(P.indptr, np.asarray(P.indices), np.asarray(P.data),
                         P.shape, device='cpu')


def _jaxP(domain, lvl):
    mC, mF = _jaxMeshes(domain, lvl)[-2:]
    Pj = jgmg.buildProlongation(jfem.P1_DoFMap(mC), jfem.P1_DoFMap(mF))
    return Pj, _carryCSR(Pj)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def test_csr_spmv_plain_matches_jax():
    Pj, Pt = _jaxP('disc', 3)
    rng = np.random.default_rng(0)
    xc, xf, y0 = (rng.normal(size=n) for n in (Pt.num_columns, Pt.num_rows,
                                               Pt.num_rows))
    Px = np.asarray(Pj.matvec(jnp.asarray(xc)))
    PTx = np.asarray(Pj.rmatvec(jnp.asarray(xf)))
    assert _rel(Pt.matvec(torch.as_tensor(xc)), Px) <= 1e-14
    assert _rel(Pt.rmatvec(torch.as_tensor(xf)), PTx) <= 1e-14
    assert _rel(Pt.T.matvec(torch.as_tensor(xf)), PTx) <= 1e-14
    y = torch.as_tensor(y0.copy())
    got = Pt.matvec(torch.as_tensor(xc), out=y, accumulate=True)
    assert got is y
    assert _rel(y, y0 + Px) <= 1e-14
    np.testing.assert_array_equal(Pt.T.toarray(), np.asarray(Pj.toarray()).T)
    # T is the CSR of the transpose, built once, whose own T is P again
    assert Pt.T is Pt.transposed() and Pt.T.T is Pt
    assert Pt.T.shape == (Pt.num_columns, Pt.num_rows)


def test_cpu_wrappers_count_no_launch():
    """On CPU tensors K9, K10, K24 and K25 run their plain versions: no
    count moves; resetLaunches zeroes both counts."""
    from pynucleus_tpu_torch import kernels
    from pynucleus_tpu_torch.fem.assembly import matfree_apply
    from pynucleus_tpu_torch.nl.operator_interpolation import interp_matvec
    _, Pt = _jaxP('interval', 2)
    kernels.launches['csr_spmv'] = kernels.deviceLaunches['h2_matvec'] = 5
    kernels.launches['matfree_apply:diagonal'] = 5
    kernels.resetLaunches()
    x = torch.ones(Pt.num_columns, dtype=torch.float64)
    Pt.matvec(x)
    Pt.rmatvec(torch.ones(Pt.num_rows, dtype=torch.float64))
    tgmg.jacobi_smooth('residual', torch.empty_like(x), x, Ax=x)
    interp_matvec(torch.ones(2, dtype=torch.float64),
                  torch.ones((2, 3, 3), dtype=torch.float64),
                  torch.ones(3, dtype=torch.float64))
    zero = torch.zeros(1, dtype=torch.int32)
    matfree_apply(torch.ones((1, 1, 1), dtype=torch.float64),
                  zero.reshape(1, 1), zero,
                  torch.tensor([0, 1], dtype=torch.int32),
                  torch.ones(1, dtype=torch.float64))
    assert not any(kernels.launches.values())
    assert not any(kernels.deviceLaunches.values())
    assert set(kernels.deviceLaunches) == set(kernels.KERNELS
                                              + kernels.COMPLEX
                                              + kernels.HORIZON
                                              + kernels.FORMATS
                                              + kernels.TWOPOINT
                                              + kernels.ORDERS
                                              + kernels.FLOAT32)
    assert {'interp_matvec', 'matfree_apply'} <= set(kernels.deviceLaunches)


def test_csr_spmv_validates_inputs():
    _, Pt = _jaxP('interval', 2)
    x = torch.zeros(Pt.num_columns, dtype=torch.float64)
    with pytest.raises(ValueError, match='float64'):
        Pt.matvec(x.float())
    with pytest.raises(ValueError, match='out'):
        Pt.matvec(x, out=torch.zeros(Pt.num_rows + 1, dtype=torch.float64))


def test_jacobi_smooth_plain_matches_jax():
    rng = np.random.default_rng(1)
    n = 257
    x0, b, Ax = (rng.normal(size=n) for _ in range(3))
    Dinv = rng.uniform(0.5, 2.0, n)
    om = 2.0 / 3.0
    jx0, jb, jAx, jD = (jnp.asarray(a) for a in (x0, b, Ax, Dinv))
    refs = {'zero': om * (jD * jb), 'residual': jb - jAx,
            'update': jx0 + om * (jD * (jb - jAx))}
    omT = torch.tensor([om], dtype=torch.float64)
    for mode, ref in refs.items():
        x = torch.as_tensor(x0.copy())
        got = tgmg.jacobi_smooth(mode, x, torch.as_tensor(b),
                                 Ax=torch.as_tensor(Ax),
                                 Dinv=torch.as_tensor(Dinv), omega=omT)
        assert got is x
        assert _rel(x, ref) <= 1e-15, mode
    with pytest.raises(ValueError, match='omega'):
        tgmg.jacobi_smooth('zero', x, torch.as_tensor(b),
                           Dinv=torch.as_tensor(Dinv))
    with pytest.raises(ValueError, match='mode'):
        tgmg.jacobi_smooth('sweep', x, torch.as_tensor(b))


@pytest.fixture(scope='module', params=[('disc', 3, 'H2'),
                                        ('interval', 4, 'dense')],
                ids=['disc-noRef3-H2', 'interval-noRef4-dense'])
def carried(request):
    """A JAX hierarchy (4 H2 levels of the disc, or 5 dense levels of the
    interval) set up as the JAX multigrid, and the same operators carried
    into the port, set up as the port's multigrid."""
    domain, noRef, fmt = request.param
    dim, s = (2, 0.75) if domain == 'disc' else (1, 0.25)
    meshes = _jaxMeshes(domain, noRef)
    dms = [jfem.P1_DoFMap(m) for m in meshes]
    hj, ht = [], []
    for lvl, dm in enumerate(dms):
        builder = jasm.nonlocalBuilder(dm, jKernel(dim, s))
        A = builder.getH2() if fmt == 'H2' else builder.getDense()
        ej, et = {'A': A}, {}
        if fmt == 'H2':
            assert A.fusedTree
            et['A'] = _carry(A, device='cpu')
        else:
            et['A'] = Dense_LinearOperator(torch.as_tensor(
                np.asarray(A.data)))
        if lvl > 0:
            ej['P'] = jgmg.buildProlongation(dms[lvl - 1], dm)
            et['P'] = _carryCSR(ej['P'])
        hj.append(ej)
        ht.append(et)
    mj = jgmg.multigrid(hj)
    mj.setup()
    mt = tgmg.multigrid(ht)
    mt.setup()
    rng = np.random.default_rng(2)
    return mj, mt, rng.normal(size=dms[-1].num_dofs)


def test_mg_apply_on_carried_hierarchy(carried):
    mj, mt, b = carried
    assert len(mt.levels.As) == len(mj.levels.As)
    ref = np.asarray(jgmg._mg_apply(mj.levels, jnp.asarray(b)))
    got = tgmg._mg_apply(mt.levels, torch.as_tensor(b))
    assert np.linalg.norm(got.numpy() - ref) <= 1e-12 * np.linalg.norm(ref)
    # the preconditioner writes into out; a W cycle repeats the coarse
    # visit, as in the JAX package
    out = torch.empty_like(got)
    assert tgmg.mgPreconditioner(mt.levels).matvec(
        torch.as_tensor(b), out=out) is out
    assert torch.equal(out, got)
    refW = np.asarray(jgmg._mg_apply(mj.levels, jnp.asarray(b), gamma=2))
    gotW = tgmg.mgPreconditioner(mt.levels, 'W').matvec(torch.as_tensor(b))
    assert np.linalg.norm(gotW.numpy() - refW) <= \
        1e-12 * np.linalg.norm(refW)


def test_cg_mg_steps_match_cg_core(carried):
    """Ten CG-MG steps (tolerance 0, so none stops early) against
    _cg_core's use_prec branch with the JAX V-cycle as M."""
    mj, mt, b = carried
    Mj = mj.asPreconditioner()
    _, iters, hist = _cg_core(mj.A, Mj, jnp.asarray(b),
                              jnp.zeros(len(b)), 0.0, 10, use_prec=True)
    ts = solverFactory.build('cg', A=mt.A)
    ts.setPreconditioner(mt.asPreconditioner())
    ts.tolerance, ts.maxIter = 0.0, 10
    ts.solve(torch.as_tensor(b))
    rj = np.asarray(hist)
    rt = np.asarray(ts.residuals)
    assert int(iters) == 10 and ts.iterations == 10
    assert rt.shape == rj.shape == (11,)
    assert np.abs(rt - rj).max() <= 1e-10 * np.abs(rj).max()


def test_mg_solve_matches_jax(carried):
    mj, mt, b = carried
    for s in (mj, mt):
        s.tolerance, s.maxIter = 1e-8, 30
    xj = np.asarray(mj.solve(jnp.asarray(b)))
    xt = mt.solve(torch.as_tensor(b)).numpy()
    assert mt.iterations == mj.iterations
    rj, rt = np.asarray(mj.residuals), np.asarray(mt.residuals)
    assert rt.shape == rj.shape
    # relative to the first residual: the last ones are ||b - A x|| of
    # ~1e-8, where the cancellation leaves ~1e-16 of absolute difference
    assert np.abs(rt - rj).max() <= 1e-10 * rj.max()
    assert np.abs(xt - xj).max() <= 1e-10 * np.abs(xj).max()


def test_solver_factory_builds_cg_mg(carried):
    _, mt, _ = carried
    hierarchy = [{'A': A} if P is None else {'A': A, 'P': P, 'R': P.T}
                 for A, P in zip(mt.levels.As, mt.levels.Ps)]
    s = solverFactory.build('cg-mg', hierarchy=hierarchy, setup=True)
    assert s.A is hierarchy[-1]['A'] and s.initialized
    assert isinstance(s.prec, tgmg.mgPreconditioner)
    # a smoother kind the port does not have still raises; Chebyshev is
    # one of its kinds now (tests/test_torch_mg_extras.py holds it)
    with pytest.raises(NotImplementedError):
        tgmg.multigrid(hierarchy, smoother='gauss_seidel').setup()
    ml = tgmg.multigrid(hierarchy, smoother='chebyshev')
    ml.setup()
    assert ml.levels.kind == 'chebyshev' and len(ml.levels.rhos) == \
        len(hierarchy)


# the pinned values of tests/test_drivers_fractional.py for this config
INTERVAL_CG_MG = {'Hs error': 0.09611243700804001,
                  'L2 error': 0.026655318974538753,
                  'L2 error interpolated': 0.008022651615535344,
                  'Linf error interpolated': 0.04664221602282875,
                  'relative Hs error': 0.06843473328998091,
                  'relative L2 error': 0.018848156801586795,
                  'relative interpolated L2 error': 0.00567675661514787,
                  'relative interpolated Linf error': 0.04133558770221488}


@pytest.mark.parametrize('argv', [
    ['--domain', 'interval', '--s', 'const(0.25)', '--solverType', 'cg-mg',
     '--matrixFormat', 'dense'],
    ['--domain', 'interval', '--s', 'const(0.25)', '--solverType', 'mg',
     '--matrixFormat', 'dense'],
    ['--domain', 'disc', '--s', 'const(0.75)', '--solverType', 'cg-mg',
     '--matrixFormat', 'H2', '--noRef', '3'],
    ['--domain', 'disc', '--s', 'const(0.75)', '--solverType', 'mg',
     '--matrixFormat', 'H2', '--noRef', '3'],
], ids=['interval-cg-mg-dense', 'interval-mg-dense', 'disc-cg-mg-H2-noRef3',
        'disc-mg-H2-noRef3'])
def test_mg_driver_matches_jax_driver(argv):
    from drivers.runFractional import main as jMain
    flags = argv + ['--problem', 'constant', '--element', 'P1']
    d, _ = jMain(flags)
    out = tMain(flags + ['--device', 'cpu'], quiet=True)
    ej = d.outputGroups['errors'].toDict()
    et = out['errors'].toDict()
    assert set(et) == set(ej)
    for label, val in ej.items():
        assert np.isclose(et[label], val, rtol=3e-2, atol=1e-8), \
            (label, et[label], val)
    if argv[1] == 'interval' and 'cg-mg' in argv:
        for label, val in INTERVAL_CG_MG.items():
            assert np.isclose(et[label], val, rtol=3e-2, atol=1e-8), label
    rj = d.outputGroups['results'].toDict()
    rt = out['results'].toDict()
    assert rt['dofs'] == rj['dofs'] and rt['solver'] == rj['solver']
    assert rt['iterations'] == rj['iterations']
    if argv[1] == 'disc':
        assert (rt['dofs'], rt['iterations']) == \
            (253, 6 if 'cg-mg' in argv else 14)
    nLvl = len(out['hierarchy'])
    tim = out['timers'].toDict()
    assert nLvl == 4 if argv[1] == 'disc' else nLvl == 7
    assert np.isclose(tim['assembly seconds'],
                      sum(tim[f'assembly level {k} seconds']
                          for k in range(nLvl)))
    assert tim['hierarchy set-up seconds'] >= 0.0
    assert out['solver'].residuals[-1] <= 1e-6


def test_driver_defaults_to_the_card():
    """Without --device the driver asks for the card, and raises where
    there is none (it never runs on the CPU in its place)."""
    if torch.cuda.is_available():
        pytest.skip('a GPU is present')
    with pytest.raises(RuntimeError, match='cuda'):
        tMain(['--domain', 'interval', '--noRef', '2', '--solverType',
               'cg-mg'], quiet=True)

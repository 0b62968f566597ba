"""The multigrid extras of the port against the JAX package, on the CPU in
float64.

  spectral estimates  estimateSpectralRadius (with and without D^-1),
                      lanczos and lanczosSpectralBounds to 1e-12 relative,
                      arnoldi's H to 1e-12 and V to 1e-10
  K26 cheb_smooth     the plain version's three modes composed as
                      _chebSmooth (degree 1-3, from x = 0 and from x) to
                      1e-14 of the largest entry
  Chebyshev MG        V and FMG_V on the JAX package's hierarchies carried
                      into the port: iterations equal, residuals 1e-10
                      relative above their rounding floor, x 1e-12; the
                      tier-1 bar of
                      tests/test_multilevel_extra.py:63 on the port
  _mg_solve           iterations equal, x 1e-12, rn 1e-10 relative (both
                      above the rounding floor of ||b - A x||)
  K27 sss_spmv        toarray exactly, the apply to 1e-14 (both
                      constructors, unsorted row ids, a random SPD matrix)
  host smoothers      ILU and IChol solves 1e-12 and as CG preconditioners
                      (iterations equal), the ILU smoother's MG
                      (iterations equal, x 1e-10), GS/SOR/SSOR sweeps
                      1e-12, cg-ssor iterations equal
  hierarchyManager,   level matrices exactly and the solve's iterations;
  SchurComplement     1e-10
  the slice           Chebyshev MG as a solver and as CG's preconditioner
                      on the square at noRef 5 carried from JAX arrays
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.base import linalg as jla
from pynucleus_tpu.base import linear_operators as jlo
from pynucleus_tpu.base.solvers import solverFactory as jFactory
from pynucleus_tpu.multilevel import gmg as jgmg
from pynucleus_tpu.multilevel import hierarchies as jhier
from pynucleus_tpu.multilevel import smoothers as jsmooth  # noqa: F401

from pynucleus_tpu_torch import kernels
from pynucleus_tpu_torch.base import linalg as tla
from pynucleus_tpu_torch.base import linear_operators as tlo
from pynucleus_tpu_torch.base import solvers as tsol
from pynucleus_tpu_torch.base import sparse_native
from pynucleus_tpu_torch.base.solvers import solverFactory as tFactory
from pynucleus_tpu_torch.fem.meshes import uniformSquare
from pynucleus_tpu_torch.fem.assembly import assembleRHS
from pynucleus_tpu_torch.fem.functions import constant
from pynucleus_tpu_torch.interop import (csrHierarchyFromArrays,
                                         sssFromArrays)
from pynucleus_tpu_torch.multilevel import gmg as tgmg
from pynucleus_tpu_torch.multilevel import smoothers as tsmooth
from pynucleus_tpu_torch.multilevel.hierarchies import (hierarchyManager,
                                                        paramsForMG)

CPU = 'cpu'


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _t(a):
    return torch.tensor(np.asarray(a, dtype=np.float64))


def _lap1d(n):
    h = 1.0 / (n + 1)
    return (np.diag(2 * np.ones(n)) - np.diag(np.ones(n - 1), 1)
            - np.diag(np.ones(n - 1), -1)) / h ** 2


def _csrArrays(A):
    return (np.asarray(A.indptr), np.asarray(A.indices), np.asarray(A.data),
            A.shape)


def _both(A):
    """A scipy or dense matrix as the JAX package's and the port's CSR
    operators."""
    M = sp.csr_matrix(A)
    return (jlo.CSR_LinearOperator.from_scipy(M),
            tlo.CSR_LinearOperator.from_scipy(M, device=CPU))


def _levels(domain, noRef, first):
    """The JAX package's stiffness levels of the interval or the square
    (uniformSquare(N=2)) refined 0 ... noRef times, from refinement
    ``first`` on (tests/test_multilevel_extra.py:_gmgLevels)."""
    mesh = jfem.simpleInterval(0.0, 1.0) if domain == 'interval' else \
        jfem.uniformSquare(N=2, ax=0., ay=0., bx=1., by=1.)
    meshes = jgmg.buildMeshHierarchy(mesh, noRef)[first:]
    levels, dmPrev = [], None
    for m in meshes:
        dm = jfem.P1_DoFMap(m)
        entry = {'A': jfem.assembleStiffness(dm), 'dm': dm}
        if dmPrev is not None:
            entry['P'] = jgmg.buildProlongation(dmPrev, dm)
        levels.append(entry)
        dmPrev = dm
    return levels


def _carry(levels):
    """The same operators as the port's level list."""
    return csrHierarchyFromArrays(
        [_csrArrays(e['A']) for e in levels],
        [None] + [_csrArrays(e['P']) for e in levels[1:]], device=CPU)


def _load(levels):
    return np.asarray(jfem.assembleRHS(
        levels[-1]['dm'], jfem.functionFactory('constant', value=1.)).data)


@pytest.fixture(scope='module')
def interval():
    """test_chebyshev_mg's interval (noRef 6, levels 2-6), both packages,
    and its load."""
    lj = _levels('interval', 6, 2)
    return lj, _carry(lj), _load(lj)


@pytest.fixture(scope='module')
def square4():
    lj = _levels('square', 4, 1)
    return lj, _carry(lj), _load(lj)


# ------------------------------------------------------ spectral estimates

def _spectralOperators(name):
    if name == 'lap1d':
        A = _lap1d(50)
        return jlo.Dense_LinearOperator(jnp.asarray(A)), \
            tlo.Dense_LinearOperator(torch.as_tensor(A))
    lj = _levels('interval', 6, 2)
    return _both(lj[-1]['A'].to_scipy())


@pytest.mark.parametrize('name', ['lap1d', 'interval'])
def test_spectral_estimates_match_jax(name):
    Aj, At = _spectralOperators(name)
    Dj = 1.0 / Aj.diagonal
    Dt = 1.0 / At.diagonal
    for kw in ({}, {'maxiter': 500, 'tol': 1e-8}):
        rj = jla.estimateSpectralRadius(Aj, **kw)
        rt = tla.estimateSpectralRadius(At, **kw)
        assert abs(rt - rj) <= 1e-12 * rj
        rj = jla.estimateSpectralRadius(Aj, Dj, **kw)
        rt = tla.estimateSpectralRadius(At, Dt, **kw)
        assert abs(rt - rj) <= 1e-12 * rj
    for Dinv in (None, 'D'):
        aj, bj = jla.lanczos(Aj, k=20, Dinv=None if Dinv is None else Dj)
        at, bt = tla.lanczos(At, k=20, Dinv=None if Dinv is None else Dt)
        assert len(at) == len(aj)
        assert _rel(at, aj) <= 1e-12 and _rel(bt, bj) <= 1e-12
    bj = jla.lanczosSpectralBounds(Aj, k=30)
    bt = tla.lanczosSpectralBounds(At, k=30)
    np.testing.assert_allclose(bt, bj, rtol=1e-12)


def test_arnoldi_matches_jax():
    Aj, At = _spectralOperators('lap1d')
    Hj, Vj = jla.arnoldi(Aj, k=10)
    Ht, Vt = tla.arnoldi(At, k=10)
    assert Ht.shape == (11, 10) and Vt.shape == (50, 11)
    assert _rel(Ht, Hj) <= 1e-12
    assert np.abs(Vt.numpy() - np.asarray(Vj)).max() <= 1e-10


# ------------------------------------------------------------------ K26 ----

def _chebPort(A, Dinv, b, x, rho, degree, zeroGuess):
    """_chebSmooth composed of the port's schedule, applies and K26."""
    theta, coeffs = tgmg._chebSchedule(rho, degree)
    x, d = x.clone(), torch.empty_like(b)
    if zeroGuess:
        tgmg.cheb_smooth('zero', x, b, d, Dinv, theta=theta)
    else:
        tgmg.cheb_smooth('first', x, b, d, Dinv, Ax=A.matvec(x),
                         theta=theta)
    for c1, c2 in coeffs:
        tgmg.cheb_smooth('step', x, b, d, Dinv, Ax=A.matvec(x), c1=c1,
                         c2=c2)
    return x


@pytest.mark.parametrize('zeroGuess', [True, False])
@pytest.mark.parametrize('degree', [1, 2, 3])
def test_cheb_smooth_plain_matches_chebSmooth(degree, zeroGuess, interval):
    lj, lt, _ = interval
    Aj, At = lj[-1]['A'], lt[-1]['A']
    rng = np.random.RandomState(7)
    b, x = rng.rand(At.num_rows), rng.rand(At.num_rows) - 0.5
    Dj, Dt = 1.0 / Aj.diagonal, 1.0 / At.diagonal
    rho = jla.estimateSpectralRadius(Aj, Dj)
    ref = np.asarray(jgmg._chebSmooth(Aj, Dj, jnp.asarray(b),
                                      jnp.asarray(x), rho, degree,
                                      zeroGuess=zeroGuess))
    got = _chebPort(At, Dt, _t(b), _t(x), rho, degree, zeroGuess)
    assert np.abs(got.numpy() - ref).max() <= 1e-14 * np.abs(ref).max()


def test_cheb_smooth_checks_and_counts():
    n = 5
    v = [torch.ones(n, dtype=torch.float64) for _ in range(5)]
    kernels.resetLaunches()
    tgmg.cheb_smooth('step', v[0], v[1], v[2], v[3], Ax=v[4], c1=0.5,
                     c2=0.25)
    assert kernels.launches['cheb_smooth'] == 0
    np.testing.assert_array_equal(v[2].numpy(), np.full(n, 0.5))
    with pytest.raises(ValueError, match='mode'):
        tgmg.cheb_smooth('update', *v[:4], Ax=v[4], theta=1.0)
    with pytest.raises(ValueError, match='float64'):
        c = v[1].to(torch.complex128)
        tgmg.cheb_smooth('zero', v[0], c, v[2], v[3], theta=1.0)
    with pytest.raises(ValueError, match='host float'):
        tgmg.cheb_smooth('zero', *v[:4], theta=torch.ones(1))
    with pytest.raises(ValueError, match='contiguous'):
        tgmg.cheb_smooth('first', *v[:4], theta=1.0)   # no Ax


# -------------------------------------------------------- Chebyshev MG ----

def _solvePair(lj, lt, b, smoother, cycle, tol=1e-10):
    mj = jgmg.multigrid(hierarchy=lj, smoother=smoother)
    mj.setup()
    mj.tolerance = tol
    mj.cycle = cycle
    xj = np.asarray(mj.solve(jnp.asarray(b)))
    mt = tgmg.multigrid(lt, smoother=smoother)
    mt.setup()
    mt.tolerance = tol
    mt.cycle = cycle
    xt = mt.solve(_t(b)).numpy()
    return mj, xj, mt, xt


@pytest.mark.parametrize('domain', ['interval', 'square4'])
@pytest.mark.parametrize('cycle', ['V', 'FMG_V'])
def test_chebyshev_mg_matches_jax(domain, cycle, request):
    lj, lt, b = request.getfixturevalue(domain)
    mj, xj, mt, xt = _solvePair(lj, lt, b, ('chebyshev', {}), cycle)
    assert (mt.levels.kind, mt.levels.preSteps, mt.levels.postSteps) == \
        ('chebyshev', 3, 3)
    np.testing.assert_allclose(mt.levels.rhos, mj.levels.rhos, rtol=1e-12)
    assert mt.iterations == mj.iterations
    # residuals 1e-10 relative above the rounding floor of ||b - A x||
    # (1e-13 of the first; the two packages sum A x and the norm in other
    # orders, 3.7e-15 of the first on the interval's last residual)
    np.testing.assert_allclose(mt.residuals, mj.residuals, rtol=1e-10,
                               atol=1e-13 * mj.residuals[0])
    assert _rel(xt, xj) <= 1e-12
    if domain == 'square4':
        assert mt.iterations == {'V': 10, 'FMG_V': 9}[cycle]
    # the tier-1 bar (tests/test_multilevel_extra.py:63): no more
    # iterations than damped Jacobi, the same solution to 1e-8
    mJ = tgmg.multigrid(lt)
    mJ.setup()
    mJ.tolerance = 1e-10
    mJ.cycle = cycle
    xJ = mJ.solve(_t(b)).numpy()
    assert mt.iterations <= mJ.iterations
    assert np.abs(xt - xJ).max() < 1e-8


def test_smoother_parameters():
    assert tgmg._smootherParameters('chebyshev')[2:] == (3, 3)
    assert tgmg._smootherParameters(('chebyshev', {}))[2:] == (3, 3)
    assert tgmg._smootherParameters(('ilu', {}))[2:] == (1, 1)
    assert tgmg._smootherParameters(
        ('chebyshev', {'presmoothingSteps': 2}))[2:] == (2, 2)
    with pytest.raises(NotImplementedError, match='smoother'):
        tgmg._smootherParameters('gs')


@pytest.mark.parametrize('smoother', ['jacobi', 'chebyshev'])
def test_mg_solve_matches_jax(smoother, square4):
    lj, lt, b = square4
    mj = jgmg.multigrid(hierarchy=lj, smoother=(smoother, {}))
    mj.setup()
    mt = tgmg.multigrid(lt, smoother=(smoother, {}))
    mt.setup()
    x0 = np.random.RandomState(3).rand(len(b)) * 1e-3
    xj, kj, rj = jgmg._mg_solve(mj.levels, jnp.asarray(b), jnp.asarray(x0),
                                1e-10, 50)
    xt, kt, rt = tgmg._mg_solve(mt.levels, _t(b), _t(x0), 1e-10, 50)
    assert kt == int(kj) and rt <= 1e-10
    assert _rel(xt, xj) <= 1e-12
    # rn 1e-10 relative above its rounding floor, 1e-13 of ||b|| (it sits
    # at 1e-10, 1e-8 of ||b||; the packages sum A x and the norm in other
    # orders)
    assert abs(rt - float(rj)) <= 1e-10 * float(rj) \
        + 1e-13 * np.linalg.norm(b)
    # from x = 0, multigrid.solve's count
    mt.tolerance = 1e-10
    mt.solve(_t(b))
    _, k0, _ = tgmg._mg_solve(mt.levels, _t(b), torch.zeros(len(b),
                              dtype=torch.float64), 1e-10, 50)
    assert k0 == mt.iterations


def test_mg_preconditioner_with_chebyshev(square4):
    """One Chebyshev V-cycle as CG's preconditioner (the JAX
    mgPreconditioner through its _cg_core) and the port's."""
    lj, lt, b = square4
    mj = jgmg.multigrid(hierarchy=lj, smoother='chebyshev')
    mj.setup()
    mt = tgmg.multigrid(lt, smoother='chebyshev')
    mt.setup()
    v = np.random.RandomState(4).rand(len(b))
    ref = np.asarray(mj.asPreconditioner().matvec(jnp.asarray(v)))
    got = mt.asPreconditioner().matvec(_t(v)).numpy()
    assert _rel(got, ref) <= 1e-12


# ------------------------------------------------------------------ K27 ----

def _laplace1d(n):
    return sp.diags([-1., 2., -1.], [-1, 0, 1], shape=(n, n), format='csr')


def _randomSPD(n, seed=11):
    rng = np.random.RandomState(seed)
    M = sp.random(n, n, density=0.08, random_state=rng, format='csr')
    M = M + M.T + sp.diags(np.full(n, 4.0))
    return M.tocsr()


@pytest.mark.parametrize('form', ['indptr', 'rowids', 'unsorted', 'spd'])
def test_sss_matches_jax(form):
    A = _randomSPD(80) if form == 'spd' else _laplace1d(50)
    n = A.shape[0]
    L = sp.tril(A, k=-1).tocsr()
    x = np.random.RandomState(123).rand(n)
    if form in ('indptr', 'spd'):
        args, kw = (L.indices, L.indptr, L.data, A.diagonal()), {}
    else:
        Lc = L.tocoo()
        perm = (np.random.RandomState(5).permutation(Lc.nnz)
                if form == 'unsorted' else np.arange(Lc.nnz))
        args = (Lc.col[perm], None, Lc.data[perm], A.diagonal())
        kw = {'rowids': Lc.row[perm], 'num_rows': n}
    Sj = jlo.SSS_LinearOperator(*args, **kw)
    St = tlo.SSS_LinearOperator(*args, **kw, device=CPU)
    np.testing.assert_array_equal(St.toarray(), A.toarray())
    np.testing.assert_array_equal(St.toarray(), Sj.toarray())
    ref = np.asarray(Sj.matvec(jnp.asarray(x)))
    got = St.matvec(_t(x)).numpy()
    assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()
    assert np.abs(got - A @ x).max() <= 1e-13 * np.abs(A @ x).max()
    assert St.nnz == Sj.nnz and St.T is St
    np.testing.assert_array_equal(St.diagonal.numpy(), A.diagonal())
    np.testing.assert_array_equal(St.to_csr().toarray(), A.toarray())
    # the JAX operator's arrays carried into the port
    Sc = sssFromArrays(Sj.indices, Sj.indptr if Sj.indptr is not None
                       else None, Sj.data, Sj.diag,
                       rowids=None if Sj.indptr is not None else Sj.rowids,
                       num_rows=Sj.num_rows, device=CPU)
    np.testing.assert_array_equal(Sc.matvec(_t(x)).numpy(), got)


def test_sss_spmv_checks_and_counts():
    L = sp.tril(_laplace1d(6), k=-1).tocsr()
    S = tlo.SSS_LinearOperator(L.indices, L.indptr, L.data, np.full(6, 2.),
                               device=CPU)
    kernels.resetLaunches()
    out = torch.empty(6, dtype=torch.float64)
    assert S.matvec(torch.ones(6, dtype=torch.float64), out=out) is out
    assert kernels.launches['sss_spmv'] == 0
    args = [S.diag, S.data, S.indices, S.rowids, S.order1, S.offsets1,
            S.order2, S.offsets2, torch.ones(6, dtype=torch.float64)]
    with pytest.raises(ValueError, match='int32'):
        tlo.sss_spmv(*args[:2], S.indices.long(), *args[3:])
    with pytest.raises(ValueError, match='float64'):
        tlo.sss_spmv(*args[:-1], args[-1].to(torch.complex128))
    with pytest.raises(ValueError, match='shape'):
        tlo.sss_spmv(*args[:-1], torch.ones(5, dtype=torch.float64))
    assert 'sss_spmv.cu' in kernels.SOURCES and \
        'cheb_smooth.cu' in kernels.SOURCES
    assert kernels.KERNELS[-2:] == ('cheb_smooth', 'sss_spmv')


# ------------------------------------------------------- host smoothers ----

def _poisson1d(n):
    h = 1.0 / (n + 1)
    return (sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
            / h ** 2).tocsr()


@pytest.mark.parametrize('name', ['ilu', 'ichol'])
def test_incomplete_factorizations_match_jax(name):
    Aj, At = _both(_poisson1d(50) + sp.diags(np.linspace(0, 1e3, 50)))
    b = np.random.RandomState(0).rand(50)
    sj = jFactory.build(name, A=Aj, setup=True)
    st = tFactory.build(name, A=At, setup=True)
    ref = np.asarray(sj.solve(jnp.asarray(b)))
    got = st.solve(_t(b))
    assert got.dtype == torch.float64 and _rel(got.numpy(), ref) <= 1e-12
    Mt = st.asPreconditioner()
    assert _rel(Mt.matvec(_t(b)).numpy(), ref) <= 1e-12
    if name == 'ichol':
        # the port's own copy of the native source, built into the port
        lib = sparse_native.buildLibrary()
        assert '/pynucleus_tpu_torch/kernels/build/' in lib


@pytest.mark.parametrize('name', ['ilu', 'ichol'])
def test_incomplete_factorizations_precondition_cg(name):
    Aj, At = _both(_poisson1d(200))
    b = np.ones(200)
    sj = jFactory.build('cg', A=Aj, setup=True)
    st = tFactory.build('cg', A=At, setup=True)
    pj = jFactory.build(name, A=Aj)
    pt = tFactory.build(name, A=At)
    for s, p in ((sj, pj), (st, pt)):
        s.tolerance, s.maxIter = 1e-10, 500
        if name == 'ilu':
            p.fill_factor = 10.0
        p.setup()
        s.setPreconditioner(p.asPreconditioner())
    xj = np.asarray(sj.solve(jnp.asarray(b)))
    xt = st.solve(_t(b)).numpy()
    assert st.iterations == sj.iterations
    assert _rel(xt, xj) <= 1e-10


def test_ilu_smoother_mg_matches_jax():
    """test_ilu_smoother_gmg's interval (levels 3-7) with the ILU
    smoother."""
    lj = _levels('interval', 7, 3)
    lt = _carry(lj)
    b = np.ones(lt[-1]['A'].num_rows)
    mj = jgmg.multigrid(hierarchy=lj, smoother=('ilu', {}))
    mj.tolerance, mj.maxIter = 1e-10, 50
    mj.setup()
    xj = np.asarray(mj.solve(jnp.asarray(b)))
    mt = tgmg.multigrid(lt, smoother=('ilu', {}))
    mt.tolerance, mt.maxIter = 1e-10, 50
    mt.setup()
    xt = mt.solve(_t(b)).numpy()
    assert mt.levels.kind == 'ilu' and mt.iterations == mj.iterations
    assert _rel(xt, xj) <= 1e-10
    mJ = tgmg.multigrid(lt)
    mJ.tolerance, mJ.maxIter = 1e-10, 50
    mJ.setup()
    mJ.solve(_t(b))
    assert mt.iterations <= mJ.iterations


@pytest.mark.parametrize('name,omega', [('gs', 1.0), ('sor', 1.5),
                                        ('ssor', 1.2)])
def test_relaxation_sweeps_match_jax(name, omega):
    A = _lap1d(20)
    kw = {} if name == 'gs' else {'omega': omega}
    sj = jFactory.build(name, A=jlo.Dense_LinearOperator(jnp.asarray(A)),
                        setup=True, **kw)
    st = tFactory.build(name, A=tlo.Dense_LinearOperator(torch.as_tensor(A)),
                        setup=True, **kw)
    b = np.random.RandomState(5).rand(20)
    x0 = np.random.RandomState(6).rand(20)
    for x in (None, x0):
        ref = sj.solve(b, x)
        got = st.solve(_t(b), None if x is None else _t(x))
        assert _rel(got.numpy(), ref) <= 1e-12


def test_cg_ssor_matches_jax():
    A = _lap1d(60)
    b = np.random.RandomState(0).rand(60)
    sj = jFactory.build('cg-ssor', A=jlo.Dense_LinearOperator(
        jnp.asarray(A)), setup=True)
    st = tFactory.build('cg-ssor', A=tlo.Dense_LinearOperator(
        torch.as_tensor(A)), setup=True)
    for s in (sj, st):
        s.maxIter, s.tolerance = 200, 1e-10
    xj = np.asarray(sj.solve(jnp.asarray(b)))
    xt = st.solve(_t(b)).numpy()
    assert st.iterations == sj.iterations
    assert _rel(xt, xj) <= 1e-10
    assert np.linalg.norm(A @ xt - b) < 1e-7


def test_solver_factory_aliases():
    """'gs' and 'gauss_seidel' name one solver, as in the JAX package, and
    register's aliases add names."""
    assert tFactory.classes['gs'] == tFactory.classes['gauss_seidel']
    assert tFactory.classes['gs'][0] is tsmooth.gaussSeidel_solver
    A = tlo.Dense_LinearOperator(torch.as_tensor(_lap1d(8)))
    s = tFactory.build('sor', A=A, setup=True, omega=1.3, numSweeps=2)
    assert (s.omega, s.numSweeps) == (1.3, 2)
    factory = tsol.solverFactoryClass()
    factory.register('jacobi', tsol.jacobi_solver, aliases=['diag', 'j'])
    assert set(factory.classes) == {'jacobi', 'diag', 'j'}
    assert isinstance(factory.build('j', A=A, setup=True), tsol.jacobi_solver)


# ---------------------------------- hierarchyManager, SchurComplement ----

def test_hierarchy_manager_matches_jax():
    hj = jhier.hierarchyManager(jfem.uniformSquare(N=2, ax=0, ay=0, bx=1,
                                                   by=1),
                                jhier.paramsForMG(4, dim=2)).setup()
    ht = hierarchyManager(uniformSquare(N=2, ax=0, ay=0, bx=1, by=1),
                          paramsForMG(4, dim=2), device=CPU).setup()
    lj, lt = hj.getLevelList(), ht.getLevelList()
    assert len(ht) == len(hj) == 5
    assert 'P' in lt[-1] and 'R' in lt[-1] and 'P' not in lt[0]
    for ej, et in zip(lj, lt):
        np.testing.assert_array_equal(et['A'].toarray(), ej['A'].toarray())
        if 'P' in ej:
            np.testing.assert_array_equal(et['P'].toarray(),
                                          ej['P'].toarray())
    mj = jgmg.multigrid(hierarchy=lj)
    mj.setup()
    mj.tolerance = 1e-10
    bj = np.asarray(jfem.assembleRHS(lj[-1]['dm'], jfem.functionFactory(
        'constant', value=1.)).data)
    uj = np.asarray(mj.solve(jnp.asarray(bj)))
    mt = tgmg.multigrid(lt)
    mt.setup()
    mt.tolerance = 1e-10
    bt = assembleRHS(lt[-1]['dm'], constant(1.0)).data
    np.testing.assert_allclose(bt.numpy(), bj, rtol=1e-14)
    ut = mt.solve(bt).numpy()
    assert mt.iterations == mj.iterations
    assert _rel(ut, uj) <= 1e-10
    assert abs(ut.max() - 0.07367) < 2e-3


def test_schur_complement_matches_jax():
    rng = np.random.RandomState(3)
    M = rng.rand(12, 12)
    M = M @ M.T + 12 * np.eye(12)
    idx = np.array([0, 2, 5, 7])
    Sj = jlo.SchurComplement(jlo.Dense_LinearOperator(jnp.asarray(M)), idx)
    St = tlo.SchurComplement(tlo.Dense_LinearOperator(torch.as_tensor(M)),
                             idx)
    x = rng.rand(4)
    assert _rel(St.matvec(_t(x)).numpy(), np.asarray(Sj @ jnp.asarray(x))) \
        <= 1e-10
    assert _rel(St.toarray(), Sj.toarray()) <= 1e-10
    comp = np.setdiff1d(np.arange(12), idx)
    exact = M[np.ix_(idx, idx)] - M[np.ix_(idx, comp)] @ np.linalg.solve(
        M[np.ix_(comp, comp)], M[np.ix_(comp, idx)])
    assert _rel(St.toarray(), exact) <= 1e-10


# -------------------------------------------------------------- the slice --

@pytest.fixture(scope='module')
def square5():
    lj = _levels('square', 5, 1)
    return lj, _carry(lj), _load(lj)


@pytest.mark.parametrize('name', ['mg', 'cg-mg'])
def test_chebyshev_slice_end_to_end(name, square5):
    """Chebyshev MG on the square at noRef 5 (961 dofs) carried from JAX
    arrays: as the solver and as CG's preconditioner."""
    lj, lt, b = square5
    smoother = ('chebyshev', {})
    out = []
    for factory, h, v in ((jFactory, lj, jnp.asarray(b)), (tFactory, lt,
                                                           _t(b))):
        if name == 'mg':
            s = factory.build('mg', hierarchy=h, smoother=smoother)
        else:
            s = factory.build('cg', A=h[-1]['A'])
            s.setPreconditioner(factory.build(
                'mg', hierarchy=h, setup=True,
                smoother=smoother).asPreconditioner())
        s.setup()
        s.tolerance, s.maxIter = 1e-10, 50
        out.append((np.asarray(s.solve(v)), s.iterations))
    (xj, ij), (xt, it) = out
    assert it == ij and _rel(xt, xj) <= 1e-10
    A = lt[-1]['A']
    assert float(torch.linalg.norm(A.matvec(_t(xt)) - _t(b))) <= 1e-9

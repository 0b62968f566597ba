"""The port's two-point weights phi(x, y) and tempered kernels against the
JAX package.

Same inputs in both packages (the JAX package's meshes handed over as
arrays, numpy seeds); on the CPU the port's kernel wrappers run their
plain versions:

  two-point functions  evalPairs of constant, tempered, leftRight, lambda,
                       lookup and interface against the JAX ones: exactly
                       equal; the factory's names and aliases; the smooth
                       weight's device evaluation against jaxEval (1e-15)
  the tier-1 bars      tests/test_kernels_extra.py test_two_point_functions
                       and test_tempered_twopoint_kernel repeated on the port
  per-pair dense       getDense (params={'denseGrid': False}, the JAX
                       package's CPU path) with a tempered, leftRight,
                       constant, interface and lookup phi on the interval and
                       a tempered phi on a small disc: 1e-12 of max|A|; with
                       the zero-exterior term too (the boundary kernel drops
                       phi in both packages)
  the grid             the port's default grid with a tempered phi against
                       its per-pair path and the JAX per-pair path: 1e-4 (the
                       JAX grid drops phi and misses by 3 %: the port does
                       not copy that fault)
  tempered kernels     FractionalKernel(temperedLambda=) on the grid against
                       the JAX grid: 1e-12; A_phi = (C / C_t) A_t
  finite horizon       getSparse with a host phi, a tempered phi and the
                       gaussian and exponential kernels of a finite horizon
                       (K14 on the interval, K15 on the square): the JAX
                       pattern, data to 1e-12; runNonlocal's gaussian and
                       exponential lines against the JAX driver's outputs
  K19                  a nonsymmetric order with a tempered phi: 1e-12
  complex kernels      greens2D with a tempered phi: 1e-12
  refusals             H2, H2corrected and the cross operator of a weighted
                       or tempered kernel raise NotImplementedError naming
                       the reference fault; getFractionalKernel's
                       temperedLambda raises and names the constructor
"""
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import jax.numpy as jnp

from pynucleus_tpu.fem import meshFactory, dofmapFactory
from pynucleus_tpu.fem import Lambda as jLambda
from pynucleus_tpu.fem.meshes import circle as jCircle
from pynucleus_tpu.nl.assembly import nonlocalBuilder as jBuilder
from pynucleus_tpu.nl.kernels import (
    twoPointFunctionFactory as jtp, temperedTwoPoint as jTempered,
    leftRightTwoPoint as jLeftRight, constantTwoPoint as jConstant,
    interfaceTwoPoint as jInterface, lookupTwoPoint as jLookup,
    getFractionalKernel as jFractional, getIntegrableKernel as jIntegrable,
    getComplexKernel as jComplex, FractionalKernel as jFractionalKernel,
    constFractionalOrder as jConst, constantNonSymFractionalOrder as jNonSym)
from pynucleus_tpu.nl.problems import nonlocalMeshFactory, DIRICHLET

from pynucleus_tpu_torch.interop import fromArrays
from pynucleus_tpu_torch.fem import meshes as tmeshes
from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
from pynucleus_tpu_torch.nl.assembly import (nonlocalBuilder,
                                             assembleNonlocal,
                                             horizonCorrected)
from pynucleus_tpu_torch.nl.kernels import (
    twoPointFunctionFactory, temperedTwoPoint, leftRightTwoPoint,
    constantTwoPoint, lambdaTwoPoint, lookupTwoPoint,
    getFractionalKernel, getIntegrableKernel, FractionalKernel,
    getComplexKernel, Kernel, TWO_POINT_TEMPERED)
from pynucleus_tpu_torch.drivers.runNonlocal import main as tMain

PER_PAIR = {'denseGrid': False}
S, LAM = 0.4, 2.0


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def interval(noRef):
    """The JAX interval [-1, 1] refined noRef times and its P1 dofmap."""
    mesh = meshFactory('interval', a=-1, b=1)
    for _ in range(noRef):
        mesh = mesh.refine()
    return mesh, dofmapFactory('P1', mesh)


def disc(noRef):
    mesh = jCircle(h=0.78, radius=1.0)
    for _ in range(noRef):
        mesh = mesh.refine()
    return mesh, dofmapFactory('P1', mesh)


def port(mesh, **kw):
    """(dofmap, kernel) of the port on the JAX mesh's arrays."""
    _, tdm, tk = fromArrays(np.asarray(mesh.vertices),
                            np.asarray(mesh.cells), kw.pop('s', S),
                            mesh.dim, device='cpu', **kw)
    return tdm, tk


def dense(builder):
    return np.asarray(builder.getDense().toarray())


# ----------------------------------------------------- two-point functions

PAIRS = np.random.default_rng(16).uniform(-1.0, 1.0, (2, 200, 2))


@pytest.mark.parametrize('name,args', [
    ('constant', (2.5,)), ('const', (0.5,)), ('tempered', (3.0,)),
    ('temperedTwoPoint', (0.7,)), ('leftRight', (1.0, 2.0)),
    ('leftRight', (1.0, 2.0, 0.3, 4.0, 0.1)),
    ('interface', (0.2, 0.3, True)), ('interface', (0.2, 0.3, False, 0.1)),
    ('interfaceTwoPoint', (0.25, 0.15, True, -0.2, -0.5, 0.5))])
def test_two_point_evalpairs_match_jax(name, args):
    """evalPairs of each factory entry equals the JAX one, in 1D and 2D,
    exactly; the smooth weight is the tempered one only."""
    x, y = PAIRS
    # points on the interfaces themselves
    x[:5, 0] = y[5:10, 0] = 0.1
    a, b = twoPointFunctionFactory(name, *args), jtp(name, *args)
    assert type(a).__name__ == type(b).__name__
    for d in (1, 2):
        np.testing.assert_array_equal(a.evalPairs(x[:, :d], y[:, :d]),
                                      b.evalPairs(x[:, :d], y[:, :d]))
    assert a.smooth == getattr(b, 'smooth', False) \
        == (type(a) is temperedTwoPoint)
    assert a.symmetric == b.symmetric
    assert a._key() == b._key()


@pytest.mark.parametrize('phi,jphi', [
    (temperedTwoPoint(1.5), jTempered(1.5)),
    (leftRightTwoPoint(1.0, 2.0, 0.5, 3.0, 0.2),
     jLeftRight(1.0, 2.0, 0.5, 3.0, 0.2)),
    (constantTwoPoint(4.0), jConstant(4.0))])
def test_two_point_device_eval_matches_jaxeval(phi, jphi):
    x, y = PAIRS
    v = phi.eval(torch.as_tensor(x), torch.as_tensor(y)).numpy()
    jv = np.asarray(jphi.jaxEval(jnp.asarray(x), jnp.asarray(y)))
    assert_allclose(v, jv, rtol=1e-15, atol=0)
    assert temperedTwoPoint(1.5).deviceParams() == (TWO_POINT_TEMPERED, 1.5)


def test_lambda_and_lookup_two_point_match_jax():
    x, y = PAIRS

    def fun(a, b):
        return a[0] * b[1] + 1.0
    np.testing.assert_array_equal(lambdaTwoPoint(fun).evalPairs(x, y),
                                  jtp('lambda', fun=fun).evalPairs(x, y))
    mesh, dm = disc(1)
    tdm, _ = port(mesh)
    f = jLambda(lambda p: 1.0 + p[0] - 2.0 * p[1] ** 2)
    ju = dm.interpolate(f)
    tu = tdm.interpolate(lambda p: 1.0 + p[:, 0] - 2.0 * p[:, 1] ** 2)
    np.testing.assert_array_equal(tu.toarray(), np.asarray(ju))
    pts = 0.6 * PAIRS[:, :50]
    np.testing.assert_array_equal(
        lookupTwoPoint(tu).evalPairs(pts[0], pts[1]),
        jLookup(ju).evalPairs(pts[0], pts[1]))


# -------------------------------------------------- the tier-1 bars, port

def test_two_point_functions():
    """tests/test_kernels_extra.py::test_two_point_functions on the port."""
    tp = twoPointFunctionFactory
    x = np.array([[0.1, 0.2], [0.5, 0.5]])
    y = np.array([[0.4, 0.6], [0.5, 0.5]])
    c = tp('constant', value=2.0)
    assert_allclose(c.evalPairs(x, y), [2.0, 2.0])
    t = tp('tempered', lambdaCoeff=3.0)
    r = np.linalg.norm(x - y, axis=1)
    assert_allclose(t.evalPairs(x, y), np.exp(-3 * r))
    assert t.smooth
    lr = tp('leftRight', 1.0, 2.0, interface=0.3)
    assert_allclose(lr.evalPairs(x, y), [1.5, 2.0])
    lam = tp('lambda', fun=lambda a, b: a[0] + b[0])
    assert_allclose(lam.evalPairs(x, y), [0.5, 1.0])


def test_tempered_twopoint_kernel():
    """tests/test_kernels_extra.py::test_tempered_twopoint_kernel on the
    port: the smooth phi is evaluated per quadrature node (the device
    weight), the far entry scales by about exp(-lambda |xi - xj|)."""
    mesh, _ = interval(4)
    tdm = P1_DoFMap(tmeshes.simplexMesh(np.asarray(mesh.vertices),
                                        np.asarray(mesh.cells), dim=1),
                    device='cpu')
    phi = temperedTwoPoint(2.0, dim=1)
    k = getFractionalKernel(1, 0.4, phi=phi)
    assert k.phiDevice is not None and k.phi is None
    A = nonlocalBuilder(tdm, k, zeroExterior=False).getDense().toarray()
    A0 = nonlocalBuilder(tdm, getFractionalKernel(1, 0.4),
                         zeroExterior=False).getDense().toarray()
    assert np.abs(A - A0).max() > 1e-3
    coords = tdm.getDoFCoordinates()[:, 0]
    i, j = 0, tdm.num_dofs - 1
    expected = np.exp(-2.0 * abs(coords[i] - coords[j]))
    assert_allclose(A[i, j] / A0[i, j], expected, rtol=5e-2)


# -------------------------------------------------------- per-pair dense

def _lookupValues(mesh, dm):
    return np.asarray(dm.interpolate(jLambda(lambda p: 1.5 + p[0])))


INTERVAL_PHIS = {
    'tempered': (('tempered', LAM), lambda m, dm: jTempered(LAM)),
    'leftRight': (('leftRight', 1.0, 2.0, 0.5, 3.0, 0.1),
                  lambda m, dm: jLeftRight(1.0, 2.0, 0.5, 3.0, 0.1)),
    'constant': (('constant', 0.75), lambda m, dm: jConstant(0.75)),
    'interface': (('interface', 0.3, 0.2, True, 0.05),
                  lambda m, dm: jInterface(0.3, 0.2, True, 0.05)),
    'lookup': (None, lambda m, dm: jLookup(dm.interpolate(
        jLambda(lambda p: 1.5 + p[0])))),
}


@pytest.mark.parametrize('name', sorted(INTERVAL_PHIS))
@pytest.mark.parametrize('zeroExterior', [False, True])
def test_per_pair_dense_interval_matches_jax(name, zeroExterior):
    mesh, dm = interval(4)
    tphi, jphi = INTERVAL_PHIS[name]
    if name == 'lookup':
        tphi = ('lookup', _lookupValues(mesh, dm))
    jk = jFractional(1, S, phi=jphi(mesh, dm))
    Aj = dense(jBuilder(dm, jk, zeroExterior=zeroExterior,
                        params=PER_PAIR))
    tdm, tk = port(mesh, phi=tphi)
    assert (tk.phiDevice is not None) == (name == 'tempered')
    At = dense(nonlocalBuilder(tdm, tk, zeroExterior=zeroExterior,
                               params=PER_PAIR))
    assert rel(At, Aj) <= 1e-12
    if name != 'tempered' and not zeroExterior:
        # a host phi leaves the grid: the default path is the per-pair one
        np.testing.assert_array_equal(
            At, dense(nonlocalBuilder(tdm, tk, zeroExterior=False)))


def test_per_pair_dense_disc_tempered_matches_jax():
    mesh, dm = disc(1)
    Aj = dense(jBuilder(dm, jFractional(2, 0.75, phi=jTempered(LAM)),
                        params=PER_PAIR))
    tdm, tk = port(mesh, s=0.75, phi=('tempered', LAM))
    At = dense(nonlocalBuilder(tdm, tk, params=PER_PAIR))
    assert rel(At, Aj) <= 1e-12
    # the grid path applies phi as well (K2 from r2; the zero-exterior
    # term's grid and per-pair forms differ by 1e-4 with or without phi)
    assert rel(dense(nonlocalBuilder(tdm, tk, zeroExterior=False)),
               dense(nonlocalBuilder(tdm, tk, zeroExterior=False,
                                     params=PER_PAIR))) <= 1e-4


# ------------------------------------------------- the grid and tempering

def test_grid_applies_tempered_phi():
    """The port's grid (its default) applies the tempered phi: it meets its
    per-pair path and the JAX per-pair path to 1e-4 at 127 dofs, where the
    JAX grid, which drops phi (a reference fault), misses by about 3 %."""
    mesh, dm = interval(7)
    jk = jFractional(1, S, phi=jTempered(LAM))
    Aj = dense(jBuilder(dm, jk, zeroExterior=False, params=PER_PAIR))
    tdm, tk = port(mesh, phi=('tempered', LAM))
    Ag = dense(nonlocalBuilder(tdm, tk, zeroExterior=False))
    Ap = dense(nonlocalBuilder(tdm, tk, zeroExterior=False, params=PER_PAIR))
    assert rel(Ap, Aj) <= 1e-12
    assert rel(Ag, Ap) <= 1e-4 and rel(Ag, Aj) <= 1e-4
    Ajg = dense(jBuilder(dm, jk, zeroExterior=False,
                         params={'denseGrid': True}))
    assert rel(Ajg, Aj) > 1e-2


def test_tempered_kernel_grid_matches_jax_grid():
    """FractionalKernel(temperedLambda=) on the grid (the JAX grid has the
    tempering) and per pair, with the zero-exterior term (the boundary
    kernel keeps lambda); without it A_phi = (C / C_t) A_t."""
    mesh, dm = interval(5)
    jk = jFractionalKernel(1, jConst(S), temperedLambda=LAM)
    tdm, tk = port(mesh, temperedLambda=LAM)
    assert tk.scalingValue == jk.scalingValue
    assert tk.getBoundaryKernel().profileParams().t == LAM
    for params in ({'denseGrid': True}, PER_PAIR):
        Aj = dense(jBuilder(dm, jk, params=params))
        At = dense(nonlocalBuilder(tdm, tk, params=params))
        assert rel(At, Aj) <= 1e-12
    _, kphi = port(mesh, phi=('tempered', LAM))
    At = dense(nonlocalBuilder(tdm, tk, zeroExterior=False))
    Aphi = dense(nonlocalBuilder(tdm, kphi, zeroExterior=False))
    ratio = kphi.scalingValue / tk.scalingValue
    assert rel(Aphi, ratio * At) <= 1e-12


# --------------------------------------------------------- finite horizon

def jaxCollar(domain, noRef, k):
    mesh, info = nonlocalMeshFactory.build(
        domain, kernel=k, boundaryCondition=DIRICHLET,
        **({'a': -1, 'b': 1} if domain == 'interval' else {}))
    for _ in range(noRef):
        mesh = mesh.refine()
    dm = dofmapFactory('P1', mesh, tag=info['domain'])
    interior = np.zeros(mesh.num_vertices, dtype=bool)
    c, loc = np.nonzero(np.asarray(dm.dofs) >= 0)
    interior[np.asarray(mesh.cells)[c, loc]] = True
    return mesh, dm, interior


FH_LINES = {
    'leftRight-fractional': ('interval', 4, 'fractional',
                             ('leftRight', 1.0, 2.0, 0.5, 3.0, 0.1)),
    'tempered-constant': ('interval', 4, 'constant', ('tempered', LAM)),
    'gaussian': ('interval', 4, 'gaussian', None),
    'exponential': ('interval', 4, 'exponential', None),
    'gaussian-square': ('square', 0, 'gaussian', None),
    'tempered-square': ('square', 0, 'constant', ('tempered', LAM)),
}


@pytest.mark.parametrize('line', sorted(FH_LINES))
def test_finite_horizon_sparse_matches_jax(line):
    domain, noRef, kind, phi = FH_LINES[line]
    dim = 1 if domain == 'interval' else 2
    jphi = None if phi is None else (
        jTempered(phi[1]) if phi[0] == 'tempered' else jLeftRight(*phi[1:]))
    if kind == 'fractional':
        jk = jFractional(dim, S, horizon=0.2, phi=jphi)
    else:
        jk = jIntegrable(dim, {'constant': 'indicator'}.get(kind, kind), 0.2,
                         phi=jphi)
    mesh, dm, interior = jaxCollar(domain, noRef, jk)
    tdm, tk = port(mesh, kernelType=kind, horizon=0.2, phi=phi,
                   interior=interior)
    assert tk.scalingValue == jk.scalingValue
    assert tk.exponentParam == jk.exponentParam
    Sj = jBuilder(dm, jk).getSparse()
    St = assembleNonlocal(tdm, tk, matrixFormat='sparse', device='cpu')
    np.testing.assert_array_equal(St.indptrH, np.asarray(Sj.indptr))
    np.testing.assert_array_equal(St.indicesH, np.asarray(Sj.indices))
    assert rel(St.dataH, np.asarray(Sj.data)) <= 1e-12
    if domain == 'interval':
        dmBC = dm.getComplementDoFMap()
        Bj = np.asarray(jBuilder(dm, jk, zeroExterior=False,
                                 dm2=dmBC).getDenseCross().toarray())
        Bt = nonlocalBuilder(tdm, tk).getDenseCross().toarray()
        assert rel(Bt, Bj) <= 1e-12


# runNonlocal --problem poly-Dirichlet --element P1 --matrixFormat sparse
# (horizon 0.2): the JAX driver's outputs on the CPU (the interval's patch
# test at rounding level in both packages: held to 1e-10 absolute; the
# square to rtol 1e-6, its iterations exactly)
JAX_RUN_NONLOCAL = {
    ('interval', 'gaussian', 6, 'lu'): (639, 1, 6.4247010076930075e-12),
    ('interval', 'exponential', 6, 'lu'): (639, 1, 8.358673601561266e-14),
    ('square', 'gaussian', 1, 'cg-mg'): (361, 12, 0.3590483423625737),
}


@pytest.mark.parametrize('key', sorted(JAX_RUN_NONLOCAL))
def test_run_nonlocal_matches_jax_driver(key):
    domain, kind, noRef, solver = key
    out = tMain(['--domain', domain, '--kernelType', kind, '--problem',
                 'poly-Dirichlet', '--element', 'P1', '--solverType', solver,
                 '--matrixFormat', 'sparse', '--noRef', str(noRef),
                 '--device', 'cpu'], quiet=True)
    dofs, its, ref = JAX_RUN_NONLOCAL[key]
    res = out['results'].toDict()
    assert res['dofs'] == dofs and res['iterations'] == its
    err = out['errors'].toDict()['L2 error interpolated']
    if domain == 'interval':
        assert abs(err - ref) <= 1e-10
    else:
        assert abs(err - ref) <= 1e-6 * ref


# ---------------------------------------------------------- K19, complex

def test_nonsymmetric_order_with_tempered_phi_matches_jax():
    mesh, dm = interval(4)
    jk = jFractional(1, jNonSym(0.25), phi=jTempered(LAM))
    Aj = dense(jBuilder(dm, jk, params=PER_PAIR))
    tdm, tk = port(mesh, s='constantNonSym(0.25)', phi=('tempered', LAM))
    assert not tk.symmetric and tk.phiDevice is not None
    At = dense(nonlocalBuilder(tdm, tk, params=PER_PAIR))
    assert rel(At, Aj) <= 1e-12


def test_greens_with_tempered_phi_matches_jax():
    mesh = meshFactory('square', N=2, ax=0, ay=0, bx=1, by=1)
    mesh = mesh.refine().refine()
    dm = dofmapFactory('P1', mesh)
    jk = jComplex(2, greensLambda=-3j, phi=jTempered(1.0))
    Aj = dense(jBuilder(dm, jk))
    tdm, tk = port(mesh, kernelType='greens2D', greensLambda=-3j,
                   phi=('tempered', 1.0))
    At = dense(nonlocalBuilder(tdm, tk))
    assert At.dtype == np.complex128
    assert rel(At, Aj) <= 1e-12
    assert getComplexKernel(2, greensLambda=-3j,
                            phi=temperedTwoPoint(1.0)).phiDevice is not None


# ------------------------------------------------------------- refusals

def test_h2_formats_of_weighted_kernels_raise():
    """H2, H2corrected and the cross operator of a kernel with phi or a
    tempering raise, naming the reference fault; the finite horizon's H2
    is its sparse operator, which takes them."""
    mesh, _ = interval(3)
    tdm, _ = port(mesh)
    for k in (getFractionalKernel(1, S, phi=temperedTwoPoint(LAM)),
              getFractionalKernel(1, S, phi=leftRightTwoPoint(1.0, 2.0)),
              FractionalKernel(1, S, temperedLambda=LAM)):
        with pytest.raises(NotImplementedError, match='reference fault'):
            assembleNonlocal(tdm, k, matrixFormat='H2', device='cpu')
    kf = getFractionalKernel(1, S, horizon=0.3, phi=temperedTwoPoint(LAM))
    with pytest.raises(NotImplementedError, match='reference fault'):
        assembleNonlocal(tdm, kf, matrixFormat='H2corrected', device='cpu')
    with pytest.raises(NotImplementedError, match='reference fault'):
        horizonCorrected.setKernel(object.__new__(horizonCorrected), kf)
    with pytest.raises(NotImplementedError, match='reference fault'):
        nonlocalBuilder(tdm, kf.getComplementKernel())._getComplementCross()
    with pytest.raises(NotImplementedError, match='FractionalKernel'):
        getFractionalKernel(1, S, temperedLambda=LAM)
    with pytest.raises(NotImplementedError, match='polynomial'):
        getIntegrableKernel(1, 'polynomial', 0.2)
    assert isinstance(Kernel(1, 'polynomial', 0.2, None, 0.5, 0.0,
                             exponentParam=0.2), Kernel)


def test_kernel_keys_cover_phi_and_lambda():
    base = getFractionalKernel(1, S)
    keys = {base._key(),
            getFractionalKernel(1, S, phi=temperedTwoPoint(1.0))._key(),
            getFractionalKernel(1, S, phi=temperedTwoPoint(2.0))._key(),
            getFractionalKernel(1, S, phi=leftRightTwoPoint(1, 2))._key(),
            FractionalKernel(1, S, temperedLambda=1.0)._key()}
    assert len(keys) == 5
    jk = jFractional(1, S, phi=jTempered(1.0))
    assert getFractionalKernel(1, S, phi=temperedTwoPoint(1.0))._key()[-1] \
        == jk._key()[-1]

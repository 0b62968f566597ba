"""The port's remaining finite-horizon cut pairs against the JAX package:
ball1 and the ellipse (K15 and K1's indicator), the horizon indicator and
the variable horizon delta(x) of K19 (the indicator fallback), and
runNonlocal's disc with its collar.

Same inputs in both packages (numpy seeds, or the JAX package's meshes
handed over as arrays); on the CPU the port's kernel wrappers run their
plain versions:

  indicators         indicatorMask and dirNorm against jaxIndicator and
                     jaxDirNorm (ball2, ballInf, ball1, ellipse): exact
  K15 cut2d_polar    _bucket_cut2d_polar, ball1 and the ellipse, on the pair
                     of tests/test_cut_cells.py at order 16 and at the rules
                     _runCutPairs picks, and on the cut pairs of a square:
                     1e-13 of max|M|
  K19                _bucket_contrib_nonsym with the interaction indicator
                     (2D, the four balls) and with the variable horizon (1D,
                     compact=False rules, both orderings): 1e-13 of max|M|
  rules, screen      distantRule(compact=False) exactly; classifyPairsDense
                     of ball1, the ellipse and a variable horizon: the same
                     identical, touching, distant and cut sets and orders
  operators          getDense of ball1 and the ellipse (zeroExterior=False)
                     and getSparse and getDense of the three kernels of
                     tests/test_variable_horizon.py: 1e-12 of max|A|;
                     getSparse equals getDense
  the driver         runNonlocal --domain disc at noRef 2 (--device cpu):
                     the JAX driver's mesh, 187 dofs, 7 +-1 iterations and
                     its L2 error within rtol 3e-2

Each ellipse below has the axes and horizon of the JAX package's own test
of that horizon: the JAX package caches its programs per kernel with the
interaction's type alone (Kernel._key), so two ellipses of one horizon in
one process would share a program.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pynucleus_tpu.fem import meshFactory, dofmapFactory
from pynucleus_tpu.fem import simpleInterval as jInterval, P1_DoFMap as jP1
from pynucleus_tpu.fem.quadrature import simplexDuffy as jDuffy, \
    gauss01 as jGauss01
from pynucleus_tpu.nl import getFractionalKernel as jFractional
from pynucleus_tpu.nl.assembly import (nonlocalBuilder as jBuilder,
                                       _bucket_cut2d_polar,
                                       _bucket_contrib_nonsym)
from pynucleus_tpu.nl.kernels import (interactionFactory as jInter,
                                      getIntegrableKernel as jIntegrable,
                                      horizonFunction as jHorizon,
                                      INDICATOR)
from pynucleus_tpu.nl.panels import classifyPairsDense as jClassify
from pynucleus_tpu.nl.problems import nonlocalMeshFactory, DIRICHLET
from pynucleus_tpu.nl.quad_singular import distantRule as jDistantRule

from pynucleus_tpu_torch.interop import fromArrays
from pynucleus_tpu_torch.fem.quadrature import gauss01, simplexDuffy
from pynucleus_tpu_torch.nl import assembly as tasm
from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder as tBuilder
from pynucleus_tpu_torch.nl.kernels import (
    interactionFactory, indicatorMask, dirNorm, horizonFunction,
    getFractionalKernel, Indicator)
from pynucleus_tpu_torch.nl.panels import classifyPairsDense
from pynucleus_tpu_torch.nl.problems import processKernel
from pynucleus_tpu_torch.nl.quad_singular import distantRule
from pynucleus_tpu_torch.drivers.runNonlocal import main as tMain

# name -> (interaction args, horizon, normalized): the pair of
# tests/test_cut_cells.py (horizon 0.25) and the square of
# tests/test_kernels_extra.py (horizon 0.3)
PAIR_BALLS = {'ball1': ((), 0.25), 'ellipse': ((1.0, 0.7), 0.25)}
SQUARE_BALLS = {'ball1': ((), 0.3, True), 'ellipse': ((1.0, 0.5), 0.3, False)}
V1 = np.array([[0.0, 0.0], [0.1, 0.0], [0.0, 0.1]])
V2 = np.array([[0.22, 0.0], [0.32, 0.02], [0.2, 0.12]])
# (c0, c, min, max, s) of the kernels of tests/test_variable_horizon.py,
# delta(x) = clip(c0 + c x, min, max), and their refinements
VARIABLE = {'constant': ((0.2, 0.0, 0.2, 0.2), 0.25, 6),
            'patch': ((0.15, 0.05, 0.1, 0.2), 0.25, 6),
            'dense': ((0.25, 0.1, 0.15, 0.35), 0.4, 5)}
# the JAX driver's `runNonlocal --domain disc --kernelType constant
# --horizon 0.2 --problem poly-Dirichlet --element P1 --solverType cg-mg
# --matrixFormat sparse --noRef 2` on the CPU
JAX_DISC_NOREF2 = {'dofs': 187, 'iterations': 7,
                   'L2 error interpolated': 7.056934e-01}


def t(a, dtype=torch.float64):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(b).max()


def jaxBallKernel(name, args, horizon, normalized):
    return jIntegrable(2, INDICATOR, horizon,
                       interaction=jInter(name, *args), normalized=normalized)


def portBallKernel(name, args, horizon, normalized, mesh):
    """The port's indicator kernel of the same ball on the JAX mesh, P1 on
    every vertex (the JAX tag -1)."""
    _, dm, k = fromArrays(mesh.vertices, mesh.cells, 0.0, 2, device='cpu',
                          kernelType='constant', horizon=horizon,
                          interaction=(name,) + args, normalized=normalized,
                          interior=np.ones(mesh.num_vertices, dtype=bool))
    return dm, k


def jaxSquare(noRef):
    mesh = meshFactory('square', ax=0, ay=0, bx=1, by=1)
    for _ in range(noRef):
        mesh = mesh.refine()
    return mesh, dofmapFactory('P1', mesh, tag=-1)


def jaxVariable(label):
    (c0, c, lo, hi), s, noRef = VARIABLE[label]
    mesh = jInterval(-1.0, 1.0)
    for _ in range(noRef):
        mesh = mesh.refine()
    dm = jP1(mesh)
    k = jFractional(1, s, horizon=jHorizon(
        lambda x, c0=c0, c=c: c0 + c * x[..., 0], lo, hi))
    _, tdm, tk = fromArrays(mesh.vertices, mesh.cells, s, 1, device='cpu',
                            horizon=(c0, c, lo, hi))
    return mesh, dm, k, tdm, tk


# ----------------------------------------------------------- indicators --

@pytest.mark.parametrize('name,args', [('ball2', ()), ('ballInf', ()),
                                       ('ball1', ()), ('ellipse', (1.0, 0.7)),
                                       ('ellipse', (0.6, 1.0, 0.4))])
def test_indicator_and_dir_norm_match_jax(name, args):
    """indicatorMask and dirNorm against jaxIndicator and jaxDirNorm on
    seeded points around the horizon and seeded directions: exactly."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.3, 0.3, (4000, 2))
    y = rng.uniform(-0.3, 0.3, (4000, 2))
    ji, ti = jInter(name, *args), interactionFactory[name](*args)
    if name == 'ellipse':
        np.testing.assert_array_equal(ti.T, np.asarray(ji.T).ravel())
    h2 = 0.25 ** 2
    ref = np.asarray(ji.jaxIndicator(jnp.asarray(x), jnp.asarray(y), h2))
    xt, yt = t(x), t(y)
    got = indicatorMask(xt, yt, ((xt - yt) ** 2).sum(-1),
                        Indicator(ti.code, h2, ti.T))
    np.testing.assert_array_equal(got.numpy().astype(float), ref)
    assert 0 < ref.sum() < len(ref)
    th = rng.uniform(-np.pi, np.pi, 4000)
    d = np.stack([np.cos(th), np.sin(th)], -1)
    # the 1-norm and the max norm exactly; the 2-norms to 1 ulp (some runs
    # have rounded about 2 % of them to the double next to XLA's), and XLA's
    # CPU einsum fuses T[i,1] d_1 into a multiply-add where the port rounds
    # each product (2 ulps more for a rotated ellipse)
    got = dirNorm(t(d), ti.code, ti.T).numpy()
    ref = np.asarray(ji.jaxDirNorm(jnp.asarray(d)))
    ulps = {'ball2': 1, 'ellipse': 3}.get(name, 0)
    # on a mismatch, which side left numpy's correctly rounded 2-norm
    two = np.sqrt(np.sum(d ** 2, axis=-1))
    np.testing.assert_allclose(
        got, ref, rtol=ulps * 2.23e-16, atol=0, err_msg=(
            f'2-norms against numpy: port {np.abs(got - two).max():.3e}, '
            f'JAX {np.abs(ref - two).max():.3e}'))


# ------------------------------------------------------------------ K15 --

def _jaxPolar(k, verts, vi1, vi2, vols, bary_x, wx, thetas, wtheta, rq, wr,
              horizon):
    exps = jnp.asarray([[1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=jnp.float64)
    return np.asarray(_bucket_cut2d_polar(
        jnp.asarray(verts), jnp.asarray(vi1), jnp.asarray(vi2),
        jnp.asarray(vols), jnp.asarray(bary_x.T.copy()), jnp.asarray(wx),
        jnp.asarray(thetas), jnp.asarray(wtheta), jnp.asarray(rq),
        jnp.asarray(wr), exps, jnp.eye(3), horizon, kernel=k, dpe=3))


def _portPolar(tk, verts, vi1, vi2, vols, bary_x, wx, thetas, wtheta, rq,
               wr, horizon):
    return tasm._cut2dMatrices(
        t(verts), t(vi1, torch.int64), t(vi2, torch.int64), t(vols),
        t(bary_x.T), t(wx), t(thetas), t(wtheta), t(rq), t(wr), horizon,
        tk.interaction, tk.profileParams()).numpy()


@pytest.mark.parametrize('order', [None, 4, 8, 12, 16],
                         ids=['order16-81x', 'cut4', 'cut8', 'cut12',
                              'cut16'])
@pytest.mark.parametrize('name', ['ball1', 'ellipse'])
def test_k15_pair_matches_bucket_cut2d_polar(name, order):
    """K15's plain version against _bucket_cut2d_polar on the pair V1, V2
    of tests/test_cut_cells.py: at order 16 with simplexDuffy(16, 2) (81 x
    nodes, the plain version alone: the card takes at most 32) and at the
    rules _runCutPairs picks for the cut orders 4-16."""
    args, horizon = PAIR_BALLS[name]
    k = jaxBallKernel(name, args, horizon, False)
    verts = np.concatenate([V1, V2])
    vi1, vi2 = np.array([[0, 1, 2]]), np.array([[3, 4, 5]])
    vols = np.array([0.5 * abs(np.linalg.det(np.stack([V1[1] - V1[0],
                                                        V1[2] - V1[0]])))])
    if order is None:
        rules = (simplexDuffy(16, 2), gauss01(18), gauss01(16))
    else:
        rules = (simplexDuffy(max(order // 2, 4), 2),
                 gauss01(max(order // 2 + 2, 6)), gauss01(max(order // 2, 4)))
    (bx, wx), (th, wth), (rq, wr) = rules
    Mj = _jaxPolar(k, verts, vi1, vi2, vols, bx, wx, th, wth, rq, wr,
                   horizon)
    _, tk = portBallKernel(name, args, horizon, False, jaxSquare(0)[0])
    Mt = _portPolar(tk, verts, vi1, vi2, vols, bx, wx, th, wth, rq, wr,
                    horizon)
    assert rel(Mt, Mj) <= 1e-13


@pytest.mark.parametrize('name', ['ball1', 'ellipse'])
def test_k15_mesh_pairs_match_bucket_cut2d_polar(name):
    """K15's plain version against _bucket_cut2d_polar on every cut pair of
    the square refined twice, order by order with the rules of
    _runCutPairs."""
    args, horizon, normalized = SQUARE_BALLS[name]
    mesh, dm = jaxSquare(2)
    k = jaxBallKernel(name, args, horizon, normalized)
    _, tk = portBallKernel(name, args, horizon, normalized, mesh)
    ci, cj, orders = jClassify(dm, k)['cut']
    vols = mesh.simplexVolumes()
    assert len(ci) > 100
    for order in np.unique(orders):
        sel = orders == order
        ii, jj = ci[sel], cj[sel]
        oX = max(int(order) // 2, 4)
        (bx, wx), (th, wth), (rq, wr) = (
            jDuffy(oX, 2), jGauss01(max(int(order) // 2 + 2, 6)),
            jGauss01(max(int(order) // 2, 4)))
        np.testing.assert_array_equal(simplexDuffy(oX, 2)[0], bx)
        Mj = _jaxPolar(k, mesh.vertices, mesh.cells[ii], mesh.cells[jj],
                       vols[ii], bx, wx, th, wth, rq, wr, horizon)
        Mt = _portPolar(tk, mesh.vertices, mesh.cells[ii], mesh.cells[jj],
                        vols[ii], bx, wx, th, wth, rq, wr, horizon)
        assert rel(Mt, Mj) <= 1e-13, order


# ------------------------------------------------------------------ K19 --

def _nonsymPair(jk, tk, verts, cells, dm, ii, jj, order, mdim, compact):
    """K19's plain version against _bucket_contrib_nonsym on the pairs
    (ii, jj), both orderings, on distantRule(order, mdim, compact)."""
    rule = distantRule(order, mdim, compact=compact)
    jrule = jDistantRule(order, mdim, compact=compact)
    np.testing.assert_array_equal(rule.bary_x, jrule.bary_x)
    PSI = jrule.buildPSI(dm, nSharedVertices=0)
    PHIx, PHIy = jrule.buildPHI(dm, nSharedVertices=0)
    iiA, jjA = np.concatenate([ii, jj]), np.concatenate([jj, ii])
    vs = np.full(len(iiA), 0.01)
    PX, PY = tasm._phiPsi(PHIx, PSI), tasm._phiPsi(PHIy, PSI)
    Mj = np.asarray(_bucket_contrib_nonsym(
        jnp.asarray(verts), jnp.asarray(cells[iiA]), jnp.asarray(cells[jjA]),
        jnp.asarray(vs), jnp.asarray(rule.bary_x), jnp.asarray(rule.bary_y),
        jnp.asarray(rule.w), jnp.asarray(PX), jnp.asarray(PY), kernel=jk))
    Mt = tasm._nonsymMatrices(
        t(verts), t(cells[iiA], torch.int64), t(cells[jjA], torch.int64),
        t(vs), t(rule.bary_x), t(rule.bary_y), t(rule.w), t(PX), t(PY),
        tk.profileParams(), tk.orderParams(), tk.indicatorParams(),
        tk.horizonParams()).numpy()
    assert np.abs(Mj).max() > 0
    return rel(Mt, Mj)


@pytest.mark.parametrize('name,args', [('ball2', ()), ('ballInf', ()),
                                       ('ball1', ()),
                                       ('ellipse', (1.0, 0.5))])
def test_k19_indicator_matches_bucket_contrib_nonsym(name, args):
    """K19 with the interaction indicator (radial profile, no order) on the
    cut pairs of the square refined twice (the indicator decides inside
    these pairs) against _bucket_contrib_nonsym of the same kernel."""
    horizon, normalized = 0.3, name != 'ellipse'
    mesh, dm = jaxSquare(2)
    k = jaxBallKernel(name, args, horizon, normalized)
    _, tk = portBallKernel(name, args, horizon, normalized, mesh)
    ci, cj, _ = jClassify(dm, k)['cut']
    assert _nonsymPair(k, tk, mesh.vertices, mesh.cells, dm, ci[:300],
                       cj[:300], 6, 2, False) <= 1e-13


@pytest.mark.parametrize('label', list(VARIABLE))
def test_k19_variable_horizon_matches_bucket_contrib_nonsym(label):
    """K19 with the variable horizon (HorizonParams, delta(x) in t1 and
    delta(y) in t2) and its ball2 indicator against _bucket_contrib_nonsym
    of variableHorizonFractionalKernel: the cut pairs on the compact=False
    rules of the indicator fallback, the distant pairs on the compact
    ones."""
    mesh, dm, k, tdm, tk = jaxVariable(label)
    info = jClassify(dm, k)
    for key, compact in (('cut', False), ('distant', True)):
        ii, jj, orders = info[key]
        for order in np.unique(orders)[:3]:
            sel = orders == order
            assert _nonsymPair(k, tk, mesh.vertices, mesh.cells, dm,
                               ii[sel], jj[sel], int(order), 1,
                               compact) <= 1e-13, (key, order)


# -------------------------------------------------------- rules, screen --

@pytest.mark.parametrize('mdim', [1, 2])
def test_distant_rule_not_compact_matches_jax(mdim):
    for order in range(2, 17, 2):
        a, b = distantRule(order, mdim, compact=False), \
            jDistantRule(order, mdim, compact=False)
        for f in ('bary_x', 'bary_y', 'w'):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize('which', ['ball1', 'ellipse', 'variable'])
def test_classification_matches_jax(which):
    """classifyPairsDense gives the JAX package's identical, touching,
    distant and cut sets and orders."""
    if which == 'variable':
        mesh, dm, k, tdm, tk = jaxVariable('patch')
    else:
        args, horizon, normalized = SQUARE_BALLS[which]
        mesh, dm = jaxSquare(3)
        k = jaxBallKernel(which, args, horizon, normalized)
        tdm, tk = portBallKernel(which, args, horizon, normalized, mesh)
    ij, it = jClassify(dm, k), classifyPairsDense(tdm, tk)
    np.testing.assert_array_equal(it['id'], ij['id'])
    np.testing.assert_array_equal(it['touching'][0], ij['touching'][0])
    for key in ('distant', 'cut'):
        for a, b in zip(it[key], ij[key]):
            np.testing.assert_array_equal(a, b)
    assert len(it['cut'][0]) > 0


def test_horizon_function_is_affine():
    """The port's horizonFunction is the affine clip(c0 + c x_0, min, max);
    a general function raises, and getFractionalKernel builds the variable
    horizon's kernel from it."""
    hf = horizonFunction(0.15, 0.05, 0.1, 0.2)
    x = np.linspace(-2, 2, 9)[:, None]
    jh = jHorizon(lambda x: 0.15 + 0.05 * x[..., 0], 0.1, 0.2)
    np.testing.assert_array_equal(hf(x), jh(x))
    np.testing.assert_array_equal(hf.eval(t(x)).numpy(), jh(x))
    with pytest.raises(NotImplementedError, match='general delta'):
        horizonFunction(lambda x: 0.1 + x[..., 0] ** 2, 0.1, 0.2)
    k = getFractionalKernel(1, 0.25, horizon=hf)
    assert k.variableHorizon and not k.symmetric and k.horizonValue == 0.2
    with pytest.raises(NotImplementedError, match='general delta'):
        getFractionalKernel(1, 0.25, horizon=lambda x: 0.2 + 0 * x[..., 0])


# ------------------------------------------------------------ operators --

@pytest.mark.parametrize('name', ['ball1', 'ellipse'])
def test_ball_operators_match_jax(name):
    """getDense of ball1 and the ellipse on the square refined 3 times (P1
    on every vertex, zeroExterior=False) against the JAX getDense; the
    port's getSparse equals its getDense."""
    args, horizon, normalized = SQUARE_BALLS[name]
    mesh, dm = jaxSquare(3)
    k = jaxBallKernel(name, args, horizon, normalized)
    Aj = np.asarray(jBuilder(dm, k, zeroExterior=False).getDense().toarray())
    tdm, tk = portBallKernel(name, args, horizon, normalized, mesh)
    At = tBuilder(tdm, tk, zeroExterior=False).getDense().toarray()
    assert rel(At, Aj) <= 1e-12
    As = tBuilder(tdm, tk).getSparse().toarray()
    assert rel(As, At) <= 1e-12


@pytest.mark.parametrize('label', list(VARIABLE))
def test_variable_horizon_operators_match_jax(label):
    """getSparse and getDense of the kernels of
    tests/test_variable_horizon.py (delta constant 0.2; 0.1 + 0.05 (x+1);
    0.15 + 0.1 (x+1), s 0.4) at their refinements against the JAX
    package's."""
    mesh, dm, k, tdm, tk = jaxVariable(label)
    Sj = np.asarray(jBuilder(dm, k).getSparse().toarray())
    St = tBuilder(tdm, tk).getSparse().toarray()
    assert rel(St, Sj) <= 1e-12
    Dt = tBuilder(tdm, tk).getDense().toarray()
    assert rel(Dt, St) <= 1e-12
    Dj = np.asarray(jBuilder(dm, k).getDense().toarray())
    assert rel(Dt, Dj) <= 1e-12


# ------------------------------------------------------------ the driver --

def test_interaction_ellipse_maps_to_ball2():
    """runNonlocal's --interaction ellipse is ball2, as in the JAX
    driver."""
    k = processKernel('disc', 'constant', 'const(0.4)', 0.2, 'ellipse')
    assert repr(k.interaction) == 'ball2'
    assert k.scalingValue == processKernel('disc', 'constant', 'const(0.4)',
                                           0.2, 'ball2').scalingValue


def test_disc_driver_matches_jax():
    """runNonlocal's disc with its collar at noRef 2 on the CPU: the JAX
    driver's mesh (discWithInteraction refined twice), dofs, iterations
    (+-1) and L2 error (rtol 3e-2)."""
    k = jIntegrable(2, 'indicator', 0.2, interaction=jInter('ball2'))
    jmesh, _ = nonlocalMeshFactory.build('disc', kernel=k,
                                         boundaryCondition=DIRICHLET)
    out = tMain(['--domain', 'disc', '--kernelType', 'constant',
                 '--horizon', '0.2', '--problem', 'poly-Dirichlet',
                 '--element', 'P1', '--solverType', 'cg-mg',
                 '--matrixFormat', 'sparse', '--noRef', '2', '--device',
                 'cpu'], quiet=True)
    for _ in range(2):
        jmesh = jmesh.refine()
    np.testing.assert_allclose(out['meshes'][-1].vertices, jmesh.vertices,
                               rtol=0, atol=1e-15)
    np.testing.assert_array_equal(out['meshes'][-1].cells, jmesh.cells)
    res, errs = out['results'].toDict(), out['errors'].toDict()
    ref = JAX_DISC_NOREF2
    assert res['dofs'] == ref['dofs']
    assert abs(res['iterations'] - ref['iterations']) <= 1
    np.testing.assert_allclose(errs['L2 error interpolated'],
                               ref['L2 error interpolated'], rtol=3e-2)


# ------------------------------------------------------------- the card --

@pytest.mark.cuda
def test_finite_horizon_kernels_match_plain_on_gpu():
    """K15 with ball1 and the ellipse, K1 with their indicators and K19
    with the ball2 indicator and the variable horizon on the card against
    their plain versions on the same tensors, to 1e-12 of the largest entry
    (atomics add in no fixed order; needs an NVIDIA GPU)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    from pynucleus_tpu_torch import kernels
    kernels.resetLaunches()
    for name in ('ball1', 'ellipse'):
        args, horizon, normalized = SQUARE_BALLS[name]
        mesh, _ = jaxSquare(3)
        _, dm, kc = fromArrays(mesh.vertices, mesh.cells, 0.0, 2,
                               device='cuda', kernelType='constant',
                               horizon=horizon, interaction=(name,) + args,
                               normalized=normalized,
                               interior=np.ones(mesh.num_vertices, bool))
        Ac = tBuilder(dm, kc).getDense().toarray()
        tdm, tk = portBallKernel(name, args, horizon, normalized, mesh)
        Ap = tBuilder(tdm, tk).getDense().toarray()
        assert rel(Ac, Ap) <= 1e-12
        assert kernels.launches['cut2d_polar:' + name] > 0
        assert kernels.launches['panel_scatter:' + name] > 0
    for label in VARIABLE:
        mesh, _, _, tdm, tk = jaxVariable(label)
        (c0, c, lo, hi), s, _ = VARIABLE[label]
        _, dm, kc = fromArrays(mesh.vertices, mesh.cells, s, 1,
                               device='cuda', horizon=(c0, c, lo, hi))
        Sc = tBuilder(dm, kc).getSparse().toarray()
        Sp = tBuilder(tdm, tk).getSparse().toarray()
        assert rel(Sc, Sp) <= 1e-12
    for key in kernels.HORIZON:
        assert kernels.deviceLaunches[key] == kernels.launches[key] > 0, key

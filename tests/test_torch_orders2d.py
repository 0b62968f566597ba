"""The variable fractional orders of position (innerOuter, islands,
layers, smoothedLeftRight, linearLeftRightNonSym, innerOuterNonSym and
fe) and leftRight on triangles, with the variableOrder driver, of the port
against the JAX package.

  values     each order's host __call__ and its plain device evaluation
             (nl.kernels.orderEval) against the JAX __call__ and jaxEval
             at seeded points and at points on the orders' branch lines
             (|x - c| = r, |x_d| = r or r2, a layer boundary, the ends of
             the transitions, fe's raster nodes and box): 1e-15 (the
             branch taken is the JAX package's)
  flags      symmetric, min, max, repr and the factory's names: equal
  tier-1     tests/test_kernels_extra.py:86-125 (test_extra_orders_eval,
             test_fe_order_assembly) repeated on the port
  dense      each order on the interval refined 4 times and on its 2D
             mesh at noRef 2 (the driver's square or disc), with the
             zero-exterior term, per pair in both packages: 1e-12 of the
             largest entry
  driver     the port's variableOrder driver against the JAX driver:
             the square at noRef 2 (gmres, the transpose by gmres), the
             circle at noRef 2 (cg), the interval at noRef 4 (lu, dense
             and --do_h2), per pair: the same labels, norms to
             1e-10 relative, resNorms to 1e-10 of ||b|| (a solve's
             residual is rounding: it has no relative digits to hold)
  refusals   P0, --do_h2 in 2D, H2 of a 2D and of an order of position,
             the fe order's string
  tables     an order's table copied to a device once, freed with its
             order

The JAX side runs on the CPU as the JAX package's own tests run it; the
port's kernel wrappers run their plain versions on CPU tensors.  The
orders' cases (CASES) are those of scripts/pin_orders2d_jax.py.
"""
import contextlib
import io
import os
import sys

import numpy as np
import pytest
import torch

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.nl import kernels as jker
from pynucleus_tpu.nl.assembly import nonlocalBuilder as jBuilder

from pynucleus_tpu_torch.interop import fromArrays
from pynucleus_tpu_torch.drivers import variableOrder as tDriver
from pynucleus_tpu_torch.fem.dofmaps import fe_vector
from pynucleus_tpu_torch.fem.functions import Lambda as tLambda
from pynucleus_tpu_torch.fem.meshes import simpleInterval
from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap as tP1
from pynucleus_tpu_torch.nl import kernels as tker
from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder as tBuilder
from pynucleus_tpu_torch.nl.problems import parseFractionalOrder as tParse

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PER_PAIR = {'denseGrid': False}


def FE_ORDER(x):
    return 0.45 + 0.2 * x[0]


# name -> (the port's order string with {d} for the dimension, the JAX
# order of dimension d, the 2D mesh); 'fe' is the interpolant of FE_ORDER
CASES = {
    'leftRight': ('twoDomainNonSym(0.25,0.75)',
                  lambda d: jker.leftRightFractionalOrder(0.25, 0.75),
                  'square'),
    'innerOuter': ('innerOuter({d},0.75,0.25,0.5)',
                   lambda d: jker.innerOuterFractionalOrder(d, 0.75, 0.25,
                                                            0.5), 'disc'),
    'innerOuter_sio': ('innerOuter({d},0.75,0.25,0.5,sio=0.4,soi=0.6)',
                       lambda d: jker.innerOuterFractionalOrder(
                           d, 0.75, 0.25, 0.5, sio=0.4, soi=0.6), 'disc'),
    'islands': ('islands(0.3,0.7,r=0.1,r2=0.6)',
                lambda d: jker.islandsFractionalOrder(0.3, 0.7, r=0.1,
                                                      r2=0.6), 'square'),
    'islands_sio': ('islands(0.3,0.7,r=0.1,r2=0.6,sio=0.4,soi=0.6)',
                    lambda d: jker.islandsFractionalOrder(
                        0.3, 0.7, r=0.1, r2=0.6, sio=0.4, soi=0.6),
                    'square'),
    'layers': ('layers({d},2,-1,0.25,1,0.2,0.3,0.3,0.4)',
               lambda d: jker.layersFractionalOrder(
                   d, [-1.0, 0.25, 1.0], [[0.2, 0.3], [0.3, 0.4]]),
               'square'),
    'layers_nonsym': ('layers({d},2,-1,0.25,1,0.2,0.3,0.6,0.4)',
                      lambda d: jker.layersFractionalOrder(
                          d, [-1.0, 0.25, 1.0], [[0.2, 0.3], [0.6, 0.4]]),
                      'square'),
    'smoothedLeftRight': ('smoothedLeftRight(0.25,0.75,r=0.3)',
                          lambda d: jker.smoothedLeftRightFractionalOrder(
                              0.25, 0.75, r=0.3), 'square'),
    'linearLeftRightNonSym': ('linearLeftRightNonSym(0.25,0.75,r=0.3)',
                              lambda d: jker.linearLeftRightFractionalOrder(
                                  0.25, 0.75, r=0.3), 'square'),
    'innerOuterNonSym': ('innerOuterNonSym(0.3,0.6,r=0.2,radius=0.5)',
                         lambda d: jker.smoothedInnerOuterFractionalOrder(
                             0.3, 0.6, r=0.2, radius=0.5), 'disc'),
    'fe': (None, None, 'square'),
}


def _mesh(domain, noRef):
    m = {'interval': lambda: jfem.meshFactory('interval', a=-1, b=1),
         'square': lambda: jfem.meshFactory('square', ax=-1, ay=-1, bx=1,
                                            by=1),
         'disc': lambda: jfem.meshFactory('disc', n=8)}[domain]()
    for _ in range(noRef):
        m = m.refine()
    return m


def _where(name, where):
    """The JAX mesh of a case: the interval refined 4 times, or its 2D mesh
    at noRef 2."""
    return _mesh('interval', 4) if where == 'interval' \
        else _mesh(CASES[name][2], 2)


@pytest.fixture(scope='module')
def cases():
    """(name, where) -> (JAX mesh, JAX dofmap, JAX order, the port's mesh,
    dofmap and kernel), built once per module (fe's rasters are 36,864
    point lookups in 2D in each package)."""
    memo = {}

    def get(name, where):
        if (name, where) not in memo:
            jm = _where(name, where)
            jdm = jfem.dofmapFactory('P1', jm)
            spec, jaxOrder, _ = CASES[name]
            d = jm.dim
            if name == 'fe':
                vec = jdm.interpolate(jfem.Lambda(FE_ORDER))
                jo, spec = jker.feFractionalOrder(vec), \
                    ('fe', np.asarray(vec.data))
            else:
                jo, spec = jaxOrder(d), spec.format(d=d)
            memo[name, where] = (jm, jdm, jo) + fromArrays(
                jm.vertices, jm.cells, spec, d, device='cpu')
        return memo[name, where]
    return get


def _t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


# ------------------------------------------------------------ values ----

def _points(d, name, rng):
    """Seeded points in [-1.2, 1.2]^d and the case's branch points."""
    X = rng.uniform(-1.2, 1.2, (300, d))
    special = {
        'innerOuter': [[0.5] + [0.0] * (d - 1), [-0.5] + [0.0] * (d - 1)],
        'innerOuter_sio': [[0.0] * (d - 1) + [0.5]],
        'islands': [[0.1] * d, [0.6] * d, [-0.6] * d, [0.1, 0.6][:d]],
        'layers': [[0.0] * (d - 1) + [0.25], [0.0] * (d - 1) + [1.0],
                   [0.0] * (d - 1) + [-1.0]],
        'smoothedLeftRight': [[0.3] + [0.0] * (d - 1),
                              [-0.3] + [0.1] * (d - 1), [0.0] * d],
        'linearLeftRightNonSym': [[0.3] + [0.0] * (d - 1),
                                  [-0.3] + [0.1] * (d - 1), [0.0] * d],
        'innerOuterNonSym': [[0.3] + [0.0] * (d - 1),
                             [0.7] + [0.0] * (d - 1)],
        'fe': [[-1.0] * d, [1.0] * d, [-1.0 + 2.0 / 255] * d, [0.0] * d],
    }.get(name.replace('_nonsym', '').replace('islands_sio', 'islands'),
          [])
    S = np.array(special, dtype=np.float64).reshape(-1, d)
    return np.concatenate([X, S]), np.concatenate([X[::-1], S[::-1]])


@pytest.mark.parametrize('where', ['interval', '2d'])
@pytest.mark.parametrize('name', [n for n in CASES if n != 'leftRight'])
def test_order_values_match_jax(cases, name, where):
    """Host and device values of each order against the JAX package."""
    import jax.numpy as jnp
    jm, _, jo, _, _, tk = cases(name, where)
    d = jm.dim
    to = tk.s
    assert (type(to).__name__, to.symmetric, to.min, to.max, repr(to)) == \
        (type(jo).__name__, jo.symmetric, jo.min, jo.max, repr(jo))
    X, Y = _points(d, name, np.random.default_rng(17 + d))
    np.testing.assert_allclose(to(X, Y), jo(X, Y), rtol=0, atol=1e-15)
    dev = tker.orderEval(_t(X), _t(Y), to.orderParams(d, False)).numpy()
    ref = np.asarray(jo.jaxEval(jnp.asarray(X), jnp.asarray(Y)))
    np.testing.assert_allclose(dev, ref, rtol=0, atol=1e-15)


def test_factory_names_match_jax():
    f = jker.fractionalOrderFactory
    for name in ('innerOuter', 'smoothedLeftRight', 'smoothedTwoDomain',
                 'linearLeftRightNonSym', 'innerOuterNonSym', 'islands',
                 'layers', 'fe'):
        assert f.classes[f.getCanonicalName(name)][1].__name__ == \
            tker.fractionalOrderFactory[name].__name__


# ---------------------------------------------------- the tier-1 bars ----

def test_extra_orders_eval():
    """tests/test_kernels_extra.py::test_extra_orders_eval on the port."""
    f = tker.fractionalOrderFactory
    X = np.array([[-0.5], [0.0], [0.5]])
    Y = np.array([[0.5], [0.0], [-0.5]])
    lin = f['linearLeftRightNonSym'](0.25, 0.75, r=0.5)
    np.testing.assert_allclose(lin(X, Y), [0.25, 0.5, 0.75])
    isl = f['islands'](0.3, 0.7, r=0.1, r2=0.6)
    Xi = np.array([[0.3, 0.3], [0.0, 0.0]])
    np.testing.assert_allclose(isl(Xi, Xi), [0.3, 0.7])
    lay = tker.layersFractionalOrder(2, [0.0, 0.5, 1.0],
                                     [[0.2, 0.3], [0.3, 0.4]])
    Xl = np.array([[0.1, 0.25], [0.1, 0.75]])
    np.testing.assert_allclose(lay(Xl, Xl), [0.2, 0.4])
    np.testing.assert_allclose(lay(Xl[:1], Xl[1:]), [0.3])
    io_ = f['innerOuterNonSym'](0.3, 0.6, r=0.1, radius=0.5)
    np.testing.assert_allclose(io_(np.array([[0.0, 0.0]]),
                                   np.array([[0.0, 0.0]])), [0.3])
    np.testing.assert_allclose(io_(np.array([[0.9, 0.0]]),
                                   np.array([[0.0, 0.0]])), [0.6])


def test_fe_order_assembly():
    """tests/test_kernels_extra.py::test_fe_order_assembly on the port: the
    fe order of a constant field assembles as varconst."""
    mesh = simpleInterval(-1.0, 1.0)
    for _ in range(4):
        mesh = mesh.refine()
    dm = tP1(mesh, device='cpu')
    from pynucleus_tpu_torch.fem.meshes import NO_BOUNDARY
    dmAll = tP1(mesh, NO_BOUNDARY, device='cpu')
    sVec = fe_vector(torch.as_tensor(tLambda(lambda x: 0.75)(
        dmAll.getDoFCoordinates())), dmAll)
    sFe = tker.feFractionalOrder(sVec, smin=0.75, smax=0.75)
    # per pair, as the JAX test assembles on the CPU (varconst is a radial
    # profile: the port's default grid differs from the per-pair path by
    # 3.5e-5 on the interval, ROADMAP.md)
    Afe = tBuilder(dm, tker.getFractionalKernel(1, sFe),
                   params=PER_PAIR).getDense().toarray()
    Ac = tBuilder(dm, tker.getFractionalKernel(
        1, tker.fractionalOrderFactory['varconst'](0.75)),
        params=PER_PAIR).getDense().toarray()
    assert np.abs(Afe - Ac).max() < 1e-8 * np.abs(Ac).max()


# ------------------------------------------------------------- dense ----

@pytest.mark.parametrize('where', ['interval', '2d'])
@pytest.mark.parametrize('name', list(CASES))
def test_dense_matches_jax(cases, name, where):
    """Each order's dense operator with its zero-exterior term, per pair in
    both packages, on the interval refined 4 times and on its 2D mesh at
    noRef 2."""
    jm, jdm, jo, _, tdm, tk = cases(name, where)
    A = np.asarray(jBuilder(jdm, jker.getFractionalKernel(jm.dim, jo),
                            params=PER_PAIR).getDense().toarray())
    assert tk.variable and tk.symmetric == jo.symmetric
    B = tBuilder(tdm, tk, params=PER_PAIR).getDense().toarray()
    assert np.abs(B - A).max() <= 1e-12 * np.abs(A).max()


# ------------------------------------------------------------ driver ----

def _jaxDriver(argv):
    sys.path.insert(0, os.path.join(ROOT, 'drivers'))
    import variableOrder
    with contextlib.redirect_stdout(io.StringIO()):
        d = variableOrder.main(argv)
    return d.outputGroups['results'].toDict()


@pytest.mark.parametrize('argv', [
    ['--domain', 'square', '--noRef', '2', '--solver', 'gmres',
     '--do_transpose'],
    ['--domain', 'circle', '--noRef', '2', '--solver', 'cg'],
    ['--domain', 'interval', '--noRef', '4', '--do_h2']],
    ids=['square-gmres', 'circle-cg', 'interval-lu-h2'])
def test_driver_matches_jax(argv):
    ref = _jaxDriver(argv)
    out = tDriver.main(argv + ['--device', 'cpu'], quiet=True,
                       params=PER_PAIR)
    got = out['results'].toDict()
    assert sorted(got) == sorted(ref)
    bnorm = float(torch.linalg.norm(
        tDriver.assembleRHS(out['dm'], tDriver.constant(1.0)).data))
    for label, want in ref.items():
        if label.endswith('resNorm'):
            assert abs(got[label] - want) <= 1e-10 * bnorm, label
        else:
            assert abs(got[label] - want) <= 1e-10 * abs(want), label


# ---------------------------------------------------------- refusals ----

def test_refusals():
    with pytest.raises(NotImplementedError, match='A8 item 3'):
        tDriver.main(['--domain', 'interval', '--element', 'P0', '--device',
                      'cpu'], quiet=True)
    for domain in ('square', 'circle'):
        with pytest.raises(NotImplementedError):
            tDriver.main(['--domain', domain, '--do_h2', '--device', 'cpu'],
                         quiet=True)
    jm = _mesh('square', 1)
    _, tdm, tk = fromArrays(jm.vertices, jm.cells,
                            'twoDomainNonSym(0.25,0.75)', 2, device='cpu')
    with pytest.raises(NotImplementedError, match='2D'):
        tBuilder(tdm, tk).getH2()
    jm = _mesh('interval', 4)
    _, tdm, tk = fromArrays(jm.vertices, jm.cells,
                            'innerOuter(1,0.75,0.25,0.5)', 1, device='cpu')
    with pytest.raises(NotImplementedError, match='dense operator only'):
        tBuilder(tdm, tk).getH2()
    with pytest.raises(NotImplementedError):
        tParse('fe(0.5)')


# ------------------------------------------------------- order tables ----

def test_order_table_copies():
    """An order's table (layers, fe's raster) is copied to a device once,
    whatever OrderParams carry it, and goes with its order; the C entry
    points' order arguments need the device of an order with a table."""
    import gc
    import weakref
    order = tker.fractionalOrderFactory['layers'](
        2, [-1.0, 0.25, 1.0], [[0.2, 0.3], [0.3, 0.4]])
    p1, p2 = order.orderParams(2, False), order.orderParams(2, False)
    args = tker.orderArgs(p1, 'cpu')
    assert len(args) == len(tker.orderArgs(None)) == 21
    assert args[15].value == tker.orderArgs(p2, 'cpu')[15].value
    with pytest.raises(ValueError, match='device'):
        tker.orderArgs(p1)
    copy = weakref.ref(p1.table.on('cpu'))
    del order, p1, p2, args
    gc.collect()
    assert copy() is None

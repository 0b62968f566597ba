"""The variable-order H2 on the interval of the port against the JAX
package: the component kernels of a vector s-derivative kernel (the
singular rules' log correction in K1 and K19, the component order in K1,
K19 and K7), getH2Vector of a multi-parameter order, and the H2 of the
orders of position (K1's tree target, K19's slot target and K7 with
innerOuter, islands, layers and fe).

  component dense  getDense of each component kernel of LR2-d1
                   (leftRight(0.25, 0.75), derivative 1) at noRef 4 against
                   the JAX one: 1e-12 of the components' largest entry; of
                   LR4-d1 (leftRight(0.25, 0.75, 0.4, 0.6)) and LR2-d2
                   (derivative 2) against the JAX arrays pinned in
                   tests/data/varorder_h2_jax.npz
                   (scripts/pin_varorder_h2_jax.py; the slow twins hold
                   them to the JAX package)
  getH2Vector      LR2-d1, LR2-d2 and LR4-d1 at noRef 5: the apply and the
                   transposed apply against the pinned JAX ones, 1e-10
                   relative
  orders           getH2 of innerOuter and islands (symmetric and with sio
                   != soi) and layers (3 layers) at noRef 5, of fe at noRef
                   3 (the largest interval on which the JAX getH2 of the fe
                   order runs: beyond it its near-field nodes share dofs and
                   it fails with an AssertionError): the apply and the
                   transposed apply against the JAX ones, 1e-10 relative;
                   the gaps to getDense (max-norm, relative) equal to the
                   JAX operator's, pinned in ORDER_GAPS (the JAX H2 of
                   islands and layers is 1-4 % off its dense operator,
                   ROADMAP.md), to 1e-6 of them; the slow twin holds the
                   pins and the port's getDense to the JAX package
  kernels (plain)  K1 (tree target with the log correction and the y shift;
                   the orders of position), K19 (dense and slot targets with
                   the log correction; the orders of position) and K7 (the
                   component and the orders of position) at their largest
                   calls in these builds against _bucket_contrib,
                   _bucket_contrib_nonsym and _farFieldBlocks on the same
                   inputs: 1e-13 of the largest entry
  refusals         the H2 of smoothedLeftRight, linearLeftRight and
                   smoothedInnerOuter, and of fe at noRef 5, raises
                   NotImplementedError in the port; the slow twin shows the
                   JAX getH2 failing there with an AssertionError
  card             tests/test_torch_varorder_h2_gpu.py (no JAX there)

The JAX side runs on the CPU as the JAX package's own tests run it; the
port's kernel wrappers run their plain versions on CPU tensors.  The JAX
programs of each component kernel compile on their own (tens of seconds
a line): the vector lines but LR2-d1's component dense operators hold the
port to pinned JAX arrays.
"""
import contextlib
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.nl import kernels as jker
from pynucleus_tpu.nl import assembly as jasm

from pynucleus_tpu_torch.interop import fromArrays
from pynucleus_tpu_torch.nl import assembly as tasm
from pynucleus_tpu_torch.nl import kernels as tker

HERE = os.path.dirname(os.path.abspath(__file__))
PINS = os.path.join(HERE, 'data', 'varorder_h2_jax.npz')
SEED = 27           # scripts/pin_varorder_h2_jax.py SEED
FE_SMIN, FE_SMAX = 0.2, 0.8
FE_NOREF = 3        # scripts/pin_varorder_h2_jax.py FE_NOREF
# the vector lines: (leftRight parameters, derivative)
VECTOR_LINES = {'LR2-d1': ((0.25, 0.75), 1), 'LR2-d2': ((0.25, 0.75), 2),
                'LR4-d1': ((0.25, 0.75, 0.4, 0.6), 1)}
PINNED_LINES = ('LR4-d1', 'LR2-d2')   # component dense operators pinned


def FE_ORDER(x):
    return 0.5 + 0.3 * x[0]


# the orders of position (scripts/pin_varorder_h2_jax.py ORDER_CASES): the
# port's order string (fe: built from the JAX interpolant's values) and the
# JAX order on the JAX dofmap
ORDER_CASES = {
    'innerOuter': ('innerOuter(1,0.75,0.25,0.5)',
                   lambda dm: jker.innerOuterFractionalOrder(1, 0.75, 0.25,
                                                             0.5)),
    'innerOuter_sio': ('innerOuter(1,0.75,0.25,0.5,sio=0.4,soi=0.6)',
                       lambda dm: jker.innerOuterFractionalOrder(
                           1, 0.75, 0.25, 0.5, sio=0.4, soi=0.6)),
    'islands': ('islands(0.3,0.7)',
                lambda dm: jker.islandsFractionalOrder(0.3, 0.7)),
    'islands_sio': ('islands(0.3,0.7,sio=0.4,soi=0.6)',
                    lambda dm: jker.islandsFractionalOrder(
                        0.3, 0.7, sio=0.4, soi=0.6)),
    'layers': ('layers(1,3,-1,-0.3,0.4,1,0.2,0.3,0.4,0.3,0.5,0.6,0.4,0.6,0.7)',
               lambda dm: jker.layersFractionalOrder(
                   1, [-1.0, -0.3, 0.4, 1.0],
                   [[0.2, 0.3, 0.4], [0.3, 0.5, 0.6], [0.4, 0.6, 0.7]])),
    'fe': (None, lambda dm: jker.feFractionalOrder(
        dm.interpolate(jfem.Lambda(FE_ORDER)), FE_SMIN, FE_SMAX)),
}
# the JAX gaps max|H x - D x| / max|D x| of the apply and of the transposed
# apply of each order's getH2 against its getDense at noRef 5 (fe at
# FE_NOREF), x the seeded vector (scripts/pin_varorder_h2_jax.py --noRef 5)
ORDER_GAPS = {'innerOuter': (4.008093473236815e-06, 4.008093473236814e-06),
              'innerOuter_sio': (4.104363783515547e-06,
                                 3.8834922994267745e-06),
              'islands': (0.03416502753446562, 0.03416502753446557),
              'islands_sio': (0.01695746465680099, 0.01695605543427267),
              'layers': (0.014024929464406928, 0.014024929464406814),
              'fe': (7.573992384217347e-05, 8.314771823762246e-05)}
# the orders whose H2 operator the JAX getH2 fails to build on the interval
JAX_H2_FAILS = {
    'smoothedLeftRight': ('smoothedLeftRight(0.25,0.75)',
                          lambda: jker.smoothedLeftRightFractionalOrder(
                              0.25, 0.75)),
    'linearLeftRight': ('linearLeftRightNonSym(0.25,0.75)',
                        lambda: jker.linearLeftRightFractionalOrder(
                            0.25, 0.75)),
    'smoothedInnerOuter': ('innerOuterNonSym(0.3,0.6)',
                           lambda: jker.smoothedInnerOuterFractionalOrder(
                               0.3, 0.6)),
}


@pytest.fixture(autouse=True, scope='module')
def _twoTorchThreads():
    """Two torch threads for this module's tests: the workers of a
    parallel test run share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _interval(noRef):
    """runFractional's interval of noRef: [-1, 1] refined noRef + 1 times."""
    m = jfem.simpleInterval(-1.0, 1.0)
    for _ in range(noRef + 1):
        m = m.refine()
    return m


def _seeded(n):
    return np.random.default_rng(SEED).standard_normal(n)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _rel2(got, ref):
    ref = np.asarray(ref)
    return np.linalg.norm(np.asarray(got) - ref) / np.linalg.norm(ref)


def _maxRel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


def _gap(y, ref):
    return float(np.abs(y - ref).max() / np.abs(ref).max())


def _vectorPair(line, m):
    """(JAX dofmap, JAX vector kernel, port dofmap, port vector kernel)."""
    s, der = VECTOR_LINES[line]
    jk = jker.getFractionalKernel(1, jker.leftRightFractionalOrder(*s),
                                  derivative=der)
    _, tdm, tk = fromArrays(m.vertices, m.cells, s, 1, device='cpu',
                            derivative=der)
    return jfem.P1_DoFMap(m), jk, tdm, tk


class _Largest:
    """Replaces K1's, K19's and K7's wrappers in nl.assembly by ones that
    keep the largest call (by pairs, or blocks for K7) of each kind:
    ``log`` (with log tables), ``component`` (K7's component order) and
    ``position`` (an order of position), with the kernel that made it."""

    NAMES = ('panel_scatter', 'panel_scatter_tree', 'panel_scatter_nonsym',
             'panel_scatter_nonsym_slots', 'far_field')

    def __init__(self):
        self.calls = {}
        self.kernel = self.tkernel = None

    def _wrap(self, name, orig):
        def rec(*args, **kw):
            order = kw.get('order')
            if order is None and name.startswith('panel_scatter_nonsym'):
                order = args[12] if len(args) > 12 else None
            if order is None and name == 'far_field':
                order = args[3] if len(args) > 3 else None
            code = None if order is None else int(order.code)
            kind = 'log' if kw.get('logTables') is not None else \
                'component' if code == tker.ORDER_COMPONENT else \
                'position' if code in tker.ORDER_VARIANTS else None
            if kind is not None:
                size = args[0].shape[0] if name == 'far_field' \
                    else args[2].shape[0]
                key = (name, kind, kw.get('yShift') is not None)
                if size > self.calls.get(key, (-1,))[0]:
                    self.calls[key] = (size, (self.kernel, self.tkernel),
                                       order, args, kw)
            return orig(*args, **kw)
        return rec

    @contextlib.contextmanager
    def recording(self):
        with pytest.MonkeyPatch.context() as mp:
            for name in self.NAMES:
                mp.setattr(tasm, name, self._wrap(name, getattr(tasm, name)))
            yield self


RECORDED = _Largest()


def _build(jk, tk, what, dm, tdm):
    """The JAX and the port operator of what ('dense' or 'h2'),
    the port's calls recorded with the JAX kernel that made them."""
    RECORDED.kernel, RECORDED.tkernel = jk, tk
    with RECORDED.recording():
        tb = tasm.nonlocalBuilder(tdm, tk)
        t = {'dense': tb.getDense, 'h2': tb.getH2}[what]()
    jb = jasm.nonlocalBuilder(dm, jk)
    j = {'dense': jb.getDense, 'h2': jb.getH2}[what]()
    return j, t


# ------------------------------------------------------ vector lines ----

@pytest.fixture(scope='module')
def lr2():
    """LR2-d1: the component kernels' getDense at noRef 4 in both
    packages, the port's getH2Vector of LR2-d1 at noRef 5 (its calls
    recorded with the JAX vector kernel)."""
    out = {'dense': []}
    dm, jk, tdm, tk = _vectorPair('LR2-d1', _interval(4))
    for jc, tc in zip(jk.componentKernels(), tk.componentKernels()):
        j, t = _build(jc, tc, 'dense', dm, tdm)
        out['dense'].append((np.asarray(j.data), t.data.numpy()))
    dm, jk, tdm, tk = _vectorPair('LR2-d1', _interval(5))
    RECORDED.kernel, RECORDED.tkernel = jk, tk
    with RECORDED.recording():
        out['h2vec'] = tasm.nonlocalBuilder(tdm, tk).getH2Vector()
    return out


def test_component_dense_matches_jax(lr2):
    scale = max(np.abs(j).max() for j, _ in lr2['dense'])
    for j, t in lr2['dense']:
        assert np.abs(t - j).max() <= 1e-12 * scale
    # the two components differ: the sides of each parameter
    assert np.abs(lr2['dense'][0][0] - lr2['dense'][1][0]).max() > 0.1 * scale


@pytest.mark.parametrize('line', list(VECTOR_LINES))
def test_h2vector_matches_pinned_jax(lr2, line):
    """getH2Vector at noRef 5: the apply and the transposed apply against
    the JAX ones pinned by scripts/pin_varorder_h2_jax.py (the slow twin
    below)."""
    pins = np.load(PINS)
    if line == 'LR2-d1':
        Ht = lr2['h2vec']
    else:
        _, _, tdm, tk = _vectorPair(line, _interval(5))
        Ht = tasm.nonlocalBuilder(tdm, tk).getH2Vector()
    assert type(Ht).__name__ == 'H2_VectorLinearOperator'
    x = _t(_seeded(Ht.num_rows))
    for name, key in (('matvec', 'apply'), ('matvecTrans', 'transposed')):
        ref = pins[f'{line}/{key}']
        got = getattr(Ht, name)(x).numpy()
        assert got.shape == ref.shape == (Ht.num_rows, len(
            Ht.components))
        assert _rel2(got, ref) <= 1e-10


@pytest.mark.parametrize('line', PINNED_LINES)
def test_component_dense_matches_pinned_jax(line):
    """LR4-d1 and LR2-d2: each component kernel's getDense at noRef 4
    against the JAX operators pinned by scripts/pin_varorder_h2_jax.py (the
    slow twin below)."""
    pins = np.load(PINS)
    dm, jk, tdm, tk = _vectorPair(line, _interval(4))
    ref = pins[f'{line}/dense']
    assert ref.shape[0] == tk.valueSize == len(tk.componentKernels())
    for q, tc in enumerate(tk.componentKernels()):
        got = tasm.nonlocalBuilder(tdm, tc).getDense().data.numpy()
        assert np.abs(got - ref[q]).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.slow
@pytest.mark.parametrize('line', list(VECTOR_LINES))
def test_vector_line_pins_are_jax(line):
    """The arrays pinned in tests/data/varorder_h2_jax.npz are the JAX
    package's (about a minute a line: each component kernel compiles)."""
    pins = np.load(PINS)
    m4, m5 = _interval(4), _interval(5)
    dm, jk, _, _ = _vectorPair(line, m4)
    ref = pins[f'{line}/dense']
    for q, jc in enumerate(jk.componentKernels()):
        got = np.asarray(jasm.nonlocalBuilder(dm, jc).getDense().data)
        assert np.abs(got - ref[q]).max() <= 1e-13 * np.abs(ref).max()
    dm, jk, _, _ = _vectorPair(line, m5)
    H = jasm.nonlocalBuilder(dm, jk).getH2Vector()
    x = jnp.asarray(_seeded(dm.num_dofs))
    for name, key in (('matvec', 'apply'), ('matvecTrans', 'transposed')):
        assert _rel2(np.asarray(getattr(H, name)(x)),
                     pins[f'{line}/{key}']) <= 1e-13


# ------------------------------------------------- orders of position ----

def _orderPair(name):
    """(JAX dofmap, JAX kernel, port dofmap, port kernel) of an order of
    position on the interval at noRef 5 (fe at FE_NOREF)."""
    spec, jorder = ORDER_CASES[name]
    m = _interval(FE_NOREF if name == 'fe' else 5)
    dm = jfem.P1_DoFMap(m)
    jo = jorder(dm)
    if spec is None:
        spec = ('fe', np.asarray(jo.vec.data), FE_SMIN, FE_SMAX)
    _, tdm, tk = fromArrays(m.vertices, m.cells, spec, 1, device='cpu')
    return dm, jker.getFractionalKernel(1, jo), tdm, tk


@pytest.fixture(scope='module')
def orders():
    """getH2 of each order of position in both packages, the port's
    getDense."""
    out = {}
    for name in ORDER_CASES:
        dm, jk, tdm, tk = _orderPair(name)
        assert tk.symmetric == jk.symmetric and tk.variable
        H, Ht = _build(jk, tk, 'h2', dm, tdm)
        Dt = tasm.nonlocalBuilder(tdm, tk).getDense().data.numpy()
        out[name] = (H, Ht, Dt, tdm, tk)
    return out


@pytest.mark.parametrize('name', list(ORDER_CASES))
def test_order_h2_matches_jax(orders, name):
    H, Ht, Dt, tdm, tk = orders[name]
    x = _seeded(H.num_rows)
    # assembleNonlocal's 'h2' format is nonlocalBuilder's getH2
    A = tasm.assembleNonlocal(tdm, tk, matrixFormat='h2')
    assert _rel2(A.matvec(_t(x)).numpy(), Ht.matvec(_t(x)).numpy()) <= 1e-13
    for fwd, gJ in zip((True, False), ORDER_GAPS[name]):
        ref = np.asarray((H if fwd else H.T).matvec(jnp.asarray(x)))
        got = (Ht if fwd else Ht.T).matvec(_t(x)).numpy()
        assert _rel2(got, ref) <= 1e-10
        # the gap to dense is the JAX operator's (islands and layers: 1-4 %)
        gT = _gap(got, Dt @ x if fwd else Dt.T @ x)
        assert abs(gT - gJ) <= 1e-6 * gJ + 1e-12, (gT, gJ)


@pytest.mark.slow
@pytest.mark.parametrize('name', list(ORDER_CASES))
def test_order_gap_pins_are_jax(name):
    """ORDER_GAPS are the JAX operators' gaps, and the port's getDense is
    the JAX one (1e-12 of the largest entry)."""
    dm, jk, tdm, tk = _orderPair(name)
    H = jasm.nonlocalBuilder(dm, jk).getH2()
    D = np.asarray(jasm.nonlocalBuilder(dm, jk).getDense().data)
    assert _maxRel(tasm.nonlocalBuilder(tdm, tk).getDense().data.numpy(),
                   D) <= 1e-12
    x = _seeded(dm.num_dofs)
    for fwd, pin in zip((True, False), ORDER_GAPS[name]):
        y = np.asarray((H if fwd else H.T).matvec(jnp.asarray(x)))
        assert abs(_gap(y, D @ x if fwd else D.T @ x) - pin) <= 1e-9 * pin


# ------------------------------------------------------------ kernels ----

def _recorded(name, kind, yShift=False):
    key = (name, kind, yShift)
    assert key in RECORDED.calls, sorted(RECORDED.calls)
    return RECORDED.calls[key][1:]


def _jaxKernel(kernels, order):
    """The JAX kernel of a recorded call (``kernels``: the JAX and the
    port kernel of the build that made it): of a vector kernel's build the
    component whose gradient entries the call's component order holds, the
    boundary kernel where the call's order is the boundary kernel's."""
    jk, tk = kernels
    if int(order.code) == tker.ORDER_COMPONENT and \
            getattr(jk, 'valueSize', 1) > 1:
        G = order.table.host.reshape(4, tker.COMPONENT_ROW)[:, -1].numpy()
        grads = tk.vectorParams().grads
        q = next(q for q in range(grads.shape[1])
                 if np.array_equal(grads[:, q], G))
        jk = jk.componentKernels()[q]
    return jk.getBoundaryKernel() if order.boundary else jk


def _np(a):
    return None if a is None else jnp.asarray(a.numpy())


@pytest.mark.parametrize('kind,yShift', [('log', True), ('component', True),
                                         ('position', False),
                                         ('position', True)])
def test_k1_tree_plain_matches_jax(lr2, orders, kind, yShift):
    """K1's tree target at its largest call of each kind (a component's
    union surfaces with and without the log correction, all with the y
    shift; an order of position's distant near pairs and its union
    surfaces): the local matrices of the plain version against
    _bucket_contrib with useLogCorr and useYShift."""
    jk, order, args, kw = _recorded('panel_scatter_tree', kind, yShift)
    (data, vertices, vi1, vi2, dofRows, volsym, normals, I, J, offF, offB,
     tables, bary_x, bary_y, w, PSIP, prof) = args
    logs = kw.get('logTables')
    got = tasm._panelMatrices(vertices, vi1, vi2, volsym, normals, bary_x,
                              bary_y, w, PSIP, prof, None, order,
                              kw.get('yShift'), logs).numpy()
    logkw = {} if logs is None else dict(
        lnEta=_np(logs[0]), cw1=_np(logs[1]), cw2=_np(logs[2]),
        useLogCorr=True)
    ref = np.asarray(jasm._bucket_contrib(
        *(_np(a) for a in (vertices, vi1, vi2, volsym, bary_x, bary_y, w,
                           PSIP)), kernel=_jaxKernel(jk, order),
        yShift=_np(kw.get('yShift')), useYShift=yShift, **logkw))
    assert _maxRel(got, ref) <= 1e-13


@pytest.mark.parametrize('name,kind', [('panel_scatter', 'log'),
                                       ('panel_scatter_nonsym', 'log'),
                                       ('panel_scatter_nonsym_slots', 'log'),
                                       ('panel_scatter_nonsym_slots',
                                        'position')])
def test_dense_and_k19_plain_match_jax(lr2, orders, name, kind):
    """K1's dense target (the zero-exterior term of a component) and K19's
    dense and slot targets at their largest call of each kind: the plain
    version's local matrices against _bucket_contrib and
    _bucket_contrib_nonsym with useLogCorr."""
    jk, order, args, kw = _recorded(name, kind)
    logs = kw.get('logTables')
    logkw = {} if logs is None else dict(
        lnEta=_np(logs[0]), cw1=_np(logs[1]), cw2=_np(logs[2]),
        useLogCorr=True)
    if name == 'panel_scatter':
        (A, vertices, vi1, vi2, dofRows, volsym, normals, bary_x, bary_y, w,
         PSIP, prof) = args
        got = tasm._panelMatrices(vertices, vi1, vi2, volsym, normals,
                                  bary_x, bary_y, w, PSIP, prof, None, order,
                                  None, logs).numpy()
        ref = np.asarray(jasm._bucket_contrib(
            *(_np(a) for a in (vertices, vi1, vi2, volsym, bary_x, bary_y, w,
                               PSIP)), kernel=_jaxKernel(jk, order), **logkw))
    else:
        (out, vertices, vi1, vi2, index, volsym, bary_x, bary_y, w, PX, PY,
         prof) = args[:12]
        got = tasm._nonsymMatrices(vertices, vi1, vi2, volsym, bary_x,
                                   bary_y, w, PX, PY, prof, order, None,
                                   None, logs).numpy()
        ref = np.asarray(jasm._bucket_contrib_nonsym(
            *(_np(a) for a in (vertices, vi1, vi2, volsym, bary_x, bary_y, w,
                               PX, PY)), kernel=_jaxKernel(jk, order),
            **logkw))
    assert _maxRel(got, ref) <= 1e-13


@pytest.mark.parametrize('kind', ['component', 'position'])
def test_k7_plain_matches_jax(lr2, orders, kind):
    jk, order, args, kw = _recorded('far_field', kind)
    gi, gj, prof = args[:3]
    got = tasm.far_field(gi, gj, prof, order).numpy()
    ref = np.asarray(jasm._farFieldBlocks(_np(gi), _np(gj),
                                          kernel=_jaxKernel(jk, order)))
    assert _maxRel(got, ref) <= 1e-13


# ----------------------------------------------------------- refusals ----

def _feSpec(dm):
    """(the port's fe spec, the JAX fe order) of ORDER_CASES on dm."""
    jo = ORDER_CASES['fe'][1](dm)
    return ('fe', np.asarray(jo.vec.data), FE_SMIN, FE_SMAX), jo


@pytest.mark.parametrize('name', list(JAX_H2_FAILS) + ['fe'])
def test_h2_refused_where_jax_fails(name):
    m = _interval(5)
    spec = _feSpec(jfem.P1_DoFMap(m))[0] if name == 'fe' \
        else JAX_H2_FAILS[name][0]
    _, tdm, tk = fromArrays(m.vertices, m.cells, spec, 1, device='cpu')
    with pytest.raises(NotImplementedError, match='AssertionError'):
        tasm.nonlocalBuilder(tdm, tk).getH2()
    with pytest.raises(NotImplementedError, match='AssertionError'):
        tasm.assembleNonlocal(tdm, tk, matrixFormat='h2')


@pytest.mark.slow
@pytest.mark.parametrize('name', list(JAX_H2_FAILS) + ['fe'])
def test_jax_h2_fails_there(name):
    """The JAX getH2 of these orders fails on the interval (noRef 5) with
    an AssertionError, which the port's refusal names."""
    dm = jfem.P1_DoFMap(_interval(5))
    jo = _feSpec(dm)[1] if name == 'fe' else JAX_H2_FAILS[name][1]()
    jk = jker.getFractionalKernel(1, jo)
    with pytest.raises(AssertionError):
        jasm.nonlocalBuilder(dm, jk).getH2()

"""The s-derivative fractional operators of the port (dA/ds, d2A/ds2)
against the JAX package.

  kernels        DerivativeFractionalKernel (1D, 2D; s 0.25, 0.75;
                 normalized or not; derivative 1, 2; the boundary forms):
                 its values (the power-log profile's radialEval) against
                 _radialJax; the vector kernel of leftRight with 2 and 4
                 parameters: components and log coefficients against
                 evalComponentsJax / evalLogCoeffsJax; 1e-13 relative to
                 the size of the profile's terms at each point
  rule tables    lnEta, cw1, cw2 of the 1D singular rules: 1e-15 (the
                 same numpy code)
  getDense       constant order, the interval at noRef 6 and the disc at
                 noRef 3, the per-pair path (the JAX package's CPU
                 default; the port's params={'denseGrid': False}; the disc
                 with derivative 1) and the grid path (denseGrid True in
                 both; the disc with derivative 2): 1e-12 of the largest
                 entry
  getH2          the disc at noRef 3: the apply of a seeded x against the
                 JAX H2 apply (1e-10 relative); H2 against dense shows the
                 JAX package's discrepancy (to 1e-6 of it)
  vector dense   leftRight(0.25, 0.75) derivative 1 and 2, leftRight(0.25,
                 0.75, 0.4, 0.6) derivative 1, the interval at noRef 5:
                 toarray, matvec and matvecTrans (K23, also on the JAX
                 operator's data) against the JAX ones (1e-12); the second
                 derivative's component (0, 1) equals (1, 0) (1e-10)
  getH2Vector    constant order, the interval at noRef 6: apply and
                 transposed apply against the JAX ones (1e-10)
  raises         a finite horizon, tempered kernels, phi, a variable
                 constant-type order, getH2Vector of a multi-parameter
                 order, a 2D vector kernel, the component kernels

(1e-12: the same float64 quadrature summed in another order.)  The JAX
side runs on the CPU as the JAX package's own tests run it, its builds
shared by module fixtures; the port's kernel wrappers run their plain
versions on CPU tensors.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.nl import kernels as jker
from pynucleus_tpu.nl import assembly as jasm
from pynucleus_tpu.nl import quad_singular as jqs

from pynucleus_tpu_torch.interop import fromArrays, denseVectorFromArrays
from pynucleus_tpu_torch.nl import assembly as tasm
from pynucleus_tpu_torch.nl import kernels as tker
from pynucleus_tpu_torch.nl import quad_singular as tqs

VECTOR_ORDERS = {'LR2': (0.25, 0.75), 'LR4': (0.25, 0.75, 0.4, 0.6)}
VECTOR_LINES = [('LR2', 1), ('LR2', 2), ('LR4', 1)]


def _interval(noRef):
    m = jfem.simpleInterval(-1.0, 1.0)
    for _ in range(noRef):
        m = m.refine()
    return m


def _disc(noRef):
    m = jfem.circle(h=0.78, radius=1.0)
    for _ in range(noRef):
        m = m.refine()
    return m


def _points(dim, n=40, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.0, 1.0, (n, dim))
    y = rng.uniform(-1.0, 1.0, (n, dim))
    # a few close pairs: the singular end of the profile
    y[:5] = x[:5] + 1e-3 * rng.uniform(-1.0, 1.0, (5, dim))
    return x, y


def _termScale(r2, e, coefs):
    """|r2^e| times the sum of the absolute power-log terms at each point:
    the size against which a value that cancels is measured."""
    L = np.log(r2)
    return r2 ** e * (np.abs(coefs[0]) + np.abs(coefs[1] * L)
                      + np.abs(coefs[2] * L * L))


# ------------------------------------------------------------- kernels ---

@pytest.mark.parametrize('derivative', [1, 2])
@pytest.mark.parametrize('normalized', [True, False])
@pytest.mark.parametrize('s', [0.25, 0.75])
@pytest.mark.parametrize('dim', [1, 2])
def test_derivative_kernel_values(dim, s, normalized, derivative):
    """The kernel and its boundary kernel against _radialJax."""
    x, y = _points(dim)
    r2 = ((x - y) ** 2).sum(-1)
    kj = jker.getFractionalKernel(dim, s, normalized=normalized,
                                  derivative=derivative)
    kt = tker.getFractionalKernel(dim, s, normalized=normalized,
                                  derivative=derivative)
    assert isinstance(kt, tker.DerivativeFractionalKernel)
    for a, b in ((kj, kt), (kj.getBoundaryKernel(), kt.getBoundaryKernel())):
        ref = np.asarray(a._radialJax(jnp.asarray(r2)))
        prof = b.profileParams()
        assert prof.code == tker.POWER_LOG
        got = b.radial(torch.as_tensor(r2)).numpy()
        np.testing.assert_array_equal(
            got, tker.radialEval(torch.as_tensor(r2), prof).numpy())
        scale = _termScale(r2, prof.e, (prof.C, prof.C1, prof.C2))
        assert np.all(np.abs(got - ref) <= 1e-13 * scale)
        assert b.getSingularityValue() == a.getSingularityValue()


@pytest.mark.parametrize('boundary', [False, True])
@pytest.mark.parametrize('derivative', [1, 2])
@pytest.mark.parametrize('order', ['LR2', 'LR4'])
def test_vector_kernel_components(order, derivative, boundary):
    """Components and log coefficients against the JAX kernel, on points
    of every side pair of the interface."""
    x, y = _points(1, n=60, seed=1)
    r2 = ((x - y) ** 2).sum(-1)
    kj = jker.getFractionalKernel(
        1, jker.leftRightFractionalOrder(*VECTOR_ORDERS[order]),
        derivative=derivative)
    kt = tker.getFractionalKernel(
        1, tker.leftRightFractionalOrder(*VECTOR_ORDERS[order]),
        derivative=derivative)
    if boundary:
        kj, kt = kj.getBoundaryKernel(), kt.getBoundaryKernel()
    assert isinstance(kt, tker.VectorFractionalKernel)
    assert kt.valueSize == kj.valueSize
    assert kt.s.numParameters == kj.s.numParameters
    xt, yt, rt = (torch.as_tensor(a) for a in (x, y, r2))
    np.testing.assert_array_equal(kt.s.evalGrad(xt, yt).numpy(),
                                  np.asarray(kj.s.evalGradJax(x, y)))
    vp = kt.vectorParams()
    side = tker.vectorSide(xt, yt, vp.interface).numpy()
    cf = vp.coefs[side]
    scale = _termScale(r2, cf[:, 5], cf[:, :3].T)[:, None]
    got = kt.evalComponents(xt, yt, rt).numpy()
    ref = np.asarray(kj.evalComponentsJax(x, y, jnp.asarray(r2)))
    assert got.shape == ref.shape == (len(r2), kt.valueSize)
    assert np.all(np.abs(got - ref) <= 1e-13 * scale)
    for g, rf in zip(kt.evalLogCoeffs(xt, yt, rt),
                     kj.evalLogCoeffsJax(x, y, jnp.asarray(r2))):
        assert np.all(np.abs(g.numpy() - np.asarray(rf)) <= 1e-13 * scale)
    # the scalar view of the last component (_ComponentFractionalKernel)
    q = kt.valueSize - 1
    cj, ct = kj.componentKernels()[q], kt.componentKernels()[q]
    assert ct.derivative == cj.derivative and ct.variable and \
        not ct.symmetric
    np.testing.assert_array_equal(ct.evalXY(xt, yt, rt).numpy(), got[:, q])
    bj, _ = cj.evalLogCoeffsJax(x, y, jnp.asarray(r2))
    bt, _ = ct.evalLogCoeffs(xt, yt, rt)
    assert np.all(np.abs(bt.numpy() - np.asarray(bj)) <= 1e-13 * scale[:, 0])


def test_rule_log_tables_match_jax():
    """lnEta, cw1, cw2 of the 1D singular rules (the cancellation-1 split
    rule included) equal the JAX package's."""
    for sing in (-1.5, -2.5):
        for tj, tt in (
                (jqs.sameCellRule1D(sing, 10), tqs.sameCellRule1D(sing, 10)),
                (jqs.vertexRule1D(sing, 12, 10),
                 tqs.vertexRule1D(sing, 12, 10)),
                (jqs.vertexRule1D(sing, 12, 18, cancellation=1.0),
                 tqs.vertexRule1D(sing, 12, 18, cancellation=1.0)),
                (jqs.boundaryVertexRule1D(sing + 1.0, 6),
                 tqs.boundaryVertexRule1D(sing + 1.0, 6))):
            for name in ('bary_x', 'bary_y', 'w', 'lnEta', 'cw1', 'cw2'):
                a, b = getattr(tt, name), getattr(tj, name)
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=1e-15 * np.abs(b).max())
    assert tqs.distantRule(4, 1).cw1 is None


# --------------------------------------------------- constant-order ops ---

@pytest.fixture(scope='module')
def interval6():
    m = _interval(6)
    return m, jfem.P1_DoFMap(m)


@pytest.mark.parametrize('derivative', [1, 2])
def test_dense_interval(interval6, derivative):
    """getDense on the interval at noRef 6, the per-pair path."""
    m, dm = interval6
    ref = np.asarray(jasm.nonlocalBuilder(
        dm, jker.getFractionalKernel(1, 0.75, derivative=derivative))
        .getDense().toarray())
    _, tdm, tk = fromArrays(m.vertices, m.cells, 0.75, 1, device='cpu',
                            derivative=derivative)
    got = tasm.nonlocalBuilder(tdm, tk, params={'denseGrid': False}) \
        .getDense().toarray()
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.fixture(scope='module', params=[(1, False), (2, True)],
                ids=['d1-pairs', 'd2-grid'])
def disc3(request):
    """The disc at noRef 3 in both packages: the JAX dense operator of one
    path (derivative 1 per pair, 2 on the grid) and the JAX H2 operator,
    the port's kernel and dofmap."""
    d, grid = request.param
    m = _disc(3)
    dm = jfem.P1_DoFMap(m)
    kj = jker.getFractionalKernel(2, 0.75, derivative=d)
    J = {'dense': np.asarray(jasm.nonlocalBuilder(
        dm, kj, params={'denseGrid': grid}).getDense().toarray()),
         'H2': jasm.nonlocalBuilder(dm, kj).getH2()}
    _, tdm, tk = fromArrays(m.vertices, m.cells, 0.75, 2, device='cpu',
                            derivative=d)
    D = tasm.nonlocalBuilder(tdm, tk, params={'denseGrid': grid}) \
        .getDense().toarray()
    return J, D, tdm, tk


def test_dense_disc(disc3):
    J, D, _, _ = disc3
    ref = J['dense']
    assert np.abs(D - ref).max() <= 1e-12 * np.abs(ref).max()


def test_h2_disc(disc3):
    """The port's H2 apply against the JAX one; its distance from the
    port's dense apply is the JAX package's (H2 against its dense)."""
    J, D, tdm, tk = disc3
    x = np.random.RandomState(3).randn(tdm.num_dofs)
    H = tasm.nonlocalBuilder(tdm, tk).getH2()
    got = H.matvec(torch.as_tensor(x)).numpy()
    ref = np.asarray(J['H2'].matvec(jnp.asarray(x)))
    assert np.linalg.norm(got - ref) <= 1e-10 * np.linalg.norm(ref)
    eT = np.linalg.norm(got - D @ x) / np.linalg.norm(D @ x)
    eJ = np.linalg.norm(ref - J['dense'] @ x) / np.linalg.norm(J['dense'] @ x)
    assert 1e-5 < eJ < 1e-3
    assert abs(eT - eJ) <= 1e-6 * eJ


def test_h2_vector_interval(interval6):
    """getH2Vector of a constant order: one H2 component; apply and
    transposed apply against the JAX ones."""
    m, dm = interval6
    Hj = jasm.nonlocalBuilder(
        dm, jker.getFractionalKernel(1, 0.6, derivative=1)).getH2Vector()
    _, tdm, tk = fromArrays(m.vertices, m.cells, 0.6, 1, device='cpu',
                            derivative=1)
    Ht = tasm.nonlocalBuilder(tdm, tk).getH2Vector()
    assert Ht.vectorSize == Hj.vectorSize == 1
    x = np.sin(np.linspace(-1.0, 1.0, tdm.num_dofs))
    for trans in (False, True):
        ref = np.asarray(Hj(jnp.asarray(x), trans=trans))
        got = Ht(torch.as_tensor(x), trans=trans).numpy()
        assert got.shape == ref.shape == (tdm.num_dofs, 1)
        assert np.linalg.norm(got - ref) <= 1e-10 * np.linalg.norm(ref)


# ---------------------------------------------------------- vector dense ---

@pytest.fixture(scope='module', params=VECTOR_LINES,
                ids=[f'{o}-d{d}' for o, d in VECTOR_LINES])
def vector5(request):
    """The JAX and the port's getDenseVector of a leftRight order on the
    interval at noRef 5."""
    order, d = request.param
    m = _interval(5)
    dm = jfem.P1_DoFMap(m)
    Aj = jasm.nonlocalBuilder(dm, jker.getFractionalKernel(
        1, jker.leftRightFractionalOrder(*VECTOR_ORDERS[order]),
        derivative=d)).getDenseVector()
    _, tdm, tk = fromArrays(m.vertices, m.cells, VECTOR_ORDERS[order], 1,
                            device='cpu', derivative=d)
    At = tasm.nonlocalBuilder(tdm, tk).getDenseVector()
    return Aj, At, d


def test_vector_dense(vector5):
    Aj, At, d = vector5
    ref = np.asarray(Aj.toarray())
    got = At.toarray()
    assert got.shape == ref.shape and At.vectorSize == Aj.vectorSize
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    if d == 2:
        N, P = ref.shape[0], int(round(ref.shape[2] ** 0.5))
        H = got.reshape(N, N, P, P)
        assert np.abs(H[:, :, 0, 1] - H[:, :, 1, 0]).max() \
            <= 1e-10 * np.abs(H).max()


def test_vector_dense_apply(vector5):
    """matvec and matvecTrans (K23's plain version) on the port's operator
    and on the JAX operator's data against the JAX ones."""
    Aj, At, _ = vector5
    x = np.random.RandomState(5).randn(At.num_rows)
    Ac = denseVectorFromArrays(np.asarray(Aj.toarray()), device='cpu')
    for trans in (False, True):
        ref = np.asarray(Aj(jnp.asarray(x), trans=trans))
        for op in (At, Ac):
            got = op(torch.as_tensor(x), trans=trans).numpy()
            assert got.shape == ref.shape
            assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    A2 = (2.0 * At + At).toarray()
    np.testing.assert_allclose(A2, 3.0 * At.toarray(), rtol=1e-15, atol=0)


# ---------------------------------------------------------------- raises ---

def test_not_ported_raise():
    LR = tker.leftRightFractionalOrder(0.25, 0.75)
    with pytest.raises(NotImplementedError):
        tker.getFractionalKernel(1, 0.75, horizon=0.5, derivative=1)
    with pytest.raises(NotImplementedError):
        tker.getFractionalKernel(1, LR, horizon=0.5, derivative=1)
    with pytest.raises(NotImplementedError):
        tker.getFractionalKernel(1, 0.75, derivative=1, temperedLambda=1.0)
    # a two-point weight is a two-point function, not a bare callable
    with pytest.raises(TypeError):
        tker.getFractionalKernel(1, 0.75, derivative=1, phi=lambda x, y: 1.0)
    with pytest.raises(NotImplementedError):
        tker.getFractionalKernel(
            1, tker.constantNonSymFractionalOrder(0.25), derivative=1)
    m = _interval(3)
    _, tdm, tk = fromArrays(m.vertices, m.cells, (0.25, 0.75), 1,
                            device='cpu', derivative=1)
    # getH2Vector of a multi-parameter order and nonlocalBuilder of a
    # component kernel run (tests/test_torch_varorder_h2.py holds them to
    # the JAX package): the components' dense operators are the vector
    # operator's
    x = torch.sin(torch.arange(tdm.num_dofs, dtype=torch.float64))
    Dv = tasm.nonlocalBuilder(tdm, tk).getDenseVector()
    Hv = tasm.nonlocalBuilder(tdm, tk).getH2Vector()
    assert Hv.matvec(x).shape == Dv.matvec(x).shape == (tdm.num_dofs, 2)
    for q, kq in enumerate(tk.componentKernels()):
        Dq = tasm.nonlocalBuilder(tdm, kq).getDense().data
        assert float((Dq - Dv.data[:, :, q]).abs().max()) \
            <= 1e-12 * float(Dv.data.abs().max())
    with pytest.raises(TypeError):
        tasm.nonlocalBuilder(tdm, tk).getDense()
    d = _disc(0)
    _, ddm, dk = fromArrays(d.vertices, d.cells, (0.25, 0.75), 2,
                            device='cpu', derivative=1)
    with pytest.raises(NotImplementedError):
        tasm.nonlocalBuilder(ddm, dk).getDenseVector()


def test_quadrature_bump_matches_jax():
    """The singular rules of a derivative kernel carry 4 orders more per
    derivative, as the JAX package's (the buckets and their node counts)."""
    m = _interval(3)
    dm = jfem.P1_DoFMap(m)
    for d in (0, 1, 2):
        kj = jker.getFractionalKernel(1, 0.75, derivative=d)
        _, tdm, tk = fromArrays(m.vertices, m.cells, 0.75, 1, device='cpu',
                                derivative=d)
        rj = jasm.nonlocalBuilder(dm, kj)._makeRulesFor(-2.5, 6)
        rt = tasm.nonlocalBuilder(tdm, tk)._makeRulesFor(-2.5, 6)
        for name in ('ruleId', 'ruleVertex'):
            assert rt[name].num_nodes == rj[name].num_nodes
        sj = jasm.nonlocalBuilder(dm, kj)._makeSplitRuleFor(-2.5, 6, 1)
        st = tasm.nonlocalBuilder(tdm, tk)._makeSplitRuleFor(-2.5, 6, 1)
        np.testing.assert_array_equal(st.w, sj.w)


# ------------------------------------------------------------------- GPU ---

@pytest.mark.cuda
def test_vector_kernels_match_plain_on_gpu():
    """K21, K22 (a two-parameter derivative-2 vector build at noRef 5) and
    K23 on the card against their plain versions (needs an NVIDIA GPU)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    from pynucleus_tpu_torch.base.linear_operators import vector_matvec
    m = _interval(5)
    ops = []
    for dev in ('cuda', 'cpu'):
        _, tdm, tk = fromArrays(m.vertices, m.cells, (0.25, 0.75), 1,
                                device=dev, derivative=2)
        ops.append(tasm.nonlocalBuilder(tdm, tk).getDenseVector())
    Ag, Ac = ops
    ref = Ac.toarray()
    assert np.abs(Ag.toarray() - ref).max() <= 1e-12 * np.abs(ref).max()
    x = torch.sin(torch.arange(Ac.num_rows, dtype=torch.float64))
    for trans in (False, True):
        yg = vector_matvec(Ag.data, x.cuda(), trans=trans).cpu()
        yc = vector_matvec(Ac.data, x, trans=trans)
        assert float((yg - yc).abs().max()) <= 1e-12 * float(yc.abs().max())

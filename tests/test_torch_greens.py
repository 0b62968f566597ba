"""The complex Greens kernels and the complex branch of BiCGStab in the port
against the JAX package, on the CPU in float64.

  Bessel, profiles   besselJ0Y0 (the A&S 9.4.1-9.4.3 approximation) on the
                     500 points of tests/test_complex_kernels.py against
                     the JAX program to 1e-13 and scipy to 2e-7 (the JAX
                     bar); the greens2D and greens3D profiles against
                     _radialJax to 1e-13; the host __call__ to 1e-14
  getDense           the square at noRef 3 (49 dofs), infinite horizon and
                     horizon 0.45 (ball2, the cut pairs through K15): 1e-12
                     relative (max norm), complex symmetric to 1e-12
  getDiagonal        against JAX's getDiagonal and diag(getDense): 1e-12
  Krylov             GMRES and BiCGStab (tolerance 1e-9, maxIter 300)
                     against the JAX solvers: iterations equal, x to 1e-10
                     (GMRES) and 1e-8 (BiCGStab); complex LU
  plain versions     K1's complex dense and diagonal targets against
                     _bucket_contrib, K15's complex variant against
                     _bucket_cut2d_polar (both scattered with np.add.at),
                     K18's complex passes against numpy's expressions:
                     1e-13
  refusals           3D, greens3D assembly, the boundary kernel, getSparse,
                     getH2 and getDenseCross of a complex kernel
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.special import j0 as sj0, y0 as sy0

from pynucleus_tpu.fem import meshFactory, dofmapFactory
from pynucleus_tpu.nl.kernels import (_bessel_j0y0,
                                      getComplexKernel as jComplexKernel,
                                      GREENS_2D as jG2, GREENS_3D as jG3)
from pynucleus_tpu.nl.assembly import (nonlocalBuilder as jBuilder,
                                       _bucket_contrib, _bucket_cut2d_polar)
from pynucleus_tpu.nl.panels import classifyPairsDense as jClassify
from pynucleus_tpu.base.solvers import solverFactory as jSolvers

from pynucleus_tpu_torch import kernels
from pynucleus_tpu_torch.base import solvers as tsol
from pynucleus_tpu_torch.interop import fromArrays
from pynucleus_tpu_torch.nl import assembly as tasm
from pynucleus_tpu_torch.nl import kernels as tk
from pynucleus_tpu_torch.nl.quad_singular import distantRule
from pynucleus_tpu_torch.fem.quadrature import simplexDuffy, gauss01

LAM = -3.0j          # wavenumber 3
NOREF = 3            # 128 cells, 49 dofs
HORIZONS = (np.inf, 0.45)


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _jaxSquare(noRef):
    m = meshFactory('square', N=2, ax=0, ay=0, bx=1, by=1)
    for _ in range(noRef):
        m = m.refine()
    return m, dofmapFactory('P1', m)


def _portSquare(m, horizon, device='cpu'):
    return fromArrays(np.asarray(m.vertices), np.asarray(m.cells), 0.0, 2,
                      device=device, kernelType='greens2D',
                      greensLambda=LAM, horizon=horizon)


@pytest.fixture(scope='module', params=HORIZONS, ids=['inf', 'h045'])
def greens(request):
    """The JAX and the port's dense operators and diagonals of greens2D on
    the square at noRef 3, for one horizon."""
    hor = request.param
    m, dm = _jaxSquare(NOREF)
    kj = jComplexKernel(2, kernel=jG2, greensLambda=LAM, horizon=hor,
                        scaling=1.0)
    Aj = jBuilder(dm, kj).getDense()
    dj = np.asarray(jBuilder(dm, kj).getDiagonal().diagonal)
    _, tdm, kt = _portSquare(m, hor)
    bt = tasm.nonlocalBuilder(tdm, kt)
    return {'hor': hor, 'Aj': Aj, 'dj': dj, 'At': bt.getDense(),
            'dt': bt.getDiagonal().diagonal.numpy(), 'dm': dm, 'kj': kj,
            'mesh': m, 'tdm': tdm, 'kt': kt}


# --------------------------------------------------------------- kernel ---

def test_bessel_matches_jax_program():
    x = np.concatenate([np.linspace(1e-3, 3, 200), np.linspace(3, 60, 300)])
    Jj, Yj = (np.asarray(a) for a in _bessel_j0y0(jnp.asarray(x)))
    Jt, Yt = (a.numpy() for a in tk.besselJ0Y0(torch.as_tensor(x)))
    assert np.abs(Jt - Jj).max() <= 1e-13
    assert np.abs(Yt - Yj).max() <= 1e-13
    # the approximation, as the JAX bar holds it (not tighter)
    assert np.abs(Jt - sj0(x)).max() < 2e-7
    assert np.abs(Yt - sy0(x)).max() < 2e-7


@pytest.mark.parametrize('dim,kind,lam,scaling', [
    (2, 'greens2D', -7.0j, 0.25), (2, 'greens2D', LAM, 1.0),
    (3, 'greens3D', 1.0 + 4.0j, 1.0), (3, 'greens3D', 0.5 + 2.0j, 0.3)])
def test_radial_profiles_match_radialJax(dim, kind, lam, scaling):
    kj = jComplexKernel(dim, kernel={'greens2D': jG2, 'greens3D': jG3}[kind],
                        greensLambda=lam, scaling=scaling)
    kt = tk.getComplexKernel(dim, kernel=kind, greensLambda=lam,
                             scaling=scaling)
    r2 = np.random.RandomState(3).rand(2000) * 4.0
    r2[:5] = 0.0
    r2j = jnp.asarray(r2)
    ref = np.asarray(jnp.where(r2j > 0, kj._radialJax(
        jnp.where(r2j > 0, r2j, 1.0)), 0.0))
    got = tk.radialEval(torch.as_tensor(r2), kt.profileParams()).numpy()
    assert got.dtype == np.complex128
    assert _rel(got, ref) <= 1e-13
    assert np.all(got[:5] == 0)


def test_host_call_and_attributes_match_jax():
    rng = np.random.RandomState(4)
    for dim, kind, jkind, lam, hor in ((2, 'greens2D', jG2, -7.0j, np.inf),
                                       (2, 'greens2D', jG2, LAM, 0.45),
                                       (3, 'greens3D', jG3, 1.0 + 4.0j,
                                        np.inf)):
        kj = jComplexKernel(dim, kernel=jkind, greensLambda=lam, horizon=hor,
                            scaling=0.25)
        kt = tk.getKernel(dim, kernel=kind, greensLambda=lam, horizon=hor,
                          scaling=0.25)
        assert isinstance(kt, tk.ComplexKernel) and kt.isComplex
        assert kt.singularityValue == kj.singularityValue
        assert kt.finiteHorizon == kj.finiteHorizon
        assert type(kt.interaction).__name__ == \
            type(kj.interaction).__name__
        for _ in range(20):
            x, y = rng.rand(dim), rng.rand(dim)
            ref = kj(x, y)
            got = kt(x, y)
            assert isinstance(got, complex)
            assert abs(got - ref) <= 1e-14 * max(abs(ref), 1e-300)
        with pytest.raises(NotImplementedError):
            kt.getBoundaryKernel()
    # a two-point weight is a two-point function
    with pytest.raises(TypeError):
        tk.getComplexKernel(2, greensLambda=LAM, phi=object())


# ------------------------------------------------------------- operators ---

def test_dense_matches_jax(greens):
    Aj = np.asarray(greens['Aj'].toarray())
    At = greens['At'].data.numpy()
    assert At.dtype == np.complex128 and At.shape == (49, 49)
    assert _rel(At, Aj) <= 1e-12
    assert np.abs(At - At.T).max() <= 1e-12 * np.abs(At).max()
    assert np.abs(At.imag).max() > 1e-3


def test_diagonal_matches_jax_and_dense(greens):
    dt, dj = greens['dt'], greens['dj']
    assert dt.dtype == np.complex128
    assert _rel(dt, dj) <= 1e-12
    assert _rel(dt, np.diag(greens['At'].data.numpy())) <= 1e-12


@pytest.mark.parametrize('name,tol', [('gmres', 1e-10), ('bicgstab', 1e-8)])
def test_krylov_matches_jax(greens, name, tol):
    """The load of tests/test_complex_kernels.py:141-142; tolerance 1e-9,
    maxIter 300, no preconditioner."""
    n = greens['At'].num_rows
    b = np.random.RandomState(0).rand(n) \
        + 1j * np.random.RandomState(1).rand(n)
    sj = jSolvers.build(name, A=greens['Aj'], setup=True)
    sj.tolerance, sj.maxIter = 1e-9, 300
    xj = np.asarray(sj.solve(jnp.asarray(b)))
    st = tsol.solverFactory.build(name, A=greens['At'], setup=True)
    st.tolerance, st.maxIter = 1e-9, 300
    xt = st.solve(torch.as_tensor(b))
    assert xt.dtype == torch.complex128
    assert st.iterations == sj.iterations
    assert np.linalg.norm(xt.numpy() - xj) <= tol * np.linalg.norm(xj)
    res = np.linalg.norm(greens['At'].data.numpy() @ xt.numpy() - b)
    assert res <= 1e-7 * np.linalg.norm(b)


def test_lu_solves_a_complex_dense_operator(greens):
    A = greens['At']
    b = np.random.RandomState(2).rand(A.num_rows) + 1j
    x = tsol.solverFactory.build('lu', A=A, setup=True).solve(
        torch.as_tensor(b)).numpy()
    assert _rel(x, np.linalg.solve(A.data.numpy(), b)) <= 1e-12


@pytest.mark.parametrize('dim', [1, 2], ids=['interval', 'square'])
def test_real_finite_horizon_diagonal_is_the_dense_one(dim):
    """getDiagonal of a real kernel on the per-pair path (a finite horizon:
    K1's and K14's or K15's real diagonal targets) is diag(getDense); so is
    a real kernel's of an infinite horizon with its exterior term (every
    surface pair through K1's diagonal target) against getDense without
    the grid."""
    if dim == 1:
        from pynucleus_tpu_torch.fem.meshes import simpleInterval
        m = simpleInterval(-1.0, 1.0)
        for _ in range(5):
            m = m.refine()
    else:
        m, _ = _jaxSquare(2)
    _, dm, k = fromArrays(np.asarray(m.vertices), np.asarray(m.cells), 0.75,
                          dim, device='cpu', kernelType='constant',
                          horizon=0.45 if dim == 2 else 0.2)
    b = tasm.nonlocalBuilder(dm, k)
    d = b.getDiagonal().diagonal.numpy()
    assert d.dtype == np.float64
    assert _rel(d, np.diag(b.getDense().data.numpy())) <= 1e-13
    _, dm, k = fromArrays(np.asarray(m.vertices), np.asarray(m.cells), 0.75,
                          dim, device='cpu')
    d = tasm.nonlocalBuilder(dm, k).getDiagonal().diagonal.numpy()
    D = tasm.nonlocalBuilder(dm, k, params={'denseGrid': False}).getDense()
    assert _rel(d, np.diag(D.data.numpy())) <= 1e-13


def test_complex_refusals():
    m, _ = _jaxSquare(1)
    _, dm, kt = _portSquare(m, 0.45)
    b = tasm.nonlocalBuilder(dm, kt)
    assert b.zeroExterior is False
    for what in ('getSparse', 'getH2', 'getDenseCross'):
        with pytest.raises(NotImplementedError, match='complex'):
            getattr(b, what)()
    # greens3D: no assembly (3D meshes, and its kernel on a 2D mesh)
    with pytest.raises(NotImplementedError):
        fromArrays(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1.0]]),
                   np.array([[0, 1, 2, 3]]), 0.0, 3, device='cpu',
                   kernelType='greens3D', greensLambda=1 + 4j)
    with pytest.raises(NotImplementedError, match='greens2D'):
        tasm.nonlocalBuilder(dm, tk.ComplexKernel(3, 'greens3D'))
    # a complex profile needs a complex128 target, and the reverse
    A = torch.zeros((dm.num_dofs,) * 2, dtype=torch.float64)
    args = _k1Args(dm, kt, 'cpu')
    with pytest.raises(ValueError, match='complex128'):
        tasm.panel_scatter(A, *args)


# -------------------------------------------------------- plain versions ---

def _k1Args(dm, kt, device):
    """K1's arguments for 40 cell pairs of dm's mesh under an order-4
    distant rule (a few identical cells: repeated dofs, coincident nodes),
    on ``device``."""
    mesh = dm.mesh
    rng = np.random.RandomState(5)
    C = mesh.num_cells
    ii = rng.randint(0, C, 40)
    jj = rng.randint(0, C, 40)
    jj[:6] = ii[:6]
    rule = distantRule(4, 2)
    PSI = rule.buildPSI(dm, nSharedVertices=0)
    cells, dofs = mesh.cells, dm.dofs
    vols = mesh.simplexVolumes()

    def t(a, dt=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)
    return (t(mesh.vertices), t(cells[ii], torch.int64),
            t(cells[jj], torch.int64),
            t(np.concatenate([dofs[ii], dofs[jj]], axis=1), torch.int64),
            t(vols[ii] * vols[jj] * 2.0), None, t(rule.bary_x),
            t(rule.bary_y), t(rule.w), t(tasm._psi_prod(PSI)),
            kt.profileParams(), kt.indicatorParams())


def _scatterRef(N, dr, M):
    """np.add.at of local matrices M [P, n*n] at dofRows dr [P, n] into a
    dense [N+1, N+1] dump-slot accumulator and a diagonal, as the JAX
    DenseAccumulator and _DiagAccumulator add them."""
    P, n = dr.shape
    rows = np.repeat(dr, n, axis=1).reshape(-1)
    cols = np.tile(dr, (1, n)).reshape(-1)
    A = np.zeros((N + 1, N + 1), dtype=M.dtype)
    np.add.at(A, (np.where(rows >= 0, rows, N), np.where(cols >= 0, cols, N)),
              M.reshape(-1))
    d = np.zeros(N, dtype=M.dtype)
    sel = (rows == cols) & (rows >= 0)
    np.add.at(d, rows[sel], M.reshape(-1)[sel])
    return A[:N, :N], d


@pytest.mark.parametrize('hor', HORIZONS, ids=['inf', 'h045'])
def test_k1_complex_plain_matches_bucket_contrib(hor):
    m, dmj = _jaxSquare(2)
    _, dm, kt = _portSquare(m, hor)
    kj = jComplexKernel(2, kernel=jG2, greensLambda=LAM, horizon=hor)
    (V, vi1, vi2, dr, vs, _, bx, by, w, PSIP, prof, ind) = \
        args = _k1Args(dm, kt, 'cpu')
    M = np.asarray(_bucket_contrib(
        jnp.asarray(V.numpy()), jnp.asarray(vi1.numpy()),
        jnp.asarray(vi2.numpy()), jnp.asarray(vs.numpy()),
        jnp.asarray(bx.numpy()), jnp.asarray(by.numpy()),
        jnp.asarray(w.numpy()), jnp.asarray(PSIP.numpy()), kernel=kj))
    N = dm.num_dofs
    Aref, dref = _scatterRef(N, dr.numpy(), M)
    A = torch.zeros((N, N), dtype=torch.complex128)
    tasm.panel_scatter(A, *args[:-2], prof, indicator=ind)
    d = torch.zeros(N, dtype=torch.complex128)
    tasm.panel_scatter_diag(d, *args[:-2], prof, indicator=ind)
    assert _rel(A.numpy(), Aref) <= 1e-13
    assert _rel(d.numpy(), dref) <= 1e-13
    assert np.abs(dref).max() > 0


def _k15Args(m, dm, kt, device, P=40, order=8):
    """K15's arguments for the first P cut pairs of the JAX classification
    (ball2, horizon 0.45) under the rules of an order-``order`` bucket."""
    info = jClassify(dofmapFactory('P1', m), jComplexKernel(
        2, kernel=jG2, greensLambda=LAM, horizon=0.45))
    ci, cj, _ = info['cut']
    ci, cj = np.asarray(ci)[:P], np.asarray(cj)[:P]
    mesh = dm.mesh
    oX = max(order // 2, 4)
    bary_x, wx = simplexDuffy(oX, 2)
    thetas, wtheta = gauss01(max(order // 2 + 2, 6))
    rq, wr = gauss01(max(order // 2, 4))

    def t(a, dt=torch.float64):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)
    dr = np.concatenate([dm.dofs[ci], dm.dofs[cj]], axis=1)
    return (t(dr, torch.int64), t(mesh.vertices),
            t(mesh.cells[ci], torch.int64), t(mesh.cells[cj], torch.int64),
            t(mesh.simplexVolumes()[ci]), t(bary_x.T), t(wx), t(thetas),
            t(wtheta), t(rq), t(wr), 0.45, 1, kt.profileParams())


def test_k15_complex_plain_matches_bucket_cut2d_polar():
    m, dmj = _jaxSquare(2)
    _, dm, kt = _portSquare(m, 0.45)
    kj = jComplexKernel(2, kernel=jG2, greensLambda=LAM, horizon=0.45)
    args = _k15Args(m, dm, kt, 'cpu')
    dr, V, vi1, vi2, vols, bx, wx, th, wth, rq, wr = \
        (a.numpy() for a in args[:11])
    assert len(dr) == 40
    M = np.asarray(_bucket_cut2d_polar(
        jnp.asarray(V), jnp.asarray(vi1), jnp.asarray(vi2),
        jnp.asarray(vols), jnp.asarray(bx), jnp.asarray(wx),
        jnp.asarray(th), jnp.asarray(wth), jnp.asarray(rq), jnp.asarray(wr),
        jnp.asarray(dmj.evalPhi.monomialExps, dtype=jnp.float64),
        jnp.asarray(dmj.evalPhi.Vinv), 0.45, kernel=kj, dpe=3))
    N = dm.num_dofs
    Aref, dref = _scatterRef(N, dr, M)
    for target, ref in (('dense', Aref), ('diag', dref)):
        out = torch.zeros((N, N) if target == 'dense' else (N,),
                          dtype=torch.complex128)
        tasm.cut2d_polar(out, target, *args)
        assert _rel(out.numpy(), ref) <= 1e-13
    with pytest.raises(ValueError, match='dense and the diagonal'):
        tasm.cut2d_polar(torch.zeros(N + 1, dtype=torch.complex128),
                         'slots', *args)


def _crandn(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


def test_k18_complex_plain_matches_numpy():
    """One complex BiCGStab iteration's passes (iteration 1: rho in slot
    1) against numpy's expressions with np.vdot (conjugated dots)."""
    rng = np.random.default_rng(6)
    n = 40
    x, r, r0, p, v, s, t = (_crandn(rng, n) for _ in range(7))
    rho, alpha, omega = 0.7 - 0.2j, 1.3 + 0.4j, 0.4 - 0.9j
    X, R, R0, Pt, Vt, S, T = (torch.as_tensor(a.copy())
                              for a in (x, r, r0, p, v, s, t))
    scal = torch.tensor([0.0, rho, alpha, omega, 0.0],
                        dtype=torch.complex128)
    args = (X, R, R0, Pt, Vt, S, T, Pt, S)
    tsol.bicgstab_update('direction', *args, scal, 1)
    rho_new = np.vdot(r0, r)
    pn = r + (rho_new / rho) * (alpha / omega) * (p - omega * v)
    assert _rel(Pt.numpy(), pn) <= 1e-13
    assert abs(complex(scal[0]) - rho_new) <= 1e-13 * abs(rho_new)
    assert abs(complex(scal[4]) - np.linalg.norm(r)) <= \
        1e-13 * np.linalg.norm(r)
    tsol.bicgstab_update('step', *args, scal, 1)
    an = rho_new / np.vdot(r0, v)
    sn = r - an * v
    assert _rel(S.numpy(), sn) <= 1e-13
    assert abs(complex(scal[2]) - an) <= 1e-13 * abs(an)
    tsol.bicgstab_update('update', *args, scal, 1)
    on = np.vdot(t, sn) / np.vdot(t, t)
    assert _rel(X.numpy(), x + an * pn + on * sn) <= 1e-13
    assert _rel(R.numpy(), sn - on * t) <= 1e-13
    assert abs(complex(scal[3]) - on) <= 1e-13 * abs(on)
    with pytest.raises(ValueError, match='complex128'):
        tsol.bicgstab_update('step', *args[:-1], S.real.contiguous(), scal, 1)


# ------------------------------------------------------------- the card ---

@pytest.mark.cuda
def test_complex_kernels_match_plain_on_gpu():
    """K1's complex dense and diagonal targets, K15's complex variant and
    K18's on the card against their plain versions on the same tensors
    (needs an NVIDIA GPU)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    m, _ = _jaxSquare(2)
    _, dm, kt = _portSquare(m, 0.45, device='cuda')
    N = dm.num_dofs
    args = _k1Args(dm, kt, 'cuda')
    kernels.resetLaunches()
    for fn, plain, shape in ((tasm.panel_scatter, tasm._panel_scatter_plain,
                              (N, N)),
                             (tasm.panel_scatter_diag,
                              tasm._panel_scatter_diag_plain, (N,))):
        a = torch.zeros(shape, dtype=torch.complex128, device='cuda')
        b = torch.zeros_like(a)
        fn(a, *args[:-2], args[-2], indicator=args[-1])
        plain(b, *args[:-2], args[-2], indicator=args[-1])
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
    cargs = _k15Args(m, dm, kt, 'cuda')
    for target, shape in (('dense', (N, N)), ('diag', (N,))):
        a = torch.zeros(shape, dtype=torch.complex128, device='cuda')
        b = torch.zeros_like(a)
        tasm.cut2d_polar(a, target, *cargs)
        tasm._cut2d_polar_plain(b, target, *cargs)
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
    rng = np.random.default_rng(7)
    n = 5000
    vecs = [torch.as_tensor(_crandn(rng, n), device='cuda')
            for _ in range(7)]
    scal = torch.tensor([0.0, 0.7 - 0.2j, 1.3 + 0.4j, 0.4 - 0.9j, 0.0],
                        dtype=torch.complex128, device='cuda')
    kv, pv = [v.clone() for v in vecs], [v.clone() for v in vecs]
    ks, ps = scal.clone(), scal.clone()
    for mode in tsol.BICGSTAB_MODES:
        tsol.bicgstab_update(mode, *kv, kv[3], kv[5], ks, 1)
        tsol._bicgstab_update_plain(mode, *pv, pv[3], pv[5], ps, 1)
    for a, b in zip(kv + [ks], pv + [ps]):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())
    for name in ('panel_scatter:complex', 'panel_scatter:complex_diag',
                 'cut2d_polar:complex', 'bicgstab_update:complex'):
        assert kernels.launches[name] > 0


@pytest.mark.cuda
@pytest.mark.parametrize('dim', [1, 2])
def test_real_diagonal_targets_match_plain_on_gpu(dim, monkeypatch):
    """K1's, K14's (1D) and K15's (2D) real diagonal targets on the card:
    getDiagonal of the constant kernel of a finite horizon against
    diag(getDense), and each of its kernel calls against the plain version
    on the same tensors (needs an NVIDIA GPU)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    if dim == 1:
        from pynucleus_tpu_torch.fem.meshes import simpleInterval
        m = simpleInterval(-1.0, 1.0)
        for _ in range(5):
            m = m.refine()
    else:
        m, _ = _jaxSquare(2)
    _, dm, k = fromArrays(np.asarray(m.vertices), np.asarray(m.cells), 0.75,
                          dim, device='cuda', kernelType='constant',
                          horizon=0.45 if dim == 2 else 0.2)
    cut = 'cut1d' if dim == 1 else 'cut2d_polar'
    calls = {'panel_scatter_diag': [], cut: []}
    for name in calls:
        def rec(out, *a, _f=getattr(tasm, name), _n=name, **kw):
            calls[_n].append((out.shape, [t.clone() if torch.is_tensor(t)
                                          else t for t in a], dict(kw)))
            return _f(out, *a, **kw)
        monkeypatch.setattr(tasm, name, rec)
    b = tasm.nonlocalBuilder(dm, k)
    d = b.getDiagonal().diagonal
    dA = torch.diagonal(b.getDense().data)
    assert float((d - dA).abs().max()) <= 1e-12 * float(dA.abs().max())
    monkeypatch.undo()
    for name, cs in calls.items():
        cs = [c for c in cs if name == 'panel_scatter_diag'
              or c[1][0] == 'diag']
        assert cs, name
        for shape, a, kw in cs:
            got = torch.zeros(shape, dtype=torch.float64, device='cuda')
            ref = torch.zeros_like(got)
            getattr(tasm, name)(got, *a, **kw)
            getattr(tasm, f'_{name}_plain')(ref, *a, **kw)
            assert float((got - ref).abs().max()) <= \
                1e-12 * float(ref.abs().max())

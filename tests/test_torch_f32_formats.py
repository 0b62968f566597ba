"""The float32 formats of the finite horizon and the smooth kernels in the
port (``params={'dtype': np.float32}``) against the JAX package's float32
programs, on the same meshes.  On the CPU the port runs the plain float32
versions of K1 (into a float32 dense A with the indicator, into the
float64 A_BC, with the complement indicator and the block mask into a
float64 dense A, with every ported profile into its targets), K2 and K3
(with the profiles); the cut pairs run K14 and K15 in float64 in both
packages.

  getDense       a constant finite horizon (indicator, peridynamic,
                 truncated fractional; ball2, ballInf, ball1, the
                 ellipse) on runNonlocal's interval at noRef 6 and square at
                 noRef 1 (the other interactions and the peridynamic
                 kernel at noRef 0): float32 entries within 5e-6 of the
                 largest, the
                 apply within 1e-5; where no pair but a cut one reaches an
                 entry it rounds once (fl32 of the float64 sum), as the JAX
                 DenseAccumulator's
  sparsified     the same operators: a float32 CSR of the JAX pattern
  getDenseCross  A_BC float64, within 5e-6 of the largest entry
  H2corrected    S_inf float32, Cross and the apply float64 (a float32 or
                 float64 x), 1e-5 of max|y|; the diagonal float64; CG-Jacobi
                 iterations within 2 of the JAX package's
  profiles       the gaussian, exponential, tempered, smooth and host
                 two-point, log-inverse-distance, monomial and polynomial
                 kernels: getDense per pair and on the grid, getSparse and
                 getDiagonal (float64) on the tiny interval and the square
                 at noRef 1
  formerly       the five float32 cases that the port used to refuse
  refused        (getDenseCross, H2corrected, getDense of a finite horizon,
                 sparsified, the gaussian kernel's getDense), each on its
                 tiny interval
"""
import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.fem import meshFactory, dofmapFactory
from pynucleus_tpu.nl import kernels as jk
from pynucleus_tpu.nl.assembly import (nonlocalBuilder as jBuilder,
                                       assembleNonlocal as jAssemble)
from pynucleus_tpu.nl.problems import nonlocalMeshFactory, DIRICHLET
from pynucleus_tpu.base.solvers import solverFactory as jSolvers

from pynucleus_tpu_torch import kernels
from pynucleus_tpu_torch.base.linear_operators import CSR_LinearOperator
from pynucleus_tpu_torch.base.solvers import solverFactory
from pynucleus_tpu_torch.fem.assembly import assembleMass
from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
from pynucleus_tpu_torch.fem.meshes import simplexMesh
from pynucleus_tpu_torch.interop import fromArrays, builderFromArrays
from pynucleus_tpu_torch.nl import kernels as tk
from pynucleus_tpu_torch.nl.assembly import (nonlocalBuilder,
                                             assembleNonlocal,
                                             horizonCorrected)

TOL = 5e-6          # float32 entries, of the largest
TOL_APPLY = 1e-5    # float32 applies, of max|y|
F32 = {'dtype': np.float32}
HORIZON = 0.2


@pytest.fixture(autouse=True, scope='module')
def _twoTorchThreads():
    """Two torch threads: the operators are small, and the workers of a
    parallel test run share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, ref):
    ref = np.asarray(ref, dtype=np.float64)
    scale = np.abs(ref).max()
    assert scale > 0
    return float(np.abs(np.asarray(got, dtype=np.float64) - ref).max()
                 / scale)


def _x(n, dtype=np.float32):
    return np.random.default_rng(23).standard_normal(n).astype(dtype)


def _applies(At, Aj, n):
    """The relative gap of the two operators' applies on a seeded float32
    x (numpy results)."""
    x = _x(n)
    yt = At.matvec(torch.as_tensor(x)).numpy()
    yj = np.asarray(Aj @ jnp.asarray(x))
    return _rel(yt, yj)


# ------------------------------------------------------- finite horizon --

INTERACTIONS = {'ball2': (jk.ball2, ()), 'ballInf': (jk.ballInf, ()),
                'ball1': (jk.ball1, ()),
                'ellipse': (jk.ellipse, (1.0, 0.5, 0.3))}
KINDS = {'constant': 'indicator', 'inverseDistance': 'peridynamic'}

# (domain, noRef, port kernelType, interaction): the other interactions and
# kernels of the square at noRef 0 (their JAX programs compile apart)
FINITE = {'interval-indicator': ('interval', 6, 'constant', 'ball2'),
          'interval-fractional': ('interval', 6, 'fractional', 'ball2'),
          'square-indicator': ('square', 1, 'constant', 'ball2'),
          'square-ballInf': ('square', 0, 'constant', 'ballInf'),
          'square-ball1': ('square', 0, 'constant', 'ball1'),
          'square-peridynamic': ('square', 0, 'inverseDistance', 'ball2'),
          'square-ellipse': ('square', 0, 'constant', 'ellipse')}


def _jaxFinite(dim, kernelType, interaction):
    inter, args = INTERACTIONS[interaction]
    if kernelType == 'fractional':
        return jk.getFractionalKernel(dim, 0.4, horizon=HORIZON,
                                      interaction=inter(*args))
    return jk.getIntegrableKernel(dim, KINDS[kernelType], HORIZON,
                                  interaction=inter(*args),
                                  **({'normalized': False}
                                     if interaction == 'ellipse' else {}))


_FINITE = {}


def _finite(case):
    """runNonlocal's mesh of the case (its collar of the horizon), the JAX
    float32 builder and the port's on the same arrays (made once)."""
    if case in _FINITE:
        return _FINITE[case]
    domain, noRef, kernelType, interaction = FINITE[case]
    dim = {'interval': 1, 'square': 2}[domain]
    k = _jaxFinite(dim, kernelType, interaction)
    mesh, info = nonlocalMeshFactory.build(domain, kernel=k,
                                           boundaryCondition=DIRICHLET)
    for _ in range(noRef):
        mesh = mesh.refine()
    dm = jfem.P1_DoFMap(mesh, tag=info['domain'])
    interior = np.zeros(mesh.num_vertices, dtype=bool)
    c, loc = np.nonzero(dm.dofs >= 0)
    interior[mesh.cells[c, loc]] = True
    inter = interaction if interaction != 'ellipse' else \
        ('ellipse',) + INTERACTIONS['ellipse'][1]
    _, tdm, tkern = fromArrays(
        mesh.vertices, mesh.cells, 0.4, dim, device='cpu',
        kernelType=kernelType, horizon=HORIZON, interaction=inter,
        interior=interior,
        **({'normalized': False} if interaction == 'ellipse' else {}))
    out = _FINITE[case] = dict(dm=dm, k=k, tdm=tdm, tk=tkern)
    return out


def _jaxDense(d):
    if 'Aj' not in d:
        d['Aj'] = jBuilder(d['dm'], d['k'], params=F32).getDense()
    return d['Aj']


@pytest.mark.parametrize('case', list(FINITE))
def test_dense_finite_horizon_matches_jax(case):
    """getDense of a finite horizon in float32: K1's float32 entries with
    the indicator, the cut pairs' float64 ones added with one rounding."""
    d = _finite(case)
    Aj = _jaxDense(d)
    At = nonlocalBuilder(d['tdm'], d['tk'], params=dict(F32)).getDense()
    assert At.data.dtype == torch.float32
    aj = np.asarray(Aj.toarray())
    assert aj.dtype == np.float32
    assert _rel(At.toarray(), aj) <= TOL
    assert _applies(At, Aj, aj.shape[0]) <= TOL_APPLY


def test_dense_cut_pairs_round_once():
    """The entries that the cut pairs alone reach (K1's float32 part is 0
    there) add K14's float64 entries one at a time, each sum rounded once
    to float32: bit for bit the JAX DenseAccumulator's np.add.at into its
    float32 array, and within a float32 rounding per entry added of the
    port's float64 operator."""
    d = _finite('interval-indicator')
    At = nonlocalBuilder(d['tdm'], d['tk'], params=dict(F32)).getDense() \
        .toarray()
    A64 = nonlocalBuilder(d['tdm'], d['tk']).getDense().toarray()
    aj = np.asarray(_jaxDense(d).toarray())
    # the entries of no identical, touching or distant pair: beyond the
    # reach of every whole cell pair, within the horizon of a cut one
    x = d['tdm'].getDoFCoordinates()[:, 0]
    dist = np.abs(x[:, None] - x[None, :])
    h = np.diff(np.sort(x)).max()
    only = (dist > HORIZON + h) & (At != 0)
    assert only.any()
    np.testing.assert_array_equal(At[only], aj[only])
    # each entry here takes at most 8 cut-pair entries (2 x 2 cells, both
    # orderings), each added with one rounding of at most half an ulp
    ulp = np.spacing(np.abs(At[only]).astype(np.float32)).astype(np.float64)
    assert (np.abs(At[only] - A64[only]) <= 4.0 * ulp).all()


def test_cut_scatter_rounds_each_entry():
    """The plain float32 dense target of K14 and K15 adds each float64
    value with one rounding, in the order given: bit for bit numpy's
    np.add.at into a float32 array (the JAX DenseAccumulator), repeated
    entries included, and dofs < 0 dropped."""
    from pynucleus_tpu_torch.nl.assembly import _cutScatterPlain
    rng = np.random.default_rng(23)
    P, n, N = 40, 4, 9
    index = rng.integers(-1, N, size=(P, n))
    M = rng.standard_normal((P, n * n)) * (1.0 + 1e-9 * rng.random((P, 1)))
    A0 = rng.standard_normal((N, N)).astype(np.float32)
    At = torch.tensor(A0)
    _cutScatterPlain(At, 'dense', torch.tensor(index), torch.tensor(M), n)
    rows = np.repeat(index[:, :, None], n, 2).reshape(-1)
    cols = np.repeat(index[:, None, :], n, 1).reshape(-1)
    ok = (rows >= 0) & (cols >= 0)
    Aj = A0.copy()
    np.add.at(Aj, (rows[ok], cols[ok]), M.reshape(-1)[ok])
    np.testing.assert_array_equal(At.numpy(), Aj)
    # the float64 sums rounded once differ: the test can tell them apart
    Ao = (A0.astype(np.float64) + np.bincount(
        rows[ok] * N + cols[ok], M.reshape(-1)[ok], N * N).reshape(N, N)) \
        .astype(np.float32)
    assert (Ao != Aj).any()


@pytest.mark.parametrize('case', ['interval-indicator', 'square-indicator',
                                  'square-ballInf'])
def test_sparsified_matches_jax(case):
    """'sparsified' in float32: a float32 CSR of the dense operator's
    nonzero entries, the pattern and data of the JAX package's (its
    getDense with trySparsification: scipy's csr_matrix of the float32
    dense array, formed here from the JAX float32 getDense; the tiny
    interval's case below runs the JAX call itself)."""
    d = _finite(case)
    aj = np.asarray(_jaxDense(d).toarray())
    assert np.count_nonzero(aj) < 0.9 * aj.size
    Sj = sp.csr_matrix(aj)
    St = assembleNonlocal(d['tdm'], d['tk'], matrixFormat='sparsified',
                          params=dict(F32))
    assert isinstance(St, CSR_LinearOperator)
    assert St.data.dtype == torch.float32 and Sj.dtype == np.float32
    np.testing.assert_array_equal(St.indptrH, Sj.indptr)
    np.testing.assert_array_equal(St.indicesH, Sj.indices)
    assert _rel(St.dataH, Sj.data) <= TOL
    assert _applies(St, _jaxDense(d), St.num_rows) <= TOL_APPLY


@pytest.mark.parametrize('case', ['interval-indicator', 'square-ball1'])
def test_dense_cross_matches_jax(case):
    """getDenseCross in float32: A_BC float64 (the JAX BCAccumulator), K1's
    float32 entries summed in it, the cut pairs' float64 ones."""
    d = _finite(case)
    Cj = jBuilder(d['dm'], d['k'], params=F32,
                  dm2=d['dm'].getComplementDoFMap()).getDenseCross()
    Ct = nonlocalBuilder(d['tdm'], d['tk'], params=dict(F32)).getDenseCross()
    cj = np.asarray(Cj.toarray())
    assert cj.dtype == np.float64 and Ct.data.dtype == torch.float64
    assert Ct.toarray().shape == cj.shape
    assert _rel(Ct.toarray(), cj) <= TOL


# ---------------------------------------------------------- H2corrected --

def _h2cSetups(domain, noRef):
    """(JAX dofmap, JAX kernel, port dofmap, port kernel): the fractional
    kernel of order 0.25 and horizon 0.4 on nonlocalMesh's domain with its
    collar, refined noRef times."""
    from pynucleus_tpu.nl.problems import HOMOGENEOUS_DIRICHLET as J_HD
    from pynucleus_tpu_torch.nl.problems import (nonlocalMesh,
                                                 HOMOGENEOUS_DIRICHLET)
    dim = 1 if domain == 'interval' else 2
    k = jk.getFractionalKernel(dim, 0.25, horizon=0.4)
    mesh, nI = nonlocalMeshFactory.build(
        domain, kernel=k, boundaryCondition=J_HD,
        **({'a': -1, 'b': 1} if domain == 'interval' else {}))
    for _ in range(noRef):
        mesh = mesh.refine()
    kt = tk.getFractionalKernel(dim, 0.25, horizon=0.4)
    tmesh, info = nonlocalMesh(domain, kt, HOMOGENEOUS_DIRICHLET)
    for _ in range(noRef):
        tmesh = tmesh.refine()
    tdm = P1_DoFMap(tmesh, tag=info['domain'], device='cpu')
    jdm = jfem.P1_DoFMap(mesh, tag=nI['domain'])
    assert np.array_equal(np.asarray(jdm.dofs), tdm.dofs)
    return jdm, k, tdm, kt


@pytest.mark.parametrize('domain,noRef', [('interval', 3), ('square', 1)])
def test_h2corrected_matches_jax(domain, noRef):
    """H2corrected in float32: S_inf the float32 getH2, Cross float64 (its
    float32 local entries summed in float64, masked to the off-diagonal
    blocks), the apply and the diagonal float64 with the JAX dtypes."""
    jdm, jkern, tdm, kt = _h2cSetups(domain, noRef)
    Aj = jAssemble(jdm, jkern, matrixFormat='H2corrected', params=F32)
    At = assembleNonlocal(tdm, kt, matrixFormat='H2corrected',
                          params=dict(F32))
    assert isinstance(At, horizonCorrected)
    assert (At.facS, At.c_tot) == (Aj.facS, Aj.c_tot)
    assert At.Sinf.dtype == torch.float32
    cj = np.asarray(Aj.Cross.toarray())
    assert cj.dtype == np.float64 and At.Cross.data.dtype == torch.float64
    assert _rel(At.Cross.toarray(), cj) <= TOL
    for dt in (np.float32, np.float64):
        x = _x(tdm.num_dofs, dt)
        yt = At.matvec(torch.as_tensor(x))
        yj = np.asarray(Aj.matvec(jnp.asarray(x)))
        assert yt.dtype == torch.float64 and yj.dtype == np.float64
        assert _rel(yt.numpy(), yj) <= TOL_APPLY, dt
    dt_, dj = At.diagonal, np.asarray(Aj.diagonal)
    assert dt_.dtype == torch.float64 and dj.dtype == np.float64
    assert _rel(dt_.numpy(), dj) <= TOL


def test_h2corrected_cg_matches_jax():
    """CG-Jacobi (1e-10) on the float32 H2corrected of the interval at
    noRef 6 (319 dofs), b = M 1 (float64): the JAX package's iterations
    within 2, the solutions within 1e-4 (the float32 S_inf of each package
    rounds its entries apart; the system's conditioning carries that
    gap)."""
    jdm, jkern, tdm, kt = _h2cSetups('interval', 6)
    Aj = jAssemble(jdm, jkern, matrixFormat='H2corrected', params=F32)
    At = assembleNonlocal(tdm, kt, matrixFormat='H2corrected',
                          params=dict(F32))
    bj = Aj.mass @ jnp.ones(jdm.num_dofs)
    sj = jSolvers.build('cg-jacobi', A=Aj, setup=True)
    sj.tolerance, sj.maxIter = 1e-10, 1000
    xj = np.asarray(sj.solve(bj))
    b = assembleMass(tdm).matvec(torch.ones(tdm.num_dofs,
                                            dtype=torch.float64))
    s = solverFactory.build('cg-jacobi', A=At, setup=True)
    s.tolerance, s.maxIter = 1e-10, 1000
    x = s.solve(b)
    assert x.dtype == torch.float64
    assert abs(s.iterations - sj.iterations) <= 2
    assert np.linalg.norm(x.numpy() - xj) <= 1e-4 * np.linalg.norm(xj)


# ------------------------------------------------------------- profiles --

def _mesh(domain):
    if domain == 'interval':
        m = meshFactory('interval', a=-1, b=1)
        n = 4
    else:
        m = meshFactory('square', N=2, ax=0, ay=0, bx=1, by=1)
        n = 1
    for _ in range(n):
        m = m.refine()
    return m


def _profilePair(name, dim):
    """(port kernel, JAX kernel, zeroExterior) of the same numbers."""
    if name in ('gaussian', 'exponential'):
        return (tk.getIntegrableKernel(dim, name, np.inf),
                jk.getIntegrableKernel(dim, name, np.inf), True)
    if name in ('gaussian-finite', 'exponential-finite'):
        kind = name.split('-')[0]
        return (tk.getIntegrableKernel(dim, kind, 0.25),
                jk.getIntegrableKernel(dim, kind, 0.25), False)
    if name == 'tempered':
        return (tk.FractionalKernel(dim, 0.4, temperedLambda=2.0),
                jk.FractionalKernel(dim, jk.constFractionalOrder(0.4),
                                    temperedLambda=2.0), True)
    if name == 'tempered-finite':
        return (tk.FractionalKernel(dim, 0.4, 0.25, tk.ball2(),
                                    temperedLambda=3.0),
                jk.FractionalKernel(dim, jk.constFractionalOrder(0.4), 0.25,
                                    jk.ball2(), temperedLambda=3.0), False)
    if name == 'smooth-phi':
        return (tk.getFractionalKernel(dim, 0.6,
                                       phi=tk.temperedTwoPoint(1.5)),
                jk.getFractionalKernel(dim, 0.6,
                                       phi=jk.temperedTwoPoint(1.5)), True)
    if name == 'host-phi':
        return (tk.getFractionalKernel(
                    dim, 0.6, phi=tk.twoPointFunctionFactory(
                        'leftRight', 1.0, 2.0, 0.5, 3.0, 0.1)),
                jk.getFractionalKernel(dim, 0.6, phi=jk.leftRightTwoPoint(
                    1.0, 2.0, 0.5, 3.0, 0.1)), False)
    if name == 'logInverseDistance':
        return (tk.getIntegrableKernel(dim, name, np.inf),
                jk.getIntegrableKernel(dim, name, np.inf), False)
    if name == 'monomial':
        return (tk.Kernel(dim, 'monomial', np.inf, None, 0.5, 1.0,
                          monomialPower=1.0),
                jk.Kernel(dim, 'monomial', np.inf, None, 0.5, 1.0,
                          monomialPower=1.0), False)
    assert name == 'polynomial'
    return (tk.Kernel(dim, 'polynomial', 0.3, tk.ball2(), 0.5, 0.0,
                      exponentParam=0.3),
            jk.Kernel(dim, 'polynomial', 0.3, jk.ball2(), 0.5, 0.0,
                      exponentParam=0.3), False)


PROFILES = ('gaussian', 'exponential', 'gaussian-finite',
            'exponential-finite', 'tempered', 'tempered-finite',
            'smooth-phi', 'host-phi', 'logInverseDistance', 'monomial',
            'polynomial')
# the JAX package has no exponential kernel in 2D
PROFILE_CASES = [(n, d) for n in PROFILES for d in ('interval', 'square')
                 if not (n.startswith('exponential') and d == 'square')]
_PORT = {}


def _meshes(domain):
    """(JAX mesh, JAX dofmap, port dofmap) of _mesh(domain), made once."""
    if domain not in _PORT:
        m = _mesh(domain)
        tm = simplexMesh(np.asarray(m.vertices), np.asarray(m.cells),
                         dim=m.dim)
        _PORT[domain] = (m, dofmapFactory('P1', m),
                         P1_DoFMap(tm, device='cpu'))
    return _PORT[domain]


@pytest.mark.parametrize('name,domain', PROFILE_CASES)
def test_profile_dense_matches_jax(name, domain):
    """getDense of the profile in float32, per pair and (an infinite
    horizon without a host weight; the JAX grid drops the smooth two-point
    weight, a reference fault, so that kernel is held per pair) on the
    grid: K1, K2 and K3's float32 instances with the profile switch."""
    m, dm, tdm = _meshes(domain)
    kt, kj, ze = _profilePair(name, m.dim)
    grids = (False,) if kj.finiteHorizon or 'phi' in name else (False, True)
    for grid in grids:
        P = dict(F32, denseGrid=grid)
        Aj = jBuilder(dm, kj, params=P, zeroExterior=ze).getDense()
        At = nonlocalBuilder(tdm, kt, params=dict(P),
                             zeroExterior=ze).getDense()
        aj = np.asarray(Aj.toarray())
        assert aj.dtype == np.float32 and At.data.dtype == torch.float32
        assert _rel(At.toarray(), aj) <= TOL, grid
        assert _applies(At, Aj, aj.shape[0]) <= TOL_APPLY, grid


@pytest.mark.parametrize('name,domain', [
    (n, d) for n, d in PROFILE_CASES
    if n in ('gaussian', 'gaussian-finite', 'exponential-finite',
             'tempered-finite', 'polynomial', 'tempered')])
def test_profile_diagonal_and_sparse_match_jax(name, domain):
    """getDiagonal in float32 (float64, as the JAX _DiagAccumulator) and,
    for a finite horizon, getSparse (float32 data, the JAX pattern)."""
    m, dm, tdm = _meshes(domain)
    kt, kj, ze = _profilePair(name, m.dim)
    Dj = np.asarray(jBuilder(dm, kj, params=F32,
                             zeroExterior=ze).getDiagonal().diagonal)
    Dt = nonlocalBuilder(tdm, kt, params=dict(F32),
                         zeroExterior=ze).getDiagonal().diagonal
    assert Dj.dtype == np.float64 and Dt.dtype == torch.float64
    assert _rel(Dt.numpy(), Dj) <= TOL
    if not kj.finiteHorizon:
        return
    Sj = jBuilder(dm, kj, params=F32, zeroExterior=ze).getSparse()
    St = nonlocalBuilder(tdm, kt, params=dict(F32),
                         zeroExterior=ze).getSparse()
    assert St.data.dtype == torch.float32
    assert np.asarray(Sj.data).dtype == np.float32
    np.testing.assert_array_equal(St.indptrH, np.asarray(Sj.indptr))
    np.testing.assert_array_equal(St.indicesH, np.asarray(Sj.indices))
    assert _rel(St.dataH, np.asarray(Sj.data)) <= TOL
    assert _applies(St, Sj, St.num_rows) <= TOL_APPLY


def test_grid_distant_row_sums_round_once():
    """K2's float32 plain version sums each cell's row sums R in float64
    and rounds them once (the JAX program's einsum reduces a row of its
    grid before its one float32 rounding): one window over 2,048 interval
    cells of the gaussian profile stays within 3e-7 of the largest entry
    of the float64 call (float32 sums of R gave 6.6e-7)."""
    from pynucleus_tpu_torch.nl.assembly import grid_distant
    rng = np.random.default_rng(23)
    C, Q = 2048, 3
    x = np.sort(rng.uniform(-1.0, 1.0, C + 1))
    vols = np.diff(x)
    t, w = np.polynomial.legendre.leggauss(Q)
    t, w = (t + 1.0) / 2.0, w / 2.0
    X = (x[:-1, None] + t[None, :] * vols[:, None])[:, :, None]
    ccf = torch.tensor(((x[:-1] + x[1:]) / 2.0)[:, None], dtype=torch.float32)
    dofs = np.stack([np.arange(C), np.arange(1, C + 1)], 1) - 1
    dofs[dofs >= C - 1] = -1
    Phi = np.stack([1.0 - t, t])
    prof = tk.getIntegrableKernel(1, 'gaussian', np.inf).profileParams()
    out = {}
    for dt in (torch.float32, torch.float64):
        A = torch.zeros((C - 1, C - 1), dtype=dt)
        grid_distant(A, torch.tensor(X, dtype=dt), ccf,
                     torch.tensor(vols, dtype=dt), torch.tensor(dofs),
                     torch.tensor(Phi * w, dtype=dt),
                     torch.tensor(Phi, dtype=dt),
                     torch.tensor(-Phi * w, dtype=dt),
                     torch.tensor(w, dtype=dt), 1e-30, 10.0, prof)
        out[dt] = A
    assert _rel(out[torch.float32], out[torch.float64].numpy()) <= 3e-7


def test_profile_cg_on_sparse_matches_jax():
    """CG-Jacobi (1e-6) on the float32 getSparse of the gaussian kernel of
    a finite horizon on the square at noRef 2, b = 1: the JAX package's
    iterations within 2, the solutions within 1e-4 relative."""
    m = meshFactory('square', N=2, ax=0, ay=0, bx=1, by=1)
    for _ in range(2):
        m = m.refine()
    tm = simplexMesh(np.asarray(m.vertices), np.asarray(m.cells), dim=2)
    dm, tdm = dofmapFactory('P1', m), P1_DoFMap(tm, device='cpu')
    kt, kj, ze = _profilePair('gaussian-finite', 2)
    Sj = jBuilder(dm, kj, params=F32, zeroExterior=ze).getSparse()
    St = nonlocalBuilder(tdm, kt, params=dict(F32),
                         zeroExterior=ze).getSparse()
    sj = jSolvers.build('cg-jacobi', A=Sj, setup=True)
    sj.tolerance, sj.maxIter = 1e-6, 500
    xj = np.asarray(sj.solve(jnp.ones(dm.num_dofs, dtype=jnp.float32)))
    s = solverFactory.build('cg-jacobi', A=St, setup=True)
    s.tolerance, s.maxIter = 1e-6, 500
    x = s.solve(torch.ones(tdm.num_dofs, dtype=torch.float32))
    assert x.dtype == torch.float32
    assert abs(s.iterations - sj.iterations) <= 2
    assert np.linalg.norm(x.numpy() - xj) <= 1e-4 * np.linalg.norm(xj)


# ---------------------------------------------- the formerly refused five --

def _tinyInterval():
    m = jfem.simpleInterval(-1.0, 1.0)
    for _ in range(3):
        m = m.refine()
    return m


# each names the port's builder (builderFromArrays' keywords) and its call
FORMERLY_REFUSED = {
    'getDenseCross': (dict(kernelType='constant', horizon=HORIZON),
                      'getDenseCross'),
    'H2corrected': (dict(horizon=0.4), 'getH2FiniteHorizon'),
    'denseFiniteHorizon': (dict(kernelType='constant', horizon=HORIZON),
                           'getDense'),
    'sparsified': (dict(kernelType='constant', horizon=HORIZON),
                   'sparsified'),
    'gaussian': (dict(kernelType='gaussian'), 'getDense'),
}


@pytest.mark.parametrize('name', list(FORMERLY_REFUSED))
def test_formerly_refused_cases_match_jax(name):
    """The float32 cases that the port refused until now run and match the
    JAX package's float32 program on the tiny interval (15 dofs)."""
    kw, call = FORMERLY_REFUSED[name]
    m = _tinyInterval()
    ze = name == 'gaussian'
    # the JAX package's CPU default is the per-pair dense path
    tb = builderFromArrays(m.vertices, m.cells, 0.25, 1, dtype=np.float32,
                           params={'denseGrid': False}, device='cpu',
                           zeroExterior=ze, **kw)
    dm = jfem.P1_DoFMap(m)
    hv = kw.get('horizon', np.inf)
    if kw.get('kernelType') == 'constant':
        jkern = jk.getIntegrableKernel(1, 'indicator', hv)
    elif kw.get('kernelType') == 'gaussian':
        jkern = jk.getIntegrableKernel(1, 'gaussian', np.inf)
    else:
        jkern = jk.getFractionalKernel(1, 0.25, horizon=hv)
    jb = jBuilder(dm, jkern, params=F32, zeroExterior=ze,
                  **({'dm2': dm.getComplementDoFMap()}
                     if call == 'getDenseCross' else {}))
    if call == 'sparsified':
        Aj, At = (b.getDense(trySparsification=True) for b in (jb, tb))
    else:
        Aj, At = getattr(jb, call)(), getattr(tb, call)()
    aj, at = np.asarray(Aj.toarray()), np.asarray(At.toarray())
    assert at.dtype == aj.dtype, name
    assert _rel(at, aj) <= TOL, name
    if call != 'getDenseCross':
        x = _x(aj.shape[1], np.float64)
        yt = At.matvec(torch.as_tensor(x.astype(at.dtype))).numpy()
        yj = np.asarray(Aj.matvec(jnp.asarray(x.astype(at.dtype))))
        assert yt.dtype == yj.dtype, name
        assert _rel(yt, yj) <= TOL_APPLY, name


# --------------------------------------------------------- what remains --

def test_float32_h2_of_other_profiles_raises():
    """getH2 of the smooth profiles in float32 is queued (ROADMAP.md
    A7-f32r): NotImplementedError naming it, on the CPU."""
    m = _tinyInterval()
    for kw in (dict(kernelType='gaussian'), dict(kernelType='exponential'),
               dict(kernelType='logInverseDistance')):
        tb = builderFromArrays(m.vertices, m.cells, 0.25, 1,
                               dtype=np.float32, device='cpu',
                               zeroExterior=kw['kernelType'] != (
                                   'logInverseDistance'), **kw)
        with pytest.raises(NotImplementedError, match='ROADMAP.md'):
            tb.getH2()


def test_launch_counts_stay_zero_on_the_cpu():
    """On CPU tensors the float32 wrappers run their plain versions and
    count no launch."""
    kernels.resetLaunches()
    d = _finite('interval-indicator')
    b = nonlocalBuilder(d['tdm'], d['tk'], params=dict(F32))
    b.getDense(trySparsification=True)
    b.getDenseCross()
    assert not any(kernels.launches.values())

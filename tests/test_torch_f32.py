"""The float32 dense path (``params={'dtype': np.float32}``) of the port
against the JAX package's, on the same seeded inputs.

  K1  panel_scatter         _bucket_contrib + _device_scatter_rows
                            (explicit pairs), _bucket_natural_scatter_scan
                            (natural-order buckets), _bucket_rows_scatter_scan
                            (the zero-exterior rows with normals)
      panel_scatter_natural _bucket_natural_scatter (one chunk), in float64
                            and float32
  K2  grid_distant          _grid_distant_pass
  K3  grid_boundary         _grid_boundary_blocks + _scatter_cell_blocks
  K4  pcg_update            _cg_core on float32 vectors (plain and Jacobi)

Tolerances, each relative to the largest entry: the kernels' plain float32
versions 5e-6 (the same float32 quadrature summed in another order; the
float64 one-chunk entry 1e-13), getDense 1e-5 (the whole operator, per pair
and on the grid); tests/test_f32_path.py's bars on the port and its error
within rtol 3e-2 of the JAX package's; CG iterations within 2 of
_cg_core's and its solution within 1e-4 relative.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.fem.quadrature import simplexCompact
from pynucleus_tpu.nl import getFractionalKernel as jKernel
from pynucleus_tpu.nl import assembly as jasm
from pynucleus_tpu.nl.panels import classifyPairsDenseGrid, \
    classifyBoundaryPairs
from pynucleus_tpu.nl.quad_singular import distantRule, boundaryDistantRule
from pynucleus_tpu.nl.quad_singular_2d import (edgeRule2DSS, vertexRule2DSS,
                                               sameCellRule2DSS)

from pynucleus_tpu_torch import kernels
from pynucleus_tpu_torch.config import realType
from pynucleus_tpu_torch.interop import builderFromArrays
from pynucleus_tpu_torch.nl import assembly as tasm
from pynucleus_tpu_torch.nl.kernels import getFractionalKernel as tKernel
from pynucleus_tpu_torch.nl.kernels import Profile

TOL_KERNEL = 5e-6
TOL_F64 = 1e-13
TOL_DENSE = 1e-5
F32 = torch.float32


@pytest.fixture(autouse=True, scope='module')
def _twoTorchThreads():
    """Two torch threads for this module's tests: the workers of a
    parallel test run share the host's cores, and more threads per worker
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def disc():
    m = jfem.circle(h=0.78, radius=1.0)
    for _ in range(2):
        m = m.refine()
    dm = jfem.P1_DoFMap(m)
    return m, dm, jKernel(2, 0.75), tKernel(2, 0.75)


def _t(a, dtype=F32):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def _j(a, dtype=np.float32):
    return jnp.asarray(np.asarray(a, dtype=dtype))


def _assertClose(At, Aj, tol=TOL_KERNEL):
    scale = np.abs(Aj).max()
    assert scale > 0
    err = np.abs(At - Aj).max()
    assert err <= tol * scale, (err, scale)
    return err / scale


def _port(N, vertices, vi1, vi2, dr, vs, nm, rule, PSI, kernel, dtype=F32):
    A = torch.zeros((N, N), dtype=dtype)
    tasm.panel_scatter(A, _t(vertices, dtype), _t(vi1, torch.int64),
                       _t(vi2, torch.int64), _t(dr, torch.int64),
                       _t(vs, dtype), None if nm is None else _t(nm, dtype),
                       _t(rule.bary_x, dtype), _t(rule.bary_y, dtype),
                       _t(rule.w, dtype), _t(jasm._psi_prod(PSI), dtype),
                       kernel.profileParams())
    assert A.dtype == dtype
    return A.numpy()


def _touching(m, dm, nS):
    """Touching pairs sharing nS vertices, permuted as the assembly does
    (shared vertices first, j-side shared dofs DROP)."""
    info = classifyPairsDenseGrid(dm, jKernel(2, 0.75))
    pairs, shared = info['touching']
    idx = [k for k in range(len(pairs)) if shared[k][0] == nS]
    rule = edgeRule2DSS(-3.5, 2, 9) if nS == 2 else vertexRule2DSS(-3.5, 2, 6)
    mask = rule.sharedDofMask(dm, nS)
    vi1, vi2, dr = [], [], []
    for k in idx:
        i, j = pairs[k]
        _, p1, p2 = shared[k]
        vi1.append(m.cells[i][p1])
        vi2.append(m.cells[j][p2])
        drj = dm.dofs[j][p2].copy()
        drj[mask] = jasm.DROP
        dr.append(np.concatenate([dm.dofs[i][p1], drj]))
    vs = np.random.RandomState(nS).uniform(0.5, 2.0, len(idx)) * 1e-3
    return (np.array(vi1), np.array(vi2), np.array(dr), vs, rule,
            rule.buildPSI(dm, nSharedVertices=nS))


@pytest.mark.parametrize('nS', [1, 2])
def test_f32_explicit_vs_bucket_contrib(disc, nS):
    m, dm, kj, kt = disc
    vi1, vi2, dr, vs, rule, PSI = _touching(m, dm, nS)
    N = dm.num_dofs
    M = jasm._bucket_contrib(_j(m.vertices), jnp.asarray(vi1),
                             jnp.asarray(vi2), _j(vs), _j(rule.bary_x),
                             _j(rule.bary_y), _j(rule.w),
                             _j(jasm._psi_prod(PSI)), kernel=kj)
    Aj = jasm._device_scatter_rows(jnp.zeros((N + 1, N + 1), jnp.float32),
                                   jnp.asarray(dr), M, None, nPSI=6)
    assert Aj.dtype == jnp.float32
    At = _port(N, m.vertices, vi1, vi2, dr, vs, None, rule, PSI, kt)
    _assertClose(At, np.asarray(Aj)[:N, :N])


def _naturalBucket(m, dm, kj, bucket):
    """(di, dj, rule, PSI, symfac) of an identical-cell bucket or of 300
    seeded distant pairs at a distant rule's order."""
    if bucket == 'id':
        di = dj = np.arange(m.num_cells)
        rule = sameCellRule2DSS(-3.5, 2, 9)
        return di, dj, rule, rule.buildPSI(dm, nSharedVertices=3), 4.0
    info = classifyPairsDenseGrid(dm, kj)
    di, dj, _ = info['distant']
    pick = np.random.RandomState(7).choice(len(di), size=min(300, len(di)),
                                           replace=False)
    rule = distantRule(int(bucket[len('distant'):]), 2)
    return di[pick], dj[pick], rule, rule.buildPSI(dm, nSharedVertices=0), \
        2.0


def _portNatural(m, dm, kt, di, dj, rule, PSI, symfac, dtype=F32):
    N = dm.num_dofs
    A = torch.zeros((N, N), dtype=dtype)
    tasm.panel_scatter_natural(
        A, _t(m.vertices, dtype), _t(m.cells, torch.int64),
        _t(dm.dofs, torch.int64), _t(m.simplexVolumes(), dtype),
        _t(di, torch.int64), _t(dj, torch.int64), symfac,
        _t(rule.bary_x, dtype), _t(rule.bary_y, dtype), _t(rule.w, dtype),
        _t(jasm._psi_prod(PSI), dtype), kt.profileParams())
    assert A.dtype == dtype
    return A.numpy()


@pytest.mark.parametrize('bucket', ['id', 'distant6'])
def test_f32_natural_vs_natural_scatter_scan(disc, bucket):
    m, dm, kj, kt = disc
    di, dj, rule, PSI, symfac = _naturalBucket(m, dm, kj, bucket)
    P, nPSI, N = len(di), PSI.shape[0], dm.num_dofs
    chunk = 64
    nCh = -(-P // chunk)
    pad = nCh * chunk - P
    dip = np.concatenate([di, np.zeros(pad, np.int64)]).reshape(nCh, chunk)
    djp = np.concatenate([dj, np.zeros(pad, np.int64)]).reshape(nCh, chunk)
    sf = np.concatenate([np.full(P, symfac), np.zeros(pad)]).reshape(nCh,
                                                                      chunk)
    Aj = jasm._bucket_natural_scatter_scan(
        jnp.zeros((N + 1, N + 1), jnp.float32), _j(m.vertices),
        jnp.asarray(m.cells), jnp.asarray(dm.dofs), _j(m.simplexVolumes()),
        jnp.asarray(dip), jnp.asarray(djp), _j(sf), _j(rule.bary_x),
        _j(rule.bary_y), _j(rule.w), _j(jasm._psi_prod(PSI)), kernel=kj,
        nPSI=nPSI)
    At = _portNatural(m, dm, kt, di, dj, rule, PSI, symfac)
    _assertClose(At, np.asarray(Aj)[:N, :N])


@pytest.mark.parametrize('dtype', ['float64', 'float32'])
@pytest.mark.parametrize('bucket', ['id', 'distant10'])
def test_natural_one_chunk_vs_bucket_natural_scatter(disc, bucket, dtype):
    """The natural-order entry against _bucket_natural_scatter, the JAX
    package's one-chunk program (no caller there)."""
    m, dm, kj, kt = disc
    di, dj, rule, PSI, symfac = _naturalBucket(m, dm, kj, bucket)
    N, npd = dm.num_dofs, np.dtype(dtype).type
    Aj = jasm._bucket_natural_scatter(
        jnp.zeros((N + 1, N + 1), npd), _j(m.vertices, npd),
        jnp.asarray(m.cells), jnp.asarray(dm.dofs),
        _j(m.simplexVolumes(), npd), jnp.asarray(di), jnp.asarray(dj),
        _j(symfac, npd), _j(rule.bary_x, npd), _j(rule.bary_y, npd),
        _j(rule.w, npd), _j(jasm._psi_prod(PSI), npd), kernel=kj,
        nPSI=PSI.shape[0])
    At = _portNatural(m, dm, kt, di, dj, rule, PSI, symfac,
                      realType(dtype))
    _assertClose(At, np.asarray(Aj)[:N, :N],
                 TOL_KERNEL if dtype == 'float32' else TOL_F64)


def test_f32_rows_vs_rows_scatter_scan(disc):
    m, dm, kj, kt = disc
    bj = kj.getModifiedKernel(horizon=np.inf).getBoundaryKernel()
    surface = m.get_surface_mesh()
    binfo = classifyBoundaryPairs(dm, surface, bj, correctionsOnly=True)
    di, dj, orders = binfo['distant']
    sel = orders == orders.min()
    ii, jj = di[sel], dj[sel]
    rule = boundaryDistantRule(int(orders.min()), 2, 1)
    PSI = rule.buildPSI(dm, boundary=True)
    vs = m.simplexVolumes()[ii] * surface.simplexVolumes()[jj]
    vi1, vi2, dr, nm = m.cells[ii], surface.cells[jj], dm.dofs[ii], \
        surface.normals[jj]
    N = dm.num_dofs
    assert len(ii) > 0
    Aj = jasm._bucket_rows_scatter_scan(
        jnp.zeros((N + 1, N + 1), jnp.float32), _j(m.vertices),
        jnp.asarray(vi1)[None], jnp.asarray(vi2)[None], jnp.asarray(dr)[None],
        _j(vs)[None], _j(nm)[None], _j(rule.bary_x), _j(rule.bary_y),
        _j(rule.w), _j(jasm._psi_prod(PSI)), kernel=bj, nPSI=3,
        useNormals=True)
    At = _port(N, m.vertices, vi1, vi2, dr, vs, nm, rule, PSI,
               kt.getBoundaryKernel())
    _assertClose(At, np.asarray(Aj)[:N, :N])


@pytest.mark.parametrize('window', [0, 1])
def test_f32_grid_distant_vs_grid_distant_pass(disc, window):
    m, dm, kj, kt = disc
    info = classifyPairsDenseGrid(dm, kj)
    o, t_lo, t_hi = info['gridPasses'][window]
    C, N = m.num_cells, dm.num_dofs
    V = m.vertices[m.cells]
    cc32 = V.mean(axis=1).astype(np.float32)
    b1, w1 = simplexCompact(o, 2)
    X = np.einsum('qk,ckd->cqd', b1, V)
    Phi = dm.evalPhi(b1)
    Ct = 64
    Aj = jasm._grid_distant_pass(
        jnp.zeros((N + 1, N + 1), jnp.float32), _j(X), _j(X),
        jnp.asarray(cc32), _j(m.simplexVolumes()),
        jnp.asarray(dm.dofs.astype(np.int32)),
        jnp.asarray(jasm._dofIncidence(dm.dofs, N).astype(np.int32)),
        _j(Phi * w1), _j(Phi), _j(Phi), _j(-Phi * w1), _j(w1), _j(w1),
        jnp.float32(t_lo), jnp.float32(t_hi), kernel=kj,
        nTiles=-(-C // Ct), Ct=Ct)
    assert Aj.dtype == jnp.float32
    At = torch.zeros((N, N), dtype=F32)
    tasm.grid_distant(At, _t(X), _t(cc32), _t(m.simplexVolumes()),
                      _t(dm.dofs, torch.int64), _t(Phi * w1), _t(Phi),
                      _t(-Phi * w1), _t(w1), np.float32(t_lo),
                      np.float32(t_hi), kt.profileParams())
    _assertClose(At.numpy(), np.asarray(Aj)[:N, :N])


def test_f32_grid_boundary_vs_grid_boundary_blocks(disc):
    m, dm, kj, kt = disc
    bj = kj.getModifiedKernel(horizon=np.inf).getBoundaryKernel()
    surface = m.get_surface_mesh()
    binfo = classifyBoundaryPairs(dm, surface, bj, correctionsOnly=True)
    di, dj, _ = binfo['distant']
    tp = binfo['touching'][0]
    mi = np.concatenate([di, tp[:, 0]])
    mj = np.concatenate([dj, tp[:, 1]])
    C, S, N = m.num_cells, surface.num_cells, dm.num_dofs
    b1, w1 = simplexCompact(4, 2)
    b2, w2 = simplexCompact(4, 1)
    X = np.einsum('qk,ckd->cqd', b1, m.vertices[m.cells])
    Ysurf = np.einsum('qk,skd->sqd', b2, m.vertices[surface.cells])
    Phi = dm.evalPhi(b1)
    svolw2 = surface.simplexVolumes()[:, None] * w2[None, :]
    Ct = 64
    nTiles = -(-C // Ct)
    tOf = mi // Ct
    maxM = int(np.bincount(tOf, minlength=nTiles).max())
    mR = np.full((nTiles, maxM), -1, dtype=np.int32)
    mC = np.zeros((nTiles, maxM), dtype=np.int32)
    srt = np.argsort(tOf, kind='stable')
    ts = tOf[srt]
    pos = np.arange(len(mi)) - np.searchsorted(ts, np.arange(nTiles))[ts]
    mR[ts, pos] = mi[srt] - ts * Ct
    mC[ts, pos] = mj[srt]
    B = jasm._grid_boundary_blocks(
        _j(X), _j(Ysurf), _j(svolw2), _j(m.simplexVolumes()),
        _j(surface.normals), _j(Phi * w1), _j(Phi), _j(w1),
        jnp.asarray(mR), jnp.asarray(mC), kernel=bj, nTiles=nTiles, Ct=Ct,
        useNormals=True, maskIn=False, dtype=jnp.float32)
    Aj = jasm._scatter_cell_blocks(jnp.zeros((N + 1, N + 1), jnp.float32),
                                   jnp.asarray(dm.dofs.astype(np.int32)), B)
    assert Aj.dtype == jnp.float32
    key = np.unique(mi.astype(np.int64) * S + mj)
    exclPtr = np.searchsorted(key // S, np.arange(C + 1))
    At = torch.zeros((N, N), dtype=F32)
    tasm.grid_boundary(At, _t(X), _t(m.simplexVolumes()),
                       _t(dm.dofs, torch.int64), _t(Ysurf), _t(svolw2),
                       _t(surface.normals), _t(exclPtr, torch.int64),
                       _t(key % S, torch.int64), _t(Phi * w1), _t(Phi),
                       kt.getBoundaryKernel().profileParams(), True)
    _assertClose(At.numpy(), np.asarray(Aj)[:N, :N])


def _mesh(domain, noRef):
    if domain == 'interval':
        m, d = jfem.simpleInterval(-1.0, 1.0), 1
    else:
        m, d = jfem.circle(n=8), 2
    for _ in range(noRef):
        m = m.refine()
    return m, d


DENSE_CASES = [('interval', 4), ('interval', 6), ('circle', 2)]


@pytest.mark.parametrize('grid', [True, False])
@pytest.mark.parametrize('domain,noRef', DENSE_CASES)
def test_getDense_f32_matches_jax(domain, noRef, grid):
    """The port's float32 operator against the JAX package's float32
    operator with the same params (1e-5 of the largest entry); its
    distance from the port's float64 operator is float32 rounding."""
    m, d = _mesh(domain, noRef)
    dm = jfem.P1_DoFMap(m)
    params = {'denseGrid': grid}
    Aj = np.asarray(jasm.nonlocalBuilder(
        dm, jKernel(d, 0.75), params={**params, 'dtype': np.float32})
        .getDense().data)
    assert Aj.dtype == np.float32
    A32 = builderFromArrays(m.vertices, m.cells, 0.75, d, dtype=np.float32,
                            params=params, device='cpu').getDense().data
    A64 = builderFromArrays(m.vertices, m.cells, 0.75, d, params=params,
                            device='cpu').getDense().data
    assert A32.dtype == F32 and A64.dtype == torch.float64
    _assertClose(A32.numpy(), Aj, TOL_DENSE)
    assert _assertClose(A32.double().numpy(), A64.numpy(), 1e-4) > 0


def _analyticError(dm, u):
    from scipy.special import gamma
    s = 0.75
    xs = np.asarray(dm.getDoFCoordinates())[:, 0]
    uex = (2.0 ** (-2 * s) * np.sqrt(np.pi)
           / (gamma(s + 0.5) * gamma(1.0 + s))) * (1 - xs ** 2) ** s
    return np.abs(np.asarray(u, dtype=np.float64) - uex).max()


def _portError(dtype, grid):
    """tests/test_f32_path.py's _solve on the port: the interval at noRef
    6, getDense in ``dtype``, CG to 1e-6 (500 iterations at most), the
    error against (-Delta)^0.75 u = 1's analytic solution."""
    from pynucleus_tpu_torch.fem.assembly import assembleRHS
    from pynucleus_tpu_torch.fem.functions import constant
    from pynucleus_tpu_torch.base.solvers import solverFactory
    m, _ = _mesh('interval', 6)
    b = builderFromArrays(m.vertices, m.cells, 0.75, 1, dtype=dtype,
                          params={'denseGrid': grid}, device='cpu')
    A = b.getDense()
    rhs = assembleRHS(b.dm, constant(1.0)).data.to(A.data.dtype)
    cg = solverFactory.build('cg', A=A, setup=True)
    cg.tolerance = 1e-6
    cg.maxIter = 500
    u = cg.solve(rhs)
    assert u.dtype == A.data.dtype == realType(dtype)
    return _analyticError(jfem.P1_DoFMap(m), u.numpy())


def _jaxError(dtype, grid):
    from pynucleus_tpu.base.solvers import solverFactory
    m, _ = _mesh('interval', 6)
    dm = jfem.P1_DoFMap(m)
    A = jasm.nonlocalBuilder(dm, jKernel(1, 0.75), params={
        'dtype': dtype, 'denseGrid': grid}).getDense()
    b = jfem.assembleRHS(dm, jfem.constant(1.0))
    cg = solverFactory.build('cg', A=A, setup=True)
    cg.tolerance = 1e-6
    cg.maxIter = 500
    return _analyticError(dm, cg.solve(_j(b.data, dtype)))


@pytest.mark.parametrize('grid', [True, False])
def test_f32_path_bars_on_port(grid):
    """tests/test_f32_path.py's bar e32 < max(2 e64, 5e-4) on the port (on
    the grid and per pair), and its e32 within rtol 3e-2 of the JAX
    package's."""
    e64 = _portError(np.float64, grid)
    e32 = _portError(np.float32, grid)
    assert e32 < max(2.0 * e64, 5e-4), (e32, e64)
    ej = _jaxError(np.float32, grid)
    assert abs(e32 - ej) <= 3e-2 * ej, (e32, ej)


@pytest.mark.parametrize('prec', ['cg', 'cg-jacobi'])
def test_cg_f32_matches_cg_core(prec):
    """The port's float32 CG (K4's plain float32 version; with Jacobi, a
    float32 diagonal) on the JAX package's float32 operator and load:
    iterations within 2 of _cg_core's, solutions within 1e-4 relative."""
    from pynucleus_tpu.base.solvers import solverFactory as jsf
    from pynucleus_tpu_torch.base.solvers import solverFactory as tsf
    from pynucleus_tpu_torch.base.linear_operators import \
        Dense_LinearOperator
    m, _ = _mesh('interval', 6)
    dm = jfem.P1_DoFMap(m)
    Aj = jasm.nonlocalBuilder(dm, jKernel(1, 0.75), params={
        'dtype': np.float32, 'denseGrid': True}).getDense()
    b = np.asarray(jfem.assembleRHS(dm, jfem.constant(1.0)).data,
                   dtype=np.float32)
    cj = jsf.build(prec, A=Aj, setup=True)
    ct = tsf.build(prec, A=Dense_LinearOperator(_t(np.array(Aj.data))),
                   setup=True)
    for c in (cj, ct):
        c.tolerance = 1e-6
        c.maxIter = 500
    uj = np.asarray(cj.solve(jnp.asarray(b)))
    ut = ct.solve(_t(b))
    assert ut.dtype == F32 and uj.dtype == np.float32
    assert abs(ct.iterations - cj.iterations) <= 2, (ct.iterations,
                                                     cj.iterations)
    assert np.abs(ut.numpy() - uj).max() <= 1e-4 * np.abs(uj).max()


@pytest.mark.parametrize('grid', [True, False])
def test_f32_partition_and_orders_as_float64(grid):
    """The float32 and float64 builds classify the cell pairs alike: the
    same K1 buckets (sizes, rules, nPSI), K2 windows and K3 grid."""
    m, _ = _mesh('circle', 2)
    names = ('panel_scatter', 'grid_distant', 'grid_boundary')
    orig = {n: getattr(tasm, n) for n in names}
    seen = {}

    def recorder(n, key):
        def rec(A, *args, **kw):
            shapes = tuple(tuple(a.shape) for a in args
                           if isinstance(a, torch.Tensor))
            windows = tuple(float(a) for a in args
                            if isinstance(a, (float, np.floating)))
            seen[key].append((n, shapes, windows))
            return orig[n](A, *args, **kw)
        return rec
    try:
        for dtype in (np.float64, np.float32):
            key = np.dtype(dtype).name
            seen[key] = []
            for n in names:
                setattr(tasm, n, recorder(n, key))
            A = builderFromArrays(m.vertices, m.cells, 0.75, 2, dtype=dtype,
                                  params={'denseGrid': grid},
                                  device='cpu').getDense()
            assert A.data.dtype == realType(dtype)
    finally:
        for n in names:
            setattr(tasm, n, orig[n])
    assert seen['float32'] == seen['float64']
    assert any(c[0] == 'grid_distant' for c in seen['float32']) == grid


def test_f32_refusals():
    """Float32 beyond the kernels and formats of the float32 paths (the
    constant-order fractional kernel of an infinite horizon in getDense,
    getH2 and getDiagonal; a constant finite horizon in getSparse,
    getDiagonal and getH2) raises NotImplementedError; a float32 target
    with float64 tables (or vectors) raises ValueError; an unknown dtype
    ValueError."""
    from pynucleus_tpu_torch.interop import fromArrays
    from pynucleus_tpu_torch.base.solvers import pcg_update
    m, _ = _mesh('interval', 3)
    kw = dict(dtype=np.float32, device='cpu')
    for args in (dict(horizon=(0.2, 0.0, 0.1, 0.3)),
                 dict(s='twoDomainNonSym(0.25,0.75)'),
                 dict(kernelType='gaussian', s=0.75),
                 dict(temperedLambda=2.0), dict(phi=('tempered', 2.0)),
                 dict(derivative=1)):
        s = args.pop('s', 0.75)
        with pytest.raises(NotImplementedError, match='float32'):
            builderFromArrays(m.vertices, m.cells, s, 1, **kw, **args)
    b = builderFromArrays(m.vertices, m.cells, 0.75, 1, **kw)
    finite = builderFromArrays(m.vertices, m.cells, 0.75, 1, **kw,
                               horizon=0.2)
    for build in (b.getDenseCross, b.getH2FiniteHorizon, b.getDenseVector,
                  b.getH2Vector, lambda: b.getDense(trySparsification=True),
                  finite.getDense, finite.getDenseCross):
        with pytest.raises(NotImplementedError, match='float32'):
            build()
    _, dm, k = fromArrays(m.vertices, m.cells, 0.75, 1, device='cpu')
    with pytest.raises(NotImplementedError, match='float32'):
        tasm.assembleNonlocal(dm, k, 'sparsified',
                              params={'dtype': 'float32'})
    with pytest.raises(ValueError, match='float64 or float32'):
        builderFromArrays(m.vertices, m.cells, 0.75, 1, dtype='float16',
                          device='cpu')
    A = torch.zeros((4, 4), dtype=F32)
    i2 = torch.zeros((1, 2), dtype=torch.int64)
    tables = (torch.ones((2, 3)), torch.ones((2, 3)), torch.ones(3),
              torch.ones((3, 4)))
    prof = k.profileParams()
    with pytest.raises(ValueError, match='float32'):
        tasm.panel_scatter(A, torch.zeros((3, 1), dtype=torch.float64), i2,
                           i2, i2, torch.ones(1), None, *tables, prof)
    with pytest.raises(NotImplementedError, match='float32'):
        tasm.panel_scatter(A, torch.zeros((3, 1)), i2, i2, i2, torch.ones(1),
                           None, *tables, Profile(1, 1.0, 0.0, 2.0))
    with pytest.raises(ValueError, match='float32'):
        tasm.grid_distant(A, torch.zeros((2, 3, 1), dtype=torch.float64),
                          torch.zeros((2, 1)), torch.ones(2),
                          torch.zeros((2, 2), dtype=torch.int64),
                          *(torch.ones((2, 3)),) * 3, torch.ones(3),
                          0.0, 1.0, prof)
    v = torch.zeros(3)
    with pytest.raises(ValueError, match='one type'):
        pcg_update(v, v.clone(), v.clone(), v.clone(), v.clone(),
                   v.double(), torch.ones(3), torch.ones(2), 0)


def test_f32_counts_no_launch_on_cpu():
    """On CPU tensors the float32 path runs the plain versions: no count
    moves, the float32 keys among them."""
    m, _ = _mesh('circle', 1)
    kernels.resetLaunches()
    builderFromArrays(m.vertices, m.cells, 0.75, 2, dtype=np.float32,
                      device='cpu').getDense()
    assert set(kernels.FLOAT32) <= set(kernels.launches)
    assert not any(kernels.launches.values())

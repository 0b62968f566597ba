"""The float32 H2 path (getH2 with ``params={'dtype': np.float32}``) of the
port against the JAX package's float32 getH2 (``forceDeviceCSR``: its
device near-field accumulator, as off the CPU), on the same meshes: the
interval refined 8 times (255 dofs) and circle(n=8) refined 3 times (225
dofs), on the block engine (the default: K11 + K12, then K5 + K6 on the
pairs that also hold orders above 8) and the flat one (K5 + K6; the JAX
package with PYNUCLEUS_TPU_BLOCK_NEAR=0).  On the CPU the port runs the
plain versions of K1's slot and tree targets, K6, K7, K8 and K12 in
float32.

  the plan         tree, admissible pairs, transfer matrices, leaf
                   integrals, far grids, near pattern, K5's keys and
                   histograms and K11's counts: identical in both dtypes
  near data        every kernel and route of a build, against the JAX
                   float32 data: 1e-5 of the largest entry (the same
                   float32 quadrature summed in another order); the
                   touching panels summed in a float64 shadow and cast once
                   into the float32 store, as the JAX package sums them
  Kall, leafPhi, T 1e-5 relative (K7 in float32; the bases cast once)
  K7, K8 alone     the plain float32 K7 on the JAX float32 grids against
                   _farFieldBlocks, and the plain float32 K8 on the JAX
                   operator's arrays against _h2_matvec: 1e-5 of the
                   largest entry
  apply, diagonal  1e-5 of max|y| (max|diag|)
  CG-Jacobi        iterations within 2 of the JAX package's on its own
                   float32 operator (1e-6, 500 at most)
  float32 gap      max|H32 x - H64 x| / max|H64 x| (and the diagonal's) no
                   more than twice the JAX package's own gap on the mesh
                   (pinned in JAX_GAPS; a slow twin holds the pins to the
                   JAX package's float32 and float64 builds)
  refusals         the float32 H2 of the gaussian kernel raises
                   NotImplementedError; K20, a
                   mixed-type apply and float32 data with float64 tables
                   raise
"""
import contextlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.nl import getFractionalKernel as jKernel
from pynucleus_tpu.nl import assembly as jasm
from pynucleus_tpu.nl import h2 as jh2

from pynucleus_tpu_torch import kernels
from pynucleus_tpu_torch.interop import builderFromArrays, h2FromArrays
from pynucleus_tpu_torch.nl import assembly as tasm
from pynucleus_tpu_torch.nl import h2 as th2

TOL = 1e-5
F32 = torch.float32
S = 0.75
MESHES = {'interval': (1, 8), 'circle': (2, 3)}
ENGINES = ('block', 'flat')
# the wrappers of the near-field build whose calls are recorded
RECORDED = ('panel_scatter_slots', 'panel_scatter_tree', 'near_enum',
            'near_enum_quad', 'block_near_count', 'block_near_quad',
            'far_field')


def _mesh(name):
    dim, noRef = MESHES[name]
    m = jfem.simpleInterval(-1.0, 1.0) if dim == 1 else jfem.circle(n=8)
    for _ in range(noRef):
        m = m.refine()
    return m, dim


@contextlib.contextmanager
def _recording():
    """Records, per wrapper of RECORDED, its calls' data dtype and, for K5
    and K11, their outputs (keys and histograms, counts)."""
    orig = {n: getattr(tasm, n) for n in RECORDED}
    seen = {n: [] for n in RECORDED}

    def wrap(n):
        def rec(*args, **kw):
            out = orig[n](*args, **kw)
            if n == 'near_enum':
                seen[n].append(tuple(t.clone() for t in out))
            elif n == 'block_near_count':
                seen[n].append(out.clone())
            else:
                # the data's (K7: the grids') type
                seen[n].append(args[0].dtype)
            return out
        return rec
    try:
        for n in RECORDED:
            setattr(tasm, n, wrap(n))
        yield seen
    finally:
        for n in RECORDED:
            setattr(tasm, n, orig[n])


def _jaxH2(m, dim, dtype, engine, monkeypatch):
    dm = jfem.P1_DoFMap(m)
    with monkeypatch.context() as mp:
        if engine == 'flat':
            mp.setenv('PYNUCLEUS_TPU_BLOCK_NEAR', '0')
        return jasm.nonlocalBuilder(dm, jKernel(dim, S), params={
            'dtype': dtype, 'forceDeviceCSR': True}).getH2()


def _portH2(m, dim, dtype, engine):
    with _recording() as seen:
        H = builderFromArrays(m.vertices, m.cells, S, dim, dtype=dtype,
                              params={'nearEngine': engine},
                              device='cpu').getH2()
    return H, seen


@pytest.fixture(autouse=True, scope='module')
def _twoTorchThreads():
    """Two torch threads for this module's tests: the workers of a
    parallel test run share the host's cores, and more threads per worker
    oversubscribe them (the module fixture's builds above all)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module', params=list(MESHES))
def builds(request):
    """The JAX package's float32 builds on both engines, and the port's
    (with the recorded calls) and its float64 build, on one mesh."""
    mp = pytest.MonkeyPatch()
    m, dim = _mesh(request.param)
    out = {'name': request.param, 'mesh': m, 'dim': dim, 'jax': {},
           'port': {}}
    for engine in ENGINES:
        out['jax'][engine] = _jaxH2(m, dim, np.float32, engine, mp)
        out['port'][engine] = _portH2(m, dim, np.float32, engine)
    out['port']['f64'] = _portH2(m, dim, np.float64, 'block')
    return out


def _x(n):
    return np.random.default_rng(7).normal(size=n)


def _rel(got, ref):
    scale = np.abs(ref).max()
    assert scale > 0
    return float(np.abs(np.asarray(got, dtype=np.float64)
                        - np.asarray(ref, dtype=np.float64)).max() / scale)


def test_plan_same_in_both_dtypes(builds):
    """The plan, the near pattern and the quadrature orders do not depend
    on the dtype: one plan feeds both builds."""
    m, dim = builds['mesh'], builds['dim']
    plans = [builderFromArrays(m.vertices, m.cells, S, dim, dtype=dt,
                               device='cpu').planH2()
             for dt in (np.float64, np.float32)]
    p64, p32 = plans
    assert p32['farGi'] is not None
    for key in ('m', 'M', 'nLvl', 'sizes', 'Pfar', 'Pnear', 'farOffs'):
        assert p32[key] == p64[key], key
    for a, b in zip(p32['nodes'], p64['nodes']):
        assert (a.id, a.level, a.parent, a.children) == \
            (b.id, b.level, b.parent, b.children)
        np.testing.assert_array_equal(a.dofs, b.dofs)
    for key in ('farGi', 'farGj', 'leafPhi', 'leafDofs', 'lvlIdx', 'posIdx'):
        np.testing.assert_array_equal(p32[key], p64[key])
    for ell in range(1, p64['nLvl']):
        np.testing.assert_array_equal(p32['Thost'][ell], p64['Thost'][ell])
    (H32, s32), (H64, s64) = builds['port']['block'], builds['port']['f64']
    for key in ('indptrT', 'tmplAll', 'tmplStart', 'tStartRow', 'tLen',
                'rowLen', 'perm'):
        np.testing.assert_array_equal(getattr(H32.Anear.meta, key),
                                      getattr(H64.Anear.meta, key))
    for n in ('near_enum', 'block_near_count'):
        assert len(s32[n]) == len(s64[n])
        for a, b in zip(s32[n], s64[n]):
            for u, v in zip(a if n == 'near_enum' else (a,),
                            b if n == 'near_enum' else (b,)):
                assert torch.equal(u, v), n
    assert s32['block_near_count'], 'the block engine made no K11 call'


@pytest.mark.parametrize('engine', ENGINES)
def test_near_data_matches_jax(builds, engine):
    """The float32 near data of every kernel and route of the engine
    (K1's slot and tree targets, K12 and K6, or K6 alone) against the JAX
    package's float32 data."""
    Hj = builds['jax'][engine]
    H, seen = builds['port'][engine]
    assert H.Anear.dtype == F32 and H.dtype == F32
    assert np.asarray(Hj.Anear.dataZ).dtype == np.float32
    quad = ('panel_scatter_slots', 'panel_scatter_tree', 'near_enum_quad',
            'far_field') + (('block_near_quad',) if engine == 'block'
                            else ())
    for n in quad:
        # K1's slots also into the touching panels' float64 shadow
        want = {F32, torch.float64} if n == 'panel_scatter_slots' else {F32}
        assert seen[n] and set(seen[n]) == want, (n, seen[n])
    if engine == 'flat':
        assert not seen['block_near_quad'] and not seen['block_near_count']
    err = _rel(H.Anear.dataT.numpy(), np.asarray(Hj.Anear.dataZ[:-1]))
    assert err <= TOL, err


def test_far_field_and_bases_match_jax(builds):
    """Kall (K7 in float32, scaled by -2), leafPhi and the transfers T of
    the float32 operator against the JAX package's, each relative to its
    largest entry."""
    Hj = builds['jax']['block']
    H, _ = builds['port']['block']
    Kj = np.concatenate([np.asarray(lv.K) for lv in Hj.levels
                         if lv.K is not None])
    for got, ref in ((H.Kall, Kj), (H.leafPhi, Hj.leafPhi)):
        assert got.dtype == F32 and np.asarray(ref).dtype == np.float32
        assert _rel(got.numpy(), ref) <= TOL
    for ell, lv in enumerate(Hj.levels):
        if ell == 0:
            continue
        a, b = H.levelOff[ell], H.levelOff[ell + 1]
        assert _rel(H.Ttr[a:b].numpy(), lv.T) <= TOL


def _carry(Hj, dtype):
    """The port's H2Matrix from the arrays of a JAX H2Matrix."""
    A, mt = Hj.Anear, Hj.Anear.meta

    def arr(v):
        return None if v is None else np.asarray(v)
    levels = [dict(size=lv.size, T=arr(lv.T), parentIdx=arr(lv.parentIdx),
                   K=arr(lv.K), src=arr(lv.src), dst=arr(lv.dst))
              for lv in Hj.levels]
    return h2FromArrays(np.asarray(A.dataZ[:-1]), mt.indptrT, mt.tmplAll,
                        mt.tmplStart, mt.tStartRow, mt.tLen, mt.rowLen,
                        mt.perm, mt.N, np.asarray(Hj.leafDofs),
                        np.asarray(Hj.leafPhi), *Hj.leafLevelPos, levels,
                        device='cpu', dtype=dtype)


def test_k7_k8_plain_float32_match_jax(builds):
    """K7's plain float32 version on the JAX float32 grids against
    _farFieldBlocks; K8's plain float32 version on the arrays of the JAX
    float32 operator (interop.h2FromArrays with dtype) against
    _h2_matvec, and the carried operator's diagonal."""
    m, dim = builds['mesh'], builds['dim']
    pj = jasm.nonlocalBuilder(jfem.P1_DoFMap(m), jKernel(dim, S), params={
        'dtype': np.float32}).planH2()
    gi = np.asarray(pj['farGi'], dtype=np.float32)
    gj = np.asarray(pj['farGj'], dtype=np.float32)
    Kj = np.asarray(jasm._farFieldBlocks(jnp.asarray(gi), jnp.asarray(gj),
                                         kernel=jKernel(dim, S)))
    assert Kj.dtype == np.float32
    prof = builderFromArrays(m.vertices, m.cells, S, dim, device='cpu') \
        .kernel.profileParams()
    K = tasm.far_field(torch.as_tensor(gi), torch.as_tensor(gj), prof)
    assert K.dtype == F32
    assert _rel(K.numpy(), Kj) <= TOL
    Hj = builds['jax']['block']
    op = _carry(Hj, np.float32)
    assert op.dtype == F32
    x = _x(op.num_rows).astype(np.float32)
    yj = np.asarray(jh2._h2_matvec(Hj, jnp.asarray(x)))
    assert yj.dtype == np.float32
    out = torch.empty(op.num_rows, dtype=F32)
    y = op.matvec(torch.as_tensor(x), out=out)
    assert y is out and _rel(y.numpy(), yj) <= TOL
    assert _rel(op.diagonal.numpy(), np.asarray(Hj.diagonal)) <= TOL


@pytest.mark.parametrize('engine', ENGINES)
def test_apply_and_diagonal_match_jax(builds, engine):
    """The port's float32 operator applied (K8's plain float32 version) and
    its diagonal against the JAX package's float32 operator."""
    Hj = builds['jax'][engine]
    H, _ = builds['port'][engine]
    x = _x(H.num_rows).astype(np.float32)
    yj = np.asarray(jh2._h2_matvec(Hj, jnp.asarray(x)))
    y = H.matvec(torch.as_tensor(x))
    assert y.dtype == F32 and _rel(y.numpy(), yj) <= TOL
    assert H.diagonal.dtype == F32
    assert _rel(H.diagonal.numpy(), np.asarray(Hj.diagonal)) <= TOL


def test_cg_jacobi_iterations_match_jax(builds):
    """CG-Jacobi (1e-6, 500 at most) on each package's float32 operator
    with the float32 load b = M 1: iterations within 2, solutions within
    1e-4 of the largest entry."""
    from pynucleus_tpu.base.solvers import solverFactory as jsf
    from pynucleus_tpu_torch.base.solvers import solverFactory as tsf
    m = builds['mesh']
    dm = jfem.P1_DoFMap(m)
    b = np.asarray(jfem.assembleRHS(dm, jfem.constant(1.0)).data,
                   dtype=np.float32)
    H, _ = builds['port']['block']
    cj = jsf.build('cg-jacobi', A=builds['jax']['block'], setup=True)
    ct = tsf.build('cg-jacobi', A=H, setup=True)
    for c in (cj, ct):
        c.tolerance = 1e-6
        c.maxIter = 500
    uj = np.asarray(cj.solve(jnp.asarray(b)))
    ut = ct.solve(torch.as_tensor(b))
    assert ut.dtype == F32 and uj.dtype == np.float32
    assert abs(ct.iterations - cj.iterations) <= 2, (ct.iterations,
                                                     cj.iterations)
    assert _rel(ut.numpy(), uj) <= 1e-4


# the JAX package's own float32 gaps on each mesh (its block-engine
# getH2 in float32 and float64, x = _x(N)): the apply's max|H32 x - H64 x|
# / max|H64 x| and the diagonal's, from its CPU runs; the slow twin of
# test_float32_gap_within_twice_jax below recomputes them
JAX_GAPS = {'interval': (0.00013548288660753685, 0.0001659931031258433),
            'circle': (1.219681958796679e-06, 1.8387663010991845e-06)}


def _jaxGaps(J32, J64, x):
    return (_rel(np.asarray(jh2._h2_matvec(J32, jnp.asarray(
        x.astype(np.float32)))), np.asarray(jh2._h2_matvec(
            J64, jnp.asarray(x)))),
        _rel(np.asarray(J32.diagonal), np.asarray(J64.diagonal)))


def test_float32_gap_within_twice_jax(builds):
    """max|H32 x - H64 x| / max|H64 x| and the diagonal's gap of the port
    no more than twice the JAX package's own on the mesh (float32
    rounding, not a porting error; the JAX gaps pinned in JAX_GAPS)."""
    (H32, _), (H64, _) = builds['port']['block'], builds['port']['f64']
    gapJ, dJ = JAX_GAPS[builds['name']]
    x = _x(H32.num_rows)
    gapT = _rel(H32.matvec(torch.as_tensor(x.astype(np.float32))).numpy(),
                H64.matvec(torch.as_tensor(x)).numpy())
    assert 0 < gapT <= 2 * gapJ, (gapT, gapJ)
    dT = _rel(H32.diagonal.numpy(), H64.diagonal.numpy())
    assert 0 < dT <= 2 * dJ, (dT, dJ)


@pytest.mark.slow
@pytest.mark.parametrize('name', list(MESHES))
def test_float32_gap_jax_pins(name):
    """The JAX package's own float32 gaps (its block-engine getH2 in
    float32 and float64) are the ones pinned in JAX_GAPS."""
    mp = pytest.MonkeyPatch()
    m, dim = _mesh(name)
    J32 = _jaxH2(m, dim, np.float32, 'block', mp)
    J64 = _jaxH2(m, dim, np.float64, 'block', mp)
    got = _jaxGaps(J32, J64, _x(J32.num_rows))
    np.testing.assert_allclose(got, JAX_GAPS[name], rtol=1e-6, atol=0)


def test_float64_h2_unchanged_by_dtype_param():
    """params={'dtype': np.float64} builds the float64 operator of the
    default build, bit for bit."""
    m, dim = _mesh('interval')
    a = builderFromArrays(m.vertices, m.cells, S, dim, device='cpu').getH2()
    b = builderFromArrays(m.vertices, m.cells, S, dim, dtype=np.float64,
                          device='cpu').getH2()
    assert a.dtype == b.dtype == torch.float64
    for u, v in ((a.Anear.dataZ, b.Anear.dataZ), (a.Kall, b.Kall),
                 (a.leafPhi, b.leafPhi), (a.Ttr, b.Ttr)):
        assert torch.equal(u, v)


def test_float32_h2_refusals():
    """Float32 raises NotImplementedError for the H2 of a profile other
    than the fractional one (the gaussian kernel's); K20 on a float32
    operator raises NotImplementedError; a float64 x on a float32
    operator, and float32 data with float64 tables, ValueError; on CPU
    tensors no launch is counted."""
    m = jfem.simpleInterval(-1.0, 1.0).refine().refine().refine()
    kw = dict(dtype=np.float32, device='cpu')
    b = builderFromArrays(m.vertices, m.cells, S, 1, **kw)
    with pytest.raises(NotImplementedError, match='float32'):
        builderFromArrays(m.vertices, m.cells, S, 1, kernelType='gaussian',
                          **kw).getH2()
    kernels.resetLaunches()
    H = b.getH2()
    assert not any(kernels.launches.values())
    x = torch.zeros(H.num_rows, dtype=F32)
    with pytest.raises(NotImplementedError, match='float64'):
        th2.h2_matvec_T(H, x)
    with pytest.raises(ValueError, match='float32'):
        H.matvec(x.double())
    assert H.T is H
    data = torch.zeros(5, dtype=F32)
    i2 = torch.zeros((1, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match='float32'):
        tasm.panel_scatter_slots(
            data, torch.zeros((3, 1), dtype=torch.float64), i2, i2,
            torch.zeros((1, 4), dtype=torch.int32),
            torch.ones(1, dtype=torch.float64), None,
            *(torch.ones((2, 3), dtype=torch.float64),) * 2,
            torch.ones(3, dtype=torch.float64),
            torch.ones((3, 4), dtype=torch.float64),
            b.kernel.profileParams())


@pytest.mark.cuda
def test_float32_h2_kernels_match_plain_on_gpu():
    """The float32 H2 operator built on the card (the float32 instances of
    K1's slot and tree targets, K6, K7 and K12; applied by K8's) against
    the one the plain versions build on the CPU: near data, far blocks and
    the apply to 1e-5 of the largest entry, on both engines (needs an
    NVIDIA GPU)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    m, dim = _mesh('circle')
    x = _x(m.num_vertices).astype(np.float32)
    for engine in ENGINES:
        ops = [builderFromArrays(m.vertices, m.cells, S, dim, dtype=np.float32,
                                 params={'nearEngine': engine}, device=dev)
               .getH2() for dev in ('cuda', 'cpu')]
        Hg, Hc = ops
        assert Hg.dtype == F32
        assert _rel(Hg.Anear.dataT.cpu().numpy(), Hc.Anear.dataT.numpy()) \
            <= TOL
        assert _rel(Hg.Kall.cpu().numpy(), Hc.Kall.numpy()) <= TOL
        xs = torch.as_tensor(x[:Hc.num_rows])
        assert _rel(Hg.matvec(xs.cuda()).cpu().numpy(),
                    Hc.matvec(xs).numpy()) <= TOL

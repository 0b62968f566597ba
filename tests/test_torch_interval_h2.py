"""The interval in H2, and the gaussian and exponential kernels, of the port
against the JAX package.

  profiles       nl.kernels.radialEval of every profile code, 1D and 2D,
                 against _radial_eval on 10^3 seeded r^2 (0 included):
                 1e-14 relative per value, 1e-13 for the erfc form
  kernels        the gaussian and exponential kernels' scaling,
                 exponentParam, variance and boundary kernel: equal
  K5, K11 (1D)   the plain near_enum and block_near_count on the inputs of
                 _enum_phase1 and _block_near_count recorded from the JAX
                 package's getH2 at the interval's noRef 6, s = 0.25 and
                 0.75: keys, pT, histograms and counts equal
  near field     each engine's 1D H2 near data against the JAX package's
                 forceDeviceCSR build with the same engine at noRef 5 and
                 6: 1e-12 of max|data|; the union-surface items (cells,
                 facets, normals, cluster pairs) equal array for array
  far field      1e-12 relative; the H2 apply 1e-10 relative
  H2 vs dense    the port's H2 against its dense operator, the fractional
                 and the gaussian kernel: 1e-5 relative
                 (tests/test_devicecsr_nearfield.py:14-35)
  drivers        runFractional interval H2 (lu, cg-jacobi, cg-mg) against
                 the reference cache (tests/test_drivers_fractional.py:89-101,
                 rtol 3e-2) and the JAX driver, iterations equal +-1; the two
                 smooth runNonlocal lines against their caches
                 (tests/test_nonlocal_driver.py:83-104) and the JAX driver,
                 and the gaussian on the square (the 2D profiles) against
                 the JAX driver

(1e-12: the same float64 quadrature summed in another order.)  The JAX
side runs on the CPU as the JAX package's own tests run it; the port's
kernel wrappers run their plain versions on CPU tensors.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.nl import getFractionalKernel as jFrac
from pynucleus_tpu.nl import getIntegrableKernel as jInt
from pynucleus_tpu.nl import assembly as jasm

from pynucleus_tpu_torch.interop import fromArrays
from pynucleus_tpu_torch.nl import assembly as tasm
from pynucleus_tpu_torch.nl import kernels as tker

TOL = 1e-12
ENGINES = {'block': {}, 'flat': {'PYNUCLEUS_TPU_BLOCK_NEAR': '0'},
           'host': {'PYNUCLEUS_TPU_HOST_ENUM': '1'}}
RECORDED = ('_enum_phase1', '_block_near_count')


def _interval(noRef):
    """The runFractional interval mesh of noRef: [-1, 1] refined noRef + 1
    times (the driver's coarse mesh is refined once to hold a dof)."""
    m = jfem.simpleInterval(-1.0, 1.0)
    for _ in range(noRef + 1):
        m = m.refine()
    return m


def _t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _i32(a):
    return _t(a, torch.int32)


def _assertData(got, ref):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(np.asarray(got) - ref).max() <= TOL * scale


# --------------------------------------------------------------- profiles

PROFILE_CASES = [('fractional', 1, tker.POWER), ('fractional', 2, tker.POWER),
                 ('gaussian', 1, tker.GAUSSIAN_PROFILE),
                 ('gaussian', 2, tker.GAUSSIAN_PROFILE),
                 ('exponential', 1, tker.EXPONENTIAL_PROFILE),
                 ('exponential', 2, tker.EXPONENTIAL_PROFILE),
                 ('gaussianBoundary', 1, tker.GAUSSIAN_BOUNDARY_1D),
                 ('gaussianBoundary', 2, tker.GAUSSIAN_BOUNDARY_2D),
                 ('exponentialBoundary', 1, tker.EXPONENTIAL_BOUNDARY_1D),
                 ('exponentialBoundary', 2, tker.EXPONENTIAL_BOUNDARY_2D)]


def _kernelPair(kind, dim):
    """(JAX kernel, port kernel) of one profile case: the fractional kernel
    of order 0.75, the gaussian of variance 0.1, the exponential of rate 8
    (in 2D with a given scaling: it has no normalization there), or the
    boundary kernel of one of the latter two."""
    base = kind.replace('Boundary', '')
    if base == 'fractional':
        pair = (jFrac(dim, 0.75), tker.getFractionalKernel(dim, 0.75))
    else:
        kw = dict(gaussian_variance=0.1, exponentialRate=8.0,
                  scaling=0.7 if (base, dim) == ('exponential', 2) else None)
        pair = (jInt(dim, base, np.inf, **kw),
                tker.getIntegrableKernel(dim, base, np.inf, **kw))
    if kind.endswith('Boundary'):
        pair = tuple(k.getBoundaryKernel() for k in pair)
    return pair


@pytest.mark.parametrize('kind,dim,code', PROFILE_CASES,
                         ids=[f'{k}-{d}d' for k, d, _ in PROFILE_CASES])
def test_profiles_match_jax(kind, dim, code):
    jk, tk = _kernelPair(kind, dim)
    prof = tk.profileParams()
    assert prof.code == code
    rng = np.random.default_rng(7)
    r2 = np.concatenate([[0.0], rng.uniform(0.0, 4.0, 499),
                         10.0 ** rng.uniform(-10.0, 0.5, 500)])
    ref = np.asarray(jasm._radial_eval(jk, jnp.asarray(r2)))
    got = tker.radialEval(torch.as_tensor(r2), prof).numpy()
    tol = 1e-13 if code == tker.GAUSSIAN_BOUNDARY_1D else 1e-14
    assert got[0] == 0.0 and ref[0] == 0.0
    assert (ref[1:] != 0.0).all()
    assert np.all(np.abs(got - ref) <= tol * np.abs(ref))


SMOOTH = [('gaussian', 1, {'gaussian_variance': 0.1}),
          ('gaussian', 2, {'gaussian_variance': 0.1}),
          ('exponential', 1, {'exponentialRate': 8.0})]


@pytest.mark.parametrize('kind,dim,kw', SMOOTH,
                         ids=[f'{k}-{d}d' for k, d, _ in SMOOTH])
def test_smooth_kernels_match_jax(kind, dim, kw):
    jk = jInt(dim, kind, np.inf, **kw)
    tk = tker.getIntegrableKernel(dim, kind, np.inf, **kw)
    for a, b in ((jk, tk), (jk.getBoundaryKernel(), tk.getBoundaryKernel())):
        assert (b.kernelType, b.dim, b.boundary, b.horizonValue) == \
            (a.kernelType, a.dim, a.boundary, a.horizonValue)
        assert (b.scalingValue, b.singularityValue, b.exponentParam,
                b.variance) == (a.scalingValue, a.singularityValue,
                                a.exponentParam, a.variance)
        assert repr(b) == repr(a)
    assert tk.getBoundaryKernel().scalingValue == 2.0 * tk.scalingValue
    # of a finite horizon: the JAX package's scaling and exponent
    fj, ft = jInt(dim, kind, 0.5, **kw), \
        tker.getIntegrableKernel(dim, kind, 0.5, **kw)
    assert (ft.scalingValue, ft.exponentParam, ft.horizonValue) == \
        (fj.scalingValue, fj.exponentParam, fj.horizonValue)


def test_no_fallback_for_other_profiles():
    """K14 and K15 evaluate the profiles of a finite horizon only and raise
    on any other (here a boundary kernel's); a wrapper given a bare (C, e)
    instead of a Profile raises."""
    prof = tker.getIntegrableKernel(1, 'gaussian', np.inf,
                                    gaussian_variance=0.1) \
        .getBoundaryKernel().profileParams()
    f64, i64 = torch.float64, torch.int64
    one = torch.ones(2, dtype=f64)
    with pytest.raises(NotImplementedError, match='profile code'):
        tasm.cut1d(torch.zeros((2, 2), dtype=f64), 'dense',
                   torch.zeros((1, 4), dtype=i64),
                   torch.zeros((2, 1), dtype=f64),
                   torch.zeros((1, 2), dtype=i64),
                   torch.zeros((1, 2), dtype=i64), one[:1], one, one, one,
                   one, 0.2, prof)
    with pytest.raises(NotImplementedError, match='profile code'):
        tasm.cut2d_polar(torch.zeros((3, 3), dtype=f64), 'dense',
                         torch.zeros((1, 6), dtype=i64),
                         torch.zeros((3, 2), dtype=f64),
                         torch.zeros((1, 3), dtype=i64),
                         torch.zeros((1, 3), dtype=i64), one[:1],
                         torch.ones((3, 2), dtype=f64), one, one, one, one,
                         one, 0.2, 1, prof)
    g = torch.zeros((1, 2, 1), dtype=f64)
    with pytest.raises(ValueError, match='Profile'):
        tasm.far_field(g, g, (1.0, -0.875))
    with pytest.raises(ValueError, match='Profile'):
        tker.radialEval(one, (prof.C, prof.e))


# ------------------------------------------------------------ near field

def _buildJax(m, kernel, env, record=None):
    """JAX getH2 (forceDeviceCSR) under the engine environment ``env``;
    with ``record`` (a dict) the inputs of its programs RECORDED and its
    union-surface items."""
    dm = jfem.P1_DoFMap(m)
    with pytest.MonkeyPatch.context() as mp:
        for k in ('PYNUCLEUS_TPU_BLOCK_NEAR', 'PYNUCLEUS_TPU_HOST_ENUM'):
            mp.delenv(k, raising=False)
        for k, v in env.items():
            mp.setenv(k, v)
        if record is not None:
            launch = jasm._launch

            def rec(fn, *args, _statics=None, _force=False, **kw):
                name = getattr(fn, '__name__', '')
                if name in RECORDED:
                    record.setdefault(name, []).append(
                        ([a if isinstance(a, (int, float)) else np.asarray(a)
                          for a in args], dict(_statics or {})))
                return launch(fn, *args, _statics=_statics, _force=_force,
                              **kw)
            surface = jasm.nonlocalBuilder._runUnionSurface

            def recSurface(self, acc, surfPairs, *a):
                record['surface'] = tuple(np.array(x) for x in surfPairs)
                return surface(self, acc, surfPairs, *a)
            mp.setattr(jasm, '_launch', rec)
            mp.setattr(jasm.nonlocalBuilder, '_runUnionSurface', recSurface)
        H = jasm.nonlocalBuilder(dm, kernel,
                                 params={'forceDeviceCSR': True}).getH2()
    return dm, H


def _buildPort(m, s, engine, record=None):
    """The port's getH2 with ``engine``; with ``record`` (a dict) its
    union-surface items."""
    _, tdm, tk = fromArrays(m.vertices, m.cells, s, 1, device='cpu')
    b = tasm.nonlocalBuilder(tdm, tk, params={'nearEngine': engine})
    if record is None:
        return b.getH2()
    surface = tasm.nonlocalBuilder._runUnionSurface

    def recSurface(self, acc, surf, *a):
        record['surface'] = surf
        return surface(self, acc, surf, *a)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tasm.nonlocalBuilder, '_runUnionSurface', recSurface)
        return b.getH2()


@pytest.fixture(scope='module', params=[0.25, 0.75], ids=['s0.25', 's0.75'])
def recorded(request):
    """The flat and block JAX builds at noRef 6 with the inputs of
    _enum_phase1 and _block_near_count recorded."""
    m = _interval(6)
    rec = {}
    for engine in ('flat', 'block'):
        _buildJax(m, jFrac(1, request.param), ENGINES[engine], rec)
    for name in RECORDED:
        assert rec.get(name), name
    return rec


def test_enum_phase1_1d_vs_near_enum(recorded):
    seen = 0
    for args, statics in recorded['_enum_phase1']:
        assert statics['mdim'] == 1
        (cum, offI, offJ, n2, IA, JA, ncArr, cells, cellNodes, centers, logh,
         cA, cB, cC, Treal) = args
        assert centers.shape[0] == 1
        keys, pT, hist = (np.asarray(a) for a in jasm._enum_phase1(
            *args, **statics))
        k, p, h = tasm.near_enum(
            *(_i32(a) for a in (cum, offI, offJ, n2, IA, JA, ncArr, cells,
                                cellNodes)),
            _t(centers, torch.float32), _t(logh, torch.float32),
            (cA, cB, cC))
        T = int(Treal)
        np.testing.assert_array_equal(k.numpy(), keys[:T])
        np.testing.assert_array_equal(p.numpy(), pT[:T])
        # the JAX keys are padded to Tpad with the sentinel
        hist = hist.copy()
        hist[tasm.ENUM_SENTINEL] -= statics['Tpad'] - T
        np.testing.assert_array_equal(h.numpy(), hist)
        seen += int((keys[:T] != tasm.ENUM_SENTINEL).sum())
    assert seen > 0


def _cellNodes(dofs, dofNode):
    return np.where(dofs >= 0, dofNode[np.where(dofs >= 0, dofs, 0)], -1)


def test_block_near_count_1d_vs_jax(recorded):
    tot = np.zeros(tasm.N_CLASSES, dtype=np.int64)
    for args, statics in recorded['_block_near_count']:
        assert statics['mdim'] == 1
        (offI, offJ, n1, n2, I, J, cells, dofs, dofNode, ncArr, centers, logh,
         cA, cB, cC) = args
        ref = np.asarray(jasm._block_near_count(*args, **statics))
        ref = ref.reshape(-1, tasm.N_CLASSES)
        got = tasm.block_near_count(
            *(_i32(a.reshape(-1)) for a in (offI, offJ, n1, n2, I, J)),
            _i32(ncArr), _i32(cells), _i32(_cellNodes(dofs, dofNode)),
            _t(centers, torch.float32), _t(logh, torch.float32),
            (cA, cB, cC))
        np.testing.assert_array_equal(got.numpy(), ref)
        tot += ref.sum(axis=0)
    assert (tot[:4] > 0).sum() >= 2


@pytest.fixture(scope='module', params=[5, 6], ids=['noRef5', 'noRef6'])
def builds(request):
    """Per noRef: the JAX package's builds of the fractional kernel (s =
    0.75) on each engine, with the union-surface items of the first, and
    the port's."""
    m = _interval(request.param)
    jrec, trec = {}, {}
    jax = {e: _buildJax(m, jFrac(1, 0.75), ENGINES[e],
                        jrec if e == 'block' else None)[1] for e in ENGINES}
    port = {e: _buildPort(m, 0.75, e, trec if e == 'block' else None)
            for e in ENGINES}
    return dict(m=m, jax=jax, port=port, jrec=jrec, trec=trec)


@pytest.mark.parametrize('engine', list(ENGINES))
def test_near_data_1d_matches_jax(builds, engine):
    H, Ht = builds['jax'][engine], builds['port'][engine]
    mt = H.Anear.meta
    np.testing.assert_array_equal(Ht.Anear.meta.indptrT, mt.indptrT)
    np.testing.assert_array_equal(Ht.Anear.meta.tmplAll, mt.tmplAll)
    np.testing.assert_array_equal(Ht.Anear.meta.perm, mt.perm)
    _assertData(Ht.Anear.dataT.numpy(), H.Anear.dataZ[:-1])


def test_surface_items_1d_match_jax(builds):
    cells, facets, normals, I, J, sgn = builds['jrec']['surface']
    got = builds['trec']['surface']
    assert len(cells) > 0 and (sgn == 1.0).all()
    for a, b in zip(got, (cells, facets, normals, I, J)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_far_field_and_apply_1d_match_jax(builds):
    H, Ht = builds['jax']['block'], builds['port']['block']
    Ks = [np.asarray(lv.K) for lv in H.levels if lv.K is not None]
    assert Ks
    ref = np.concatenate(Ks)
    got = Ht.Kall.numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= TOL * np.abs(ref).max()
    x = np.random.default_rng(0).normal(size=H.num_rows)
    yj = np.asarray(H.matvec(jnp.asarray(x)))
    for Hp in builds['port'].values():
        yt = Hp.matvec(torch.as_tensor(x)).numpy()
        assert np.linalg.norm(yt - yj) <= 1e-10 * np.linalg.norm(yj)


@pytest.mark.parametrize('kind', ['fractional', 'gaussian'])
def test_h2_matches_dense_1d(kind):
    m = _interval(6)
    kw = dict(kernelType='gaussian', gaussianVariance=0.1) \
        if kind == 'gaussian' else {}
    _, tdm, tk = fromArrays(m.vertices, m.cells, 0.75, 1, device='cpu', **kw)
    H = tasm.nonlocalBuilder(tdm, tk).getH2()
    D = tasm.nonlocalBuilder(tdm, tk).getDense()
    x = torch.as_tensor(np.random.default_rng(0).normal(size=tdm.num_dofs))
    ref = D.matvec(x)
    assert float(torch.linalg.norm(H.matvec(x) - ref)
                 / torch.linalg.norm(ref)) < 1e-5


# --------------------------------------------------------------- drivers

# tests/test_drivers_fractional.py:95-98 (reference cache)
H2_CACHE = {'Hs error': 0.041849732677658555,
            'L2 error': 0.001458788789368659,
            'L2 error interpolated': 0.001089628333551184,
            'Linf error interpolated': 0.0009871148528776685}
# errors against the JAX driver: the operators agree to 1e-12, the error
# formulas cancel a few digits
RTOL_JAX = 1e-6


def _fractional(solver):
    return ['--domain', 'interval', '--s', 'const(0.75)', '--problem',
            'constant', '--element', 'P1', '--solverType', solver,
            '--matrixFormat', 'H2']


@pytest.mark.parametrize('solver', ['lu', 'cg-jacobi', 'cg-mg'])
def test_runFractional_interval_h2(solver):
    from drivers.runFractional import main as jMain
    from pynucleus_tpu_torch.drivers.runFractional import main as tMain
    d, _ = jMain(_fractional(solver))
    out = tMain(_fractional(solver) + ['--device', 'cpu'], quiet=True)
    ej, et = d.outputGroups['errors'].toDict(), out['errors'].toDict()
    assert set(et) == set(ej)
    for label, val in ej.items():
        assert np.isclose(et[label], val, rtol=RTOL_JAX, atol=0), \
            (label, et[label], val)
    for label, val in H2_CACHE.items():
        assert np.isclose(et[label], val, rtol=3e-2, atol=1e-8), \
            (label, et[label], val)
    rj, rt = d.outputGroups['results'].toDict(), out['results'].toDict()
    assert rt['dofs'] == rj['dofs'] == 127
    assert abs(rt['iterations'] - rj['iterations']) <= 1
    if solver == 'cg-mg':
        assert len(out['hierarchy']) == 7
        assert all(type(lv['A']).__name__ == 'H2Matrix'
                   for lv in out['hierarchy'])


SMOOTH_LINES = [
    (['--domain', 'interval', '--kernelType', 'gaussian', '--problem',
      'gaussian', '--gaussianVariance', '0.1'], 2.9565447289171816e-03, 511),
    (['--domain', 'interval', '--kernelType', 'exponential', '--problem',
      'exponential', '--exponentialRate', '8.0'], 2.5530396949181036e-04,
     511),
    # the 2D profiles on the plain square (no reference cache)
    (['--domain', 'square', '--kernelType', 'gaussian', '--problem',
      'gaussian', '--gaussianVariance', '0.1', '--noRef', '3'], None, 225)]


@pytest.mark.parametrize('flags,cache,dofs', SMOOTH_LINES,
                         ids=['gaussian-H2', 'exponential-H2',
                              'gaussian-square-H2'])
def test_runNonlocal_smooth_lines(flags, cache, dofs):
    from drivers.runNonlocal import main as jMain
    from pynucleus_tpu_torch.drivers.runNonlocal import main as tMain
    argv = flags + ['--interaction', 'fullSpace', '--horizon', 'inf',
                    '--solverType', 'lu', '--matrixFormat', 'H2']
    d, _ = jMain(argv)
    out = tMain(argv + ['--device', 'cpu'], quiet=True)
    ej, et = d.outputGroups['errors'].toDict(), out['errors'].toDict()
    assert set(et) == set(ej)
    for label, val in ej.items():
        assert np.isclose(et[label], val, rtol=RTOL_JAX, atol=0), \
            (label, et[label], val)
    if cache is not None:
        assert np.isclose(et['L2 error interpolated'], cache, rtol=3e-2)
    assert out['results'].toDict()['dofs'] == \
        d.outputGroups['results'].toDict()['dofs'] == dofs


@pytest.mark.cuda
def test_smooth_profiles_kernels_match_plain_on_gpu():
    """K1, K6, K7, K12 and the near-field engines with the gaussian
    profile on the card, each launch against its plain version (needs an
    NVIDIA GPU)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    m = _interval(6)
    _, tdm, tk = fromArrays(m.vertices, m.cells, 0.75, 1, device='cuda',
                            kernelType='gaussian', gaussianVariance=0.1)
    _, cdm, ck = fromArrays(m.vertices, m.cells, 0.75, 1, device='cpu',
                            kernelType='gaussian', gaussianVariance=0.1)
    for engine in tasm.NEAR_ENGINES:
        p = {'nearEngine': engine}
        Hg = tasm.nonlocalBuilder(tdm, tk, params=p).getH2()
        Hc = tasm.nonlocalBuilder(cdm, ck, params=p).getH2()
        _assertData(Hg.Anear.dataT.cpu().numpy(), Hc.Anear.dataT.numpy())

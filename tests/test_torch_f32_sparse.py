"""The float32 remainder of the port (``params={'dtype': np.float32}``)
against the JAX package's float32 programs, on the same meshes: getSparse
and getDiagonal of a finite horizon, getDiagonal of the infinite one, CG
on the float32 sparse operator, getH2 with the host engine, and
DistributedH2Matrix of a float32 H2.  On the CPU the port runs the plain
float32 versions of K1's slot and diagonal targets into float64 (with the
indicator), K9 and K13.

  getSparse         runNonlocal's square at noRef 1 (ball2 and ballInf)
                    and the interval at noRef 6, horizon 0.2: the JAX
                    pattern, float32 data within 5e-6 of the largest entry
                    (float32 local entries summed in float64, cast once)
  getDiagonal       the disc at noRef 2 (zero exterior) and the square:
                    float64, within 5e-6 relative of the JAX float32
                    getDiagonal; of a finite horizon within one float32
                    ulp of the port's own float32 sparse diagonal (equal in
                    the JAX package)
  cut pairs         both packages run K14 and K15 in float64 on the float32
                    paths (the JAX _runCutPairs passes float64 vertices)
  CG-Jacobi         on the float32 sparse operator: iterations within 2 of
                    _cg_core's, the solution within 1e-4 relative
  host engine       getH2 with nearEngine='host' on the disc at noRef 2:
                    near data within 5e-6 of the largest entry (the JAX
                    host engine, PYNUCLEUS_TPU_HOST_ENUM), the apply 1e-5
  distributed       DistributedH2Matrix of a float32 H2 (halo, bcast) and
                    .assemble in float32, the interval at noRef 8 over 4
                    shards: a float64 apply, within 1e-5 relative of the
                    JAX package's, within 1e-12 of the port's own H2 on
                    the upcast coefficients (H2Matrix.double)
  refusals          what the float32 paths still refuse raises
                    NotImplementedError naming ROADMAP.md; the JAX package
                    runs it
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.nl import getFractionalKernel as jKernel
from pynucleus_tpu.nl import assembly as jasm
from pynucleus_tpu.nl import kernels as jk
from pynucleus_tpu.nl.kernels import (getIntegrableKernel as jIntegrable,
                                      ball2 as jBall2, ballInf as jBallInf)
from pynucleus_tpu.nl.problems import nonlocalMeshFactory, DIRICHLET
from pynucleus_tpu.parallel import makeDeviceMesh as jMesh
from pynucleus_tpu.parallel.dist_h2 import DistributedH2Matrix as jDistH2

from pynucleus_tpu_torch import kernels
from pynucleus_tpu_torch.interop import builderFromArrays, fromArrays
from pynucleus_tpu_torch.nl import assembly as tasm
from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder
from pynucleus_tpu_torch.parallel import makeDeviceMesh, DistributedH2Matrix

TOL = 5e-6
F32 = torch.float32
HORIZON = 0.2
S = 0.75


@pytest.fixture(autouse=True, scope='module')
def _oneTorchThread():
    """One torch thread: the tensors are small, and the workers of a
    parallel test run share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, ref):
    scale = np.abs(ref).max()
    assert scale > 0
    return float(np.abs(np.asarray(got, dtype=np.float64)
                        - np.asarray(ref, dtype=np.float64)).max() / scale)


def _finite(domain, noRef, interaction='ball2'):
    """runNonlocal's mesh of ``domain`` (its collar of the horizon) at
    noRef, the JAX float32 builder of the indicator kernel and the port's
    on the same arrays."""
    dim = {'interval': 1, 'square': 2}[domain]
    k = jIntegrable(dim, 'indicator', HORIZON,
                    interaction={'ball2': jBall2,
                                 'ballInf': jBallInf}[interaction]())
    mesh, info = nonlocalMeshFactory.build(domain, kernel=k,
                                           boundaryCondition=DIRICHLET)
    for _ in range(noRef):
        mesh = mesh.refine()
    dm = jfem.P1_DoFMap(mesh, tag=info['domain'])
    interior = np.zeros(mesh.num_vertices, dtype=bool)
    c, loc = np.nonzero(dm.dofs >= 0)
    interior[mesh.cells[c, loc]] = True
    _, tdm, tk = fromArrays(mesh.vertices, mesh.cells, 0.0, dim,
                            device='cpu', kernelType='constant',
                            horizon=HORIZON, interaction=interaction,
                            interior=interior)
    params = {'dtype': np.float32}
    return (jasm.nonlocalBuilder(dm, k, params=params),
            nonlocalBuilder(tdm, tk, params=dict(params)), dm)


CASES = {'square-ball2': ('square', 1, 'ball2'),
         'square-ballInf': ('square', 1, 'ballInf'),
         'interval': ('interval', 6, 'ball2')}


_SPARSE = {}


@pytest.fixture
def sparse(case):
    """Both packages' float32 getSparse of one case, and their builders
    (built once per case)."""
    if case not in _SPARSE:
        jb, tb, dm = _finite(*CASES[case])
        _SPARSE[case] = dict(dm=dm, jb=jb, tb=tb, jS=jb.getSparse(),
                             tS=tb.getSparse())
    return _SPARSE[case]


@pytest.fixture(scope='module', autouse=True)
def _dropSparse():
    yield
    _SPARSE.clear()


@pytest.mark.parametrize('case', list(CASES))
def test_sparse_matches_jax(sparse):
    jS, tS = sparse['jS'], sparse['tS']
    np.testing.assert_array_equal(tS.indptrH, np.asarray(jS.indptr))
    np.testing.assert_array_equal(tS.indicesH, np.asarray(jS.indices))
    assert tS.data.dtype == F32 and np.asarray(jS.data).dtype == np.float32
    assert _rel(tS.dataH, np.asarray(jS.data)) <= TOL


@pytest.mark.parametrize('case', ['square-ball2', 'interval'])
def test_diagonal_of_finite_horizon(sparse):
    """float64, as the JAX float32 getDiagonal, within 5e-6 of it; within
    one float32 ulp of the port's own float32 sparse diagonal (the JAX
    package's sparse diagonal equals float32(getDiagonal()))."""
    jD = np.asarray(sparse['jb'].getDiagonal().data)
    tD, tS = sparse['tb'].getDiagonal().data, sparse['tS']
    assert tD.dtype == torch.float64 and jD.dtype == np.float64
    assert _rel(tD.numpy(), jD) <= TOL
    d32 = tD.numpy().astype(np.float32)
    dS = tS.to_scipy().diagonal()
    assert (np.abs(dS - d32) <= np.spacing(np.abs(d32))).all()
    jS = sparse['jS']
    rows = np.repeat(np.arange(len(jD)), np.diff(np.asarray(jS.indptr)))
    onDiag = rows == np.asarray(jS.indices)
    np.testing.assert_array_equal(np.asarray(jS.data)[onDiag],
                                  jD.astype(np.float32))


def test_cut_pairs_run_in_float64(monkeypatch):
    """On the float32 sparse path the JAX _runCutPairs passes float64
    vertices and volumes to _bucket_cut1d, and the port runs K14 on
    float64 ones: K14 and K15 have no float32 instance to port."""
    seen = {'jax': [], 'port': []}
    launch = jasm._launch

    def jrec(fn, *args, **kw):
        if getattr(fn, '__name__', '') == '_bucket_cut1d':
            seen['jax'].append((args[0].dtype, args[3].dtype))
        return launch(fn, *args, **kw)
    cut1d = tasm.cut1d

    def trec(out, target, index, vertices, vi1, vi2, vols1, *args):
        seen['port'].append((vertices.dtype, vols1.dtype, out.dtype))
        return cut1d(out, target, index, vertices, vi1, vi2, vols1, *args)
    monkeypatch.setattr(jasm, '_launch', jrec)
    monkeypatch.setattr(tasm, 'cut1d', trec)
    jb, tb, _ = _finite('interval', 3)
    jb.getSparse()
    tb.getSparse()
    assert seen['jax'] and set(seen['jax']) == {(np.dtype('float64'),) * 2}
    assert seen['port'] and set(seen['port']) == {(torch.float64,) * 3}


def test_diagonal_of_the_disc_matches_jax():
    """The fractional kernel (s 0.75) on the disc at noRef 2 with its
    zero-exterior term: the port's float32 getDiagonal is float64 and
    within 5e-6 relative of the JAX float32 getDiagonal; it is K1's
    float32 diagonal target, with normals for the exterior rows."""
    m = jfem.circle(h=0.78, radius=1.0)
    for _ in range(2):
        m = m.refine()
    Dj = np.asarray(jasm.nonlocalBuilder(
        jfem.P1_DoFMap(m), jKernel(2, S),
        params={'dtype': np.float32}).getDiagonal().data)
    seen = []
    diag = tasm.panel_scatter_diag

    def rec(d, vertices, *args, **kw):
        seen.append((d.dtype, vertices.dtype, args[4] is not None))
        return diag(d, vertices, *args, **kw)
    tasm.panel_scatter_diag = rec
    try:
        Dt = builderFromArrays(m.vertices, m.cells, S, 2, dtype=np.float32,
                               device='cpu').getDiagonal().data
    finally:
        tasm.panel_scatter_diag = diag
    assert Dt.dtype == torch.float64 and Dj.dtype == np.float64
    assert _rel(Dt.numpy(), Dj) <= TOL
    assert {(d, v) for d, v, _ in seen} == {(torch.float64, F32)}
    assert any(n for *_, n in seen)


@pytest.mark.parametrize('case', list(CASES))
def test_cg_jacobi_on_float32_sparse_matches_jax(sparse):
    """CG-Jacobi (1e-6, 500 at most) on each package's float32 sparse
    operator with the float32 load b = M 1: iterations within 2 of
    _cg_core's, solutions within 1e-4 relative."""
    from pynucleus_tpu.base.solvers import solverFactory as jsf
    from pynucleus_tpu_torch.base.solvers import solverFactory as tsf
    b = np.asarray(jfem.assembleRHS(sparse['dm'], jfem.constant(1.0)).data,
                   dtype=np.float32)
    cj = jsf.build('cg-jacobi', A=sparse['jS'], setup=True)
    ct = tsf.build('cg-jacobi', A=sparse['tS'], setup=True)
    for c in (cj, ct):
        c.tolerance = 1e-6
        c.maxIter = 500
    uj = np.asarray(cj.solve(jnp.asarray(b)))
    ut = ct.solve(torch.as_tensor(b))
    assert ut.dtype == F32 and uj.dtype == np.float32
    assert abs(ct.iterations - cj.iterations) <= 2, (ct.iterations,
                                                     cj.iterations)
    assert _rel(ut.numpy(), uj) <= 1e-4


def test_host_engine_h2_matches_jax(monkeypatch):
    """getH2 with nearEngine='host' in float32 on the disc at noRef 2: K13's
    float32 plain version (and K1's touching panels in a float64 shadow,
    cast once) against the JAX host engine's float32 operator: near data
    within 5e-6 of the largest entry, the apply within 1e-5 of max|y|."""
    m = jfem.circle(h=0.78, radius=1.0)
    for _ in range(2):
        m = m.refine()
    monkeypatch.setenv('PYNUCLEUS_TPU_HOST_ENUM', '1')
    Hj = jasm.nonlocalBuilder(jfem.P1_DoFMap(m), jKernel(2, S), params={
        'dtype': np.float32, 'forceDeviceCSR': True}).getH2()
    seen = []
    quad = tasm.tree_csr_quad

    def rec(data, *args):
        seen.append(data.dtype)
        return quad(data, *args)
    monkeypatch.setattr(tasm, 'tree_csr_quad', rec)
    Ht = builderFromArrays(m.vertices, m.cells, S, 2, dtype=np.float32,
                           params={'nearEngine': 'host'},
                           device='cpu').getH2()
    assert Ht.dtype == F32 and seen and set(seen) == {F32}
    assert _rel(Ht.Anear.dataT.numpy(), np.asarray(Hj.Anear.dataZ[:-1])) \
        <= TOL
    x = np.random.default_rng(7).normal(size=Ht.num_rows).astype(np.float32)
    yj = np.asarray(Hj.matvec(jnp.asarray(x)))
    assert _rel(Ht.matvec(torch.as_tensor(x)).numpy(), yj) <= 1e-5


@pytest.fixture(scope='module')
def interval8():
    """The interval at noRef 8 (255 dofs): both packages' float32 H2 and
    dofmaps."""
    m = jfem.simpleInterval(-1.0, 1.0)
    for _ in range(8):
        m = m.refine()
    jdm = jfem.P1_DoFMap(m)
    _, tdm, tk = fromArrays(m.vertices, m.cells, S, 1, device='cpu')
    params = {'dtype': np.float32}
    return dict(jdm=jdm, tdm=tdm, tk=tk,
                Hj=jasm.nonlocalBuilder(jdm, jKernel(1, S),
                                        params=params).getH2(),
                Ht=nonlocalBuilder(tdm, tk, params=dict(params)).getH2())


@pytest.mark.parametrize('mode', ['halo', 'bcast', 'assemble'])
def test_distributed_float32_h2(interval8, mode):
    """DistributedH2Matrix of the float32 H2 (halo, bcast) and .assemble
    with params={'dtype': np.float32}, four shards: a float32 x, a float64
    y within 1e-5 relative of the JAX package's distributed apply; the
    wrapped operators within 1e-12 of the port's H2 on the upcast
    coefficients (K8 in float64), the assembled one within 1e-10 of the
    wrapped one (tests/test_dist_assemble.py's bar).  x is random, as the
    float32 H2 tests probe: on a smooth x (a sine) the float32 apply of
    either package is 4e-4 from its float64 apply (the cancellation of the
    fractional operator's rows), and the two packages' float32 operators
    are 3e-5 apart there."""
    d = interval8
    x = np.random.default_rng(7).normal(
        size=d['tdm'].num_dofs).astype(np.float32)
    mesh, jmesh = makeDeviceMesh(4, device='cpu'), jMesh(4)
    if mode == 'assemble':
        At = DistributedH2Matrix.assemble(d['tdm'], d['tk'], mesh,
                                          params={'dtype': np.float32})
        Aj = jDistH2.assemble(d['jdm'], jKernel(1, S), jmesh,
                              params={'dtype': np.float32})
        ref = DistributedH2Matrix(d['Ht'], mesh)
        tol = 1e-10
    else:
        bcast = mode == 'bcast'
        At = DistributedH2Matrix(d['Ht'], mesh, bcast=bcast)
        Aj = jDistH2(d['Hj'], jmesh, bcast=bcast)
        ref = d['Ht'].double()
        tol = 1e-12
    yt = At.matvec(torch.as_tensor(x))
    assert yt.dtype == torch.float64 and At.dtype == torch.float64
    yj = np.asarray(Aj.matvec(jnp.asarray(x)))
    assert yj.dtype == np.float64
    scale = np.linalg.norm(yj)
    assert np.linalg.norm(yt.numpy() - yj) <= 1e-5 * scale
    yr = ref.matvec(torch.as_tensor(x, dtype=torch.float64)).numpy()
    assert np.linalg.norm(yt.numpy() - yr) <= tol * np.linalg.norm(yr)


def test_upcast_h2_is_the_float64_twin(interval8):
    """H2Matrix.double(): every coefficient of the float32 operator upcast,
    the tables shared, the float32 operator left as it was."""
    H = interval8['Ht']
    H64 = H.double()
    assert H.dtype == F32 and H64.dtype == torch.float64
    for a, b in ((H.Anear.dataZ, H64.Anear.dataZ), (H.Kall, H64.Kall),
                 (H.leafPhi, H64.leafPhi), (H.Ttr, H64.Ttr)):
        assert b.dtype == torch.float64 and torch.equal(a.double(), b)
    assert H64.Anear.perm is H.Anear.perm and H64.double() is H64


def _tinyInterval():
    m = jfem.simpleInterval(-1.0, 1.0)
    for _ in range(3):
        m = m.refine()
    return m


# the float32 cases that the port still refuses and the JAX package's
# float32 program runs (ROADMAP.md A7-f32r queues them): each names the
# port's builder keywords (builderFromArrays; None: the ranged kernel of
# operator interpolation) and call, and the JAX package's kernel and call
REFUSED = {
    'gaussianH2': (dict(kernelType='gaussian'), 'getH2',
                   lambda: jIntegrable(1, 'gaussian', np.inf)),
    'derivative': (dict(derivative=1), 'getDense',
                   lambda: jKernel(1, 0.25, derivative=1)),
    'leftRight': (dict(s=(0.25, 0.75)), 'getDense',
                  lambda: jKernel(1, jk.leftRightFractionalOrder(0.25,
                                                                  0.75))),
    'constantNonSym': (dict(s='constantNonSym(0.25)'), 'getDense',
                       lambda: jKernel(1, jk.constantNonSymFractionalOrder(
                           0.25))),
    'vector': (dict(s=(0.25, 0.75), derivative=1), 'getDenseVector',
               lambda: jKernel(1, jk.leftRightFractionalOrder(0.25, 0.75),
                               derivative=1)),
    'interpolation': (None, 'dense', None),
}


@pytest.mark.parametrize('name', list(REFUSED))
def test_float32_refusals_that_jax_runs(name):
    """Each float32 refusal that remains raises NotImplementedError in the
    port, naming ROADMAP.md, where the JAX package's float32 program runs
    (ROADMAP.md A7-f32r queues them)."""
    kw, call, jaxKernel = REFUSED[name]
    m = _tinyInterval()
    dm = jfem.P1_DoFMap(m)
    params = {'dtype': np.float32}
    if kw is None:
        from pynucleus_tpu.nl.operator_interpolation import admissibleSet
        from pynucleus_tpu_torch.nl.kernels import kernelFactory
        from pynucleus_tpu_torch.nl.operator_interpolation import \
            admissibleSet as tAdmissible
        _, tdm, _ = fromArrays(m.vertices, m.cells, 0.25, 1, device='cpu')
        with pytest.raises(NotImplementedError, match='ROADMAP.md'):
            tasm.assembleNonlocal(tdm, kernelFactory(
                'fractional', s=tAdmissible([0.25, 0.75]), dim=1),
                matrixFormat=call, params=dict(params))
        jasm.assembleNonlocal(dm, jk.kernelFactory(
            'fractional', s=admissibleSet([0.25, 0.75]), dim=1), call,
            params=params)
        return
    kw = dict(kw)
    s = kw.pop('s', 0.25)
    with pytest.raises(NotImplementedError, match='ROADMAP.md'):
        getattr(builderFromArrays(m.vertices, m.cells, s, 1,
                                  dtype=np.float32, device='cpu', **kw),
                call)()
    getattr(jasm.nonlocalBuilder(dm, jaxKernel(), params=params), call)()

def test_launch_counts_stay_zero_on_the_cpu():
    """On CPU tensors the float32 wrappers run their plain versions and
    count no launch."""
    kernels.resetLaunches()
    _, tb, _ = _finite('interval', 2)
    tb.getSparse()
    tb.getDiagonal()
    assert not any(kernels.launches.values())

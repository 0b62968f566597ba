"""The port's Helmholtz path (runHelmholtz: complex128 CSR apply, V-cycle
and GMRES) against the JAX package, on the CPU.

  surface terms      assembleSurfaceMass and assembleSurfaceRHS on the
                     interval and the square at noRef 3: 1e-15 relative
  complex FEM data   assembleRHS of a complex function and interpolate,
                     exactly
  K9 complex         a complex level operator, and a real prolongation
                     and its transpose applied to complex vectors: 1e-13
  K10 complex        one V-cycle of a 3-level complex-shifted square
                     hierarchy carried from the JAX package's arrays:
                     1e-12 relative
  K17 complex        GMRES with that V-cycle: iterations equal, histories
                     and x to 1e-10 relative
  the driver         the interval's wave and greens lines against the JAX
                     driver (numIter equal, the rest to rtol 1e-6) and the
                     reference cache; the square at noRef 4 through the
                     driver's body against the same composition of JAX
                     package calls; the cube raises
  plain versions     K9, K10 and K17's complex variants against numpy:
                     1e-13
"""
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.fem import assembly as jasm
from pynucleus_tpu.fem.meshes import NO_BOUNDARY as jNO_BOUNDARY
from pynucleus_tpu.multilevel import gmg as jgmg
from pynucleus_tpu.base import solvers as jsol

from pynucleus_tpu_torch import kernels
from pynucleus_tpu_torch.base import solvers as tsol
from pynucleus_tpu_torch.base.linear_operators import (csr_spmv,
                                                       _csr_spmv_plain)
from pynucleus_tpu_torch.fem import assembly as tasm
from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
from pynucleus_tpu_torch.fem.meshes import (NO_BOUNDARY, simpleInterval,
                                            uniformSquare)
from pynucleus_tpu_torch.fem.pdeProblems import helmholtzProblem
from pynucleus_tpu_torch.interop import csrHierarchyFromArrays
from pynucleus_tpu_torch.multilevel import gmg as tgmg
from pynucleus_tpu_torch.drivers import runHelmholtz as tdrv

ROOT = __file__.rsplit('/tests/', 1)[0]
FREQ = 40.0
SMOOTHER = tdrv.SMOOTHER
# the JAX driver's outputs (drivers/runHelmholtz.py on the CPU, float64)
JAX_INTERVAL = {
    'wave': {'numIter': 23, 'res': 4.38928474391897e-06,
             'solution L2 norm': 0.9999999758530215,
             'L2 error': 1.5359002813128508e-06},
    'greens': {'numIter': 11, 'res': 7.5679531697032636e-06,
               'solution L2 norm': 0.00027988735977089665}}


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _jaxProblem(domain, problem='wave'):
    """The JAX package's helmholtzProblem as its driver builds it."""
    from pynucleus_tpu.base import driver
    from pynucleus_tpu.fem.pdeProblems import helmholtzProblem as jProblem
    d = driver()
    p = jProblem(d)
    d.process(argv=['--domain', domain, '--problem', problem])
    return p


def _meshes(domain, noRef):
    """The JAX and the port's meshes refined noRef times."""
    if domain == 'square':
        mj = jfem.uniformSquare(N=2, ax=0., ay=0., bx=1., by=1.)
        mt = uniformSquare(N=2, ax=0., ay=0., bx=1., by=1.)
    else:
        mj, mt = jfem.simpleInterval(0.0, 1.0), simpleInterval(0.0, 1.0)
    out = [(mj, mt)]
    for _ in range(noRef):
        out.append((out[-1][0].refine(), out[-1][1].refine()))
    return out


def _toScipy(A):
    return sp.csr_matrix((np.asarray(A.data), np.asarray(A.indices),
                          np.asarray(A.indptr)),
                         shape=(A.num_rows, A.num_columns))


def _fromScipy(S):
    S = S.tocsr()
    S.sort_indices()
    return jasm.CSR_LinearOperator.from_scipy(S)


def _jaxLevels(meshes, p, freq=FREQ):
    """drivers/runHelmholtz.py's composition of JAX package calls on the
    level meshes: the shifted hierarchy, A, M (complex), the finest
    dofmap and the load b."""
    dms = [jfem.P1_DoFMap(m, tag=jNO_BOUNDARY) for m in meshes]
    Ss = [_toScipy(jasm.assembleStiffness(d)) for d in dms]
    Ms = [_toScipy(jasm.assembleMass(d)) for d in dms]
    Ps = [None] + [jgmg.buildProlongation(dms[lvl - 1], dms[lvl])
                   for lvl in range(1, len(dms))]
    MBs = [None] * len(dms)
    MBs[-1] = jasm.assembleSurfaceMass(dms[-1])
    for lvl in range(len(dms) - 2, -1, -1):
        P = _toScipy(Ps[lvl + 1])
        MBs[lvl] = (P.T @ MBs[lvl + 1] @ P).tocsr()

    def getOp(lvl, shift=0.0):
        A = (Ss[lvl] - freq ** 2 * Ms[lvl]).astype(np.complex128) \
            + 1j * freq * MBs[lvl]
        if shift:
            A = A + 1j * shift * freq ** 2 * Ms[lvl]
        return _fromScipy(A)
    hierarchy = []
    for lvl in range(len(dms)):
        e = {'A': getOp(lvl, shift=0.5)}
        if lvl > 0:
            e['P'] = Ps[lvl]
            e['R'] = Ps[lvl].T
        hierarchy.append(e)
    dm = dms[-1]
    b = jnp.asarray(jasm.assembleRHS(dm, p.rhs, qOrder=3).data,
                    dtype=jnp.complex128)
    if p.boundaryCond is not None:
        b = b + jnp.asarray(jasm.assembleSurfaceRHS(dm, p.boundaryCond))
    return hierarchy, getOp(len(dms) - 1), \
        _fromScipy(Ms[-1].astype(np.complex128)), dm, b


def _jaxGmres(A, ml, b, maxiter=300, tol=1e-5):
    g = jsol.gmres_solver(A)
    g.setup()
    g.maxIter, g.restarts, g.tolerance = maxiter, 1, tol
    g.setPreconditioner(ml.asPreconditioner(), left=False)
    x = g.solve(b)
    return g, np.asarray(x)


def _arrays(A):
    return (np.asarray(A.indptr), np.asarray(A.indices), np.asarray(A.data),
            A.shape)


# ------------------------------------------------------- surface terms ----

@pytest.mark.parametrize('domain', ['interval', 'square'])
def test_surface_mass_and_rhs_match_jax(domain):
    mj, mt = _meshes(domain, 3)[-1]
    dj = jfem.P1_DoFMap(mj, tag=jNO_BOUNDARY)
    dt = P1_DoFMap(mt, tag=NO_BOUNDARY, device='cpu')
    MBj, MBt = jasm.assembleSurfaceMass(dj), tasm.assembleSurfaceMass(dt)
    np.testing.assert_array_equal(MBt.indptr, MBj.indptr)
    np.testing.assert_array_equal(MBt.indices, MBj.indices)
    assert MBt.nnz > 0
    assert _rel(MBt.data, MBj.data) <= 1e-15
    pj, pt = _jaxProblem(domain), helmholtzProblem(domain)
    bj = jasm.assembleSurfaceRHS(dj, pj.boundaryCond)
    bt = tasm.assembleSurfaceRHS(dt, pt['boundaryCond'])
    assert bt.dtype == np.complex128 and np.abs(bt).max() > 0
    assert _rel(bt, bj) <= 1e-15


def test_complex_rhs_and_interpolate_equal_jax():
    mj, mt = _meshes('square', 3)[-1]
    dj = jfem.P1_DoFMap(mj, tag=jNO_BOUNDARY)
    dt = P1_DoFMap(mt, tag=NO_BOUNDARY, device='cpu')
    pj, pt = _jaxProblem('square'), helmholtzProblem('square')
    for qOrder in (None, 3):
        bj = np.asarray(jasm.assembleRHS(dj, pj.rhs, qOrder=qOrder).data)
        bt = tasm.assembleRHS(dt, pt['rhs'], qOrder=qOrder).data
        assert bt.dtype == torch.complex128
        np.testing.assert_array_equal(bt.numpy(), bj)
    xj = np.asarray(dj.interpolate(pj.solEx).data)
    xt = dt.interpolate(pt['solEx']).data
    assert xt.dtype == torch.complex128
    np.testing.assert_array_equal(xt.numpy(), xj)
    # real functions stay float64
    assert dt.interpolate(lambda X: X[:, 0]).data.dtype == torch.float64


def test_greens_rhs_equals_jax():
    mj, mt = _meshes('interval', 7)[-1]
    dj = jfem.P1_DoFMap(mj, tag=jNO_BOUNDARY)
    dt = P1_DoFMap(mt, tag=NO_BOUNDARY, device='cpu')
    pt = helmholtzProblem('interval', 'greens')
    assert pt['solEx'] is None and pt['boundaryCond'] is None
    bj = np.asarray(jasm.assembleRHS(
        dj, _jaxProblem('interval', 'greens').rhs, qOrder=3).data)
    np.testing.assert_array_equal(
        tasm.assembleRHS(dt, pt['rhs'], qOrder=3).data.numpy(), bj)
    assert np.count_nonzero(bj) > 0


def test_cube_raises():
    with pytest.raises(NotImplementedError, match='A5'):
        helmholtzProblem('cube')
    with pytest.raises(NotImplementedError, match='A5'):
        tdrv.main(['--domain', 'cube', '--device', 'cpu'], quiet=True)


# ------------------------------------------- the complex level hierarchy --

@pytest.fixture(scope='module')
def carried():
    """The square's complex-shifted JAX hierarchy on the refinements 2, 3
    and 4 (25, 81 and 289 dofs), its A, M and load, the same arrays carried
    into the port, and both multigrids set up with the driver's
    smoother."""
    meshes = [mj for mj, _ in _meshes('square', 4)[2:]]
    hj, Aj, Mj, dm, bj = _jaxLevels(meshes, _jaxProblem('square'))
    ht = csrHierarchyFromArrays([_arrays(e['A']) for e in hj],
                                [None] + [_arrays(e['P']) for e in hj[1:]],
                                device='cpu')
    mlj = jgmg.multigrid(hj, smoother=SMOOTHER)
    mlj.setup()
    mlt = tgmg.multigrid(ht, smoother=SMOOTHER)
    mlt.setup()
    At = csrHierarchyFromArrays([_arrays(Aj)], [None], device='cpu')[0]['A']
    return {'hj': hj, 'ht': ht, 'mlj': mlj, 'mlt': mlt, 'Aj': Aj, 'At': At,
            'b': np.array(bj)}


def test_carried_levels_are_complex(carried):
    lv = carried['mlt'].levels
    assert [A.num_rows for A in lv.As] == [25, 81, 289]
    assert all(A.data.dtype == torch.complex128 for A in lv.As)
    assert all(P.data.dtype == torch.float64 for P in lv.Ps[1:])
    assert lv.dtype == torch.complex128
    assert lv.coarse_lu.dtype == torch.complex128
    assert lv.work[-1]['x'].dtype == torch.complex128
    assert (lv.preSteps, lv.postSteps) == (2, 2)
    for Aj, At in zip(carried['mlj'].levels.As, lv.As):
        np.testing.assert_array_equal(At.dataH, np.asarray(Aj.data))
    # the complex diagonal of the CSR operators
    for Aj, At in zip(carried['hj'], carried['ht']):
        np.testing.assert_array_equal(At['A'].diagonal.numpy(),
                                      np.asarray(Aj['A'].diagonal))


def test_complex_csr_apply_matches_jax(carried):
    """K9's complex variants: A x (complex data), P xc and P^T r (real
    data, complex vectors), each also accumulated."""
    rng = np.random.default_rng(3)
    A = (carried['hj'][-1]['A'], carried['ht'][-1]['A'])
    P = (carried['hj'][-1]['P'], carried['ht'][-1]['P'])
    for (Oj, Ot), trans in ((A, False), (P, False), (P, True)):
        n = Ot.num_rows if trans else Ot.num_columns
        x = rng.normal(size=n) + 1j * rng.normal(size=n)
        ref = np.asarray(Oj.rmatvec(jnp.asarray(x)) if trans
                         else Oj.matvec(jnp.asarray(x)))
        xt = torch.as_tensor(x)
        got = Ot.rmatvec(xt) if trans else Ot.matvec(xt)
        assert got.dtype == torch.complex128
        assert _rel(got.numpy(), ref) <= 1e-13
        y0 = torch.as_tensor(rng.normal(size=len(ref))
                             + 1j * rng.normal(size=len(ref)))
        y = y0.clone()
        (Ot.rmatvec if trans else Ot.matvec)(xt, out=y, accumulate=True)
        assert _rel(y.numpy(), y0.numpy() + ref) <= 1e-13
    np.testing.assert_array_equal(A[1].toarray(), np.asarray(A[0].toarray()))


def test_complex_vcycle_matches_jax(carried):
    rng = np.random.default_rng(4)
    n = carried['b'].shape[0]
    for b in (carried['b'], rng.normal(size=n) + 1j * rng.normal(size=n)):
        ref = np.asarray(jgmg._mg_apply(carried['mlj'].levels,
                                        jnp.asarray(b)))
        got = tgmg._mg_apply(carried['mlt'].levels, torch.as_tensor(b))
        assert got.dtype == torch.complex128
        assert _rel(got.numpy(), ref) <= 1e-12


def test_complex_gmres_matches_jax(carried):
    """GMRES (restart 300, one cycle, tolerance 1e-5) right-preconditioned
    by one complex V-cycle, as the driver: equal iterations, histories and
    x to 1e-10 relative."""
    b = carried['b']
    gj, xj = _jaxGmres(carried['Aj'], carried['mlj'], jnp.asarray(b))
    gt = tsol.gmres_solver(carried['At'])
    gt.maxIter, gt.restarts, gt.tolerance = 300, 1, 1e-5
    gt.setPreconditioner(carried['mlt'].asPreconditioner())
    xt = gt.solve(torch.as_tensor(b))
    assert xt.dtype == torch.complex128
    assert gt.iterations == gj.iterations
    assert len(gt.residuals) == len(gj.residuals) > 3
    assert _rel(gt.residuals, gj.residuals) <= 1e-10
    assert _rel(xt.numpy(), xj) <= 1e-10
    assert abs(gt.explicitResidual - gj.explicitResidual) <= \
        1e-10 * gj.residuals[0]


def test_complex_gmres_cycle_without_preconditioner(carried):
    """K17's complex plain version through 8 unpreconditioned steps at
    tolerance 0 against _gmres_cycle."""
    b = carried['b']
    Aj, At = carried['Aj'], carried['At']
    rng = np.random.default_rng(6)
    x0 = rng.normal(size=len(b)) + 1j * rng.normal(size=len(b))
    xj, _, kj, histj = jsol._gmres_cycle(
        Aj, jsol.Diagonal_LinearOperator(jnp.ones(len(b), jnp.complex128)),
        jnp.asarray(b), jnp.asarray(x0), 0.0, 8, False, True)
    restart = 8
    x = torch.as_tensor(x0.copy())
    V = torch.empty((restart + 1, len(b)), dtype=torch.complex128)
    w = torch.as_tensor(b) - At.matvec(x)
    h = torch.empty(restart + 1, dtype=torch.complex128)
    guards = torch.tensor([0.0, 1e-300], dtype=torch.float64)
    tsol.gmres_arnoldi(V, w, h, -1, guards[:1])
    _, k, hist = tsol.gmres_solver._cycle(At, None, V, None, w, h,
                                          guards[1:], float(h[0].real),
                                          restart, 0.0, x)
    assert k == int(kj) == restart
    assert _rel(hist, np.asarray(histj).real) <= 1e-10
    assert _rel(x.numpy(), np.asarray(xj)) <= 1e-10


# ------------------------------------------------------------ the driver --

@pytest.mark.parametrize('problem', ['wave', 'greens'])
def test_interval_driver_matches_jax_driver(problem):
    from drivers.runHelmholtz import main as jMain
    argv = ['--domain', 'interval', '--problem', problem]
    dj = jMain(argv)
    rj = dj.outputGroups['results'].toDict()
    out = tdrv.main(argv + ['--device', 'cpu'], quiet=True)
    rt = out['results'].toDict()
    assert out['info'].toDict() == dj.outputGroups['info'].toDict()
    assert len(out['hierarchy']) == 2 and out['dm'].num_dofs == 129
    assert rt.keys() == rj.keys()
    assert rt['numIter'] == rj['numIter'] == JAX_INTERVAL[problem]['numIter']
    for label, ref in rj.items():
        if label != 'numIter':
            assert abs(rt[label] - ref) <= 1e-6 * abs(ref), (label, rt, rj)
            assert abs(rt[label] - JAX_INTERVAL[problem].get(label, ref)) \
                <= 1e-6 * abs(ref)
    if problem == 'wave':
        # the reference cache (tests/test_helmholtz.py:11-17)
        assert abs(rt['numIter'] - 24) <= 1
        assert np.isclose(rt['solution L2 norm'], 1.0, rtol=1e-5)
        assert rt['L2 error'] < 5e-6


def test_square_noRef4_matches_jax_composition():
    """The driver's body on the square's levels at noRef 4 (the coarse-level
    rule keeps 81 and 289 dofs) against the JAX driver's composition of
    package calls on the same meshes."""
    pairs = _meshes('square', 4)
    pt = helmholtzProblem('square')
    meshesT = tdrv.hierarchyMeshes(pairs[0][1], 4)
    assert [m.num_vertices for m in meshesT] == [81, 289]
    meshesJ = [mj for mj, _ in pairs[-len(meshesT):]]
    hj, Aj, Mj, dm, bj = _jaxLevels(meshesJ, _jaxProblem('square'))
    mlj = jgmg.multigrid(hj, smoother=SMOOTHER)
    mlj.setup()
    gj, xj = _jaxGmres(Aj, mlj, bj)
    xEx = jnp.asarray(dm.interpolate(_jaxProblem('square').solEx).data)
    ref = {'numIter': len(gj.residuals) - 1,
           'res': float(gj.residuals[-1]),
           'solution L2 norm': float(np.sqrt(abs(jnp.vdot(xj, Mj @ xj)))),
           'L2 error': float(np.sqrt(abs(jnp.vdot(xj - xEx,
                                                  Mj @ (xj - xEx)))))}
    out = tdrv.solveHelmholtz(meshesT, pt, device='cpu')
    rt = out['results'].toDict()
    np.testing.assert_array_equal(out['b'].numpy(), np.asarray(bj))
    np.testing.assert_array_equal(out['A'].dataH, np.asarray(Aj.data))
    assert rt['numIter'] == ref['numIter'] > 3
    for label in ('res', 'solution L2 norm', 'L2 error'):
        assert abs(rt[label] - ref[label]) <= 1e-10 * ref[label], label
    assert _rel(out['x'].numpy(), xj) <= 1e-10


def test_driver_imports_no_jax():
    code = ('import sys, pynucleus_tpu_torch.drivers.runHelmholtz; '
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                   timeout=120)


def test_cpu_wrappers_count_no_launch():
    """On CPU tensors the complex variants run their plain versions: no
    count moves, the complex ones included."""
    assert set(kernels.COMPLEX) <= set(kernels.launches)
    kernels.resetLaunches()
    tdrv.main(['--domain', 'interval', '--problem', 'greens', '--device',
               'cpu'], quiet=True)
    assert not any(kernels.launches.values())
    assert not any(kernels.deviceLaunches.values())


# ------------------------------------------------------- plain versions ---

def _crandn(rng, *shape):
    return rng.normal(size=shape) + 1j * rng.normal(size=shape)


@pytest.mark.parametrize('dataType', ['real', 'complex'])
def test_csr_spmv_complex_plain_matches_numpy(dataType):
    rng = np.random.default_rng(7)
    S = sp.random(60, 45, density=0.15, random_state=8, format='csr')
    if dataType == 'complex':
        S = S + 1j * sp.random(60, 45, density=0.15, random_state=9,
                               format='csr')
    S = S.tocsr()
    S.sort_indices()
    x = _crandn(rng, 45)
    args = (torch.as_tensor(S.indptr.astype(np.int32)),
            torch.as_tensor(S.indices.astype(np.int32)),
            torch.as_tensor(S.data), torch.as_tensor(x))
    y = csr_spmv(*args)
    assert y.dtype == torch.complex128
    assert _rel(y.numpy(), S @ x) <= 1e-13
    y0 = _crandn(rng, 60)
    out = torch.as_tensor(y0.copy())
    assert csr_spmv(*args, out=out, accumulate=True) is out
    assert _rel(out.numpy(), y0 + S @ x) <= 1e-13
    # complex data with a real x, and a complex product into a real out,
    # are refused
    if dataType == 'complex':
        with pytest.raises(ValueError, match='complex128'):
            csr_spmv(*args[:3], args[3].real.contiguous())
    with pytest.raises(ValueError, match='out'):
        csr_spmv(*args, out=torch.zeros(60, dtype=torch.float64))


@pytest.mark.parametrize('mode', ['zero', 'residual', 'update'])
def test_jacobi_smooth_complex_plain_matches_numpy(mode):
    rng = np.random.default_rng(10)
    n = 301
    x0, b, Ax, Dinv = (_crandn(rng, n) for _ in range(4))
    om = 0.8
    ref = {'zero': om * (Dinv * b), 'residual': b - Ax,
           'update': x0 + om * (Dinv * (b - Ax))}[mode]
    x = torch.as_tensor(x0.copy())
    tgmg.jacobi_smooth(mode, x, torch.as_tensor(b), Ax=torch.as_tensor(Ax),
                       Dinv=torch.as_tensor(Dinv),
                       omega=torch.tensor([om], dtype=torch.float64))
    assert _rel(x.numpy(), ref) <= 1e-13
    with pytest.raises(ValueError, match='complex128'):
        tgmg.jacobi_smooth(mode, x, torch.as_tensor(b.real.copy()),
                           Ax=torch.as_tensor(Ax), Dinv=torch.as_tensor(Dinv),
                           omega=torch.tensor([om], dtype=torch.float64))


def test_gmres_arnoldi_complex_plain_matches_numpy():
    """One complex MGS step (conjugated dots, in order), the start of a
    cycle and the combine against numpy."""
    rng = np.random.default_rng(11)
    n = 70
    Vr, wr = _crandn(rng, 5, n), _crandn(rng, n)
    V, w = torch.as_tensor(Vr.copy()), torch.as_tensor(wr.copy())
    h = torch.zeros(5, dtype=torch.complex128)
    guards = torch.tensor([0.0, 1e-300], dtype=torch.float64)
    tsol.gmres_arnoldi(V, w, h, 2, guards[1:])
    wn, hn = wr.copy(), []
    for i in range(3):
        hi = np.vdot(Vr[i], wn)
        wn = wn - hi * Vr[i]
        hn.append(hi)
    nrm = np.linalg.norm(wn)
    assert _rel(h[:4].numpy(), hn + [nrm]) <= 1e-13
    assert h[3].imag == 0
    assert _rel(V[3].numpy(), wn / nrm) <= 1e-13
    assert _rel(w.numpy(), wn) <= 1e-13
    np.testing.assert_array_equal(V[:3].numpy(), Vr[:3])
    # the start: V[0] = w / ||w||, h[0] = ||w||
    w2 = torch.as_tensor(wr.copy())
    tsol.gmres_arnoldi(V, w2, h, -1, guards[:1])
    assert _rel(V[0].numpy(), wr / np.linalg.norm(wr)) <= 1e-13
    assert abs(complex(h[0]) - np.linalg.norm(wr)) <= \
        1e-13 * np.linalg.norm(wr)
    y = _crandn(rng, 4)
    x0 = _crandn(rng, n)
    x = torch.as_tensor(x0.copy())
    tsol.gmres_combine(x, V, torch.as_tensor(y))
    assert _rel(x.numpy(), x0 + V[:4].numpy().T @ y) <= 1e-13
    with pytest.raises(ValueError, match='y must be'):
        tsol.gmres_combine(x, V, torch.as_tensor(y.real.copy()))
    with pytest.raises(ValueError, match='h must be'):
        tsol.gmres_arnoldi(V, w, h.real.contiguous(), 2, guards[1:])


# ------------------------------------------------------------- the card ---

@pytest.mark.cuda
def test_complex_kernels_match_plain_on_gpu():
    """K9, K10 and K17's complex variants on the card against their plain
    versions on the same tensors (needs an NVIDIA GPU)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    rng = np.random.default_rng(12)
    S = (sp.random(3000, 2000, density=0.003, random_state=13)
         + 1j * sp.random(3000, 2000, density=0.003, random_state=14)).tocsr()
    S.sort_indices()
    ip = torch.as_tensor(S.indptr.astype(np.int32), device='cuda')
    ix = torch.as_tensor(S.indices.astype(np.int32), device='cuda')
    x = torch.as_tensor(_crandn(rng, 2000), device='cuda')
    for data in (torch.as_tensor(S.data, device='cuda'),
                 torch.as_tensor(S.data.real.copy(), device='cuda')):
        yk = csr_spmv(ip, ix, data, x)
        yp = torch.empty_like(yk)
        _csr_spmv_plain(ip, ix, data, x, yp)
        assert float((yk - yp).abs().max()) <= 1e-12 * float(yp.abs().max())
    n = 5000
    b, Ax, Dinv, x0 = (torch.as_tensor(_crandn(rng, n), device='cuda')
                       for _ in range(4))
    om = torch.tensor([0.8], dtype=torch.float64, device='cuda')
    for mode in ('zero', 'residual', 'update'):
        xk, xp = x0.clone(), x0.clone()
        tgmg.jacobi_smooth(mode, xk, b, Ax=Ax, Dinv=Dinv, omega=om)
        tgmg._jacobi_smooth_plain(mode, xp, b, Ax=Ax, Dinv=Dinv, omega=om)
        assert float((xk - xp).abs().max()) <= 1e-12 * float(xp.abs().max())
    V = torch.as_tensor(_crandn(rng, 6, n), device='cuda')
    Vp = V.clone()
    w, wp = b.clone(), b.clone()
    h = torch.zeros(6, dtype=torch.complex128, device='cuda')
    hp = h.clone()
    g = torch.tensor([1e-300], dtype=torch.float64, device='cuda')
    tsol.gmres_arnoldi(V, w, h, 3, g)
    tsol._gmres_arnoldi_plain(Vp, wp, hp, 3, g)
    for a, c in ((V, Vp), (w, wp), (h, hp)):
        assert float((a - c).abs().max()) <= 1e-12 * float(c.abs().max())
    y = torch.as_tensor(_crandn(rng, 5), device='cuda')
    xk, xp = x0.clone(), x0.clone()
    tsol.gmres_combine(xk, V, y)
    tsol._gmres_combine_plain(xp, V, y)
    assert float((xk - xp).abs().max()) <= 1e-12 * float(xp.abs().max())

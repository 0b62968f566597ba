"""The port's serial multigrid path (runSerialGMG) against the JAX package,
on the CPU in float64.

  meshes, pattern    the square and the interval refine to the JAX
                     package's vertices, cells and dofs; the sparsity
                     pattern and the slot of every local entry are equal
  K16 csr_scatter    the stiffness and mass data equal scatterToCSR's bit
                     for bit (both add each slot's contributions in flat
                     order), and so does the plain version on random values
  sweeps, FMG        a V-cycle with 2+2 Jacobi sweeps and _fmg_solve on a
                     JAX stiffness hierarchy carried into the port: 1e-12
                     relative; the FMG_V solve's iterations and residuals
  K17, K18           one GMRES cycle and a few BiCGStab iterations against
                     _gmres_cycle and _bicgstab_core at tolerance 0
  gmres, bicgstab    plain, -jacobi and -mg against the JAX solvers on the
                     square's stiffness at noRef 4: x to 1e-10 relative,
                     iterations equal, residual lists to 1e-10 relative
  the driver         the square at noRef 4 and the interval at noRef 6
                     against the JAX driver: iterations equal, residuals
                     and rates to 1e-8 relative (the interval's
                     unpreconditioned Krylov residuals, about 1e-13, to
                     1e-10 absolute), errors to 1e-10 relative above
                     the rounding floor of their cancelling formulas
"""
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.fem import assembly as jasm
from pynucleus_tpu.multilevel import gmg as jgmg
from pynucleus_tpu.base import solvers as jsol
from pynucleus_tpu.base.linear_operators import \
    Diagonal_LinearOperator as jDiag

from pynucleus_tpu_torch import kernels
from pynucleus_tpu_torch.base import solvers as tsol
from pynucleus_tpu_torch.fem import assembly as tasm
from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
from pynucleus_tpu_torch.fem.meshes import simpleInterval, uniformSquare
from pynucleus_tpu_torch.fem.pdeProblems import diffusionProblem
from pynucleus_tpu_torch.interop import csrHierarchyFromArrays
from pynucleus_tpu_torch.multilevel import gmg as tgmg
from pynucleus_tpu_torch.drivers.runSerialGMG import main as tMain

ROOT = __file__.rsplit('/tests/', 1)[0]
SMOOTHER = ('jacobi', {'presmoothingSteps': 2, 'postsmoothingSteps': 2,
                       'omega': 2.0 / 3.0})
# the JAX driver's outputs at --domain square --noRef 4 (CPU, float64)
JAX_SQUARE_NOREF4 = {
    'DoFs': 961, 'Tol': 9.765625e-04,
    'iterations': {'MG': 5, 'FMG': 4, 'CG': 8, 'PCG': 3, 'GMRES': 5,
                   'PGMRES': 3, 'BICGSTAB': 3, 'PBICGSTAB': 1},
    'residuals': {'MG': 7.453214e-04, 'FMG': 5.298254e-04,
                  'CG': 8.871800e-04, 'PCG': 1.794617e-04,
                  'GMRES': 8.725642e-04, 'PGMRES': 1.165668e-04,
                  'BICGSTAB': 7.755684e-04, 'PBICGSTAB': 1.959891e-04},
    'errors': {'L^2 error': 1.340462e-03, 'H^1_0 error': 1.095661e-01}}


def _rel(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _meshes(domain, noRef):
    """The JAX and the port's meshes of the driver's hierarchy (level 0 the
    first refinement with an interior dof), levels 0 ... noRef."""
    if domain == 'square':
        mj = jfem.uniformSquare(N=2, ax=0., ay=0., bx=1., by=1.)
        mt = uniformSquare(N=2, ax=0., ay=0., bx=1., by=1.)
    else:
        mj, mt = jfem.simpleInterval(0.0, 1.0), simpleInterval(0.0, 1.0)
    while jfem.P1_DoFMap(mj).num_dofs == 0:
        mj, mt = mj.refine(), mt.refine()
    out = [(mj, mt)]
    for _ in range(noRef):
        out.append((out[-1][0].refine(), out[-1][1].refine()))
    return out


@pytest.mark.parametrize('domain', ['square', 'interval'])
def test_refined_meshes_match_jax(domain):
    for mj, mt in _meshes(domain, 3):
        np.testing.assert_array_equal(mt.vertices, mj.vertices)
        np.testing.assert_array_equal(mt.cells, mj.cells)
        np.testing.assert_array_equal(P1_DoFMap(mt, device='cpu').dofs,
                                      np.asarray(jfem.P1_DoFMap(mj).dofs))


@pytest.mark.parametrize('domain', ['square', 'interval'])
def test_sparsity_pattern_matches_jax(domain):
    mj, mt = _meshes(domain, 3)[-1]
    pj, sj = jasm.buildSparsityPattern(jfem.P1_DoFMap(mj))
    dt = P1_DoFMap(mt, device='cpu')
    pt, st = tasm.buildSparsityPattern(dt)
    np.testing.assert_array_equal(pt.indptr, pj.indptr)
    np.testing.assert_array_equal(pt.indices, pj.indices)
    np.testing.assert_array_equal(st, sj)
    # K16's order: the kept contributions by slot, each slot's in flat order
    _, _, order, offsets = tasm.scatterPlan(dt)
    flat = st.reshape(-1)
    o = order.numpy()
    assert np.all(np.diff(flat[o]) >= 0)
    assert np.all(np.diff(o)[np.diff(flat[o]) == 0] > 0)
    np.testing.assert_array_equal(np.diff(offsets.numpy()),
                                  np.bincount(flat[flat >= 0]))
    assert tasm.scatterPlan(dt)[2] is order      # kept on the dofmap


@pytest.mark.parametrize('domain', ['square', 'interval'])
def test_stiffness_and_mass_equal_scatterToCSR(domain):
    mj, mt = _meshes(domain, 3)[-1]
    dj, dt = jfem.P1_DoFMap(mj), P1_DoFMap(mt, device='cpu')
    for name in ('assembleStiffness', 'assembleMass'):
        Aj, At = getattr(jasm, name)(dj), getattr(tasm, name)(dt)
        assert At.data.device.type == 'cpu' and At.shape == Aj.shape
        np.testing.assert_array_equal(At.indptrH, Aj.indptr)
        np.testing.assert_array_equal(At.indicesH, np.asarray(Aj.indices))
        np.testing.assert_array_equal(At.dataH, np.asarray(Aj.data))


def test_csr_scatter_plain_matches_segment_sum():
    mj, mt = _meshes('square', 3)[-1]
    dt = P1_DoFMap(mt, device='cpu')
    pat, slot, order, offsets = tasm.scatterPlan(dt)
    vals = np.random.default_rng(0).normal(size=slot.shape)
    ref = np.asarray(jasm.scatterToCSR(pat, slot, jnp.asarray(vals)).data)
    out = torch.empty(pat.nnz, dtype=torch.float64)
    got = tasm.csr_scatter(torch.as_tensor(vals.reshape(-1)), order, offsets,
                           out=out)
    assert got is out
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError, match='int32'):
        tasm.csr_scatter(torch.as_tensor(vals.reshape(-1)), order.long(),
                         offsets)
    with pytest.raises(ValueError, match='out'):
        tasm.csr_scatter(torch.as_tensor(vals.reshape(-1)), order, offsets,
                         out=torch.empty(3, dtype=torch.float64))


def test_cpu_wrappers_count_no_launch():
    """K16-K18 are registered, and on CPU tensors run their plain
    versions: no count moves."""
    assert kernels.KERNELS[15:18] == ('csr_scatter', 'gmres_arnoldi',
                                      'bicgstab_update')
    assert 'csr_scatter.cu' in kernels.SOURCES
    kernels.resetLaunches()
    tMain(['--domain', 'interval', '--noRef', '3', '--device', 'cpu'],
          quiet=True)
    assert not any(kernels.launches.values())
    assert not any(kernels.deviceLaunches.values())


def _jaxHierarchy(domain, noRef):
    """The JAX driver's stiffness hierarchy (levels 0 ... noRef)."""
    dms = [jfem.P1_DoFMap(mj) for mj, _ in _meshes(domain, noRef)]
    hj = []
    for lvl, dm in enumerate(dms):
        e = {'A': jasm.assembleStiffness(dm)}
        if lvl > 0:
            e['P'] = jgmg.buildProlongation(dms[lvl - 1], dm)
            e['R'] = e['P'].T
        hj.append(e)
    return hj, dms[-1]


def _arrays(A):
    return (A.indptr, np.asarray(A.indices), np.asarray(A.data), A.shape)


@pytest.fixture(scope='module')
def carried():
    """The square's JAX hierarchy at noRef 4 (5 levels, 961 dofs) set up as
    the JAX multigrid with 2+2 sweeps, the same operators carried into the
    port and set up as its multigrid, and the JAX driver's load vector."""
    hj, dm = _jaxHierarchy('square', 4)
    ht = csrHierarchyFromArrays([_arrays(e['A']) for e in hj],
                                [None] + [_arrays(e['P']) for e in hj[1:]],
                                device='cpu')
    mj = jgmg.multigrid(hj, smoother=SMOOTHER)
    mj.setup()
    mt = tgmg.multigrid(ht, smoother=SMOOTHER)
    mt.setup()
    b = np.array(jfem.assembleRHS(dm, jfem.Lambda(
        lambda x: 2 * np.pi ** 2 * np.sin(np.pi * x[0])
        * np.sin(np.pi * x[1]))).data)
    return mj, mt, b


def test_carried_hierarchy(carried):
    mj, mt, _ = carried
    assert [A.num_rows for A in mt.levels.As] == [1, 9, 49, 225, 961]
    assert (mt.levels.preSteps, mt.levels.postSteps) == (2, 2)
    for Aj, At in zip(mj.levels.As, mt.levels.As):
        np.testing.assert_array_equal(At.dataH, np.asarray(Aj.data))


@pytest.mark.parametrize('gamma', [1, 2], ids=['V', 'W'])
def test_cycle_with_two_sweeps_matches_jax(carried, gamma):
    mj, mt, b = carried
    ref = np.asarray(jgmg._mg_apply(mj.levels, jnp.asarray(b), gamma=gamma))
    got = tgmg._mg_apply(mt.levels, torch.as_tensor(b), gamma=gamma)
    assert _rel(got.numpy(), ref) <= 1e-12


@pytest.mark.parametrize('gamma', [1, 2], ids=['FMG_V', 'FMG_W'])
def test_fmg_matches_jax(carried, gamma):
    mj, mt, b = carried
    ref = np.asarray(jgmg._fmg_solve(mj.levels, jnp.asarray(b),
                                     gamma=gamma))
    out = torch.empty(len(b), dtype=torch.float64)
    got = tgmg._fmg_solve(mt.levels, torch.as_tensor(b), gamma, out=out)
    assert got is out
    assert _rel(got.numpy(), ref) <= 1e-12
    # FMG's iterate is not a cycle's work vector: a second call repeats it
    again = tgmg._fmg_solve(mt.levels, torch.as_tensor(b), gamma)
    assert torch.equal(again, got)


@pytest.mark.parametrize('cycle', ['V', 'FMG_V'])
def test_mg_solve_matches_jax(carried, cycle):
    mj, mt, b = carried
    for s in (mj, mt):
        s.tolerance, s.maxIter, s.cycle = 1e-8, 30, cycle
    xj = np.asarray(mj.solve(jnp.asarray(b)))
    xt = mt.solve(torch.as_tensor(b)).numpy()
    assert mt.iterations == mj.iterations
    assert np.abs(np.asarray(mt.residuals) - np.asarray(mj.residuals)).max() \
        <= 1e-10 * max(mj.residuals)
    assert _rel(xt, xj) <= 1e-10


def _krylov(name, A, tol, maxIter, restarts=None, prec=None):
    s = name(A)
    s.tolerance, s.maxIter = tol, maxIter
    if restarts is not None:
        s.restarts = restarts
    if prec is not None:
        s.setPreconditioner(prec)
    return s


@pytest.mark.parametrize('name', ['gmres', 'gmres-jacobi', 'gmres-mg',
                                  'bicgstab', 'bicgstab-jacobi',
                                  'bicgstab-mg'])
def test_krylov_matches_jax(carried, name):
    """The driver's settings (tolerance 0.5 h^2 at noRef 4, gmres restart
    10 with 5 restarts, bicgstab 50 iterations) on the square's
    stiffness."""
    mj, mt, b = carried
    outer, _, inner = name.partition('-')
    tol = 9.765625e-04
    maxIter, restarts = (10, 5) if outer == 'gmres' else (50, None)
    precs = {'': (None, None),
             'jacobi': (jDiag(1.0 / mj.A.diagonal),
                        tsol.Diagonal_LinearOperator(1.0 / mt.A.diagonal)),
             'mg': (mj.asPreconditioner(), mt.asPreconditioner())}[inner]
    cls = {'gmres': (jsol.gmres_solver, tsol.gmres_solver),
           'bicgstab': (jsol.bicgstab_solver, tsol.bicgstab_solver)}[outer]
    sj = _krylov(cls[0], mj.A, tol, maxIter, restarts, precs[0])
    st = _krylov(cls[1], mt.A, tol, maxIter, restarts, precs[1])
    xj = np.asarray(sj.solve(jnp.asarray(b)))
    xt = st.solve(torch.as_tensor(b)).numpy()
    assert st.iterations == sj.iterations
    assert _rel(xt, xj) <= 1e-10
    assert len(st.residuals) == len(sj.residuals)
    assert _rel(st.residuals, sj.residuals) <= 1e-10
    if outer == 'gmres':
        assert abs(st.explicitResidual - sj.explicitResidual) <= \
            1e-10 * sj.residuals[0]
    # the factory builds the same preconditioned solver
    hierarchy = [{'A': A} if P is None else {'A': A, 'P': P, 'R': P.T}
                 for A, P in zip(mt.levels.As, mt.levels.Ps)]
    s = tsol.solverFactory.build(name, hierarchy=hierarchy, setup=True)
    assert isinstance(s, cls[1]) and (s.prec is None) == (inner == '')


@pytest.mark.parametrize('prec', [False, True], ids=['plain', 'jacobi'])
def test_gmres_arnoldi_plain_matches_gmres_cycle(carried, prec):
    """K17's plain version (the Arnoldi steps and x0 + Z y) through one
    cycle of 6 steps at tolerance 0 against _gmres_cycle; and one step by
    itself against the JAX expressions of the loop body."""
    mj, mt, b = carried
    rng = np.random.default_rng(4)
    x0 = rng.normal(size=len(b))
    Mj = jDiag(1.0 / mj.A.diagonal) if prec else jDiag(jnp.ones(len(b)))
    xj, resj, kj, histj = jsol._gmres_cycle(mj.A, Mj, jnp.asarray(b),
                                            jnp.asarray(x0), 0.0, 6, prec,
                                            True)
    restart = 6
    Mt = tsol.Diagonal_LinearOperator(1.0 / mt.A.diagonal) if prec else None
    x = torch.as_tensor(x0.copy())
    V = torch.empty((restart + 1, len(b)), dtype=torch.float64)
    Z = torch.empty((restart, len(b)), dtype=torch.float64) if prec else None
    w = torch.as_tensor(b) - mt.A.matvec(x)
    h = torch.empty(restart + 1, dtype=torch.float64)
    guards = torch.tensor([0.0, 1e-300], dtype=torch.float64)
    tsol.gmres_arnoldi(V, w, h, -1, guards[:1])
    res, k, hist = tsol.gmres_solver._cycle(mt.A, Mt, V, Z, w, h, guards[1:],
                                            float(h[0]), restart, 0.0, x)
    assert k == int(kj) == restart
    assert _rel(hist, np.asarray(histj)) <= 1e-10
    assert _rel(x.numpy(), np.asarray(xj)) <= 1e-10

    # one MGS step: h_i = V[i].w, w -= h_i V[i] in order, then the norm
    Vr = rng.normal(size=(4, 50))
    wr = rng.normal(size=50)
    Vt, wt = torch.as_tensor(Vr.copy()), torch.as_tensor(wr.copy())
    ht = torch.zeros(4, dtype=torch.float64)
    tsol.gmres_arnoldi(Vt, wt, ht, 2, guards[1:])
    wj, hj = jnp.asarray(wr), []
    for i in range(3):
        hij = jnp.vdot(jnp.asarray(Vr[i]), wj)
        wj = wj - hij * jnp.asarray(Vr[i])
        hj.append(float(hij))
    hnorm = jnp.linalg.norm(wj)
    assert _rel(ht.numpy(), hj + [float(hnorm)]) <= 1e-14
    assert _rel(Vt[3].numpy(), np.asarray(wj / hnorm)) <= 1e-14
    np.testing.assert_array_equal(Vt[:3].numpy(), Vr[:3])
    y = torch.as_tensor(rng.normal(size=3))
    xc = torch.as_tensor(x0[:50].copy())
    tsol.gmres_combine(xc, Vt, y)
    assert _rel(xc.numpy(), x0[:50] + Vr[:3].T @ y.numpy()) <= 1e-14


@pytest.mark.parametrize('prec', [False, True], ids=['plain', 'mg'])
def test_bicgstab_update_plain_matches_bicgstab_core(carried, prec):
    """K18's plain version through 3 iterations at tolerance 0 against
    _bicgstab_core, and the passes of one iteration against the JAX loop
    body's expressions."""
    mj, mt, b = carried
    Mj = mj.asPreconditioner() if prec else jDiag(jnp.ones(len(b)))
    xj, itj, rj = jsol._bicgstab_core(mj.A, Mj, jnp.asarray(b),
                                      jnp.zeros(len(b)), 0.0, 3,
                                      use_prec=prec)
    st = _krylov(tsol.bicgstab_solver, mt.A, 0.0, 3,
                 prec=mt.asPreconditioner() if prec else None)
    xt = st.solve(torch.as_tensor(b))
    assert int(itj) == 3 and st.iterations == 3
    assert _rel(xt.numpy(), np.asarray(xj)) <= 1e-10
    assert abs(st.residuals[0] - float(rj)) <= 1e-10 * float(rj)

    rng = np.random.default_rng(5)
    n = 40
    x, r, r0, p, v, s, t = (rng.normal(size=n) for _ in range(7))
    rho, alpha, omega = 0.7, 1.3, 0.4
    vecs = [torch.as_tensor(a.copy()) for a in (x, r, r0, p, v, s, t)]
    X, R, R0, Pt, Vt, S, T = vecs
    scal = torch.tensor([0.0, rho, alpha, omega, 0.0], dtype=torch.float64)
    args = (X, R, R0, Pt, Vt, S, T, Pt, S)
    tsol.bicgstab_update('direction', *args, scal, 1)
    rho_new = np.dot(r0, r)
    pn = r + (rho_new / rho) * (alpha / omega) * (p - omega * v)
    assert _rel(Pt.numpy(), pn) <= 1e-14
    assert _rel(scal[[0, 4]].numpy(), [rho_new, np.linalg.norm(r)]) <= 1e-14
    tsol.bicgstab_update('step', *args, scal, 1)
    an = rho_new / np.dot(r0, v)
    sn = r - an * v
    assert _rel(S.numpy(), sn) <= 1e-14
    assert abs(float(scal[2]) - an) <= 1e-14 * abs(an)
    tsol.bicgstab_update('update', *args, scal, 1)
    on = np.dot(t, sn) / np.dot(t, t)
    assert _rel(X.numpy(), x + an * pn + on * sn) <= 1e-14
    assert _rel(R.numpy(), sn - on * t) <= 1e-14
    with pytest.raises(ValueError, match='mode'):
        tsol.bicgstab_update('start', *args, scal, 1)


def test_krylov_solvers_solve_complex(carried):
    """BiCGStab's complex branch on the real operator and a complex load
    against _bicgstab_core on the same load (iterations equal, x to 1e-8;
    the absolute tolerance 1e-5 ||b||: BiCGStab's residual on this operator
    jumps, and below about 1e-7 ||b|| rounding moves the step that crosses
    it, in the JAX package's own real and complex runs alike);
    GMRES solves it too (runHelmholtz's complex path): the real operator on
    a complex load converges, and equals the two real solves combined."""
    mj, mt, b = carried
    bc = torch.as_tensor(b).to(torch.complex128) * (1 - 2j)
    tol = 1e-5 * float(torch.linalg.norm(bc))
    xj, itj, _ = jsol._bicgstab_core(mj.A, jDiag(jnp.ones(len(b))),
                                     jnp.asarray(bc.numpy()),
                                     jnp.zeros(len(b), dtype=jnp.complex128),
                                     tol, 50)
    sb = _krylov(tsol.bicgstab_solver, mt.A, tol, 50)
    xb = sb.solve(bc)
    assert xb.dtype == torch.complex128
    assert sb.iterations == (int(itj) - 1 if 0 < int(itj) < 50 else int(itj))
    assert _rel(xb.numpy(), np.asarray(xj)) <= 1e-8
    s = _krylov(tsol.gmres_solver, mt.A, 1e-10, 50)
    x = s.solve(bc)
    assert x.dtype == torch.complex128
    assert s.explicitResidual <= 1e-9
    xr = _krylov(tsol.gmres_solver, mt.A, 1e-12, 50).solve(
        torch.as_tensor(b))
    assert _rel(x.numpy(), (1 - 2j) * xr.numpy()) <= 1e-9


def _groups(out):
    return {g: out.outputGroups[g].toDict() if hasattr(out, 'outputGroups')
            else out[g].toDict()
            for g in ('info', 'rates', 'iterations', 'residuals', 'errors')}


@pytest.mark.parametrize('domain,noRef', [('square', 4), ('interval', 6)])
def test_driver_matches_jax_driver(domain, noRef):
    from drivers.runSerialGMG import main as jMain
    argv = ['--domain', domain, '--noRef', str(noRef)]
    gj = _groups(jMain(argv))
    out = tMain(argv + ['--device', 'cpu'], quiet=True)
    gt = _groups(out)
    assert gt['info'] == gj['info']
    assert gt['iterations'] == gj['iterations']
    # the interval's residuals are compared absolutely: its unpreconditioned
    # Krylov solves stop at about 1e-13 after one step, and the rounding
    # of b - A x there is about eps |A| |x| = 3e-14 (the others sit near
    # 1e-6); its rates only where the residual is not that rounding
    for group in ('residuals', 'rates'):
        assert gt[group].keys() == gj[group].keys()
        for label, ref in gj[group].items():
            got = gt[group][label]
            resRef = gj['residuals'][label.replace('Rate of convergence',
                                                   'Residual norm')]
            if domain == 'interval' and group == 'residuals':
                assert abs(got - ref) <= 1e-10, (label, got, ref)
            elif domain == 'interval':
                if resRef >= 1e-10:
                    assert abs(got - ref) <= 1e-6 * ref, (label, got, ref)
            else:
                assert abs(got - ref) <= 1e-8 * ref, (label, got, ref)
    # errors to 1e-10 relative, above the rounding floor of their formula:
    # sqrt(|ex - 2 z.x + x.M x|) and sqrt(|ex - b.x|) cancel sums of the
    # size of the exact norm ex to err^2, so a few ulps of ex move err by
    # about eps ex / err^2 relative (1.1e-7 for the interval's L2 error)
    assert gt['errors'].keys() == gj['errors'].keys()
    p = diffusionProblem(domain)
    for label, ref in gj['errors'].items():
        ex, err = (p['L2ex'], gj['errors']['L^2 error']) if 'L^2' in label \
            else (p['H10ex'], gj['errors']['H^1_0 error'])
        rtol = 1e-10 + 16 * np.finfo(float).eps * ex / err ** 2
        assert abs(gt['errors'][label] - ref) <= rtol * ref, label
    if domain == 'square':
        # and the JAX outputs pinned from the driver's printout (7 digits)
        ref = JAX_SQUARE_NOREF4
        assert gt['info']['DoFs'] == ref['DoFs']
        assert np.isclose(gt['info']['Tol'], ref['Tol'], rtol=1e-6)
        for label, val in ref['iterations'].items():
            assert gt['iterations']['Number of iterations ' + label] == val
        for label, val in ref['residuals'].items():
            assert np.isclose(gt['residuals']['Residual norm ' + label], val,
                              rtol=1e-6)
        for label, val in ref['errors'].items():
            assert np.isclose(gt['errors'][label], val, rtol=1e-6)
    tim = out['timers'].toDict()
    nLvl = len(out['hierarchy'])
    assert nLvl == noRef + 1
    for k in range(nLvl):
        for part in ('local', 'pattern', 'scatter order', 'scatter'):
            assert tim[f'level {k} {part} seconds'] >= 0.0
    for label in ('MG', 'FMG', 'CG', 'PCG', 'GMRES', 'PGMRES', 'BICGSTAB',
                  'PBICGSTAB'):
        assert tim[f'solve {label} seconds'] > 0.0


def test_driver_defaults_to_the_card():
    """Without --device the driver asks for the card, and raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip('a GPU is present')
    with pytest.raises(RuntimeError, match='cuda'):
        tMain(['--domain', 'interval', '--noRef', '2'], quiet=True)


def test_diffusion_problem():
    p = diffusionProblem('square')
    assert p['noRef'] == 9 and p['L2ex'] == 0.25
    assert diffusionProblem('interval')['noRef'] == 15
    assert diffusionProblem('square', 'poly', noRef=3)['H10ex'] == 256 / 45
    X = np.random.default_rng(6).uniform(size=(20, 2))
    for problem in ('sin', 'poly'):
        fj = {'sin': lambda x: 2 * np.pi ** 2 * np.sin(np.pi * x[0])
              * np.sin(np.pi * x[1]),
              'poly': lambda x: 32 * x[0] * (1 - x[0])
              + 32 * x[1] * (1 - x[1])}[problem]
        np.testing.assert_allclose(
            diffusionProblem('square', problem)['rhsFun'](X),
            jfem.Lambda(fj)(X), rtol=1e-15)
    with pytest.raises(NotImplementedError, match='3D'):
        diffusionProblem('cube')


# the pinned values of tests/test_drivers_fractional.py for
# interval / s = 0.75 / lu / dense (the reference's regression cache)
INTERVAL_LU = {'Hs error': 0.04184296289342096,
               'L2 error': 0.0014584869810690354,
               'L2 error interpolated': 0.0010892426293132285,
               'Linf error interpolated': 0.0009870492444666035,
               'relative Hs error': 0.04023426572737264,
               'relative L2 error': 0.0017862744500557024,
               'relative interpolated L2 error': 0.0013341261573797264,
               'relative interpolated Linf error': 0.0013121244257911582}


def test_nonlocal_drivers_take_the_new_solvers():
    from pynucleus_tpu_torch.drivers import runFractional, runNonlocal
    for name in ('lu', 'gmres', 'gmres-jacobi', 'gmres-mg',
                 'bicgstab-jacobi', 'bicgstab-mg'):
        for mod in (runFractional, runNonlocal):
            assert mod.parser().parse_args(
                ['--solverType', name]).solverType == name
    out = runFractional.main(
        ['--domain', 'interval', '--s', 'const(0.75)', '--problem',
         'constant', '--element', 'P1', '--solverType', 'lu',
         '--matrixFormat', 'dense', '--device', 'cpu'], quiet=True)
    errs = out['errors'].toDict()
    for label, val in INTERVAL_LU.items():
        assert np.isclose(errs[label], val, rtol=3e-2, atol=1e-8), label
    out = runFractional.main(
        ['--domain', 'interval', '--s', 'const(0.75)', '--solverType',
         'gmres-mg', '--matrixFormat', 'dense', '--noRef', '4', '--device',
         'cpu'], quiet=True)
    assert out['solver'].residuals[-1] <= 1e-6
    assert np.isclose(out['errors'].toDict()['L2 error'],
                      runFractional.main(
                          ['--domain', 'interval', '--s', 'const(0.75)',
                           '--solverType', 'lu', '--matrixFormat', 'dense',
                           '--noRef', '4', '--device', 'cpu'],
                          quiet=True)['errors'].toDict()['L2 error'],
                      rtol=1e-4)


def test_new_modules_import_no_jax():
    code = ('import pynucleus_tpu_torch.drivers.runSerialGMG, '
            'pynucleus_tpu_torch.fem.pdeProblems, '
            'pynucleus_tpu_torch.kernels.gmres_arnoldi, '
            'pynucleus_tpu_torch.kernels.bicgstab_update, sys; '
            "assert 'jax' not in sys.modules, 'jax imported'")
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                   timeout=120)

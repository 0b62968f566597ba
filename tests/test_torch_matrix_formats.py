"""The port's remaining matrix formats of assembleNonlocal against the JAX
package: 'H2corrected' (the complement kernel, its cross operator through
K1 with the complement indicator and a launch-wide entry mask, and
horizonCorrected with a horizon sweep), 'diagonal' with the zero-exterior
term, and 'sparsified'.

Same inputs in both packages (the same meshes built by each, numpy seeds);
on the CPU the port's kernel wrappers run their plain versions:

  complement kernel  ball2Complement's indicator, Kernel.eval /
                     Kernel.__call__ and getComplementKernel's fields
                     against jaxIndicator, jaxEval, __call__: exact (1e-15
                     for the profile)
  K1 complement      one bucket of ring-cut pairs (compact=False rule) with
                     the complement indicator, and its scatter with the
                     off-diagonal block mask, against _bucket_contrib and
                     the JAX package's DROP rows: 1e-13 of the largest entry
  cross operator     _getComplementCross on the interval at noRef 3 and the
                     square at noRef 1: 1e-12 of the largest entry
  H2corrected        toarray 1e-12, apply 1e-10 of the JAX operator; the
                     bars of tests/test_matrix_formats.py test_h2corrected
                     against the port's getSparse; setKernel to delta 0.3
                     keeps S_inf and caches the cross operator; CG at noRef
                     6: the JAX package's 32 iterations and ||x||
  diagonal           s = 0.6, infinite horizon, zero exterior: the interval
                     at noRef 4 and the disc at noRef 1 (normals) against
                     the JAX getDiagonal, 1e-12
  sparsified         the finite-horizon interval at noRef 3: a
                     CSR_LinearOperator with the JAX pattern and values,
                     1e-12
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pynucleus_tpu.fem import meshFactory, dofmapFactory
from pynucleus_tpu.fem.dofmaps import P1_DoFMap as jP1
from pynucleus_tpu.fem.meshes import circle as jCircle
from pynucleus_tpu.nl.assembly import (assembleNonlocal as jAssemble,
                                       nonlocalBuilder as jBuilder,
                                       _bucket_contrib, _psi_prod)
from pynucleus_tpu.nl.kernels import (getFractionalKernel as jFractional,
                                      ball2Complement as jComplement)
from pynucleus_tpu.nl.problems import (nonlocalMeshFactory,
                                       HOMOGENEOUS_DIRICHLET as J_HD)
from pynucleus_tpu.nl.quad_singular import distantRule as jDistantRule

from pynucleus_tpu_torch.base.linear_operators import CSR_LinearOperator
from pynucleus_tpu_torch.base.solvers import solverFactory
from pynucleus_tpu_torch.fem.assembly import assembleMass
from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
from pynucleus_tpu_torch.fem.meshes import simpleInterval, circle
from pynucleus_tpu_torch.nl import assembly as tasm
from pynucleus_tpu_torch.nl.assembly import (assembleNonlocal,
                                             nonlocalBuilder,
                                             horizonCorrected)
from pynucleus_tpu_torch.nl.kernels import (getFractionalKernel,
                                            interactionFactory,
                                            ball2Complement, indicatorMask,
                                            BALL2_COMPLEMENT)
from pynucleus_tpu_torch.nl.problems import (nonlocalMesh,
                                             HOMOGENEOUS_DIRICHLET)
from pynucleus_tpu_torch.nl.quad_singular import distantRule

S, DELTA = 0.25, 0.4
# the JAX package's CG (tolerance 1e-10, no preconditioner) on its
# H2corrected operator of the interval at noRef 6 (319 dofs), b = M 1
JAX_CG = {'iterations': 32, 'x_norm': 7.855299249784015}


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def t(a, dtype=torch.float64):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def portSetup(domain, noRef, horizon=DELTA, device='cpu'):
    """(dofmap, kernel) of the port: the fractional kernel of order S and
    the horizon on nonlocalMesh's domain with its collar
    (HOMOGENEOUS_DIRICHLET) refined noRef times, the interior dofs (the
    domain indicator's tag)."""
    tk = getFractionalKernel(1 if domain == 'interval' else 2, S,
                             horizon=horizon)
    tmesh, info = nonlocalMesh(domain, tk, HOMOGENEOUS_DIRICHLET)
    for _ in range(noRef):
        tmesh = tmesh.refine()
    return P1_DoFMap(tmesh, tag=info['domain'], device=device), tk


def setups(domain, noRef, horizon=DELTA):
    """(JAX dofmap, JAX kernel, port dofmap, port kernel) of portSetup in
    each package (nonlocalMeshFactory's mesh in the JAX package)."""
    dim = 1 if domain == 'interval' else 2
    jk = jFractional(dim, S, horizon=horizon)
    mesh, nI = nonlocalMeshFactory.build(
        domain, kernel=jk, boundaryCondition=J_HD,
        **({'a': -1, 'b': 1} if domain == 'interval' else {}))
    for _ in range(noRef):
        mesh = mesh.refine()
    jdm = jP1(mesh, tag=nI['domain'])
    tdm, tk = portSetup(domain, noRef, horizon)
    assert np.array_equal(np.asarray(jdm.dofs), tdm.dofs)
    np.testing.assert_array_equal(np.asarray(mesh.vertices),
                                  tdm.mesh.vertices)
    return jdm, jk, tdm, tk


# --------------------------------------------------- complement kernel --

def test_complement_kernel_matches_jax():
    """ball2Complement's indicator (code 5, r2 >= h2), the kernel's
    evaluation and getComplementKernel's fields against the JAX package."""
    assert interactionFactory['ball2Complement'] is ball2Complement
    assert ball2Complement.code == BALL2_COMPLEMENT == 5
    jk = jFractional(2, S, horizon=DELTA)
    tk = getFractionalKernel(2, S, horizon=DELTA)
    jc, tc = jk.getComplementKernel(), tk.getComplementKernel()
    for a in ('complement', 'finiteHorizon', 'scalingValue', 'horizonValue',
              'singularityValue'):
        assert getattr(tc, a) == getattr(jc, a), a
    assert tc.complement and not tc.finiteHorizon and tk.finiteHorizon
    assert tc.profileParams() == tk.profileParams()
    assert tc.indicatorParams()[:2] == (BALL2_COMPLEMENT, DELTA ** 2)
    rng = np.random.default_rng(3)
    x = rng.uniform(-0.5, 0.5, (2000, 2))
    y = rng.uniform(-0.5, 0.5, (2000, 2))
    # points at the horizon exactly, in the node arithmetic of both
    y[:10] = x[:10] + np.array([DELTA, 0.0])
    r2 = t(((x - y) ** 2).sum(-1))
    ind = indicatorMask(t(x), t(y), r2, tc.indicatorParams()).numpy()
    jind = np.asarray(jComplement().jaxIndicator(
        jnp.asarray(x), jnp.asarray(y), DELTA ** 2))
    np.testing.assert_array_equal(ind, jind.astype(bool))
    assert 0 < ind.sum() < len(ind)
    for k1, k2 in ((tc, jc), (tk, jk)):
        v = k1.eval(t(x), t(y)).numpy()
        jv = np.asarray(k2.jaxEval(jnp.asarray(x), jnp.asarray(y)))
        assert np.array_equal(v == 0, jv == 0)
        assert rel(v, jv) <= 1e-15
        for p in range(20):
            assert k1(x[p], y[p]) == pytest.approx(k2(x[p], y[p]),
                                                   rel=1e-15, abs=0)


def test_k1_complement_bucket_matches_bucket_contrib():
    """K1's plain version with the complement indicator on the ring-cut
    pairs of the interval (compact=False rule): the local matrices against
    _bucket_contrib, and the dense target with the off-diagonal block mask
    against the JAX package's scatter with DROP rows."""
    jdm, jk, tdm, tk = setups('interval', 3)
    jc, tc = jk.getComplementKernel(), tk.getComplementKernel()
    mesh = tdm.mesh
    C = mesh.num_cells
    iu, ju = np.triu_indices(C, k=0)
    from pynucleus_tpu_torch.nl.panels import _pairMinMaxDistance
    dmin, dmax = _pairMinMaxDistance(mesh.vertices, mesh.cells, iu, ju)
    sel = (dmax > DELTA) & (dmin < DELTA)
    ii, jj = iu[sel], ju[sel]
    assert len(ii) > 20
    rule, jrule = distantRule(12, 1, compact=False), \
        jDistantRule(12, 1, compact=False)
    PSI = rule.buildPSI(tdm, nSharedVertices=0)
    vols = mesh.simplexVolumes()
    vs = vols[ii] * vols[jj] * 2.0
    verts, cells = mesh.vertices, mesh.cells
    Mj = np.asarray(_bucket_contrib(
        jnp.asarray(verts), jnp.asarray(cells[ii]), jnp.asarray(cells[jj]),
        jnp.asarray(vs), jnp.asarray(jrule.bary_x), jnp.asarray(jrule.bary_y),
        jnp.asarray(jrule.w), jnp.asarray(_psi_prod(PSI)), kernel=jc))
    args = (t(verts), t(cells[ii], torch.int64), t(cells[jj], torch.int64),
            t(vs), None, t(rule.bary_x), t(rule.bary_y), t(rule.w),
            t(tasm._psi_prod(PSI)), tc.profileParams(), tc.indicatorParams())
    Mt = tasm._panelMatrices(*args).numpy()
    assert rel(Mt, Mj) <= 1e-13
    dpe = tdm.dofs_per_element
    em = np.zeros((2 * dpe, 2 * dpe), dtype=bool)
    em[:dpe, dpe:] = em[dpe:, :dpe] = True
    dr = np.concatenate([tdm.dofs[ii], tdm.dofs[jj]], axis=1)
    N = tdm.num_dofs
    Aj = np.zeros((N + 1, N + 1))
    shape = (len(ii),) + em.shape
    rb = np.where(em, np.broadcast_to(dr[:, :, None], shape), -1)
    cb = np.broadcast_to(dr[:, None, :], shape)
    np.add.at(Aj, (np.where(rb >= 0, rb, N).ravel(),
                   np.where(cb >= 0, cb, N).ravel()), Mj.ravel())
    A = torch.zeros((N, N), dtype=torch.float64)
    tasm.panel_scatter(A, *args[:3], t(dr, torch.int64), *args[3:9],
                       args[9], indicator=args[10], entryMask=em)
    assert rel(A.numpy(), Aj[:N, :N]) <= 1e-13
    with pytest.raises(ValueError, match='entryMask'):
        tasm.panel_scatter(A, *args[:3], t(dr, torch.int64), *args[3:9],
                           args[9], indicator=args[10], entryMask=em[:2])


def _plantedTies(P=64):
    """P pairs of 1D cells, each second cell its first one shifted by
    delta, so the nodes of one local coordinate are delta apart up to the
    rounding of their vertex sums: (vertices [4P, 1], cells1 [P, 2],
    cells2 [P, 2], volsym [P]); each cell's vertices are its dofs."""
    rng = np.random.default_rng(5)
    a = rng.uniform(-1.0, 1.0, P)
    h = DELTA / rng.integers(1, 16, P)
    verts = np.stack([a, a + h, a + DELTA, a + h + DELTA], 1).reshape(-1, 1)
    cells = np.arange(4 * P).reshape(P, 4)
    return verts, cells[:, :2], cells[:, 2:], h * h * 2.0


def test_k1_complement_decides_ties_as_bucket_contrib():
    """Node pairs planted at |x-y| = delta (_plantedTies): K1's plain
    version decides the complement indicator there as _bucket_contrib does
    (its nodes and local matrices, 1e-13), where a vertex sum rounded twice
    per term (product, then sum) decides some of them the other way."""
    P = 64
    verts, c1, c2, vs = _plantedTies(P)
    tdm, tk = portSetup('interval', 1)
    jc = jFractional(1, S, horizon=DELTA).getComplementKernel()
    tc = tk.getComplementKernel()
    rule, jrule = distantRule(12, 1, compact=False), \
        jDistantRule(12, 1, compact=False)
    PSI = rule.buildPSI(tdm, nSharedVertices=0)
    h2 = DELTA ** 2
    # the JAX package's nodes, as _bucket_contrib forms them
    xj = jnp.einsum('pvd,vq->pqd', jnp.asarray(verts[c1]),
                    jnp.asarray(jrule.bary_x))
    yj = jnp.einsum('pvd,vq->pqd', jnp.asarray(verts[c2]),
                    jnp.asarray(jrule.bary_y))
    jind = np.asarray(jComplement().jaxIndicator(xj, yj, h2)).astype(bool)
    r2j = np.asarray(jnp.sum((xj - yj) ** 2, axis=-1))
    assert (r2j == h2).any(axis=1).sum() > P // 2
    x = tasm._fmaNodes(t(verts), t(c1, torch.int64), t(rule.bary_x))
    y = tasm._fmaNodes(t(verts), t(c2, torch.int64), t(rule.bary_y))
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(y.numpy(), np.asarray(yj))
    r2 = ((x - y) ** 2).sum(-1)
    ind = indicatorMask(x, y, r2, tc.indicatorParams()).numpy()
    np.testing.assert_array_equal(ind, jind)
    # a vertex sum of two roundings per term decides other ways
    x2 = tasm._nodesInOrder(t(verts), t(c1, torch.int64), t(rule.bary_x))
    y2 = tasm._nodesInOrder(t(verts), t(c2, torch.int64), t(rule.bary_y))
    assert (indicatorMask(x2, y2, ((x2 - y2) ** 2).sum(-1),
                          tc.indicatorParams()).numpy() != jind).any()
    Mj = np.asarray(_bucket_contrib(
        jnp.asarray(verts), jnp.asarray(c1), jnp.asarray(c2),
        jnp.asarray(vs), jnp.asarray(jrule.bary_x), jnp.asarray(jrule.bary_y),
        jnp.asarray(jrule.w), jnp.asarray(_psi_prod(PSI)), kernel=jc))
    Mt = tasm._panelMatrices(
        t(verts), t(c1, torch.int64), t(c2, torch.int64), t(vs), None,
        t(rule.bary_x), t(rule.bary_y), t(rule.w), t(tasm._psi_prod(PSI)),
        tc.profileParams(), tc.indicatorParams()).numpy()
    assert rel(Mt, Mj) <= 1e-13


# ---------------------------------------------------- cross, H2corrected --

@pytest.mark.parametrize('domain,noRef,chunk', [('interval', 3, 97),
                                                ('square', 1, None)])
def test_complement_cross_matches_jax(domain, noRef, chunk, monkeypatch):
    """The cross operator against the JAX package's; on the interval in
    chunks of 97 pairs."""
    if chunk is not None:
        monkeypatch.setattr(nonlocalBuilder, 'CROSS_CHUNK', chunk)
    jdm, jk, tdm, tk = setups(domain, noRef)
    Cj = np.asarray(jBuilder(jdm, jk.getComplementKernel(),
                             zeroExterior=False)
                    ._getComplementCross().toarray())
    b = nonlocalBuilder(tdm, tk.getComplementKernel(), zeroExterior=False)
    Ct = b._getComplementCross().toarray()
    assert rel(Ct, Cj) <= 1e-12
    assert set(b.timers) == {'classification', 'quadrature'}


def test_triu_chunks_and_distances_are_the_jax_ones():
    """_triuChunks gives triu_indices(C, k=0) in order; the pair distances
    equal the JAX package's _pairMinDistance and _pairMaxDistance."""
    for C, chunk in ((1, 1), (9, 4), (9, 100), (17, 1), (40, 33)):
        iu, ju = (np.concatenate(a) for a in zip(*tasm._triuChunks(C,
                                                                   chunk)))
        ref = np.triu_indices(C, k=0)
        np.testing.assert_array_equal(iu, ref[0])
        np.testing.assert_array_equal(ju, ref[1])
    from pynucleus_tpu.nl.panels import (_pairMinDistance,
                                         _pairMaxDistance)
    from pynucleus_tpu_torch.nl.panels import _pairMinMaxDistance
    for domain, noRef in (('interval', 3), ('square', 1)):
        _, _, tdm, _ = setups(domain, noRef)
        iu, ju = np.triu_indices(tdm.mesh.num_cells, k=0)
        m = tdm.mesh
        dmin, dmax = _pairMinMaxDistance(m.vertices, m.cells, iu, ju)
        np.testing.assert_array_equal(
            dmin, _pairMinDistance(m.vertices, m.cells, iu, ju))
        np.testing.assert_array_equal(
            dmax, _pairMaxDistance(m.vertices, m.cells, iu, ju))


def test_h2corrected_matches_jax():
    """toarray and apply against the JAX operator; the bars of
    tests/test_matrix_formats.py test_h2corrected against the port's own
    getSparse; setKernel reuses S_inf and caches the cross operators."""
    jdm, jk, tdm, tk = setups('interval', 3)
    Aj = jAssemble(jdm, jk, matrixFormat='H2corrected')
    Ac = assembleNonlocal(tdm, tk, matrixFormat='H2corrected')
    assert isinstance(Ac, horizonCorrected)
    assert (Ac.facS, Ac.c_tot) == (Aj.facS, Aj.c_tot)
    Act = Ac.toarray()
    assert rel(Act, np.asarray(Aj.toarray())) <= 1e-12
    x = np.cos(np.arange(tdm.num_dofs) * 0.3)
    assert rel(Ac.matvec(t(x)).numpy(), np.asarray(Aj @ x)) <= 1e-10
    np.testing.assert_allclose(Ac.diagonal.numpy(), np.diag(Act),
                               rtol=1e-14)
    Asp = nonlocalBuilder(tdm, tk).getSparse().toarray()
    assert np.abs(Act - Asp).max() < 5e-3 * np.abs(Asp).max()
    rel1 = np.linalg.norm(Ac.matvec(t(x)).numpy() - Asp @ x) \
        / np.linalg.norm(Asp @ x)
    assert rel1 < 5e-3
    Sinf, Cross = Ac.Sinf, Ac.Cross
    k2 = getFractionalKernel(1, S, horizon=0.3)
    Ac.setKernel(k2)
    assert Ac.Sinf is Sinf and Ac.Cross is not Cross
    assert set(Ac.timers) == {'classification', 'quadrature'}
    Cross2 = Ac.Cross
    Ac.setKernel(getFractionalKernel(1, S, horizon=0.3))
    assert Ac.Cross is Cross2 and Ac.timers == {}
    Asp2 = nonlocalBuilder(tdm, k2).getSparse().toarray()
    rel2 = np.linalg.norm(Ac.matvec(t(x)).numpy() - Asp2 @ x) \
        / np.linalg.norm(Asp2 @ x)
    assert rel2 < 1e-2
    Aj.setKernel(jFractional(1, S, horizon=0.3))
    assert rel(Ac.toarray(), np.asarray(Aj.toarray())) <= 1e-12


def test_h2corrected_cg_matches_jax():
    """CG (tolerance 1e-10) on H2corrected of the interval at noRef 6, b =
    M 1: the JAX package's iterations and ||x||; Jacobi through the
    operator's diagonal."""
    _, _, tdm, tk = setups('interval', 6)
    A = assembleNonlocal(tdm, tk, matrixFormat='H2corrected')
    b = assembleMass(tdm).matvec(torch.ones(tdm.num_dofs,
                                            dtype=torch.float64))
    for name in ('cg', 'cg-jacobi'):
        s = solverFactory.build(name, A=A, setup=True)
        s.tolerance, s.maxIter = 1e-10, 1000
        x = s.solve(b)
        assert s.iterations == JAX_CG['iterations'], name
        assert float(torch.linalg.norm(x)) == pytest.approx(
            JAX_CG['x_norm'], rel=1e-10)


def test_h2corrected_refusals():
    """H2corrected of an infinite horizon, H2 of a complement kernel and
    an unknown format raise."""
    tdm, tk = portSetup('interval', 2)
    with pytest.raises(ValueError, match='finite horizon'):
        nonlocalBuilder(tdm, getFractionalKernel(1, S)).getH2FiniteHorizon()
    with pytest.raises(NotImplementedError, match='dense'):
        nonlocalBuilder(tdm, tk.getComplementKernel(),
                        zeroExterior=False).getH2()
    with pytest.raises(NotImplementedError, match='csr'):
        assembleNonlocal(tdm, tk, matrixFormat='csr')


# ------------------------------------------------- diagonal, sparsified --

def _diagonalDofmaps(domain):
    if domain == 'interval':
        jm, tm, n = meshFactory('interval', a=-1, b=1), \
            simpleInterval(-1.0, 1.0), 4
    else:
        jm, tm, n = jCircle(h=0.78, radius=1.0), circle(h=0.78, radius=1.0), 1
    for _ in range(n):
        jm, tm = jm.refine(), tm.refine()
    return dofmapFactory('P1', jm), P1_DoFMap(tm, device='cpu')


@pytest.mark.parametrize('domain', ['interval', 'disc'])
def test_diagonal_with_zero_exterior_matches_jax(domain):
    """getDiagonal of s = 0.6, infinite horizon, with the zero-exterior
    term (every surface pair through K1's diagonal target; 2D with
    normals) against the JAX getDiagonal, and equal to the diagonal of the
    port's getDense without the grid."""
    jdm, tdm = _diagonalDofmaps(domain)
    assert np.array_equal(np.asarray(jdm.dofs), tdm.dofs)
    dim = tdm.mesh.dim
    dj = np.asarray(jAssemble(jdm, jFractional(dim, 0.6),
                              matrixFormat='diagonal').data)
    tk = getFractionalKernel(dim, 0.6)
    d = assembleNonlocal(tdm, tk, matrixFormat='diagonal').data.numpy()
    assert rel(d, dj) <= 1e-12
    D = nonlocalBuilder(tdm, tk, params={'denseGrid': False}).getDense()
    assert rel(d, np.diag(D.toarray())) <= 1e-12


def test_sparsified_matches_jax():
    jdm, jk, tdm, tk = setups('interval', 3)
    Aj = jAssemble(jdm, jk, matrixFormat='sparsified')
    A = assembleNonlocal(tdm, tk, matrixFormat='Sparsified')
    assert isinstance(A, CSR_LinearOperator)
    np.testing.assert_array_equal(A.indptrH, np.asarray(Aj.indptr))
    np.testing.assert_array_equal(A.indicesH, np.asarray(Aj.indices))
    assert rel(A.dataH, np.asarray(Aj.data)) <= 1e-12
    D = assembleNonlocal(tdm, tk, matrixFormat='dense').toarray()
    np.testing.assert_array_equal(A.toarray(), D)
    # an infinite horizon's operator is dense: it stays dense
    _, tdm2 = _diagonalDofmaps('interval')
    assert not isinstance(assembleNonlocal(tdm2, getFractionalKernel(1, 0.6),
                                           matrixFormat='sparsified'),
                          CSR_LinearOperator)


# ------------------------------------------------------------- the card --

@pytest.mark.cuda
def test_matrix_format_kernels_match_plain_on_gpu():
    """K1 with the complement indicator on the planted ties, and with the
    block mask (the cross operators of the interval at noRef 5 and the
    square at noRef 1), and K1's diagonal target on the zero-exterior pairs
    (the disc at noRef 2) on the card against their plain versions on the
    CPU, to 1e-12 of the largest entry (atomics add in no fixed order;
    needs an NVIDIA GPU)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    from pynucleus_tpu_torch import kernels
    kernels.resetLaunches()
    # the planted ties: K1's fused vertex sums decide as the plain version's
    verts, c1, c2, vs = _plantedTies()
    tdm, tk = portSetup('interval', 1)
    tc = tk.getComplementKernel()
    rule = distantRule(12, 1, compact=False)
    PSIP = tasm._psi_prod(rule.buildPSI(tdm, nSharedVertices=0))
    out = []
    for device in ('cuda', 'cpu'):
        def d(a, dtype=torch.float64):
            return t(a, dtype).to(device)
        A = torch.zeros((len(verts), len(verts)), dtype=torch.float64,
                        device=device)
        tasm.panel_scatter(A, d(verts), d(c1, torch.int64),
                           d(c2, torch.int64),
                           d(np.concatenate([c1, c2], 1), torch.int64),
                           d(vs), None, d(rule.bary_x), d(rule.bary_y),
                           d(rule.w), d(PSIP), tc.profileParams(),
                           indicator=tc.indicatorParams())
        out.append(A.cpu().numpy())
    assert rel(*out) <= 1e-12
    for domain, noRef in (('interval', 5), ('square', 1)):
        out = []
        for device in ('cuda', 'cpu'):
            dm, k = portSetup(domain, noRef, device=device)
            out.append(nonlocalBuilder(dm, k.getComplementKernel(),
                                       zeroExterior=False)
                       ._getComplementCross().toarray())
        assert rel(*out) <= 1e-12, domain
    out = []
    for device in ('cuda', 'cpu'):
        m = circle(h=0.78, radius=1.0).refine().refine()
        out.append(assembleNonlocal(P1_DoFMap(m, device=device),
                                    getFractionalKernel(2, 0.6),
                                    matrixFormat='diagonal').data.cpu())
    assert rel(*out) <= 1e-12
    for key in kernels.FORMATS:
        assert kernels.deviceLaunches[key] == kernels.launches[key] > 0, key

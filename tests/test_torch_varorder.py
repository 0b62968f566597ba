"""Variable-order and nonsymmetric fractional kernels on the interval
(varconst, constantNonSym, twoDomainNonSym) of the port against the JAX
package.

  evalXY         nl.kernels.evalXY of constantNonSym and leftRight (both
                 sides, across the interface, the boundary form) against
                 FractionalKernel.evalXY on seeded points: 1e-13 relative
  flags          the orders' values, bounds and keys, the kernels'
                 variable / variableOrder / symmetric flags and singularity
                 bounds: equal
  K1 (plain)     panel_scatter with an order and a y shift against
                 _bucket_contrib(useYShift=True): 1e-13 of the largest entry
  K19 (plain)    panel_scatter_nonsym against _bucket_contrib_nonsym on the
                 same pairs and rules: 1e-13 of the largest entry
  K7 (plain)     far_field of a leftRight kernel against _farFieldBlocks:
                 1e-12 relative
  K20 (plain)    h2_matvec_T on the JAX operator's arrays (h2FromArrays)
                 against _h2_matvec_T: 1e-12 relative
  host copies    splitLeavesByKernelBlocks, _getKernelJumps,
                 _pairSingularities, the touching-bucket keys, the union
                 surface items with their signs: equal
  getDense       constantNonSym(0.25) and twoDomainNonSym(0.25,0.75) at
                 noRef 5: 1e-12 relative
  H2             the near data against the JAX CPU build
                 (CSRAccumulator): 1e-10 of max|data|; the apply and the
                 transposed apply against JAX: 1e-10 relative; H.T.T is H;
                 the far list holds (i, j) and (j, i); H2 against dense
  drivers        the port driver on the six lines of
                 tests/test_drivers_fractional.py:121-167 against their pins
                 (rtol 3e-2) and the JAX driver's outputs pinned below from
                 a CPU run (1e-6), iterations equal +-1; twoDomainNonSym
                 H2 lu at noRef 10: the port's L2 error against the JAX
                 driver's (1e-6), both more than ten times the dense one

(1e-12 and 1e-13: the same float64 quadrature summed in another order.)
The JAX side runs on the CPU as the JAX package's own tests run it; the
port's kernel wrappers run their plain versions on CPU tensors.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.nl import kernels as jker
from pynucleus_tpu.nl import assembly as jasm
from pynucleus_tpu.nl import h2 as jh2
from pynucleus_tpu.nl import quad_singular as jqs
from pynucleus_tpu.nl.panels import classifyPairsDense as jClassify
from pynucleus_tpu.nl.problems import parseFractionalOrder as jParse

from pynucleus_tpu_torch.interop import fromArrays, h2FromArrays
from pynucleus_tpu_torch.nl import assembly as tasm
from pynucleus_tpu_torch.nl import h2 as th2
from pynucleus_tpu_torch.nl import kernels as tker
from pynucleus_tpu_torch.nl.problems import parseFractionalOrder as tParse
from pynucleus_tpu_torch.nl.panels import classifyPairsDense as tClassify

NONSYM = ['constantNonSym(0.25)', 'twoDomainNonSym(0.25,0.75)']
LR = 'twoDomainNonSym(0.25,0.75)'


def _interval(noRef):
    """The runFractional interval mesh of noRef: [-1, 1] refined noRef + 1
    times."""
    m = jfem.simpleInterval(-1.0, 1.0)
    for _ in range(noRef + 1):
        m = m.refine()
    return m


def _pair(sArg, m):
    """(JAX dofmap, JAX kernel, port dofmap, port kernel) on mesh m."""
    dm = jfem.P1_DoFMap(m)
    jk = jker.getFractionalKernel(1, jParse(sArg))
    _, tdm, tk = fromArrays(m.vertices, m.cells, sArg, 1, device='cpu')
    return dm, jk, tdm, tk


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _rel(got, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(got) - ref).max() / np.abs(ref).max()


# ------------------------------------------------------------- orders ----

@pytest.mark.parametrize('sArg', ['varconst(0.75)'] + NONSYM)
def test_orders_and_flags_match_jax(sArg):
    js, ts = jParse(sArg), tParse(sArg)
    assert type(ts).__name__ == type(js).__name__
    assert (ts.min, ts.max, ts.symmetric, repr(ts)) == \
        (js.min, js.max, js.symmetric, repr(js))
    assert ts._key() == js._key()
    X = np.linspace(-1.0, 1.0, 9)[:, None]
    np.testing.assert_array_equal(ts(X, X[::-1]), js(X, X[::-1]))
    jk, tk = jker.getFractionalKernel(1, js), tker.getFractionalKernel(1, ts)
    for name in ('variable', 'variableOrder', 'symmetric', 'min_singularity',
                 'max_singularity', 'singularityValue', 'scalingValue'):
        assert getattr(tk, name) == getattr(jk, name), name
    bj, bt = jk.getBoundaryKernel(), tk.getBoundaryKernel()
    for name in ('variable', 'symmetric', 'singularityValue',
                 'scalingValue', 'min_singularity', 'max_singularity'):
        assert getattr(bt, name) == getattr(bj, name), name
    for name in ('varconst', 'constantNonSym', 'twoDomain',
                 'twoDomainNonSym', 'leftRight'):
        f = jker.fractionalOrderFactory
        assert f.classes[f.getCanonicalName(name)][1].__name__ == \
            tker.fractionalOrderFactory[name].__name__


def test_variable_order_refusals():
    with pytest.raises(NotImplementedError):
        tker.getFractionalKernel(1, tParse(LR), horizon=0.5)
    # a variable order in 2D assembles dense (tests/test_torch_orders2d.py);
    # its H2 operator raises, as the JAX package fails there
    m = jfem.circle(h=0.78, radius=1.0)
    _, tdm, tk = fromArrays(m.vertices, m.cells, LR, 2, device='cpu')
    with pytest.raises(NotImplementedError):
        tasm.nonlocalBuilder(tdm, tk).getH2()
    # the fe order needs an FE vector: no string of it parses
    with pytest.raises(NotImplementedError):
        tParse('fe(0.25,0.75)')


EVAL_CASES = [('constantNonSym(0.25)', False), (LR, False), (LR, True)]


@pytest.mark.parametrize('sArg,boundary', EVAL_CASES,
                         ids=['constantNonSym', 'leftRight',
                              'leftRight-boundary'])
def test_evalXY_matches_jax(sArg, boundary):
    jk = jker.getFractionalKernel(1, jParse(sArg))
    tk = tker.getFractionalKernel(1, tParse(sArg))
    if boundary:
        jk, tk = jk.getBoundaryKernel(), tk.getBoundaryKernel()
    rng = np.random.default_rng(11)
    # both sides, across the interface, and points on it
    x = np.concatenate([rng.uniform(-1, 1, 400), [0.0, -0.3, 0.0]])[:, None]
    y = np.concatenate([rng.uniform(-1, 1, 400), [0.2, 0.0, -1e-9]])[:, None]
    r2 = ((x - y) ** 2).sum(-1)
    ref = np.asarray(jk.evalXY(jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(r2)))
    got = tker.evalXY(_t(x), _t(y), _t(r2), tk.profileParams(),
                      tk.orderParams()).numpy()
    assert (np.abs(got - ref) <= 1e-13 * np.abs(ref)).all()
    zero = tker.evalXY(_t(x[:2]), _t(x[:2]), _t(np.zeros(2)),
                       tk.profileParams(), tk.orderParams())
    assert (zero == 0).all()


# ------------------------------------------------------- K1, K19, K7 ----

def _randomPairs(P, nv2, seed):
    """P random 1D pairs on seeded vertices in [-1, 1]: vi1 [P, 2] cells,
    vi2 [P, nv2] (a cell, or a vertex for nv2 = 1)."""
    rng = np.random.default_rng(seed)
    V = np.sort(rng.uniform(-1.0, 1.0, 64))[:, None]
    V[32, 0] = 0.0
    c = rng.integers(0, 63, P)
    vi1 = np.stack([c, c + 1], axis=1)
    if nv2 == 1:
        vi2 = rng.integers(0, 64, (P, 1))
    else:
        d = (c + rng.integers(2, 30, P)) % 63
        vi2 = np.stack([d, d + 1], axis=1)
    return V, vi1, vi2, rng.uniform(0.5, 2.0, P)


def test_k1_order_and_yshift_plain_matches_jax():
    jk = jker.getFractionalKernel(1, jParse(LR)).getBoundaryKernel()
    tk = tker.getFractionalKernel(1, tParse(LR)).getBoundaryKernel()
    V, vi1, vi2, vs = _randomPairs(200, 1, 3)
    rule = jqs.boundaryVertexRule1D(-1.5, 12)
    P = len(vi1)
    dm = jfem.P1_DoFMap(jfem.simpleInterval(-1.0, 1.0).refine())
    PSI = rule.buildPSI(dm, boundary=True)
    PSIP = jasm._psi_prod(PSI)
    yShift = np.where(np.arange(P) % 2, 1.0, -1.0)[:, None] * 1e-9
    ref = np.asarray(jasm._bucket_contrib(
        jnp.asarray(V), jnp.asarray(vi1), jnp.asarray(vi2), jnp.asarray(vs),
        jnp.asarray(rule.bary_x), jnp.asarray(rule.bary_y),
        jnp.asarray(rule.w), jnp.asarray(PSIP), kernel=jk,
        yShift=jnp.asarray(yShift), useYShift=True))
    n = PSI.shape[0] ** 2
    data = torch.zeros(P * n + 1, dtype=torch.float64)
    tasm.panel_scatter_slots(
        data, _t(V), _t(vi1, torch.int64), _t(vi2, torch.int64),
        _t(np.arange(P * n).reshape(P, n), torch.int32), _t(vs), None,
        _t(rule.bary_x), _t(rule.bary_y), _t(rule.w), _t(PSIP),
        tk.profileParams(), order=tk.orderParams(), yShift=_t(yShift))
    got = data[:-1].numpy().reshape(P, n)
    assert _rel(got, ref) <= 1e-13


@pytest.mark.parametrize('sArg', NONSYM)
def test_k19_plain_matches_jax(sArg):
    jk = jker.getFractionalKernel(1, jParse(sArg))
    tk = tker.getFractionalKernel(1, tParse(sArg))
    dm = jfem.P1_DoFMap(jfem.simpleInterval(-1.0, 1.0).refine())
    for rule, nS, nv2 in ((jqs.distantRule(6, 1), 0, 2),
                          (jqs.vertexRule1D(-1.5, 8, 4), 1, 2),
                          (jqs.vertexRule1D(-2.5, 8, 4, cancellation=1.0), 1,
                           2)):
        V, vi1, vi2, vs = _randomPairs(150, nv2, 5 + nS)
        PSI = rule.buildPSI(dm, nSharedVertices=nS)
        PHIx, PHIy = rule.buildPHI(dm, nSharedVertices=nS)
        PX, PY = tasm._phiPsi(PHIx, PSI), tasm._phiPsi(PHIy, PSI)
        ref = np.asarray(jasm._bucket_contrib_nonsym(
            jnp.asarray(V), jnp.asarray(vi1), jnp.asarray(vi2),
            jnp.asarray(vs), jnp.asarray(rule.bary_x),
            jnp.asarray(rule.bary_y), jnp.asarray(rule.w), jnp.asarray(PX),
            jnp.asarray(PY), kernel=jk))
        P, n = ref.shape
        data = torch.zeros(P * n + 1, dtype=torch.float64)
        tasm.panel_scatter_nonsym_slots(
            data, _t(V), _t(vi1, torch.int64), _t(vi2, torch.int64),
            _t(np.arange(P * n).reshape(P, n), torch.int32), _t(vs),
            _t(rule.bary_x), _t(rule.bary_y), _t(rule.w), _t(PX), _t(PY),
            tk.profileParams(), tk.orderParams())
        assert _rel(data[:-1].numpy().reshape(P, n), ref) <= 1e-13
        # the dense target adds the same matrices
        nP = PSI.shape[0]
        dr = np.random.default_rng(1).integers(-1, 40, (P, nP))
        A = torch.zeros((40, 40), dtype=torch.float64)
        tasm.panel_scatter_nonsym(
            A, _t(V), _t(vi1, torch.int64), _t(vi2, torch.int64),
            _t(dr, torch.int64), _t(vs), _t(rule.bary_x), _t(rule.bary_y),
            _t(rule.w), _t(PX), _t(PY), tk.profileParams(), tk.orderParams())
        Aref = np.zeros((41, 41))
        rows = np.where(dr >= 0, dr, 40)
        np.add.at(Aref, (np.repeat(rows, nP, axis=1).reshape(-1),
                         np.tile(rows, (1, nP)).reshape(-1)), ref.reshape(-1))
        assert _rel(A.numpy(), Aref[:40, :40]) <= 1e-13


def test_k7_plain_matches_jax():
    jk = jker.getFractionalKernel(1, jParse(LR))
    tk = tker.getFractionalKernel(1, tParse(LR))
    rng = np.random.default_rng(2)
    gi = rng.uniform(-1, 1, (30, 5, 1))
    gj = rng.uniform(-1, 1, (30, 5, 1)) + 2.5 * np.sign(rng.normal(size=(
        30, 1, 1)))
    ref = np.asarray(jasm._farFieldBlocks(jnp.asarray(gi), jnp.asarray(gj),
                                          kernel=jk))
    got = tasm.far_field(_t(gi), _t(gj), tk.profileParams(),
                         tk.orderParams()).numpy()
    assert _rel(got, ref) <= 1e-12


# -------------------------------------------------------- host copies ----

def test_host_copies_match_jax():
    m = _interval(6)
    dm, jk, tdm, tk = _pair(LR, m)
    jb, tb = jasm.nonlocalBuilder(dm, jk), tasm.nonlocalBuilder(tdm, tk)
    # order jumps
    jj, tj = jb._getKernelJumps(), tb._getKernelJumps()
    assert len(jj) == len(tj) == 1
    for a, b in zip(jj, tj):
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    # leaves split at the jump
    jn = jh2.splitLeavesByKernelBlocks(jh2.buildClusterTree(dm, 4), dm, jk)
    tn = th2.splitLeavesByKernelBlocks(th2.buildClusterTree(tdm, 4), tdm,
                                       tk)
    assert len(jn) == len(tn) > 2 * dm.num_dofs // 4
    for a, b in zip(jn, tn):
        assert (a.id, a.level, a.parent, list(a.children), a.mixed) == \
            (b.id, b.level, b.parent, list(b.children), b.mixed)
        np.testing.assert_array_equal(a.dofs, b.dofs)
        np.testing.assert_array_equal(a.box, b.box)
    assert any(nd.mixed for nd in tn)
    # pair singularities and the touching buckets
    ji, ti = jClassify(dm, jk), tClassify(tdm, tk)
    pairs, sharedInfo = ji['touching']
    np.testing.assert_array_equal(ti['touching'][0], pairs)
    for pi, pj in ((pairs[:, 0], pairs[:, 1]), (pairs[:, 1], pairs[:, 0]),
                   (ji['id'], ji['id'])):
        np.testing.assert_array_equal(tb._pairSingularities(pi, pj),
                                      jb._pairSingularities(pi, pj))
    # the JAX grouping (nl/assembly.py:2176-2187)
    s12 = jb._pairSingularities(pairs[:, 0], pairs[:, 1])
    s21 = jb._pairSingularities(pairs[:, 1], pairs[:, 0])
    ref = {}
    for k in range(len(pairs)):
        ref.setdefault((sharedInfo[k][0], round(float(s12[k]), 12),
                        round(float(s21[k]), 12)), []).append(k)
    got = tb._touchingGroups(*ti['touching'])
    assert list(got) == list(ref) and len(ref) >= 3
    assert all(got[k] == ref[k] for k in ref)


# ------------------------------------------------------------- dense ----

@pytest.mark.parametrize('sArg', NONSYM)
def test_dense_matches_jax(sArg):
    dm, jk, tdm, tk = _pair(sArg, _interval(5))
    ref = np.asarray(jasm.nonlocalBuilder(dm, jk).getDense().data)
    got = tasm.nonlocalBuilder(tdm, tk).getDense().data.numpy()
    if sArg == LR:
        assert np.abs(ref - ref.T).max() > 1e-3 * np.abs(ref).max()
    assert _rel(got, ref) <= 1e-12


# ---------------------------------------------------------------- H2 ----

def _portH2FromJax(H):
    A, mt = H.Anear, H.Anear.meta

    def arr(v):
        return None if v is None else np.asarray(v)
    levels = [dict(size=lv.size, T=arr(lv.T), parentIdx=arr(lv.parentIdx),
                   K=arr(lv.K), src=arr(lv.src), dst=arr(lv.dst))
              for lv in H.levels]
    return h2FromArrays(np.asarray(A.dataZ[:-1]), mt.indptrT, mt.tmplAll,
                        mt.tmplStart, mt.tStartRow, mt.tLen, mt.rowLen,
                        mt.perm, mt.N, np.asarray(H.leafDofs),
                        np.asarray(H.leafPhi), *H.leafLevelPos, levels,
                        device='cpu', symmetric=H.symmetric)


@pytest.fixture(scope='module', params=NONSYM, ids=['constantNonSym',
                                                     'twoDomainNonSym'])
def h2builds(request):
    """The JAX package's CPU H2 build (CSRAccumulator) at noRef 6 with its
    union-surface items recorded, and the port's."""
    dm, jk, tdm, tk = _pair(request.param, _interval(6))
    rec = {}
    jsurf, tsurf = jasm.nonlocalBuilder._runUnionSurface, \
        tasm.nonlocalBuilder._runUnionSurface

    def jrec(self, acc, surfPairs, *a):
        rec['jax'] = tuple(np.array(x) for x in surfPairs)
        return jsurf(self, acc, surfPairs, *a)

    def trec(self, acc, surf, *a):
        rec['port'] = surf
        return tsurf(self, acc, surf, *a)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jasm.nonlocalBuilder, '_runUnionSurface', jrec)
        mp.setattr(tasm.nonlocalBuilder, '_runUnionSurface', trec)
        H = jasm.nonlocalBuilder(dm, jk).getH2()
        Ht = tasm.nonlocalBuilder(tdm, tk).getH2()
    return dict(H=H, Ht=Ht, rec=rec, tdm=tdm, tk=tk, sArg=request.param)


def test_h2_near_data_and_surfaces_match_jax(h2builds):
    H, Ht = h2builds['H'], h2builds['Ht']
    assert H.fusedTree and not H.symmetric and not Ht.symmetric
    mt = H.Anear.meta
    for name in ('indptrT', 'tmplAll', 'perm', 'tLen'):
        np.testing.assert_array_equal(getattr(Ht.Anear.meta, name),
                                      getattr(mt, name))
    ref = np.asarray(H.Anear.dataZ[:-1])
    assert np.abs(Ht.Anear.dataT.numpy() - ref).max() \
        <= 1e-10 * np.abs(ref).max()
    got, exp = h2builds['rec']['port'], h2builds['rec']['jax']
    assert len(got) == len(exp) == 6
    for a, b in zip(got, exp):
        np.testing.assert_array_equal(a, b)
    if h2builds['sArg'] == LR:
        assert (exp[5] == -1.0).any()


def test_h2_apply_and_transpose_match_jax(h2builds):
    H, Ht = h2builds['H'], h2builds['Ht']
    x = np.random.default_rng(4).normal(size=H.num_rows)
    for fwd in (True, False):
        ref = np.asarray(H.matvec(jnp.asarray(x)) if fwd else
                         H.T.matvec(jnp.asarray(x)))
        got = (Ht if fwd else Ht.T).matvec(_t(x)).numpy()
        assert np.linalg.norm(got - ref) <= 1e-10 * np.linalg.norm(ref)
    assert Ht.T.T is Ht and Ht.T is Ht.T
    # the far list holds both orderings of every far pair, so the forward
    # apply needs no transposed blocks
    pairs = set(zip(Ht.src.tolist(), Ht.dst.tolist()))
    assert pairs and all((j, i) in pairs for i, j in pairs)


def test_k20_plain_matches_jax(h2builds):
    H = h2builds['H']
    Hp = _portH2FromJax(H)
    x = np.random.default_rng(6).normal(size=H.num_rows)
    ref = np.asarray(jh2._h2_matvec_T(H, jnp.asarray(x)))
    got = th2.h2_matvec_T(Hp, _t(x)).numpy()
    assert np.linalg.norm(got - ref) <= 1e-12 * np.linalg.norm(ref)
    # and the forward apply of the same arrays
    ref = np.asarray(jh2._h2_matvec(H, jnp.asarray(x)))
    got = th2.h2_matvec(Hp, _t(x)).numpy()
    assert np.linalg.norm(got - ref) <= 1e-12 * np.linalg.norm(ref)


def test_h2_and_transpose_against_dense(h2builds):
    Ht, tdm, tk = h2builds['Ht'], h2builds['tdm'], h2builds['tk']
    D = tasm.nonlocalBuilder(tdm, tk).getDense().data
    x = torch.sin(torch.linspace(-1.0, 1.0, tdm.num_dofs,
                                 dtype=torch.float64))
    eFwd = float(torch.linalg.norm(Ht.matvec(x) - D @ x))
    eT = float(torch.linalg.norm(Ht.T.matvec(x) - D.T @ x))
    # tests/test_h2_transpose.py:33
    assert eT < max(1e-5, 3.0 * eFwd), (eFwd, eT)
    assert eFwd < 1e-5 * float(torch.linalg.norm(D @ x))


# ----------------------------------------------------------- drivers ----

def _argv(s, problem, solver, fmt):
    return ['--domain', 'interval', '--s', s, '--problem', problem,
            '--element', 'P1', '--solverType', solver, '--matrixFormat', fmt]


# (argv, pins of tests/test_drivers_fractional.py:121-167, the JAX
# driver's errors and iterations from a CPU run of drivers/runFractional.py)
DRIVER_LINES = [
    (_argv('varconst(0.75)', 'constant', 'cg-jacobi', 'dense'),
     {'Hs error': 0.041842962898268554, 'L2 error': 0.0014584869817160686,
      'Linf error interpolated': 0.0009870492444583046},
     {'L2 error': 0.0014584876514333886,
      'L2 error interpolated': 0.0010892434381019561,
      'Linf error interpolated': 0.0009870496485860358,
      'Hs error': 0.04184297753455954}, 41),
    (_argv('constantNonSym(0.25)', 'constant', 'gmres-jacobi', 'dense'),
     {'Hs error': 0.09611243700814974, 'L2 error': 0.0266553185536795,
      'Linf error interpolated': 0.04664216828925677},
     {'L2 error': 0.026655322723040574,
      'L2 error interpolated': 0.008022626666842203,
      'Linf error interpolated': 0.04664203600833766,
      'Hs error': 0.09611246910485544}, 9),
    (_argv(LR, 'knownSolution', 'lu', 'dense'),
     {'L2 error': 0.0020560901451394443,
      'Linf error interpolated': 0.003599161364716205},
     {'L2 error': 0.0020165419394079244,
      'L2 error interpolated': 0.0012040812422250483,
      'Linf error interpolated': 0.0036074442982775012}, 1),
    (_argv('constantNonSym(0.25)', 'constant', 'gmres-jacobi', 'H2'),
     {'L2 error': 0.02665532198267176},
     {'L2 error': 0.026655317676124377,
      'L2 error interpolated': 0.008022571820942168,
      'Linf error interpolated': 0.046641894707784626,
      'Hs error': 0.09611199629077337}, 9),
    (_argv(LR, 'knownSolution', 'lu', 'H2'),
     {'L2 error': 0.001968154983051443},
     {'L2 error': 0.0020155700017095396,
      'L2 error interpolated': 0.001202654921585978,
      'Linf error interpolated': 0.0036095994277783594}, 1),
    (_argv(LR, 'knownSolution', 'gmres-mg', 'H2'),
     {'L2 error': 0.001968148149500615},
     {'L2 error': 0.002015603941010537,
      'L2 error interpolated': 0.0012026945043101618,
      'Linf error interpolated': 0.0036093081028042984}, 5),
]
DRIVER_IDS = ['varconst', 'constantNonSym', 'twoDomainNonSym',
              'constantNonSym-H2', 'twoDomainNonSym-H2-lu',
              'twoDomainNonSym-H2-mg']
# errors against the JAX driver: the operators agree to 1e-12, the error
# formulas cancel a few digits
RTOL_JAX = 1e-6


@pytest.mark.parametrize('argv,pins,jaxOut,its', DRIVER_LINES,
                         ids=DRIVER_IDS)
def test_runFractional_variable_orders(argv, pins, jaxOut, its):
    from pynucleus_tpu_torch.drivers.runFractional import main as tMain
    out = tMain(argv + ['--device', 'cpu'], quiet=True)
    got = out['errors'].toDict()
    # the JAX driver reports Hs errors only with an exact Hs norm
    assert ('Hs error' in got) == ('Hs error' in jaxOut)
    for label, val in pins.items():
        assert np.isclose(got[label], val, rtol=3e-2, atol=1e-8), \
            (label, got[label], val)
    for label, val in jaxOut.items():
        assert np.isclose(got[label], val, rtol=RTOL_JAX, atol=0), \
            (label, got[label], val)
    res = out['results'].toDict()
    assert res['dofs'] == 127
    assert abs(res['iterations'] - its) <= 1
    if 'mg' in argv:
        assert len(out['hierarchy']) == 7
        assert all(type(lv['A']).__name__ == 'H2Matrix' and
                   not lv['A'].symmetric for lv in out['hierarchy'])


# twoDomainNonSym knownSolution lu at noRef 10 (2,047 dofs): the L2 error
# of the H2 line, the JAX driver's on the CPU (ROADMAP.md section C: the H2
# operator of a variable order loses accuracy with refinement, in both
# packages), and the dense line's, the port's on the CPU
NOREF10_H2_L2 = 0.002585306367322747
NOREF10_DENSE_L2 = 0.00011265870936805422


def test_h2_lu_error_at_noRef10_matches_jax():
    """The H2 line's error at depth is the JAX package's, and both lie far
    above the dense line's: the fault of section C is mirrored, not the
    port's own."""
    from drivers.runFractional import main as jMain
    from pynucleus_tpu_torch.drivers.runFractional import main as tMain
    argv = _argv(LR, 'knownSolution', 'lu', 'H2') + ['--noRef', '10']
    d, _ = jMain(argv)
    jax = d.outputGroups['errors'].toDict()['L2 error']
    port = tMain(argv + ['--device', 'cpu'],
                 quiet=True)['errors'].toDict()['L2 error']
    dense = tMain(_argv(LR, 'knownSolution', 'lu', 'dense')
                  + ['--noRef', '10', '--device', 'cpu'],
                  quiet=True)['errors'].toDict()['L2 error']
    assert np.isclose(jax, NOREF10_H2_L2, rtol=1e-6, atol=0), jax
    assert np.isclose(port, jax, rtol=1e-6, atol=0), (port, jax)
    assert np.isclose(dense, NOREF10_DENSE_L2, rtol=1e-6, atol=0), dense
    assert min(port, jax) > 10.0 * dense, (port, jax, dense)


@pytest.mark.cuda
def test_variable_order_kernels_match_plain_on_gpu():
    """K1 (with an order and a y shift), K7, K19 and K20 on the card
    against their plain versions on a twoDomainNonSym H2 build at noRef 6
    (needs an NVIDIA GPU)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    m = _interval(6)
    _, gdm, gk = fromArrays(m.vertices, m.cells, LR, 1, device='cuda')
    _, cdm, ck = fromArrays(m.vertices, m.cells, LR, 1, device='cpu')
    Hg = tasm.nonlocalBuilder(gdm, gk).getH2()
    Hc = tasm.nonlocalBuilder(cdm, ck).getH2()
    ref = Hc.Anear.dataT.numpy()
    assert np.abs(Hg.Anear.dataT.cpu().numpy() - ref).max() \
        <= 1e-12 * np.abs(ref).max()
    x = torch.sin(torch.arange(gdm.num_dofs, dtype=torch.float64))
    for fwd in (True, False):
        yg = (Hg if fwd else Hg.T).matvec(x.cuda()).cpu()
        yc = (Hc if fwd else Hc.T).matvec(x)
        assert float(torch.linalg.norm(yg - yc)) <= 1e-12 * float(
            torch.linalg.norm(yc))

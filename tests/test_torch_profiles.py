"""The port's remaining radial profiles against the JAX package: the
tempered fractional kernel, the finite-horizon gaussian and exponential
kernels, and the log-inverse-distance, monomial and polynomial profiles.

Same inputs in both packages (the JAX package's meshes handed over as
arrays, numpy seeds); on the CPU the port's kernel wrappers run their
plain versions:

  profiles       radialEval of each kernel's Profile (and Kernel.eval,
                 Kernel.__call__) against the JAX _radial_eval, jaxEval and
                 __call__ on seeded node pairs: 1e-15 relative (the
                 s-derivative's closed form against the JAX jvp: 1e-13)
  scalings       constantFractionalLaplacianScaling with its tempered
                 branch, constantIntegrableScaling of a finite horizon and of
                 the new types: equal
  K14, K15       the cut pairs' local matrices with the gaussian, the
                 exponential and the tempered power profiles against
                 _bucket_cut1d and _bucket_cut2d_polar: 1e-13 of max|M|
  getDense       the three new profiles (dense; infinite horizon on the
                 grid and per pair, the polynomial one of a finite horizon
                 with its cut pairs) against the JAX package: 1e-12
  getSparse      the tempered fractional kernel of a finite horizon (K14 with
                 the tempered power): the JAX pattern, data to 1e-12
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pynucleus_tpu.fem import meshFactory, dofmapFactory
from pynucleus_tpu.fem.quadrature import gauss01 as jGauss01, \
    simplexDuffy as jDuffy
from pynucleus_tpu.nl.assembly import (nonlocalBuilder as jBuilder,
                                       _radial_eval, _bucket_cut1d,
                                       _bucket_cut2d_polar)
from pynucleus_tpu.nl import kernels as jk
from pynucleus_tpu.nl.panels import classifyPairsDense as jClassify
from pynucleus_tpu.nl.problems import nonlocalMeshFactory, DIRICHLET

from pynucleus_tpu_torch.interop import fromArrays
from pynucleus_tpu_torch.fem.quadrature import gauss01, simplexDuffy
from pynucleus_tpu_torch.nl import kernels as tk
from pynucleus_tpu_torch.nl.assembly import (nonlocalBuilder,
                                             assembleNonlocal,
                                             _cut1dMatrices, _cut2dMatrices)

PER_PAIR = {'denseGrid': False}
HORIZON = 0.2


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def t(a, dtype=torch.float64):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def kernelPair(name, dim):
    """(port kernel, JAX kernel) of the same numbers."""
    if name == 'tempered':
        return (tk.FractionalKernel(dim, 0.4, temperedLambda=2.0),
                jk.FractionalKernel(dim, jk.constFractionalOrder(0.4),
                                    temperedLambda=2.0))
    if name == 'tempered-finite':
        return (tk.FractionalKernel(dim, 0.4, HORIZON, tk.ball2(),
                                    temperedLambda=3.0),
                jk.FractionalKernel(dim, jk.constFractionalOrder(0.4),
                                    HORIZON, jk.ball2(), temperedLambda=3.0))
    if name == 'tempered-boundary':
        a, b = kernelPair('tempered', dim)
        return a.getBoundaryKernel(), b.getBoundaryKernel()
    if name == 'tempered-phi':
        return (tk.getFractionalKernel(dim, 0.6,
                                       phi=tk.temperedTwoPoint(1.5)),
                jk.getFractionalKernel(dim, 0.6,
                                       phi=jk.temperedTwoPoint(1.5)))
    if name == 'derivative-tempered':
        return (tk.DerivativeFractionalKernel(dim, 0.4, derivative=2,
                                              temperedLambda=1.5),
                jk.DerivativeFractionalKernel(dim,
                                              jk.constFractionalOrder(0.4),
                                              derivative=2,
                                              temperedLambda=1.5))
    if name in ('gaussian', 'exponential'):
        return (tk.getIntegrableKernel(dim, name, HORIZON),
                jk.getIntegrableKernel(dim, name, HORIZON))
    if name == 'logInverseDistance':
        return (tk.getIntegrableKernel(dim, name, np.inf),
                jk.getIntegrableKernel(dim, name, np.inf))
    if name == 'monomial':
        return (tk.Kernel(dim, 'monomial', np.inf, None, 0.5, 1.0,
                          monomialPower=1.0),
                jk.Kernel(dim, 'monomial', np.inf, None, 0.5, 1.0,
                          monomialPower=1.0))
    assert name == 'polynomial'
    return (tk.Kernel(dim, 'polynomial', 0.3, tk.ball2(), 0.5, 0.0,
                      exponentParam=0.3),
            jk.Kernel(dim, 'polynomial', 0.3, jk.ball2(), 0.5, 0.0,
                      exponentParam=0.3))


PROFILE_CASES = [(n, d) for n in (
    'tempered', 'tempered-finite', 'tempered-boundary', 'tempered-phi',
    'derivative-tempered', 'gaussian', 'logInverseDistance', 'monomial',
    'polynomial') for d in (1, 2)] + [('exponential', 1)]


@pytest.mark.parametrize('name,dim', PROFILE_CASES)
def test_profiles_match_jax(name, dim):
    a, b = kernelPair(name, dim)
    assert a.scalingValue == b.scalingValue
    assert a.singularityValue == b.singularityValue
    rng = np.random.default_rng(21)
    x = rng.uniform(-0.5, 0.5, (400, dim))
    y = rng.uniform(-0.5, 0.5, (400, dim))
    y[:4] = x[:4]                      # coincident nodes: 0 in both
    r2 = ((x - y) ** 2).sum(-1)
    jr2 = jnp.sum((jnp.asarray(x) - jnp.asarray(y)) ** 2, axis=-1)
    ref = np.asarray(_radial_eval(b, jr2, jnp.asarray(x), jnp.asarray(y)))
    prof = a.profileParams()
    got = tk.radialEval(t(r2), prof).numpy()
    tol = 1e-13 if name.startswith('derivative') else 1e-15
    assert np.array_equal(got == 0, ref == 0)
    assert rel(got, ref) <= tol
    # jaxEval has no guard at coincident nodes (inf there): the others
    got = a.eval(t(x[4:]), t(y[4:])).numpy()
    ref = np.asarray(b.jaxEval(jnp.asarray(x[4:]), jnp.asarray(y[4:])))
    assert rel(got, ref) <= tol
    for p in range(4, 24):
        assert a(x[p], y[p]) == pytest.approx(b(x[p], y[p]), rel=tol,
                                              abs=1e-300)


def test_scalings_match_jax():
    for dim in (1, 2):
        for s in (0.25, 0.4, 0.5, 0.75):
            for lam in (0.0, 1.0):
                for h in (np.inf, 0.3):
                    assert tk.constantFractionalLaplacianScaling(
                        dim, s, h, lam) == \
                        jk.constantFractionalLaplacianScaling(dim, s, h, lam)
    for kind, dim, inter in (('gaussian', 1, 'ball2'),
                             ('gaussian', 2, 'ball2'),
                             ('exponential', 1, 'ball2'),
                             ('polynomial', 2, 'ball2'),
                             ('logInverseDistance', 1, 'fullSpace')):
        for h in (0.2, 0.45):
            args = dict(gaussian_variance=0.3, exponentialRate=4.0)
            assert tk.constantIntegrableScaling(
                kind, tk.interactionFactory[inter](), dim, h, **args) == \
                jk.constantIntegrableScaling(
                    kind, jk.interactionFactory(inter), dim, h, **args)
    with pytest.raises(NotImplementedError):
        tk.constantIntegrableScaling('exponential', tk.ball2(), 2, 0.2)


def test_profile_arguments_are_checked():
    with pytest.raises(ValueError, match='tempered'):
        tk.profileArgs(tk.Profile(tk.GAUSSIAN_PROFILE, 1.0, 0.0, 1.0, t=1.0))
    with pytest.raises(ValueError, match='two-point code'):
        tk.profileArgs(tk.Profile(tk.POWER, 1.0, -1.0, 0.0, wcode=2))
    assert tk.profileArgs(tk.Profile(tk.POWER_LOG, 1.0, -1.0, 0.0, 0.5, 0.1,
                                     2.0, 1, 3.0))[6:] == (2.0, 1, 3.0)
    # a tempered variable order: the JAX package drops its tempering
    with pytest.raises(NotImplementedError, match='tempered'):
        tk.FractionalKernel(1, tk.constantNonSymFractionalOrder(0.3),
                            temperedLambda=1.0)


# ------------------------------------------------------------- K14, K15

def jaxCollar(domain, noRef, k):
    mesh, info = nonlocalMeshFactory.build(
        domain, kernel=k, boundaryCondition=DIRICHLET,
        **({'a': -1, 'b': 1} if domain == 'interval' else {}))
    for _ in range(noRef):
        mesh = mesh.refine()
    dm = dofmapFactory('P1', mesh, tag=info['domain'])
    return mesh, dm


@pytest.mark.parametrize('name', ['gaussian', 'exponential',
                                  'tempered-finite', 'polynomial'])
def test_cut1d_profiles_match_jax(name):
    """K14's plain version with the profile against _bucket_cut1d on every
    cut pair of the interval at noRef 3 (both orderings)."""
    a, b = kernelPair(name, 1)
    mesh, dm = jaxCollar('interval', 3, b)
    ci, cj, orders = jClassify(dm, b)['cut']
    vols = mesh.simplexVolumes()
    assert len(ci)
    for order in np.unique(orders):
        sel = orders == order
        iiA = np.concatenate([ci[sel], cj[sel]])
        jjA = np.concatenate([cj[sel], ci[sel]])
        tq, wq = jGauss01(int(order))
        Mj = np.asarray(_bucket_cut1d(
            mesh.vertices, mesh.cells[iiA], mesh.cells[jjA], vols[iiA], tq,
            wq, tq, wq, dm.evalPhi.monomialExps, dm.evalPhi.Vinv,
            b.horizonValue, kernel=b, dpe=2))
        tq2, wq2 = gauss01(int(order))
        Mt = _cut1dMatrices(t(mesh.vertices), t(mesh.cells[iiA], torch.int64),
                            t(mesh.cells[jjA], torch.int64), t(vols[iiA]),
                            t(tq2), t(wq2), t(tq2), t(wq2), a.horizonValue,
                            a.profileParams()).numpy()
        assert rel(Mt, Mj) <= 1e-13


@pytest.mark.parametrize('name', ['gaussian', 'tempered-finite'])
def test_cut2d_polar_profiles_match_jax(name):
    """K15's plain version with the profile against _bucket_cut2d_polar on
    the square's noRef 0 cut pairs."""
    a, b = kernelPair(name, 2)
    mesh, dm = jaxCollar('square', 0, b)
    ci, cj, orders = jClassify(dm, b)['cut']
    vols = mesh.simplexVolumes()
    for order in np.unique(orders):
        sel = orders == order
        ii, jj = ci[sel], cj[sel]
        oX = max(int(order) // 2, 4)
        (bx, wx), (th, wth), (rq, wr) = (
            jDuffy(oX, 2), jGauss01(max(int(order) // 2 + 2, 6)),
            jGauss01(max(int(order) // 2, 4)))
        Mj = np.asarray(_bucket_cut2d_polar(
            mesh.vertices, mesh.cells[ii], mesh.cells[jj], vols[ii],
            bx.T.copy(), wx, th, wth, rq, wr, dm.evalPhi.monomialExps,
            dm.evalPhi.Vinv, b.horizonValue, kernel=b, dpe=3))
        tbx, twx = simplexDuffy(oX, 2)
        Mt = _cut2dMatrices(t(mesh.vertices), t(mesh.cells[ii], torch.int64),
                            t(mesh.cells[jj], torch.int64), t(vols[ii]),
                            t(tbx.T), t(twx), t(th), t(wth), t(rq), t(wr),
                            a.horizonValue, a.interaction.code,
                            a.profileParams()).numpy()
        # (a bucket of pairs that the rays miss is 0 in both packages)
        assert np.abs(Mt - Mj).max() <= 1e-13 * np.abs(Mj).max(), order


# ------------------------------------------------------ getDense, sparse

def _interval(noRef):
    mesh = meshFactory('interval', a=-1, b=1)
    for _ in range(noRef):
        mesh = mesh.refine()
    return mesh, dofmapFactory('P1', mesh)


def _square(noRef):
    mesh = meshFactory('square', N=2, ax=0, ay=0, bx=1, by=1)
    for _ in range(noRef):
        mesh = mesh.refine()
    return mesh, dofmapFactory('P1', mesh)


NEW_PROFILES = {'logInverseDistance': {}, 'monomial': {'monomialPower': 1.0},
                'polynomial': {'polynomialRadius': 0.3, 'horizon': 0.3}}


@pytest.mark.parametrize('name', sorted(NEW_PROFILES))
@pytest.mark.parametrize('domain', ['interval', 'square'])
def test_new_profiles_getDense_matches_jax(name, domain):
    """getDense of both packages (no zero-exterior term: these types have
    no boundary kernel), per pair and, for an infinite horizon, on the
    grid (the port's default)."""
    mesh, dm = _interval(4) if domain == 'interval' else _square(2)
    dim = mesh.dim
    a, b = kernelPair(name, dim)
    kw = dict(NEW_PROFILES[name])
    _, tdm, tkern = fromArrays(np.asarray(mesh.vertices),
                               np.asarray(mesh.cells), 0.5, dim,
                               device='cpu', kernelType=name,
                               scaling=a.scalingValue, **kw)
    assert tkern.profileParams() == a.profileParams()
    Aj = np.asarray(jBuilder(dm, b, zeroExterior=False,
                             params=PER_PAIR).getDense().toarray())
    At = nonlocalBuilder(tdm, tkern, zeroExterior=False,
                         params=PER_PAIR).getDense().toarray()
    assert rel(At, Aj) <= 1e-12
    if not tkern.finiteHorizon:
        Ajg = np.asarray(jBuilder(dm, b, zeroExterior=False,
                                  params={'denseGrid': True}).getDense()
                         .toarray())
        Atg = nonlocalBuilder(tdm, tkern, zeroExterior=False).getDense() \
            .toarray()
        assert rel(Atg, Ajg) <= 1e-12


def test_tempered_finite_horizon_sparse_matches_jax():
    """The tempered fractional kernel of a finite horizon (its cut pairs
    through K14 with the tempered power profile) in the sparse format."""
    a, b = kernelPair('tempered-finite', 1)
    mesh, dm = jaxCollar('interval', 4, b)
    interior = np.zeros(mesh.num_vertices, dtype=bool)
    c, loc = np.nonzero(np.asarray(dm.dofs) >= 0)
    interior[np.asarray(mesh.cells)[c, loc]] = True
    _, tdm, tkern = fromArrays(mesh.vertices, mesh.cells, 0.4, 1,
                               device='cpu', horizon=HORIZON,
                               temperedLambda=3.0, interior=interior)
    assert tkern.profileParams() == a.profileParams()
    Sj = jBuilder(dm, b).getSparse()
    St = assembleNonlocal(tdm, tkern, matrixFormat='sparse', device='cpu')
    np.testing.assert_array_equal(St.indptrH, np.asarray(Sj.indptr))
    np.testing.assert_array_equal(St.indicesH, np.asarray(Sj.indices))
    assert rel(St.dataH, np.asarray(Sj.data)) <= 1e-12

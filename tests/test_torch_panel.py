"""Kernel K1 (panel_scatter): its plain version against the JAX programs it
replaces, on the same seeded inputs.

  _bucket_contrib + _device_scatter_rows   touching panels (with normals:
                                           boundary touching panels)
  _bucket_natural_scatter_scan             identical-cell and distant
                                           correction buckets (cell ids)
  _bucket_rows_scatter_scan                boundary correction buckets

Tolerance 1e-13 relative to max|A|: the same float64 quadrature summed in
another order.  On the card the kernel itself is held to the plain
version by chip_smoke.py and by the ``cuda``-marked test below.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.nl import getFractionalKernel as jKernel
from pynucleus_tpu.nl import assembly as jasm
from pynucleus_tpu.nl.panels import classifyPairsDenseGrid, \
    classifyBoundaryPairs
from pynucleus_tpu.nl.quad_singular import distantRule, boundaryDistantRule
from pynucleus_tpu.nl.quad_singular_2d import (edgeRule2DSS, vertexRule2DSS,
                                               sameCellRule2DSS,
                                               boundaryEdgeRule2DSS)

from pynucleus_tpu_torch.nl import assembly as tasm
from pynucleus_tpu_torch.nl.kernels import getFractionalKernel as tKernel
from pynucleus_tpu_torch.nl.kernels import Profile

TOL = 1e-13


@pytest.fixture(scope='module')
def disc():
    m = jfem.circle(h=0.78, radius=1.0)
    for _ in range(2):
        m = m.refine()
    dm = jfem.P1_DoFMap(m)
    return m, dm, jKernel(2, 0.75), tKernel(2, 0.75)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def _port(N, vertices, vi1, vi2, dr, vs, nm, rule, PSI, kernel):
    A = torch.zeros((N, N), dtype=torch.float64)
    prof = kernel.profileParams()
    tasm.panel_scatter(A, _t(vertices), _t(vi1, torch.int64),
                       _t(vi2, torch.int64), _t(dr, torch.int64), _t(vs),
                       None if nm is None else _t(nm), _t(rule.bary_x),
                       _t(rule.bary_y), _t(rule.w), _t(jasm._psi_prod(PSI)),
                       prof)
    return A.numpy()


def _assertClose(At, Aj):
    scale = np.abs(Aj).max()
    assert scale > 0
    assert np.abs(At - Aj).max() <= TOL * scale


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
def test_touching_vs_bucket_contrib(disc, nS):
    m, dm, kj, kt = disc
    vi1, vi2, dr, vs, rule, PSI = _touching(m, dm, nS)
    N = dm.num_dofs
    M = jasm._bucket_contrib(jnp.asarray(m.vertices), jnp.asarray(vi1),
                             jnp.asarray(vi2), jnp.asarray(vs),
                             jnp.asarray(rule.bary_x),
                             jnp.asarray(rule.bary_y), jnp.asarray(rule.w),
                             jnp.asarray(jasm._psi_prod(PSI)), kernel=kj)
    Aj = jasm._device_scatter_rows(jnp.zeros((N + 1, N + 1)),
                                   jnp.asarray(dr), M, None, nPSI=6)
    At = _port(N, m.vertices, vi1, vi2, dr, vs, None, rule, PSI, kt)
    _assertClose(At, np.asarray(Aj)[:N, :N])


def test_boundary_touching_vs_bucket_contrib_normals(disc):
    m, dm, kj, kt = disc
    bj = kj.getModifiedKernel(horizon=np.inf).getBoundaryKernel()
    surface = m.get_surface_mesh()
    binfo = classifyBoundaryPairs(dm, surface, bj, correctionsOnly=True)
    tp, perms = binfo['touching']
    sel = [k for k in range(len(tp)) if perms[k][0] == 2]
    vi1 = np.array([m.cells[tp[k, 0]][perms[k][1]] for k in sel])
    vi2 = np.array([surface.cells[tp[k, 1]][perms[k][2]] for k in sel])
    dr = np.array([dm.dofs[tp[k, 0]][perms[k][1]] for k in sel])
    nm = surface.normals[tp[sel, 1]]
    vs = np.random.RandomState(5).uniform(0.5, 2.0, len(sel)) * 1e-2
    rule = boundaryEdgeRule2DSS(2.0 + bj.singularityValue, 12, 12)
    PSI = rule.buildPSI(dm, boundary=True)
    N = dm.num_dofs
    M = jasm._bucket_contrib(jnp.asarray(m.vertices), jnp.asarray(vi1),
                             jnp.asarray(vi2), jnp.asarray(vs),
                             jnp.asarray(rule.bary_x),
                             jnp.asarray(rule.bary_y), jnp.asarray(rule.w),
                             jnp.asarray(jasm._psi_prod(PSI)),
                             normals=jnp.asarray(nm), kernel=bj,
                             useNormals=True)
    Aj = jasm._device_scatter_rows(jnp.zeros((N + 1, N + 1)),
                                   jnp.asarray(dr), M, None, nPSI=3)
    At = _port(N, m.vertices, vi1, vi2, dr, vs, nm, rule, PSI,
               kt.getBoundaryKernel())
    _assertClose(At, np.asarray(Aj)[:N, :N])


@pytest.mark.parametrize('bucket', ['id', 'distant6', 'distant10'])
def test_natural_vs_natural_scatter_scan(disc, bucket):
    m, dm, kj, kt = disc
    C = m.num_cells
    rng = np.random.RandomState(7)
    if bucket == 'id':
        di = dj = np.arange(C)
        rule = sameCellRule2DSS(-3.5, 2, 9)
        PSI = rule.buildPSI(dm, nSharedVertices=3)
        symfac = 4.0
    else:
        order = int(bucket[len('distant'):])
        info = classifyPairsDenseGrid(dm, kj)
        di, dj, _ = info['distant']
        pick = rng.choice(len(di), size=min(300, len(di)), replace=False)
        di, dj = di[pick], dj[pick]
        rule = distantRule(order, 2)
        PSI = rule.buildPSI(dm, nSharedVertices=0)
        symfac = 2.0
    P, nPSI = len(di), PSI.shape[0]
    vols = m.simplexVolumes()
    N = dm.num_dofs
    chunk = 64
    nCh = -(-P // chunk)
    pad = nCh * chunk - P
    dip = np.concatenate([di, np.zeros(pad, np.int64)]).reshape(nCh, chunk)
    djp = np.concatenate([dj, np.zeros(pad, np.int64)]).reshape(nCh, chunk)
    sf = np.concatenate([np.full(P, symfac), np.zeros(pad)]).reshape(nCh,
                                                                      chunk)
    Aj = jasm._bucket_natural_scatter_scan(
        jnp.zeros((N + 1, N + 1)), jnp.asarray(m.vertices),
        jnp.asarray(m.cells), jnp.asarray(dm.dofs), jnp.asarray(vols),
        jnp.asarray(dip), jnp.asarray(djp), jnp.asarray(sf),
        jnp.asarray(rule.bary_x), jnp.asarray(rule.bary_y),
        jnp.asarray(rule.w), jnp.asarray(jasm._psi_prod(PSI)), kernel=kj,
        nPSI=nPSI)
    # the port's natural-bucket glue (cell ids -> explicit arrays)
    dr = dm.dofs[di] if nPSI == 3 else np.concatenate([dm.dofs[di],
                                                       dm.dofs[dj]], axis=1)
    At = _port(N, m.vertices, m.cells[di], m.cells[dj], dr,
               vols[di] * vols[dj] * symfac, None, rule, PSI, kt)
    _assertClose(At, np.asarray(Aj)[:N, :N])


def test_boundary_rows_vs_rows_scatter_scan(disc):
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
    N, P = dm.num_dofs, len(ii)
    Aj = jasm._bucket_rows_scatter_scan(
        jnp.zeros((N + 1, N + 1)), jnp.asarray(m.vertices),
        jnp.asarray(vi1)[None], jnp.asarray(vi2)[None], jnp.asarray(dr)[None],
        jnp.asarray(vs)[None], jnp.asarray(nm)[None],
        jnp.asarray(rule.bary_x), jnp.asarray(rule.bary_y),
        jnp.asarray(rule.w), jnp.asarray(jasm._psi_prod(PSI)), kernel=bj,
        nPSI=3, useNormals=True)
    At = _port(N, m.vertices, vi1, vi2, dr, vs, nm, rule, PSI,
               kt.getBoundaryKernel())
    assert P > 0
    _assertClose(At, np.asarray(Aj)[:N, :N])


def test_panel_scatter_validates_inputs(disc):
    m, dm, kj, kt = disc
    A = torch.zeros((4, 4), dtype=torch.float64)
    v = torch.zeros((3, 2), dtype=torch.float64)
    i2 = torch.zeros((1, 3), dtype=torch.int64)
    w = torch.ones(2, dtype=torch.float64)
    with pytest.raises(ValueError, match='shape'):
        tasm.panel_scatter(A, v, i2, i2, i2, torch.ones(1, dtype=torch.float64),
                           None, torch.ones((3, 2), dtype=torch.float64),
                           torch.ones((3, 2), dtype=torch.float64), w,
                           torch.ones((2, 4), dtype=torch.float64),
                           Profile(0, 1.0, -1.0, 0.0))
    with pytest.raises(ValueError, match='int64'):
        tasm.panel_scatter(A, v, i2.int(), i2, i2,
                           torch.ones(1, dtype=torch.float64), None,
                           torch.ones((3, 2), dtype=torch.float64),
                           torch.ones((3, 2), dtype=torch.float64), w,
                           torch.ones((2, 9), dtype=torch.float64),
                           Profile(0, 1.0, -1.0, 0.0))


@pytest.mark.cuda
def test_kernels_match_plain_on_gpu(disc):
    """Every kernel of the dense assembly against its plain version on the
    card, on the buckets of the disc at noRef 2 (needs an NVIDIA GPU)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    from pynucleus_tpu_torch.interop import fromArrays
    m, dm, kj, kt = disc
    _, tdm, tk = fromArrays(m.vertices, m.cells, 0.75, 2, device='cuda')
    calls = {}
    names = ('panel_scatter', 'grid_distant', 'grid_boundary')
    orig = {n: getattr(tasm, n) for n in names}

    def recorder(n):
        def rec(A, *args):
            calls.setdefault(n, []).append((A.shape[0], args))
            return orig[n](A, *args)
        return rec
    try:
        for n in names:
            setattr(tasm, n, recorder(n))
        tasm.nonlocalBuilder(tdm, tk).getDense()
    finally:
        for n in names:
            setattr(tasm, n, orig[n])
    for n in names:
        assert calls.get(n)
        for N, args in calls[n]:
            Ak = torch.zeros((N, N), dtype=torch.float64, device='cuda')
            Ap = torch.zeros_like(Ak)
            orig[n](Ak, *args)
            getattr(tasm, '_' + n + '_plain')(Ap, *args)
            assert float((Ak - Ap).abs().max()) <= \
                1e-12 * float(Ap.abs().max())

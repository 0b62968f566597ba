"""Kernels K2 (grid_distant) and K3 (grid_boundary): their plain versions
against the JAX programs they replace, _grid_distant_pass and
_grid_boundary_blocks + _scatter_cell_blocks, on the disc at noRef 3 with
the windows and exclusion lists of the real classification.  Tolerance
1e-13 relative to max|A|: the same float64 quadrature summed in another
order (the window test is float32 in both, and bit-identical).
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

from pynucleus_tpu_torch.nl import assembly as tasm
from pynucleus_tpu_torch.nl.kernels import getFractionalKernel as tKernel
from pynucleus_tpu_torch.nl.kernels import Profile

TOL = 1e-13


@pytest.fixture(scope='module')
def disc():
    m = jfem.circle(h=0.78, radius=1.0)
    for _ in range(3):
        m = m.refine()
    dm = jfem.P1_DoFMap(m)
    kj = jKernel(2, 0.75)
    return m, dm, kj, tKernel(2, 0.75), classifyPairsDenseGrid(dm, kj)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)


def _assertClose(At, Aj):
    scale = np.abs(Aj).max()
    assert scale > 0
    assert np.abs(At - Aj).max() <= TOL * scale


@pytest.mark.parametrize('window', [0, 1])
def test_grid_distant_vs_grid_distant_pass(disc, window):
    m, dm, kj, kt, info = disc
    o, t_lo, t_hi = info['gridPasses'][window]
    C, N = m.num_cells, dm.num_dofs
    V = m.vertices[m.cells]
    cc32 = V.mean(axis=1).astype(np.float32)
    b1, w1 = simplexCompact(o, 2)
    X = np.einsum('qk,ckd->cqd', b1, V)
    Phi = dm.evalPhi(b1)
    Ct = 64
    Aj = jasm._grid_distant_pass(
        jnp.zeros((N + 1, N + 1)), jnp.asarray(X), jnp.asarray(X),
        jnp.asarray(cc32), jnp.asarray(m.simplexVolumes()),
        jnp.asarray(dm.dofs.astype(np.int32)),
        jnp.asarray(jasm._dofIncidence(dm.dofs, N).astype(np.int32)),
        jnp.asarray(Phi * w1), jnp.asarray(Phi), jnp.asarray(Phi),
        jnp.asarray(-Phi * w1), jnp.asarray(w1), jnp.asarray(w1),
        jnp.float32(t_lo), jnp.float32(t_hi), kernel=kj,
        nTiles=-(-C // Ct), Ct=Ct)
    At = torch.zeros((N, N), dtype=torch.float64)
    prof = kt.profileParams()
    tasm.grid_distant(At, _t(X), _t(cc32, torch.float32),
                      _t(m.simplexVolumes()), _t(dm.dofs, torch.int64),
                      _t(Phi * w1), _t(Phi), _t(-Phi * w1), _t(w1),
                      np.float32(t_lo), np.float32(t_hi), prof)
    _assertClose(At.numpy(), np.asarray(Aj)[:N, :N])


def test_window_test_is_float32_and_matches_host(disc):
    """The plain version's float32 d2 equals panels._d2f32 bit for bit."""
    from pynucleus_tpu.nl.panels import _d2f32
    m = disc[0]
    cc32 = m.vertices[m.cells].mean(axis=1).astype(np.float32)
    rc = np.arange(0, m.num_cells, 7)
    d2t = tasm._d2f32(_t(cc32, torch.float32), torch.as_tensor(rc)).numpy()
    ii = np.repeat(rc, m.num_cells)
    jj = np.tile(np.arange(m.num_cells), len(rc))
    d2h = _d2f32(cc32, ii, jj).reshape(len(rc), m.num_cells)
    assert d2t.dtype == np.float32
    assert np.array_equal(d2t, d2h)


def test_grid_boundary_vs_grid_boundary_blocks(disc):
    m, dm, kj, kt, info = disc
    bj = kj.getModifiedKernel(horizon=np.inf).getBoundaryKernel()
    surface = m.get_surface_mesh()
    binfo = classifyBoundaryPairs(dm, surface, bj, correctionsOnly=True)
    di, dj, _ = binfo['distant']
    tp = binfo['touching'][0]
    mi = np.concatenate([di, tp[:, 0]])
    mj = np.concatenate([dj, tp[:, 1]])
    C, S, N = m.num_cells, surface.num_cells, dm.num_dofs
    V = m.vertices[m.cells]
    SV = m.vertices[surface.cells]
    b1, w1 = simplexCompact(4, 2)
    b2, w2 = simplexCompact(4, 1)
    X = np.einsum('qk,ckd->cqd', b1, V)
    Ysurf = np.einsum('qk,skd->sqd', b2, SV)
    Phi = dm.evalPhi(b1)
    svolw2 = surface.simplexVolumes()[:, None] * w2[None, :]
    # JAX: per-tile exclusion lists (as _runBoundaryGrid builds them)
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
        jnp.asarray(X), jnp.asarray(Ysurf), jnp.asarray(svolw2),
        jnp.asarray(m.simplexVolumes()), jnp.asarray(surface.normals),
        jnp.asarray(Phi * w1), jnp.asarray(Phi), jnp.asarray(w1),
        jnp.asarray(mR), jnp.asarray(mC), kernel=bj, nTiles=nTiles, Ct=Ct,
        useNormals=True, maskIn=False, dtype=jnp.float64)
    Aj = jasm._scatter_cell_blocks(jnp.zeros((N + 1, N + 1)),
                                   jnp.asarray(dm.dofs.astype(np.int32)), B)
    # port: per-cell sorted CSR exclusion lists
    key = np.unique(mi.astype(np.int64) * S + mj)
    exclPtr = np.searchsorted(key // S, np.arange(C + 1))
    At = torch.zeros((N, N), dtype=torch.float64)
    prof = kt.getBoundaryKernel().profileParams()
    tasm.grid_boundary(At, _t(X), _t(m.simplexVolumes()),
                       _t(dm.dofs, torch.int64), _t(Ysurf), _t(svolw2),
                       _t(surface.normals), _t(exclPtr, torch.int64),
                       _t(key % S, torch.int64), _t(Phi * w1), _t(Phi),
                       prof, True)
    _assertClose(At.numpy(), np.asarray(Aj)[:N, :N])


def test_grid_wrappers_validate_inputs():
    A = torch.zeros((3, 3), dtype=torch.float64)
    X = torch.zeros((2, 3, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match='float32'):
        tasm.grid_distant(A, X, torch.zeros((2, 2), dtype=torch.float64),
                          torch.ones(2, dtype=torch.float64),
                          torch.zeros((2, 3), dtype=torch.int64),
                          *(torch.ones((3, 3), dtype=torch.float64),) * 3,
                          torch.ones(3, dtype=torch.float64),
                          0.0, 1.0, Profile(0, 1.0, -1.0, 0.0))
    with pytest.raises(ValueError, match='contiguous square'):
        tasm.grid_distant(torch.zeros((3, 4), dtype=torch.float64), X,
                          torch.zeros((2, 2), dtype=torch.float32),
                          torch.ones(2, dtype=torch.float64),
                          torch.zeros((2, 3), dtype=torch.int64),
                          *(torch.ones((3, 3), dtype=torch.float64),) * 3,
                          torch.ones(3, dtype=torch.float64),
                          0.0, 1.0, Profile(0, 1.0, -1.0, 0.0))

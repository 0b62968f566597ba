"""The manifold fractional kernel (MANIFOLD_FRACTIONAL: a closed 1-manifold
in R^2, the chordal distance, the effective dimension dim - 1) of the port
against the JAX package.

  bar        tests/test_manifold_kernel.py on the port: the type, the
             singularity -1 - 2s, symmetry, a positive diagonal and the
             constants in the null space (1e-12 of the largest entry)
  kernel     the scaling, singularities and profile against the JAX kernel
  dense      getDense on the surface of circle(n=8) refined 3 and 5 times
             (64 and 256 dofs), per pair and on the grid, against the JAX
             getDense with the same ``denseGrid``: 1e-12 of the largest
             entry; the zero-exterior term of the closed curve adds
             exactly 0 (the JAX grid path fails on its empty surface)
  sphere1    fem.meshes.sphere1 against pynucleus_tpu/fem/mesh_zoo.py
             sphere1 and its refinements: equal; the operator on it
  refusals   H2 of the manifold kernel (the JAX getH2 fails there too),
             a variable order or a finite horizon of it

The JAX side runs on the CPU as the JAX package's own tests run it; the
port's kernel wrappers run their plain versions on CPU tensors.
"""
import numpy as np
import pytest
import torch

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.fem.mesh_zoo import sphere1 as jSphere1
from pynucleus_tpu.nl import kernels as jker
from pynucleus_tpu.nl.assembly import nonlocalBuilder as jBuilder

from pynucleus_tpu_torch.interop import fromArrays
from pynucleus_tpu_torch.fem.meshes import circle, sphere1
from pynucleus_tpu_torch.fem.dofmaps import P1_DoFMap
from pynucleus_tpu_torch.nl import kernels as tker
from pynucleus_tpu_torch.nl.assembly import nonlocalBuilder as tBuilder


def _surface(noRef):
    m = jfem.circle(n=8)
    for _ in range(noRef):
        m = m.refine()
    return m.get_surface_mesh()


@pytest.fixture(scope='module')
def jaxDense():
    """The JAX getDense of the manifold kernel (s 0.5) on the surfaces of
    the disc refined 3 and 5 times, per pair and on the grid."""
    k = jker.getFractionalKernel(2, 0.5, manifold=True)
    out = {}
    for noRef in (3, 5):
        dm = jfem.P1_DoFMap(_surface(noRef), tag=None)
        for grid in (False, True):
            out[noRef, grid] = np.asarray(jBuilder(
                dm, k, zeroExterior=False,
                params={'denseGrid': grid}).getDense().toarray())
    return out


def test_manifold_fractional_circle():
    """tests/test_manifold_kernel.py on the port."""
    m = circle(n=8)
    for _ in range(3):
        m = m.refine()
    surf = m.get_surface_mesh()
    assert surf.manifold_dim == 1 and surf.dim == 2
    k = tker.getFractionalKernel(2, 0.5, manifold=True)
    assert k.kernelType == tker.MANIFOLD_FRACTIONAL
    assert np.isclose(k.singularityValue, -2.0)
    dm = P1_DoFMap(surf, tag=None, device='cpu')
    A = tBuilder(dm, k, zeroExterior=False).getDense()
    Ad = A.toarray()
    assert np.abs(Ad - Ad.T).max() < 1e-12
    assert (np.diag(Ad) > 0).all()
    one = torch.ones(dm.num_dofs, dtype=torch.float64)
    assert float(torch.linalg.norm(A.matvec(one))) < 1e-12 * np.abs(Ad).max()


@pytest.mark.parametrize('s', [0.25, 0.5, 0.75])
def test_kernel_matches_jax(s):
    jk = jker.getFractionalKernel(2, s, manifold=True)
    tk = tker.getFractionalKernel(2, s, manifold=True)
    for name in ('kernelType', 'dim', 'scalingValue', 'singularityValue',
                 'min_singularity', 'max_singularity', 'symmetric',
                 'variable'):
        assert getattr(tk, name) == getattr(jk, name), name
    x, y = np.array([[0.3, -0.2]]), np.array([[-0.5, 0.4]])
    assert tk(x, y) == pytest.approx(jk(x, y), rel=1e-15)


@pytest.mark.parametrize('grid', [False, True], ids=['per-pair', 'grid'])
@pytest.mark.parametrize('noRef', [3, 5], ids=['64dofs', '256dofs'])
def test_dense_matches_jax(jaxDense, noRef, grid):
    surf = _surface(noRef)
    _, tdm, tk = fromArrays(surf.vertices, surf.cells, 0.5, 2,
                            device='cpu', manifold=True)
    assert tdm.num_dofs == surf.cells.shape[0]
    ref = jaxDense[noRef, grid]
    B = tBuilder(tdm, tk, zeroExterior=False,
                 params={'denseGrid': grid}).getDense().toarray()
    assert np.abs(B - ref).max() <= 1e-12 * np.abs(ref).max()
    # the closed curve has no surface: its zero-exterior term adds 0
    Bz = tBuilder(tdm, tk, params={'denseGrid': grid}).getDense().toarray()
    assert np.array_equal(Bz, B)


def test_sphere1_matches_jax():
    jm, tm = jSphere1(16, 0.8), sphere1(16, 0.8)
    for _ in range(2):
        np.testing.assert_array_equal(tm.vertices, jm.vertices)
        np.testing.assert_array_equal(tm.cells, jm.cells)
        assert (tm.dim, tm.manifold_dim) == (jm.dim, jm.manifold_dim)
        jm, tm = jm.refine(), tm.refine()
    k = jker.getFractionalKernel(2, 0.3, manifold=True)
    A = np.asarray(jBuilder(jfem.P1_DoFMap(jm, tag=None), k,
                            zeroExterior=False).getDense().toarray())
    B = tBuilder(P1_DoFMap(tm, tag=None, device='cpu'),
                 tker.getFractionalKernel(2, 0.3, manifold=True),
                 params={'denseGrid': False}).getDense().toarray()
    assert np.abs(B - A).max() <= 1e-12 * np.abs(A).max()


def test_refusals():
    surf = _surface(2)
    _, tdm, tk = fromArrays(surf.vertices, surf.cells, 0.5, 2,
                            device='cpu', manifold=True)
    with pytest.raises(NotImplementedError, match='manifold'):
        tBuilder(tdm, tk).getH2()
    with pytest.raises(NotImplementedError):
        tker.getFractionalKernel(
            2, tker.leftRightFractionalOrder(0.25, 0.75), manifold=True)
    with pytest.raises(NotImplementedError):
        tker.getFractionalKernel(2, 0.5, horizon=0.5, manifold=True)

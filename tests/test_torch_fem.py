"""The port's host modules against the JAX package: meshes, dofmaps,
quadrature and singular rules, functions, FEM assembly, kernel parameters
and pair classification.  Integer arrays must be equal, floats agree to
1e-14 (both packages run the same numpy code on the same inputs).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import pynucleus_tpu.fem as jfem
import pynucleus_tpu.nl.quad_singular as jqs
import pynucleus_tpu.nl.quad_singular_2d as jqs2
from pynucleus_tpu.fem.quadrature import (gaussJacobi01 as jGJ,
                                          simplexCompact as jSC,
                                          simplexDuffy as jSD)
from pynucleus_tpu.nl import getFractionalKernel as jKernel
from pynucleus_tpu.nl.panels import (classifyPairsDenseGrid as jGrid,
                                     classifyBoundaryPairs as jBnd)

import pynucleus_tpu_torch as pt
import pynucleus_tpu_torch.fem as tfem
import pynucleus_tpu_torch.nl.quad_singular as tqs
import pynucleus_tpu_torch.nl.quad_singular_2d as tqs2
from pynucleus_tpu_torch.fem.quadrature import (gaussJacobi01 as tGJ,
                                                simplexCompact as tSC,
                                                simplexDuffy as tSD)
from pynucleus_tpu_torch.interop import fromArrays
from pynucleus_tpu_torch.nl.kernels import getFractionalKernel as tKernel
from pynucleus_tpu_torch.nl.panels import (classifyPairsDenseGrid as tGrid,
                                           classifyBoundaryPairs as tBnd)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-14


def _meshes(domain, noRef):
    if domain == 'disc':
        mj, mt = jfem.circle(h=0.78, radius=1.0), tfem.circle(h=0.78,
                                                              radius=1.0)
    else:
        mj = jfem.simpleInterval(-1.0, 1.0).refine()
        mt = tfem.simpleInterval(-1.0, 1.0).refine()
    for _ in range(noRef):
        mj, mt = mj.refine(), mt.refine()
    return mj, mt


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1.0) if b.size else 1.0
    assert np.abs(a - b).max(initial=0.0) <= tol * scale


def test_port_imports_no_jax():
    code = ('import pynucleus_tpu_torch, pynucleus_tpu_torch.nl.assembly, '
            'pynucleus_tpu_torch.nl.h2, pynucleus_tpu_torch.interop, '
            'pynucleus_tpu_torch.drivers.runFractional, '
            'pynucleus_tpu_torch.drivers.runNonlocal, '
            'pynucleus_tpu_torch.nl.problems, '
            'pynucleus_tpu_torch.nl.kernels, '
            'pynucleus_tpu_torch.nl.quad_singular, '
            'pynucleus_tpu_torch.kernels, '
            'pynucleus_tpu_torch.kernels.pcg_update, '
            'pynucleus_tpu_torch.kernels.jacobi_smooth, '
            'pynucleus_tpu_torch.multilevel.gmg, '
            'pynucleus_tpu_torch.nl.discretized, '
            'pynucleus_tpu_torch.base.linear_operators, '
            'pynucleus_tpu_torch.fem.quadrature, sys; '
            'from pynucleus_tpu_torch.base.linear_operators import '
            'vector_matvec, Dense_VectorLinearOperator, '
            'H2_VectorLinearOperator; '
            'from pynucleus_tpu_torch.nl.assembly import panel_scatter_vec, '
            'panel_scatter_nonsym_vec; '
            'from pynucleus_tpu_torch.nl.kernels import '
            'DerivativeFractionalKernel, VectorFractionalKernel; '
            'import pynucleus_tpu_torch.nl.operator_interpolation, '
            'pynucleus_tpu_torch.examples.example_operator_interpolation; '
            'from pynucleus_tpu_torch.fem.assembly import '
            'matrixFreeOperator; '
            'import pynucleus_tpu_torch.base.linalg, '
            'pynucleus_tpu_torch.base.sparse_native, '
            'pynucleus_tpu_torch.multilevel, '
            'pynucleus_tpu_torch.multilevel.smoothers, '
            'pynucleus_tpu_torch.multilevel.hierarchies; '
            'from pynucleus_tpu_torch.base.linear_operators import '
            'SSS_LinearOperator, SchurComplement, sss_spmv; '
            'from pynucleus_tpu_torch.base.solvers import ichol_solver, '
            'ilu_solver; '
            'from pynucleus_tpu_torch.multilevel.gmg import cheb_smooth, '
            '_mg_solve; '
            'from pynucleus_tpu_torch.interop import sssFromArrays; '
            'import pynucleus_tpu_torch.drivers.variableOrder; '
            'from pynucleus_tpu_torch.fem.meshes import sphere1; '
            'from pynucleus_tpu_torch.nl.kernels import '
            'feFractionalOrder, innerOuterFractionalOrder, '
            'layersFractionalOrder, MANIFOLD_FRACTIONAL; '
            'from pynucleus_tpu_torch.config import realType; '
            'from pynucleus_tpu_torch.interop import builderFromArrays; '
            'from pynucleus_tpu_torch.nl.assembly import '
            'panel_scatter_natural; '
            'import pynucleus_tpu_torch.parallel, '
            'pynucleus_tpu_torch.parallel.dist, '
            'pynucleus_tpu_torch.parallel.dist_h2, '
            'pynucleus_tpu_torch.parallel.maps, '
            'pynucleus_tpu_torch.parallel.overlaps, '
            'pynucleus_tpu_torch.parallel.collectives, '
            'pynucleus_tpu_torch.fem.partitioning, '
            'pynucleus_tpu_torch.kernels.outbox, '
            'pynucleus_tpu_torch.kernels.dist_h2, '
            'pynucleus_tpu_torch.drivers.testDistOp, '
            'pynucleus_tpu_torch.drivers.runParallelGMG; '
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m == 'pynucleus_tpu' or "
            "m.startswith('pynucleus_tpu.') for m in sys.modules), "
            "'pynucleus_tpu imported'")
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                   timeout=120)


def test_cuda_request_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present')
    with pytest.raises(RuntimeError, match='cuda'):
        pt.getDevice('cuda')
    mesh = tfem.simpleInterval(-1.0, 1.0, numCells=4)
    with pytest.raises(RuntimeError):
        tfem.P1_DoFMap(mesh, device='cuda')


@pytest.mark.parametrize('order,alpha,beta', [(1, 0.0, 0.0), (7, 2.5, 0.0),
                                              (13, -0.5, 1.0)])
def test_gauss_jacobi(order, alpha, beta):
    for a, b in zip(tGJ(order, alpha, beta), jGJ(order, alpha, beta)):
        _close(a, b)


@pytest.mark.parametrize('order,mdim', [(2, 1), (4, 2), (6, 2), (8, 2),
                                        (12, 2), (28, 2)])
def test_simplex_rules(order, mdim):
    for a, b in zip(tSC(order, mdim), jSC(order, mdim)):
        _close(a, b)
    for a, b in zip(tSD(order, mdim), jSD(order, mdim)):
        _close(a, b)


@pytest.mark.parametrize('name,args', [
    ('sameCellRule2DSS', (-3.5, 2, 13)),
    ('edgeRule2DSS', (-3.5, 2, 13)),
    ('vertexRule2DSS', (-3.5, 2, 9)),
    ('boundaryEdgeRule2DSS', (-0.5, 18, 18)),
    ('boundaryVertexRule2DSS', (-2.5, 18, 18)),
])
def test_singular_rules_2d(name, args):
    rj, rt = getattr(jqs2, name)(*args), getattr(tqs2, name)(*args)
    for f in ('bary_x', 'bary_y', 'w'):
        _close(getattr(rt, f), getattr(rj, f))


@pytest.mark.parametrize('name,args', [
    ('sameCellRule1D', (-2.5, 2)), ('vertexRule1D', (-2.5, 20, 2)),
    ('boundaryVertexRule1D', (-1.5, 5)), ('distantRule', (6, 2)),
    ('boundaryDistantRule', (6, 2, 1)), ('boundaryDistantRule', (4, 1, 0)),
])
def test_rules_1d_and_distant(name, args):
    rj, rt = getattr(jqs, name)(*args), getattr(tqs, name)(*args)
    for f in ('bary_x', 'bary_y', 'w'):
        _close(getattr(rt, f), getattr(rj, f))


@pytest.mark.parametrize('domain,noRef', [('disc', 3), ('interval', 5)])
def test_mesh_dofmap_surface(domain, noRef):
    mj, mt = _meshes(domain, noRef)
    assert np.array_equal(mt.cells, mj.cells)
    _close(mt.vertices, mj.vertices)
    assert (mt.h, mt.hmin, mt.diam) == (mj.h, mj.hmin, mj.diam)
    _close(mt.simplexVolumes(), mj.simplexVolumes())
    dj, dt = jfem.P1_DoFMap(mj), tfem.P1_DoFMap(mt, device='cpu')
    assert np.array_equal(dt.dofs, dj.dofs)
    assert (dt.num_dofs, dt.num_boundary_dofs) == \
        (dj.num_dofs, dj.num_boundary_dofs)
    cj, ct = dj.getComplementDoFMap(), dt.getComplementDoFMap()
    assert np.array_equal(ct.dofs, cj.dofs) and ct.num_dofs == cj.num_dofs
    _close(dt.getDoFCoordinates(), dj.getDoFCoordinates())
    bary = np.random.RandomState(0).dirichlet(np.ones(mt.manifold_dim + 1), 7)
    _close(dt.evalPhi(bary), dj.evalPhi(bary))
    sj, st = mj.get_surface_mesh(), mt.get_surface_mesh()
    assert np.array_equal(st.cells, sj.cells)
    _close(st.normals, sj.normals)
    _close(st.simplexVolumes(), sj.simplexVolumes())
    # interop builds the same objects from the JAX package's arrays
    mesh, dm, k = fromArrays(mj.vertices, mj.cells, 0.75, mj.dim,
                             device='cpu')
    assert np.array_equal(dm.dofs, dj.dofs)


@pytest.mark.parametrize('domain', ['disc', 'interval'])
def test_functions_rhs_mass(domain):
    mj, mt = _meshes(domain, 2)
    dj, dt = jfem.P1_DoFMap(mj), tfem.P1_DoFMap(mt, device='cpu')
    dim = mt.dim
    X = np.random.RandomState(1).uniform(-1.1, 1.1, size=(50, dim))
    fj = [jfem.constant(2.5), jfem.solFractional(0.75, dim),
          jfem.radialIndicator(0.8), jfem.Lambda(lambda x: np.sin(x[0]))]
    ft = [tfem.constant(2.5), tfem.solFractional(0.75, dim),
          tfem.radialIndicator(0.8), tfem.Lambda(lambda x: np.sin(x[0]))]
    for a, b in zip(ft, fj):
        _close(a(X), b(X))
    for q in (None, 3):
        _close(tfem.assembleRHS(dt, ft[1], qOrder=q).toarray(),
               np.asarray(jfem.assembleRHS(dj, fj[1], qOrder=q).data))
    _close(tfem.assembleMass(dt).toarray(), jfem.assembleMass(dj).toarray())
    _close(dt.interpolate(ft[1]).toarray(),
           np.asarray(dj.interpolate(fj[1]).data))


@pytest.mark.parametrize('dim,s', [(1, 0.25), (2, 0.75)])
def test_kernel_parameters(dim, s):
    kj, kt = jKernel(dim, s), tKernel(dim, s)
    for a, b in ((kt, kj), (kt.getBoundaryKernel(),
                            kj.getModifiedKernel(horizon=np.inf)
                            .getBoundaryKernel())):
        assert a.scalingValue == b.scalingValue
        assert a.singularityValue == b.singularityValue
        assert (a.min_singularity, a.max_singularity) == \
            (b.min_singularity, b.max_singularity)
        assert repr(a) == repr(b)


@pytest.mark.parametrize('domain,noRef', [('disc', 3), ('interval', 5)])
def test_pair_classification(domain, noRef):
    mj, mt = _meshes(domain, noRef)
    dj, dt = jfem.P1_DoFMap(mj), tfem.P1_DoFMap(mt, device='cpu')
    kj, kt = jKernel(mt.dim, 0.75), tKernel(mt.dim, 0.75)
    ij, it = jGrid(dj, kj), tGrid(dt, kt)
    assert it['gridPasses'] == ij['gridPasses']
    assert it['quad_order_diagonal'] == ij['quad_order_diagonal']
    assert np.array_equal(it['touching'][0], ij['touching'][0])
    lut, group = it['touching'][1]
    assert len(group) == len(ij['touching'][1])
    for g, b in zip(group, ij['touching'][1]):
        a = lut[g]
        assert a[0] == b[0] and np.array_equal(a[1], b[1]) \
            and np.array_equal(a[2], b[2])
    for a, b in zip(it['distant'], ij['distant']):
        assert np.array_equal(a, b)
    bj = jBnd(dj, mj.get_surface_mesh(),
              kj.getModifiedKernel(horizon=np.inf).getBoundaryKernel(),
              correctionsOnly=True)
    bt = tBnd(dt, mt.get_surface_mesh(), kt.getBoundaryKernel(),
              correctionsOnly=True)
    assert np.array_equal(bt['touching'][0], bj['touching'][0])
    for a, b in zip(bt['distant'], bj['distant']):
        assert np.array_equal(a, b)
    assert bt['quad_order_diagonal'] == bj['quad_order_diagonal']

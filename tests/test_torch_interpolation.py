"""The port's operator interpolation over the fractional order and its
matrix-free FEM operator against the JAX package.

Same inputs in both packages (the same meshes built by each, numpy
seeds); on the CPU the port's kernel wrappers run their plain versions:

  host part        getChebyIntervalsAndNodes (its three branches, the
                   arguments of assembleRangedNonlocal at noRef 4, 12, 13)
                   and lagrangeWeights: exact
  ranged kernel    kernelFactory('fractional', s=admissibleSet(...))
  dense family     the interval at noRef 4, s in [0.3, 0.7]: apply (K24),
                   diagonal and toarray at s = 0.5 and 0.45, 1e-12
                   relative; the node operators assembled after each set,
                   equal; CG-Jacobi: iterations equal, ||x|| to 1e-10
  H2 family        apply at s = 0.5, 1e-10 relative
  matrix-free      mass and stiffness, with and without a coefficient, on
                   the interval at noRef 4 and the disc's mesh refined
                   once: apply (K25) and diagonal, 1e-12 relative
  K24, K25 plain   against the JAX programs they replace (the einsum of
                   the stack; the jitted gather, einsum and segment sum)
  the example      the port's copy at its own size against the JAX
                   outputs pinned by scripts/pin_operator_interpolation_jax.py

The dense node operators take the per-pair path (``denseGrid`` False),
which the JAX package takes on the CPU.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pynucleus_tpu.fem as jfem
from pynucleus_tpu.base import solverFactory as jSolverFactory
from pynucleus_tpu.fem import matrixFreeOperator as jMatrixFree
from pynucleus_tpu.nl.assembly import assembleNonlocal as jAssemble
from pynucleus_tpu.nl.kernels import kernelFactory as jKernelFactory
from pynucleus_tpu.nl import operator_interpolation as jOI

import pynucleus_tpu_torch.fem as tfem
from pynucleus_tpu_torch import kernels
from pynucleus_tpu_torch.base.solvers import solverFactory
from pynucleus_tpu_torch.fem.assembly import (matrixFreeOperator,
                                              matfree_apply, assembleRHS)
from pynucleus_tpu_torch.nl.assembly import assembleNonlocal
from pynucleus_tpu_torch.nl.kernels import (kernelFactory, ComplexKernel,
                                            FractionalKernel)
from pynucleus_tpu_torch.nl import operator_interpolation as tOI
from pynucleus_tpu_torch.nl.operator_interpolation import (
    admissibleSet, RangedFractionalKernel, multiIntervalInterpolationOperator,
    interp_matvec)

NOREF = 4
RANGE = [0.3, 0.7]
DENSE = {'denseGrid': False}


def _interval(noRef):
    mj, mt = jfem.simpleInterval(-1.0, 1.0), tfem.simpleInterval(-1.0, 1.0)
    for _ in range(noRef):
        mj, mt = mj.refine(), mt.refine()
    return mj, mt


def _disc():
    mj = jfem.circle(h=0.78, radius=1.0).refine()
    mt = tfem.circle(h=0.78, radius=1.0).refine()
    return mj, mt


def _rel(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope='module')
def dms():
    mj, mt = _interval(NOREF)
    dj, dt = jfem.P1_DoFMap(mj), tfem.P1_DoFMap(mt, device='cpu')
    np.testing.assert_array_equal(dj.dofs, dt.dofs)
    return dj, dt


@pytest.fixture(scope='module')
def dense(dms):
    """The dense families of both packages (node operators assembled as
    the tests set s)."""
    dj, dt = dms
    Aj = jAssemble(dj, jKernelFactory('fractional',
                                      s=jOI.admissibleSet(RANGE), dim=1),
                   matrixFormat='dense')
    At = assembleNonlocal(dt, kernelFactory('fractional',
                                            s=admissibleSet(RANGE), dim=1),
                          matrixFormat='dense', params=DENSE, device='cpu')
    return Aj, At


def _x(n):
    return np.random.RandomState(14).standard_normal(n)


# ------------------------------------------------------------ host part ---

# (s_left, s_right, delta, r, eta, keywords): the three branches, and the
# arguments of assembleRangedNonlocal on the interval [-1, 1] (diameter 2,
# eta = 0.1 h^(1/2)) at noRef 4, 12 and 13
CHEBY_CASES = {
    'variable': (0.1, 0.9, 2.0, 0.5, 1e-3, {'variableOrder': True}),
    'variable_fixed_xi': (0.1, 0.9, 2.0, 0.5, 1e-3,
                          {'variableOrder': True, 'fixedXi': 0.3}),
    'split_m': (0.05, 0.95, 2.0, 0.5, 1e-4, {'doSplitM': True}),
    'fixed_order': (0.2, 0.8, 0.5, 0.5, 1e-5, {}),
}
CHEBY_CASES.update({
    f'ranged_noRef{n}_{lo}_{hi}': (
        lo, hi, 2.0, 0.5, 0.1 * (2.0 / 2 ** n) ** 0.5,
        {'M_min': 1, 'M_max': 20, 'fixedXi': 0.0, 'variableOrder': True})
    for n, lo, hi in ((4, 0.3, 0.7), (12, 0.05, 0.95), (13, 0.05, 0.95),
                      (13, 0.3, 0.7))})


@pytest.mark.parametrize('case', sorted(CHEBY_CASES))
def test_cheby_intervals_and_nodes_equal_jax(case):
    *args, kw = CHEBY_CASES[case]
    ivJ, ndJ = jOI.getChebyIntervalsAndNodes(*args, **kw)
    ivT, ndT = tOI.getChebyIntervalsAndNodes(*args, **kw)
    assert np.array_equal(np.array(ivT, dtype=float),
                          np.array(ivJ, dtype=float))
    assert len(ndT) == len(ndJ)
    for a, b in zip(ndT, ndJ):
        assert np.array_equal(a, b)


def test_node_counts_of_the_example_and_refine_13():
    """The example's 14 intervals of 4 nodes (56), noRef 13's 13 of 6."""
    for n, count in ((6, [4] * 14), (13, [6] * 13)):
        *args, kw = (0.05, 0.95, 2.0, 0.5, 0.1 * (2.0 / 2 ** n) ** 0.5,
                     {'M_min': 1, 'M_max': 20, 'fixedXi': 0.0,
                      'variableOrder': True})
        assert [len(v) for v in tOI.getChebyIntervalsAndNodes(
            *args, **kw)[1]] == count


@pytest.mark.parametrize('n', [1, 4, 6])
def test_lagrange_weights_equal_jax(n):
    nodes = tOI.chebyshevNodesOnInterval(n, 0.2, 0.6)
    np.testing.assert_array_equal(nodes,
                                  jOI.chebyshevNodesOnInterval(n, 0.2, 0.6))
    np.testing.assert_array_equal(tOI.chebyshevBarycentricWeights(n),
                                  jOI.chebyshevBarycentricWeights(n))
    for s in (0.2, 0.25, float(nodes[-1]), 0.41, 0.6):
        wT, wJ = tOI.lagrangeWeights(nodes, s), jOI.lagrangeWeights(nodes, s)
        assert np.abs(wT - wJ).max() <= 1e-15


def test_kernel_factory_ranged():
    k = kernelFactory('fractional', s=admissibleSet(RANGE), dim=1)
    assert isinstance(k, RangedFractionalKernel)
    frozen = k.getFrozenKernel(0.5)
    assert isinstance(frozen, FractionalKernel)
    assert frozen.sValue == 0.5
    with pytest.raises(AssertionError):
        k.getFrozenKernel(0.8)
    assert isinstance(kernelFactory('fractional', s=0.5, dim=1),
                      FractionalKernel)
    assert isinstance(kernelFactory('greens2D', 2, greensLambda=-3j),
                      ComplexKernel)
    assert isinstance(kernelFactory('GREENS3D', 3), ComplexKernel)


# ---------------------------------------------------------- the families ---

def test_dense_apply_diagonal_toarray(dense):
    Aj, At = dense
    assert isinstance(At, multiIntervalInterpolationOperator)
    assert At.getNumInterpolationNodes() == Aj.getNumInterpolationNodes()
    x = _x(At.num_rows)
    for s in (0.5, 0.45):
        Aj.set(s)
        At.set(s)
        np.testing.assert_array_equal(At._weights, Aj._weights)
        out = torch.empty(At.num_rows, dtype=torch.float64)
        y = At.matvec(torch.as_tensor(x), out=out)
        assert y is out
        assert _rel(y.numpy(), Aj @ x) <= 1e-12
        assert _rel(At.diagonal.numpy(), Aj.diagonal) <= 1e-12
        assert _rel(At.toarray(), Aj.toarray()) <= 1e-12


def test_lazy_assembly_counts(dense):
    Aj, At = dense

    def counts(A):
        return [sum(d.assembled for d in ops) for ops in A.ops]

    x = _x(At.num_rows)
    seen = []
    for s in (0.5, 0.55, 0.35, 0.3, 0.65):
        Aj.set(s)
        At.set(s)
        Aj @ x
        At.matvec(torch.as_tensor(x))
        assert counts(At) == counts(Aj)
        seen.append(sum(counts(At)))
    # 0.55 reuses 0.5's interval and 0.3 0.35's; each new one adds 3
    assert seen[1] == seen[0] and seen[3] == seen[2] == seen[1] + 3
    assert seen[4] == seen[3] + 3


def test_cg_jacobi(dense, dms):
    Aj, At = dense
    dj, dt = dms
    bj = np.asarray(jfem.assembleRHS(dj, jfem.constant(1.)).data)
    bt = assembleRHS(dt, tfem.constant(1.)).data
    np.testing.assert_allclose(bt.numpy(), bj, rtol=1e-15)
    Aj.set(0.5)
    At.set(0.5)
    sj = jSolverFactory('cg-jacobi', A=Aj, setup=True)
    sj.maxIter, sj.tolerance = 1000, 1e-8
    xj = np.asarray(sj(bj, np.zeros(dj.num_dofs)))
    st = solverFactory.build('cg-jacobi', A=At, setup=True)
    st.maxIter, st.tolerance = 1000, 1e-8
    xt = st.solve(bt).numpy()
    assert st.iterations == sj.iterations
    assert abs(np.linalg.norm(xt) - np.linalg.norm(xj)) \
        <= 1e-10 * np.linalg.norm(xj)


def test_h2_apply(dms):
    dj, dt = dms
    Hj = jAssemble(dj, jKernelFactory('fractional',
                                      s=jOI.admissibleSet(RANGE), dim=1),
                   matrixFormat='H2')
    Ht = assembleNonlocal(dt, kernelFactory('fractional',
                                            s=admissibleSet(RANGE), dim=1),
                          matrixFormat='H2', device='cpu')
    Hj.set(0.5)
    Ht.set(0.5)
    x = _x(Ht.num_rows)
    assert _rel(Ht.matvec(torch.as_tensor(x)).numpy(), Hj @ x) <= 1e-10
    assert _rel(Ht.diagonal.numpy(), Hj.diagonal) <= 1e-10
    assert kernels.launches['interp_matvec'] == 0


# -------------------------------------------------------- matrix-free -----

@pytest.mark.parametrize('domain', ['interval', 'disc'])
@pytest.mark.parametrize('kind,coef', [('mass', False), ('stiffness', False),
                                       ('mass', True), ('stiffness', True)])
def test_matrix_free(domain, kind, coef):
    mj, mt = _interval(NOREF) if domain == 'interval' else _disc()
    dj, dt = jfem.P1_DoFMap(mj), tfem.P1_DoFMap(mt, device='cpu')

    def c(X):
        return 1.0 + X[:, 0] ** 2 + 0.5 * X[:, -1]

    kw = {'coefficient': c} if coef else {}
    Aj = jMatrixFree(dj, kind=kind, **kw)
    At = matrixFreeOperator(dt, kind=kind, **kw)
    x = _x(dt.num_dofs)
    assert _rel(At.matvec(torch.as_tensor(x)).numpy(), Aj.matvec(x)) <= 1e-12
    assert _rel(At.diagonal.numpy(), Aj.diagonal) <= 1e-12
    if not coef:
        A = tfem.assembleMass(dt) if kind == 'mass' else \
            tfem.assembleStiffness(dt)
        assert _rel(At.matvec(torch.as_tensor(x)).numpy(),
                    A.matvec(torch.as_tensor(x)).numpy()) <= 1e-12


def test_matrix_free_rejects_other_kinds():
    _, mt = _interval(2)
    with pytest.raises(NotImplementedError):
        matrixFreeOperator(tfem.P1_DoFMap(mt, device='cpu'), kind='drift')


# ------------------------------------------------- K24, K25 plain versions -

def test_interp_matvec_plain_matches_jax_einsum():
    rng = np.random.RandomState(24)
    w, A, x = rng.standard_normal(6), rng.standard_normal((6, 37, 37)), \
        rng.standard_normal(37)
    ref = np.asarray(jnp.einsum('m,mnk,k->n', jnp.asarray(w), jnp.asarray(A),
                                jnp.asarray(x)))
    got = interp_matvec(*(torch.as_tensor(a) for a in (w, A, x)))
    assert _rel(got.numpy(), ref) <= 1e-13
    assert kernels.launches['interp_matvec'] == 0


def test_interp_matvec_validates_inputs():
    A = torch.zeros((2, 3, 3), dtype=torch.float64)
    w, x = torch.zeros(2, dtype=torch.float64), torch.zeros(3,
                                                            dtype=torch.float64)
    with pytest.raises(ValueError, match='stack'):
        interp_matvec(w, A.float(), x)
    with pytest.raises(ValueError, match='w must'):
        interp_matvec(w[:1], A, x)
    with pytest.raises(ValueError, match='out must'):
        interp_matvec(w, A, x, out=torch.zeros(4, dtype=torch.float64))


def test_matfree_apply_plain_matches_jax_program():
    """K25's plain version on the JAX operator's local matrices against
    its jitted mv and its diagonal."""
    mj, mt = _disc()
    dj = jfem.P1_DoFMap(mj)
    Aj = jMatrixFree(dj, kind='stiffness')
    At = matrixFreeOperator(tfem.P1_DoFMap(mt, device='cpu'), 'stiffness')
    Aloc = torch.as_tensor(np.array(Aj._Aloc))
    x = _x(dj.num_dofs)
    got = matfree_apply(Aloc, At._dofs, At._order, At._offsets,
                        torch.as_tensor(x))
    assert _rel(got.numpy(), Aj._mv(Aj._Aloc, jnp.asarray(x))) <= 1e-13
    d = matfree_apply(Aloc, At._dofs, At._order, At._offsets, diagonal=True)
    assert _rel(d.numpy(), Aj.diagonal) <= 1e-13
    with pytest.raises(ValueError, match='x must'):
        matfree_apply(Aloc, At._dofs, At._order, At._offsets, None)
    assert kernels.launches['matfree_apply'] == 0


# ---------------------------------------------------------- the example ---

# the JAX outputs of scripts/pin_operator_interpolation_jax.py: per order,
# the CG-Jacobi iterations, max(u) and the node operators assembled
EXAMPLE_PINS = ((0.75, 26, 0.7508971971875337, 4),
                (0.76, 26, 0.7404090974097841, 4),
                (0.3, 11, 1.1154156989416253, 8))


def test_example_matches_jax_pins():
    from pynucleus_tpu_torch.examples import example_operator_interpolation
    A, results = example_operator_interpolation.main(['--device', 'cpu'],
                                                     params=DENSE)
    assert A.getNumInterpolationNodes() == 56
    for r, (s, its, uMax, assembled) in zip(results, EXAMPLE_PINS):
        assert r['s'] == s
        assert r['iterations'] == its
        assert abs(r['u_max'] - uMax) <= 1e-8
        assert r['assembled'] == assembled


# ------------------------------------------------------------------- GPU ---

@pytest.mark.cuda
def test_kernels_match_plain_on_gpu():
    """K24 on a dense family and K25 (apply and diagonal) on the card
    against their plain versions (needs an NVIDIA GPU)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    from pynucleus_tpu_torch.nl.operator_interpolation import \
        _interp_matvec_plain
    from pynucleus_tpu_torch.fem.assembly import _matfree_apply_plain
    rng = np.random.RandomState(24)
    w, A, x = (torch.as_tensor(a, device='cuda') for a in (
        rng.standard_normal(6), rng.standard_normal((6, 301, 301)),
        rng.standard_normal(301)))
    y = interp_matvec(w, A, x)
    ref = _interp_matvec_plain(w, A, x, torch.empty_like(x))
    assert float((y - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
    _, mt = _disc()
    op = matrixFreeOperator(tfem.P1_DoFMap(mt.refine(), device='cuda'),
                            'stiffness')
    x = torch.as_tensor(_x(op.num_rows), device='cuda')
    args = (op._Aloc, op._dofs, op._order, op._offsets)
    for diag in (False, True):
        got = matfree_apply(*args, None if diag else x, diagonal=diag)
        ref = _matfree_apply_plain(*args, x, torch.empty_like(x), diag)
        assert float((got - ref).abs().max()) <= 1e-12 * float(
            ref.abs().max())

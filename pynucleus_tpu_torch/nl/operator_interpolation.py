"""Chebyshev interpolation of the operator family A(s) over ranges of the
fractional order s; kernel K24.

Port of pynucleus_tpu/nl/operator_interpolation.py.  The admissible range
[s_min, s_max] is covered by sub-intervals S_k; on each S_k

    A(s) ~= sum_m Theta_{k,m}(s) A(s_{k,m}),   s in S_k,

with s_{k,m} the Chebyshev nodes of S_k and Theta the Lagrange basis
polynomials, evaluated barycentrically.  The host part (admissibleSet,
the nodes and weights, getChebyIntervalsAndNodes, RangedFractionalKernel)
is code-identical to the JAX package's: it decides the intervals, the
nodes and the weights.  Node operators are assembled lazily, in any
format of nl/assembly.py assembleNonlocal, and kept.  When an interval's
node operators are all dense they are stacked once into an [M+1, N, N]
float64 tensor on their device, and A(s) x is kernel K24
:func:`interp_matvec`; otherwise it is the weighted sum of the node
operators' own applies (K8 for H2 nodes), as in the JAX package.  The
JAX package's pytree registration exists only for ``jax.jit`` and has no
counterpart here.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..base.linear_operators import LinearOperator, Dense_LinearOperator

__all__ = ['admissibleSet', 'chebyshevNodesOnInterval',
           'chebyshevBarycentricWeights', 'lagrangeWeights',
           'getChebyIntervalsAndNodes', 'delayedNonlocalOp',
           'multiIntervalInterpolationOperator', 'RangedFractionalKernel',
           'assembleRangedNonlocal', 'interp_matvec']


class admissibleSet:
    """A box of admissible kernel parameter ranges
    (ref operatorInterpolation.py:12-93)."""

    def __init__(self, ranges):
        ranges = np.asarray(ranges, dtype=np.float64)
        if ranges.ndim == 1:
            ranges = ranges[np.newaxis, :]
        assert ranges.shape[1] == 2
        self.ranges = ranges

    @property
    def numParams(self):
        return self.ranges.shape[0]

    def getLowerBounds(self):
        return self.ranges[:, 0].copy()

    def getUpperBounds(self):
        return self.ranges[:, 1].copy()

    @property
    def min(self):
        return float(self.ranges[0, 0])

    @property
    def max(self):
        return float(self.ranges[0, 1])

    def isAdmissible(self, z):
        z = np.atleast_1d(np.asarray(z, dtype=np.float64))
        assert z.shape[0] == self.numParams
        return bool(np.all((self.ranges[:, 0] <= z) & (z <= self.ranges[:, 1])))

    def __repr__(self):
        return '{}({})'.format(type(self).__name__, self.ranges.tolist())


def chebyshevNodesOnInterval(n, a, b):
    """n Chebyshev points of the first kind mapped to [a, b], ascending."""
    theta = (2.0 * np.arange(n, 0, -1) - 1.0) / (2.0 * n) * np.pi
    return 0.5 * (a + b) + 0.5 * (b - a) * np.cos(theta)


def chebyshevBarycentricWeights(n):
    """Barycentric weights for Chebyshev points of the first kind
    (ascending order as produced by chebyshevNodesOnInterval)."""
    m = np.arange(n - 1, -1, -1)  # node m ascending == angle index descending
    return (-1.0) ** m * np.sin((2.0 * m + 1.0) * np.pi / (2.0 * n))


def lagrangeWeights(nodes, s):
    """Theta_m(s) for the Lagrange basis on `nodes` (barycentric form)."""
    nodes = np.asarray(nodes)
    n = nodes.shape[0]
    if n == 1:
        return np.ones(1)
    w = chebyshevBarycentricWeights(n)
    d = s - nodes
    onNode = np.abs(d) < 1e-14
    if onNode.any():
        out = np.zeros(n)
        out[np.argmax(onNode)] = 1.0
        return out
    t = w / d
    return t / t.sum()


def getChebyIntervalsAndNodes(s_left, s_right, delta, r, eta,
                              M_max=20, M_min=3, variableOrder=False,
                              doSplitM=False, fixedXi=-1):
    """Cover [s_left, s_right] with sub-intervals and per-interval Chebyshev
    nodes so the operator-interpolation error is below `eta`
    (ref operatorInterpolation.py:123-265).  On an interval starting at
    smin the family s -> A(s) is analytic in a Bernstein-type region whose
    size is limited by the regularity lift rho(s) = min(r+s, 1/2); the
    contraction factor sigma of the Chebyshev interpolant gives either the
    interval length for a fixed order M, or the order for a fixed relative
    length xi.

    :param delta: the domain diameter/horizon entering the constant C_delta.
    :param r: RHS regularity (1/2 for the standard setting).
    :param eta: target interpolation error bound.
    """
    assert delta > 0. and s_left > 0. and s_right < 1.

    def lift(s):
        return min(r + s, 0.5)

    def C_delta(smin, s2):
        # epsHat at smin is (s1+s2) - 2*smin = s2 - smin
        if delta > 1:
            return 4.0 * (np.exp(-1.0) + delta ** ((s2 - smin) + 1.0))
        return 4.0 * np.exp(-1.0)

    def nextIntervalFixedOrder(smin, M):
        """Largest smax so that (M+1)-node interpolation on [smin, smax]
        meets eta."""
        s2 = min(1.0, smin + lift(smin))
        sigma = (eta / C_delta(smin, s2)) ** (1.0 / (M + 1))
        return smin + 2.0 * sigma / (1.0 + 4.0 * sigma) * min(1.0 - smin, lift(smin))

    def nextIntervalVariableOrder(smin, xi):
        """For relative interval size xi, the end point and the order M
        needed to meet eta."""
        s2 = min(1.0, smin + lift(smin))
        smax = 0.5 * (smin + s2) - xi * min(1.0 - smin, lift(smin))
        sigma = 0.5 * (smax - smin) / ((smin + s2) - 2.0 * smax)
        M = int(np.ceil(np.log(eta / C_delta(smin, s2)) / np.log(sigma) - 1.0))
        return smax, M

    def chainFixed(M, M2=None):
        if M2 is None:
            M2 = M
        s = s_left
        intervals, orders = [], []
        while s < s_right and len(intervals) < 1000:
            Mk = M2 if s >= 0.5 else M
            s_new = min(nextIntervalFixedOrder(s, Mk), s_right)
            intervals.append((s, s_new))
            orders.append(Mk)
            s = s_new
        return intervals, np.array(orders)

    def chainVariable(xi):
        s = s_left
        intervals, orders = [], []
        while s < s_right and len(intervals) < 1000:
            s_new, M = nextIntervalVariableOrder(s, xi)
            intervals.append((s, min(s_new, s_right)))
            orders.append(min(max(M, M_min), M_max))
            s = s_new
        return intervals, np.array(orders)

    if variableOrder:
        if fixedXi > 0:
            assert 0.1 < fixedXi < 0.5
            xis = np.array([fixedXi])
        else:
            xis = np.linspace(0.1, 0.5, 300)[1:-1]
        costs = np.array([(chainVariable(xi)[1] + 1).sum() for xi in xis])
        intervals, orders = chainVariable(xis[costs.argmin()])
    elif doSplitM:
        Mvals = np.arange(M_min, M_max + 1)
        costs = np.array([[(chainFixed(M, M2)[1] + 1).sum() for M2 in Mvals]
                          for M in Mvals])
        i, j = np.unravel_index(costs.argmin(), costs.shape)
        intervals, orders = chainFixed(Mvals[i], Mvals[j])
    else:
        Mvals = np.arange(M_min, M_max + 1)
        costs = np.array([(chainFixed(M)[1] + 1).sum() for M in Mvals])
        intervals, orders = chainFixed(Mvals[costs.argmin()])

    nodes = [chebyshevNodesOnInterval(M + 1, a, b)
             for (a, b), M in zip(intervals, orders)]
    return intervals, nodes


class delayedNonlocalOp:
    """Lazily-assembled nonlocal operator for one frozen kernel
    (ref nl/helpers.py:636 delayedNonlocalOp): assembled by
    nl/assembly.py assembleNonlocal at the first :meth:`get`, then kept."""

    def __init__(self, dm, kernel, matrixFormat='dense', **kwargs):
        self.dm = dm
        self.kernel = kernel
        self.matrixFormat = matrixFormat
        self.kwargs = kwargs
        self._op = None

    @property
    def assembled(self):
        return self._op is not None

    def get(self):
        if self._op is None:
            from .assembly import assembleNonlocal
            self._op = assembleNonlocal(self.dm, self.kernel,
                                        matrixFormat=self.matrixFormat,
                                        **self.kwargs)
        return self._op


class multiIntervalInterpolationOperator(LinearOperator):
    """Operator family A(s) = sum_m Theta_m(s) A(s_m) over Chebyshev
    sub-intervals (ref multiIntervalInterpolationOperator, selected via
    DoFMaps.pyx:836-863).

    :meth:`set` selects the interval that holds s and its weights (host,
    float64); the interval's node operators are assembled on demand.  For
    dense node operators a stacked [M+1, N, N] tensor is made once per
    interval on their device, and :meth:`matvec` is kernel K24."""

    def __init__(self, intervals, nodes, ops, device=None):
        self.intervals = intervals
        self.nodes = nodes
        self.ops = ops
        self._s = None
        self._k = None
        self._weights = None
        self._weightsDev = None
        self._stacked = {}  # interval index -> [M+1, N, N] tensor (dense)
        self._device = device
        n = ops[0][0].dm.num_dofs
        self.num_rows = self.num_columns = n

    @property
    def device(self):
        return self._device if self._device is not None \
            else self.ops[0][0].dm.device

    def getNumInterpolationNodes(self):
        return sum(len(n) for n in self.nodes)

    def get(self):
        return self._s

    def set(self, s, derivative=0):
        assert derivative == 0, 'derivative interpolation not supported'
        lo = self.intervals[0][0]
        hi = self.intervals[-1][1]
        assert lo <= s <= hi, (s, lo, hi)
        for k, (a, b) in enumerate(self.intervals):
            if s <= b or k == len(self.intervals) - 1:
                break
        self._k = k
        self._s = float(s)
        self._weights = lagrangeWeights(self.nodes[k], s)
        self._weightsDev = None

    def _intervalOps(self):
        assert self._k is not None, 'call set(s) first'
        return [d.get() for d in self.ops[self._k]]

    def _denseStack(self):
        k = self._k
        if k not in self._stacked:
            self._stacked[k] = torch.stack([op.data for op in
                                            self._intervalOps()])
        return self._stacked[k]

    def matvec(self, x, out=None):
        ops = self._intervalOps()
        if all(isinstance(op, Dense_LinearOperator) for op in ops):
            stack = self._denseStack()
            if self._weightsDev is None:
                self._weightsDev = torch.as_tensor(
                    self._weights, dtype=torch.float64, device=stack.device)
            return interp_matvec(self._weightsDev, stack, x, out=out)
        y = self._weights[0] * (ops[0] @ x)
        for w, op in zip(self._weights[1:], ops[1:]):
            y = y + w * (op @ x)
        if out is None:
            return y
        return out.copy_(y)

    def toarray(self):
        ops = self._intervalOps()
        A = self._weights[0] * np.asarray(ops[0].toarray())
        for w, op in zip(self._weights[1:], ops[1:]):
            A = A + w * np.asarray(op.toarray())
        return A

    @property
    def diagonal(self):
        ops = self._intervalOps()
        d = self._weights[0] * ops[0].diagonal
        for w, op in zip(self._weights[1:], ops[1:]):
            d = d + w * op.diagonal
        return d

    def assembleAll(self):
        """Assemble every node operator (the reference does this before
        HDF5 serialization, example_operator_interpolation.py)."""
        for intervalOps in self.ops:
            for d in intervalOps:
                d.get()

    def __repr__(self):
        return ('<multiIntervalInterpolationOperator {} intervals, {} nodes, '
                's={}>'.format(len(self.intervals),
                               self.getNumInterpolationNodes(), self._s))


class RangedFractionalKernel:
    """Fractional kernel with the order s ranging over an admissibleSet
    (ref kernelsCy.pyx RangedFractionalKernel; frozen via getFrozenKernel)."""

    def __init__(self, dim, admissibleOrders, horizon=np.inf, normalized=True,
                 errorBound=-1.0, M_min=1, M_max=20, xi=0.0):
        if not isinstance(admissibleOrders, admissibleSet):
            admissibleOrders = admissibleSet(admissibleOrders)
        self.dim = dim
        self.admissibleOrders = admissibleOrders
        self.horizon = horizon
        self.normalized = normalized
        self.errorBound = errorBound
        self.M_min = M_min
        self.M_max = M_max
        self.xi = xi

    @property
    def horizonValue(self):
        return self.horizon.value if hasattr(self.horizon, 'value') \
            else float(self.horizon)

    def getFrozenKernel(self, s):
        from .kernels import getFractionalKernel
        assert self.admissibleOrders.isAdmissible(s), s
        return getFractionalKernel(self.dim, float(s), horizon=self.horizonValue,
                                   normalized=self.normalized)

    def __repr__(self):
        return 'RangedFractionalKernel({}, s in {})'.format(
            self.dim, self.admissibleOrders)


def assembleRangedNonlocal(dm, kernel, matrixFormat='dense', **kwargs):
    """Build the interpolated operator family for a RangedFractionalKernel
    (ref DoFMaps.pyx:836-863); ``kwargs`` (zeroExterior, params, device)
    go to each node operator's assembleNonlocal."""
    aS = kernel.admissibleOrders
    s_left, s_right = aS.min, aS.max
    horizonValue = min(float(dm.mesh.diam), kernel.horizonValue)
    r = 0.5
    errorBound = kernel.errorBound
    if errorBound <= 0.:
        errorBound = 0.1 * float(dm.mesh.h) ** 0.5
    intervals, nodes = getChebyIntervalsAndNodes(
        s_left, s_right, horizonValue, r, errorBound,
        M_min=kernel.M_min, M_max=kernel.M_max, fixedXi=kernel.xi,
        variableOrder=True)
    ops = []
    for nodeSet in nodes:
        ops.append([delayedNonlocalOp(dm, kernel.getFrozenKernel(s),
                                      matrixFormat=matrixFormat, **kwargs)
                    for s in nodeSet])
    device = kwargs.get('device')
    return multiIntervalInterpolationOperator(
        intervals, nodes, ops,
        device=torch.device(device) if device is not None else None)


# ----------------------------------------------------------------- K24 ----

def interp_matvec(w, stack, x, out=None):
    """y [N] with y[n] = sum_m w[m] sum_k stack[m, n, k] x[k], for the
    weights w [M+1], the stacked node operators stack [M+1, N, N] and x
    [N], float64, contiguous, on one device.  Writes into ``out`` [N] when
    given.

    Kernel K24 (kernels/csrc/interp_matvec.cu) on CUDA tensors, the plain
    version on CPU tensors.  Replaces the einsum('m,mnk,k->n') of
    pynucleus_tpu/nl/operator_interpolation.py:262-281."""
    if stack.dim() != 3 or stack.dtype != torch.float64 \
            or not stack.is_contiguous() or stack.shape[1] != stack.shape[2]:
        raise ValueError('interp_matvec: stack must be a contiguous float64 '
                         '[M+1, N, N] tensor')
    M1, N, _ = stack.shape
    dev = stack.device
    for name, t, n in (('w', w, M1), ('x', x, N)):
        if t.dtype != torch.float64 or t.shape != (n,) \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f'interp_matvec: {name} must be a contiguous '
                             f'float64 [{n}] on {dev}')
    if out is None:
        out = torch.empty(N, dtype=torch.float64, device=dev)
    elif out.dtype != torch.float64 or out.shape != (N,) \
            or not out.is_contiguous() or out.device != dev:
        raise ValueError(f'interp_matvec: out must be a contiguous float64 '
                         f'[{N}] on {dev}')
    if dev.type == 'cpu':
        return _interp_matvec_plain(w, stack, x, out)
    if dev.type != 'cuda':
        raise ValueError(f'interp_matvec: unsupported device {dev}')
    lib = kernels.library()
    kernels.launches['interp_matvec'] += 1
    kernels.deviceLaunches['interp_matvec'] += 1
    p = kernels.ptr
    kernels.check(lib.interp_matvec(p(out), p(w), p(stack), p(x), M1, N,
                                    kernels.stream()))
    return out


# rows of the stack per step of the plain version (bounds its
# [M+1, rows, N] intermediate)
_PLAIN_ENTRIES = 1 << 24


def _interp_matvec_plain(w, stack, x, out):
    """Plain PyTorch version of :func:`interp_matvec` (any device): the
    weighted products summed over m and k, a block of rows at a time."""
    M1, N, _ = stack.shape
    step = max(_PLAIN_ENTRIES // max(M1 * N, 1), 1)
    for s in range(0, N, step):
        blk = stack[:, s:s + step] * x[None, None, :]
        out[s:s + step] = (w[:, None] * blk.sum(2)).sum(0)
    return out

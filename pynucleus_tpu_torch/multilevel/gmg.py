"""Geometric multigrid on tensors; kernels K10 and K26.

Port of pynucleus_tpu/multilevel/gmg.py: ``buildProlongation`` (host
numpy/scipy, code-identical), the level container, the V/W cycle
``_vcycle``/``_mg_apply`` with the smoother's pre- and post-sweep counts,
full multigrid ``_fmg_solve``, the loop of cycles ``_mg_solve``,
``multigrid`` (set-up and the host-driven solve loop, V, W, FMG_V and
FMG_W) and ``mgPreconditioner``, with the JAX package's three smoothers:
damped Jacobi (the default), Chebyshev and ILU.

The JAX package compiles the whole cycle into one XLA program; here the
host walks the levels and each step is a launch on the level's device:

  the level operator's matvec      torch.mv (dense), kernel K9 (CSR) or
                                   K8 (H2)
  the damped-Jacobi passes         kernel K10 :func:`jacobi_smooth`
  the Chebyshev steps              kernel K26 :func:`cheb_smooth`, with
                                   the host's float64 coefficients from
                                   rho(D^-1 A) of each level, estimated at
                                   set-up (base/linalg.py)
  the ILU steps                    host triangular solves of each level's
                                   factors (scipy's spilu), as in the JAX
                                   package, and K10's residual pass
  restriction P^T res, x += P xc   kernel K9 (CSR_LinearOperator)
  the coarsest level               torch.linalg.lu_solve on factors made
                                   once by torch.linalg.lu_factor (the JAX
                                   package's jax.scipy.linalg.lu_factor /
                                   lu_solve there, a library LU too)

Every level keeps its work vectors, made at set-up (FMG's at its first
use), so a cycle allocates only the coarsest level's solution.  Complex
levels (complex128 operators with float64 prolongations, runHelmholtz's
complex-shifted Laplacian) run the same steps on complex128 vectors:
K9's and K10's complex variants, a complex inverse diagonal and a complex
coarse LU; the Chebyshev smoother is float64 only (no JAX path smooths a
complex level with it).  FMG and ``_mg_solve`` compose the same steps: the
chain of P^T (K9), the coarse LU, then per level P (K9), the residual (the
level's matvec and K10) and a cycle; a loop of residuals and cycles whose
norm the host reads once per iteration.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from .. import kernels
from ..base.linalg import estimateSpectralRadius
from ..base.linear_operators import LinearOperator, CSR_LinearOperator
from ..base.solvers import iterative_solver, solverFactory, ilu_solver

__all__ = ['buildProlongation', 'multigrid', 'mgPreconditioner',
           'jacobi_smooth', 'cheb_smooth']


def buildProlongation(dmCoarse, dmFine):
    """P [fineDofs x coarseDofs]: evaluate coarse basis at fine dof nodes.

    Exact for nested Lagrange spaces; replaces the reference's
    buildRestrictionProlongation tables (restrictionProlongation.pyx).
    Assumes dmFine.mesh is the uniform refinement of dmCoarse.mesh (children
    of coarse cell c are fine cells c + k*C, k < 2^mdim, as produced by
    simplexMesh.refine).  The operator lives on dmFine's device."""
    meshC, meshF = dmCoarse.mesh, dmFine.mesh
    C = meshC.num_cells
    mdim = meshC.manifold_dim
    nchild = meshF.num_cells // C
    assert nchild * C == meshF.num_cells

    # physical coords of fine dof nodes per fine cell
    VF = meshF.vertices[meshF.cells]                     # [CF, m+1, dim]
    nodesF = np.einsum('jk,ckd->cjd', dmFine.localNodes, VF)  # [CF, dpeF, dim]

    # barycentric coords of those points within the parent coarse cell
    parents = np.tile(np.arange(C), nchild)
    VC = meshC.vertices[meshC.cells[parents]]            # [CF, m+1, dim]
    v0 = VC[:, 0, :]
    span = VC[:, 1:, :] - v0[:, None, :]                 # [CF, m, dim]
    if mdim == meshC.dim:
        spanInv = np.linalg.inv(span)
        xi = np.einsum('cjd,cdm->cjm', nodesF - v0[:, None, :], spanInv)
    else:
        G = np.einsum('cid,cjd->cij', span, span)
        rhs = np.einsum('cjd,cmd->cjm', nodesF - v0[:, None, :], span)
        xi = np.einsum('cjm,cmn->cjn', rhs, np.linalg.inv(G))
    bary = np.concatenate([1.0 - xi.sum(axis=2, keepdims=True), xi], axis=2)

    rows, cols, vals = [], [], []
    dofsF = dmFine.dofs
    dofsC = dmCoarse.dofs
    dpeF = dofsF.shape[1]
    CF = meshF.num_cells
    # evaluate all coarse basis functions at all fine nodes (per fine cell)
    baryFlat = bary.reshape(-1, mdim + 1)
    PHI = dmCoarse.evalPhi(baryFlat)                     # [dpeC, CF*dpeF]
    PHI = PHI.reshape(-1, CF, dpeF)                      # [dpeC, CF, dpeF]
    dpeC = PHI.shape[0]

    fRow = np.broadcast_to(dofsF[None, :, :], (dpeC, CF, dpeF))
    cCol = np.broadcast_to(dofsC[parents].T[:, :, None], (dpeC, CF, dpeF))
    mask = (fRow >= 0) & (cCol >= 0) & (np.abs(PHI) > 1e-14)
    rows = fRow[mask]
    cols = cCol[mask]
    vals = PHI[mask]
    P = sp.coo_matrix((vals, (rows, cols)),
                      shape=(dmFine.num_dofs, dmCoarse.num_dofs)).tocsr()
    # duplicates: same fine dof seen from several cells -> average (values
    # agree for nested spaces, so sum/count is exact)
    cnt = sp.coo_matrix((np.ones(len(rows)), (rows, cols)),
                        shape=P.shape).tocsr()
    P.sort_indices()
    cnt.sort_indices()
    P.data = P.data / cnt.data
    P.eliminate_zeros()
    return CSR_LinearOperator.from_scipy(P, device=dmFine.device)


# ----------------------------------------------------------------- K10 ----

_K10_MODES = ('zero', 'residual', 'update')


def jacobi_smooth(mode, x, b, Ax=None, Dinv=None, omega=None):
    """One damped-Jacobi vector pass of the V-cycle, into x [n] in place:

        'zero'      x = omega * (Dinv * b)              (first pre-sweep)
        'residual'  x = b - Ax
        'update'    x = x + omega * (Dinv * (b - Ax))

    vectors [n] on one device, all float64 or all complex128 (the
    complex-shifted Laplacian's levels); ``omega`` a float64 tensor [1]
    there.  Kernel K10 (Triton, kernels/jacobi_smooth.py; its complex
    variant for complex128) on CUDA tensors, the plain version on CPU
    tensors.  Replaces the Jacobi arithmetic of
    pynucleus_tpu/multilevel/gmg.py:_vcycle (lines 216-218, 220,
    235-236)."""
    if mode not in _K10_MODES:
        raise ValueError(f'jacobi_smooth: mode must be one of {_K10_MODES}')
    n = x.shape[0]
    need = {'zero': (b, Dinv), 'residual': (b, Ax),
            'update': (b, Ax, Dinv)}[mode]
    dtype = x.dtype if x.dtype == torch.complex128 else torch.float64
    for t in (x,) + need:
        if t is None or t.dtype != dtype or t.shape != (n,) \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f'jacobi_smooth ({mode}): contiguous {dtype} '
                             f'vectors [{n}] on {x.device} expected (all '
                             'float64 or all complex128)')
    if mode != 'residual' and (omega is None or omega.shape != (1,)
                               or omega.dtype != torch.float64
                               or omega.device != x.device):
        raise ValueError('jacobi_smooth: omega must be a float64 tensor [1] '
                         f'on {x.device}')
    if x.device.type == 'cpu':
        return _jacobi_smooth_plain(mode, x, b, Ax, Dinv, omega)
    if x.device.type != 'cuda':
        raise ValueError(f'jacobi_smooth: unsupported device {x.device}')
    if n == 0:
        return x
    from ..kernels import jacobi_smooth as k10
    kernels.launches['jacobi_smooth'] += 1
    kernels.deviceLaunches['jacobi_smooth'] += 1
    if x.is_complex():
        kernels.countVariant('jacobi_smooth:complex')
    k10.launch(k10.MODES[mode], x, b, b if Ax is None else Ax,
               b if Dinv is None else Dinv, b if omega is None else omega)
    return x


def _jacobi_smooth_plain(mode, x, b, Ax=None, Dinv=None, omega=None):
    """Plain PyTorch version of :func:`jacobi_smooth` (any device)."""
    if mode == 'zero':
        x.copy_(omega * (Dinv * b))
    elif mode == 'residual':
        torch.sub(b, Ax, out=x)
    else:
        x.add_(omega * (Dinv * (b - Ax)))
    return x


# ----------------------------------------------------------------- K26 ----

CHEB_MODES = ('zero', 'first', 'step')


def cheb_smooth(mode, x, b, d, Dinv, Ax=None, theta=None, c1=None, c2=None):
    """One Chebyshev step of the smoother, into x and d [n] in place:

        'zero'   d = (Dinv * b) / theta;  x = d        (first step, x = 0)
        'first'  d = (Dinv * (b - Ax)) / theta;  x += d
        'step'   d = c1 * d + c2 * (Dinv * (b - Ax));  x += d

    with Ax = A x from the level's apply; float64 vectors [n] on one
    device, theta, c1 and c2 host floats (:func:`_chebSchedule`).
    Kernel K26 (kernels/csrc/cheb_smooth.cu) on CUDA tensors, the plain
    version on CPU tensors.  Replaces the vector arithmetic of
    pynucleus_tpu/multilevel/gmg.py:170 _chebSmooth (lines 181-189)."""
    if mode not in CHEB_MODES:
        raise ValueError(f'cheb_smooth: mode must be one of {CHEB_MODES}')
    n = x.shape[0]
    need = (x, b, d, Dinv) + ((Ax,) if mode != 'zero' else ())
    for t in need:
        if t is None or t.dtype != torch.float64 or t.shape != (n,) \
                or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f'cheb_smooth ({mode}): contiguous float64 '
                             f'vectors [{n}] on {x.device} expected')
    scal = (theta,) if mode != 'step' else (c1, c2)
    if any(not isinstance(c, float) for c in scal):
        raise ValueError(f'cheb_smooth ({mode}): host float coefficients '
                         'expected')
    if x.device.type == 'cpu':
        return _cheb_smooth_plain(mode, x, b, d, Dinv, Ax, theta, c1, c2)
    if x.device.type != 'cuda':
        raise ValueError(f'cheb_smooth: unsupported device {x.device}')
    if n == 0:
        return x
    lib = kernels.library()
    kernels.launches['cheb_smooth'] += 1
    kernels.deviceLaunches['cheb_smooth'] += 1
    p = kernels.ptr
    kernels.check(lib.cheb_smooth(
        p(x), p(d), p(b), p(b if Ax is None else Ax), p(Dinv), n,
        CHEB_MODES.index(mode), 0.0 if theta is None else theta,
        0.0 if c1 is None else c1, 0.0 if c2 is None else c2,
        kernels.stream()))
    return x


def _cheb_smooth_plain(mode, x, b, d, Dinv, Ax=None, theta=None, c1=None,
                       c2=None):
    """Plain PyTorch version of :func:`cheb_smooth` (any device), in the
    JAX package's order of operations."""
    if mode == 'zero':
        d.copy_((Dinv * b) / theta)
        x.copy_(d)
    elif mode == 'first':
        d.copy_((Dinv * (b - Ax)) / theta)
        x.add_(d)
    else:
        d.copy_(c1 * d + c2 * (Dinv * (b - Ax)))
        x.add_(d)
    return x


def _chebSchedule(rho, degree, lowerFrac=0.25):
    """(theta, [(c1, c2)] * (degree - 1)): the host coefficients of
    ``degree`` Chebyshev steps for D^-1 A's eigenvalues in [lowerFrac rho,
    rho], computed as pynucleus_tpu/multilevel/gmg.py:174-187 computes
    them (c1 = rho_{k+1} rho_k, c2 = 2 rho_{k+1} / delta)."""
    lmax = rho
    lmin = lowerFrac * rho
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta
    rhok = 1.0 / sigma
    coeffs = []
    for _ in range(degree - 1):
        rhokp = 1.0 / (2.0 * sigma - rhok)
        coeffs.append((rhokp * rhok, 2.0 * rhokp / delta))
        rhok = rhokp
    return theta, coeffs


# ------------------------------------------------------------- the cycle --

# the smoother of the JAX package's default ('jacobi', {'omega': 2/3}):
# one damped-Jacobi sweep before and one after the coarse correction
OMEGA = 2.0 / 3.0


SMOOTHERS = ('jacobi', 'chebyshev', 'ilu')


def _smootherParameters(smoother):
    """(kind, omega, preSteps, postSteps) of a smoother given as the JAX
    package's multigrid takes it (gmg.py:340-350): a name, or a tuple
    (name, {'omega', 'presmoothingSteps', 'postsmoothingSteps'}) whose
    missing entries take the defaults (omega 2/3; three pre-sweeps for
    Chebyshev, one for the others; as many post-sweeps as pre-sweeps).
    The kinds are damped Jacobi, Chebyshev and ILU; the JAX package runs
    any other name as Jacobi, the port raises."""
    kind, params = (smoother, {}) if isinstance(smoother, str) else smoother
    if kind not in SMOOTHERS:
        raise NotImplementedError(f'smoother {kind!r}: the kinds are '
                                  f'{SMOOTHERS}')
    pre = params.get('presmoothingSteps', 3 if kind == 'chebyshev' else 1)
    return kind, params.get('omega', OMEGA), pre, \
        params.get('postsmoothingSteps', pre)


class _mgLevels:
    """Per-level A, P (to this level), damped-Jacobi inverse diagonal and
    work vectors, plus the coarse LU factors, the smoother's kind and
    sweep counts, and its per-level data: rho(D^-1 A) and the Chebyshev
    schedules of the pre- and post-sweeps (``rhos``, ``chebPre``,
    ``chebPost``), or the ILU preconditioners (``precOps``).
    ``Ps[l]`` maps level l-1 to l (``Ps[0]`` is None); ``omegaT`` is omega
    as a float64 tensor [1] on the device (K10's argument)."""

    def __init__(self, As, Ps, Dinvs, coarse_lu, coarse_piv, omega=OMEGA,
                 preSteps=1, postSteps=1, kind='jacobi', rhos=None,
                 precOps=None):
        self.As, self.Ps, self.Dinvs = As, Ps, Dinvs
        self.dev = As[-1].device
        # the levels' value type: complex128 for complex operators
        self.dtype = Dinvs[-1].dtype
        self.omegaT = torch.tensor([omega], dtype=torch.float64,
                                   device=self.dev)
        self.preSteps, self.postSteps = preSteps, postSteps
        self.kind, self.rhos, self.precOps = kind, rhos, precOps
        if kind == 'chebyshev':
            self.chebPre = [_chebSchedule(r, preSteps) for r in rhos]
            self.chebPost = [_chebSchedule(r, postSteps) for r in rhos]
        self.coarse_lu, self.coarse_piv = coarse_lu, coarse_piv
        self.work = [None]
        for lvl in range(1, len(As)):
            n, nc = As[lvl].num_rows, As[lvl - 1].num_rows
            self.work.append({'x': self._vec(n), 'Ax': self._vec(n),
                              'res': self._vec(n), 'defect': self._vec(nc)})
            if kind == 'chebyshev':
                self.work[lvl]['d'] = self._vec(n)
        self._fmg = None

    def _vec(self, k):
        return torch.empty(k, dtype=self.dtype, device=self.dev)

    def fmgWork(self):
        """FMG's vectors of every level below the finest (its right-hand
        side, iterate and residual), apart from the cycle's own: FMG adds
        a cycle's result into its iterate."""
        if self._fmg is None:
            self._fmg = [{'rhs': self._vec(A.num_rows), 'x': self._vec(
                A.num_rows), 'r': self._vec(A.num_rows)}
                for A in self.As[:-1]]
        return self._fmg


def _vcycle(levels, lvl, b, gamma=1, x=None):
    """Recursive V/W cycle on level ``lvl`` for the right-hand side b; the
    result goes into x (default: the level's own work vector), which is
    returned.  As in the JAX package, the first pre-sweep starts from
    x = 0, so a W cycle's second coarse visit repeats its first."""
    if lvl == 0:
        return _coarseSolve(levels, b, x)
    if x is None:
        x = levels.work[lvl]['x']
    defect = _smoothRestrict(levels, lvl, b, x)
    for _ in range(gamma):
        xc = _vcycle(levels, lvl - 1, defect, gamma)
    _prolongSmooth(levels, lvl, b, x, xc)
    return x


def _coarseSolve(levels, b, x=None):
    """Level 0: the LU solve, into x if given."""
    xc = torch.linalg.lu_solve(levels.coarse_lu, levels.coarse_piv,
                               b.unsqueeze(1)).squeeze(1)
    return xc if x is None else x.copy_(xc)


def _smoothRestrict(levels, lvl, b, x):
    """Level ``lvl``'s steps before the coarse visit: the pre-sweeps (the
    first from x = 0), the residual and its restriction; returns the
    defect."""
    A, Dinv, w = levels.As[lvl], levels.Dinvs[lvl], levels.work[lvl]
    if levels.kind == 'chebyshev':
        theta, coeffs = levels.chebPre[lvl]
        cheb_smooth('zero', x, b, w['d'], Dinv, theta=theta)
        _chebSteps(A, Dinv, w, b, x, coeffs)
    elif levels.kind == 'ilu':
        levels.precOps[lvl].matvec(b, out=x)
        _iluSteps(levels, lvl, b, x, levels.preSteps - 1)
    else:
        jacobi_smooth('zero', x, b, Dinv=Dinv, omega=levels.omegaT)
        for _ in range(levels.preSteps - 1):
            A.matvec(x, out=w['Ax'])
            jacobi_smooth('update', x, b, Ax=w['Ax'], Dinv=Dinv,
                          omega=levels.omegaT)
    A.matvec(x, out=w['Ax'])
    jacobi_smooth('residual', w['res'], b, Ax=w['Ax'])
    return levels.Ps[lvl].rmatvec(w['res'], out=w['defect'])   # R = P^T


def _chebSteps(A, Dinv, w, b, x, coeffs):
    """The Chebyshev steps after the first (K26 'step' after each apply)."""
    for c1, c2 in coeffs:
        A.matvec(x, out=w['Ax'])
        cheb_smooth('step', x, b, w['d'], Dinv, Ax=w['Ax'], c1=c1, c2=c2)


def _iluSteps(levels, lvl, b, x, steps):
    """``steps`` ILU sweeps x += M (b - A x), M the level's host
    preconditioner."""
    A, w = levels.As[lvl], levels.work[lvl]
    for _ in range(steps):
        A.matvec(x, out=w['Ax'])
        jacobi_smooth('residual', w['res'], b, Ax=w['Ax'])
        x.add_(levels.precOps[lvl].matvec(w['res']))


def _prolongSmooth(levels, lvl, b, x, xc):
    """Level ``lvl``'s steps after the coarse visit: x += P xc and the
    post-sweeps."""
    levels.Ps[lvl].matvec(xc, out=x, accumulate=True)
    _postSmooth(levels, lvl, b, x)


def _postSmooth(levels, lvl, b, x):
    """The post-sweeps from x, of the levels' smoother kind."""
    A, Dinv, w = levels.As[lvl], levels.Dinvs[lvl], levels.work[lvl]
    if levels.kind == 'chebyshev':
        theta, coeffs = levels.chebPost[lvl]
        A.matvec(x, out=w['Ax'])
        cheb_smooth('first', x, b, w['d'], Dinv, Ax=w['Ax'], theta=theta)
        _chebSteps(A, Dinv, w, b, x, coeffs)
    elif levels.kind == 'ilu':
        _iluSteps(levels, lvl, b, x, levels.postSteps)
    else:
        for _ in range(levels.postSteps):
            A.matvec(x, out=w['Ax'])
            jacobi_smooth('update', x, b, Ax=w['Ax'], Dinv=Dinv,
                          omega=levels.omegaT)


def _mg_apply(levels, b, gamma=1, out=None):
    """One cycle from x = 0 on the finest level; into ``out`` if given,
    else into a new vector."""
    return _vcycle(levels, len(levels.As) - 1, b, gamma,
                   torch.empty_like(b) if out is None else out)


def _fmg_solve(levels, b, gamma=1, out=None):
    """Full multigrid (pynucleus_tpu/multilevel/gmg.py:268): b restricted
    to every level, the coarsest solved by LU, then on each intermediate
    level the prolonged iterate corrected by one cycle on its residual; on
    the finest level only the prolongation and the post-sweeps.  Into
    ``out`` if given, else into a new vector."""
    nl = len(levels.As) - 1
    if nl < 1:
        raise ValueError('FMG needs at least two levels')
    fw = levels.fmgWork()
    rhss = [None] * nl + [b]
    for lvl in range(nl - 1, -1, -1):
        rhss[lvl] = levels.Ps[lvl + 1].rmatvec(rhss[lvl + 1],
                                               out=fw[lvl]['rhs'])
    x = _coarseSolve(levels, rhss[0], fw[0]['x'])
    for lvl in range(1, nl):
        x = levels.Ps[lvl].matvec(x, out=fw[lvl]['x'])
        Ax = levels.work[lvl]['Ax']
        levels.As[lvl].matvec(x, out=Ax)
        jacobi_smooth('residual', fw[lvl]['r'], rhss[lvl], Ax=Ax)
        x.add_(_vcycle(levels, lvl, fw[lvl]['r'], gamma))
    out = levels.Ps[nl].matvec(x, out=torch.empty_like(b) if out is None
                               else out)
    _postSmooth(levels, nl, b, out)
    return out


def _mg_solve(levels, b, x0, tol, maxiter, gamma=1):
    """Cycles from x0 until ||b - A x|| <= tol or ``maxiter`` cycles
    (pynucleus_tpu/multilevel/gmg.py:247, a while loop on the device
    there): each iteration x += cycle(b - A x), then the residual, whose
    norm the host reads.  Returns (x, iterations, the last residual
    norm)."""
    A = levels.As[-1]
    nl = len(levels.As) - 1
    x = x0.clone()
    Ax, r, xc = (torch.empty_like(b) for _ in range(3))
    A.matvec(x, out=Ax)
    jacobi_smooth('residual', r, b, Ax=Ax)
    rn = float(torch.linalg.norm(r))
    k = 0
    while rn > tol and k < maxiter:
        x.add_(_vcycle(levels, nl, r, gamma, xc))
        A.matvec(x, out=Ax)
        jacobi_smooth('residual', r, b, Ax=Ax)
        rn = float(torch.linalg.norm(r))
        k += 1
    return x, k, rn


class multigrid(iterative_solver):
    """MG solver over a level list [{'A':..., 'P':..., ('R':...)}, ...]
    ordered coarse -> fine (pynucleus_tpu/multilevel/gmg.py:302) with the
    damped-Jacobi, Chebyshev or ILU smoother, given as the JAX package's
    (a name or a tuple, :func:`_smootherParameters`)."""

    def __init__(self, hierarchy=None, smoother=('jacobi', {'omega': OMEGA})):
        self.hierarchyList = hierarchy
        A = hierarchy[-1]['A'] if hierarchy else None
        super().__init__(A)
        self.smootherType = smoother
        self.maxIter = 50
        self.cycle = 'V'

    def setup(self, A=None):
        levels = self.hierarchyList
        kind, omega, pre, post = _smootherParameters(self.smootherType)
        As, Ps, Dinvs = [], [], []
        for lvlNo, lvl in enumerate(levels):
            A_ = lvl['A']
            As.append(A_)
            Ps.append(lvl.get('P', None) if lvlNo > 0 else None)
            Dinvs.append((1.0 / A_.diagonal).contiguous())
        rhos = precOps = None
        if kind == 'chebyshev':
            if Dinvs[-1].is_complex():
                raise NotImplementedError('the Chebyshev smoother is float64 '
                                          'only')
            # rho(D^-1 A) of every level, the coarsest too, as the JAX
            # package estimates them (gmg.py:364-367)
            rhos = [estimateSpectralRadius(A_, Dinv_)
                    for A_, Dinv_ in zip(As, Dinvs)]
        elif kind == 'ilu':
            # host ILU factors of each level above the coarsest with fill
            # factor 10, the JAX package's choice for smoothing
            # (gmg.py:368-383)
            precOps = [None]
            for lvl in levels[1:]:
                s = ilu_solver(A=lvl['A'])
                s.fill_factor = 10.0
                s.setup()
                precOps.append(s.asPreconditioner())
        # a complex coarse matrix keeps its type (the complex-shifted
        # Laplacian's levels): the LU is complex then
        A0 = torch.as_tensor(levels[0]['A'].toarray(), device=As[-1].device)
        if not A0.is_complex():
            A0 = A0.to(torch.float64)
        lu, piv = torch.linalg.lu_factor(A0)
        self.levels = _mgLevels(As, Ps, Dinvs, lu, piv, omega, pre, post,
                                kind, rhos, precOps)
        self.initialized = True

    def _gamma(self):
        if self.cycle not in ('V', 'W', 'FMG_V', 'FMG_W'):
            raise NotImplementedError(f'cycle {self.cycle!r}')
        return 2 if self.cycle in ('W', 'FMG_W') else 1

    def solve(self, b):
        """Host-driven iteration over cycles, recording the residual
        history (the JAX package's loop: FMG counts as iteration 1 and
        seeds the cycles; the residuals list starts with the residual
        before the first cycle)."""
        gamma = self._gamma()
        A = self.A
        if self.cycle in ('FMG_V', 'FMG_W'):
            x = _fmg_solve(self.levels, b, gamma)
            iters = 1
        else:
            x = torch.zeros_like(b)
            iters = 0
        Ax = A.matvec(x)
        r = torch.empty_like(b)
        jacobi_smooth('residual', r, b, Ax=Ax)
        rn = float(torch.linalg.norm(r))
        residuals = [rn]
        while rn > self.tolerance and iters < self.maxIter:
            iters += 1
            x.add_(_mg_apply(self.levels, r, gamma=gamma))
            A.matvec(x, out=Ax)
            jacobi_smooth('residual', r, b, Ax=Ax)
            rn = float(torch.linalg.norm(r))
            residuals.append(rn)
        self.iterations = iters
        self.residuals = residuals
        return x

    def asPreconditioner(self, cycle='V'):
        return mgPreconditioner(self.levels, cycle)


class mgPreconditioner(LinearOperator):
    """One MG cycle as an operator (pynucleus_tpu/multilevel/gmg.py:422)."""

    def __init__(self, levels, cycle='V'):
        if cycle not in ('V', 'W'):
            raise NotImplementedError(f'cycle {cycle!r}')
        self.levels = levels
        self.cycle = cycle
        self.num_rows = self.num_columns = levels.As[-1].num_rows

    @property
    def device(self):
        return self.levels.As[-1].device

    def matvec(self, b, out=None):
        return _mg_apply(self.levels, b, gamma=2 if self.cycle == 'W' else 1,
                         out=out)


solverFactory.register('mg', multigrid, isMultilevelSolver=True)

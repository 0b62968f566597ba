"""Host-side quadrature rule construction (numpy/scipy).

Carried over from pynucleus_tpu/fem/quadrature.py, with the log-moment
weights of the s-derivative kernels (logWeights): rules are built once on
the host and copied to the device as static tables, so the port and the
JAX package quadrature with bit-identical nodes and weights.

Conventions:
  - 1D rules: nodes/weights on [0,1].
  - Gauss-Jacobi(k, alpha, beta): integrates f(x) x^alpha (1-x)^beta on [0,1].
  - simplex rules: barycentric nodes [Q, m+1]; weights sum to 1, so
    integral ~= vol(simplex) * sum_q w_q f(x_q).
"""
from __future__ import annotations

import numpy as np
from scipy.special import roots_jacobi, roots_legendre

__all__ = ['gauss01', 'gaussJacobi01', 'simplexDuffy', 'tensorRule',
           'simplexCompact', 'shiftedLegendreVandermonde', 'logWeights']


def gauss01(order):
    """Gauss-Legendre with polynomial exactness >= order, mapped to [0,1]."""
    k = max((order + 1) // 2 + ((order + 1) % 2 != 0), 1)
    x, w = roots_legendre(k)
    return (x + 1.0) / 2.0, w / 2.0


def gaussJacobi01(order, alpha, beta):
    """Nodes/weights integrating f(x) * x^alpha * (1-x)^beta dx on [0,1]."""
    k = max((order + 1) // 2 + ((order + 1) % 2 != 0), 1)
    # scipy roots_jacobi(n, a, b): weight (1-x)^a (1+x)^b on [-1,1]
    t, w = roots_jacobi(k, beta, alpha)
    x = (t + 1.0) / 2.0
    w = w * 0.5 ** (alpha + beta + 1.0)
    return x, w


def shiftedLegendreVandermonde(x, n):
    """[n, len(x)] table of shifted Legendre polynomials P~_k(x) on [0,1]
    (stable three-term recurrence)."""
    x = np.asarray(x, dtype=np.float64)
    V = np.zeros((n, x.shape[0]))
    V[0] = 1.0
    if n > 1:
        t = 2.0 * x - 1.0
        V[1] = t
        for k in range(1, n - 1):
            V[k + 1] = ((2 * k + 1) * t * V[k] - k * V[k - 1]) / (k + 1)
    return V


def _shiftedLegendreMomentDerivs(beta, n):
    """(mu, mu', mu'') of mu_k(beta) = int_0^1 x^beta P~_k(x) dx
    = prod_{j<k}(beta-j) / prod_{j=1..k+1}(beta+j), derivatives wrt beta,
    computed with dual-number products (safe at beta near integers)."""
    mu = np.zeros(n)
    d1 = np.zeros(n)
    d2 = np.zeros(n)
    for k in range(n):
        # numerator: prod (beta - j), j = 0..k-1; track (f, f', f'')
        f, fp, fpp = 1.0, 0.0, 0.0
        for j in range(k):
            a = beta - j
            f, fp, fpp = f * a, fp * a + f, fpp * a + 2.0 * fp
        # denominator: prod (beta + j), j = 1..k+1
        g, gp, gpp = 1.0, 0.0, 0.0
        for j in range(1, k + 2):
            a = beta + j
            g, gp, gpp = g * a, gp * a + g, gpp * a + 2.0 * gp
        # quotient rule for f/g and its two derivatives
        mu[k] = f / g
        d1[k] = (fp * g - f * gp) / g ** 2
        d2[k] = (fpp * g ** 2 - 2 * fp * gp * g - f * gpp * g
                 + 2 * f * gp ** 2) / g ** 3
    return mu, d1, d2


def logWeights(nodes, beta, logorder=1):
    """Weights u on the GIVEN nodes such that
        sum_q u_q f(x_q)  ~=  int_0^1 x^beta (ln x)^logorder f(x) dx
    for smooth f (moment matching against shifted Legendre polynomials;
    the log-moments are d^m/dbeta^m of the closed-form power moments).
    Used to integrate the log|x-y| factors of s-derivative kernels EXACTLY
    through the singularity-cancellation rules (the reference reaches the
    same accuracy implicitly because its per-s Gauss-Jacobi rules track s;
    ref kernelNormalization.pyx:363-380 evaluates the log factor
    pointwise)."""
    x = np.asarray(nodes, dtype=np.float64)
    n = x.shape[0]
    V = shiftedLegendreVandermonde(x, n)
    mu, d1, d2 = _shiftedLegendreMomentDerivs(float(beta), n)
    m = d1 if logorder == 1 else d2
    return np.linalg.solve(V, m)


def tensorRule(*rules):
    """Tensor product of 1D (nodes, weights) pairs.
    Returns nodes [Q, d] and weights [Q]."""
    grids = np.meshgrid(*[r[0] for r in rules], indexing='ij')
    nodes = np.stack([g.ravel() for g in grids], axis=1)
    w = np.ones(nodes.shape[0])
    wgrids = np.meshgrid(*[r[1] for r in rules], indexing='ij')
    for wg in wgrids:
        w = w * wg.ravel()
    return nodes, w


def simplexDuffy(order, mdim):
    """Simplex quadrature via the Duffy (collapsed-coordinate) transform:
    tensor Gauss-Jacobi absorbing the Jacobian powers (1-x)^{m-d-1}
    (ref quadrature.pyx simplexDuffyTransformation).  Exact for polynomials of
    total degree <= order.  Barycentric nodes [Q, m+1]; weights sum to 1."""
    if mdim == 0:
        return np.ones((1, 1)), np.ones(1)
    rules = [gaussJacobi01(order + mdim - d - 1, 0.0, mdim - d - 1)
             for d in range(mdim)]
    nodes, w = tensorRule(*rules)
    Q = nodes.shape[0]
    bary = np.zeros((Q, mdim + 1))
    for j in range(mdim - 1, -1, -1):
        b = nodes[:, j].copy()
        for k in range(j):
            b *= (1.0 - nodes[:, k])
        bary[:, j + 1] = b
    bary[:, 0] = 1.0 - bary[:, 1:].sum(axis=1)
    # weights already integrate over the Duffy cube with Jacobian; normalize
    # so that sum = 1 (reference multiplies by m! instead)
    fac = {1: 1.0, 2: 2.0, 3: 6.0}[mdim]
    w = w * fac
    return bary, w


# ---------------------------------------------------------------------------
# Compact symmetric simplex rules (Dunavant triangle / Keast tetrahedron
# orbits) — the role the Xiao-Gimbutas / Jaskowiec-Sukumar tables play in the
# reference (fem/PyNucleus_fem/quadrature.pyx:521 simplexXiaoGimbutas,
# js_data.py): far fewer points than the Duffy tensor rule at the same
# exactness, which enters QUADRATICALLY in the distant two-simplex pair cost.
# Orbit generators keep the data tiny; every table is verified ONCE against
# exact monomial integrals at first use and silently falls back to Duffy if
# it does not reproduce them to 5e-13.
# ---------------------------------------------------------------------------

def _orbits(mdim, entries, order=None):
    """Expand (values, weight) orbit entries into (bary [Q, mdim+1], w [Q]).
    Each entry's values is a tuple of barycentric coordinates; all distinct
    permutations are generated with equal weight.  When ``order`` is given,
    the per-orbit weights are REFITTED by solving the monomial moment
    system on the tabulated points (the tabulated weights only seed the
    least-squares) — this removes last-digit table imprecision and makes
    every rule exact to machine precision or rejected."""
    from itertools import permutations
    pts, ws, orbitOf = [], [], []
    for k, (vals, w) in enumerate(entries):
        seen = set()
        for p in permutations(vals):
            if p not in seen:
                seen.add(p)
                pts.append(p)
                ws.append(w)
                orbitOf.append(k)
    bary = np.asarray(pts, dtype=np.float64)
    w = np.asarray(ws)
    if order is not None:
        from itertools import product
        x = bary[:, 1:]
        orbitOf = np.asarray(orbitOf)
        nOrb = len(entries)
        rows, rhs = [], []
        for exps in product(range(order + 1), repeat=mdim):
            if sum(exps) > order:
                continue
            vals = np.prod(x ** np.asarray(exps), axis=1)
            rows.append(np.bincount(orbitOf, weights=vals,
                                    minlength=nOrb))
            rhs.append(_exactSimplexMonomial(exps))
        sol, *_ = np.linalg.lstsq(np.asarray(rows), np.asarray(rhs),
                                  rcond=None)
        w = sol[orbitOf]
    return bary, w


def _triRule(order):
    a = 1.0 / 3.0
    if order <= 1:
        return [((a, a, a), 1.0)]
    if order == 2:
        return [((2 / 3, 1 / 6, 1 / 6), 1 / 3)]
    if order == 3:
        return [((a, a, a), -27 / 48),
                           ((0.6, 0.2, 0.2), 25 / 48)]
    if order == 4:
        return [
            ((0.816847572980459, 0.091576213509771, 0.091576213509771),
             0.109951743655322),
            ((0.108103018168070, 0.445948490915965, 0.445948490915965),
             0.223381589678011)]
    if order == 5:
        return [
            ((a, a, a), 0.225),
            ((0.059715871789770, 0.470142064105115, 0.470142064105115),
             0.132394152788506),
            ((0.797426985353087, 0.101286507323456, 0.101286507323456),
             0.125939180544827)]
    if order == 6:
        return [
            ((0.873821971016996, 0.063089014491502, 0.063089014491502),
             0.050844906370207),
            ((0.501426509658179, 0.249286745170910, 0.249286745170910),
             0.116786275726379),
            ((0.636502499121399, 0.310352451033785, 0.053145049844816),
             0.082851075618374)]
    if order == 7:
        return [
            ((a, a, a), -0.149570044467670),
            ((0.479308067841923, 0.260345966079038, 0.260345966079038),
             0.175615257433204),
            ((0.869739794195568, 0.065130102902216, 0.065130102902216),
             0.053347235608839),
            ((0.638444188569809, 0.312865496004875, 0.048690315425316),
             0.077113760890257)]
    if order == 8:
        return [
            ((a, a, a), 0.144315607677787),
            ((0.081414823414554, 0.459292588292723, 0.459292588292723),
             0.095091634413245),
            ((0.658861384496480, 0.170569307751760, 0.170569307751760),
             0.103217370534718),
            ((0.898905543365938, 0.050547228317031, 0.050547228317031),
             0.032458497623198),
            ((0.008394777409958, 0.263112829634638, 0.728492392955404),
             0.027230314174435)]
    return None


def _tetRule(order):
    q = 0.25
    if order <= 1:
        return [((q, q, q, q), 1.0)]
    if order == 2:
        a, b = 0.585410196624969, 0.138196601125011
        return [((a, b, b, b), 0.25)]
    if order == 3:
        return [((q, q, q, q), -0.8),
                           ((0.5, 1 / 6, 1 / 6, 1 / 6), 0.45)]
    return None


def _exactSimplexMonomial(exps):
    """Integral of prod x_i^{e_i} over the unit simplex in R^d times d!
    (i.e. normalized so the simplex has measure 1):
    d! * prod(e_i!) / (d + sum e_i)!"""
    from math import factorial
    d = len(exps)
    num = 1.0
    for e in exps:
        num *= factorial(e)
    return factorial(d) * num / factorial(d + sum(exps))


def _ruleIsExact(bary, w, order, mdim, tol=5e-13):
    from itertools import product
    x = bary[:, 1:]                                # cartesian coords [Q, d]
    for exps in product(range(order + 1), repeat=mdim):
        if sum(exps) > order:
            continue
        got = float((w * np.prod(x ** np.asarray(exps), axis=1)).sum())
        if abs(got - _exactSimplexMonomial(exps)) > tol:
            return False
    return True


_compactCache = {}


def simplexCompact(order, mdim):
    """Minimal-point symmetric simplex rule of polynomial exactness
    ``order`` (Dunavant/Keast orbits), validated against exact monomial
    moments at first use; falls back to :func:`simplexDuffy` above the
    tabulated range (triangle: order 8, tet: order 3).  Same conventions as
    simplexDuffy: barycentric nodes, weights sum to 1."""
    key = (int(order), int(mdim))
    hit = _compactCache.get(key)
    if hit is not None:
        return hit
    entries = None
    if mdim == 2:
        entries = _triRule(int(order))
    elif mdim == 3:
        entries = _tetRule(int(order))
    rule = None
    if entries is not None:
        rule = _orbits(mdim, entries, order=int(order))
        if not _ruleIsExact(rule[0], rule[1], int(order), mdim):
            rule = None
    if rule is None:
        rule = simplexDuffy(order, mdim)
    _compactCache[key] = rule
    return rule

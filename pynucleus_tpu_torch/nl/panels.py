"""Host-side element-pair classification into panel buckets (numpy).

Carried over from pynucleus_tpu/nl/panels.py: the grid classification of
the dense assembly (classifyPairsDenseGrid), the classification of all cell
pairs with the horizon screen of a finite horizon (classifyPairsDense,
_horizonScreen: pairs fully inside, cut by, or beyond the horizon), the
zero-exterior boundary classification and the shared-vertex permutations.
The port must partition the cell pairs exactly as the JAX package does, so
the partitioning code is unchanged; only the shared-vertex permutations
come back per pattern group instead of one tuple per pair.  Every pair is
classified up front with vectorized numpy, permuted so shared vertices come
first, and grouped into buckets that each map to ONE batched device kernel
launch:

  bucket = (rule tables, vertIdx1 [P,nv1], vertIdx2 [P,nv2],
            dofRows [P,nPSI] global dofs (or DROP), volsym [P])

The quadrature order for distant pairs follows the reference's error model
(ref fractionalLaplacian1D.pyx:234-253): orders are rounded UP to the next
even value.
"""
from __future__ import annotations

import numpy as np

__all__ = ['permuteLocalDofs', 'classifyPairsDense', 'classifyPairsDenseGrid',
           'classifyPairList', 'classifyBoundaryPairs']


def permuteLocalDofs(dm, perm):
    """Local-dof permutation induced by a vertex permutation of the element
    (replaces ref PermutationIndexer + precomputedDoFPermutations,
    nonlocalOperator.pxd:39).  perm[k] = natural local vertex at rule slot k.
    Returns ld with ld[r] = natural local dof whose interpolation node
    coincides (in physical space) with permuted-element dof r.

    Fully generic: a permuted dof with barycentric node b (in permuted vertex
    order) sits at natural barycentric nat[perm[k]] = b[k]; we match against
    the element's natural node table."""
    nodes = dm.localNodes                      # [dpe, m+1]
    perm = np.asarray(perm)
    nat = np.zeros_like(nodes)
    nat[:, perm] = nodes
    # match rows of nat against rows of nodes
    ld = np.zeros(nodes.shape[0], dtype=np.int64)
    for r in range(nodes.shape[0]):
        dist = np.abs(nodes - nat[r][None, :]).max(axis=1)
        j = int(np.argmin(dist))
        assert dist[j] < 1e-12, (r, perm, nat[r], nodes)
        ld[r] = j
    return ld


def _cellAdjacency(cells, num_vertices):
    """Pairs of cells sharing >= 1 vertex (i < j)."""
    import scipy.sparse as sp
    C = cells.shape[0]
    nv = cells.shape[1]
    X = sp.coo_matrix(
        (np.ones(C * nv), (np.repeat(np.arange(C), nv), cells.ravel())),
        shape=(C, num_vertices)).tocsr()
    Adj = sp.triu((X @ X.T).tocoo(), k=1).tocoo()
    if Adj.nnz == 0:
        return np.zeros((0, 2), dtype=np.int64)
    return np.stack([Adj.row.astype(np.int64), Adj.col.astype(np.int64)],
                    axis=1)


def _sharedPermFromEq(eq):
    """Permutations for one vertex-match matrix eq [nv1, nv2]."""
    nv1, nv2 = eq.shape
    shared1, shared2 = [], []
    used2 = set()
    for a in range(nv1):
        for b in range(nv2):
            if b in used2:
                continue
            if eq[a, b]:
                shared1.append(a)
                shared2.append(b)
                used2.add(b)
                break
    rest1 = [a for a in range(nv1) if a not in shared1]
    rest2 = [b for b in range(nv2) if b not in used2]
    return (len(shared1),
            np.array(shared1 + rest1, dtype=np.int64),
            np.array(shared2 + rest2, dtype=np.int64))


def _sharedVertices(cells, pairs):
    """For cell pairs, the matched local vertex indices, grouped by pattern:
    returns (lut, inv) with lut[g] = (nShared, perm1, perm2) and inv[k] the
    group of pair k (the JAX package expands this to one tuple per pair).

    The boolean vertex-match matrix has only a handful of distinct patterns
    over all pairs, so the python permutation logic runs once per pattern
    and the assembly gathers each group's arrays at once."""
    if len(pairs) == 0:
        return [], np.zeros(0, dtype=np.int64)
    pairs = np.asarray(pairs)
    c1 = cells[pairs[:, 0]]                       # [T, nv]
    c2 = cells[pairs[:, 1]]
    eq = c1[:, :, None] == c2[:, None, :]         # [T, nv, nv]
    T, nv1, nv2 = eq.shape
    code = eq.reshape(T, -1).astype(np.int64) @ (1 << np.arange(nv1 * nv2))
    uniq, first, inv = np.unique(code, return_index=True, return_inverse=True)
    lut = [_sharedPermFromEq(eq[k]) for k in first]
    return lut, inv.reshape(-1)


def orderModelParams(dm, kernel, target_order=None):
    """Scalars of the distant-panel order model (ref fractionalLaplacian1D
    setKernel:203-233 / 2D:587-615)."""
    mesh = dm.mesh
    smin = max(-0.5 * (kernel.min_singularity + 1), 0.0)
    smax = max(-0.5 * (kernel.max_singularity + 1), 0.0)
    if target_order is None:
        if mesh.manifold_dim == 1:
            target_order = dm.polynomialOrder + 1 - smin
        else:
            target_order = 0.5
    H0 = mesh.diam / np.sqrt(8)
    hmin = mesh.hmin
    num_dofs = dm.num_dofs
    if mesh.manifold_dim == 1:
        quad_order_diagonal = max(int(np.ceil(
            ((target_order + 2.0) * np.log(num_dofs * H0) +
             (2.0 * smax - 1.0) * abs(np.log(hmin / H0))) / 0.8)), 2)
    else:
        smax2 = max(-0.5 * (kernel.max_singularity + 2), 0.0)
        quad_order_diagonal = max(int(np.ceil(
            (target_order + 1.0 + smax2) / 0.43 * abs(np.log(hmin / H0)))), 4)
    return dict(target_order=target_order, H0=H0, hmin=hmin,
                num_dofs=num_dofs, smin=smin, smax=smax,
                quad_order_diagonal=quad_order_diagonal)


def distantOrders(dm, kernel, hs, centers, di, dj, mp):
    """Quadrature orders for a list of distant pairs.

    Bandwidth-lean: per-CELL logs are precomputed (C values), so the only
    O(P) transcendental is one log of the squared pair distance; all O(P)
    arithmetic runs in float32 (orders are small integers -- f32 is plenty,
    and the pair count is O(C^2))."""
    mesh = dm.mesh
    diff = (centers[di] - centers[dj]).astype(np.float32)
    logd = 0.5 * np.log(np.einsum('pd,pd->p', diff, diff))
    logh = np.log(hs).astype(np.float32)                      # [C]
    if mesh.manifold_dim == 1:
        sval = max(mp['smin'], mp['smax'])
        H0 = mp['H0']
        c = np.float32((mp['target_order'] + 2.0)
                       * np.log(mp['num_dofs'] * H0))
        lH = np.abs(logh - np.float32(np.log(H0)))            # [C]
        logdh1 = logd - logh[di]
        logdh2 = logd - logh[dj]
        num1 = c + (2 * sval - 1) * lH[dj] - 2 * sval * logdh2
        num2 = c + (2 * sval - 1) * lH[di] - 2 * sval * logdh1
        o1 = np.ceil(num1 / (np.maximum(logdh1, 0) + np.float32(0.8)))
        o2 = np.ceil(num2 / (np.maximum(logdh2, 0) + np.float32(0.8)))
        return np.maximum(np.maximum(o1, o2), 2).astype(np.int64)
    # 2D model (ref fractionalLaplacian2D.pyx:622-641)
    s = np.float32(max(-0.5 * (kernel.max_singularity + 2), 0.0))
    H0 = mp['H0']
    logdh1 = logd - logh[di]
    logdh2 = logd - logh[dj]
    c = np.float32((0.5 * mp['target_order'] + 0.5)
                   * np.log(mp['num_dofs'] * H0 ** 2))
    lH = np.abs(logh - np.float32(np.log(H0)))                # [C]
    l1 = lH[di]
    l2 = lH[dj]
    lmin = np.maximum(l1, l2)
    o1 = np.ceil((c + (s - 1.0) * l2 + lmin - s * logdh2) /
                 (np.maximum(logdh1, 0) + np.float32(0.4)))
    o2 = np.ceil((c + (s - 1.0) * l1 + lmin - s * logdh1) /
                 (np.maximum(logdh2, 0) + np.float32(0.4)))
    return np.maximum(np.maximum(o1, o2), 2).astype(np.int64)


def classifyPairList(dm, kernel, pi, pj, target_order=None):
    """Classify an explicit cell-pair list into id / touching / distant
    buckets (pynucleus_tpu/nl/panels.py classifyPairList, infinite
    horizon).  The H2 near field passes the identical and vertex-sharing
    pairs through it; 'touching' is (pairs [P, 2], (lut, group)) as
    _sharedVertices returns it."""
    if kernel.finiteHorizon:
        raise NotImplementedError('finite horizon')
    mesh = dm.mesh
    cells = mesh.cells
    mp = orderModelParams(dm, kernel, target_order)

    pi = np.asarray(pi, dtype=np.int64)
    pj = np.asarray(pj, dtype=np.int64)
    idMask = pi == pj
    ids = pi[idMask]

    rest_i = pi[~idMask]
    rest_j = pj[~idMask]
    c1 = cells[rest_i]
    c2 = cells[rest_j]
    nShared = (c1[:, :, None] == c2[:, None, :]).any(axis=2).sum(axis=1)
    touchMask = nShared >= 1

    touching_pairs = np.stack([rest_i[touchMask], rest_j[touchMask]], axis=1)
    sharedInfo = _sharedVertices(cells, touching_pairs)

    di = rest_i[~touchMask]
    dj = rest_j[~touchMask]
    centers = mesh.vertices[cells].mean(axis=1)
    hs = _cellDiameter(mesh.vertices, cells)
    orders = distantOrders(dm, kernel, hs, centers, di, dj, mp) \
        if len(di) else np.zeros(0, dtype=np.int64)
    orders = ((orders + 1) // 2) * 2

    return {'id': ids,
            'touching': (touching_pairs, sharedInfo),
            'distant': (di, dj, orders),
            **mp}


def classifyPairsDense(dm, kernel, target_order=None):
    """Classify all (i <= j) cell pairs for a symmetric kernel.

    Returns dict with keys:
      'id'        -> ids of identical-cell pairs
      'touching'  -> (pairs, (lut, group)) touching pairs with shared-vertex
                     perms
      'distant'   -> (i, j, orders) per remaining pair (horizon-screened)
      'cut'       -> (i, j, orders) of the pairs cut by a finite horizon
      plus the order-model scalars.
    """
    mesh = dm.mesh
    cells = mesh.cells
    C = mesh.num_cells
    verts = mesh.vertices
    mp = orderModelParams(dm, kernel, target_order)

    touching_pairs = _cellAdjacency(cells, mesh.num_vertices)
    sharedInfo = _sharedVertices(cells, touching_pairs)

    centers = verts[cells].mean(axis=1)                       # [C, dim]
    hs = _cellDiameter(verts, cells)                          # [C]

    iu, ju = np.triu_indices(C, k=1)
    mask_touch = np.zeros(len(iu), dtype=bool)
    if len(touching_pairs):
        keys = iu.astype(np.int64) * C + ju.astype(np.int64)
        tkeys = touching_pairs[:, 0] * C + touching_pairs[:, 1]
        mask_touch = np.isin(keys, tkeys)
    di = iu[~mask_touch]
    dj = ju[~mask_touch]

    # horizon screening (extreme distances; ref getPanelType + IGNORED);
    # pairs CUT by the horizon get exact interval clipping (1D) instead of
    # the discontinuous-indicator quadrature (ref interactionDomains
    # retriangulation)
    ci = cj = np.zeros(0, dtype=np.int64)
    if kernel.finiteHorizon and len(di):
        di, dj, ci, cj = _horizonScreen(verts, cells, centers, di, dj,
                                        kernel)

    orders = distantOrders(dm, kernel, hs, centers, di, dj, mp) \
        if len(di) else np.zeros(0, dtype=np.int64)
    orders = ((orders + 1) // 2) * 2
    cutOrders = distantOrders(dm, kernel, hs, centers, ci, cj, mp) \
        if len(ci) else np.zeros(0, dtype=np.int64)
    cutOrders = np.minimum(((cutOrders + 1) // 2) * 2 + 2, 16)

    return {
        'id': np.arange(C, dtype=np.int64),
        'touching': (touching_pairs, sharedInfo),
        'distant': (di, dj, orders),
        'cut': (ci, cj, cutOrders),
        **mp,
    }


def _d2f32(centers32, ii, jj):
    """Squared f32 center distance with a FIXED expression — replicated
    verbatim on the device grid so both sides partition pairs identically."""
    acc = None
    for d in range(centers32.shape[1]):
        dd = centers32[ii, d] - centers32[jj, d]
        acc = dd * dd if acc is None else acc + dd * dd
    return acc


def classifyPairsDenseGrid(dm, kernel, target_order=None,
                           gridOrders=(2, 4)):
    """Sparse classification for the grid-based dense assembly: O(C log C +
    near pairs) instead of materializing all O(C^2) pairs.

    The device grid (assembly._grid_distant_pass) handles every pair with
    f32 center distance >= the lowest pass threshold; here we find only
      - touching/id pairs (sparse vertex adjacency),
      - the correction pairs below the threshold (KD-tree radius search),
      - the pass thresholds themselves (gap midpoints over the candidate
        distances, verified against a conservative worst-case order bound
        so no pair outside the search radius can need order > min(passes)).

    Replaces the reference's O(C^2) outer loop (nonlocalAssembly pxi:1387)
    for the full-space symmetric constant-order case."""
    from scipy.spatial import cKDTree
    mesh = dm.mesh
    cells = mesh.cells
    C = mesh.num_cells
    verts = mesh.vertices
    assert not kernel.finiteHorizon
    mp = orderModelParams(dm, kernel, target_order)

    touching_pairs = _cellAdjacency(cells, mesh.num_vertices)
    sharedGroups = _sharedVertices(cells, touching_pairs)

    centers = verts[cells].mean(axis=1)
    centers32 = centers.astype(np.float32)
    hs = _cellDiameter(verts, cells)
    logh = np.log(hs)
    hmax = float(hs.max())
    oMin = min(gridOrders)

    def worstOrderBeyond(dist):
        """Upper bound on the quadrature order of ANY pair at center
        distance >= dist: probe the order model with one side swept over
        all realized cells and the other fixed at each h-extreme (the model
        is monotone decreasing in distance but not monotone in h, so both
        extremes are probed)."""
        cenP = np.zeros((C, centers.shape[1]))
        cenP[:, 0] = dist
        cenProbe = np.concatenate([np.zeros((C, centers.shape[1])), cenP])
        hsProbe = np.concatenate([hs, hs])
        jj = np.arange(C, dtype=np.int64)
        worst = 0
        for anchor in (int(np.argmax(hs)), int(np.argmin(hs))):
            ii = np.full(C, anchor, dtype=np.int64)
            o = distantOrders(dm, kernel, hsProbe, cenProbe, ii, C + jj, mp)
            worst = max(worst, int(o.max()))
        return worst

    diam = float(mesh.diam)

    def formulaCut(o):
        """Smallest distance beyond which the conservative bound guarantees
        order <= o (bisection on the monotone-in-distance order model); None
        if no such distance below 2*diam."""
        lo, hi = 0.25 * float(hs.min()), 2.0 * diam
        if worstOrderBeyond(hi) > o:
            return None
        if worstOrderBeyond(lo) <= o:
            return lo
        for _ in range(20):
            mid = np.sqrt(lo * hi)
            if worstOrderBeyond(mid) <= o:
                hi = mid
            else:
                lo = mid
        return hi

    # formula thresholds per pass (device-side pass assignment uses the
    # same f32 d2 on both sides of each inter-pass boundary, so no
    # consistency machinery is needed there)
    fCuts = {}
    for o in sorted(gridOrders):
        c = formulaCut(o)
        if c is not None:
            fCuts[o] = c

    # adaptive extension: the host bucket path pays O(1) per correction
    # pair, so when the innermost cut still contains too many pairs
    # (estimated from the mean cell density -- pairs(r) ~ C^2 ball_d(r) /
    # 2 vol), add higher-order grid passes until the correction set is
    # bucket-sized.  The cut radius shrinks ~exp(-c/o(o+2)) per step while
    # a pass costs the device O(C^2 Q(o)^2), so a handful of passes always
    # suffices (order 8 cap: the compact orbit tables end there; Duffy
    # fallback rules would make a full-grid pass Q^2-prohibitive).
    def pairEstimate(r):
        md = mesh.manifold_dim
        bv = 2.0 * r if md == 1 else \
            (np.pi * r * r if md == 2 else 4.0 / 3.0 * np.pi * r ** 3)
        return 0.5 * C * C * min(bv / max(meshVol, 1e-300), 1.0)

    meshVol = float(mesh.simplexVolumes().sum())
    CORRECTION_BUDGET = 6.0e6
    while fCuts and pairEstimate(fCuts[max(fCuts)]) > CORRECTION_BUDGET \
            and max(fCuts) < 8:
        oNext = max(fCuts) + 2
        c = formulaCut(oNext)
        if c is None or c >= fCuts[max(fCuts)]:
            break
        fCuts[oNext] = c
    oMaxGrid = max(fCuts) if fCuts else min(gridOrders)
    rSearch = (fCuts[oMaxGrid] * 1.02) if fCuts else 2.0 * diam
    rSearch = max(rSearch, 2.5 * hmax)

    tree = cKDTree(centers)
    cand = tree.query_pairs(rSearch, output_type='ndarray')
    if len(cand):
        ci, cj = cand[:, 0].astype(np.int64), cand[:, 1].astype(np.int64)
        # drop touching pairs from the candidate set (searchsorted against
        # the small sorted touching-key set; np.isin would sort the
        # multi-million candidate array instead)
        keys = np.minimum(ci, cj) * C + np.maximum(ci, cj)
        if len(touching_pairs):
            tkeys = np.sort(touching_pairs[:, 0] * C + touching_pairs[:, 1])
            pos = np.searchsorted(tkeys, keys)
            pos = np.minimum(pos, len(tkeys) - 1)
            far = tkeys[pos] != keys
        else:
            far = np.ones(len(keys), dtype=bool)
        ci, cj = ci[far], cj[far]
    else:
        ci = cj = np.zeros(0, dtype=np.int64)
    candOrders = distantOrders(dm, kernel, hs, centers, ci, cj, mp) \
        if len(ci) else np.zeros(0, dtype=np.int64)
    candOrders = ((candOrders + 1) // 2) * 2
    d2c = _d2f32(centers32, ci, cj) if len(ci) else \
        np.zeros(0, dtype=np.float32)
    d2t = _d2f32(centers32, touching_pairs[:, 0], touching_pairs[:, 1]) \
        if len(touching_pairs) else np.zeros(0, dtype=np.float32)
    rs2 = np.float32(rSearch * rSearch)

    def gapThreshold(o):
        """Correction boundary: gap midpoint above the realized d2 of every
        touching/higher-order candidate, so host (corrections) and device
        (grid) partition pairs identically despite f32 FMA wobble."""
        excl = np.concatenate([d2t, d2c[candOrders > o],
                               np.zeros(1, dtype=np.float32)])
        v = float(excl.max())
        while True:
            above = d2c[d2c > v]
            nxt = float(above.min()) if len(above) else float(rs2)
            if nxt <= v:
                return None
            if (nxt - v) > 1e-6 * max(nxt, 1e-30):
                return 0.5 * (v + nxt)
            v = nxt

    passes = []
    hi = np.float32(np.inf)
    orderedCuts = sorted(fCuts)          # ascending grid orders
    for idx, o in enumerate(orderedCuts):
        if o == oMaxGrid:
            t = gapThreshold(o)          # realized boundary, gap-safe
        else:
            t = fCuts[o] ** 2
        if t is None or np.float32(t) >= hi:
            continue
        passes.append((int(o), np.float32(t), hi))
        hi = np.float32(t)
    if passes and passes[-1][0] != oMaxGrid:
        # the gap-safe innermost pass got dropped; without it the correction
        # boundary would sit on a raw formula value (host/device f32 wobble)
        passes = []
    if passes:
        tMin = min(t for (_, t, _) in passes)
        keep = d2c < tMin
        di, dj, orders = ci[keep], cj[keep], candOrders[keep]
    else:
        # no usable pass: everything found is a correction; the bucket path
        # assembles all candidate pairs (grid contributes nothing)
        di, dj, orders = ci, cj, candOrders

    return {
        'id': np.arange(C, dtype=np.int64),
        'touching': (touching_pairs, sharedGroups),
        'distant': (di, dj, orders),
        'cut': (np.zeros(0, dtype=np.int64),) * 3,
        'gridPasses': passes,
        **mp,
    }


def _cellDiameter(verts, cells):
    V = verts[cells]
    m = cells.shape[1] - 1
    h = np.zeros(len(cells))
    for i in range(m + 1):
        for j in range(i + 1, m + 1):
            h = np.maximum(h, np.linalg.norm(V[:, i] - V[:, j], axis=1))
    return h


def _horizonScreen(verts, cells, centers, di, dj, kernelOrHv):
    """Split non-touching pairs into fully-within-horizon (di, dj) and
    horizon-cut (ci, cj); pairs entirely beyond the horizon are dropped
    (ref getPanelType IGNORED, interactionDomains getRelativePosition).

    For non-Euclidean interaction balls (ballInf, ball1, the ellipse) the
    screen uses the enclosed/enclosing Euclidean radii ball2(rIn) <=
    interaction <= ball2(rOut): pairs with dmin >= rOut cannot interact,
    pairs with dmax < rIn interact fully, everything between is treated as
    cut.  A variable horizon delta(x) brackets the pairs with [min delta,
    max delta]: rIn from horizonMin, rOut from horizonValue (the largest).

    A cheap center-distance screen with cell radii r = max|v - center|
    bounds dc - ri - rj <= dmin <= dmax <= dc + ri + rj, so the exact
    O(nv^2) vertex-pair distances are only computed on the ambiguous band
    around the horizon."""
    if np.isscalar(kernelOrHv):
        rIn = rOut = kernelOrHv
    elif getattr(kernelOrHv, 'variableHorizon', False):
        kernel = kernelOrHv
        dim = verts.shape[1]
        inter = kernel.interaction
        rIn = inter.innerRadius2(kernel.horizonMin, dim)
        rOut = inter.outerRadius2(kernel.horizonValue, dim)
    else:
        kernel = kernelOrHv
        hv = kernel.horizonValue
        dim = verts.shape[1]
        inter = kernel.interaction
        rIn = inter.innerRadius2(hv, dim)
        rOut = inter.outerRadius2(hv, dim)
    radii = np.linalg.norm(
        verts[cells] - centers[:, None, :], axis=-1).max(axis=1)
    dc = np.linalg.norm(centers[di] - centers[dj], axis=-1)
    rsum = radii[di] + radii[dj]
    sureIgnored = dc - rsum >= rOut        # implies dmin >= rOut
    sureInside = dc + rsum < rIn           # implies dmax < rIn
    band = ~(sureIgnored | sureInside)
    bi, bj = di[band], dj[band]
    dmin, dmax = _pairMinMaxDistance(verts, cells, bi, bj)
    keep = dmin < rOut
    cut = keep & (dmax >= rIn)
    bandFull = keep & ~cut
    full = np.zeros(len(di), dtype=bool)
    full[~band] = sureInside[~band]
    full[band] = bandFull
    return di[full], dj[full], bi[cut], bj[cut]


def _pairMinMaxDistance(verts, cells, di, dj):
    """The smallest and the largest vertex distance of each cell pair (di,
    dj), equal to pynucleus_tpu/nl/panels.py _pairMinDistance and
    _pairMaxDistance: each squared distance sums its coordinates in order,
    and sqrt, being monotone and correctly rounded, takes the extremes of
    the squares to those of the distances.  One coordinate array at a time
    over the pairs, and no [P, nv, nv, dim] temporary."""
    cv = verts[cells].transpose(1, 2, 0)                      # [nv, dim, C]
    X = [[c[di] for c in v] for v in cv]
    Y = [[c[dj] for c in v] for v in cv]
    lo = hi = None
    for x in X:
        for y in Y:
            r2 = (x[0] - y[0]) ** 2
            for d in range(1, len(x)):
                r2 += (x[d] - y[d]) ** 2
            if lo is None:
                lo, hi = r2, r2.copy()
            else:
                np.minimum(lo, r2, out=lo)
                np.maximum(hi, r2, out=hi)
    return np.sqrt(lo), np.sqrt(hi)


def _boundaryOrderModel(d, h1, h2, sval, c0, H0, horizon, hcut=None):
    """Per-pair boundary quad order (same model as the volume distant one;
    ref fractionalLaplacian1D.pyx:644-669 boundary getQuadOrder), rounded up
    to even.  d/h1/h2 broadcastable; hcut = per-pair cut half-width for the
    finite-horizon tripling (None = infinite horizon)."""
    logdh1 = np.maximum(np.log(d / h1), 0.0)
    logdh2 = np.maximum(np.log(d / h2), 0.0)
    o1 = np.ceil((c0 + (2 * sval - 1) * np.abs(np.log(h2 / H0)) -
                  2 * sval * np.log(d / h2)) / (logdh1 + 0.8))
    o2 = np.ceil((c0 + (2 * sval - 1) * np.abs(np.log(h1 / H0)) -
                  2 * sval * np.log(d / h1)) / (logdh2 + 0.8))
    orders = np.maximum(np.maximum(o1, o2), 2)
    if hcut is not None:
        cut = (d - hcut < horizon) & (horizon < d + hcut)
        orders = np.where(cut, orders * 3, orders)
    return ((orders.astype(np.int64) + 1) // 2) * 2


def boundaryOrderModelParams(dm, kernel, target_order=None):
    """Scalars of the BOUNDARY (zeroExterior surface) order model -- shared
    by classifyBoundaryPairs and the cluster-union surface quadrature so the
    two evaluate singular (cell, own-facet) panels with IDENTICAL rules.
    For the regional operator (s > 1/2, Neumann dofs) both terms diverge
    individually and only their difference is finite: the reference gets
    exact cancellation by reusing one local_matrix_zeroExterior in both
    loops (nonlocalAssembly pxi:1842-1917); identical rule parameters are
    our equivalent."""
    mesh = dm.mesh
    p = dm.polynomialOrder
    smin = max(0.5 * (-kernel.min_singularity), 0.0)
    smax = max(0.5 * (-kernel.max_singularity), 0.0)
    if target_order is None:
        target_order = p + 1 - smin
    H0 = mesh.diam / np.sqrt(8)
    hmin = mesh.hmin
    num_dofs = dm.num_dofs
    if mesh.manifold_dim >= 2:
        quad_order_diagonal = max(int(np.ceil(
            (target_order + 1.0 + smax) / 0.43 * abs(np.log(hmin / H0)))), 4)
    else:
        quad_order_diagonal = max(int(np.ceil(
            ((target_order + 1.0) * np.log(num_dofs * H0) +
             (2.0 * smax - 1.0) * abs(np.log(hmin / H0))) / 0.8)), 2)
    return dict(target_order=target_order, H0=H0, hmin=hmin,
                num_dofs=num_dofs, smin=smin, smax=smax,
                quad_order_diagonal=quad_order_diagonal)


def classifyBoundaryPairs(dm, surface, kernel, target_order=None,
                          correctionsOnly=False):
    """(cell, surface-cell) pairs for the zeroExterior term
    (ref nonlocalAssembly getDense zeroExterior loop + boundary getQuadOrder,
    fractionalLaplacian1D.pyx:644-669).  Kernel here is the BOUNDARY kernel.
    Returns ('vertex' touching pairs with perms, 'distant' with orders).

    correctionsOnly=True (the grid-consumer contract): 'distant' holds ONLY
    the pairs needing order > 4 — the order<=4 grid pass covers everything
    else implicitly, so the O(C*S) pair enumeration and per-pair order model
    never materialize.  Pairs are screened by a conservative distance
    threshold (the order model is nonincreasing in d and corner-monotone in
    (h1, h2), so a bisection at the (h1, h2) corner extremes bounds it)."""
    mesh = dm.mesh
    cells = mesh.cells
    verts = mesh.vertices
    C = mesh.num_cells
    S = surface.num_cells
    scells = surface.cells

    mpb = boundaryOrderModelParams(dm, kernel, target_order)
    target_order = mpb['target_order']
    H0 = mpb['H0']
    hmin = mpb['hmin']
    num_dofs = mpb['num_dofs']
    smin, smax = mpb['smin'], mpb['smax']
    quad_order_diagonal = mpb['quad_order_diagonal']

    # touching = cell contains a vertex of the surface simplex.  Incidence
    # detection: only cells holding a boundary vertex can touch, so the
    # candidate x surface comparison is O(C + nBnd*S), never C*S.
    if kernel.singularityValue >= 0:
        # smooth boundary kernels (gaussian/exponential potentials) need no
        # singularity-cancelling transformation: plain Gauss on every pair
        ti = tj = np.zeros(0, dtype=np.int64)
    else:
        bverts = np.unique(scells)
        cand = np.nonzero(np.isin(cells, bverts).any(axis=1))[0]
        m = (cells[cand][:, :, None, None] ==
             scells[None, None, :, :]).any(axis=(1, 3))       # [nCand, S]
        ti, tj = np.nonzero(m)
        ti = cand[ti]

    touching = []
    perms = []
    for k in range(len(ti)):
        c1 = cells[ti[k]]
        c2 = scells[tj[k]]
        shared1, shared2 = [], []
        used2 = set()
        for a, v1 in enumerate(c1):
            for b, v2 in enumerate(c2):
                if b in used2:
                    continue
                if v1 == v2:
                    shared1.append(a)
                    shared2.append(b)
                    used2.add(b)
                    break
        rest1 = [a for a in range(len(c1)) if a not in shared1]
        rest2 = [b for b in range(len(c2)) if b not in used2]
        touching.append((ti[k], tj[k]))
        perms.append((len(shared1),
                      np.array(shared1 + rest1, dtype=np.int64),
                      np.array(shared2 + rest2, dtype=np.int64)))

    centers1 = verts[cells].mean(axis=1)                      # [C, dim]
    centers2 = verts[scells].mean(axis=1) if scells.shape[1] > 1 else \
        verts[scells[:, 0]]                                   # [S, dim]
    h1c = _cellDiameter(verts, cells)                         # [C]
    h2c = _cellDiameter(verts, scells) if scells.shape[1] > 1 else \
        np.full(S, hmin)                                      # [S]
    sval = max(smin, smax)
    c0 = (target_order + 1.0) * np.log(num_dofs * H0)
    horizon = kernel.horizonValue if kernel.finiteHorizon else np.inf

    # squared center distances, per-dim accumulation (no [C,S,dim] temp)
    d2 = np.zeros((C, S))
    for dd in range(centers1.shape[1]):
        diff = centers1[:, dd][:, None] - centers2[:, dd][None, :]
        d2 += diff * diff

    def exactOrders(di, dj):
        d = np.sqrt(d2[di, dj])
        h1, h2 = h1c[di], h2c[dj]
        hcut = 0.5 * np.maximum(h1, h2) if kernel.finiteHorizon else None
        return _boundaryOrderModel(d, h1, h2, sval, c0, H0, horizon, hcut)

    if correctionsOnly:
        # conservative screen: bisect the largest d at which the order model
        # can still exceed 4, over the (h1, h2) corner extremes (the model
        # is piecewise-monotone in log h1/log h2, so corners bound it)
        corners = [(a, b) for a in (h1c.min(), h1c.max())
                   for b in (h2c.min(), h2c.max())]
        dgrid = np.geomspace(max(hmin * 1e-3, 1e-12), 8.0 * mesh.diam, 4096)
        worst = np.zeros(len(dgrid), dtype=np.int64)
        for a, b in corners:
            worst = np.maximum(worst, _boundaryOrderModel(
                dgrid, a, b, sval, c0, H0, np.inf))
        ok = worst <= 4
        dthr = dgrid[np.argmax(ok)] if ok.any() else np.inf
        screen = d2 < min(1.05 * dthr, 8.0 * mesh.diam) ** 2
        if kernel.finiteHorizon and np.isfinite(horizon):
            hmax = 0.5 * max(h1c.max(), h2c.max())
            dmat = np.sqrt(d2)
            screen |= (dmat - hmax < horizon) & (horizon < dmat + hmax)
        if len(ti):
            screen[ti, tj] = False
        di, dj = np.nonzero(screen)
        orders = exactOrders(di, dj)
        sel = orders > 4
        di, dj, orders = di[sel], dj[sel], orders[sel]
    else:
        mask = np.zeros((C, S), dtype=bool)
        if len(ti):
            mask[ti, tj] = True
        di, dj = np.nonzero(~mask)
        orders = exactOrders(di, dj)

    return {
        'touching': (np.array(touching, dtype=np.int64).reshape(-1, 2), perms),
        'distant': (di, dj, orders),
        'target_order': target_order,
        'quad_order_diagonal': quad_order_diagonal,
    }

"""Mesh and dof partitioning and boundary layers for distributed assembly.

Host numpy copy of pynucleus_tpu/fem/partitioning.py: the inertial
recursive bisection (a METIS-free graph partitioner), the regular vertex,
mesh and dof partitioners, the dof-graph partitioner with a greedy
boundary refinement, and the boundary layers of a cell partition.  The
code that decides which vertex, cell or dof goes to which part is the JAX
package's line for line, so both packages partition alike.
"""
import numpy as np

__all__ = ['regularVertexPartitioner', 'regularMeshPartitioner',
           'regularDofPartitioner', 'metisDofPartitioner',
           'partitionCellsRecursiveBisection', 'boundaryLayers']


def _recursiveBisection(coords, nParts, idx=None):
    """Recursive inertial (principal-axis) bisection into nParts
    (METIS-free analogue of PartGraphRecursive)."""
    n = coords.shape[0]
    if idx is None:
        idx = np.arange(n)
    if nParts <= 1 or len(idx) <= 1:
        return {0: idx} if nParts <= 1 else {p: idx[0:0] for p in
                                             range(nParts)} | {0: idx}
    nLeft = nParts // 2
    frac = nLeft / nParts
    X = coords[idx]
    Xc = X - X.mean(axis=0)
    # principal axis via the covariance's leading eigenvector
    cov = Xc.T @ Xc
    w, V = np.linalg.eigh(cov)
    axis = V[:, -1]
    proj = Xc @ axis
    order = np.argsort(proj, kind='stable')
    cut = max(int(np.round(frac * len(idx))), 1)
    left = idx[order[:cut]]
    right = idx[order[cut:]]
    out = {}
    for p, sub in _recursiveBisection(coords, nLeft, left).items():
        out[p] = sub
    for p, sub in _recursiveBisection(coords, nParts - nLeft, right).items():
        out[nLeft + p] = sub
    return out


def _toPartArray(parts, n):
    arr = np.zeros(n, dtype=np.int64)
    for p, idx in parts.items():
        arr[idx] = p
    return arr


def regularVertexPartitioner(mesh, nParts):
    """Coordinate-bisection partition of mesh VERTICES -> part id per vertex
    (ref meshPartitioning.pyx:130)."""
    parts = _recursiveBisection(mesh.vertices, nParts)
    return _toPartArray(parts, mesh.num_vertices)


def regularMeshPartitioner(mesh, nParts):
    """Partition of CELLS by barycenter bisection
    (ref meshPartitioning.pyx:282)."""
    centers = mesh.vertices[mesh.cells].mean(axis=1)
    parts = _recursiveBisection(centers, nParts)
    return _toPartArray(parts, mesh.num_cells)


def regularDofPartitioner(dm, nParts):
    """Partition of DOFS by dof-coordinate bisection
    (ref meshPartitioning.pyx:316)."""
    coords = dm.getDoFCoordinates()
    parts = _recursiveBisection(coords, nParts)
    return _toPartArray(parts, dm.num_dofs)


def metisDofPartitioner(dm, nParts, refineSweeps=2):
    """Graph partition of the dof connectivity (ref metisDofPartitioner;
    METIS itself is unavailable here, so inertial bisection seeds a
    greedy Kernighan-Lin-style boundary refinement on the dof graph)."""
    import scipy.sparse as sp
    part = regularDofPartitioner(dm, nParts)
    N = dm.num_dofs
    d = dm.dofs
    mask = d >= 0
    # dof-dof adjacency through shared cells
    cc, ll = np.nonzero(mask)
    X = sp.coo_matrix((np.ones(mask.sum()), (d[cc, ll], cc)),
                      shape=(N, dm.mesh.num_cells)).tocsr()
    Adj = (X @ X.T).tocsr()
    Adj.setdiag(0)
    Adj.eliminate_zeros()
    counts = np.bincount(part, minlength=nParts)
    target = N / nParts
    for _ in range(refineSweeps):
        moved = 0
        for i in range(N):
            row = Adj.indices[Adj.indptr[i]:Adj.indptr[i + 1]]
            if len(row) == 0:
                continue
            neighParts = part[row]
            best = np.bincount(neighParts, minlength=nParts).argmax()
            if best != part[i] and counts[part[i]] > 0.8 * target \
                    and counts[best] < 1.2 * target:
                counts[part[i]] -= 1
                counts[best] += 1
                part[i] = best
                moved += 1
        if moved == 0:
            break
    return part


def partitionCellsRecursiveBisection(mesh, nParts):
    """Alias used by distributed drivers (cell partition)."""
    return regularMeshPartitioner(mesh, nParts)


def boundaryLayers(mesh, cellPartition, numLayers, part=None):
    """Cells within numLayers of a partition boundary
    (ref boundaryLayerCy.pyx:17 boundaryLayer/getLayer): layer[k][p] = cells
    of part p at graph distance k+1 from another part.  Needed to widen
    halos for finite-horizon assembly near partition boundaries."""
    import scipy.sparse as sp
    C = mesh.num_cells
    nv = mesh.cells.shape[1]
    X = sp.coo_matrix((np.ones(C * nv),
                       (np.repeat(np.arange(C), nv), mesh.cells.ravel())),
                      shape=(C, mesh.num_vertices)).tocsr()
    Adj = (X @ X.T).tocsr()
    parts = [part] if part is not None else \
        list(range(int(cellPartition.max()) + 1))
    out = {}
    for p in parts:
        own = cellPartition == p
        # frontier: own cells adjacent to any non-own cell
        frontier = np.zeros(C, dtype=bool)
        for c in np.nonzero(own)[0]:
            row = Adj.indices[Adj.indptr[c]:Adj.indptr[c + 1]]
            if np.any(cellPartition[row] != p):
                frontier[c] = True
        layers = []
        seen = frontier.copy()
        cur = frontier
        layers.append(np.nonzero(cur)[0])
        for _ in range(numLayers - 1):
            nxt = np.zeros(C, dtype=bool)
            for c in np.nonzero(cur)[0]:
                row = Adj.indices[Adj.indptr[c]:Adj.indptr[c + 1]]
                nxt[row] = True
            nxt &= own & ~seen
            seen |= nxt
            layers.append(np.nonzero(nxt)[0])
            cur = nxt
        out[p] = layers
    return out if part is None else out[part]

"""Simplex meshes (1D/2D), uniform refinement, boundary facets, surface mesh.

Carried over from pynucleus_tpu/fem/meshes.py (host numpy): simpleInterval,
the disc (circle + radialMeshTransformer), the uniform square and the
interval, square and disc extended by an interaction collar of width
horizon (intervalWithInteraction, uniformSquare, squareWithInteractions,
discWithInteraction), the circle as a closed 1-manifold in R^2 (sphere1,
of pynucleus_tpu/fem/mesh_zoo.py), red
refinement, the boundary facets of the default PHYSICAL tag and the
outward-oriented surface mesh of the zero-exterior term.  Vertex and cell
numbering are those of the JAX package, so both packages refine to
identical meshes.
"""
from __future__ import annotations

import numpy as np

from ..config import REAL, INDEX

PHYSICAL = 0
NO_BOUNDARY = np.iinfo(np.int32).min

__all__ = ['simplexMesh', 'simpleInterval', 'circle', 'radialMeshTransformer',
           'intervalWithInteraction', 'uniformSquare',
           'squareWithInteractions', 'discWithInteraction', 'sphere1',
           'PHYSICAL', 'NO_BOUNDARY']


class simplexMesh:
    """vertices [V, dim] float64, cells [C, manifold_dim+1] int32."""

    def __init__(self, vertices, cells, dim=None):
        self.vertices = np.ascontiguousarray(vertices, dtype=REAL)
        self.cells = np.ascontiguousarray(cells, dtype=INDEX)
        self.dim = dim if dim is not None else self.vertices.shape[1]
        self.manifold_dim = self.cells.shape[1] - 1
        self.transformer = None
        self._boundaryVertices = None
        self._boundaryEdges = None

    @property
    def num_vertices(self):
        return self.vertices.shape[0]

    @property
    def num_cells(self):
        return self.cells.shape[0]

    # --------------------------------------------------------------- geometry
    def simplexVolumes(self):
        V = self.vertices[self.cells]                      # [C, m+1, dim]
        m = self.manifold_dim
        span = V[:, 1:, :] - V[:, :1, :]                   # [C, m, dim]
        if m == 0:
            return np.ones(self.num_cells, dtype=REAL)
        fac = {1: 1.0, 2: 0.5, 3: 1.0 / 6.0}[m]
        if m == self.dim:
            return np.abs(np.linalg.det(span)) * fac
        # manifold simplices (surface meshes)
        G = np.einsum('cid,cjd->cij', span, span)
        det = np.linalg.det(G) if m > 1 else G[:, 0, 0]
        return np.sqrt(np.abs(det)) * fac

    def edgeLengths(self):
        V = self.vertices[self.cells]
        m = self.manifold_dim
        ls = []
        for i in range(m + 1):
            for j in range(i + 1, m + 1):
                ls.append(np.linalg.norm(V[:, i, :] - V[:, j, :], axis=1))
        return np.stack(ls, axis=1)  # [C, numEdges]

    @property
    def h(self):
        return float(self.edgeLengths().max())

    @property
    def hmin(self):
        return float(self.edgeLengths().min())

    @property
    def diam(self):
        lo = self.vertices.min(axis=0)
        hi = self.vertices.max(axis=0)
        return float(np.linalg.norm(hi - lo))

    # --------------------------------------------------------------- boundary
    def _computeBoundary(self):
        """Boundary facets appear in exactly one cell."""
        m = self.manifold_dim
        if m == 1:
            counts = np.zeros(self.num_vertices, dtype=np.int64)
            np.add.at(counts, self.cells.ravel(), 1)
            self._boundaryVertices = np.nonzero(counts == 1)[0].astype(INDEX)
        elif m == 2:
            edges = np.concatenate([self.cells[:, [0, 1]],
                                    self.cells[:, [1, 2]],
                                    self.cells[:, [2, 0]]], axis=0)
            uniq, counts = np.unique(np.sort(edges, axis=1), axis=0,
                                     return_counts=True)
            self._boundaryEdges = uniq[counts == 1].astype(INDEX)
            self._boundaryVertices = np.unique(
                self._boundaryEdges.ravel()).astype(INDEX)
        else:
            raise NotImplementedError(m)

    @property
    def boundaryVertices(self):
        if self._boundaryVertices is None:
            self._computeBoundary()
        return self._boundaryVertices

    @property
    def boundaryEdges(self):
        if self._boundaryEdges is None:
            self._computeBoundary()
        return self._boundaryEdges

    # ------------------------------------------------------------- refinement
    def refine(self):
        """Uniform refinement (red). 1D: bisection; 2D: 4 triangles."""
        m = self.manifold_dim
        if m == 1:
            newMesh, lookup = self._refine1D()
        elif m == 2:
            newMesh, lookup = self._refine2D()
        else:
            raise NotImplementedError(m)
        newMesh.transformer = self.transformer
        if self.transformer is not None:
            self.transformer(self, newMesh, lookup)
        return newMesh

    def _refine1D(self):
        C = self.num_cells
        mids = 0.5 * (self.vertices[self.cells[:, 0]] +
                      self.vertices[self.cells[:, 1]])
        newV = np.concatenate([self.vertices, mids], axis=0)
        midIdx = self.num_vertices + np.arange(C)
        left = np.stack([self.cells[:, 0], midIdx], axis=1)
        right = np.stack([midIdx, self.cells[:, 1]], axis=1)
        newC = np.concatenate([left, right], axis=0)
        lookup = {'edges': np.sort(self.cells, axis=1), 'newIdx': midIdx}
        return simplexMesh(newV, newC, dim=self.dim), lookup

    def _refine2D(self):
        cells = self.cells
        edges = np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]],
                                cells[:, [2, 0]]], axis=0)
        uniq, inv = np.unique(np.sort(edges, axis=1), axis=0,
                              return_inverse=True)
        inv = inv.reshape(-1)
        mids = 0.5 * (self.vertices[uniq[:, 0]] + self.vertices[uniq[:, 1]])
        newIdx = self.num_vertices + np.arange(uniq.shape[0], dtype=np.int64)
        newV = np.concatenate([self.vertices, mids], axis=0)
        C = self.num_cells
        m01 = newIdx[inv[:C]]
        m12 = newIdx[inv[C:2 * C]]
        m20 = newIdx[inv[2 * C:]]
        v0, v1, v2 = cells[:, 0], cells[:, 1], cells[:, 2]
        newC = np.concatenate([
            np.stack([v0, m01, m20], axis=1),
            np.stack([v1, m12, m01], axis=1),
            np.stack([v2, m20, m12], axis=1),
            np.stack([m01, m12, m20], axis=1)], axis=0)
        lookup = {'edges': uniq, 'newIdx': newIdx}
        return simplexMesh(newV, newC, dim=self.dim), lookup

    # ----------------------------------------------------------- surface mesh
    def get_surface_mesh(self):
        """Mesh of the boundary facets with outward unit normals."""
        m = self.manifold_dim
        if m == 1:
            bv = self.boundaryVertices
            sm = simplexMesh(self.vertices.copy(), bv.reshape(-1, 1),
                             dim=self.dim)
            normals = np.zeros((len(bv), self.dim), dtype=REAL)
            for k, v in enumerate(bv):
                # outward: away from the other vertex of v's single cell
                cell = self.cells[np.nonzero((self.cells == v).any(axis=1))[0][0]]
                d = self.vertices[v] - self.vertices[cell[cell != v][0]]
                normals[k] = d / np.linalg.norm(d)
            sm.normals = normals
            return sm
        if m != 2:
            raise NotImplementedError(m)
        be = self.boundaryEdges
        sm = simplexMesh(self.vertices.copy(), be, dim=self.dim)
        # owner cell of each boundary edge (first cell holding it)
        cells = self.cells
        alledges = np.sort(np.concatenate([cells[:, [0, 1]], cells[:, [1, 2]],
                                           cells[:, [2, 0]]], axis=0), axis=1)
        owner = np.tile(np.arange(len(cells)), 3)
        order = np.lexsort((owner, alledges[:, 1], alledges[:, 0]))
        keys = alledges[order, 0].astype(np.int64) * self.num_vertices \
            + alledges[order, 1]
        bkeys = be[:, 0].astype(np.int64) * self.num_vertices + be[:, 1]
        cellNo = owner[order][np.searchsorted(keys, bkeys)]
        t = self.vertices[be[:, 1]] - self.vertices[be[:, 0]]
        n = np.stack([t[:, 1], -t[:, 0]], axis=1)
        n /= np.linalg.norm(n, axis=1)[:, None]
        center = self.vertices[cells[cellNo]].mean(axis=1)
        mid = 0.5 * (self.vertices[be[:, 0]] + self.vertices[be[:, 1]])
        flip = np.einsum('kd,kd->k', n, mid - center) < 0
        n[flip] = -n[flip]
        sm.normals = n
        return sm

    def __repr__(self):
        return (f'<simplexMesh dim={self.dim} manifold={self.manifold_dim} '
                f'V={self.num_vertices} C={self.num_cells} h={self.h:.4g}>')


def simpleInterval(a=0.0, b=1.0, numCells=1):
    vertices = np.linspace(a, b, numCells + 1).reshape(-1, 1)
    cells = np.stack([np.arange(numCells), np.arange(1, numCells + 1)], axis=1)
    return simplexMesh(vertices, cells, dim=1)


def intervalWithInteraction(a=-1.0, b=1.0, horizon=0.1, h=None):
    """[a-horizon, b+horizon] with vertices at a and b.  The default mesh
    size is the horizon, so that after uniform refinement the horizon stays
    an exact multiple of h."""
    if h is None:
        h = horizon if horizon > 0 else (b - a)
    numCells = int(np.ceil((b - a) / h - 1e-8))
    hh = (b - a) / numCells
    numInt = max(int(np.ceil(horizon / hh - 1e-8)), 1) if horizon > 0 else 0
    left = a - horizon + (horizon / numInt) * np.arange(numInt) if numInt \
        else np.zeros((0,))
    mid = a + hh * np.arange(numCells + 1)
    right = b + (horizon / numInt) * np.arange(1, numInt + 1) if numInt \
        else np.zeros((0,))
    verts = np.concatenate([left, mid, right]).reshape(-1, 1)
    n = len(verts)
    cells = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    return simplexMesh(verts, cells, dim=1)


def _crossedGrid(xs, ys):
    """Triangles of the vertex grid xs x ys, the diagonal of each square
    alternating in a checkerboard."""
    X, Y = np.meshgrid(xs, ys, indexing='ij')
    vertices = np.stack([X.ravel(), Y.ravel()], axis=1)
    N, M = len(xs), len(ys)

    def vid(i, j):
        return i * M + j

    cells = []
    for i in range(N - 1):
        for j in range(M - 1):
            v00, v10 = vid(i, j), vid(i + 1, j)
            v01, v11 = vid(i, j + 1), vid(i + 1, j + 1)
            if (i + j) % 2 == 0:
                cells.append([v00, v10, v11])
                cells.append([v00, v11, v01])
            else:
                cells.append([v10, v11, v01])
                cells.append([v10, v01, v00])
    return simplexMesh(vertices, np.array(cells, dtype=INDEX), dim=2)


def uniformSquare(N=2, M=None, ax=0.0, ay=0.0, bx=1.0, by=1.0):
    """N x M vertex grid of crossed triangles."""
    if M is None:
        M = N
    return _crossedGrid(np.linspace(ax, bx, N), np.linspace(ay, by, M))


def squareWithInteractions(ax=-1., ay=-1., bx=1., by=1., horizon=0.1, h=None):
    """The square extended by the horizon: a uniform grid over the
    extended box with grid lines on the inner square's boundary."""
    if h is None:
        h = horizon

    def axis(lo, hi):
        nIn = max(int(np.ceil((hi - lo) / h)), 1)
        inner = np.linspace(lo, hi, nIn + 1)
        nH = max(int(np.ceil(horizon / h)), 1)
        left = lo - horizon + (horizon / nH) * np.arange(nH)
        right = hi + (horizon / nH) * np.arange(1, nH + 1)
        return np.concatenate([left, inner, right])
    return _crossedGrid(axis(ax, bx), axis(ay, by))


def circle(n=8, radius=1.0, h=None):
    """Disc mesh: regular n-gon fan, with a radial projection transformer so
    refinements approach the circle."""
    if h is not None:
        n = max(int(np.ceil(2 * np.pi * radius / h)), 4)
    angles = 2 * np.pi * np.arange(n) / n
    ring = radius * np.stack([np.cos(angles), np.sin(angles)], axis=1)
    vertices = np.concatenate([np.zeros((1, 2)), ring], axis=0)
    cells = np.array([[0, 1 + i, 1 + (i + 1) % n] for i in range(n)],
                     dtype=INDEX)
    m = simplexMesh(vertices, cells, dim=2)
    m.transformer = radialMeshTransformer(radius)
    return m


class radialMeshTransformer:
    """After refinement, project new vertices whose parent edge endpoints both
    lie on a circle of the same radius back onto that circle."""

    def __init__(self, radius=None, center=None):
        self.radius = radius
        self.center = center

    def __call__(self, oldMesh, newMesh, lookup):
        edges = lookup['edges']
        newIdx = lookup['newIdx']
        center = self.center
        if center is None:
            center = np.zeros(oldMesh.dim)
        r0 = np.linalg.norm(oldMesh.vertices[edges[:, 0]] - center, axis=1)
        r1 = np.linalg.norm(oldMesh.vertices[edges[:, 1]] - center, axis=1)
        onCircle = np.abs(r0 - r1) < 1e-9 * (1 + np.abs(r0))
        target = 0.5 * (r0 + r1)
        mids = newMesh.vertices[newIdx]
        rm = np.linalg.norm(mids - center, axis=1)
        scale = np.where(onCircle & (rm > 0),
                         target / np.maximum(rm, 1e-300), 1.0)
        newMesh.vertices[newIdx] = center + (mids - center) * scale[:, None]


def sphere1(numCells=10, radius=1.):
    """The circle of ``radius`` as a closed 1-manifold mesh in R^2:
    numCells vertices at the angles 2 pi k / numCells, cell k joining
    vertices k and k + 1 (mod numCells), refined onto the circle
    (pynucleus_tpu/fem/mesh_zoo.py:443-451 sphere1)."""
    thetas = 2 * np.pi * np.arange(numCells) / numCells
    verts = radius * np.stack([np.cos(thetas), np.sin(thetas)], axis=1)
    cells = np.stack([np.arange(numCells),
                      (np.arange(numCells) + 1) % numCells], axis=1)
    m = simplexMesh(verts.astype(REAL), cells.astype(INDEX), dim=2)
    m.transformer = radialMeshTransformer()
    return m


def discWithInteraction(radius=1.0, horizon=0.1, h=0.25):
    """The disc of radius + horizon (pynucleus_tpu/fem/meshes.py:720): the
    interaction collar is the ring beyond ``radius``, which no mesh line
    follows (the domain indicator picks the dofs); refinement projects the
    boundary nodes onto the outer circle."""
    m = circle(h=h, radius=radius + horizon)
    m.transformer = radialMeshTransformer()
    return m

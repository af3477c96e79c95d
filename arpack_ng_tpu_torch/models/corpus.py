"""Irregular-matrix corpus generators: the port's own copy of
``arpack_ng_tpu/models/corpus.py`` (numpy and scipy only), so both packages
build the same matrices from the same seed.

* :func:`fem_triangulation` — P1 finite-element stiffness matrix of the
  Laplacian on an UNSTRUCTURED Delaunay triangulation of random points:
  irregular bandwidth, node degrees 4-12, no diagonal structure until a
  reordering finds one.
* :func:`powerlaw_graph` — Barabasi-Albert preferential-attachment graph
  Laplacian: power-law degree distribution with O(sqrt(n))-degree hubs.
* :func:`saddle_point` — Stokes-class KKT block matrix
  ``[[K, B^T], [B, 0]]``: symmetric INDEFINITE with a structural zero block.

All return scipy CSR (float64; cast at import) so they flow through
``ops.sparse.from_scipy(format='auto')`` exactly like user matrices.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def fem_triangulation(n_points: int, seed: int = 0) -> sp.csr_matrix:
    """P1 stiffness matrix of -Laplace on a Delaunay triangulation of
    ``n_points`` random points in the unit square (element-wise cotangent
    assembly, the standard FEM formula); SPD after grounding one node."""
    from scipy.spatial import Delaunay
    rng = np.random.default_rng(seed)
    pts = rng.random((n_points, 2))
    tri = Delaunay(pts)
    t = tri.simplices                     # (ntri, 3)
    # per-triangle edge vectors and area
    p0, p1, p2 = pts[t[:, 0]], pts[t[:, 1]], pts[t[:, 2]]
    e0 = p2 - p1
    e1 = p0 - p2
    e2 = p1 - p0
    area2 = np.abs(e2[:, 0] * (-e1[:, 1]) - e2[:, 1] * (-e1[:, 0]))
    area2 = np.maximum(area2, 1e-12)
    # local stiffness K_ij = (e_i . e_j) / (2 * area2)  (P1 gradients)
    edges = np.stack([e0, e1, e2], axis=1)          # (ntri, 3, 2)
    Kloc = np.einsum("tik,tjk->tij", edges, edges) / (2.0 * area2)[:, None,
                                                                   None]
    rows = np.repeat(t, 3, axis=1).ravel()          # i index
    cols = np.tile(t, (1, 3)).ravel()               # j index
    a = sp.coo_matrix((Kloc.ravel(), (rows, cols)),
                      shape=(n_points, n_points)).tocsr()
    a = (a + a.T) / 2.0
    # ground: add a small diagonal so the matrix is SPD (removes the
    # constant-vector null space without changing the structure)
    a = (a + 1e-3 * sp.identity(n_points)).tocsr()
    a.sum_duplicates()
    return a


def powerlaw_graph(n: int, m_attach: int = 4, seed: int = 0
                   ) -> sp.csr_matrix:
    """Graph Laplacian of a Barabasi-Albert preferential-attachment graph
    (each new node attaches to ``m_attach`` existing nodes chosen
    proportionally to degree — the repeated-nodes sampling trick).  Hub
    degrees grow like sqrt(n): the stress case for fixed-width formats."""
    rng = np.random.default_rng(seed)
    # start from a small clique
    src, dst = [], []
    m0 = m_attach + 1
    for i in range(m0):
        for j in range(i + 1, m0):
            src.append(i)
            dst.append(j)
    # repeated-node list: every edge endpoint appears once per incidence,
    # so uniform sampling from it IS degree-proportional sampling
    repeated = list(src) + list(dst)
    for v in range(m0, n):
        targets = set()
        while len(targets) < m_attach:
            pick = repeated[rng.integers(len(repeated))]
            if pick != v:
                targets.add(pick)
        for u in targets:
            src.append(v)
            dst.append(u)
            repeated.extend((v, u))
    src = np.asarray(src)
    dst = np.asarray(dst)
    data = np.ones(len(src))
    adj = sp.coo_matrix((data, (src, dst)), shape=(n, n))
    adj = ((adj + adj.T) > 0).astype(np.float64)
    deg = np.asarray(adj.sum(axis=1)).ravel()
    return (sp.diags(deg) - adj).tocsr()


def saddle_point(nx: int) -> sp.csr_matrix:
    """Stokes-class KKT matrix ``[[K, B^T], [B, 0]]`` on an nx x nx grid:
    K = 2-D 5-point Laplacian (velocity block, dim nx^2), B = forward-
    difference divergence (pressure rows, dim nx^2).  Symmetric
    indefinite, structural zero block — total dim 2*nx^2."""
    nv = nx * nx
    t = sp.diags([-np.ones(nx - 1), 2.0 * np.ones(nx), -np.ones(nx - 1)],
                 [-1, 0, 1])
    eye = sp.identity(nx)
    K = (sp.kron(eye, t) + sp.kron(t, eye)).tocsr()
    dx = sp.diags([-np.ones(nx), np.ones(nx - 1)], [0, 1],
                  shape=(nx, nx))
    B = (sp.kron(eye, dx) + sp.kron(dx, eye)).tocsr()  # (nv, nv)
    Z = sp.csr_matrix((nv, nv))
    return sp.bmat([[K, B.T], [B, Z]], format="csr")

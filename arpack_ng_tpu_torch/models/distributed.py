"""Distributed stencil operator with an explicit halo exchange (port of
``arpack_ng_tpu/models/distributed.py``): the PARPACK example pattern
(PARPACK/EXAMPLES/MPI/pdsdrv1.f:429-480), a 1-D row-partitioned 2-D
Laplacian whose matvec sends and receives one nx-sized grid row between
neighbouring ranks.

The exchange is one batched send/receive pair per neighbour
(``RowMesh.exchange``); the rows missing at the mesh's edges arrive as
zeros, the Dirichlet walls.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp

from ..ops.operator import Operator


def laplacian_2d_sharded(nx: int, ny: int, mesh, dtype=np.float32,
                         device=None) -> Tuple[Operator, sp.spmatrix]:
    """Row-partitioned 2-D Dirichlet Laplacian over ``mesh`` (a grid of ny
    rows of nx points; the y-dimension is partitioned, ``ny / size`` grid
    rows per rank), on ``device`` (default: the mesh's).  The operator maps
    this rank's rows to its rows (``op.mesh``); n = nx*ny needs no padding.
    Returns ``(op, a)`` with ``a`` the whole matrix as scipy CSR (float64),
    the oracle.  Requires ``ny % size == 0``."""
    ndev = mesh.size
    if ny % ndev != 0:
        raise ValueError(f"ny={ny} must be divisible by mesh size {ndev}")
    device = mesh.device if device is None else device
    n = nx * ny
    ny_loc = ny // ndev

    def matvec(x_loc):
        u = x_loc.view(ny_loc, nx)
        # the halo exchange: one grid row each way (the reference's
        # mpi_send/mpi_recv of nx-sized blocks, pdsdrv1.f:466-480)
        from_above, from_below = mesh.exchange(u[0], u[-1])
        y = 4.0 * u
        y[:-1, :] -= u[1:, :]
        y[1:, :] -= u[:-1, :]
        y[:, :-1] -= u[:, 1:]
        y[:, 1:] -= u[:, :-1]
        # the boundary rows take the neighbours' rows last, as the
        # reference's sharded stencil does
        y[0] -= from_above
        y[-1] -= from_below
        return y.view(-1)

    def apply(v, bv):
        w = matvec(v)
        return w, w

    op = Operator(n=n, dtype=np.dtype(dtype), apply=apply, bmat="I",
                  mode=1, a_apply=matvec, n_pad=n, hermitian=True,
                  device=device, capturable=mesh.capturable, mesh=mesh)

    t = sp.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)],
                 [-1, 0, 1])
    ty = sp.diags([-np.ones(ny - 1), 2 * np.ones(ny), -np.ones(ny - 1)],
                  [-1, 0, 1])
    a = (sp.kron(sp.identity(ny), t)
         + sp.kron(ty, sp.identity(nx))).tocsr().astype(np.float64)
    return op, a

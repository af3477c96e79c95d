"""Laplacian model operators (port of the symmetric half of
``arpack_ng_tpu/models/stencil.py``).

* :func:`laplacian_2d` — the 2-D Dirichlet Laplacian, the ``dssimp`` model
  problem (EXAMPLES/SIMPLE/dssimp.f:47, ``av`` at :470-506).
* :func:`laplacian_1d` — tridiag(-1, 2, -1), the dsdrv2-class model.

The matvec is plain torch arithmetic on the operator's device: no matrix
is stored.  The stencil is applied as the reference package applies it
(``4u`` minus the four shifted neighbours, in the same order), so both
packages round the same way.  Each constructor also returns the
``scipy.sparse`` matrix as the independent oracle.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..config import pad_dim
from ..ops.operator import Operator, from_matvec


def _wrap_padded(stencil_fn, n, n_pad):
    def matvec(x):
        y = stencil_fn(x[:n])
        if n_pad == n:
            return y
        out = torch.zeros(n_pad, dtype=x.dtype, device=x.device)
        out[:n] = y
        return out

    return matvec


def laplacian_1d(n: int, dtype=np.float32, *, pad: bool = True,
                 scale: bool = False, device="cpu"
                 ) -> Tuple[Operator, sp.spmatrix]:
    """1-D Dirichlet Laplacian: tridiag(-1, 2, -1) (optionally / h^2)."""
    h2inv = (n + 1.0) ** 2 if scale else 1.0
    n_pad = pad_dim(n) if pad else n

    def stencil(u):
        y = 2.0 * u
        y[:-1] -= u[1:]
        y[1:] -= u[:-1]
        return h2inv * y if scale else y

    op = from_matvec(_wrap_padded(stencil, n, n_pad), n, dtype,
                     n_pad=n_pad, hermitian=True, device=device)
    a = h2inv * sp.diags([-np.ones(n - 1), 2 * np.ones(n),
                          -np.ones(n - 1)], [-1, 0, 1], format="csr")
    return op, a.astype(np.float64)


def laplacian_2d(nx: int, dtype=np.float32, *, pad: bool = True,
                 device="cpu") -> Tuple[Operator, sp.spmatrix]:
    """2-D Dirichlet Laplacian, 5-point stencil (diagonal 4, neighbours -1)
    on an nx*nx grid; eigenvalues 4 - 2cos(i*pi*h) - 2cos(j*pi*h)."""
    n = nx * nx
    n_pad = pad_dim(n) if pad else n

    def stencil(x):
        u = x.view(nx, nx)
        y = 4.0 * u
        y[:-1, :] -= u[1:, :]
        y[1:, :] -= u[:-1, :]
        y[:, :-1] -= u[:, 1:]
        y[:, 1:] -= u[:, :-1]
        return y.view(-1)

    op = from_matvec(_wrap_padded(stencil, n, n_pad), n, dtype,
                     n_pad=n_pad, hermitian=True, device=device)
    t = sp.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)],
                 [-1, 0, 1])
    eye = sp.identity(nx)
    a = (sp.kron(eye, t) + sp.kron(t, eye)).tocsr()
    return op, a.astype(np.float64)

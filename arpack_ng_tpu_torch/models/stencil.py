"""Stencil model operators (port of ``arpack_ng_tpu/models/stencil.py``).

* :func:`laplacian_2d` — the 2-D Dirichlet Laplacian, the ``dssimp`` model
  problem (EXAMPLES/SIMPLE/dssimp.f:47, ``av`` at :470-506).
* :func:`laplacian_1d` — tridiag(-1, 2, -1), the dsdrv2-class model.
* :func:`convection_diffusion_1d` / :func:`convection_diffusion_2d` — the
  non-symmetric dndrv1 and dnsimp models; a complex ``dtype`` gives the
  zndrv1-class complex operator.

The matvec is plain torch arithmetic on the operator's device (the card
unless ``device="cpu"`` is given): no matrix is stored.  Each stencil is
applied as the reference package applies it (the same terms in the same
order), so both packages round the same way.  Each constructor also
returns the ``scipy.sparse`` matrix as the independent oracle.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..config import pad_dim
from ..ops.operator import Operator, from_matvec
from ..utils.device import DEFAULT


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
                 scale: bool = False, device=DEFAULT
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
                     n_pad=n_pad, hermitian=True, device=device,
                     capturable=True)
    a = h2inv * sp.diags([-np.ones(n - 1), 2 * np.ones(n),
                          -np.ones(n - 1)], [-1, 0, 1], format="csr")
    return op, a.astype(np.float64)


def laplacian_2d(nx: int, dtype=np.float32, *, pad: bool = True,
                 device=DEFAULT) -> Tuple[Operator, sp.spmatrix]:
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
                     n_pad=n_pad, hermitian=True, device=device,
                     capturable=True)
    t = sp.diags([-np.ones(nx - 1), 2 * np.ones(nx), -np.ones(nx - 1)],
                 [-1, 0, 1])
    eye = sp.identity(nx)
    a = (sp.kron(eye, t) + sp.kron(t, eye)).tocsr()
    return op, a.astype(np.float64)


def convection_diffusion_1d(n: int, rho: float = 10.0, dtype=np.float32, *,
                            pad: bool = True, device=DEFAULT
                            ) -> Tuple[Operator, sp.spmatrix]:
    """1-D convection-diffusion: tridiag(-1-c, 2, -1+c), c = rho*h/2, the
    dndrv1-class non-symmetric model (EXAMPLES/NONSYM/dndrv1.f)."""
    h = 1.0 / (n + 1)
    c = rho * h / 2.0
    dl, dd, du = -1.0 - c, 2.0, -1.0 + c
    n_pad = pad_dim(n) if pad else n

    def stencil(u):
        y = dd * u
        y[:-1] += du * u[1:]
        y[1:] += dl * u[:-1]
        return y

    op = from_matvec(_wrap_padded(stencil, n, n_pad), n, dtype,
                     n_pad=n_pad, hermitian=False, device=device,
                     capturable=True)
    a = sp.diags([dl * np.ones(n - 1), dd * np.ones(n),
                  du * np.ones(n - 1)], [-1, 0, 1], format="csr")
    return op, a.astype(np.float64)


def convection_diffusion_2d(nx: int, rho: float = 100.0, dtype=np.float32,
                            *, pad: bool = True, device=DEFAULT
                            ) -> Tuple[Operator, sp.spmatrix]:
    """2-D convection-diffusion (the dnsimp model): ``I (x) T + T0 (x) I``
    with the convection in the x-sweep, T = tridiag(-1-c, 4, -1+c),
    c = rho*h/2, T0 = tridiag(-1, 0, -1).  A complex ``dtype`` gives the
    zndrv1-class complex operator."""
    n = nx * nx
    h = 1.0 / (nx + 1)
    c = rho * h / 2.0
    dl, dd, du = -1.0 - c, 4.0, -1.0 + c
    n_pad = pad_dim(n) if pad else n

    def stencil(x):
        u = x.view(nx, nx)
        y = dd * u
        y[:, :-1] += du * u[:, 1:]
        y[:, 1:] += dl * u[:, :-1]
        y[:-1, :] -= u[1:, :]
        y[1:, :] -= u[:-1, :]
        return y.view(-1)

    op = from_matvec(_wrap_padded(stencil, n, n_pad), n, dtype,
                     n_pad=n_pad, hermitian=False, device=device,
                     capturable=True)
    t = sp.diags([dl * np.ones(nx - 1), dd * np.ones(nx),
                  du * np.ones(nx - 1)], [-1, 0, 1])
    t0 = sp.diags([-np.ones(nx - 1), np.zeros(nx), -np.ones(nx - 1)],
                  [-1, 0, 1])
    eye = sp.identity(nx)
    a = (sp.kron(eye, t) + sp.kron(t0, eye)).tocsr()
    return op, a.astype(np.float64)

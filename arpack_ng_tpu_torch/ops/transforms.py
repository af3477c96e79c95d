"""Spectral transformations: builders for the OP/B operator pairs of the
reference's modes 1-5 (port of ``arpack_ng_tpu/ops/transforms.py``;
SRC/dsaupd.f:30-48 symmetric, SRC/dnaupd.f:20-36 non-symmetric,
SRC/znaupd.f:20-27 complex).

==== symmetric (dsaupd) ====
mode 1: OP = A,                     B = I   (dsdrv1)
mode 2: OP = inv(M)*A,              B = M   (dsdrv3)
mode 3: OP = inv(A - sigma*M)*M,    B = M   (shift-invert, dsdrv2/dsdrv4)
mode 4: OP = inv(A - sigma*M)*A,    B = A   (buckling, dsdrv5; A = K)
mode 5: OP = inv(A - sigma*M)*(A + sigma*M), B = M  (Cayley, dsdrv6),
        applied as v + 2*sigma*inv(A - sigma*M)*M*v

==== non-symmetric (dnaupd) ====
mode 1/2 as above;
mode 3: OP = Re [ inv(A - sigma*M)*M ],  B = M  (dndrv4/5)
mode 4: OP = Im [ inv(A - sigma*M)*M ],  B = M  (dndrv6)
(For a real sigma mode 3 is real arithmetic throughout; complex dtypes use
znaupd mode 3: OP = inv(A - sigma*M)*M.)

The linear solve comes in three flavours:

* dense direct: a host LU factorization once, applied on the device as an
  explicit-inverse product (:func:`build_sym_operator`,
  :func:`build_nonsym_operator`; capturable);
* a caller's ``solve`` callable (:func:`shift_invert_operator`);
* the iterative Krylov solves of :mod:`~arpack_ng_tpu_torch.ops.solvers`
  (CG/BiCGSTAB) for the matrix-free case: a host loop with one device read
  per iteration where nothing is captured, and, in an operator declared
  ``capturable`` on a card, one CUDA-graph WHILE node per solve
  (:mod:`~arpack_ng_tpu_torch.ops.cuda_krylov_loop`), so that the restart
  loop's graphs hold whole inner solves.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from ..config import pad_dim
from ..utils import dtypes as _dt
from ..utils.device import DEFAULT, require
from .operator import Operator, _pad_mat, from_dense


def _dense_inv(mat: np.ndarray, n_pad: int) -> np.ndarray:
    """Host LU -> explicit inverse, identity-padded."""
    m = _pad_mat(np.asarray(mat), n_pad, fill_identity=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lu, piv = sla.lu_factor(m)
        inv = sla.lu_solve((lu, piv), np.eye(n_pad, dtype=m.dtype))
    if not np.all(np.isfinite(inv)):
        raise ValueError(
            "A - sigma*M is numerically singular: sigma appears to be an "
            "eigenvalue; perturb the shift (reference behavior: LAPACK "
            "factorization info>0 aborts the driver)")
    return inv


def _coerce_dense(A):
    if sp.issparse(A):
        return A.toarray()
    return np.asarray(A)


def shift_invert_operator(
    n: int,
    dtype,
    solve: Callable,
    *,
    sigma: complex,
    m_apply: Optional[Callable] = None,
    a_apply: Optional[Callable] = None,
    mode: int = 3,
    n_pad: int = 0,
    hermitian: bool = False,
    bmat: Optional[str] = None,
    device=DEFAULT,
    capturable: bool = False,
) -> Operator:
    """Spectral-transform operator on ``device`` from a ``solve`` with
    ``solve(b) ~= inv(A - sigma*M) b`` (M = I when ``m_apply`` is None).

    ``mode`` selects the right-hand side fed to the solve, as in the table
    of the module docstring; B is ``m_apply`` for ``bmat='G'`` and
    ``a_apply`` in buckling mode.  ``capturable``: the caller declares that
    ``solve``, ``a_apply`` and ``m_apply`` are torch ops and kernels with
    no host read or sync (see :class:`~arpack_ng_tpu_torch.ops.operator.
    Operator`).  An iterative solve of :func:`~arpack_ng_tpu_torch.ops.
    solvers.make_iterative_solve` is, on a CUDA device (CUDA 12.4 or later:
    it raises here otherwise), where its matvec and preconditioner are:
    the DIA, CSR and stencil products, Jacobi, and ILU(0) / IC(0) over
    the DIA kernel; each solve is then one WHILE node of a CUDA graph (the
    capturing one, or one of its own).  Such an operator lifted onto a
    mesh (``parallel/sharding.mesh_operator``) runs uncaptured: NCCL
    beside a conditional body is unverified."""
    from .solvers import IterativeSolve

    n_pad = n_pad or n
    dtype = np.dtype(dtype)
    loops = isinstance(solve, IterativeSolve)
    if capturable and loops and torch.device(device).type == "cuda":
        solve.bind(device)
    if bmat is None:
        bmat = "I" if m_apply is None else "G"

    if mode == 3:
        if m_apply is None:
            def apply(v, bv):
                w = solve(v)
                return w, w
        else:
            def apply(v, bv):
                w = solve(bv)          # OP v = inv(A-sigma M) (M v)
                return w, m_apply(w)
    elif mode == 4:
        if a_apply is None:
            raise ValueError("buckling mode needs a_apply")

        def apply(v, bv):
            w = solve(bv)              # bv = A v here (B = A)
            return w, a_apply(w)
    elif mode == 5:
        if a_apply is None or m_apply is None:
            raise ValueError("Cayley mode needs a_apply and m_apply")
        sig2 = np.array(2 * sigma).astype(dtype).item()

        def apply(v, bv):
            # inv(A - sM)(A + sM) v = v + 2s inv(A - sM) M v: the solve
            # never sees A v, whose stiff components (|A v| up to ||A|| |v|)
            # it would return with errors ~eps*cond(A - sM) that the
            # selective Lanczos' rounding model does not cover
            w = v + sig2 * solve(bv)
            return w, m_apply(w)
    else:
        raise ValueError(f"bad transform mode {mode}")

    b_ap = m_apply if bmat == "G" else None
    if mode == 4:
        b_ap = a_apply
    return Operator(n=n, dtype=dtype, apply=apply, bmat=bmat, mode=mode,
                    b_apply=b_ap, a_apply=a_apply, m_apply=m_apply,
                    n_pad=n_pad, sigma=sigma, hermitian=hermitian,
                    device=device, capturable=capturable, while_loops=loops)


def _product(mat: np.ndarray, device) -> Callable:
    """``v -> mat @ v`` with ``mat`` held on ``device``."""
    m_dev = torch.from_numpy(np.ascontiguousarray(mat)).to(device)
    return lambda v: m_dev @ v


def build_sym_operator(A, M=None, sigma=None, mode: str = "normal",
                       dtype=None, n_pad: int = 0,
                       device=DEFAULT) -> Operator:
    """Dense/sparse convenience builder for the symmetric drivers (the
    dsdrv1-6 example family) on ``device``: the shifted matrix is factored
    on the host and its explicit inverse applied as one product.
    ``n_pad`` overrides the default 128-row padding."""
    if isinstance(A, Operator):
        if sigma is None and M is None:
            return A
        raise ValueError(
            "pass matrices (dense/sparse) for built-in spectral transforms, "
            "or use shift_invert_operator() with your own solve callable")
    device = require(device)
    a = _coerce_dense(A)
    if dtype is not None:
        a = a.astype(dtype)
    n = a.shape[0]
    n_pad = n_pad or pad_dim(n)
    m = _coerce_dense(M).astype(a.dtype) if M is not None else None

    if sigma is None:
        # mode 1, or mode 2 with M
        return from_dense(a, m, n_pad=n_pad, hermitian=True, device=device)

    sigma = float(sigma)
    mnum = {"normal": 3, "buckling": 4, "cayley": 5}[mode]
    m_eff = m if m is not None else np.eye(n, dtype=a.dtype)
    shifted = a - sigma * m_eff
    solve = _product(_dense_inv(shifted, n_pad).astype(a.dtype), device)
    a_apply = _product(_pad_mat(a, n_pad, fill_identity=mnum == 4), device)
    if m is None and mnum == 3:
        # standard shift-invert: bmat='I' (dsdrv2 class)
        return shift_invert_operator(n, a.dtype, solve, sigma=sigma,
                                     mode=3, n_pad=n_pad, hermitian=True,
                                     a_apply=a_apply, device=device,
                                     capturable=True)
    return shift_invert_operator(
        n, a.dtype, solve, sigma=sigma, mode=mnum, n_pad=n_pad,
        hermitian=True, a_apply=a_apply,
        m_apply=_product(_pad_mat(m_eff, n_pad), device), device=device,
        capturable=True)


def build_nonsym_operator(A, M=None, sigma=None, dtype=None,
                          part: str = "real", n_pad: int = 0,
                          device=DEFAULT) -> Operator:
    """Dense/sparse convenience builder for the non-symmetric and complex
    drivers (dndrv1-6 / zndrv1-4 families) on ``device``.

    ``part`` selects mode 3 (real part) or mode 4 (imaginary part) when
    sigma is complex and the problem dtype real (dndrv5/dndrv6): the
    operator is the real or imaginary part of the complex128 inverse.
    ``n_pad`` as in :func:`build_sym_operator`."""
    if isinstance(A, Operator):
        if sigma is None and M is None:
            return A
        raise ValueError(
            "pass matrices for built-in spectral transforms, or use "
            "shift_invert_operator() with your own solve callable")
    device = require(device)
    a = _coerce_dense(A)
    if dtype is not None:
        a = a.astype(dtype)
    n = a.shape[0]
    n_pad = n_pad or pad_dim(n)
    m = _coerce_dense(M).astype(a.dtype) if M is not None else None

    if sigma is None:
        return from_dense(a, m, n_pad=n_pad, hermitian=False, device=device)

    sigma = complex(sigma)
    is_cplx_prob = _dt.is_complex(a.dtype)
    m_eff = m if m is not None else np.eye(n, dtype=a.dtype)
    shifted = a.astype(np.complex128) - sigma * m_eff.astype(np.complex128)
    cinv128 = _dense_inv(shifted, n_pad)
    a_apply = _product(_pad_mat(a, n_pad), device)
    mode = 3
    if is_cplx_prob:
        cinv = cinv128
    elif sigma.imag == 0.0:
        cinv = cinv128.real
    else:
        # real arithmetic with a complex shift: OP = Re/Im[inv(A-sigma M) M]
        # (dnaupd modes 3/4, SRC/dnaupd.f:20-36)
        cinv = cinv128.real if part == "real" else cinv128.imag
        mode = 3 if part == "real" else 4
    solve = _product(cinv.astype(a.dtype), device)

    if m is None:
        # mode 3 with bmat 'I' for either part, as the reference builds it
        # (the values then come from Rayleigh quotients on extraction)
        return shift_invert_operator(n, a.dtype, solve, sigma=sigma,
                                     mode=3, n_pad=n_pad, hermitian=False,
                                     a_apply=a_apply, device=device,
                                     capturable=True)
    op = shift_invert_operator(
        n, a.dtype, solve, sigma=sigma, mode=3, n_pad=n_pad,
        hermitian=False, a_apply=a_apply,
        m_apply=_product(_pad_mat(m_eff, n_pad), device), device=device,
        capturable=True)
    if mode == 4:
        op = Operator(n=n, dtype=a.dtype, apply=op.apply, bmat=op.bmat,
                      mode=4, b_apply=op.b_apply, a_apply=op.a_apply,
                      m_apply=op.m_apply, n_pad=n_pad, sigma=sigma,
                      hermitian=False, device=device, capturable=True)
    return op

"""Iterative and direct linear solvers for matrix-free shift-invert (port
of ``arpack_ng_tpu/ops/solvers.py``).

The reference's C++ layer offers a mode-solver menu, direct (LU/QR/LLT/
LDLT) and iterative (CG/BiCG with diagonal or ILU preconditioning), to
apply ``inv(A - sigma*B)`` inside the RCI loop (arpackmm.cpp:445-476
``--slv CG|BiCG|LU|QR...``).

* :func:`cg` and :func:`bicgstab`: the reference's ``lax.while_loop``
  Krylov iterations as a host loop over device tensors, with the same
  update order and the same test before each iteration
  (``|r.r| > (tol*||b||)^2`` and ``it < maxiter``; BiCGSTAB also restarts
  where the reference would divide by a zero ``rho``).  The test reads
  the device once per iteration, so an operator built on them is not
  capturable by a CUDA graph;
* :func:`jacobi_preconditioner` (the reference's ``Diag`` option) and
  :func:`ilu0_preconditioner` (its ``ILU`` option): the incomplete
  factorization runs once on the host (SuperLU, natural ordering, zero
  fill) and each application replaces the two triangular solves by
  fixed-sweep truncated Neumann series over the strict triangles in DIA
  form (:func:`~arpack_ng_tpu_torch.ops.sparse.dia_matvec_fn`: the DIA
  kernel on the card);
* :func:`make_direct_inverse`: a host factorization turned into an
  explicit identity-padded inverse, applied on the device as one product.
"""
from __future__ import annotations

import warnings
from functools import partial
from typing import Callable, Optional

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..utils.device import DEFAULT, require


def _vdot(a, b):
    return torch.vdot(a, b)


def cg_start(matvec: Callable, b: torch.Tensor, x0=None, tol: float = 1e-8,
             precond: Optional[Callable] = None):
    """CG's state ``(x, r, z, p, rz)`` before the first iteration, and the
    squared absolute tolerance ``(tol*||b||)^2``."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = precond(r) if precond is not None else r
    bnorm = torch.sqrt(torch.abs(_vdot(b, b)))
    return (x, r, z, z, _vdot(r, z)), (tol * bnorm) ** 2


def cg_step(matvec: Callable, c, precond: Optional[Callable] = None):
    """One CG iteration on the state of :func:`cg_start`, no device read."""
    x, r, z, p, rz = c
    ap = matvec(p)
    alpha = rz / _vdot(p, ap)
    x = x + alpha * p
    r = r - alpha * ap
    z = precond(r) if precond is not None else r
    rz_new = _vdot(r, z)
    beta = rz_new / rz
    p = z + beta * p
    return (x, r, z, p, rz_new)


def _cg(matvec, b, x0, tol, maxiter, precond):
    c, atol2 = cg_start(matvec, b, x0, tol, precond)
    it = 0
    # the reference's loop test, one device read
    while it < maxiter and bool(torch.abs(_vdot(c[1], c[1])) > atol2):
        c = cg_step(matvec, c, precond)
        it += 1
    return c[0], it


def cg(matvec: Callable, b: torch.Tensor, *, x0=None, tol: float = 1e-8,
       maxiter: int = 1000, precond: Optional[Callable] = None
       ) -> torch.Tensor:
    """Conjugate gradients: solves ``matvec(x) = b``."""
    return _cg(matvec, b, x0, tol, maxiter, precond)[0]


def _bicgstab(matvec, b, x0, tol, maxiter, precond):
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rhat = r
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    v = p = torch.zeros_like(b)
    one, zero = rho, v
    bnorm = torch.sqrt(torch.abs(_vdot(b, b)))
    atol2 = (tol * bnorm) ** 2
    it = 0
    while it < maxiter:
        # the loop test and a zero rho, in one read
        go, brk = torch.stack([torch.abs(_vdot(r, r)) > atol2,
                               rho == 0]).tolist()
        if not go:
            break
        if brk:
            # the last step's rho_new was exactly 0 (r orthogonal to the
            # shadow residual): the next beta would divide by it and turn
            # the solve to nan.  Restart from the current residual.
            rhat, rho, alpha, omega, v, p = r, one, one, one, zero, zero
        rho_new = _vdot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        ph = precond(p) if precond is not None else p
        v = matvec(ph)
        alpha = rho_new / _vdot(rhat, v)
        s = r - alpha * v
        sh = precond(s) if precond is not None else s
        t = matvec(sh)
        omega = _vdot(t, s) / _vdot(t, t)
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rho = rho_new
        it += 1
    return x, it


def bicgstab(matvec: Callable, b: torch.Tensor, *, x0=None,
             tol: float = 1e-8, maxiter: int = 1000,
             precond: Optional[Callable] = None) -> torch.Tensor:
    """BiCGSTAB for general (non-symmetric) systems.  Where a step's
    ``rho = rhat.r`` comes out exactly 0 the next iteration restarts from
    the current residual (``rhat = r``): the reference package divides by
    it and returns nan.  Otherwise the iteration is the reference's."""
    return _bicgstab(matvec, b, x0, tol, maxiter, precond)[0]


def jacobi_preconditioner(diag: torch.Tensor) -> Callable:
    """The reference's ``Diag`` preconditioner option (arpackmm.cpp:
    449-466): ``r -> r / diag``, a zero diagonal entry taken as 1."""
    safe = torch.where(diag == 0, torch.ones_like(diag), diag)
    inv = 1.0 / safe

    def precond(r):
        return inv * r

    return precond


def _padded_diag(a_sp, n_pad, device=DEFAULT):
    d = np.asarray(a_sp.diagonal())
    if n_pad and n_pad > d.shape[0]:
        d = np.concatenate([d, np.ones(n_pad - d.shape[0], d.dtype)])
    return torch.from_numpy(d).to(require(device))


def make_direct_inverse(mat, kind: str, *, pivot: float = 1e-6,
                        offset: float = 0.0, scale: float = 1.0,
                        n_pad: int = 0) -> np.ndarray:
    """Host direct factorization -> explicit identity-padded inverse (a
    numpy array), applied on the device as one product.

    ``kind`` mirrors arpackSolver's Eigen direct solvers
    (arpackmm.cpp:445-463, arpackSolver.hpp:1030-1130):

    * ``LU``: partial-pivoting LU (sparse input above n = 256 uses SuperLU
      with ``diag_pivot_thresh=pivot``, arpackSolver.hpp:1055);
    * ``QR``: column-pivoted Householder QR; ``pivot`` is the
      rank-deficiency threshold on ``|diag(R)|`` (arpackSolver.hpp:1110);
    * ``LLT``: Cholesky, SPD matrices only (``ValueError`` otherwise);
    * ``LDLT``: Bunch-Kaufman symmetric-indefinite LDL^T (LAPACK sysv).

    ``offset``/``scale`` apply to the Cholesky family as
    ``scale*S + offset*I`` (Eigen setShift, arpackSolver.hpp:1071-1079)."""
    from .operator import _pad_mat

    kind = kind.upper()
    is_sparse = sp.issparse(mat)
    n = mat.shape[0]
    n_pad = n_pad or n
    if kind in ("LLT", "LDLT") and (offset != 0.0 or scale != 1.0):
        eye = sp.eye(n, dtype=mat.dtype, format="csr") if is_sparse \
            else np.eye(n, dtype=mat.dtype)
        mat = scale * mat + offset * eye
    if kind == "LU" and is_sparse and n > 256:
        a = sp.csc_matrix(mat)
        if np.issubdtype(a.dtype, np.floating) and a.dtype != np.float64:
            a = a.astype(np.float64)
        if np.issubdtype(a.dtype, np.complexfloating) \
                and a.dtype != np.complex128:
            a = a.astype(np.complex128)
        lu = spla.splu(a, diag_pivot_thresh=pivot)
        inv_n = lu.solve(np.eye(n, dtype=a.dtype)).astype(mat.dtype)
        inv = np.eye(n_pad, dtype=mat.dtype)
        inv[:n, :n] = inv_n
    else:
        m = _pad_mat(mat.toarray() if is_sparse else np.asarray(mat), n_pad,
                     fill_identity=True)
        eye = np.eye(n_pad, dtype=m.dtype)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if kind == "LU":
                lu, piv = sla.lu_factor(m)
                inv = sla.lu_solve((lu, piv), eye)
            elif kind == "QR":
                q, r, p = sla.qr(m, pivoting=True)
                dr = np.abs(np.diag(r))
                if dr.min() <= pivot * max(dr.max(), 1e-300):
                    raise ValueError(
                        f"QR: matrix numerically rank-deficient at pivot "
                        f"threshold {pivot} (min|R_ii|/max|R_ii| = "
                        f"{dr.min() / dr.max():.2e})")
                x = sla.solve_triangular(r, q.conj().T, lower=False)
                inv = np.empty_like(x)
                inv[p, :] = x
            elif kind == "LLT":
                try:
                    c = sla.cho_factor(m, lower=True)
                except np.linalg.LinAlgError as e:
                    raise ValueError(
                        "LLT requires an SPD matrix (Cholesky failed: "
                        f"{e}); use LDLT or LU") from e
                inv = sla.cho_solve(c, eye)
            elif kind == "LDLT":
                herm = np.iscomplexobj(m)
                inv = sla.solve(m, eye, assume_a="her" if herm else "sym")
            else:
                raise ValueError(
                    f"unknown direct solver kind {kind!r}; expected "
                    "LU | QR | LLT | LDLT")
    if not np.all(np.isfinite(inv)):
        raise ValueError(
            f"{kind}: factored matrix is numerically singular (the shift "
            "appears to be an eigenvalue); perturb sigma")
    return inv


def ilu0_preconditioner(a_sp, *, sweeps: int = 3, dtype=None,
                        n_pad: int = 0, symmetric: bool = False,
                        drop_tol: float = 0.0, fill_factor: float = 1.0,
                        device=DEFAULT) -> Callable:
    """ILU(0) preconditioner (arpackmm's ``ILU`` option) applied on
    ``device`` (the card unless told otherwise).

    Host side (once): SuperLU incomplete LU with zero fill, natural column
    ordering and no row pivoting, in float64 (complex128).  Device side
    (per application): the two triangular solves are replaced by
    ``sweeps`` steps of the truncated Neumann series

        inv(L) r  ~= sum_k (-Ls)^k r          (L unit lower)
        inv(U) y  ~= sum_k (inv(D)(-Us))^k inv(D) y

    over the strict triangles ``Ls``/``Us`` as DIA products.
    ``symmetric=True`` builds the IC(0)-class form ``p(L)^T D^-1 p(L)``
    that CG needs (symmetric positive semidefinite by construction).

    Falls back to Jacobi, with a warning, where the factorization fails,
    where SuperLU had to permute (a structurally zero diagonal), where the
    exact factor does not contract a random residual (an indefinite
    matrix), and where the strict lower triangle spreads over more than
    128 diagonals."""
    from .sparse import _to_dia, dia_matvec_fn

    device = require(device)
    n = a_sp.shape[0]
    n_pad = n_pad or n
    A = sp.csc_matrix(a_sp)
    if dtype is not None:
        A = A.astype(dtype)
    if np.issubdtype(A.dtype, np.floating) and A.dtype != np.float64:
        A = A.astype(np.float64)          # SuperLU wants d/z
    try:
        ilu = spla.spilu(A, drop_tol=drop_tol, fill_factor=fill_factor,
                         permc_spec="NATURAL", diag_pivot_thresh=0.0)
    except RuntimeError as e:             # singular ILU pivot
        warnings.warn(f"ILU(0) factorization failed ({e}); "
                      "falling back to Jacobi", stacklevel=2)
        return jacobi_preconditioner(_padded_diag(a_sp, n_pad, device))
    idperm = np.arange(n)
    if not (np.array_equal(ilu.perm_r, idperm)
            and np.array_equal(ilu.perm_c, idperm)):
        warnings.warn("ILU(0) required pivoting (zero structural "
                      "diagonal); falling back to Jacobi to stay "
                      "gather-free on device", stacklevel=2)
        return jacobi_preconditioner(_padded_diag(a_sp, n_pad, device))
    # quality probe: the ILU(0) of an indefinite matrix can amplify
    # rather than precondition; reject a factor whose exact application
    # does not contract the residual
    rng = np.random.default_rng(11)
    rp = rng.standard_normal(n)
    if np.iscomplexobj(A):
        rp = rp + 1j * rng.standard_normal(n)
    with np.errstate(all="ignore"):
        zp = ilu.solve(rp.astype(A.dtype))
        q = np.linalg.norm(rp - A @ zp) / np.linalg.norm(rp)
    if not np.isfinite(q) or q >= 1.0:
        warnings.warn(
            f"ILU(0) quality probe {q:.2f} >= 1 (indefinite/unstable "
            "incomplete factorization amplifies); falling back to Jacobi",
            stacklevel=2)
        return jacobi_preconditioner(_padded_diag(a_sp, n_pad, device))

    out_dtype = np.dtype(dtype) if dtype is not None else a_sp.dtype
    L = ilu.L.tocsr()
    U = ilu.U.tocsr()
    if drop_tol == 0.0 and fill_factor == 1.0:
        # ILU(0) keeps only the pattern of A: SuperLU still scatters a
        # little fill onto off-pattern diagonals, which would widen the
        # DIA form
        csr = a_sp.tocsr()
        patt = sp.csr_matrix(
            (np.ones_like(csr.data, dtype=np.float64), csr.indices,
             csr.indptr), shape=A.shape)
        L = L.multiply(patt).tocsr()
        U = U.multiply(patt).tocsr()
        du = np.asarray(ilu.U.diagonal())
        U = U + sp.diags(du - U.diagonal())
    ls = sp.tril(L, -1).tocsr()
    ndiag = len(np.unique(
        ls.tocoo().col.astype(np.int64) - ls.tocoo().row.astype(np.int64)
    )) if ls.nnz else 0
    if ndiag > 128:
        warnings.warn(
            f"ILU factor spreads over {ndiag} distinct diagonals — the "
            "gather-free DIA application would materialize "
            f"~{ndiag * n * 8 / 1e9:.1f} GB; falling back to Jacobi "
            "(raise drop_tol to thin the factor)", stacklevel=2)
        return jacobi_preconditioner(_padded_diag(a_sp, n_pad, device))
    d_u = np.asarray(U.diagonal())
    d_u = np.where(d_u == 0, 1.0, d_u)

    def dia_of(tri):
        off, diags = _to_dia(tri)
        return dia_matvec_fn(off, [d.astype(out_dtype) for d in diags], n,
                             n, device=device)

    lmv = dia_of(ls)
    dinv = torch.from_numpy((1.0 / d_u).astype(out_dtype)).to(device)

    def padded(r, y):
        if r.shape[0] == n:
            return y
        out = torch.zeros(r.shape, dtype=y.dtype, device=y.device)
        out[:n] = y
        return out

    if symmetric:
        # IC(0)-class: M^-1 = p(L)^T D^-1 p(L), SPD for CG
        ltmv = dia_of(ls.T.tocsr())

        def precond(r):
            rn = r[:n].contiguous()
            z = rn
            for _ in range(sweeps):       # z ~= inv(L) r
                z = rn - lmv(z)
            v = dinv * z
            y = v
            for _ in range(sweeps):       # y ~= inv(L^T) v
                y = v - ltmv(y)
            return padded(r, y)

        return precond

    umv = dia_of(sp.triu(U, 1).tocsr())

    def precond(r):
        rn = r[:n].contiguous()
        z = rn
        for _ in range(sweeps):           # L z = r, unit diagonal
            z = rn - lmv(z)
        y0 = dinv * z
        y = y0
        for _ in range(sweeps):           # U y = z
            y = y0 - dinv * umv(y)
        return padded(r, y)

    return precond


def make_iterative_solve(matvec: Callable, *, symmetric: bool,
                         tol: float = 1e-10, maxiter: int = 1000,
                         precond: Optional[Callable] = None) -> Callable:
    """Wrap a shifted matvec ``v -> (A - sigma M) v`` into ``solve(b)`` for
    :func:`~arpack_ng_tpu_torch.ops.transforms.shift_invert_operator`: CG
    (``symmetric``) or BiCGSTAB.  ``solve.iterations`` lists each call's
    iteration count."""
    inner = _cg if symmetric else _bicgstab
    run = partial(inner, matvec, x0=None, tol=tol, maxiter=maxiter,
                  precond=precond)

    def solve(b):
        x, it = run(b)
        solve.iterations.append(it)
        return x

    solve.iterations = []
    return solve

"""Iterative and direct linear solvers for matrix-free shift-invert (port
of ``arpack_ng_tpu/ops/solvers.py``).

The reference's C++ layer offers a mode-solver menu, direct (LU/QR/LLT/
LDLT) and iterative (CG/BiCG with diagonal or ILU preconditioning), to
apply ``inv(A - sigma*B)`` inside the RCI loop (arpackmm.cpp:445-476
``--slv CG|BiCG|LU|QR...``).

* :func:`cg` and :func:`bicgstab`: the reference's ``lax.while_loop``
  Krylov iterations, with the same update order and the same test before
  each iteration (``|r.r| > (tol*||b||)^2`` and ``it < maxiter``;
  BiCGSTAB also restarts where the reference would divide by a zero
  ``rho``).  One iteration is :func:`cg_step` / :func:`bicgstab_step`
  (torch ops, no device read: the plain version, which runs on the CPU);
  on a card an iteration updates the loop's buffers in place, its products
  and dots as in those steps and every vector pass between the dots a
  fused update kernel of :mod:`~arpack_ng_tpu_torch.ops.cuda_krylov_loop`,
  bit for bit the steps' torch ops.  :func:`cg`, :func:`bicgstab` and an
  unbound solve of :func:`make_iterative_solve` run a host loop that reads
  the test back once per iteration; a solve bound to a card runs each call
  as one conditional WHILE node of a CUDA graph (the capturing one, or one
  of its own), the test in the body's last update kernel, bit for bit the
  host loop, so an operator built on it is capturable;
* :func:`jacobi_preconditioner` (the reference's ``Diag`` option) and
  :func:`ilu0_preconditioner` (its ``ILU`` option): the incomplete
  factorization runs once on the host (SuperLU, natural ordering, zero
  fill) and each application replaces the two triangular solves by
  fixed-sweep truncated Neumann series over the strict triangles in DIA
  form, each sweep one product with its subtraction (and scaling) fused
  (:func:`~arpack_ng_tpu_torch.ops.sparse.dia_sub_fn`: the DIA kernel's
  epilogue form on the card).  Both write into a given ``out``, the loop's
  ``z``;
* :func:`make_direct_inverse`: a host factorization turned into an
  explicit identity-padded inverse, applied on the device as one product.
"""
from __future__ import annotations

import warnings
from typing import Callable, Optional

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..utils.device import DEFAULT, normalized, require
from . import cuda_krylov_loop as kl
from .cuda_dia import SCALE_SUB, SUB, SUB_SCALED


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
    """One CG iteration on the state of :func:`cg_start`, no device read:
    the update kernels' plain twins (torch ops), new tensors."""
    x, r, z, p, rz = c
    ap = matvec(p)
    x, r = kl.cg_xr_plain(rz, _vdot(p, ap), x, r, p, ap)
    z = precond(r) if precond is not None else r
    rz_new = _vdot(r, z)
    p = kl.cg_p_plain(rz_new, rz, z, p)
    return (x, r, z, p, rz_new)


def _cg_carry(c, precond, own_x=False):
    """CG's state as the loop's buffers ``[x, r, z, p, rz, rz_prev]``,
    which :func:`_cg_iteration` updates in place: ``z`` is ``r`` itself
    without a preconditioner, ``p`` a copy of ``z``, ``rz_prev`` the
    update kernels' copy of ``rz``; ``own_x``: copy ``x`` (a caller's
    ``x0``)."""
    x, r, z, p, rz = c
    if precond is None:
        z = r
    return [x.clone() if own_x else x, r, z, p.clone(), rz,
            torch.empty_like(rz)]


def _precond_into(precond, r, out) -> None:
    """``out = precond(r)``: written in place by a preconditioner that
    takes ``out`` (``writes_out``), copied from any other."""
    if getattr(precond, "writes_out", False):
        precond(r, out=out)
    else:
        out.copy_(precond(r))


def _cg_iteration(matvec, s, precond, test=None):
    """One CG iteration on the loop's buffers ``s`` (:func:`_cg_carry`),
    in place: the product and the dots, then :func:`~arpack_ng_tpu_torch.
    ops.cuda_krylov_loop.cg_xr`, the preconditioner into ``z`` and
    ``cg_p_test``, bit for bit :func:`cg_step`; with ``test`` (a
    ``LoopTest``) the last kernel runs the loop test on ``|r.r|`` and the
    decision is returned on the CPU (None on a card or without a test)."""
    x, r, z, p, rz, rz_prev = s
    ap = matvec(p)
    kl.cg_xr(rz, _vdot(p, ap), x, r, p, ap, rz_prev)
    if precond is not None:
        _precond_into(precond, r, z)
    rzn = _vdot(r, z)
    rr = _vdot(r, r) if test is not None else None
    return kl.cg_p_test(rzn, rz_prev, z, p, rz, rr=rr, test=test)


def _read_loop(r, atol2, maxiter, step) -> int:
    """The host loop on a card: the reference's test before the first
    iteration read back, then ``step(test)`` (an iteration in place whose
    last kernel writes the decision into ``test.go``) and one read of the
    decision per iteration.  Returns the iteration count."""
    dev = r.device
    test = kl.LoopTest(atol2, torch.zeros((), dtype=torch.int32, device=dev),
                       maxiter,
                       go=torch.zeros((), dtype=torch.int32, device=dev))
    it = 0
    go = it < maxiter and bool(torch.abs(_vdot(r, r)) > atol2)
    while go:
        step(test)
        it += 1
        go = bool(test.go.item())
    return it


def _cg(matvec, b, x0, tol, maxiter, precond):
    c, atol2 = cg_start(matvec, b, x0, tol, precond)
    if b.is_cuda:
        s = _cg_carry(c, precond, own_x=x0 is not None)
        it = _read_loop(s[1], atol2, maxiter,
                        lambda t: _cg_iteration(matvec, s, precond, t))
        return s[0], it
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


def bicgstab_start(matvec: Callable, b: torch.Tensor, x0=None,
                   tol: float = 1e-8):
    """BiCGSTAB's state ``(x, r, rhat, rho, alpha, omega, v, p)`` before
    the first iteration, and the squared absolute tolerance."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros_like(b)
    bnorm = torch.sqrt(torch.abs(_vdot(b, b)))
    return (x, r, r, one, one, one, zero, zero), (tol * bnorm) ** 2


def bicgstab_step(matvec: Callable, c, precond: Optional[Callable] = None,
                  brk: Optional[torch.Tensor] = None):
    """One BiCGSTAB iteration on the state of :func:`bicgstab_start`, no
    device read: the update kernels' plain twins (torch ops), new tensors.
    Where the last step's ``rho`` came out exactly 0 (``r`` orthogonal to
    the shadow residual; ``brk``, 0-d bool, or ``rho == 0`` when not
    given) the next ``beta`` would divide by it and turn the solve to nan:
    the iteration restarts from the current residual (``rhat = r``, ``rho
    = alpha = omega = 1``, ``v = p = 0``), by selects that keep every
    value's bits."""
    x, r, rhat, rho, alpha, omega, v, p = c
    if brk is None:
        brk = rho == 0
    rhat = torch.where(brk, r, rhat)
    rho_new = _vdot(rhat, r)
    p = kl.bicg_p_plain(brk, rho_new, rho, alpha, omega, r, p, v)
    ph = precond(p) if precond is not None else p
    v = matvec(ph)
    alpha, s = kl.bicg_s_plain(rho_new, _vdot(rhat, v), r, v)
    sh = precond(s) if precond is not None else s
    t = matvec(sh)
    omega, r = kl.bicg_r_plain(_vdot(t, s), _vdot(t, t), s, t)
    x = kl.bicg_x_plain(alpha, omega, x, ph, sh)
    return (x, r, rhat, rho_new, alpha, omega, v, p)


def _bicg_carry(c, own_x=False):
    """BiCGSTAB's state as the loop's buffers ``[x, r, rhat, rho, alpha,
    omega, v, p, brk]``, each in storage of its own, which
    :func:`_bicg_iteration` updates in place; ``brk``: the restart flag
    (0-d bool, False)."""
    carry = _distinct(c)
    if own_x:
        carry[0] = carry[0].clone()
    return carry + [torch.zeros((), dtype=torch.bool, device=c[1].device)]


def _bicg_iteration(matvec, s, precond, test=None):
    """One BiCGSTAB iteration on the loop's buffers ``s``
    (:func:`_bicg_carry`), in place: the products, the preconditioner and
    the dots, the vector passes between them the update kernels
    (``bicg_p``, ``bicg_s``, ``bicg_r``, ``bicg_x_test``), bit for bit
    :func:`bicgstab_step`; with ``test`` the last kernel runs the loop test
    and the decision is returned on the CPU (None on a card or without a
    test)."""
    x, r, rhat, rho, alpha, omega, v, p, brk = s
    rho_new = _vdot(rhat, r)
    kl.bicg_p(brk, rho_new, rho, alpha, omega, r, p, v)
    ph = precond(p) if precond is not None else p
    vn = matvec(ph)
    sv = kl.bicg_s(rho_new, _vdot(rhat, vn), r, vn, v, rho, alpha)
    sh = precond(sv) if precond is not None else sv
    t = matvec(sh)
    kl.bicg_r(_vdot(t, sv), _vdot(t, t), sv, t, r, omega)
    rr = _vdot(r, r) if test is not None else None
    return kl.bicg_x_test(alpha, omega, x, ph, sh, rho, rhat, r, brk, rr=rr,
                          test=test)


def _bicgstab(matvec, b, x0, tol, maxiter, precond):
    c, atol2 = bicgstab_start(matvec, b, x0, tol)
    if b.is_cuda:
        s = _bicg_carry(c, own_x=x0 is not None)
        it = _read_loop(s[1], atol2, maxiter,
                        lambda t: _bicg_iteration(matvec, s, precond, t))
        return s[0], it
    it = 0
    # the reference's loop test, one device read
    while it < maxiter and bool(torch.abs(_vdot(c[1], c[1])) > atol2):
        c = bicgstab_step(matvec, c, precond)
        it += 1
    return c[0], it


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

    def precond(r, out=None):
        return torch.mul(inv, r, out=out)

    precond.writes_out = True
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

    over the strict triangles ``Ls``/``Us`` as DIA products, each sweep
    one launch with its subtraction (the DIA kernel's epilogue form on the
    card), bit for bit the product and the torch ops it fuses.
    ``symmetric=True`` builds the IC(0)-class form ``p(L)^T D^-1 p(L)``
    that CG needs (symmetric positive semidefinite by construction).  The
    returned ``precond(r, out=None)`` writes ``out`` where given.

    Falls back to Jacobi, with a warning, where the factorization fails,
    where SuperLU had to permute (a structurally zero diagonal), where the
    exact factor does not contract a random residual (an indefinite
    matrix), and where the strict lower triangle spreads over more than
    128 diagonals."""
    from .sparse import _to_dia, dia_sub_fn

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

    def sweep_of(tri):
        off, diags = _to_dia(tri)
        return dia_sub_fn(off, [d.astype(out_dtype) for d in diags], n, n,
                          device=device)

    lsub = sweep_of(ls)
    dinv = torch.from_numpy((1.0 / d_u).astype(out_dtype)).to(device)
    if symmetric:
        # IC(0)-class: M^-1 = p(L)^T D^-1 p(L), SPD for CG
        tsub, form, dt = sweep_of(ls.T.tocsr()), SUB, None
    else:
        tsub, form, dt = sweep_of(sp.triu(U, 1).tocsr()), SUB_SCALED, dinv

    def precond(r, out=None):
        """``z ~= M^-1 r``, into ``out`` (r's shape, not ``r``) or a new
        vector: each sweep one DIA launch with its subtraction, the last L
        sweep scaled by ``D^-1`` (as ``dinv * z`` after it), ILU(0)'s U
        sweeps ``y0 - D^-1 (U y)``; the sweeps' outputs ping-pong between
        two buffers, ``v = D^-1 z`` in a third, the last into ``out``."""
        rn = r[:n].contiguous()
        dt_out = torch.promote_types(r.dtype, dinv.dtype)
        full = torch.empty(r.shape, dtype=dt_out, device=r.device) \
            if out is None else out
        dst = full[:n]
        buf = [torch.empty(n, dtype=dt_out, device=r.device)
               for _ in range(3)]
        z = rn
        for k in range(sweeps):           # z ~= inv(L) r, unit diagonal
            last = k == sweeps - 1
            z = lsub(z, rn, dinv if last else None,
                     SCALE_SUB if last else SUB,
                     out=buf[0] if last else buf[1 + k % 2])
        v = z if sweeps else dinv * rn
        y = v
        for k in range(sweeps):           # y ~= inv(L^T) v, or inv(U) v
            y = tsub(y, v, dt, form,
                     out=dst if k == sweeps - 1 else buf[1 + k % 2])
        if not sweeps:
            dst.copy_(v)
        if full.shape[0] > n:
            full[n:].zero_()
        return full

    precond.writes_out = True
    return precond


def _distinct(c):
    """The state ``c`` with every tensor in storage of its own: the loop's
    buffers, which its iterations update in place."""
    seen, out = set(), []
    for t in c:
        if t.data_ptr() in seen:
            t = t.clone()
        seen.add(t.data_ptr())
        out.append(t)
    return out


def _loop(start, step, b, tol, maxiter, log, brk_flag, pool=None):
    """One solve as :func:`~arpack_ng_tpu_torch.ops.cuda_krylov_loop.
    run_while`: ``start(b, tol)`` gives the loop's buffers and ``atol2``,
    ``step(carry, test)`` runs one iteration on them in place, ending with
    the loop test, until the reference's test stops it (a WHILE node
    inside a capture, the node's CPU form on CPU tensors); ``brk_flag``:
    BiCGSTAB's buffers, whose restart flag the test before the node sets.
    Returns ``x``."""
    carry, atol2 = start(b, tol)
    it = torch.zeros((), dtype=torch.int32, device=b.device)
    kl.run_while(torch.abs(_vdot(carry[1], carry[1])), atol2, it, maxiter,
                 lambda test: step(carry, test), log=log, pool=pool,
                 rho=carry[3] if brk_flag else None,
                 brk=carry[8] if brk_flag else None)
    return carry[0]


class IterativeSolve:
    """``solve(b)`` of :func:`make_iterative_solve`.  ``iterations``: each
    call's iteration count, in call order; ``on_graph``: whether the call
    ran as a WHILE node.  A solve bound to a card (:meth:`bind`) runs
    every call there as one WHILE node (:func:`_loop`): inside a CUDA-graph
    capture as a node of that graph, elsewhere as a graph of its own,
    captured and replayed once (:meth:`_once`); its counts are read after
    the next synchronisation (the device loop's packet, or
    ``iterations``), never per iteration.  An unbound solve runs the host
    loop, the plain version: on the CPU, and on a card where the caller
    did not declare the operator capturable."""

    def __init__(self, matvec, symmetric, tol, maxiter, precond):
        self.matvec, self.symmetric = matvec, symmetric
        self.tol, self.maxiter, self.precond = tol, maxiter, precond
        self.on_graph = []        # per call: whether it ran as a node
        self._its = []
        self._log = None
        self._held = []           # graphs of their own, until read

    def bind(self, device) -> None:
        """Make ready to run on the CUDA ``device`` as WHILE nodes: raise
        where its graphs cannot hold them (CUDA < 12.4); build the kernels,
        the iteration log, the body stream and the pools, outside any
        capture.  ``shift_invert_operator(capturable=True)`` calls it."""
        device = torch.device(*normalized(device))
        if self._log is not None and self._log.device == device:
            return
        kl.require(device)
        kl.body_stream(device)
        self._log = kl.IterationLog(device)
        self._stream = torch.cuda.Stream(device=device)
        # pools that live as long as the solve (made and freed outside any
        # capture): its graphs of their own, which come and go, and its
        # loops' bodies in every graph
        self._pools = (torch.cuda.MemPool(), torch.cuda.MemPool())

    def _start(self, b, tol):
        """The loop's buffers and ``atol2`` (:func:`_loop`)."""
        if self.symmetric:
            c, atol2 = cg_start(self.matvec, b, None, tol, self.precond)
            return _cg_carry(c, self.precond), atol2
        c, atol2 = bicgstab_start(self.matvec, b, None, tol)
        return _bicg_carry(c), atol2

    def _step(self, carry, test):
        if self.symmetric:
            return _cg_iteration(self.matvec, carry, self.precond, test)
        return _bicg_iteration(self.matvec, carry, self.precond, test)

    def settle(self) -> None:
        """After a synchronisation with the graphs that hold this solve's
        loops: their iteration counts, read from the log."""
        its = self._log.drain()
        self._its.extend(its)
        self.on_graph.extend([True] * len(its))
        self._held.clear()

    @property
    def iterations(self) -> list:
        log = self._log
        if log is not None and log.nodes:
            if log.device.type == "cuda":
                torch.cuda.synchronize(log.device)
            self.settle()
        return self._its

    def _once(self, b):
        """The solve outside a capture: a graph of its own, captured on the
        solve's stream in its pools and replayed once, kept until its
        count is read."""
        from ..core.loop import CapturedGraph

        cur = torch.cuda.current_stream(b.device)
        self._stream.wait_stream(cur)
        with torch.cuda.stream(self._stream):
            graph = CapturedGraph(lambda: self(b), self._pools[0].id)
            x = graph.replay()
        cur.wait_stream(self._stream)
        self._held.append(graph)
        return x

    def __call__(self, b):
        if b.is_cuda and self._log is not None:
            if not torch.cuda.is_current_stream_capturing():
                return self._once(b)
            self.bind(b.device)
            kl.note(self)
            return _loop(self._start, self._step, b, self.tol, self.maxiter,
                         self._log, not self.symmetric, self._pools[1])
        if b.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "an iterative solve is captured only once bound to the card "
                "(shift_invert_operator(capturable=True) binds it)")
        inner = _cg if self.symmetric else _bicgstab
        x, it = inner(self.matvec, b, None, self.tol, self.maxiter,
                      self.precond)
        self._its.append(it)
        self.on_graph.append(False)
        return x


def make_iterative_solve(matvec: Callable, *, symmetric: bool,
                         tol: float = 1e-10, maxiter: int = 1000,
                         precond: Optional[Callable] = None
                         ) -> IterativeSolve:
    """Wrap a shifted matvec ``v -> (A - sigma M) v`` into ``solve(b)`` for
    :func:`~arpack_ng_tpu_torch.ops.transforms.shift_invert_operator`: CG
    (``symmetric``) or BiCGSTAB, a host loop or, bound to a card, one
    CUDA-graph WHILE node per call (:class:`IterativeSolve`).
    ``solve.iterations`` lists each call's iteration count."""
    return IterativeSolve(matvec, symmetric, tol, maxiter, precond)

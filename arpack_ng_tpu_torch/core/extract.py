"""Eigenpair extraction: the dseupd / dneupd / zneupd equivalent (port of
``arpack_ng_tpu/core/extract.py`` for modes 1-2).

* re-derive the reduced eigensystem from the final H on the host in
  float64, complex128 for complex dtypes (the tridiagonal solve, real for
  a Hermitian problem, or LAPACK geev of the Hessenberg) and re-apply the
  eps^(2/3)
  convergence test (dseupd re-solves at :536; a count mismatch with the
  iteration phase is reference info = -14);
* select the converged wanted subset per ``which``; for real
  non-symmetric problems a conjugate pair is never split at the boundary,
  so nev+1 values may come back (dneupd);
* form Ritz vectors on the basis' device with one GEMM: ``S^T V`` (complex
  for a complex basis), or for complex Ritz vectors of a real basis the
  stacked ``[Re; Im]`` GEMM; or, with ``howmny='P'``, the Schur vectors of
  the wanted invariant subspace (a sorted real or complex Schur form from
  ``scipy.linalg.schur`` on the host);
* output order: ascending (symmetric; Hermitian values are real, their
  vectors complex), wanted first (non-symmetric);
* ``howmny='S'``: values and vectors only for the flagged Ritz values of
  a ``select`` mask that converged (see :func:`_select`);
* untransform the values and Ritz estimates of the spectral-transform
  modes: SHIFTI ``lambda = sigma + 1/theta``, BUCKLE ``lambda =
  sigma*theta/(theta-1)``, CAYLEY ``lambda = sigma*(theta+1)/(theta-1)``
  (SRC/dseupd.f:656-683, :762-790); non-symmetric shift-invert ``lambda =
  sigma + 1/theta`` (SRC/dneupd.f), replaced by Rayleigh quotients of the
  raw operator for a complex shift in real arithmetic (dndrv5/6);
* purify the Ritz vectors of generalized modes 3/4/5 by one formal step of
  inverse subspace iteration, ``z += resid * (last_comp/theta)`` (SHIFTI,
  CAYLEY) or ``/(theta-1)`` (BUCKLE) (SRC/dseupd.f:817-843).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import scipy.linalg as sla
import torch

from ..config import IRAMConfig
from ..ops.operator import Operator
from ..utils import dtypes as _dt
from . import reduced
from .iram import IRAMResult


@dataclasses.dataclass
class EigenResult:
    """User-facing solve output (dseupd outputs d, z + iparam info)."""

    values: np.ndarray             # (nconv,) eigenvalues, ascending
    vectors: Optional[np.ndarray]  # (n, nconv) or None if rvec=False
    nconv: int
    info: int
    bounds: np.ndarray             # Ritz estimates
    n_iter: int
    stats: object
    validation: object = None      # the F64Validation report of
    #   ``validate=``, attached by the API


def _untransform(theta: np.ndarray, mode: int, sigma: complex,
                 symmetric: bool) -> np.ndarray:
    if mode in (1, 2):
        return theta.copy()
    if mode == 3:
        return sigma + 1.0 / theta
    if mode == 4 and symmetric:    # buckling
        return sigma * theta / (theta - 1.0)
    if mode == 5 and symmetric:    # Cayley
        return sigma * (theta + 1.0) / (theta - 1.0)
    # non-symmetric mode 4 (a complex shift in real arithmetic): the
    # shift-invert relation, replaced by Rayleigh quotients in extract()
    return sigma + 1.0 / theta


def _untransform_bounds(bounds: np.ndarray, theta: np.ndarray, mode: int,
                        sigma: complex, symmetric: bool) -> np.ndarray:
    """Ritz estimates in the original system (SRC/dseupd.f:762-790)."""
    if mode in (1, 2):
        return bounds.copy()
    if mode == 3:
        return np.abs(bounds) / np.abs(theta) ** 2
    if mode == 4 and symmetric:
        return np.abs(sigma) * np.abs(bounds) / np.abs(theta - 1.0) ** 2
    if mode == 5 and symmetric:
        return np.abs(bounds / theta * (theta - 1.0))
    return np.abs(bounds) / np.abs(theta) ** 2


def extract(op: Operator, cfg: IRAMConfig, result: IRAMResult,
            rvec: bool = True, howmny: str = "A",
            select: Optional[np.ndarray] = None,
            use_rayleigh: Optional[bool] = None) -> EigenResult:
    """dseupd/dneupd: values (and vectors with ``rvec``) of the solve in
    ``result``.  ``use_rayleigh``: replace the values by Rayleigh quotients
    of the raw operator (default: for a complex shift in real arithmetic,
    non-symmetric modes 3/4)."""
    if howmny not in ("A", "P", "S"):
        raise ValueError(f"howmny must be 'A', 'P' or 'S', not {howmny!r}")
    sym = cfg.symmetric
    is_cplx = _dt.is_complex(cfg.dtype)
    host_dtype = _dt.host_dtype(cfg.dtype)
    state = result.state
    tol, eps23 = cfg.tol_effective, cfg.eps23
    rnorm = float(state.rnorm)
    info = result.info if result.info in (1, 2) else 0

    H = np.asarray(state.H).astype(host_dtype)
    if sym and cfg.restart == "thick":
        # the projected matrix from the upper triangle: the dgks extension
        # writes whole projection columns there after a thick restart (the
        # subdiagonal holds the recurrence's beta writes)
        T = np.triu(H.real) + np.triu(H.real, 1).T
        theta_all, S = np.linalg.eigh(T)
        bounds_all = np.abs(rnorm * S[-1, :])
    elif sym:
        alpha = np.diag(H).real.copy()
        beta = np.diag(H, -1).real.copy()
        theta_all, bounds_all, S = reduced.sym_eigt(alpha, beta, rnorm)
    else:
        theta_all, bounds_all, S = reduced.nonsym_eigt(H, rnorm)

    # ---- converged subset (dseupd re-test; mismatch -> info=-14) ----
    idx_conv = np.where(reduced.conv_mask(theta_all, bounds_all, tol,
                                          eps23))[0]
    nconv = result.nconv
    if len(idx_conv) < nconv:
        info = -14
        nconv = len(idx_conv)
    if nconv == 0:
        return EigenResult(values=np.zeros(0, host_dtype), vectors=None,
                           nconv=0,
                           info=info, bounds=np.zeros(0),
                           n_iter=result.n_iter, stats=result.stats)

    real_pairs = (not sym) and (not is_cplx)
    if howmny == "S":
        sel = _select(select, result.ritz, theta_all, idx_conv, eps23,
                      real_pairs)
        nconv = len(sel)
        if nconv == 0:
            return EigenResult(values=np.zeros(0, host_dtype), vectors=None,
                               nconv=0, info=info, bounds=np.zeros(0),
                               n_iter=result.n_iter, stats=result.stats)
    elif sym and cfg.which == "BE":
        # nconv//2 from the low end, the rest from the high end
        # (dsgets.f:166-171)
        order = np.argsort(theta_all[idx_conv], kind="stable")
        half_lo = nconv // 2
        half_hi = nconv - half_lo
        pick = np.concatenate([order[:half_lo],
                               order[len(order) - half_hi:]])
    else:
        key = reduced.sort_key(cfg.which, theta_all[idx_conv], real_pairs)
        pick = np.argsort(key, kind="stable")[len(idx_conv) - nconv:]
    if howmny != "S":
        sel = idx_conv[np.sort(pick)]
        if real_pairs:
            # dneupd may return nev+1 values rather than split a conjugate
            # pair at the selection boundary (scipy allocates k+1 slots)
            selset = set(sel.tolist())
            for i in sel:
                ti = theta_all[i]
                if ti.imag == 0:
                    continue
                partner = np.where(
                    np.isclose(theta_all[idx_conv], np.conj(ti)))[0]
                if len(partner) and idx_conv[partner[0]] not in selset:
                    sel = np.sort(np.append(sel, idx_conv[partner[0]]))
                    nconv += 1
                    break

    theta = theta_all[sel]
    sigma = op.sigma
    lam = _untransform(theta, op.mode, sigma, sym)
    lam_bounds = _untransform_bounds(bounds_all[sel], theta, op.mode, sigma,
                                     sym)
    if sym:
        lam = lam.real
    # output order: ascending for symmetric problems (dseupd's final dsortr
    # 'LA', :697-707), wanted first for non-symmetric ones (dneupd)
    if sym:
        order_out = np.argsort(lam, kind="stable")
    else:
        order_out = np.argsort(
            -reduced.sort_key(cfg.which, lam, real_pairs), kind="stable")
    theta, lam, lam_bounds, sel = (theta[order_out], lam[order_out],
                                   lam_bounds[order_out], sel[order_out])

    vectors = None
    if rvec:
        if howmny == "P" and not sym:
            # Schur basis of the wanted invariant subspace (dneupd
            # howmny='P'): reorder the real Schur form of H so the selected
            # values lead and take the first nconv Schur vectors
            wanted_vals = theta_all[sel]

            def _sort(w_r, w_i=None):
                w = complex(w_r) if w_i is None else complex(w_r) \
                    + 1j * complex(w_i)
                return bool(np.min(np.abs(wanted_vals - w))
                            < 1e-8 * max(1.0, abs(w)))

            _, QQ, _ = sla.schur(H, output="complex" if is_cplx else "real",
                                 sort=_sort)
            Scols = QQ[:, :nconv]
        else:
            Scols = S[:, sel]
            if not sym:
                # unit 2-norm Ritz vectors in the small system (the basis
                # is orthonormal, so Z inherits it; dneupd via dtrevc)
                Scols = Scols / np.linalg.norm(Scols, axis=0, keepdims=True)
        Z = _basis_product(Scols, state.V, cfg.dtype)
        if op.mode in (3, 4, 5) and op.bmat == "G" and howmny != "P":
            # purification (SRC/dseupd.f:817-843)
            last = Scols[-1, :]
            coef = last / theta if op.mode in (3, 5) else \
                last / (theta - 1.0)
            Z = Z + coef[:, None] * state.resid.cpu().numpy().astype(
                host_dtype)[None, :]
        if use_rayleigh is None:
            s_arr = np.array(sigma)
            use_rayleigh = (not sym) and op.mode in (3, 4) \
                and op.a_apply is not None and np.iscomplexobj(s_arr) \
                and s_arr.imag != 0
        if use_rayleigh and op.a_apply is not None:
            lam = _rayleigh(op, cfg, Z)
        vectors = Z[:, : cfg.n].T  # (n, nconv)
        if op.perm is not None:
            # internal row i holds logical coordinate perm[i]
            unperm = np.empty_like(vectors)
            unperm[np.asarray(op.perm)] = vectors
            vectors = unperm

    return EigenResult(values=lam, vectors=vectors, nconv=nconv, info=info,
                       bounds=lam_bounds, n_iter=result.n_iter,
                       stats=result.stats)


def _rayleigh(op: Operator, cfg: IRAMConfig, Z: np.ndarray) -> np.ndarray:
    """Rayleigh quotients ``z^H A z / z^H M z`` (``M = I`` for
    ``bmat='I'``) of the rows of ``Z`` through the raw device products: the
    reference's value recovery for a complex shift in real arithmetic
    (dndrv5/6)."""
    tdt = _dt.torch_dtype(cfg.dtype)

    def to_dev(x):
        # contiguous: the DIA kernel refuses strided vectors
        return torch.from_numpy(np.ascontiguousarray(x.astype(cfg.dtype))
                                ).to(dtype=tdt, device=op.device)

    def apply_c(fn, z):
        """A (possibly real-dtype) device product on a host vector."""
        if np.iscomplexobj(z) and not _dt.is_complex(cfg.dtype):
            return fn(to_dev(z.real)).cpu().numpy() \
                + 1j * fn(to_dev(z.imag)).cpu().numpy()
        return fn(to_dev(z)).cpu().numpy()

    lam = np.zeros(Z.shape[0], np.complex128)
    for i, z in enumerate(Z):
        az = apply_c(op.a_apply, z)
        mz = apply_c(op.m_apply, z) if (op.m_apply is not None
                                         and op.bmat == "G") else z
        lam[i] = np.vdot(z, az) / np.vdot(z, mz)
    return lam


def _select(select, ritz_iter, theta_all, idx_conv, eps23, real_pairs
            ) -> np.ndarray:
    """The re-solved spectrum's indices for ``howmny='S'`` (the documented
    SELECT semantics of SRC/dseupd.f:62-66 and dneupd.f:60-66, which the
    Fortran library leaves unimplemented): ``select[j]`` flags the j-th
    Ritz value of the final factorization in the exit order
    (``ritz_iter``).  Each flagged value maps to the nearest converged
    value of ``theta_all`` within ``max(sqrt(eps23), 1e-8)`` relative, each
    taken once; flags on unconverged values are dropped.  In real
    arithmetic a selected member of a conjugate pair brings its partner
    (real storage holds both halves).  Returns the sorted indices."""
    if select is None:
        raise ValueError("howmny='S' requires a select mask")
    select_m = np.asarray(select, bool).ravel()
    ritz_iter = np.asarray(ritz_iter)
    if select_m.shape[0] != len(ritz_iter):
        raise ValueError(
            f"select must have length ncv={len(ritz_iter)} "
            "(one flag per Ritz value of the final factorization)")
    gate = max(np.sqrt(eps23), 1e-8)
    avail = list(idx_conv)
    sel_list = []
    for w in ritz_iter[select_m]:
        if not avail:
            break
        j = min(avail, key=lambda t: abs(theta_all[t] - w))
        if abs(theta_all[j] - w) <= gate * max(1.0, abs(w)):
            sel_list.append(j)
            avail.remove(j)
    if real_pairs:
        for j in list(sel_list):
            tj = theta_all[j]
            if tj.imag == 0:
                continue
            have = any(np.isclose(theta_all[p], np.conj(tj))
                       for p in sel_list if p != j)
            if not have:
                cand = [p for p in avail
                        if np.isclose(theta_all[p], np.conj(tj))]
                if cand:
                    sel_list.append(cand[0])
                    avail.remove(cand[0])
    return np.sort(np.array(sel_list, dtype=int))


def _basis_product(Scols: np.ndarray, V: torch.Tensor, dtype) -> np.ndarray:
    """``Scols^T V`` on the basis' device, one GEMM in the compute dtype,
    returned on the host as ``(m, n_pad)``: float64; complex128 for a
    complex basis (a complex GEMM) or for complex ``Scols`` of a real basis
    (the real GEMM of the stacked ``[Re; Im]`` coefficients, dneupd's packed
    pair storage)."""
    tdt = _dt.torch_dtype(dtype)
    m = Scols.shape[1]
    if _dt.is_complex(dtype):
        s_dev = torch.from_numpy(np.ascontiguousarray(
            Scols.T.astype(dtype))).to(V.device)
        return (s_dev @ V).cpu().numpy().astype(np.complex128)
    cplx = np.iscomplexobj(Scols)
    coef = np.concatenate([Scols.real.T, Scols.imag.T]) if cplx else Scols.T
    s_dev = torch.from_numpy(np.ascontiguousarray(coef.astype(dtype))).to(
        V.device)
    z = (s_dev @ V.to(tdt)).cpu().numpy().astype(np.float64)
    return z[:m] + 1j * z[m:] if cplx else z

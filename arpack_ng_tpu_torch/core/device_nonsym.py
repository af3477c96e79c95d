"""Complex non-symmetric restart cycle driven from the host (port of
``arpack_ng_tpu/core/device_nonsym.py``): the znaupd/znaup2 major
iteration in complex arithmetic, and through :func:`complexify_operator`
the same cycle for real non-symmetric problems (``eigs(strategy='fused')``).

* Extension by the CGS + DGKS Arnoldi step of ``core/arnoldi.py`` on the
  operator's device.
* **Schur form** of the (ncv, ncv) Hessenberg by a single-shift complex QR
  iteration with Wilkinson shifts (dlahqr's role, SRC/dneigh.f:194): each
  sweep takes one explicit QR of ``H - mu I`` (mu from the trailing active
  2x2), applies the unitary similarity, truncates to Hessenberg and
  deflates negligible subdiagonals, within a budget of ``4 ncv`` sweeps; a
  sweep with no active subdiagonal changes nothing, so the loop stops
  there.
* **Ritz bounds** = rnorm * |last component of the unit eigenvector of
  H| (dneigh.f:213), by masked triangular solves on the Schur factor with
  dtrevc's smallnum clamp.
* Shift selection, the convergence count, the zero-bound rule and nev
  inflation as the reference computes them, and the shifts applied as
  one explicit complex QR each (znapps), largest bound first, deflating
  after each; then the kev-row basis rotation (a complex torch GEMM) and
  the residual update.

The reference package runs this cycle (``make_cplx_cycle``) inside one
device computation in the problem dtype; here it is ``tail(head(state),
is_last)``, its reduced-space steps in numpy in the same complex dtype
(complex64 for float32 input) and the same order of operations, the O(n)
work on the operator's device, and the restart loop on the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import scipy.linalg as sla
import torch

from ..config import IRAMConfig
from ..ops.operator import Operator
from ..utils import dtypes as _dt
from ..utils.debug import debug, trace
from . import reduced
from .arnoldi import (FactorizationState, make_bnorm, make_extend,
                      restart_tail)
from .iram import HostLoopSolver

#: QR-iteration sweep budget per cycle, in units of ncv (Wilkinson-shifted
#: single-shift QR converges in ~2-3 sweeps per eigenvalue)
_SWEEPS_PER_EV = 4


def split_complex(v: torch.Tensor) -> torch.Tensor:
    """``(2, n)`` contiguous real rows ``[Re v; Im v]`` of a complex
    vector: the real operator's kernels take contiguous vectors, and the
    real and imaginary parts of a complex tensor are strided views."""
    return torch.view_as_real(v).t().contiguous()


def _lift(fn):
    """``v -> fn(Re v) + i fn(Im v)`` for a real matvec ``fn``."""
    if fn is None:
        return None

    def g(v):
        xy = split_complex(v)
        return torch.complex(fn(xy[0]), fn(xy[1]))

    return g


def complexify_operator(op: Operator) -> Operator:
    """Lift a real-dtype operator to complex arithmetic: the operator is
    applied to the real and imaginary parts apart (two real matvecs per
    complex matvec), each a contiguous real vector.  Carries the
    permutation, padding, shift, device, capturability, mesh and the
    lifted B, A and M products over."""
    if _dt.is_complex(op.dtype):
        return op
    cdt = np.dtype(np.complex64 if op.dtype == np.float32
                   else np.complex128)

    def apply(v, bv):
        xy = split_complex(v)
        bxy = xy if bv is v else split_complex(bv)
        wr, bwr = op.apply(xy[0], bxy[0])
        wi, bwi = op.apply(xy[1], bxy[1])
        w = torch.complex(wr, wi)
        if bwr is wr and bwi is wi:
            return w, w
        return w, torch.complex(bwr, bwi)

    return Operator(n=op.n, dtype=cdt, apply=apply, bmat=op.bmat,
                    mode=op.mode,
                    b_apply=_lift(op.b_apply) if op.bmat == "G" else None,
                    a_apply=_lift(op.a_apply), m_apply=_lift(op.m_apply),
                    n_pad=op.n_pad, sigma=op.sigma, hermitian=False,
                    perm=op.perm, format=op.format, device=op.device,
                    capturable=op.capturable, mesh=op.mesh)


def _which_key_cplx(which: str, vals):
    """Sort key on complex values; ascending puts the WANTED values last."""
    if which == "LM":
        return np.abs(vals)
    if which == "SM":
        return -np.abs(vals)
    if which == "LR":
        return vals.real
    if which == "SR":
        return -vals.real
    if which == "LI":
        return vals.imag
    if which == "SI":
        return -vals.imag
    raise ValueError(f"bad which={which!r}")


def _deflate(T, eps):
    """Zero negligible subdiagonals; returns ``(T', keep)``, ``keep[i]``
    for each subdiagonal that stays."""
    sub = np.diag(T, -1)
    d = np.diag(T)
    big = np.abs(d[:-1]) + np.abs(d[1:])
    big = np.where(big == 0, np.ones_like(big), big)
    keep = np.abs(sub) > eps * big
    sub2 = np.where(keep, sub, np.zeros_like(sub))
    return np.triu(T, 0) + np.diag(sub2, -1), keep


def make_hessenberg_schur(k: int, cdt, sweeps: int):
    """Schur decomposition of a complex Hessenberg matrix:
    ``schur(H) -> (T upper-triangular, Q unitary)``, ``H = Q T Q^H``."""
    cdt = np.dtype(cdt)
    rdt = _dt.real_dtype(cdt)
    eps = rdt.type(_dt.eps(cdt))
    eye = np.eye(k, dtype=cdt)
    idx1 = np.arange(k - 1)

    def schur(H):
        T, Q = H.astype(cdt), eye
        for _ in range(sweeps):
            T, keep = _deflate(T, eps)
            if not keep.any():
                break
            # the trailing active 2x2: the largest i with keep[i]
            m = max(int(np.max(np.where(keep, idx1, -1))), 0)
            a11, a12 = T[m, m], T[m, m + 1]
            a21, a22 = T[m + 1, m], T[m + 1, m + 1]
            tr = a11 + a22
            det = a11 * a22 - a12 * a21
            disc = np.sqrt(tr * tr / 4.0 - det)
            mu1 = tr / 2.0 + disc
            mu2 = tr / 2.0 - disc
            mu = mu1 if np.abs(mu1 - a22) < np.abs(mu2 - a22) else mu2
            q, _ = np.linalg.qr(T - mu * eye)
            T = np.triu(q.conj().T @ T @ q, -1)     # re-Hessenberg
            Q = Q @ q
        T, _ = _deflate(T, eps)
        return T, Q

    return schur


def make_last_components(k: int, cdt):
    """``last_comps(T, Q)``: for every eigenvalue ``lambda_i = T[i, i]`` of
    the Schur pair (T, Q) of H, the modulus of the LAST component of the
    unit eigenvector of H, which dneigh feeds the Ritz bounds.

    The eigenvector of T for lambda_i: ``z[:i]`` solves ``(T[:i, :i] -
    lambda_i) u = -T[:i, i]``, ``z[i] = 1``, ``z[i+1:] = 0``; diagonal
    entries of modulus below ``eps max(max|T|, 1)`` are clamped to it
    (dtrevc's smallnum, for degenerate eigenvalues)."""
    cdt = np.dtype(cdt)
    rdt = _dt.real_dtype(cdt)
    eps = rdt.type(_dt.eps(cdt))

    def last_comps(T, Q):
        tnorm = np.maximum(np.max(np.abs(T)), rdt.type(1))
        small = eps * tnorm
        lam = np.diag(T)
        qlast = Q[k - 1, :]
        out = np.zeros(k, rdt)
        for i in range(k):
            z = np.zeros(k, cdt)
            z[i] = 1
            if i > 0:
                M = T[:i, :i] - lam[i] * np.eye(i, dtype=cdt)
                d = np.diag(M)
                dsafe = np.where(np.abs(d) < small, small.astype(cdt), d)
                M[np.arange(i), np.arange(i)] = dsafe
                z[:i] = sla.solve_triangular(M, -T[:i, i], lower=False)
            znorm = np.sqrt(np.abs(np.vdot(z, z)))
            out[i] = np.abs(qlast @ z) / znorm
        return out

    return last_comps


class CplxCycleOut(NamedTuple):
    state: FactorizationState
    done: bool
    nconv: int
    ritz_s: np.ndarray    # (ncv,) which-sorted Ritz values, wanted last
    bounds_s: np.ndarray  # (ncv,)


class CplxHeadOut(NamedTuple):
    """What the restart tail needs from the first half of a cycle
    (extension, dneigh, dngets, dnconv, nev inflation)."""

    state: FactorizationState
    r_s: np.ndarray
    b_s: np.ndarray
    nconv: int
    done: bool
    nev_eff: int
    np_eff: int


def make_cplx_head(op: Operator, cfg: IRAMConfig):
    """Build ``head(state) -> CplxHeadOut``: znaup2 from the extension
    through the shift count (znaitr, zneigh, zngets, znconv, the zero-bound
    shift removal and nev inflation)."""
    if cfg.symmetric:
        raise ValueError("use device_sym for symmetric problems")
    if not _dt.is_complex(cfg.dtype):
        raise ValueError("complex dtype required (complexify the operator)")
    ncv, nev0 = cfg.ncv, cfg.nev
    np0 = ncv - nev0
    cdt = np.dtype(cfg.dtype)
    rdt = _dt.real_dtype(cdt)
    tol = rdt.type(cfg.tol_effective)
    eps23 = rdt.type(cfg.eps23)
    extend = make_extend(op, cfg)
    schur = make_hessenberg_schur(ncv, cdt, sweeps=_SWEEPS_PER_EV * ncv)
    last_comps = make_last_components(ncv, cdt)

    def head(state: FactorizationState) -> CplxHeadOut:
        state = extend(state, ncv)
        # ---- zneigh: Schur + Ritz values + bounds ----
        T, Qs = schur(state.H)
        lam = np.diag(T)
        bounds = (state.rnorm * last_comps(T, Qs)).astype(rdt)
        # ---- zngets: wanted last ----
        order = np.argsort(_which_key_cplx(cfg.which, lam), kind="stable")
        r_s, b_s = lam[order], bounds[order]
        # ---- znconv over the nev0 wanted ----
        wanted, wb = r_s[np0:], b_s[np0:]
        nconv = int(np.sum(wb <= tol * np.maximum(eps23, np.abs(wanted))))
        nz = int(np.sum(b_s[:np0] == 0))
        np_eff, nev_eff = np0 - nz, nev0 + nz
        done = nconv >= nev0 or np_eff == 0
        trace(debug.maup2, 0, "_cplx_cycle: iter {i}: nconv={nc} rnorm={rn}",
              i=state.iter, nc=nconv, rn=state.rnorm)
        trace(debug.maup2, 1, "_cplx_cycle: ritz (wanted last) {r}\n"
              " _cplx_cycle: bounds {b}", r=r_s, b=b_s)
        # ---- nev inflation (znaup2.f, as dsaup2.f:673-693) ----
        nev_inf = nev_eff + min(nconv, np_eff // 2)
        if nev_inf == 1 and ncv >= 6:
            nev_inf = ncv // 2
        elif nev_inf == 1 and ncv > 3:
            nev_inf = 2
        nev_eff = min(nev_inf, ncv - 1)
        np_eff = ncv - nev_eff
        return CplxHeadOut(state=state, r_s=r_s, b_s=b_s, nconv=nconv,
                           done=done, nev_eff=nev_eff, np_eff=np_eff)

    return head


def make_cplx_tail(op: Operator, cfg: IRAMConfig):
    """Build the exact-shift restart tail ``tail(h, is_last) ->
    CplxCycleOut`` (znapps with the shifts from zngets)."""
    ncv, nev0 = cfg.ncv, cfg.nev
    np0 = ncv - nev0
    cdt = np.dtype(cfg.dtype)
    rdt = _dt.real_dtype(cdt)
    eps_m = rdt.type(_dt.eps(cdt))
    iota = np.arange(ncv)
    eyek = np.eye(ncv, dtype=cdt)
    bnorm = make_bnorm(op, cfg)

    def apply_shifts(h: CplxHeadOut) -> FactorizationState:
        state, nev_eff, np_eff = h.state, h.nev_eff, h.np_eff
        # the np_eff least-wanted values, largest bound first
        active = (iota < np_eff)[:np0]
        skey = np.where(active, -np.abs(h.b_s[:np0]), rdt.type(np.inf))
        shifts = h.r_s[:np0][np.argsort(skey, kind="stable")]
        Hc, Q = state.H.astype(cdt), eyek
        for mu, act in zip(shifts, active):
            if not act:
                continue
            q, _ = np.linalg.qr(Hc - mu * eyek)
            # deflation after each shift (dnapps.f:328-336)
            Hc, _ = _deflate(np.triu(q.conj().T @ Hc @ q, -1), eps_m)
            Q = Q @ q
        sigmak = Q[ncv - 1, nev_eff - 1]
        betak = Hc[nev_eff, nev_eff - 1]
        # znapps-parity kev-row update of the basis (rows 0..nev_eff of
        # Q^T V survive the restart)
        return restart_tail(op, cfg, bnorm, state, Q, Hc, sigmak, betak,
                            nev_eff)

    def tail(h: CplxHeadOut, is_last: bool) -> CplxCycleOut:
        if h.done or is_last:
            # exit before znapps: keep the full factorization
            state = h.state.replace(iter=h.state.iter + 1)
        else:
            state = apply_shifts(h)
        return CplxCycleOut(state=state, done=h.done, nconv=h.nconv,
                            ritz_s=h.r_s, bounds_s=h.b_s)

    return tail


class FusedNonsymSolver(HostLoopSolver):
    """znaupd-equivalent driver over the complex cycle, with the name of the
    reference package's driver; serves real non-symmetric problems through
    :func:`complexify_operator`.  The restart loop runs on the host.
    ``mesh``: see :class:`HostLoopSolver`."""

    def __init__(self, op: Operator, cfg: IRAMConfig, mesh=None):
        if not _dt.is_complex(cfg.dtype):
            raise ValueError(
                "FusedNonsymSolver needs a complex dtype; use "
                "complexify_operator + a complex IRAMConfig for real input")
        if not cfg.exact_shifts:
            raise ValueError("fused path requires exact shifts")
        super().__init__(op, cfg, make_cplx_head, make_cplx_tail, mesh)

    def _start(self, state: FactorizationState) -> CplxCycleOut:
        cdt = np.dtype(self.cfg.dtype)
        return CplxCycleOut(state=state, done=False, nconv=0,
                            ritz_s=np.zeros(self.cfg.ncv, cdt),
                            bounds_s=np.zeros(self.cfg.ncv,
                                              _dt.real_dtype(cdt)))

    def _exit(self, out: CplxCycleOut):
        cfg = self.cfg
        r_s = np.asarray(out.ritz_s).astype(np.complex128)
        b_s = np.asarray(out.bounds_s).astype(np.float64)
        r_x, b_x = reduced.exit_sort(cfg.which, cfg.nev, out.nconv,
                                     r_s.copy(), b_s.copy(), cfg.eps23,
                                     False, False)
        info = 1 if (out.state.iter >= cfg.max_iter
                     and out.nconv < cfg.nev) else 0
        return r_x, b_x, info

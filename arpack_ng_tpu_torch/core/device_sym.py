"""Symmetric restart cycle driven from the host (port of
``arpack_ng_tpu/core/device_sym.py``).

One major iteration of dsaup2: factorization extension (dsaitr), the
tridiagonal eigensolve (dseigt), shift selection (dsgets), the convergence
count (dsconv), nev inflation, the implicit exact-shift QR with
accumulated Q (dsapps), the kev-row basis rotation and the residual
update.  The reference package fuses the whole loop into one device
computation; here the loop runs on the host, the O(n) work (extension,
rotation, norms) on the operator's device and the ncv-sized reduced work
in numpy, in the compute dtype, exactly as the reference computes it on
its device.

Not ported yet: ``restart='thick'`` and caller-supplied shifts
(``shift_fn``); both raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import IRAMConfig
from ..ops.operator import Operator
from ..utils import dtypes as _dt
from ..utils.debug import debug, trace
from ..utils.stats import SolverStats, Timers
from . import reduced
from .arnoldi import (FactorizationState, _host, make_bnorm, make_extend,
                      make_init, rotate_basis_kev)
from .iram import IRAMResult


def _which_key(which: str, vals):
    """Sort key: ascending order puts the WANTED nev last (dsortr)."""
    if which == "LA":
        return vals
    if which == "SA":
        return -vals
    if which == "LM":
        return np.abs(vals)
    if which == "SM":
        return -np.abs(vals)
    raise ValueError(f"device path does not support which={which!r}")


class CycleOut(NamedTuple):
    state: FactorizationState
    done: bool          # exit condition fired (excl. maxiter)
    nconv: int
    ritz_s: np.ndarray  # (ncv,) which-sorted Ritz values (wanted last)
    bounds_s: np.ndarray


class HeadOut(NamedTuple):
    """What the restart tail needs from the first half of a cycle
    (extend + dseigt + dsgets + dsconv + nev inflation)."""

    state: FactorizationState
    T: np.ndarray        # (ncv, ncv) tridiagonal projected matrix
    r_s: np.ndarray      # which-sorted Ritz values, nev0 arrangement
    b_s: np.ndarray      # matching bounds
    r_si: np.ndarray     # which-sorted with the INFLATED nev (differs
    b_si: np.ndarray     #   from r_s/b_s only for which='BE')
    nconv: int
    done: bool
    nev_eff: int         # after zero-bound removal + inflation
    np_eff: int


def _make_be_arrange(ncv: int):
    """'BE' arrangement over the ascending order: [unwanted middle, low
    half, high half]; low share nev//2 (dsgets.f:166-171)."""
    iota = np.arange(ncv)

    def be_arrange(vals_a, nev):
        lo = nev // 2
        hi = nev - lo
        np_ = ncv - nev
        src = np.where(iota < np_, lo + iota,
                       np.where(iota < np_ + lo, iota - np_,
                                (ncv - hi) + (iota - np_ - lo)))
        return vals_a[src]

    return be_arrange


def make_sym_head(op: Operator, cfg: IRAMConfig, inflate: bool = True):
    """Build ``head(state) -> HeadOut``: dsaup2 from the extension through
    shift-count fixing (dsaitr, dseigt, dsgets, dsconv, the zero-bound
    shift removal and the stagnation nev inflation, dsaup2.f:368-693)."""
    if not cfg.symmetric:
        raise ValueError("the symmetric cycle is for symmetric problems")
    if cfg.restart == "thick":
        raise NotImplementedError("restart='thick' is not ported yet")
    ncv, nev0 = cfg.ncv, cfg.nev
    np0 = ncv - nev0
    rdt = _dt.real_dtype(cfg.dtype)
    tol = rdt.type(cfg.tol_effective)
    eps23 = rdt.type(cfg.eps23)
    extend = make_extend(op, cfg)
    be_arrange = _make_be_arrange(ncv) if cfg.which == "BE" else None

    def head(state: FactorizationState) -> HeadOut:
        state = extend(state, ncv)
        # ---- dseigt ----
        d = np.diag(state.H).real.astype(rdt)
        e = np.diag(state.H, -1).real.astype(rdt)
        T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
        evals, S = np.linalg.eigh(T)
        bounds = np.abs(state.rnorm * S[ncv - 1, :]).astype(rdt)
        # ---- dsgets: wanted last ----
        if cfg.which == "BE":
            order_a = np.argsort(evals, kind="stable")
            r_a, b_a = evals[order_a], bounds[order_a]
            r_s, b_s = be_arrange(r_a, nev0), be_arrange(b_a, nev0)
        else:
            order = np.argsort(_which_key(cfg.which, evals), kind="stable")
            r_s, b_s = evals[order], bounds[order]
        # ---- dsconv over the nev0 wanted ----
        wanted, wb = r_s[np0:], b_s[np0:]
        nconv = int(np.sum(wb <= tol * np.maximum(eps23, np.abs(wanted))))
        # ---- zero-bound unwanted (cannot be shifted away) ----
        nz = int(np.sum(b_s[:np0] == 0))
        np_eff = np0 - nz
        nev_eff = nev0 + nz
        done = nconv >= nev0 or np_eff == 0
        trace(debug.maup2, 0, "_sym_cycle: iter {i}: nconv={nc} rnorm={rn}",
              i=state.iter, nc=nconv, rn=state.rnorm)
        trace(debug.maup2, 1, "_sym_cycle: ritz (wanted last) {r}\n"
              " _sym_cycle: bounds {b}", r=r_s, b=b_s)
        trace(debug.meigt, 0, "_sym_cycle: eigenvalues of T {e}", e=evals)
        if inflate:
            # stagnation guard: nev inflation (dsaup2.f:673-693)
            nev_inf = nev_eff + min(nconv, np_eff // 2)
            if nev_inf == 1 and ncv >= 6:
                nev_inf = ncv // 2
            elif nev_inf == 1 and ncv > 3:
                nev_inf = 2
            nev_eff = min(nev_inf, ncv - 1)
            np_eff = ncv - nev_eff
        if cfg.which == "BE":
            # the BE split moves with the inflated nev (dsaup2.f:690-693)
            r_si, b_si = be_arrange(r_a, nev_eff), be_arrange(b_a, nev_eff)
        else:
            r_si, b_si = r_s, b_s
        return HeadOut(state=state, T=T, r_s=r_s, b_s=b_s,
                       r_si=r_si, b_si=b_si, nconv=nconv, done=done,
                       nev_eff=nev_eff, np_eff=np_eff)

    return head


def make_sym_tail(op: Operator, cfg: IRAMConfig):
    """Build the exact-shift restart tail ``tail(h, is_last) -> CycleOut``
    (dsapps with the shifts from dsgets)."""
    ncv, nev0 = cfg.ncv, cfg.nev
    np0 = ncv - nev0
    rdt = _dt.real_dtype(cfg.dtype)
    eps_m = rdt.type(_dt.eps(cfg.dtype))
    is_g = op.bmat == "G"
    iota = np.arange(ncv)
    bnorm = make_bnorm(op, cfg)
    device = op.device
    tdt = _dt.torch_dtype(cfg.dtype)

    def apply_shifts(h: HeadOut) -> FactorizationState:
        state = h.state
        nev_eff, np_eff = h.nev_eff, h.np_eff
        # exact shifts: the np_eff least-wanted values, largest Ritz
        # estimate first; masked-out slots are skipped
        active = (iota < np_eff)[:np0]
        skey = np.where(active, -np.abs(h.b_si[:np0]), rdt.type(np.inf))
        shifts = h.r_si[:np0][np.argsort(skey, kind="stable")]
        eyek = np.eye(ncv, dtype=rdt)
        Tc, Q = h.T, eyek
        for mu, act in zip(shifts, active):
            if not act:
                continue
            q, _ = np.linalg.qr(Tc - mu * eyek)
            Tn = q.T @ Tc @ q
            dn = np.diag(Tn)
            en = 0.5 * (np.diag(Tn, 1) + np.diag(Tn, -1))
            Tc = np.diag(dn) + np.diag(en, 1) + np.diag(en, -1)
            Q = Q @ q
        dn = np.diag(Tc).copy()
        en = np.diag(Tc, -1).copy()
        # deflation sweep (dsapps.f:430-443)
        big = np.abs(dn[:-1]) + np.abs(dn[1:])
        en = np.where(np.abs(en) <= eps_m * big, rdt.type(0), en)
        # subdiagonal sign normalization via a diagonal similarity
        sgn = np.where(en >= 0, rdt.type(1), rdt.type(-1))
        phi = np.concatenate([np.ones(1, rdt), np.cumprod(sgn)])
        en = np.abs(en)
        Q = (Q * phi[None, :]).astype(rdt)
        H_new = (np.diag(dn) + np.diag(en, 1)
                 + np.diag(en, -1)).astype(cfg.dtype)
        sigmak = Q[ncv - 1, nev_eff - 1]
        betak = en[nev_eff - 1] if nev_eff < ncv else rdt.type(0)
        # dsapps-parity kev-row update of the basis (SRC/dsapps.f:445-481)
        Q_dev = torch.from_numpy(np.ascontiguousarray(Q)).to(
            device=device, dtype=tdt)
        V, v_next, rots = rotate_basis_kev(Q_dev, state.V, nev_eff)
        resid = (float(sigmak) * state.resid
                 + float(betak) * v_next.to(tdt))
        b_resid = op.b_apply(resid) if is_g else resid
        counts = state.counts.add(nbx=1 if is_g else 0, nrotr=rots)
        rnorm = _host(bnorm(resid, b_resid), rdt)
        return state.replace(V=V, H=H_new, resid=resid, b_resid=b_resid,
                             rnorm=rnorm, k=nev_eff, nev_cur=nev_eff,
                             iter=state.iter + 1, counts=counts)

    def tail(h: HeadOut, is_last: bool) -> CycleOut:
        if h.done or is_last:
            # exit before dsapps: keep the full factorization
            state = h.state.replace(iter=h.state.iter + 1)
        else:
            state = apply_shifts(h)
        return CycleOut(state=state, done=h.done, nconv=h.nconv,
                        ritz_s=h.r_s, bounds_s=h.b_s)

    return tail


class FusedSymSolver:
    """dsaupd-equivalent driver over the symmetric cycle, with the name of
    the reference package's driver.  The restart loop runs on the host."""

    def __init__(self, op: Operator, cfg: IRAMConfig):
        if not cfg.exact_shifts:
            raise NotImplementedError("caller-supplied shifts (shift_fn) "
                                      "are not ported yet")
        self.op, self.cfg = op, cfg
        self._init = make_init(op, cfg)
        self._head = make_sym_head(op, cfg)
        self._tail = make_sym_tail(op, cfg)

    def init_state(self, gen: Optional[torch.Generator] = None, v0=None
                   ) -> FactorizationState:
        if v0 is None:
            return self._init(gen, None)
        v0 = np.asarray(v0)
        if self.op.perm is not None and v0.shape[0] == self.cfg.n:
            v0 = v0[np.asarray(self.op.perm)]
        if v0.shape[0] == self.cfg.n and self.cfg.n_pad != self.cfg.n:
            v0p = np.zeros((self.cfg.n_pad,), v0.dtype)
            v0p[: self.cfg.n] = v0
            v0 = v0p
        return self._init(gen, v0.astype(self.cfg.dtype))

    def solve(self, gen: Optional[torch.Generator] = None, v0=None,
              state: Optional[FactorizationState] = None) -> IRAMResult:
        cfg = self.cfg
        ncv = cfg.ncv
        rdt = _dt.real_dtype(cfg.dtype)
        dev = self.op.device
        timers = Timers()
        with timers.timed("taupd", dev):
            if state is None:
                with timers.timed("tgetv0", dev):
                    state = self.init_state(gen=gen, v0=v0)
            if state.info < 0:
                z = np.zeros(ncv)
                return self._result(state, z, z, 0, state.info, 0, timers)
            out = CycleOut(state=state, done=False, nconv=0,
                           ritz_s=np.zeros(ncv, rdt),
                           bounds_s=np.zeros(ncv, rdt))
            while (not out.done and out.state.iter < cfg.max_iter
                   and out.state.info == 0):
                is_last = out.state.iter + 1 >= cfg.max_iter
                with timers.timed("taitr", dev):
                    h = self._head(out.state)
                with timers.timed("tapps", dev):
                    out = self._tail(h, is_last)
        state = out.state
        it, info = state.iter, state.info
        if info != 0:
            z = np.zeros(ncv)
            return self._result(state, z, z, 0,
                                -9999 if info > 0 else info, it, timers)
        nconv = out.nconv
        r_s = np.asarray(out.ritz_s, np.float64)
        b_s = np.asarray(out.bounds_s, np.float64)
        r_x, b_x = reduced.exit_sort(cfg.which, cfg.nev, nconv, r_s.copy(),
                                     b_s.copy(), cfg.eps23, True, False)
        info = 0
        if it >= cfg.max_iter and nconv < cfg.nev:
            info = 1
        np_rem = int(np.count_nonzero(b_s[: ncv - cfg.nev] == 0))
        if (ncv - cfg.nev - np_rem) == 0 and nconv < cfg.nev:
            info = 2
        return self._result(state, r_x, b_x, nconv, info, it, timers)

    def _result(self, state, ritz, bounds, nconv, info, n_iter, timers
                ) -> IRAMResult:
        stats = SolverStats(n_iter=n_iter, n_conv=nconv, timers=timers)
        stats.absorb_counts(state.counts)
        return IRAMResult(ritz=ritz, bounds=bounds, nconv=nconv, info=info,
                          n_iter=n_iter, state=state, stats=stats)

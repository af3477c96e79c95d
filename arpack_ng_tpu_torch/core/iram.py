"""Implicitly-restarted Arnoldi/Lanczos driver (port of
``arpack_ng_tpu/core/iram.py``): the output of the iteration phase
(``IRAMResult``), the host restart loop the cycle drivers share
(``HostLoopSolver``) and the hybrid driver ``IRAMSolver``, the
dsaupd+dsaup2 / dnaupd+dnaup2 / znaupd+znaup2 equivalent.

The hybrid driver splits each cycle as the reference package's
``IRAMSolver.iterate`` does: the extension to ncv steps on the operator's
device, then one read of the projected matrix and the residual norm, the
reduced space on the host in float64 (complex128 for complex dtypes) with
``core/reduced`` (Ritz values and bounds, shift selection, the
convergence count, the zero-bound rule, the exit test, nev inflation, the
shifted QR), then the device tail: the kev-row basis rotation, the
residual update ``r <- sigma_k r + beta_k v_next`` and its B-norm.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import IRAMConfig
from ..ops.operator import Operator
from ..utils import dtypes as _dt
from ..utils.debug import debug, trace
from ..utils.stats import SolverStats, Timers
from . import reduced
from .arnoldi import (FactorizationState, make_bnorm, make_extend,
                      make_init, restart_tail)


@dataclasses.dataclass
class IRAMResult:
    """Output of the iteration phase (input to extraction, cf. dseupd)."""

    ritz: np.ndarray        # (ncv,) exit-ordered Ritz values (conv. first)
    bounds: np.ndarray      # (ncv,) matching Ritz estimates
    nconv: int              # iparam(5)
    info: int               # dsaupd info code (0, 1=maxiter, 2=no shifts,
    #                         <0 errors; SRC/dsaupd.f:247-276)
    n_iter: int             # iparam(3)
    state: FactorizationState
    stats: SolverStats


class HostLoopSolver:
    """The restart loop of a cycle driver, on the host: the start vector
    (dgetv0), ``tail(head(state), is_last)`` until the exit test fires,
    ``max_iter`` cycles have run or the state records an error, then the
    result.  A driver gives the builders of ``head`` and ``tail``, the
    loop's output before its first cycle (:meth:`_start`) and the exit
    ordering and info code (:meth:`_exit`)."""

    def __init__(self, op, cfg, make_head, make_tail):
        self.op, self.cfg = op, cfg
        self._init = make_init(op, cfg)
        self._head = make_head(op, cfg)
        self._tail = make_tail(op, cfg)

    def _start(self, state: FactorizationState):
        raise NotImplementedError

    def _exit(self, out):
        """``(ritz, bounds, info)`` of the last cycle's output ``out``."""
        raise NotImplementedError

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
        dev = self.op.device
        timers = Timers()
        with timers.timed("taupd", dev):
            if state is None:
                with timers.timed("tgetv0", dev):
                    state = self.init_state(gen=gen, v0=v0)
            if state.info < 0:
                z = np.zeros(ncv)
                return self._result(state, z, z, 0, state.info, 0, timers)
            out = self._start(state)
            while (not out.done and out.state.iter < cfg.max_iter
                   and out.state.info == 0):
                is_last = out.state.iter + 1 >= cfg.max_iter
                with timers.timed("taitr", dev):
                    h = self._head(out.state)
                with timers.timed("tapps", dev):
                    out = self._tail(h, is_last)
        state = out.state
        it, info = self._n_iter(out), state.info
        if info != 0:
            z = np.zeros(ncv)
            return self._result(state, z, z, 0,
                                -9999 if info > 0 else info, it, timers)
        ritz, bounds, info = self._exit(out)
        return self._result(state, ritz, bounds, out.nconv, info, it, timers)

    def _n_iter(self, out) -> int:
        """The cycles run (iparam(3)) when the loop handed back ``out``."""
        return out.state.iter

    def _result(self, state, ritz, bounds, nconv, info, n_iter, timers
                ) -> IRAMResult:
        stats = SolverStats(n_iter=n_iter, n_conv=nconv, timers=timers)
        stats.absorb_counts(state.counts)
        return IRAMResult(ritz=ritz, bounds=bounds, nconv=nconv, info=info,
                          n_iter=n_iter, state=state, stats=stats)


class IRAMCycleOut(NamedTuple):
    """One hybrid cycle: the state after it and, when the exit test fired,
    the exit-ordered Ritz values and bounds with the info code."""

    state: FactorizationState
    done: bool
    nconv: int
    ritz: np.ndarray
    bounds: np.ndarray
    info: int


def make_iram_head(op: Operator, cfg: IRAMConfig):
    """``head(state)``: the extension to ncv steps (dsaitr / dnaitr) with
    the event kernels allowed, as the reference's unsharded hybrid builds
    it (``pallas_sel_ok=True``)."""
    extend = make_extend(op, cfg)
    return lambda state: extend(state, cfg.ncv)


def make_iram_tail(op: Operator, cfg: IRAMConfig, shift_fn=None):
    """``tail(state, is_last) -> IRAMCycleOut``: the reduced space of one
    cycle on the host and the device tail (reference
    ``IRAMSolver.iterate``, ``arpack_ng_tpu/core/iram.py:167-306``, from
    the read-back on).  With ``cfg.exact_shifts`` False the caller's
    ``shift_fn(ritz, bounds)`` gives the shifts (the ido=3 protocol,
    SRC/dsaup2.f:700-724): it gets the np unwanted Ritz values and bounds,
    its leading np shifts are applied in the given order, and nev is not
    inflated (dsaup2.f:673)."""
    kplusp, nev0 = cfg.ncv, cfg.nev
    np0 = kplusp - nev0
    sym = cfg.symmetric
    cplx = _dt.is_complex(cfg.dtype)
    host = _dt.host_dtype(cfg.dtype)
    tol, eps23 = cfg.tol_effective, cfg.eps23
    eps_m = _dt.eps(np.float64)      # the host reduced space is float64
    smlnum = _dt.safmin(np.float64) * (kplusp / eps_m)
    real_pairs = (not sym) and (not cplx)
    bnorm = make_bnorm(op, cfg)
    zero = np.zeros(kplusp)

    def tail(state: FactorizationState, is_last: bool) -> IRAMCycleOut:
        cur_iter = state.iter + 1
        if state.info != 0:
            # no kplusp-step factorization even after random restarts: the
            # reference maps this to -9999 (SRC/dsaup2.f:434-443)
            return IRAMCycleOut(state, True, 0, zero, zero,
                                -9999 if state.info > 0 else state.info)
        H = np.asarray(state.H).astype(host)
        rnorm = float(state.rnorm)

        # ---- Ritz values + bounds (dseigt / dneigh) ----
        if sym:
            alpha = np.diag(H).real.copy()
            beta = np.zeros(kplusp)
            if kplusp > 1:
                beta[: kplusp - 1] = np.diag(H, -1).real
            ritz, bounds, _ = reduced.sym_eigt(
                alpha, beta[: kplusp - 1], rnorm, need_vectors=False)
        else:
            ritz, bounds, _ = reduced.nonsym_eigt(H, rnorm)
        trace(debug.maup2, 1, "_aup2: eigenvalues of H {r}", r=ritz)

        # ---- shift selection (dsgets / dngets) ----
        nev, np_ = nev0, np0
        if sym:
            r_s, b_s, shifts = reduced.sym_gets(cfg.which, nev, np_, ritz,
                                                bounds)
        else:
            nev, np_, r_s, b_s, shifts = reduced.nonsym_gets(
                cfg.which, nev, np_, ritz, bounds, real_pairs)

        # ---- convergence count on the nev0 wanted values ----
        nconv = reduced.conv_count(r_s[kplusp - nev0:], b_s[kplusp - nev0:],
                                   tol, eps23)
        trace(debug.maup2, 0, "_aup2: iter {i}: nconv={nc}, rnorm={rn:.3e}",
              i=cur_iter, nc=nconv, rn=rnorm)

        # ---- unremovable (zero-bound) unwanted values (dsaup2.f:500-516)
        nz = int(np.count_nonzero(b_s[:np_] == 0.0))
        np_ -= nz
        nev += nz

        # ---- exit test (dsaup2.f:519-667) ----
        if nconv >= nev0 or cur_iter >= cfg.max_iter or np_ == 0:
            r_x, b_x = reduced.exit_sort(cfg.which, nev0, nconv, r_s.copy(),
                                         b_s.copy(), eps23, sym, real_pairs)
            info = 0
            if cur_iter >= cfg.max_iter and nconv < nev0:
                info = 1
            if np_ == 0 and nconv < nev0:
                info = 2
            return IRAMCycleOut(state, True, nconv, r_x, b_x, info)

        # ---- stagnation guard: inflate nev (dsaup2.f:673-693) ----
        if nconv < nev0 and cfg.exact_shifts:
            nevbef = nev
            nev = nev + min(nconv, np_ // 2)
            if nev == 1 and kplusp >= 6:
                nev = kplusp // 2
            elif nev == 1 and kplusp > 3:
                nev = 2
            np_ = kplusp - nev
            if nevbef < nev:
                if sym:
                    r_s, b_s, shifts = reduced.sym_gets(
                        cfg.which, nev, np_, ritz, bounds)
                else:
                    nev, np_, r_s, b_s, shifts = reduced.nonsym_gets(
                        cfg.which, nev, np_, ritz, bounds, real_pairs)
        if not cfg.exact_shifts:
            shifts = np.asarray(shift_fn(r_s[:np_].copy(),
                                         b_s[:np_].copy()))[:np_]
        trace(debug.mgets, 2, "_aup2: shifts selected {s}", s=shifts[:np_])

        # ---- the shifted QR on the host (dsapps / dnapps / znapps) ----
        if sym:
            alpha2, beta2, Q = reduced.sym_shift_q(
                alpha, beta[: kplusp - 1], shifts[:np_], eps_m)
            betak = float(beta2[nev - 1]) if nev < kplusp else 0.0
            H_new = (np.diag(alpha2) + np.diag(beta2[: kplusp - 1], -1)
                     + np.diag(beta2[: kplusp - 1], 1))
        else:
            H_new, Q = reduced.nonsym_shift_q(H, shifts[:np_], eps_m,
                                              smlnum, real_pairs)
            betak = H_new[nev, nev - 1] if nev < kplusp else 0.0
        sigmak = Q[kplusp - 1, nev - 1]
        state = restart_tail(op, cfg, bnorm, state, Q, H_new, sigmak,
                             betak, nev)
        return IRAMCycleOut(state, False, nconv, zero, zero, 0)

    return tail


class IRAMSolver(HostLoopSolver):
    """The hybrid driver (reference ``arpack_ng_tpu.core.iram.IRAMSolver``):
    the host loop over :func:`make_iram_head` and :func:`make_iram_tail`,
    for symmetric (Hermitian) and non-symmetric, real and complex problems.
    :meth:`iterate` runs one cycle.  ``shift_fn``: the caller's shifts
    (see :func:`make_iram_tail`), for a config with ``exact_shifts``
    False."""

    def __init__(self, op: Operator, cfg: IRAMConfig, shift_fn=None):
        if op.n != cfg.n:
            raise ValueError("operator/config dimension mismatch")
        if op.bmat != cfg.bmat:
            raise ValueError("operator/config bmat mismatch")
        if not cfg.exact_shifts and shift_fn is None:
            raise ValueError("exact_shifts=False requires a shift_fn")
        if cfg.restart != "implicit":
            # the reference's hybrid driver never reads cfg.restart and
            # runs the implicit restart instead (arpack_ng_tpu/api.py:132)
            raise ValueError("the hybrid driver runs the implicit restart "
                             "only; restart='thick' needs strategy='fused'")
        super().__init__(op, cfg, make_iram_head,
                         lambda o, c: make_iram_tail(o, c, shift_fn))

    def _start(self, state: FactorizationState) -> IRAMCycleOut:
        z = np.zeros(self.cfg.ncv)
        return IRAMCycleOut(state, False, 0, z, z, 0)

    def _exit(self, out: IRAMCycleOut):
        return out.ritz, out.bounds, out.info

    def _n_iter(self, out: IRAMCycleOut) -> int:
        # an exit hands back the last cycle's factorization before its
        # shifts with ``iter`` at the cycles before it, as the reference's
        # hybrid driver does: a dump of it resumes by taking that cycle up
        # again under its own number (a run stopped at max_iter continues
        # as the unbroken solve does); the exit cycle counts in n_iter
        return out.state.iter + int(out.done)

    def solve(self, gen: Optional[torch.Generator] = None, v0=None,
              state: Optional[FactorizationState] = None) -> IRAMResult:
        res = super().solve(gen=gen, v0=v0, state=state)
        if debug.maupd > 0:
            print(res.stats.summary())
        return res

    def iterate(self, state: FactorizationState) -> IRAMCycleOut:
        """One major iteration (the dsaup2 1000-loop body)."""
        return self._tail(self._head(state),
                          state.iter + 1 >= self.cfg.max_iter)

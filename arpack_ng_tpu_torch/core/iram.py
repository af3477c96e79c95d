"""Output of the iteration phase (port of ``IRAMResult`` of
``arpack_ng_tpu/core/iram.py``) and the host restart loop the cycle
drivers share.  The hybrid driver ``IRAMSolver`` is not ported yet."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..utils.stats import SolverStats, Timers
from .arnoldi import FactorizationState, make_init


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
        it, info = state.iter, state.info
        if info != 0:
            z = np.zeros(ncv)
            return self._result(state, z, z, 0,
                                -9999 if info > 0 else info, it, timers)
        ritz, bounds, info = self._exit(out)
        return self._result(state, ritz, bounds, out.nconv, info, it, timers)

    def _result(self, state, ritz, bounds, nconv, info, n_iter, timers
                ) -> IRAMResult:
        stats = SolverStats(n_iter=n_iter, n_conv=nconv, timers=timers)
        stats.absorb_counts(state.counts)
        return IRAMResult(ritz=ritz, bounds=bounds, nconv=nconv, info=info,
                          n_iter=n_iter, state=state, stats=stats)

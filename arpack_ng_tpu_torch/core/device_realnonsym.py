"""Real non-symmetric restart cycle (port of
``arpack_ng_tpu/core/device_realnonsym.py``): the dnaupd/dnaup2 major
iteration in real arithmetic.

* Extension by the CGS + DGKS Arnoldi step of ``core/arnoldi.py`` on the
  operator's device, with no device-to-host read (``Extension.run``).
* **Real Schur form** of the (ncv, ncv) Hessenberg by explicit QR sweeps
  (dlahqr's role, SRC/dneigh.f:194): the trailing active 2x2 gives either
  a real Wilkinson shift (QR of ``H - mu I``) or a conjugate pair applied
  as one double shift (QR of ``H^2 - s H + p I``); converged complex 2x2
  blocks are left alone.
* **Eigenvalues** from the 1x1/2x2 diagonal blocks (dlanv2's role),
  exact conjugates by construction.
* **Ritz bounds** = rnorm * |last component of the unit eigenvector of
  H| (dneigh.f:213): dtrevc's quasi-triangular back-substitution in
  explicit (re, im) pair arithmetic, with its smallnum clamping.
* **Shift selection** (dngets): which-keyed stable sort with conjugate
  pairs adjacent (+imag first), the kev+1 boundary adjustment when the cut
  would split a pair (dngets.f:165-176) and the re-check after nev
  inflation.
* **Shift application** (dnapps): an explicit single-shift QR per real
  shift, one double shift per conjugate pair, deflation after each step
  (dnapps.f:328-336); then the kev-row basis rotation (the kernel of
  ``csrc/rot.cu`` on the card) and the residual update.  Where the
  explicit chase loses the Hessenberg form in the columns the restart
  keeps (forward instability of an explicit QR with a near-zero pivot),
  the shifts are applied again by dnapps' implicit bulge chases; the
  reference package keeps the broken chase and loses the Arnoldi relation
  there.

:class:`FusedRealNonsymSolver` runs the restart loop on the operator's
device, the counterpart of the reference's ``make_realnonsym_multi_cycle``:
the shared device loop (``core/loop._DeviceLoop``: per cycle the
previous restart's rotation and residual update and the read-free
extension, one CUDA graph per start ``k`` on a capturable operator), then
the reduced space above as one kernel launch
(``ops/cuda_realnonsym_cycle.py``, ``csrc/realnonsym_cycle.cu``; in float64
whatever the problem dtype), then one read of a small packet.
``make_realnonsym_head`` / ``make_realnonsym_tail`` keep the host loop,
the same reduced space in numpy (the kernel's plain twin's pieces), which
``HostLoopSolver.solve(solver)`` still runs as a witness.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import IRAMConfig
from ..ops.cuda_realnonsym_cycle import (  # noqa: F401
    P_CNT, P_DONE, P_HEAD, P_NCONV, P_RNORM, Params,
    block_disc as _block_disc, deflate_real as _deflate_real, head_plain,
    make_real_last_components, make_real_schur, packet_size,
    real_block_eigs, realnonsym_cycle, shifts_plain,
    which_key_real as _which_key_real)
from ..ops.operator import Operator
from ..utils import dtypes as _dt
from ..utils.debug import debug, trace
from . import reduced
from .arnoldi import (FactorizationState, make_bnorm, make_extend,
                      restart_tail)
from .loop import DeviceLoopSolver


def params(cfg: IRAMConfig) -> Params:
    """The reduced space's parameters: the thresholds in the problem
    dtype."""
    rdt = _dt.real_dtype(cfg.dtype)
    return Params(which=cfg.which, nev=cfg.nev,
                  tol=float(rdt.type(cfg.tol_effective)),
                  eps23=float(rdt.type(cfg.eps23)),
                  eps_m=float(_dt.eps(rdt)), safmin=float(_dt.safmin(rdt)))


class RealCycleOut(NamedTuple):
    state: FactorizationState
    done: bool
    nconv: int
    wr_s: np.ndarray      # (ncv,) which-sorted Ritz real parts, wanted last
    wi_s: np.ndarray      # (ncv,) imaginary parts
    bounds_s: np.ndarray  # (ncv,)


class RealHeadOut(NamedTuple):
    """What the restart tail needs from the first half of a cycle
    (extension, dneigh, dngets, dnconv, nev inflation)."""

    state: FactorizationState
    wr_s: np.ndarray
    wi_s: np.ndarray
    b_s: np.ndarray
    nconv: int
    done: bool
    nev_eff: int
    np_eff: int


def _trace_cycle(it, nconv, rnorm, wr_s, wi_s, b_s) -> None:
    trace(debug.maup2, 0, "_realnonsym_cycle: iter {i}: nconv={nc} "
          "rnorm={rn}", i=it, nc=nconv, rn=rnorm)
    trace(debug.maup2, 1, "_realnonsym_cycle: ritz Re (wanted last) {wr}"
          "\n _realnonsym_cycle: ritz Im {wi}\n _realnonsym_cycle: "
          "bounds {b}", wr=wr_s, wi=wi_s, b=b_s)


def _check_cfg(cfg: IRAMConfig) -> None:
    if cfg.symmetric:
        raise ValueError("use device_sym for symmetric problems")
    if _dt.is_complex(cfg.dtype):
        raise ValueError("the real cycle is for real dtypes")


def make_realnonsym_head(op: Operator, cfg: IRAMConfig):
    """Build ``head(state) -> RealHeadOut``: dnaup2 from the extension
    through the shift count (dnaitr, dneigh, dngets, dnconv, the
    zero-bound shift removal, nev inflation and the pair re-check), the
    reduced space in numpy (``head_plain``, float64)."""
    _check_cfg(cfg)
    extend = make_extend(op, cfg)
    p = params(cfg)

    def head(state: FactorizationState) -> RealHeadOut:
        state = extend(state, cfg.ncv)
        h = head_plain(state.H.astype(np.float64), np.float64(state.rnorm),
                       p)
        _trace_cycle(state.iter, h.nconv, state.rnorm, h.wr_s, h.wi_s, h.b_s)
        return RealHeadOut(state=state, wr_s=h.wr_s, wi_s=h.wi_s, b_s=h.b_s,
                           nconv=h.nconv, done=h.done, nev_eff=h.nev_eff,
                           np_eff=h.np_eff)

    return head


def make_realnonsym_tail(op: Operator, cfg: IRAMConfig):
    """Build the exact-shift restart tail ``tail(h, is_last) ->
    RealCycleOut`` (dnapps with the shifts from dngets, ``shifts_plain``,
    float64)."""
    ncv = cfg.ncv
    p = params(cfg)
    bnorm = make_bnorm(op, cfg)

    def tail(h: RealHeadOut, is_last: bool) -> RealCycleOut:
        if h.done or is_last:
            # exit before dnapps: keep the full factorization
            state = h.state.replace(iter=h.state.iter + 1)
        else:
            Hc, Q, _ = shifts_plain(h.state.H.astype(np.float64), h, p)
            k = h.nev_eff
            # dnapps-parity kev-row update of the basis (rows 0..nev_eff of
            # Q^T V survive the restart)
            state = restart_tail(op, cfg, bnorm, h.state, Q, Hc,
                                 Q[ncv - 1, k - 1], Hc[k, k - 1], k)
        return RealCycleOut(state=state, done=h.done, nconv=h.nconv,
                            wr_s=h.wr_s, wi_s=h.wi_s, bounds_s=h.b_s)

    return tail


class FusedRealNonsymSolver(DeviceLoopSolver):
    """dnaupd-equivalent driver over the real non-symmetric cycle, with the
    name of the reference package's driver.  The restart loop runs on the
    operator's device (:class:`~arpack_ng_tpu_torch.core.loop.
    DeviceLoopSolver`; the dgks extension is read-free): per cycle, the
    previous restart and the extension from ``k`` (a CUDA graph per ``k``
    on a capturable operator, eager otherwise), the reduced space as one
    launch of ``csrc/realnonsym_cycle.cu`` (the numpy twin on the CPU), one
    read of its packet (one more after the host finished an extension).
    :meth:`multi` is the counterpart of the reference's
    ``make_realnonsym_multi_cycle``.  ``mesh``: see
    :class:`~arpack_ng_tpu_torch.core.iram.HostLoopSolver`; the loop runs
    on each rank's rows, the reduced space on every rank alike."""

    _host_loop = False   # every extension make_extend builds is read-free

    def __init__(self, op: Operator, cfg: IRAMConfig, mesh=None):
        if _dt.is_complex(cfg.dtype):
            raise ValueError("FusedRealNonsymSolver is for real dtypes")
        if cfg.symmetric:
            raise ValueError("use FusedSymSolver for symmetric problems")
        if not cfg.exact_shifts:
            raise ValueError("the fused path requires exact shifts")
        super().__init__(op, cfg, make_realnonsym_head, make_realnonsym_tail,
                         mesh)
        self._ext = make_extend(self.op, cfg)
        self._p = params(cfg)

    def _start(self, state: FactorizationState) -> RealCycleOut:
        z = np.zeros(self.cfg.ncv)
        return RealCycleOut(state=state, done=False, nconv=0, wr_s=z,
                            wi_s=z, bounds_s=z)

    def _exit(self, out: RealCycleOut):
        cfg = self.cfg
        r_s = (np.asarray(out.wr_s, np.float64)
               + 1j * np.asarray(out.wi_s, np.float64))
        b_s = np.asarray(out.bounds_s, np.float64)
        r_x, b_x = reduced.exit_sort(cfg.which, cfg.nev, out.nconv,
                                     r_s.copy(), b_s.copy(), cfg.eps23,
                                     False, True)
        info = 1 if (out.state.iter >= cfg.max_iter
                     and out.nconv < cfg.nev) else 0
        return r_x, b_x, info

    # ---- the reduce step of the device loop ------------------------------
    def _packet_size(self) -> int:
        return packet_size(self.cfg.ncv)

    def _reduce(self, ds, Q, sk, packet, is_last: bool) -> None:
        realnonsym_cycle(ds.H, ds.rnorm, ds.brk, ds.force, ds.cnt, Q, sk,
                         packet, self._p, is_last)

    def _packet_fields(self, pk):
        ncv = self.cfg.ncv
        return (pk[P_HEAD + 3 * ncv:].reshape(ncv, ncv), pk[P_RNORM],
                pk[P_CNT:P_CNT + 4])

    def _read_fields(self, ds):
        ncv = self.cfg.ncv
        back = torch.cat([ds.rnorm.double().reshape(1), ds.cnt.double(),
                          ds.H.double().reshape(-1)]).cpu().numpy()
        return back[5:].reshape(ncv, ncv), back[0], back[1:5]

    def _cycle_out(self, state: FactorizationState, pk) -> RealCycleOut:
        if pk is None:
            return self._start(state)
        ncv = self.cfg.ncv
        return RealCycleOut(state=state, done=bool(pk[P_DONE]),
                            nconv=int(pk[P_NCONV]),
                            wr_s=pk[P_HEAD:P_HEAD + ncv].copy(),
                            wi_s=pk[P_HEAD + ncv:P_HEAD + 2 * ncv].copy(),
                            bounds_s=pk[P_HEAD + 2 * ncv:
                                        P_HEAD + 3 * ncv].copy())

    def _trace_packet(self, pk, it: int) -> None:
        if debug.maup2 > 0:
            ncv = self.cfg.ncv
            _trace_cycle(it, int(pk[P_NCONV]), pk[P_RNORM],
                         pk[P_HEAD:P_HEAD + ncv],
                         pk[P_HEAD + ncv:P_HEAD + 2 * ncv],
                         pk[P_HEAD + 2 * ncv:P_HEAD + 3 * ncv])

"""Complex non-symmetric restart cycle (port of
``arpack_ng_tpu/core/device_nonsym.py``): the znaupd/znaup2 major
iteration in complex arithmetic, and through :func:`complexify_operator`
the same cycle for real non-symmetric problems (``eigs(strategy='fused')``).

* Extension by the CGS + DGKS Arnoldi step of ``core/arnoldi.py`` on the
  operator's device, with no device-to-host read (``Extension.run``).
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

:class:`FusedNonsymSolver` runs the restart loop on the operator's
device, the counterpart of the reference's ``make_cplx_multi_cycle``: the
shared device loop (``core/loop._DeviceLoop``: per cycle the previous
restart's rotation and residual update and the read-free extension, one
CUDA graph per start ``k`` on a capturable operator), then the reduced
space above as one kernel launch (``ops/cuda_cplx_cycle.py``,
``csrc/cplx_cycle.cu``; in complex128 whatever the problem dtype, with
the problem dtype's thresholds), then one read of a small packet.
``make_cplx_head`` / ``make_cplx_tail`` keep the host loop, the same
reduced space in numpy (the kernel's plain twin's pieces), which
``HostLoopSolver.solve(solver)`` still runs as a witness.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import IRAMConfig
from ..ops.cuda_cplx_cycle import (  # noqa: F401
    P_CNT, P_DONE, P_HEAD, P_NCONV, P_RNORM, Params, cplx_cycle, head_plain,
    make_hessenberg_schur, make_last_components, packet_size, shifts_plain)
from ..ops.operator import Operator
from ..utils import dtypes as _dt
from ..utils.debug import debug, trace
from . import reduced
from .arnoldi import (FactorizationState, make_bnorm, make_extend,
                      restart_tail)
from .loop import DeviceLoopSolver


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


def params(cfg: IRAMConfig) -> Params:
    """The reduced space's parameters: the thresholds in the problem
    dtype."""
    rdt = _dt.real_dtype(cfg.dtype)
    return Params(which=cfg.which, nev=cfg.nev,
                  tol=float(rdt.type(cfg.tol_effective)),
                  eps23=float(rdt.type(cfg.eps23)),
                  eps_m=float(_dt.eps(cfg.dtype)))


class CplxCycleOut(NamedTuple):
    state: FactorizationState
    done: bool
    nconv: int
    ritz_s: np.ndarray    # (ncv,) which-sorted Ritz values, wanted last
    bounds_s: np.ndarray  # (ncv,)


class CplxHeadOut(NamedTuple):
    """What the restart tail needs from the first half of a cycle
    (extension, zneigh, zngets, znconv, nev inflation)."""

    state: FactorizationState
    r_s: np.ndarray
    b_s: np.ndarray
    nconv: int
    done: bool
    nev_eff: int
    np_eff: int


def _trace_cycle(it, nconv, rnorm, r_s, b_s) -> None:
    trace(debug.maup2, 0, "_cplx_cycle: iter {i}: nconv={nc} rnorm={rn}",
          i=it, nc=nconv, rn=rnorm)
    trace(debug.maup2, 1, "_cplx_cycle: ritz (wanted last) {r}\n"
          " _cplx_cycle: bounds {b}", r=r_s, b=b_s)


def make_cplx_head(op: Operator, cfg: IRAMConfig):
    """Build ``head(state) -> CplxHeadOut``: znaup2 from the extension
    through the shift count (znaitr, zneigh, zngets, znconv, the zero-bound
    shift removal and nev inflation), the reduced space in numpy
    (``head_plain``, complex128)."""
    if cfg.symmetric:
        raise ValueError("use device_sym for symmetric problems")
    if not _dt.is_complex(cfg.dtype):
        raise ValueError("complex dtype required (complexify the operator)")
    extend = make_extend(op, cfg)
    p = params(cfg)

    def head(state: FactorizationState) -> CplxHeadOut:
        state = extend(state, cfg.ncv)
        h = head_plain(state.H.astype(np.complex128),
                       np.float64(state.rnorm), p)
        _trace_cycle(state.iter, h.nconv, state.rnorm, h.r_s, h.b_s)
        return CplxHeadOut(state=state, r_s=h.r_s, b_s=h.b_s, nconv=h.nconv,
                           done=h.done, nev_eff=h.nev_eff, np_eff=h.np_eff)

    return head


def make_cplx_tail(op: Operator, cfg: IRAMConfig):
    """Build the exact-shift restart tail ``tail(h, is_last) ->
    CplxCycleOut`` (znapps with the shifts from zngets, ``shifts_plain``,
    complex128)."""
    ncv = cfg.ncv
    p = params(cfg)
    bnorm = make_bnorm(op, cfg)

    def tail(h: CplxHeadOut, is_last: bool) -> CplxCycleOut:
        if h.done or is_last:
            # exit before znapps: keep the full factorization
            state = h.state.replace(iter=h.state.iter + 1)
        else:
            Hc, Q = shifts_plain(h.state.H.astype(np.complex128), h, p)
            k = h.nev_eff
            # znapps-parity kev-row update of the basis (rows 0..nev_eff of
            # Q^T V survive the restart)
            state = restart_tail(op, cfg, bnorm, h.state, Q, Hc,
                                 Q[ncv - 1, k - 1], Hc[k, k - 1], k)
        return CplxCycleOut(state=state, done=h.done, nconv=h.nconv,
                            ritz_s=h.r_s, bounds_s=h.b_s)

    return tail


class FusedNonsymSolver(DeviceLoopSolver):
    """znaupd-equivalent driver over the complex cycle, with the name of the
    reference package's driver; serves real non-symmetric problems through
    :func:`complexify_operator`.  The restart loop runs on the operator's
    device (:class:`~arpack_ng_tpu_torch.core.loop.DeviceLoopSolver`; the
    dgks extension is read-free): per cycle, the previous restart and the
    extension from ``k`` (a CUDA graph per ``k`` on a capturable operator,
    eager otherwise), the reduced space as one launch of
    ``csrc/cplx_cycle.cu`` (the numpy twin on the CPU), one read of its
    packet (one more after the host finished an extension).  :meth:`multi`
    is the counterpart of the reference's ``make_cplx_multi_cycle``.
    ``mesh``: see :class:`~arpack_ng_tpu_torch.core.iram.HostLoopSolver`;
    the loop runs on each rank's rows, the reduced space on every rank
    alike."""

    def __init__(self, op: Operator, cfg: IRAMConfig, mesh=None):
        if not _dt.is_complex(cfg.dtype):
            raise ValueError(
                "FusedNonsymSolver needs a complex dtype; use "
                "complexify_operator + a complex IRAMConfig for real input")
        if not cfg.exact_shifts:
            raise ValueError("fused path requires exact shifts")
        super().__init__(op, cfg, make_cplx_head, make_cplx_tail, mesh)
        self._ext = make_extend(self.op, cfg)
        self._host_loop = not self._ext.read_free
        self._p = params(cfg)

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

    # ---- the reduce step of the device loop ------------------------------
    def _packet_size(self) -> int:
        return packet_size(self.cfg.ncv)

    def _q_dtype(self) -> torch.dtype:
        return _dt.torch_dtype(self.cfg.dtype)

    def _reduce(self, ds, Q, sk, packet, is_last: bool) -> None:
        cplx_cycle(ds.H, ds.rnorm, ds.brk, ds.force, ds.cnt, Q, sk, packet,
                   self._p, is_last)

    def _packet_fields(self, pk):
        ncv = self.cfg.ncv
        H = np.ascontiguousarray(pk[P_HEAD + 3 * ncv:]).reshape(ncv, ncv, 2)
        return (H.view(np.complex128)[..., 0], pk[P_RNORM],
                pk[P_CNT:P_CNT + 4])

    def _read_fields(self, ds):
        ncv = self.cfg.ncv
        back = torch.cat([ds.rnorm.double().reshape(1), ds.cnt.double(),
                          torch.view_as_real(ds.H).double().reshape(-1)]
                         ).cpu().numpy()
        H = back[5:].reshape(ncv, ncv, 2).view(np.complex128)[..., 0]
        return H, back[0], back[1:5]

    def _cycle_out(self, state: FactorizationState, pk) -> CplxCycleOut:
        if pk is None:
            return self._start(state)
        ncv = self.cfg.ncv
        ritz = np.empty(ncv, np.complex128)
        ritz.real = pk[P_HEAD:P_HEAD + ncv]
        ritz.imag = pk[P_HEAD + ncv:P_HEAD + 2 * ncv]
        return CplxCycleOut(state=state, done=bool(pk[P_DONE]),
                            nconv=int(pk[P_NCONV]), ritz_s=ritz,
                            bounds_s=pk[P_HEAD + 2 * ncv:
                                        P_HEAD + 3 * ncv].copy())

    def _trace_packet(self, pk, it: int) -> None:
        if debug.maup2 > 0:
            ncv = self.cfg.ncv
            r_s = pk[P_HEAD:P_HEAD + ncv] + 1j * pk[P_HEAD + ncv:
                                                     P_HEAD + 2 * ncv]
            _trace_cycle(it, int(pk[P_NCONV]), pk[P_RNORM], r_s,
                         pk[P_HEAD + 2 * ncv:P_HEAD + 3 * ncv])

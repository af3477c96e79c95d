"""Solver statistics: the counterpart of ``arpack_ng_tpu/utils/stats.py``
(arpack-ng's ``stat.h``: op counters and per-phase timers).

The host-driven solver keeps its counters as plain Python integers.
Timers accumulate seconds; a phase that runs on a CUDA device is timed
with CUDA events recorded on the current stream, so the figure is device
time and not the time the host took to enqueue the work.
"""
from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import torch


class OpCounts(NamedTuple):
    """Op counters, mirroring stat.h:10-13 plus the two traffic counters
    of the reference package."""

    nopx: int = 0     # number of OP*x applications
    nbx: int = 0      # number of B*x applications
    nrorth: int = 0   # steps that entered re-orthogonalization
    nitref: int = 0   # iterative-refinement passes taken
    nrstrt: int = 0   # invariant-subspace restarts (SRC/dsaitr.f:397)
    nrotr: int = 0    # basis rows written by restart rotations
    nrorthr: int = 0  # basis rows streamed by selective-reorth events

    @classmethod
    def zeros(cls) -> "OpCounts":
        return cls()

    def add(self, **deltas) -> "OpCounts":
        return self._replace(
            **{k: getattr(self, k) + int(v) for k, v in deltas.items()})


@dataclasses.dataclass
class Timers:
    """Per-phase timers (seconds), named like stat.h:14-21."""

    taupd: float = 0.0   # total in the top-level iteration driver
    taitr: float = 0.0   # total in Lanczos factorization extension
    teigt: float = 0.0   # total computing Ritz values of the projected matrix
    tgets: float = 0.0   # total in shift selection
    tapps: float = 0.0   # total applying implicit shifts
    tconv: float = 0.0   # total in convergence testing
    tgetv0: float = 0.0  # total generating starting vectors
    titref: float = 0.0  # total in iterative refinement (folded into taitr)
    trvec: float = 0.0   # total computing Ritz vectors
    tmvopx: float = 0.0  # total in user OP*x (folded into taitr)
    tmvbx: float = 0.0   # total in user B*x

    def timed(self, name: str, device=None):
        """Context manager accumulating the phase's time into
        ``self.<name>``: CUDA-event time on a CUDA ``device``, host wall
        time otherwise."""
        return _TimerCtx(self, name, device)


class _TimerCtx:
    def __init__(self, timers: Timers, name: str, device):
        self._timers, self._name = timers, name
        self._cuda = device is not None and torch.device(device).type == "cuda"

    def __enter__(self):
        if self._cuda:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t1 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._cuda:
            self._t1.record()
            self._t1.synchronize()
            dt = self._t0.elapsed_time(self._t1) / 1e3
        else:
            dt = time.perf_counter() - self._t0
        setattr(self._timers, self._name,
                getattr(self._timers, self._name) + dt)
        return False


@dataclasses.dataclass
class SolverStats:
    """Aggregated statistics returned to the user (``iparam(3,5,9:11)``
    of the reference driver, SRC/dsaupd.f:616-620)."""

    n_iter: int = 0
    n_conv: int = 0
    nopx: int = 0
    nbx: int = 0
    nrorth: int = 0
    nitref: int = 0
    nrstrt: int = 0
    nrotr: int = 0
    nrorthr: int = 0
    timers: Timers = dataclasses.field(default_factory=Timers)

    def absorb_counts(self, counts: OpCounts) -> None:
        for f in OpCounts._fields:
            setattr(self, f, int(getattr(counts, f)))

    def summary(self) -> str:
        """Human-readable summary in the spirit of SRC/dsaupd.f:662-679."""
        t = self.timers
        lines = [
            "==========================================",
            "= Implicitly-restarted Arnoldi  (CUDA)   =",
            "= Version arpack_ng_tpu_torch            =",
            "==========================================",
            f"Total number update iterations             = {self.n_iter}",
            f"Total number of OP*x operations            = {self.nopx}",
            f"Total number of B*x operations             = {self.nbx}",
            f"Total number of reorthogonalization steps  = {self.nrorth}",
            f"Total number of iterative refinement steps = {self.nitref}",
            f"Total number of restart steps              = {self.nrstrt}",
            f"Total time in user OP*x operation          = {t.tmvopx:.6f}",
            f"Total time in user B*x operation           = {t.tmvbx:.6f}",
            f"Total time in Arnoldi update routine       = {t.taitr:.6f}",
            f"Total time in saup2 routine                = {t.taupd:.6f}",
            f"Total time in basic Arnoldi iteration loop = {t.taitr:.6f}",
            f"Total time in reorthogonalization phase    = {t.titref:.6f}",
            f"Total time in (re)start vector generation  = {t.tgetv0:.6f}",
            f"Total time in Hessenberg eig. subproblem   = {t.teigt:.6f}",
            f"Total time in getting the shifts           = {t.tgets:.6f}",
            f"Total time in applying the shifts          = {t.tapps:.6f}",
            f"Total time in convergence testing          = {t.tconv:.6f}",
            f"Total time in computing final Ritz vectors = {t.trvec:.6f}",
        ]
        return "\n".join(lines)

"""Output of the iteration phase (port of ``IRAMResult`` of
``arpack_ng_tpu/core/iram.py``).  The hybrid driver ``IRAMSolver`` is not
ported yet."""
from __future__ import annotations

import dataclasses

import numpy as np

from ..utils.stats import SolverStats
from .arnoldi import FactorizationState


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

"""Solver configuration: the typed replacement of arpack-ng's ``iparam``
argument list (SRC/dsaupd.f:154-226); port of ``arpack_ng_tpu/config.py``.

The fields, their defaults and the argument checks are those of the
reference package, so a configuration means the same solve in both.
``storage_dtype`` may be a torch dtype (``torch.bfloat16``) here.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .utils import dtypes as _dt

#: Valid ``which`` selectors, symmetric problems (SRC/dsaupd.f:98-105).
SYM_WHICH = ("LA", "SA", "LM", "SM", "BE")
#: Valid ``which`` selectors, non-symmetric/complex (SRC/dnaupd.f:106-111).
NONSYM_WHICH = ("LM", "SM", "LR", "SR", "LI", "SI")


@dataclasses.dataclass(frozen=True)
class IRAMConfig:
    """Static configuration of one implicitly-restarted Lanczos solve.
    See ``arpack_ng_tpu.config.IRAMConfig`` for the meaning of each
    option; the values and checks are the same."""

    n: int                      # problem dimension (logical, un-padded)
    nev: int                    # number of eigenvalues wanted
    ncv: int                    # Krylov subspace dimension (nev < ncv <= n)
    which: str = "LM"
    bmat: str = "I"             # 'I' standard, 'G' generalized
    mode: int = 1               # ARPACK iparam(7): 1..5
    tol: float = 0.0            # <=0 -> machine eps of dtype
    max_iter: int = 300         # max restart cycles (iparam(3))
    exact_shifts: bool = True   # iparam(1)=1
    symmetric: bool = False     # Lanczos semantics (dsaupd vs dnaupd)
    dtype: np.dtype = np.dtype(np.float32)
    n_pad: int = 0              # padded dimension carried on the device
    seed: int = 0               # seed of the start/restart-vector generator
    safe_norms: bool = False    # overflow-safe two-phase norms (pdnorm2)
    storage_dtype: object = None  # optional narrow basis storage
    restart: str = "implicit"   # 'implicit' (dsapps chase) or 'thick'
    reorth: str = "dgks"        # 'dgks' or 'selective'
    pair_rule: str = "always"   # 'always' or 'clean'
    cgs_kernel: str = "auto"    # 'auto'/'xla' or 'pallas'

    def __post_init__(self):
        if self.n <= 0:
            raise ValueError("n must be positive (reference info = -1)")
        if self.nev <= 0:
            raise ValueError("nev must be positive (reference info = -2)")
        min_gap = 1 if self.symmetric else 2
        if not (self.nev + min_gap <= self.ncv
                <= max(self.n, self.nev + min_gap)):
            raise ValueError(
                f"need nev+{min_gap} <= ncv <= n; got nev={self.nev}, "
                f"ncv={self.ncv}, n={self.n} (reference info = -3)")
        valid = SYM_WHICH if self.symmetric else NONSYM_WHICH
        if self.which not in valid:
            raise ValueError(
                f"which={self.which!r} invalid; must be one of {valid} "
                "(reference info = -5)")
        if self.bmat not in ("I", "G"):
            raise ValueError("bmat must be 'I' or 'G' (reference info = -6)")
        if self.max_iter <= 0:
            raise ValueError("max_iter must be positive (reference info = -4)")
        if not (1 <= self.mode <= 5):
            raise ValueError("mode must be 1..5 (reference info = -10)")
        if self.mode == 1 and self.bmat == "G":
            raise ValueError("mode 1 requires bmat='I' (reference info = -11)")
        if self.cgs_kernel not in ("auto", "xla", "pallas"):
            raise ValueError("cgs_kernel must be 'auto', 'xla' or 'pallas'")
        if self.reorth not in ("dgks", "selective"):
            raise ValueError("reorth must be 'dgks' or 'selective'")
        if self.pair_rule not in ("always", "clean"):
            raise ValueError("pair_rule must be 'always' or 'clean'")
        if self.restart not in ("implicit", "thick"):
            raise ValueError("restart must be 'implicit' or 'thick'")
        object.__setattr__(self, "dtype", np.dtype(self.dtype))
        if self.n_pad == 0:
            object.__setattr__(self, "n_pad", self.n)
        if self.n_pad < self.n:
            raise ValueError("n_pad must be >= n")

    @property
    def tol_effective(self) -> float:
        return self.tol if self.tol > 0 else _dt.default_tol(self.dtype)

    @property
    def eps23(self) -> float:
        return _dt.eps23(self.dtype)


def default_ncv(n: int, nev: int, symmetric: bool) -> int:
    """Default subspace size (scipy convention: min(n, max(2k+1, 20)))."""
    gap = 1 if symmetric else 2
    return int(min(n, max(2 * nev + 1, 20, nev + gap + 1)))


def pad_dim(n: int, multiple: int = 128) -> int:
    """Round ``n`` up to a multiple of 128, as the reference package pads,
    so both packages carry the same padded vectors."""
    return int(-(-n // multiple) * multiple)

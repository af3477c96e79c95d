"""Dtype-parametric numerics helpers (port of ``arpack_ng_tpu/utils/dtypes.py``).

Machine constants are re-derived per dtype, as the reference obtains them
from LAPACK ``dlamch`` (``SRC/dsaupd.f:550``, ``SRC/dsconv.f:123``).  Dtypes
may be numpy or torch dtypes (``torch.bfloat16`` for basis storage); the
compute dtype of a solve is a numpy float32/float64/complex64/complex128,
so the host reduced space keeps numpy semantics; a complex dtype has the
constants of its real part.
"""
from __future__ import annotations

import os as _os

import numpy as np
import torch

#: Machine-epsilon floor exponent used in the ARPACK convergence test
#: ``bounds(i) <= tol * max(eps23, |ritz(i)|)`` (SRC/dsconv.f:64-69,123).
EPS23_POW = 2.0 / 3.0

#: DGKS iterative-refinement threshold (SRC/dsaitr.f:656).
DGKS_ETA = 0.717

#: Safety factor of the selective-reorthogonalization trigger
#: ``tau = sqrt(eps_eff) / SELECTIVE_SAFETY`` (the reference package's
#: default since its round 5; see ``arpack_ng_tpu/utils/dtypes.py``).
#: ``ARPACK_TPU_SELECTIVE_SAFETY`` is the same measurement hatch as in the
#: reference package, read at import; values below 1 are clamped.
SELECTIVE_SAFETY = 6.0
_s = _os.environ.get("ARPACK_TPU_SELECTIVE_SAFETY")
if _s:
    try:
        SELECTIVE_SAFETY = max(float(_s), 1.0)
    except ValueError:
        pass

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
    np.dtype(np.complex64): torch.complex64,
    np.dtype(np.complex128): torch.complex128,
}


def torch_dtype(dtype) -> torch.dtype:
    """Torch dtype for a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NP_TO_TORCH[np.dtype(dtype)]


def selective_eta(dtype) -> float:
    """Trigger threshold for selective reorthogonalization."""
    return float(SELECTIVE_SAFETY * np.sqrt(eps(dtype)))


def real_dtype(dtype) -> np.dtype:
    """Real numpy counterpart of a (possibly complex) compute dtype."""
    td = torch_dtype(dtype)
    if td.is_complex:
        td = torch.float32 if td == torch.complex64 else torch.float64
    if td == torch.float32:
        return np.dtype(np.float32)
    if td == torch.float64:
        return np.dtype(np.float64)
    raise TypeError(f"{dtype!r} is not a compute dtype")


def is_complex(dtype) -> bool:
    return torch_dtype(dtype).is_complex


def host_dtype(dtype) -> np.dtype:
    """Dtype of the host reduced space: complex128 for complex compute
    dtypes, float64 for real ones (reference ``core/iram.py:74-76``)."""
    return np.dtype(np.complex128 if is_complex(dtype) else np.float64)


def eps(dtype) -> float:
    """Machine epsilon of the real dtype underlying ``dtype``
    (``dlamch('EpsMach')``); covers bfloat16 storage."""
    td = torch_dtype(dtype)
    if td.is_complex:
        td = torch.float32 if td == torch.complex64 else torch.float64
    return float(torch.finfo(td).eps)


def eps23(dtype) -> float:
    """``eps**(2/3)``: the relative-accuracy floor of the convergence test."""
    return float(eps(dtype) ** EPS23_POW)


def safmin(dtype) -> float:
    """Smallest safe reciprocal-able number (``dlamch('S')``)."""
    return float(np.finfo(real_dtype(dtype)).tiny)


def default_tol(dtype) -> float:
    """Default convergence tolerance: machine eps (SRC/dsaupd.f:546-551)."""
    return eps(dtype)

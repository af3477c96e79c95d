"""Solver state to and from numpy: the weights a solve carries.

:func:`state_from_numpy` takes the fields of a reference-package
``FactorizationState`` after ``jax.device_get`` (V reshaped to
``(ncv, n_pad)``; ``counts`` as a mapping or a NamedTuple of integers) and
builds this package's state on a device (the card unless ``device="cpu"``
is given), so a solve can resume here from a state the reference package
produced, and the other way round with :func:`state_to_numpy`.  The
reference's PRNG key has no counterpart: the restart-vector generator is
seeded from ``seed``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .core.arnoldi import FactorizationState
from .utils import dtypes as _dt
from .utils.device import DEFAULT, require
from .utils.stats import OpCounts

_VECTORS = ("resid", "b_resid")
_INTS = ("k", "nev_cur", "iter", "info")


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def state_from_numpy(d: Mapping[str, object], device=DEFAULT,
                     seed: int = 0) -> FactorizationState:
    """Build a :class:`FactorizationState` on ``device`` from numpy
    fields ``V, H, resid, b_resid, rnorm, k, nev_cur, iter, info,
    counts``."""
    device = require(device)
    H = np.array(d["H"])
    V = np.asarray(d["V"])
    V = V.reshape(V.shape[0], -1)
    counts = d["counts"]
    if hasattr(counts, "_asdict"):
        counts = counts._asdict()
    rdt = _dt.real_dtype(H.dtype)
    return FactorizationState(
        V=_tensor(V, device),
        H=H,
        resid=_tensor(d["resid"], device),
        b_resid=_tensor(d["b_resid"], device),
        rnorm=rdt.type(np.asarray(d["rnorm"])),
        **{f: int(np.asarray(d[f])) for f in _INTS},
        gen=torch.Generator().manual_seed(seed),
        counts=OpCounts(**{f: int(np.asarray(counts[f]))
                           for f in OpCounts._fields}))


def state_to_numpy(st: FactorizationState) -> dict:
    """The state's fields as numpy values; ``counts`` as a dict of
    integers."""
    out = {"V": st.V.detach().cpu().numpy(), "H": st.H.copy(),
           "rnorm": np.asarray(st.rnorm),
           "counts": dict(st.counts._asdict())}
    for f in _VECTORS:
        out[f] = getattr(st, f).detach().cpu().numpy()
    for f in _INTS:
        out[f] = np.int32(getattr(st, f))
    return out

"""Eigenpair extraction for symmetric problems: the dseupd equivalent
(port of the symmetric path of ``arpack_ng_tpu/core/extract.py``).

* re-derive the reduced eigensystem from the final H and re-apply the
  eps^(2/3) convergence test (dseupd re-solves at :536; a count mismatch
  with the iteration phase is reference info = -14);
* select the converged wanted subset per ``which``;
* form Ritz vectors ``S^T V`` on the basis' device (one GEMM);
* untransform mode 1 and 2 (the identity).  The spectral-transform
  modes 3-5, purification and ``howmny='S'`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import IRAMConfig
from ..ops.operator import Operator
from ..utils import dtypes as _dt
from . import reduced
from .iram import IRAMResult


@dataclasses.dataclass
class EigenResult:
    """User-facing solve output (dseupd outputs d, z + iparam info)."""

    values: np.ndarray             # (nconv,) eigenvalues, ascending
    vectors: Optional[np.ndarray]  # (n, nconv) or None if rvec=False
    nconv: int
    info: int
    bounds: np.ndarray             # Ritz estimates
    n_iter: int
    stats: object


def extract(op: Operator, cfg: IRAMConfig, result: IRAMResult,
            rvec: bool = True) -> EigenResult:
    if not cfg.symmetric:
        raise NotImplementedError("non-symmetric extraction is not ported "
                                  "yet")
    if op.mode not in (1, 2):
        raise NotImplementedError(f"mode {op.mode} (spectral transforms) is "
                                  "not ported yet")
    state = result.state
    tol, eps23 = cfg.tol_effective, cfg.eps23
    rnorm = float(state.rnorm)
    info = result.info if result.info in (1, 2) else 0

    H = np.asarray(state.H, np.float64)
    alpha = np.diag(H).copy()
    beta = np.diag(H, -1).copy()
    theta_all, bounds_all, S = reduced.sym_eigt(alpha, beta, rnorm)

    # ---- converged subset (dseupd re-test; mismatch -> info=-14) ----
    idx_conv = np.where(reduced.conv_mask(theta_all, bounds_all, tol,
                                          eps23))[0]
    nconv = result.nconv
    if len(idx_conv) < nconv:
        info = -14
        nconv = len(idx_conv)
    if nconv == 0:
        return EigenResult(values=np.zeros(0), vectors=None, nconv=0,
                           info=info, bounds=np.zeros(0),
                           n_iter=result.n_iter, stats=result.stats)

    if cfg.which == "BE":
        # nconv//2 from the low end, the rest from the high end
        # (dsgets.f:166-171)
        order = np.argsort(theta_all[idx_conv], kind="stable")
        half_lo = nconv // 2
        half_hi = nconv - half_lo
        pick = np.concatenate([order[:half_lo],
                               order[len(order) - half_hi:]])
    else:
        key = reduced.sort_key(cfg.which, theta_all[idx_conv], False)
        pick = np.argsort(key, kind="stable")[len(idx_conv) - nconv:]
    sel = idx_conv[np.sort(pick)]

    lam = theta_all[sel].copy()
    lam_bounds = bounds_all[sel].copy()
    # ascending output order (dseupd's final dsortr 'LA', :697-707)
    order_out = np.argsort(lam, kind="stable")
    lam, lam_bounds, sel = lam[order_out], lam_bounds[order_out], \
        sel[order_out]

    vectors = None
    if rvec:
        V = state.V
        tdt = _dt.torch_dtype(cfg.dtype)
        s_dev = torch.from_numpy(
            np.ascontiguousarray(S[:, sel].T.astype(cfg.dtype))).to(V.device)
        z = (s_dev @ V.to(tdt)).cpu().numpy().astype(np.float64)
        vectors = z[:, : cfg.n].T  # (n, nconv)
        if op.perm is not None:
            # internal row i holds logical coordinate perm[i]
            unperm = np.empty_like(vectors)
            unperm[np.asarray(op.perm)] = vectors
            vectors = unperm

    return EigenResult(values=lam, vectors=vectors, nconv=nconv, info=info,
                       bounds=lam_bounds, n_iter=result.n_iter,
                       stats=result.stats)

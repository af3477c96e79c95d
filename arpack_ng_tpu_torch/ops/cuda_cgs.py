"""Classical Gram-Schmidt passes over the first ``rows`` basis rows (port
of ``arpack_ng_tpu/ops/pallas_cgs.py``; kernels in ``csrc/cgs.cu``).

* :func:`cgs_proj`   ``h = V[:rows] w``
* :func:`cgs_update` ``r = w - h @ V[:rows]``, out of place (``w`` is left
  untouched), with ``||r||^2`` from the same pass when ``with_norm`` is set.

``V`` is the row-major basis ``(ncv, n)`` in its storage dtype (float32,
bfloat16 or float64); ``w``, ``h`` and ``r`` are in the accumulation dtype
(float32 for float32 and bfloat16 storage, float64 for float64).  The
solver calls them for the row buckets up to :data:`MAX_FAST_ROWS` under
``cgs_kernel='pallas'``, as the reference package does.

Each wrapper runs its plain twin (``*_plain``) for tensors on the CPU and
launches its CUDA kernel for tensors on a CUDA device; ``launches`` counts
the kernel launches.
"""
from __future__ import annotations

import torch

from . import cuda_lib

#: largest bucket the solver sends to these kernels; the 32-row bucket
#: stays a GEMV, as in the reference (``pallas_cgs.py:40``)
MAX_FAST_ROWS = 24


def _check(V, vec, rows, name):
    if V.dim() != 2 or not V.is_contiguous():
        raise ValueError("V must be a contiguous (ncv, n) basis")
    top = min(V.shape[0], cuda_lib.MAX_ROWS)
    if not 1 <= rows <= top:
        raise ValueError(f"rows={rows} outside [1, {top}]")
    if vec.dim() != 1 or vec.shape[0] != V.shape[1] \
            or not vec.is_contiguous():
        raise ValueError(f"{name} must be a contiguous vector of length "
                         f"{V.shape[1]}")
    if V.device != vec.device:
        raise ValueError("V and the vectors must share one device")


def cgs_proj_plain(V, w, rows):
    """Plain twin of :func:`cgs_proj`: one GEMV in the accumulation dtype."""
    return V[:rows].to(w.dtype) @ w


def cgs_proj(V: torch.Tensor, w: torch.Tensor, rows: int) -> torch.Tensor:
    """``h[k] = <V[k], w>`` for ``k < rows``; returns ``h`` (rows,)."""
    _check(V, w, rows, "w")
    if V.device.type == "cpu":
        return cgs_proj_plain(V, w, rows)
    if V.device.type != "cuda":
        raise ValueError(f"no kernel for device {V.device}")
    code = cuda_lib.dtype_code(V.dtype, w.dtype)
    lib = cuda_lib.load()
    n = V.shape[1]
    partial = torch.empty(rows * lib.atpt_row_blocks(n), dtype=w.dtype,
                          device=V.device)
    h = torch.empty(rows, dtype=w.dtype, device=V.device)
    err = lib.atpt_cgs_proj(code, rows, V.data_ptr(), V.stride(0),
                            w.data_ptr(), n, partial.data_ptr(), h.data_ptr(),
                            cuda_lib.stream_handle(V.device))
    cuda_lib.check(lib, err, "cgs_proj")
    cgs_proj.launches += 1
    return h


cgs_proj.launches = 0


def cgs_update_plain(w, h, V, with_norm=False):
    """Plain twin of :func:`cgs_update`: one GEMV, subtract."""
    r = w - h @ V[:h.shape[0]].to(w.dtype)
    if with_norm:
        return r, torch.dot(r, r)
    return r


def cgs_update(w: torch.Tensor, h: torch.Tensor, V: torch.Tensor,
               with_norm: bool = False):
    """``r = w - sum_k h[k] V[k]`` over ``k < len(h)``; returns ``r`` or
    ``(r, ||r||^2)`` (a 0-d tensor) when ``with_norm``."""
    rows = h.shape[0] if h.dim() == 1 else 0
    _check(V, w, rows, "w")
    if h.dtype != w.dtype or h.device != w.device:
        raise ValueError("h must match w's dtype and device")
    if V.device.type == "cpu":
        return cgs_update_plain(w, h, V, with_norm)
    if V.device.type != "cuda":
        raise ValueError(f"no kernel for device {V.device}")
    code = cuda_lib.dtype_code(V.dtype, w.dtype)
    h = h.contiguous()
    lib = cuda_lib.load()
    n = V.shape[1]
    r = torch.empty_like(w)
    if with_norm:
        partial = torch.empty(lib.atpt_row_blocks(n), dtype=w.dtype,
                              device=V.device)
        nrm = torch.empty((), dtype=w.dtype, device=V.device)
        pp, np_ = partial.data_ptr(), nrm.data_ptr()
    else:
        pp = np_ = None
    err = lib.atpt_cgs_update(code, h.data_ptr(), rows, V.data_ptr(),
                              V.stride(0), w.data_ptr(), r.data_ptr(), n, pp,
                              np_, cuda_lib.stream_handle(V.device))
    cuda_lib.check(lib, err, "cgs_update")
    cgs_update.launches += 1
    return (r, nrm) if with_norm else r


cgs_update.launches = 0

"""Eta-subset reorthogonalization event: one projection and one update
against K basis rows chosen by index (port of
``arpack_ng_tpu/ops/pallas_sel.py``; kernels in ``csrc/sel.cu``).

* :func:`sel_proj`   ``s[k] = <V[idx[k]], br>``
* :func:`sel_update` ``r <- r - sum_k s[k] V[idx[k]]`` in place, with
  ``||r'||^2`` from the same pass when ``with_norm`` is set.

``V`` is the row-major basis ``(ncv, n_pad)`` in its storage dtype
(float32, bfloat16 or float64); ``br``, ``r`` and ``s`` are in the
accumulation dtype (float32 for float32 and bfloat16 storage, float64 for
float64).  ``idx`` is int32 on the same device, values in ``[0, ncv)``.
A row with ``s[k] == 0`` leaves ``r`` unchanged.

Each wrapper runs its plain twin (``*_plain``) for tensors on the CPU and
launches its CUDA kernel for tensors on a CUDA device; ``launches``
counts the kernel launches.
"""
from __future__ import annotations

import torch

from . import cuda_lib

MAX_K = cuda_lib.MAX_ROWS


def _check(idx, V, vec, name):
    if V.dim() != 2 or not V.is_contiguous():
        raise ValueError("V must be a contiguous (ncv, n) basis")
    if idx.dim() != 1 or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("idx must be a contiguous 1-D int32 tensor")
    if not 1 <= idx.shape[0] <= MAX_K:
        raise ValueError(f"K={idx.shape[0]} outside [1, {MAX_K}]")
    if vec.dim() != 1 or vec.shape[0] != V.shape[1] \
            or not vec.is_contiguous():
        raise ValueError(f"{name} must be a contiguous vector of length "
                         f"{V.shape[1]}")
    if not (idx.device == V.device == vec.device):
        raise ValueError("idx, V and the vectors must share one device")


def sel_proj_plain(idx, V, br):
    """Plain twin of :func:`sel_proj`: gather, then one GEMV."""
    return V.index_select(0, idx.long()).to(br.dtype) @ br


def sel_proj(idx: torch.Tensor, V: torch.Tensor, br: torch.Tensor
             ) -> torch.Tensor:
    """``s[k] = <V[idx[k]], br>`` for ``k < K``; returns ``s`` (K,)."""
    _check(idx, V, br, "br")
    if V.device.type == "cpu":
        return sel_proj_plain(idx, V, br)
    if V.device.type != "cuda":
        raise ValueError(f"no kernel for device {V.device}")
    code = cuda_lib.dtype_code(V.dtype, br.dtype)
    lib = cuda_lib.load()
    K, n = idx.shape[0], V.shape[1]
    partial = torch.empty(K * lib.atpt_row_blocks(n), dtype=br.dtype,
                          device=V.device)
    s = torch.empty(K, dtype=br.dtype, device=V.device)
    err = lib.atpt_sel_proj(code, idx.data_ptr(), K, V.data_ptr(),
                            V.stride(0), br.data_ptr(), n,
                            partial.data_ptr(), s.data_ptr(),
                            cuda_lib.stream_handle(V.device))
    cuda_lib.check(lib, err, "sel_proj")
    sel_proj.launches += 1
    return s


sel_proj.launches = 0


def sel_update_plain(idx, s, r, V, with_norm=False):
    """Plain twin of :func:`sel_update`: gather, one GEMV, subtract."""
    r -= s @ V.index_select(0, idx.long()).to(r.dtype)
    if with_norm:
        return r, torch.dot(r, r)
    return r


def sel_update(idx: torch.Tensor, s: torch.Tensor, r: torch.Tensor,
               V: torch.Tensor, with_norm: bool = False):
    """``r <- r - sum_k s[k] V[idx[k]]`` in place; returns ``r`` or
    ``(r, ||r||^2)`` (a 0-d tensor) when ``with_norm``."""
    _check(idx, V, r, "r")
    if s.shape != idx.shape or s.dtype != r.dtype or s.device != r.device:
        raise ValueError("s must match idx's shape and r's dtype/device")
    if V.device.type == "cpu":
        return sel_update_plain(idx, s, r, V, with_norm)
    if V.device.type != "cuda":
        raise ValueError(f"no kernel for device {V.device}")
    code = cuda_lib.dtype_code(V.dtype, r.dtype)
    s = s.contiguous()
    lib = cuda_lib.load()
    K, n = idx.shape[0], V.shape[1]
    if with_norm:
        partial = torch.empty(lib.atpt_row_blocks(n), dtype=r.dtype,
                              device=V.device)
        nrm = torch.empty((), dtype=r.dtype, device=V.device)
        pp, np_ = partial.data_ptr(), nrm.data_ptr()
    else:
        pp = np_ = None
    err = lib.atpt_sel_update(code, idx.data_ptr(), s.data_ptr(), K,
                              V.data_ptr(), V.stride(0), r.data_ptr(), n,
                              pp, np_, cuda_lib.stream_handle(V.device))
    cuda_lib.check(lib, err, "sel_update")
    sel_update.launches += 1
    return (r, nrm) if with_norm else r


sel_update.launches = 0

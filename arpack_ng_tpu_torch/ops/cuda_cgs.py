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

Each call is one kernel launch, laid out by :func:`plan` (bucket, vector
width, grid, scratch), which stays here in Python so that it is tested
without a card.  The partial sums and the ticket the kernel's last block
takes live in a scratch cached per stream.

Each wrapper runs its plain twin (``*_plain``) for tensors on the CPU and
launches its CUDA kernel for tensors on a CUDA device; ``launches`` counts
the kernel launches.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import cuda_lib

#: largest bucket the solver sends to these kernels; the 32-row bucket
#: stays a GEMV, as in the reference (``pallas_cgs.py:40``)
MAX_FAST_ROWS = 24

#: row counts compiled into the kernels; more than 32 rows loop over 32
BUCKETS = (8, 16, 24, 32)
#: threads per block (``PASS_THREADS`` in csrc/passes.cuh)
THREADS = 256
#: the grid fills the H100's 132 SMs, one block each ...
SMS = 132
#: ... or grows so that no thread adds more than RUN vectors into one sum
#: (``PASS_RUN``: the kernels refuse a grid that breaks it)
RUN = 32


class Plan(NamedTuple):
    bucket: int    # rows compiled into the kernel (8, 16, 24 or 32)
    vec: int       # values per 16-byte vector; 1 is the scalar path
    grid: int      # blocks, fixed by n and the vector width
    scratch: int   # partial sums the launch writes (accumulation dtype)


@functools.lru_cache(maxsize=1024)
def plan(rows: int, n: int, itemsize: int, aligned: bool) -> Plan:
    """The launch of one pass over ``rows`` rows of length ``n`` stored in
    ``itemsize``-byte values.  ``aligned``: every pointer is 16-byte
    aligned and the row stride is a multiple of 16 bytes, so the kernel
    moves 16-byte vectors (the last ``n % vec`` values are added one by
    one); otherwise it takes the scalar path."""
    if not 1 <= rows <= cuda_lib.MAX_ROWS:
        raise ValueError(f"rows={rows} outside [1, {cuda_lib.MAX_ROWS}]")
    bucket = next((b for b in BUCKETS if rows <= b), BUCKETS[-1])
    vec = 16 // itemsize if aligned else 1
    grid = max(SMS, -(-(n // vec) // (THREADS * RUN)))
    return Plan(bucket, vec, grid, rows * grid)


def _aligned(V, *vecs) -> bool:
    return (V.stride(0) * V.element_size()) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (V, *vecs))


#: per (device, CUDA stream): the partial sums (float64, so that either
#: accumulation dtype fits) and the ticket (one int32 the kernel leaves at
#: zero)
_scratch: dict = {}


def _scratch_for(device, size):
    stream = cuda_lib.stream_handle(device)
    key = (device.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf[0].numel() < size:
        buf = (torch.empty(max(size, cuda_lib.MAX_ROWS * SMS),
                           dtype=torch.float64, device=device),
               torch.zeros(1, dtype=torch.int32, device=device))
        _scratch[key] = buf
    return stream, buf


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
    p = plan(rows, n, V.element_size(), _aligned(V, w))
    stream, (partial, ticket) = _scratch_for(V.device, p.scratch)
    h = torch.empty(rows, dtype=w.dtype, device=V.device)
    err = lib.atpt_cgs_proj(code, p.bucket, p.vec > 1, p.grid, rows, V.data_ptr(), V.stride(0),
                            w.data_ptr(), n, partial.data_ptr(),
                            ticket.data_ptr(), h.data_ptr(), stream)
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
    p = plan(rows, n, V.element_size(), _aligned(V, w, r))
    stream, (partial, ticket) = _scratch_for(V.device, p.grid)
    nrm = torch.empty((), dtype=w.dtype, device=V.device) if with_norm \
        else None
    err = lib.atpt_cgs_update(code, p.bucket, p.vec > 1, p.grid,
                              h.data_ptr(), rows, V.data_ptr(),
                              V.stride(0), w.data_ptr(), r.data_ptr(), n,
                              partial.data_ptr(), ticket.data_ptr(),
                              None if nrm is None else nrm.data_ptr(),
                              stream)
    cuda_lib.check(lib, err, "cgs_update")
    cgs_update.launches += 1
    return (r, nrm) if with_norm else r


cgs_update.launches = 0

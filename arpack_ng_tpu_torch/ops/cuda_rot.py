"""In-place restart rotation of the basis, ``V[:rows] <- Q[:, :rows]^T V``
(port of ``arpack_ng_tpu/ops/pallas_rot.py``; kernel in ``csrc/rot.cu``).

``rows = ncv`` is the full rotation (the reference package's
``make_rotate``).  Rows from ``rows`` on are left untouched.  ``V`` is
the row-major basis ``(ncv, n)`` in its storage dtype; ``Q`` is
``(ncv, m)``, ``m >= rows``, in the accumulation dtype (float32 for
float32 and bfloat16 storage, float64 for float64).

The wrapper runs the plain twin for tensors on the CPU and launches the
CUDA kernel for tensors on a CUDA device; ``launches`` counts kernel
launches.  The product is never written through a GEMM's ``out=`` into a
slice of V: that would read rows it has already overwritten.
"""
from __future__ import annotations

import torch

from . import cuda_lib

#: shared memory one block of the kernel may use on Hopper (bytes)
MAX_SMEM = 227 * 1024


def rotate_rows_plain(Q, V, rows):
    """Plain twin of :func:`rotate_rows`: one GEMM into a temporary."""
    top = Q[:, :rows].T @ V.to(Q.dtype)
    V[:rows] = top.to(V.dtype)
    return V


def rotate_rows(Q: torch.Tensor, V: torch.Tensor, rows: int
                ) -> torch.Tensor:
    """Overwrite ``V[:rows]`` with ``Q[:, :rows]^T V``; returns ``V``."""
    if V.dim() != 2 or not V.is_contiguous():
        raise ValueError("V must be a contiguous (ncv, n) basis")
    ncv = V.shape[0]
    if Q.dim() != 2 or Q.shape[0] != ncv or Q.shape[1] < rows \
            or not Q.is_contiguous():
        raise ValueError(f"Q must be a contiguous ({ncv}, >= {rows}) matrix")
    if not 1 <= rows <= ncv:
        raise ValueError(f"rows={rows} outside [1, {ncv}]")
    if Q.device != V.device:
        raise ValueError("Q and V must share one device")
    if V.device.type == "cpu":
        return rotate_rows_plain(Q, V, rows)
    if V.device.type != "cuda":
        raise ValueError(f"no kernel for device {V.device}")
    code = cuda_lib.dtype_code(V.dtype, Q.dtype)
    lib = cuda_lib.load()
    smem = lib.atpt_rot_smem_bytes(code, ncv, rows)
    if smem > MAX_SMEM:
        raise ValueError(f"ncv={ncv} needs {smem} B of shared memory per "
                         f"block; the kernel takes at most {MAX_SMEM}")
    err = lib.atpt_rotate_rows(code, Q.data_ptr(), Q.stride(0), ncv, rows,
                               V.data_ptr(), V.stride(0), V.shape[1],
                               cuda_lib.stream_handle(V.device))
    cuda_lib.check(lib, err, "rotate_rows")
    rotate_rows.launches += 1
    return V


rotate_rows.launches = 0

"""DIA (diagonal-set) sparse matrix-vector product (port of
``arpack_ng_tpu/ops/pallas_dia.py``; kernel in ``csrc/dia.cu``).

:func:`dia_matvec` computes ``y[i] = sum_k dtab[k, i] * x[i + off_k]`` for
``i < n``, with ``x`` read as zero outside ``[0, n)``, and ``y[n:] = 0``:
the matvec of the DIA operators of ``ops/sparse.from_scipy``.  ``dtab``
is the ``(nd, n_pad)`` table of row-aligned diagonals
(``dtab[k, i] = A[i, i + offsets[k]]``), ``offsets`` an int64 tensor of
``nd`` offsets on the same device; the diagonals are summed in that order.

The wrapper runs its plain twin (:func:`dia_matvec_plain`, the
shift-multiply of ``arpack_ng_tpu/ops/sparse.py:100-113``) for tensors on
the CPU and launches the CUDA kernel for tensors on a CUDA device;
``launches`` counts the kernel launches.
"""
from __future__ import annotations

import torch

from . import cuda_lib


def dia_matvec_plain(offsets, dtab, x, n):
    """Plain twin of :func:`dia_matvec`: one shifted multiply-add per
    diagonal, in the order of ``offsets``."""
    xs = x[:n]
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    for k, d in enumerate(offsets.tolist()):
        if abs(d) >= n:
            continue
        diag = dtab[k, :n]
        if d == 0:
            y = y + diag * xs
        elif d > 0:
            y[: n - d] += diag[: n - d] * xs[d:]
        else:
            y[-d:] += diag[-d:] * xs[: n + d]
    out = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    out[:n] = y
    return out


def dia_matvec(offsets: torch.Tensor, dtab: torch.Tensor, x: torch.Tensor,
               n: int) -> torch.Tensor:
    """``y = A x`` for the DIA matrix ``(offsets, dtab)`` of logical size
    ``n``; ``x`` and the returned ``y`` have length ``dtab.shape[1]``."""
    if dtab.dim() != 2 or not dtab.is_contiguous():
        raise ValueError("dtab must be a contiguous (nd, n_pad) table")
    nd, n_pad = dtab.shape
    if offsets.shape != (nd,) or offsets.dtype != torch.int64 \
            or not offsets.is_contiguous():
        raise ValueError(f"offsets must be a contiguous int64 tensor of "
                         f"{nd} offsets")
    if x.shape != (n_pad,) or x.dtype != dtab.dtype or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous {dtab.dtype} vector of "
                         f"length {n_pad}")
    if not 0 <= n <= n_pad or nd < 1:
        raise ValueError(f"n={n} outside [0, {n_pad}] or no diagonal")
    if not (offsets.device == dtab.device == x.device):
        raise ValueError("offsets, dtab and x must share one device")
    if x.device.type == "cpu":
        return dia_matvec_plain(offsets, dtab, x, n)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    code = cuda_lib.dtype_code(x.dtype, x.dtype)
    lib = cuda_lib.load()
    y = torch.empty_like(x)
    err = lib.atpt_dia_matvec(code, offsets.data_ptr(), nd, dtab.data_ptr(),
                              dtab.stride(0), x.data_ptr(), n, n_pad,
                              y.data_ptr(), cuda_lib.stream_handle(x.device))
    cuda_lib.check(lib, err, "dia_matvec")
    dia_matvec.launches += 1
    return y


dia_matvec.launches = 0

"""Gather kernels (port of the two Pallas probes of
``benchmarks/bench_gather_primitives.py``; kernels in ``csrc/gather.cu``).

* :func:`take_flat` — ``out.flat[i] = x.flat[cols.flat[i]]`` (``pl_take``,
  :118): float32 values, int32 indices into the flattened ``x``; ``out``
  has the shape of ``cols``.
* :func:`take_lanes` — ``out[r, l] = X[r, lidx[r, l]]`` for rows of 128
  values (``pl_tal``, :139): the per-row lane gather, int32 ``lidx`` in
  ``[0, 128)``.

Each wrapper runs its plain twin (:func:`take_flat_plain`,
:func:`take_lanes_plain`) for tensors on the CPU and launches its CUDA
kernel for tensors on a CUDA device; ``launches`` counts the kernel
launches.  The kernels check no index: with ``check_range`` (the default)
the wrapper verifies the indices first, at the cost of one reduction and
one device-to-host read; without it an index out of range reads whatever
it points at (for :func:`take_lanes`, another value of the same row).
:func:`noop` launches the empty kernel whose time is a timing harness's
launch floor.
"""
from __future__ import annotations

import torch

from . import cuda_lib

#: row width of :func:`take_lanes` (``LANES_WIDTH`` in csrc/gather.cu)
WIDTH = 128


def take_flat_plain(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`take_flat`."""
    return x.reshape(-1)[cols]


def take_lanes_plain(X: torch.Tensor, lidx: torch.Tensor) -> torch.Tensor:
    """Plain twin of :func:`take_lanes`."""
    return torch.gather(X, 1, lidx)


def _check(values: torch.Tensor, idx: torch.Tensor, what: str) -> None:
    if values.dtype != torch.float32 or not values.is_contiguous():
        raise ValueError(f"{what}: values must be a contiguous float32 tensor")
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError(f"{what}: indices must be a contiguous int32 tensor")
    if values.device != idx.device:
        raise ValueError(f"{what}: values on {values.device}, indices on "
                         f"{idx.device}")


def _check_range(idx: torch.Tensor, hi: int, what: str) -> None:
    if idx.numel():
        lo, top = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or top >= hi:
            raise IndexError(f"{what}: indices span [{lo}, {top}], outside "
                             f"[0, {hi})")


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def take_flat(x: torch.Tensor, cols: torch.Tensor, check_range: bool = True
              ) -> torch.Tensor:
    """``x.reshape(-1)[cols]``: a tensor of the shape of ``cols``."""
    _check(x, cols, "take_flat")
    if x.device.type == "cpu":
        return take_flat_plain(x, cols)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    if check_range:
        _check_range(cols, x.numel(), "take_flat")
    out = torch.empty(cols.shape, dtype=x.dtype, device=x.device)
    lib = cuda_lib.load()
    err = lib.atpt_take_flat(4 if _aligned(cols, out) else 1, x.data_ptr(),
                             cols.data_ptr(), cols.numel(), out.data_ptr(),
                             cuda_lib.stream_handle(x.device))
    cuda_lib.check(lib, err, "take_flat")
    take_flat.launches += 1
    return out


def take_lanes(X: torch.Tensor, lidx: torch.Tensor, check_range: bool = True
               ) -> torch.Tensor:
    """``torch.gather(X, 1, lidx)`` for ``(rows, 128)`` tensors."""
    _check(X, lidx, "take_lanes")
    if X.dim() != 2 or X.shape[1] != WIDTH or lidx.shape != X.shape:
        raise ValueError(f"take_lanes: X and lidx must both be (rows, "
                         f"{WIDTH}); got {tuple(X.shape)}, "
                         f"{tuple(lidx.shape)}")
    if X.device.type == "cpu":
        return take_lanes_plain(X, lidx)
    if X.device.type != "cuda":
        raise ValueError(f"no kernel for device {X.device}")
    if check_range:
        _check_range(lidx, WIDTH, "take_lanes")
    out = torch.empty_like(X)
    if not _aligned(X, lidx, out):
        raise ValueError("take_lanes: X and lidx must start on 16-byte "
                         "boundaries")
    lib = cuda_lib.load()
    err = lib.atpt_take_lanes(X.data_ptr(), lidx.data_ptr(), X.shape[0],
                              out.data_ptr(), cuda_lib.stream_handle(X.device))
    cuda_lib.check(lib, err, "take_lanes")
    take_lanes.launches += 1
    return out


def noop(device: torch.device) -> None:
    """Launch the empty kernel (one block) on ``device``'s current stream:
    the launch floor of a timing harness."""
    lib = cuda_lib.load()
    cuda_lib.check(lib, lib.atpt_noop(cuda_lib.stream_handle(device)),
                   "noop")


take_flat.launches = 0
take_lanes.launches = 0

"""In-place restart rotation of the basis, ``V[:rows] <- Q[:, :rows]^T V``
(port of ``arpack_ng_tpu/ops/pallas_rot.py``; kernel in ``csrc/rot.cu``).

``rows = ncv`` is the full rotation (the reference package's
``make_rotate``).  Rows from ``rows`` on are left untouched.  ``V`` is
the row-major basis ``(ncv, n)`` in its storage dtype; ``Q`` is
``(ncv, m)``, ``m >= rows``, in the accumulation dtype (float32 for
float32 and bfloat16 storage, float64 for float64).

Each call is one kernel launch, laid out by :func:`plan` (ncv bucket,
columns per thread, grid, shared memory), which stays here in Python so
that it is tested without a card.

A complex basis rotated by a real Q (the Hermitian restart) runs the same
kernel on its real view.

The wrapper runs the plain twin for tensors on the CPU and launches the
CUDA kernel for tensors on a CUDA device; ``launches`` counts kernel
launches.  The product is never written through a GEMM's ``out=`` into a
slice of V: that would read rows it has already overwritten.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import cuda_lib

#: shared memory one block of the kernel may use on Hopper (bytes)
MAX_SMEM = 227 * 1024
#: ncv buckets compiled into the register kernel; a larger ncv takes the
#: shared-memory slab kernel
BUCKETS = (16, 24, 32)
#: threads per block (``ROT_THREADS``) and columns per slab (``ROT_SLAB``)
#: in csrc/rot.cu
THREADS = 256
SLAB = 32
#: SMs of the H100; the grid is about one wave of resident blocks
SMS = 132
#: bytes one thread loads per basis row, by storage itemsize, where V's
#: address and row stride allow (else the widest word they allow): float32
#: 8 (2 columns: two resident blocks per SM, ahead of 16-byte words at every
#: row count, PERF.md section 6), bfloat16 8 (4 columns), float64 16
#: (2 columns)
WORD_BYTES = {4: 8, 2: 8, 8: 16}


class Plan(NamedTuple):
    bucket: int   # ncv compiled into the register kernel; 0: the slab kernel
    vec: int      # consecutive columns per thread (one load per row)
    grid: int     # blocks, striding over the column words
    smem: int     # dynamic shared memory per block (slab kernel), bytes


def blocks_per_sm(bucket: int, vec: int, acc_itemsize: int) -> int:
    """Blocks of the register kernel that fit on one SM (1 or 2): the
    estimate behind its ``__launch_bounds__`` (``RotMinBlocks`` in
    csrc/rot.cu): the V words as the compiler keeps them (bfloat16 widened
    to float), the accumulators and 40 more registers per thread."""
    out_block = 32 // acc_itemsize
    regs = (bucket * vec * acc_itemsize // 4
            + out_block * vec * acc_itemsize // 4 + 40)
    return max(1, min(2, 65536 // (THREADS * regs)))


def regs_plan(bucket: int, vec: int, n: int, acc_itemsize: int) -> Plan:
    """The register kernel's launch for ``vec`` columns per thread: about
    one wave of resident blocks, fewer when n is small."""
    per_sm = blocks_per_sm(bucket, vec, acc_itemsize)
    return Plan(bucket, vec, max(1, min(SMS * per_sm,
                                        -(-(n // vec) // THREADS))), 0)


@functools.lru_cache(maxsize=1024)
def plan(ncv: int, rows: int, n: int, itemsize: int, acc_itemsize: int,
         align: int) -> Plan:
    """The launch for a ``(ncv, n)`` basis of ``itemsize``-byte values.
    ``align``: the largest power of two (at most 16) that divides both V's
    address and its row stride in bytes; a thread's columns are one load
    of that many bytes at most."""
    if not 1 <= rows <= ncv:
        raise ValueError(f"rows={rows} outside [1, {ncv}]")
    if n < 1:
        raise ValueError("the basis has no columns")
    if ncv > BUCKETS[-1]:
        smem = ncv * SLAB * itemsize
        if smem > MAX_SMEM:
            raise ValueError(f"ncv={ncv} needs {smem} B of shared memory per "
                             f"block; the kernel takes at most {MAX_SMEM}")
        return Plan(0, 1, min(-(-n // SLAB), SMS * 4), smem)
    bucket = next(b for b in BUCKETS if ncv <= b)
    vec = WORD_BYTES[itemsize] // itemsize
    while vec > 1 and align % (vec * itemsize):
        vec //= 2
    return regs_plan(bucket, vec, n, acc_itemsize)


def _align(V: torch.Tensor) -> int:
    a = 16
    while a > 1 and (V.data_ptr() % a or (V.stride(0) * V.element_size()) % a):
        a //= 2
    return a


def rotate_rows_plain(Q, V, rows):
    """Plain twin of :func:`rotate_rows`: one GEMM into a temporary."""
    top = Q[:, :rows].T @ V.to(Q.dtype)
    V[:rows] = top.to(V.dtype)
    return V


def rotate_rows(Q: torch.Tensor, V: torch.Tensor, rows: int
                ) -> torch.Tensor:
    """Overwrite ``V[:rows]`` with ``Q[:, :rows]^T V``; returns ``V``.  A
    complex V with a real Q of its real dtype is rotated as its real view,
    ``(ncv, 2 n)`` with each value's real and imaginary parts side by side:
    the same function."""
    if V.dim() != 2 or not V.is_contiguous():
        raise ValueError("V must be a contiguous (ncv, n) basis")
    if V.is_complex():
        if Q.dtype != V.real.dtype:
            raise ValueError("a complex V takes a real Q of its real dtype")
        rotate_rows(Q, torch.view_as_real(V).view(V.shape[0], -1), rows)
        return V
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
    p = plan(ncv, rows, V.shape[1], V.element_size(), Q.element_size(),
             _align(V))
    launch(Q, V, rows, p)
    rotate_rows.launches += 1
    return V


def launch(Q: torch.Tensor, V: torch.Tensor, rows: int, p: Plan) -> None:
    """One launch of the kernel under plan ``p`` on checked CUDA tensors
    (``chip_smoke.py`` also times a plan's narrower word through it); the C
    side refuses a plan it cannot run safely."""
    code = cuda_lib.dtype_code(V.dtype, Q.dtype)
    lib = cuda_lib.load()
    err = lib.atpt_rotate_rows(code, p.bucket, p.vec, p.grid, Q.data_ptr(),
                               Q.stride(0), V.shape[0], rows, V.data_ptr(),
                               V.stride(0), V.shape[1],
                               cuda_lib.stream_handle(V.device))
    cuda_lib.check(lib, err, "rotate_rows")


rotate_rows.launches = 0

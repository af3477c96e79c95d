"""What the two non-symmetric reduced-space kernels share (the real one,
``cuda_realnonsym_cycle`` on ``csrc/realnonsym_cycle.cu``, and the
complex one, ``cuda_cplx_cycle`` on ``csrc/cplx_cycle.cu``): the which
codes, the Schur sweep budget, the rule that puts a workspace in one
block's shared memory or in a global buffer, the length of the optional
stamp buffer and the checks of the buffers a launch reads and writes.
Each kernel module passes its own workspace size, packet size and stamp
names."""
from __future__ import annotations

import torch

from .cuda_sym_cycle import MAX_SMEM

#: the which codes of both kernels
WHICH = {"LM": 0, "SM": 1, "LR": 2, "SR": 3, "LI": 4, "SI": 5}
#: QR sweeps of the Schur form per Ritz value (Wilkinson-shifted QR takes
#: two to three per value; a real double shift retires a whole pair)
SWEEPS_PER_EV = 4


def fits_shared(work_bytes, ncv: int) -> bool:
    """Whether a workspace of ``work_bytes(ncv)`` bytes fits in one block's
    shared memory."""
    return work_bytes(ncv) <= MAX_SMEM


def max_shared_ncv(work_bytes) -> int:
    """The largest ncv whose workspace fits in shared memory."""
    n = 2
    while fits_shared(work_bytes, n + 1):
        n += 1
    return n


def clock_size(clocks, laps, counts) -> int:
    """Length of a kernel's stamp buffer: its phase ends, its QR steps'
    parts and its counts (any ncv)."""
    return len(clocks) + len(laps) + len(counts)


def check_buffers(H, rnorm, brk, force, cnt, Q, sk, packet, *, dtypes,
                  rnorm_dtype, min_ncv: int, packet_size: int,
                  what: str) -> None:
    """Refuse buffers a launch cannot take: H a contiguous square matrix of
    one of ``dtypes`` with at least ``min_ncv`` rows, rnorm 0-d of
    ``rnorm_dtype``, brk and force 0-d int32, cnt int64 (4,), Q and sk
    contiguous of H's dtype, packet a contiguous float64 vector of
    ``packet_size``, all on one device."""
    ncv = H.shape[0] if H.dim() else 0
    if H.dim() != 2 or H.shape != (ncv, ncv) or not H.is_contiguous():
        raise ValueError("H must be a contiguous square matrix")
    if H.dtype not in dtypes:
        raise TypeError(f"no {what} kernel for {H.dtype}")
    if ncv < min_ncv:
        raise ValueError(f"the {what} needs ncv >= {min_ncv}")
    if rnorm.shape != () or rnorm.dtype != rnorm_dtype:
        raise ValueError(f"rnorm must be a 0-d {rnorm_dtype} tensor")
    if brk.shape != () or force.shape != () or brk.dtype != torch.int32 \
            or force.dtype != torch.int32:
        raise ValueError("brk and force must be 0-d int32 tensors")
    if cnt.shape != (4,) or cnt.dtype != torch.int64:
        raise ValueError("cnt must be an int64 (4,) tensor")
    if Q.shape != (ncv, ncv) or Q.dtype != H.dtype or not Q.is_contiguous():
        raise ValueError(f"Q must be a contiguous ({ncv}, {ncv}) matrix of "
                         "H's dtype")
    if sk.shape != (2,) or sk.dtype != H.dtype or not sk.is_contiguous():
        raise ValueError("sk must be a contiguous (2,) vector of H's dtype")
    if packet.shape != (packet_size,) or packet.dtype != torch.float64 \
            or not packet.is_contiguous():
        raise ValueError(f"packet must be a contiguous float64 vector of "
                         f"{packet_size}")
    devs = {t.device for t in (H, rnorm, brk, force, cnt, Q, sk, packet)}
    if len(devs) != 1:
        raise ValueError("every tensor must be on one device")


def check_call(H, which: str, clocks, size: int) -> None:
    """Refuse a which the kernels do not know and a stamp buffer that is not
    an int64 vector of ``size`` on H's device."""
    if which not in WHICH:
        raise ValueError(f"bad which={which!r}")
    if clocks is not None and (clocks.shape != (size,)
                               or clocks.dtype != torch.int64
                               or clocks.device != H.device):
        raise ValueError(f"clocks must be an int64 ({size},) tensor on H's "
                         "device")

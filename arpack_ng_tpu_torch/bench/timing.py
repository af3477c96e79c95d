"""Device-only timing of calls on a CUDA card, in alternation.

Each timed launch follows a read-only pass over a buffer larger than the
H100's 50 MB L2 (the operands arrive cold, as a solver finds them) and a
device-side wait that outlasts the host's enqueue, so the CUDA events
around the call hold only the call's own device work.
"""
from __future__ import annotations

import statistics
import time

import torch

#: timed rounds per call
REPS = 20
#: device-side wait before each timed launch, in SM clock cycles (~1 ms at
#: 1.98 GHz): longer than any wrapper's host enqueue
SLEEP_CYCLES = 2_000_000
#: L2 flush: a read of this many bytes (the H100's L2 holds 50 MB)
FLUSH_BYTES = 128 * 2**20
#: enqueues behind each host cost per call
HOST_CALLS = 200


def flush_buffer(device) -> torch.Tensor:
    """A buffer larger than the L2; a read of it evicts the operands of
    the next launch."""
    return torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device=device)


def alternating_ms(fns, flush, reps: int = REPS) -> list:
    """Device-only median time (ms) of each of ``fns``, timed in turns over
    ``reps`` rounds (forward order, then reverse: kernel, library, library,
    kernel, ...).  Before each launch: a read-only pass over ``flush`` and a
    device-side wait of SLEEP_CYCLES, so that the card is still busy when
    the host has enqueued the timed call and ``t0`` .. ``t1`` holds only the
    call's own device work."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    marks = [[] for _ in fns]
    for rep in range(reps):
        order = range(len(fns)) if rep % 2 == 0 else \
            range(len(fns) - 1, -1, -1)
        for i in order:
            flush.sum()
            torch.cuda._sleep(SLEEP_CYCLES)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fns[i]()
            t1.record()
            marks[i].append((t0, t1))
    torch.cuda.synchronize()
    return [statistics.median(a.elapsed_time(b) for a, b in m)
            for m in marks]


def host_us(fn) -> float:
    """Host microseconds per call of ``fn``: ``time.perf_counter`` over
    HOST_CALLS enqueues (the solver is host-bound, so this cost is real on
    its path)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / HOST_CALLS * 1e6

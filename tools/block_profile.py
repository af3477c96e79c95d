"""Where the block Lanczos cycle's time goes on the card
(``core/block``; phase 13d's flagship cell: the 2-D Laplacian's CSR at
nx = 1024 imported as DIA, float32, k = 8, ncv = 32).

For each block size: the wall per cycle over steady cycles on the solve's
CUDA graph and with the operator declared not capturable (every cycle
eager), then ``torch.profiler`` over eager cycles: the device time per
cycle and its largest items by kernel name, so a graph cycle that does
not get faster than its device time shows it.  Prints the card's name
and power limit.  Runs on a CUDA card only:

    python tools/block_profile.py [--nx 1024] [--blocks 1,2,4]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import arpack_ng_tpu_torch as pt  # noqa: E402
from arpack_ng_tpu_torch.core.block import make_block_solver  # noqa: E402
from arpack_ng_tpu_torch.models import laplacian_2d  # noqa: E402


def _gpu() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def _ms_per_cycle(op, b, warm, cycles):
    init, cycle, _, _ = make_block_solver(op, b, 8, 32, np.float32)
    st = init()
    for _ in range(warm):
        st, theta, bounds = cycle(st)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(cycles):
        st, theta, bounds = cycle(st)
        torch.stack([theta, bounds]).cpu()       # the solve's one read
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / cycles, st, cycle


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--blocks", default="1,2,4")
    ap.add_argument("--cycles", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("block_profile: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gpu = _gpu()
    print(f"card {gpu}; torch {torch.__version__}", flush=True)
    a = laplacian_2d(args.nx, np.float32, device="cpu")[1]
    op = pt.from_scipy(a, dtype=np.float32, hermitian=True, device=dev)
    eager_op = dataclasses.replace(op, capturable=False)
    for b in (int(x) for x in args.blocks.split(",")):
        g_ms, _, _ = _ms_per_cycle(op, b, 3, args.cycles)
        e_ms, st, cycle = _ms_per_cycle(eager_op, b, 3, args.cycles)
        prof_cycles = 5
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(prof_cycles):
                st, theta, bounds = cycle(st)
                torch.stack([theta, bounds]).cpu()
            torch.cuda.synchronize()
        items = [e for e in prof.key_averages()
                 if e.device_time_total > 0 and e.device_type.name == "CUDA"]
        dev_ms = sum(e.device_time_total for e in items) / 1e3 / prof_cycles
        items.sort(key=lambda e: -e.device_time_total)
        print(f"b={b}: {g_ms:.4f} ms per cycle on the graph, {e_ms:.4f} "
              f"eager; device time {dev_ms:.4f} ms per eager cycle "
              f"({len(items)} kernel names); card {gpu}", flush=True)
        for e in items[:8]:
            print(f"  {e.device_time_total / 1e3 / prof_cycles:9.4f} ms "
                  f"{e.count // prof_cycles:5d}x  {e.key[:90]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

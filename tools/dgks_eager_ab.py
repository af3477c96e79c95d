#!/usr/bin/env python3
"""The hybrid's eager dgks extension, read-free against the host's step.

    python3 tools/dgks_eager_ab.py [--nx 1024] [--rounds 2]

Solves ``chip_smoke.py``'s phase-4 problem (the 2-D Dirichlet Laplacian at
nx = 1024, float32, k = 8, ncv = 32, which = 'LA', tol = 1e-5) through
``eigsh(strategy='hybrid', reorth='dgks')``: the hybrid driver, which runs
its extension eagerly (no CUDA graph), as the CLI (phase 14a) and the C
ABI (16a) do.  Each round runs it with the extension as it is (read-free:
``load``, ``run``, one read) and with the host's step
(``Extension.stepwise``: each step's decisions read back), in turns
(stepwise, read-free, read-free, stepwise), so both meet the same card and
host.  The two must give the same counters and values bit for bit.
Then the same problem once on the dgks device loop (``strategy='auto'``)
beside them.  Prints each run's wall, ms per step and counters, and a JSON
line with the walls.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("dgks_eager_ab: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core import arnoldi, iram
    from arpack_ng_tpu_torch.models import laplacian_2d

    dev = torch.device("cuda", 0)
    gpu = chip_smoke._gpu_line()
    print(gpu, flush=True)
    small, _ = laplacian_2d(64, np.float32, device=dev)  # warm-up
    pt.eigsh(small, k=8, ncv=chip_smoke.NCV, which="LA", tol=1e-5,
             reorth="dgks", strategy="hybrid")
    op, a_sp = laplacian_2d(args.nx, np.float32, device=dev)
    spectrum = chip_smoke._analytic_spectrum(args.nx)
    real = iram.make_extend

    def stepwise(o, c):
        return arnoldi.Extension(real(o, c).stepwise)

    def solve(name, strategy="hybrid"):
        patch = (mock.patch.object(iram, "make_extend", stepwise)
                 if name == "stepwise" else mock.patch.object(
                     iram, "make_extend", real))
        with patch:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vals, vecs, out = pt.eigsh(op, k=8, ncv=chip_smoke.NCV,
                                       which="LA", tol=1e-5, reorth="dgks",
                                       strategy=strategy, return_stats=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        chip_smoke.check_values(vals, vecs, a_sp, spectrum,
                                f"{name} {strategy}")
        st = out.stats
        counts = (st.n_iter, st.nopx, st.nrorth, st.nitref, st.nrotr)
        print(f"{name} ({strategy}): wall {wall:.4f} s, "
              f"{wall * 1e3 / (st.nopx - 1):.4f} ms per step; cycles, nopx, "
              f"nrorth, nitref, nrotr {counts}; card {gpu}", flush=True)
        return wall, counts, vals

    walls = {"stepwise": [], "read-free": []}
    ref = None
    for _ in range(args.rounds):
        for name in ("stepwise", "read-free", "read-free", "stepwise"):
            wall, counts, vals = solve(name)
            walls[name].append(wall)
            if ref is None:
                ref = (counts, vals)
            elif counts != ref[0] or not np.array_equal(vals, ref[1]):
                raise AssertionError(f"{name}: counters {counts} or values "
                                     f"differ from {ref[0]}")
    wall, counts, _ = solve("read-free", strategy="auto")
    print(json.dumps({"nx": args.nx, "card": gpu, "hybrid walls": walls,
                      "hybrid counters": ref[0], "device loop wall": wall,
                      "device loop counters": counts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

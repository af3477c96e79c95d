#!/usr/bin/env python3
"""The flagship's restart counts over start-vector seeds, on a card.

    python3 tools/flagship_seeds.py [--seeds 5] [--nx 1024] [--reorth dgks]

Solves ``chip_smoke.py``'s phase-4 problem (the 2-D Dirichlet Laplacian at
nx = 1024, float32, k = 8, ncv = 32, which = 'LA', tol = 1e-5) through
``eigsh`` with ``reorth`` ('selective', the default, or 'dgks') for seeds
0 .. seeds - 1, each twice: on the device restart loop with the reduced
space as the kernel of ``csrc/sym_cycle.cu``, and with the reduced space
on the host as the host loop computed it (``chip_smoke._host_sym_cycle``:
the numpy twin on host copies).  Everything else is the same code, so the
two columns differ only by the reduced space's rounding.  Each solve must
pass phase 4's value and residual gates.  Prints one line per seed
(cycles, matvecs, refinements or events, the host's reruns of an
extension and the wall of each run) and a JSON line with each run's counts
over the seeds: the spread that ``chip_smoke.SELECTIVE_BAND`` (selective)
and ``chip_smoke.DGKS_BAND`` (dgks) are read from.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--reorth", choices=("selective", "dgks"),
                    default="selective")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("flagship_seeds: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core import arnoldi, device_sym
    from arpack_ng_tpu_torch.models import laplacian_2d

    dev = torch.device("cuda", 0)
    gpu = chip_smoke._gpu_line()
    print(gpu, flush=True)
    small, _ = laplacian_2d(64, np.float32, device=dev)  # warm-up
    pt.eigsh(small, k=8, ncv=chip_smoke.NCV, which="LA", tol=1e-5)
    op, a_sp = laplacian_2d(args.nx, np.float32, device=dev)
    spectrum = chip_smoke._analytic_spectrum(args.nx)
    runs = {"kernel": [], "host reduced": []}
    for seed in range(args.seeds):
        line = []
        for name in runs:
            patch = (mock.patch.object(device_sym, "sym_cycle",
                                       chip_smoke._host_sym_cycle)
                     if name == "host reduced" else contextlib.nullcontext())
            for k in arnoldi.reruns:
                arnoldi.reruns[k] = 0
            with patch:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                vals, vecs, out = pt.eigsh(op, k=8, ncv=chip_smoke.NCV,
                                           which="LA", tol=1e-5, seed=seed,
                                           reorth=args.reorth,
                                           return_stats=True)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            chip_smoke.check_values(vals, vecs, a_sp, spectrum,
                                    f"seed {seed} {name}")
            st = out.stats
            runs[name].append([st.n_iter, st.nopx, st.nrorth])
            line.append(f"{name}: cycles {st.n_iter}, nopx {st.nopx}, nrorth "
                        f"{st.nrorth}, host reruns {dict(arnoldi.reruns)}, "
                        f"packets {st.packets}, {wall:.4f} s")
        print(f"seed {seed}: " + "; ".join(line), flush=True)
    print(json.dumps({"nx": args.nx, "reorth": args.reorth, "card": gpu,
                      "cycles, nopx, nrorth by seed": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

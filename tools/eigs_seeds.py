#!/usr/bin/env python3
"""Phase 9b-c's restart counts over start-vector seeds, on a card.

    python3 tools/eigs_seeds.py [--seeds 5] [--nx 512]

Solves ``chip_smoke.py``'s phase-9b-c problems (the convection-diffusion
operator at nx = 512, rho = 100, float32, k = 8, ncv = 32, which = 'LM',
tol = 1e-5; (b) the stencil operator, (c) its CSR matrix imported as DIA
with ``cgs_kernel='pallas'``) through ``eigs`` for seeds 0 .. seeds - 1,
each twice: on the device restart loop with the reduced space as the
kernel of ``csrc/realnonsym_cycle.cu``, and with the reduced space on the
host as the host loop computes it (``chip_smoke._host_realnonsym_cycle``:
the numpy twin on host copies).  Everything else is the same code, so the
two columns differ only by the reduced space's rounding.  Each solve must
pass phase 9's gates (``chip_smoke.check_nonsym``; a failure is printed
and makes the exit code 1).  Prints one line per
seed (cycles, matvecs, refinements, the host's reruns of an extension,
packets, the count of values, the extraction's info and the wall of each
run) and a JSON line with each run's counts
over the seeds: the spread that ``chip_smoke.EIGS_BAND`` is read from.
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
    ap.add_argument("--nx", type=int, default=512)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("eigs_seeds: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core import arnoldi, device_realnonsym
    from arpack_ng_tpu_torch.models import convection_diffusion_2d

    dev = torch.device("cuda", 0)
    gpu = chip_smoke._gpu_line()
    print(gpu, flush=True)
    op, a_sp = convection_diffusion_2d(args.nx, dtype=np.float32, device=dev)
    kw = dict(k=8, ncv=chip_smoke.NCV, which="LM", tol=1e-5,
              maxiter=chip_smoke.EIGS_MAX_RESTARTS, return_stats=True)
    pt.eigs(convection_diffusion_2d(64, dtype=np.float32, device=dev)[0],
            **kw)  # warm-up
    solves = {"(b)": lambda s: pt.eigs(op, seed=s, **kw),
              "(c)": lambda s: pt.eigs(a_sp, dtype=np.float32,
                                       cgs_kernel="pallas", seed=s, **kw)}
    runs = {f"{tag} {name}": [] for tag in solves
            for name in ("kernel", "host reduced")}
    failed = False
    for seed in range(args.seeds):
        line = []
        for tag, solve in solves.items():
            for name in ("kernel", "host reduced"):
                patch = (mock.patch.object(device_realnonsym,
                                           "realnonsym_cycle",
                                           chip_smoke._host_realnonsym_cycle)
                         if name == "host reduced"
                         else contextlib.nullcontext())
                for k in arnoldi.reruns:
                    arnoldi.reruns[k] = 0
                with patch:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    vals, vecs, out = solve(seed)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                try:
                    rmax = chip_smoke.check_nonsym(
                        vals, vecs, a_sp, f"seed {seed} {tag} {name}")
                    gate = f"residual {rmax:.2e}"
                except AssertionError as e:
                    gate, failed = f"GATE FAILED: {e}", True
                st = out.stats
                runs[f"{tag} {name}"].append([st.n_iter, st.nopx,
                                              st.nrorth])
                line.append(f"{tag} {name}: cycles {st.n_iter}, nopx "
                            f"{st.nopx}, nrorth {st.nrorth}, host reruns "
                            f"{dict(arnoldi.reruns)}, packets {st.packets}, "
                            f"{len(vals)} values, extraction info "
                            f"{out.info}, {gate}, {wall:.4f} s")
        print(f"seed {seed}: " + "; ".join(line), flush=True)
    cycles = [r[0] for v in runs.values() for r in v]
    print(json.dumps({"nx": args.nx, "card": gpu, "cycles span":
                      [min(cycles), max(cycles)],
                      "cycles, nopx, nrorth by seed": runs}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""How far a float32 eigensolve moves the symmetric reduced space, on the CPU.

    python3 tools/reduced_rounding_cpu.py

The reduced-space kernel (``arpack_ng_tpu_torch/csrc/sym_cycle.cu``) runs
its eigensolve and its QR factorizations in double and rounds their
results to float32, as its numpy twin does (numpy's float32 ``eigh`` and
``qr`` compute in double).  ``chip_smoke.py`` (phase 3) and
``tests/test_torch_gpu.py`` hold the kernel to the twin on Lanczos
tridiagonals of the flagship's spectrum (ncv = 32, nev = 8).  This script
takes the same inputs, for each ``which``, through the twin and through a
variant whose
eigensolve and QR run in float32 (``torch.linalg.eigh`` / ``qr`` on
float32 CPU tensors: LAPACK's single-precision routines), the fault a
float32 kernel would have, and prints each gap the checks read, in their
units (``chip_smoke._sym_gaps``): Ritz values and bounds over T's scale,
the new T over the scale, Q's kept columns, sigmak, and the residual's new
part over the scale, and the smallest and largest of each over the cases.  A limit that a kernel
meets and this variant breaks sits between the two.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from unittest import mock

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

NCV, NEV = 32, 8


def _f32_eigh(a):
    import torch
    w, v = torch.linalg.eigh(torch.from_numpy(np.asarray(a, np.float32)))
    return w.numpy(), v.numpy()


def _f32_qr(a):
    import torch
    q, r = torch.linalg.qr(torch.from_numpy(np.asarray(a, np.float32)))
    return q.numpy(), r.numpy()


def main() -> int:
    import torch

    import chip_smoke
    from arpack_ng_tpu_torch.ops import cuda_sym_cycle as csc

    def cycle(d, e, p):
        return chip_smoke._sym_run(torch, csc, d, e, torch.float32,
                                   torch.device("cpu"), p)

    f = np.finfo(np.float32)
    lo, hi = {}, {}
    for which in csc.WHICH:
        p = csc.Params(which=which, nev=NEV, tol=1e-5,
                       eps23=float(f.eps ** (2 / 3)), eps_m=float(f.eps))
        for seed in range(4):
            d, e = chip_smoke._lanczos_tridiag(seed=seed)
            d, e = d.astype(np.float32), e.astype(np.float32)
            twin = cycle(d, e, p)
            with mock.patch.object(np.linalg, "eigh", _f32_eigh), \
                    mock.patch.object(np.linalg, "qr", _f32_qr):
                var = cycle(d, e, p)
            g = chip_smoke._sym_gaps(twin, var, d, NCV)
            print(json.dumps({"which": which, "seed": seed,
                              "float32 eigensolve and QR": g}))
            for key, v in g.items():
                if key != "counts_equal":
                    lo[key] = min(lo.get(key, np.inf), v)
                    hi[key] = max(hi.get(key, 0.0), v)
    print(json.dumps({"smallest over cases": lo, "largest": hi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

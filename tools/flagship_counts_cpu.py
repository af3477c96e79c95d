#!/usr/bin/env python3
"""Counters of the JAX reference package's flagship solve, on the host CPU.

    JAX_PLATFORMS=cpu python3 tools/flagship_counts_cpu.py [--nx 1024]

Runs ``arpack_ng_tpu``'s ``FusedSymSolver`` (the reference driver: its
restart loop inside one on-device ``while_loop`` per chunk) on the
flagship problem of ``bench.py``: the 2-D Dirichlet Laplacian at nx = 1024
(n = 1,048,576), float32, k = 8, ncv = 32, which = 'LA', tol = 1e-5, seed
0, once with ``reorth='selective'`` and once with ``reorth='dgks'``.
Prints first the relative error of one float32 dot product of n = nx^2
positive terms on this backend and in torch on the CPU (against float64),
then one JSON line per variant: cycles, matvecs, events (``nrorth``) and
the other counters, the wall seconds on this CPU and the eight values.
The PyTorch port's counters on the card are held against these (the
summation order differs, so they agree as a band, not exactly).

    python3 tools/flagship_counts_cpu.py --package port

runs the same solves through the PyTorch port on the CPU instead
(``device="cpu"``, 4 threads).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def _dot_error(n: int) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, n).astype(np.float32)
    y = rng.uniform(0, 1, n).astype(np.float32)
    exact = float(np.dot(x.astype(np.float64), y.astype(np.float64)))
    xla = float(jax.jit(jnp.dot)(x, y))
    tch = float(torch.dot(torch.from_numpy(x), torch.from_numpy(y)))
    print(json.dumps({"dot_n": n, "backend": jax.default_backend(),
                      "rel_err_jax": abs(xla - exact) / exact,
                      "rel_err_torch_cpu": abs(tch - exact) / exact,
                      "eps": float(np.finfo(np.float32).eps)}), flush=True)


def _port(args) -> int:
    import torch

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.models import laplacian_2d

    torch.set_num_threads(4)
    op, _ = laplacian_2d(args.nx, np.float32, device="cpu")
    for reorth in args.reorth:
        t0 = time.perf_counter()
        vals, _, out = pt.eigsh(op, k=8, ncv=32, which="LA", tol=1e-5,
                                reorth=reorth, return_stats=True)
        st = out.stats
        print(json.dumps({
            "package": "port", "reorth": reorth, "nx": args.nx,
            "device": "cpu", "cycles": st.n_iter, "nopx": st.nopx,
            "nrorth": st.nrorth, "nitref": st.nitref,
            "nrorthr": st.nrorthr, "nrotr": st.nrotr,
            "wall_s": time.perf_counter() - t0,
            "values": sorted(float(v) for v in vals)}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--reorth", nargs="*", default=["selective", "dgks"])
    ap.add_argument("--package", choices=("reference", "port"),
                    default="reference")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    _dot_error(args.nx ** 2)
    if args.package == "port":
        return _port(args)
    import jax

    from arpack_ng_tpu import models
    from arpack_ng_tpu.config import IRAMConfig
    from arpack_ng_tpu.core.device_sym import FusedSymSolver

    op, _ = models.laplacian_2d(args.nx, dtype=np.float32)
    for reorth in args.reorth:
        cfg = IRAMConfig(n=op.n, nev=8, ncv=32, which="LA", symmetric=True,
                         dtype=np.dtype(np.float32), tol=1e-5,
                         n_pad=op.n_pad, max_iter=10 * op.n, seed=0,
                         reorth=reorth)
        t0 = time.perf_counter()
        res = FusedSymSolver(op, cfg).solve()
        wall = time.perf_counter() - t0
        c = jax.device_get(res.state.counts)
        print(json.dumps({
            "reorth": reorth, "nx": args.nx, "backend": jax.default_backend(),
            "cycles": int(res.n_iter), "nopx": int(c.nopx),
            "nrorth": int(c.nrorth), "nitref": int(c.nitref),
            "nrorthr": int(c.nrorthr), "nrotr": int(c.nrotr),
            "nconv": int(res.nconv), "info": int(res.info),
            "wall_s": wall,
            "values": sorted(float(v) for v in res.ritz[:8])}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""How far each Hermitian ``eigsh`` driver's values drift from the operator
on ``chip_smoke.py``'s phase-10c input, over start vectors.

    python3 tools/hermitian_drift.py --impl torch [--nx 1024] [--seeds 4]
    python3 tools/hermitian_drift.py --impl jax [--nx 256] [--seeds 4]

The operator is phase 10c's ``A = T_c (x) I + I (x) T_0`` (complex64, c =
0.5, ``T_c = tridiag(-1 - ic, 2, -1 + ic)``, ``T_0 = tridiag(-1, 2, -1)``)
with its analytic spectrum.  Each seed's start vector is drawn by numpy
(real and imaginary parts uniform in (-1, 1)) and passed as ``v0``, so
``--impl jax`` (the reference package, on its own in the process) and
``--impl torch`` (the port, on its own: on the card where there is one,
else on the CPU) start from the same vector.  Every solve is phase 10c's:
k = 8, ncv = 32, tol = 1e-5, which = 'LA'.

Strategies: ``auto`` (the selective restart loop: on the card the device
loop with the ``sym_cycle`` kernel; on the CPU the same loop with the
kernel's numpy twin; in the reference its fused device loop), ``hybrid``
(the host float64 reduced space), and, on the card, ``witness`` (the
device loop with the reduced space on the host, as the host loop computed
it: ``chip_smoke._host_sym_cycle``).

Per solve it prints the cycles and counters, how far the top value lies
above the spectrum's top (``above``; a Rayleigh quotient of a Hermitian
operator cannot lie above it), the largest relative distance of a value
to the analytic spectrum (``dist``), and the largest relative gap between
a value and the float64 Rayleigh quotient of its returned vector (``rq``:
how far the projected T has drifted from ``V^H A V``).  The last line is
a JSON object with every solve.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

HERM_C = 0.5


def hermitian_operator(nx, c=HERM_C):
    """The operator (scipy CSR, complex128) and its ascending spectrum, as
    ``chip_smoke._hermitian_operator`` builds them."""
    one = np.ones(nx - 1)
    tc = sp.diags([(-1 - 1j * c) * one, 2 * np.ones(nx), (-1 + 1j * c) * one],
                  [-1, 0, 1])
    t0 = sp.diags([-one, 2 * np.ones(nx), -one], [-1, 0, 1])
    eye = sp.identity(nx)
    a = (sp.kron(tc, eye) + sp.kron(eye, t0)).tocsr().astype(np.complex128)
    cs = np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    lam = (2.0 - 2.0 * np.sqrt(1.0 + c * c) * cs)[:, None] \
        + (2.0 - 2.0 * cs)[None, :]
    return a, np.sort(lam.ravel())


def start_vector(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, n) + 1j * rng.uniform(-1, 1, n)).astype(
        np.complex64)


def measures(vals, vecs, a, spectrum):
    """``above``, ``dist``, ``rq`` and the largest residual (float64)."""
    vals = np.asarray(vals, np.float64)
    v = np.asarray(vecs, np.complex128)
    av = a @ v
    pos = np.clip(np.searchsorted(spectrum, vals), 1, len(spectrum) - 1)
    dist = np.minimum(np.abs(spectrum[pos] - vals),
                      np.abs(spectrum[pos - 1] - vals)) / np.abs(vals)
    rq = np.real(np.sum(v.conj() * av, axis=0)) / np.real(
        np.sum(v.conj() * v, axis=0))
    res = np.linalg.norm(av - v * vals[None, :], axis=0) / np.abs(vals)
    return dict(above=float(vals.max() - spectrum[-1]),
                dist=float(dist.max()),
                rq=float(np.max(np.abs(vals - rq) / np.abs(vals))),
                residual=float(res.max()))


def solvers(impl, a):
    """``(name -> solve(v0), sync, card)`` for each strategy of one
    package; ``card`` is the card's line, or None on the CPU."""
    kw = dict(k=8, ncv=32, tol=1e-5, which="LA", return_stats=True)
    if impl == "jax":
        import arpack_ng_tpu as at
        from arpack_ng_tpu.ops.sparse import from_scipy

        op = from_scipy(a, dtype=np.complex64, hermitian=True)
        return {s: (lambda v0, s=s: at.eigsh(op, v0=v0, strategy=s, **kw))
                for s in ("auto", "hybrid")}, (lambda: None), None

    import contextlib
    from unittest import mock

    import torch

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core import device_sym

    gpu = torch.cuda.is_available()
    dev = torch.device("cuda", 0) if gpu else torch.device("cpu")
    op = pt.from_scipy(a, dtype=np.complex64, hermitian=True, device=dev)
    if gpu:
        import chip_smoke

    def solve(strategy, v0):
        patch = contextlib.nullcontext()
        if strategy == "witness":
            patch = mock.patch.object(device_sym, "sym_cycle",
                                      chip_smoke._host_sym_cycle)
            strategy = "auto"
        with patch:
            return pt.eigsh(op, v0=v0, strategy=strategy, **kw)

    strategies = ("auto", "witness", "hybrid") if gpu else ("auto", "hybrid")
    return ({s: (lambda v0, s=s: solve(s, v0)) for s in strategies},
            torch.cuda.synchronize if gpu else (lambda: None),
            chip_smoke._gpu_line() if gpu else None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--impl", choices=("torch", "jax"), required=True)
    ap.add_argument("--nx", type=int, default=256)
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args()
    a, spectrum = hermitian_operator(args.nx)
    run, sync, card = solvers(args.impl, a)
    if card:
        print(card, flush=True)
    rows = []
    for seed in range(args.seeds):
        v0 = start_vector(a.shape[0], seed)
        for name, solve in run.items():
            sync()
            t0 = time.perf_counter()
            vals, vecs, out = solve(v0)
            sync()
            wall = time.perf_counter() - t0
            st = out.stats
            row = dict(impl=args.impl, nx=args.nx, seed=seed, strategy=name,
                       cycles=int(st.n_iter), nopx=int(st.nopx),
                       nrorth=int(st.nrorth), wall_s=wall, values=len(vals),
                       **measures(vals, vecs, a, spectrum))
            rows.append(row)
            print(f"{args.impl} nx={args.nx} seed {seed} {name}: cycles "
                  f"{row['cycles']}, nopx {row['nopx']}, nrorth "
                  f"{row['nrorth']}; above {row['above']:.3e}, dist "
                  f"{row['dist']:.3e}, rq {row['rq']:.3e}, residual "
                  f"{row['residual']:.3e}; {wall:.4f} s", flush=True)
    print(json.dumps({"spectrum_top": float(spectrum[-1]), "card": card,
                      "solves": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

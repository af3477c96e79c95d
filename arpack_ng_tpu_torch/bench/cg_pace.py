#!/usr/bin/env python3
"""The pace of one preconditioned CG iteration in two checkouts, on a card.

    python -m arpack_ng_tpu_torch.bench.cg_pace --base DIR [--nx 1024]
        [--its 500]

``DIR`` holds another checkout of the repository (``git archive`` of the
commit to compare with, unpacked where ``.gitignore`` lists it, such as
``_final/base``). Each checkout runs in a process of its own, in the order
base, this, this, base, and builds its own kernels: ``chip_smoke.py``
12a's inner solve, CG on the 2-D Laplacian at ``nx`` (float64, imported
as DIA) with ``ilu0_preconditioner(symmetric=True, sweeps=3)`` (IC(0):
the DIA kernel for the product and both triangles), on the same seeded
right-hand side. Each process times ``its`` iterations with the loop
test's device read (``solvers._cg`` at tol 0), without it (``its``
in-place iterations, ``solvers._cg_iteration``, the fused update kernels;
in a checkout without them ``its`` times ``cg_step``) and, where the
checkout has them, as one
CUDA-graph WHILE node (``make_iterative_solve``'s solve captured once
and replayed; ``graph_ms`` null in a checkout without), in turns (read,
free, graph, graph, free, read, read, free, graph), and prints the
median ms per iteration of each. The last line is a JSON object with
every run.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

CHILD = r'''
import json, sys, time
sys.path.insert(0, {tree!r})
import numpy as np, torch
import arpack_ng_tpu_torch as pt
from arpack_ng_tpu_torch.models import laplacian_2d
from arpack_ng_tpu_torch.ops import cuda_lib, solvers
cuda_lib.load()
dev = torch.device("cuda", 0)
nx, its = {nx}, {its}
a = laplacian_2d(nx, np.float64, device="cpu")[1]
op = pt.from_scipy(a, format="dia", device=dev)
pc = solvers.ilu0_preconditioner(a, symmetric=True, sweeps=3,
                                 n_pad=op.n_pad, device=dev)
b = torch.zeros(op.n_pad, dtype=torch.float64, device=dev)
b[:nx * nx] = torch.from_numpy(
    np.random.default_rng(12).standard_normal(nx * nx)).to(dev)

def with_reads():
    if solvers._cg(op.a_apply, b, None, 0.0, its, pc)[1] != its:
        raise AssertionError("CG stopped before its iteration count")

def read_free():
    c, _ = solvers.cg_start(op.a_apply, b, None, 0.0, pc)
    if hasattr(solvers, "_cg_iteration"):
        carry = solvers._cg_carry(c, pc)
        for _ in range(its):
            solvers._cg_iteration(op.a_apply, carry, pc)
        return
    for _ in range(its):
        c = solvers.cg_step(op.a_apply, c, pc)

forms = [with_reads, read_free]
if hasattr(solvers, "IterativeSolve"):
    from arpack_ng_tpu_torch.core.loop import CapturedGraph
    solve = solvers.make_iterative_solve(op.a_apply, symmetric=True,
                                         tol=0.0, maxiter=its, precond=pc)
    solve.bind(dev)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph = CapturedGraph(lambda: solve(b),
                              torch.cuda.graph_pool_handle())

    def on_graph():
        with torch.cuda.stream(stream):
            graph.replay()

    forms.append(on_graph)
for f in forms:
    f()
times = [[] for _ in forms]
for i in (0, 1, 2, 2, 1, 0, 0, 1, 2):
    if i < len(forms):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forms[i]()
        torch.cuda.synchronize()
        times[i].append((time.perf_counter() - t0) * 1e3 / its)
if len(forms) == 3:
    if solve.iterations != [its] * 4:
        raise AssertionError(f"graph solves ran {{solve.iterations}}")
print(json.dumps({{"read_ms": float(np.median(times[0])),
                  "free_ms": float(np.median(times[1])),
                  "graph_ms": (float(np.median(times[2]))
                               if len(forms) == 3 else None)}}))
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True, type=Path)
    ap.add_argument("--nx", type=int, default=1024)
    ap.add_argument("--its", type=int, default=500)
    args = ap.parse_args()
    trees = {"base": args.base.resolve(), "this": REPO}
    runs = []
    for name in ("base", "this", "this", "base"):
        code = CHILD.format(tree=str(trees[name]), nx=args.nx, its=args.its)
        out = subprocess.run([sys.executable, "-c", code], cwd=trees[name],
                             capture_output=True, text=True, timeout=1200)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        res = json.loads(out.stdout.strip().splitlines()[-1])
        runs.append({"tree": name, **res})
        graph = res.get("graph_ms")
        graph = "none" if graph is None else f"{graph:.4f}"
        print(f"{name}: {res['read_ms']:.4f} ms per CG iteration with the "
              f"loop test's read, {res['free_ms']:.4f} without, {graph} as "
              f"a WHILE node", flush=True)
    print(json.dumps({"nx": args.nx, "its": args.its, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

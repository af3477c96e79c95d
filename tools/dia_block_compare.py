#!/usr/bin/env python3
"""The block DIA kernel of two checkouts side by side, on a card.

    python3 tools/dia_block_compare.py --base DIR

``DIR`` holds another checkout of the repository (``git archive`` of the
commit to compare with, unpacked where ``.gitignore`` lists it, such as
``_final/base``).  Each checkout builds its own kernels
(``arpack_ng_tpu_torch.ops.cuda_lib``, both builds at once) and runs its
``dia_block_kernel`` (``csrc/dia.cu``) through its wrapper,
``cuda_dia.dia_block_matvec``, in a process of its own, in the order base,
this, this, base, on the same inputs:

* ``chip_smoke.py`` phase 13e's shapes: the flagship's 5 diagonals
  (nx = 1024) and ``chip_smoke.dia65``'s 65 at n = 2^20, float32 and
  float64, b = 1-8, at n and at n + 3 (random table entries in the three
  new rows);
* the case list of ``tests/torch_dia_cases.py`` in both dtypes at every
  block size of its ``BLOCKS``.

With ``--solves``, each run then also solves phase 13d's block problems
(``eigsh_block``, float32, k = 8, ncv = 32, b = 1, 2, 4: the flagship's CSR
through ``from_scipy`` at tol 1e-5 and dia65 at 1e-4) and reports each
solve's cycles, matvecs, wall and ms per cycle: equal bits give equal
cycle counts in both checkouts.

Prints each checkout's device-only medians (13e's protocol:
``bench.timing.alternating_ms``, L2 flushed before each launch) at n, b =
1, 2, 4, 8, in each of the four runs, with this checkout's plan of each
timed shape where its wrapper has one (``cuda_dia.block_plan``,
``block_config``), and whether every output of this checkout equals the
base's bit for bit (a SHA-256 of each output's bytes), and each
checkout's two runs each other's.  The last line is a JSON object with all
of it.  Exits non-zero if any output differs (with ``--solves``, also if
any cycle or matvec count does).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
TIMED_BLOCKS = (1, 2, 4, 8)


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` (whichever package is imported)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tables():
    """(name, offsets, row-aligned diagonals, n) of 13e's two tables."""
    from arpack_ng_tpu_torch.models import laplacian_2d
    from arpack_ng_tpu_torch.ops.sparse import _to_dia

    chip_smoke = _chip_smoke()
    nx = chip_smoke.NX
    flag = _to_dia(laplacian_2d(nx, np.float64, device="cpu")[1])
    return (("flagship", *flag, nx * nx),
            ("dia65", *chip_smoke.dia65(chip_smoke.P13_N), chip_smoke.P13_N))


def _solves(torch, dev) -> list:
    """13d's block solves, each timed between syncs."""
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core.block import eigsh_block
    from arpack_ng_tpu_torch.models import laplacian_2d

    cs = _chip_smoke()
    a_sp = laplacian_2d(cs.NX, np.float32, device="cpu")[1]
    ops = (("flagship", pt.from_scipy(a_sp, dtype=np.float32, hermitian=True,
                                      device=dev), 1e-5),
           ("dia65", cs._dia_operator(*cs.dia65(cs.P13_N), cs.P13_N, dev),
            1e-4))
    out = []
    for name, A, tol in ops:
        for b in cs.P13_BLOCKS:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            vals, _, info = eigsh_block(A, k=8, ncv=cs.NCV, tol=tol,
                                        block_size=b,
                                        maxiter=cs.P13_BLOCK_MAXITER,
                                        dtype=np.float32)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out.append({"op": name, "b": b, "cycles": int(info["iters"]),
                        "matvecs": int(info["matvecs"]), "wall_s": wall,
                        "ms_per_cycle": wall * 1e3 / info["iters"],
                        "top": float(np.max(vals))})
    return out


def _digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:24]


def _worker(root: Path, build_only: bool, solves: bool) -> int:
    # the checkout's package; this checkout's inputs
    sys.path[:0] = [str(root), str(REPO / "tests")]
    import torch

    from arpack_ng_tpu_torch.bench import timing
    from arpack_ng_tpu_torch.config import pad_dim
    from arpack_ng_tpu_torch.ops import cuda_dia, cuda_lib
    from arpack_ng_tpu_torch.ops.sparse import _dia_tab

    import torch_dia_cases

    t0 = time.perf_counter()
    cuda_lib.load()
    if build_only:
        print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
        return 0
    dev = torch.device("cuda", 0)
    flush = timing.flush_buffer(dev)
    digests, rows = {}, []
    for name, offsets, diags, n in _tables():
        offs = torch.tensor(offsets, dtype=torch.int64, device=dev)
        for dtype in (np.float32, np.float64):
            tdt = getattr(torch, dtype.__name__)
            for nn in (n, n + 3):
                n_pad = pad_dim(nn, 1024)
                tab = torch.from_numpy(_dia_tab(diags, n, n_pad,
                                                dtype)).to(dev)
                g = torch.Generator(device=dev).manual_seed(nn)
                if nn > n:
                    tab[:, n:nn] = torch.randn(len(offsets), nn - n,
                                               generator=g, device=dev,
                                               dtype=tdt)
                for b in range(1, 9):
                    X = torch.randn(b, n_pad, generator=g, device=dev,
                                    dtype=tdt)
                    Y = cuda_dia.dia_block_matvec(offs, tab, X, nn)
                    digests[f"{name}_{dtype.__name__}_{nn}_{b}"] = _digest(Y)
                    if nn > n or b not in TIMED_BLOCKS:
                        continue
                    ms = timing.alternating_ms(
                        [lambda: cuda_dia.dia_block_matvec(offs, tab, X, n)],
                        flush)[0]
                    plan = None
                    if hasattr(cuda_dia, "block_plan"):
                        p = cuda_dia.block_plan(offsets, n, b, tdt)
                        cfg = cuda_dia.block_config(len(offsets), b, n_pad,
                                                    tdt)
                        plan = {"runs": len(p["runs"]), "tile": cfg["tile"],
                                "smem": cfg["smem"],
                                "blocks_per_sm": cfg["blocks_per_sm"]}
                    rows.append({"table": name, "dtype": dtype.__name__,
                                 "b": b, "ms": ms, "plan": plan})
                del X, Y
            del tab
    for case in torch_dia_cases.CASES:
        for dtype in (np.float32, np.float64):
            for b in torch_dia_cases.BLOCKS:
                offs, dtab, X, n = (torch.from_numpy(a).to(dev) if
                                    isinstance(a, np.ndarray) else a for a in
                                    torch_dia_cases.make(case, dtype, b))
                Y = cuda_dia.dia_block_matvec(offs, dtab, X, n)
                digests[f"{case}_{dtype.__name__}_{b}"] = _digest(Y)
    torch.cuda.synchronize()
    print(json.dumps({"rows": rows, "digests": digests,
                      "solves": _solves(torch, dev) if solves else []}),
          flush=True)
    return 0


def _run(root: Path, build_only=False, solves=False):
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
           str(root)]
    if build_only:
        cmd.append("--build-only")
    if solves:
        cmd.append("--solves")
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)


def _last_json(proc) -> dict:
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"worker failed ({proc.returncode}):\n{text}")
    return json.loads(text.strip().splitlines()[-1])


def _differ(a: dict, b: dict) -> list:
    return sorted(k for k in a.keys() | b.keys() if a.get(k) != b.get(k))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", type=Path)
    ap.add_argument("--solves", action="store_true",
                    help="also time phase 13d's block solves in each run")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        return _worker(args.worker.resolve(), args.build_only, args.solves)
    import torch

    if not torch.cuda.is_available() or args.base is None:
        print("dia_block_compare: needs a CUDA device and --base",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    gpu = _chip_smoke()._gpu_line()
    print(gpu, flush=True)
    roots = {"base": args.base.resolve(), "this": REPO}
    builds = {k: _run(r, True) for k, r in roots.items()}
    for k, proc in builds.items():
        print(f"build {k}: {_last_json(proc)['build_s']:.1f} s", flush=True)
    runs = [(k, _last_json(_run(roots[k], solves=args.solves)))
            for k in ("base", "this", "this", "base")]
    print(f"dia_block_kernel device-only ms at n (runs base, this, this, "
          f"base); card {gpu}", flush=True)
    table = []
    for j, row in enumerate(runs[1][1]["rows"]):
        cells = [(k, out["rows"][j]["ms"]) for k, out in runs]
        plan = row["plan"]
        note = "" if plan is None else (
            f" (plan: {plan['runs']} runs, T = {plan['tile']}, "
            f"{plan['smem']} shared bytes a block, {plan['blocks_per_sm']} "
            "blocks per SM)")
        print(f"  {row['table']:8s} {row['dtype']} b={row['b']}: "
              + ", ".join(f"{k} {ms:.4f}" for k, ms in cells) + note,
              flush=True)
        table.append({**{k: row[k] for k in ("table", "dtype", "b", "plan")},
                      "runs": [{"tree": k, "ms": ms} for k, ms in cells]})
    solves = []
    for j, row in enumerate(runs[1][1]["solves"]):
        cells = [(k, out["solves"][j]) for k, out in runs]
        print(f"  13d {row['op']:8s} eigsh_block b={row['b']}: "
              + ", ".join(f"{k} {x['cycles']} cycles, {x['matvecs']} matvecs, "
                          f"{x['wall_s']:.3f} s, {x['ms_per_cycle']:.4f} ms a "
                          "cycle" for k, x in cells), flush=True)
        solves.append({"op": row["op"], "b": row["b"],
                       "runs": [{"tree": k, **x} for k, x in cells]})
    counts = {(x["op"], x["b"], x["cycles"], x["matvecs"]) for _, out in runs
              for x in out["solves"]}
    a, b, c, d = (out["digests"] for _, out in runs)
    differ = _differ(a, b)
    repeats = {"this": _differ(b, c), "base": _differ(a, d)}
    print(f"outputs over {len(b)} shapes and cases equal bit for bit: "
          f"{len(b) - len(differ)}; differ at: {', '.join(differ) or 'none'}",
          flush=True)
    print(f"each tree's two runs differ at: {repeats}", flush=True)
    if solves:
        print(f"13d cycles and matvecs equal in all four runs: "
              f"{len(counts) == len(solves)}", flush=True)
    print(json.dumps({"card": gpu, "times": table, "outputs": len(b),
                      "differ": differ, "repeats_differ": repeats,
                      "solves": solves}), flush=True)
    return 1 if differ or any(repeats.values()) or \
        len(counts) != len(solves) else 0


if __name__ == "__main__":
    sys.exit(main())

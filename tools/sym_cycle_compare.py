#!/usr/bin/env python3
"""The reduced-space kernel of two checkouts side by side, on a card.

    python3 tools/sym_cycle_compare.py --base DIR [--equal-through N]

``DIR`` holds another checkout of the repository (``git archive`` of the
commit to compare with, unpacked where ``.gitignore`` lists it, such as
``_final/base``). Each checkout builds its own kernels
(``arpack_ng_tpu_torch.ops.cuda_lib``, both builds at once) and runs its
``csrc/sym_cycle.cu`` through its wrapper, ``cuda_sym_cycle.sym_cycle``,
in a process of its own, in the order base, this, this, base, on the same
inputs: Lanczos tridiagonals of the flagship's spectrum (``chip_smoke.py``
phase 3), float32 and float64, at each ncv of ``SIZES`` (nev = 8 at ncv =
32, else ncv // 2, the default ncv's shape: about ncv / 2 shifts), for
every ``which`` and two seeds. Prints, for each size, how many parts of
each checkout's workspace sit in shared memory and the kernel's
device-only median time ('LA', seed 0; each call after the two copies that
restore its inputs, as phase 3 times it) in each of the four runs, with
this checkout's phase clocks (QL, head, sweep, tail) where its wrapper
takes a stamp buffer; and whether every output (a, b, Q, sk, the packet)
of this checkout equals the base's bit for bit, size by size. The last
line is a JSON object with all of it. Exits non-zero if any output differs
(with ``--equal-through N``: at an ncv up to N).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
#: (dtype, ncv): the last ncv whose workspace fits in shared memory, in
#: this checkout (111, 78) and in the commits before it (84, 57; 135, 95),
#: the first past each, and sizes between and beyond
SIZES = [("float32", n) for n in (32, 64, 84, 85, 96, 111, 112, 128, 129,
                                  135, 136, 160)] \
    + [("float64", n) for n in (32, 57, 58, 64, 78, 79, 90, 95, 96, 128,
                                129)]
WHICH = ("LA", "SA", "LM", "SM", "BE")
SEEDS = (0, 1)


def _nev(ncv: int) -> int:
    return 8 if ncv == 32 else ncv // 2


def _inputs(path: Path) -> None:
    sys.path.insert(0, str(REPO))
    import chip_smoke

    arrs = {}
    for _, ncv in SIZES:
        for seed in SEEDS:
            d, e = chip_smoke._lanczos_tridiag(ncv=ncv, seed=seed)
            arrs[f"d{ncv}_{seed}"], arrs[f"e{ncv}_{seed}"] = d, e
    np.savez(path, **arrs)


def _placement(csc, ncv: int, itemsize: int) -> str:
    """Where the kernel keeps its workspace: "s" all in shared memory, "g"
    all in global memory, "k/m" k of its m parts in shared memory."""
    if hasattr(csc, "smem_parts"):
        k = csc.smem_parts(ncv, itemsize)
        m = len(csc.part_bytes(ncv, itemsize))
    else:  # a workspace kept whole
        k, m = int(csc.fits_shared(ncv, itemsize)), 1
    return "s" if k == m else "g" if k == 0 else f"{k}/{m}"


def _worker(root: Path, inputs: Path, out: Path, build_only: bool) -> int:
    sys.path.insert(0, str(root))
    import torch

    from arpack_ng_tpu_torch.bench import timing
    from arpack_ng_tpu_torch.ops import cuda_lib
    from arpack_ng_tpu_torch.ops import cuda_sym_cycle as csc

    t0 = time.perf_counter()
    cuda_lib.load()
    if build_only:
        print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
        return 0
    dev = torch.device("cuda", 0)
    src = np.load(inputs)
    flush = timing.flush_buffer(dev)
    outs, rows = {}, []
    for dname, ncv in SIZES:
        dt = getattr(torch, dname)
        f = np.finfo(dname)
        t = dict(dtype=dt, device=dev)
        for which in WHICH:
            p = csc.Params(which=which, nev=_nev(ncv),
                           tol=1e-5 if dname == "float32" else 1e-10,
                           eps23=float(f.eps ** (2 / 3)), eps_m=float(f.eps))
            for seed in SEEDS:
                d, e = src[f"d{ncv}_{seed}"], src[f"e{ncv}_{seed}"]
                a0, b0 = torch.tensor(d, **t), torch.tensor(e, **t)
                bufs = [a0.clone(), b0.clone(), torch.tensor(e[-1], **t),
                        torch.tensor(-1, dtype=torch.int32, device=dev),
                        torch.tensor(0, dtype=torch.int32, device=dev),
                        torch.zeros(4, dtype=torch.int64, device=dev),
                        torch.zeros(ncv, ncv, **t), torch.zeros(2, **t),
                        torch.zeros(csc.packet_size(ncv), dtype=torch.float64,
                                    device=dev)]

                def kernel(**clocks):
                    bufs[0].copy_(a0)
                    bufs[1].copy_(b0)
                    csc.sym_cycle(*bufs, p, False, **clocks)

                kernel()
                key = f"{dname}_{ncv}_{which}_{seed}"
                for name, i in (("a", 0), ("b", 1), ("Q", 6), ("sk", 7),
                                ("packet", 8)):
                    outs[f"{key}_{name}"] = bufs[i].cpu().numpy()
                if which == "LA" and seed == 0:
                    ms = timing.alternating_ms([kernel], flush)[0]
                    split = None
                    if hasattr(csc, "clock_size"):  # the kernel's phase stamps
                        clk = torch.zeros(csc.clock_size(ncv),
                                          dtype=torch.int64, device=dev)
                        kernel(clocks=clk)
                        c = clk[:len(csc.CLOCKS)].cpu().numpy()
                        split = dict(zip(("ql", "head", "sweep", "tail"),
                                         np.diff(c).tolist()))
                    rows.append({"dtype": dname, "ncv": ncv, "nev": _nev(ncv),
                                 "clocks": split,
                                 "shifts": int(bufs[8][csc.P_NP]),
                                 "done": bool(bufs[8][csc.P_DONE]),
                                 "placement": _placement(csc, ncv,
                                                         dt.itemsize),
                                 "ms": ms})
    np.savez(out, **outs)
    print(json.dumps({"rows": rows}), flush=True)
    return 0


def _run(root: Path, inputs: Path, out: Path, build_only=False) -> dict:
    cmd = [sys.executable, str(Path(__file__).resolve()), "--worker",
           str(root), "--inputs", str(inputs), "--save", str(out)]
    if build_only:
        cmd.append("--build-only")
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)


def _last_json(proc) -> dict:
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"worker failed ({proc.returncode}):\n{text}")
    return json.loads(text.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", type=Path)
    ap.add_argument("--equal-through", type=int, default=None,
                    help="exit non-zero only if outputs differ at an ncv up "
                         "to this one (default: at any)")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--inputs", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--save", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        return _worker(args.worker.resolve(), args.inputs, args.save,
                       args.build_only)
    import torch

    if not torch.cuda.is_available() or args.base is None:
        print("sym_cycle_compare: needs a CUDA device and --base",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke

    gpu = chip_smoke._gpu_line()
    print(gpu, flush=True)
    tmp = tempfile.TemporaryDirectory()
    out = Path(tmp.name)
    inputs = out / "inputs.npz"
    _inputs(inputs)
    roots = {"base": args.base.resolve(), "this": REPO}
    builds = {k: _run(r, inputs, out / f"build_{k}.npz", True)
              for k, r in roots.items()}
    for k, proc in builds.items():
        print(f"build {k}: {_last_json(proc)['build_s']:.1f} s", flush=True)
    runs = []
    for i, k in enumerate(("base", "this", "this", "base")):
        path = out / f"run{i}_{k}.npz"
        rows = _last_json(_run(roots[k], inputs, path))["rows"]
        runs.append((k, path, rows))
    print(f"sym_cycle device-only ms ('LA', seed 0; runs base, this, this, "
          f"base; [s] workspace in shared memory, [g] in global, [k/m] k of "
          f"its m parts in shared memory); card {gpu}", flush=True)
    table = []
    for j, (dname, ncv) in enumerate(SIZES):
        r = [rows[j] for _, _, rows in runs]
        cells = ", ".join(f"{k} {x['ms']:.4f} [{x['placement']}]"
                          for (k, _, _), x in zip(runs, r))
        split = r[1]["clocks"]
        print(f"  {dname} ncv={ncv} nev={r[0]['nev']} ({r[0]['shifts']} "
              f"shifts{', converged: no sweep' if r[0]['done'] else ''}): "
              f"{cells}" + ("" if split is None else
                            "; this tree's phase clocks (SM cycles, one "
                            "launch): " + ", ".join(f"{k} {v}" for k, v in
                                                    split.items())),
              flush=True)
        table.append({"dtype": dname, "ncv": ncv, "nev": r[0]["nev"],
                      "shifts": r[0]["shifts"], "clocks": split,
                      "runs": [{"tree": k, "ms": x["ms"],
                                "placement": x["placement"]}
                               for (k, _, _), x in zip(runs, r)]})
    a, b = np.load(runs[0][1]), np.load(runs[1][1])
    differ = sorted({k.rsplit("_", 1)[0] for k in a.files
                     if a[k].tobytes() != b[k].tobytes()})
    sizes = {}
    for case in sorted({k.rsplit("_", 1)[0] for k in a.files}):
        dname, ncv = case.split("_")[:2]
        sizes.setdefault((dname, int(ncv)), []).append(case not in differ)
    print("outputs (a, b, Q, sk, packet over 5 which x 2 seeds) equal bit "
          "for bit at: " + ", ".join(f"{d} {n}" for (d, n), eq in
                                     sorted(sizes.items()) if all(eq))
          + "; differ at: " + (", ".join(f"{d} {n} ({eq.count(False)} of "
                                         f"{len(eq)} cases)"
                                         for (d, n), eq in
                                         sorted(sizes.items())
                                         if not all(eq)) or "none"),
          flush=True)
    print(json.dumps({"card": gpu, "times": table,
                      "cases": len(a.files) // 5, "differ": differ}),
          flush=True)
    limit = args.equal_through
    return 1 if any(not all(eq) and (limit is None or n <= limit)
                    for (_, n), eq in sizes.items()) else 0


if __name__ == "__main__":
    sys.exit(main())

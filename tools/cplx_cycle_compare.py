#!/usr/bin/env python3
"""The complex reduced-space kernel of two checkouts side by side, on a card.

    python3 tools/cplx_cycle_compare.py --base DIR

``DIR`` holds another checkout of the repository (``git archive`` of the
commit to compare with, unpacked where ``.gitignore`` lists it, such as
``_final/base``). Each checkout builds its own kernels
(``arpack_ng_tpu_torch.ops.cuda_lib``, both builds at once) and runs its
``csrc/cplx_cycle.cu`` through its wrapper, ``cuda_cplx_cycle.cplx_cycle``,
in a process of its own, in the order base, this, this, base, on the same
inputs:

* complex Arnoldi Hessenbergs of the four sources of
  ``chip_smoke._cx_hessenberg`` (complex, convdiff, realified, normal),
  complex64 and complex128, every ``which``, two seeds, at each ncv of
  :func:`sizes` (nev = max(1, ncv // 4)): 3, 8, 32, 48, the last ncv whose
  workspace fits in shared memory and the first past it (this checkout's
  ``max_shared_ncv``), and 100;
* each early exit: an extension that stopped short (``brk`` = 3), a
  converged cycle (rnorm 1e-30: done), a last cycle (``is_last``), and a
  Schur loop cut by its sweep count (``SWEEPS_PER_EV`` = 1);
* complex128 inputs scaled by 2^-490 (each square root's operand below the
  range of the kernel's fast path, so that its steps run again with the
  library's square root), and ncv 130 (past the 128 columns the reflector
  chain keeps in registers).

Prints each checkout's device-only median ('LM', complex64, the convdiff
source, seed 0; each call after a copy restoring H, as phase 11 times it)
in each of the four runs at the ncv of :func:`timed` (32, the shared
boundary's two sides, 100), with each checkout's stamps (``chip_smoke._rn_clocks`` of its
own tree), whether every output (H, Q, sk, the packet) of this checkout
equals the base's bit for bit, case by case, and whether each checkout's
two runs equal each other. The last line is a JSON object with all of it.
Exits non-zero if any output differs.
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
DTYPES = ("complex64", "complex128")
WHICH = ("LM", "SM", "LR", "SR", "LI", "SI")
SOURCES = ("complex", "convdiff", "realified", "normal")
SEEDS = (0, 1)
#: ncv of the exit cases
EXIT_NCVS = (32, 100)
#: the scale of the tiny inputs (complex128), and the ncv past the chain's
#: registers
TINY = 2.0 ** -490
WIDE = 130


def _boundary() -> int:
    """This checkout's last ncv whose workspace fits in shared memory."""
    sys.path.insert(0, str(REPO))
    from arpack_ng_tpu_torch.ops import cuda_cplx_cycle as ccc

    return ccc.max_shared_ncv()


def sizes() -> tuple:
    """The ncv of the cases: 3, 8, 32, 48, this checkout's last shared ncv
    and first global one (from its ``work_bytes``), 100."""
    m = _boundary()
    return tuple(sorted({3, 8, 32, 48, m, m + 1, 100}))


def timed() -> tuple:
    """The ncv timed ('LM', complex64, convdiff, seed 0): 32, the shared
    boundary's two sides, 100."""
    m = _boundary()
    return tuple(sorted({32, m, m + 1, 100}))


def _nev(ncv: int) -> int:
    return max(1, ncv // 4)


def _cases(ncvs):
    """(key, input, dtype, which, nev, options) of every case at the ncv of
    ``ncvs``."""
    out = []
    for dname in DTYPES:
        for ncv in ncvs:
            for source in SOURCES:
                for which in WHICH:
                    for seed in SEEDS:
                        out.append((f"{dname}_{ncv}_{source}_{which}_{seed}",
                                    f"{source}{ncv}_{seed}", dname, which,
                                    _nev(ncv), {}))
        for ncv in EXIT_NCVS:
            for exit_, opt in (("brk", {"brk": 3}), ("done", {"rnorm": 1e-30}),
                               ("last", {"is_last": True}),
                               ("sweeps", {"sweeps_per_ev": 1})):
                out.append((f"{dname}_{ncv}_convdiff_LM_{exit_}",
                            f"convdiff{ncv}_0", dname, "LM", _nev(ncv), opt))
        for source, which in (("convdiff", "LM"), ("normal", "SR")):
            out.append((f"{dname}_{WIDE}_{source}_{which}_wide",
                        f"{source}{WIDE}_0", dname, which, _nev(WIDE), {}))
    for ncv in (32, ncvs[-2]):
        for source in SOURCES:
            out.append((f"complex128_{ncv}_{source}_LM_tiny", f"{source}{ncv}_0",
                        "complex128", "LM", _nev(ncv), {"scale": TINY}))
    return out


def _inputs(path: Path) -> None:
    sys.path.insert(0, str(REPO))
    import chip_smoke

    arrs = {"sizes": np.array(sizes()), "timed": np.array(timed())}
    for ncv in sizes() + (WIDE,):
        for source in SOURCES:
            for seed in SEEDS[:1] if ncv == WIDE else SEEDS:
                H, rn = chip_smoke._cx_hessenberg(ncv, seed, source)
                arrs[f"{source}{ncv}_{seed}"] = H
                arrs[f"{source}{ncv}_{seed}_rn"] = rn
    np.savez(path, **arrs)


def _params(ccc, dname, which, nev):
    f = np.finfo(np.float32 if dname == "complex64" else np.float64)
    R = f.dtype.type
    return ccc.Params(which=which, nev=nev,
                      tol=float(R(1e-5 if dname == "complex64" else 1e-10)),
                      eps23=float(R(f.eps ** (2 / 3))), eps_m=float(f.eps))


def _worker(root: Path, inputs: Path, out: Path, build_only: bool) -> int:
    sys.path.insert(0, str(root))
    import torch

    from arpack_ng_tpu_torch.bench import timing
    from arpack_ng_tpu_torch.ops import cuda_cplx_cycle as ccc
    from arpack_ng_tpu_torch.ops import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.load()
    if build_only:
        print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
        return 0
    import chip_smoke  # this checkout's, from root

    dev = torch.device("cuda", 0)
    src = np.load(inputs)
    flush = timing.flush_buffer(dev)
    per_ev = ccc.SWEEPS_PER_EV
    want = set(src["timed"].tolist())
    outs, rows = {}, []
    for key, name, dname, which, nev, opt in _cases(src["sizes"].tolist()):
        dt = getattr(torch, dname)
        rdt = torch.float32 if dname == "complex64" else torch.float64
        H = (src[name] * opt.get("scale", 1.0)).astype(dname).astype(np.complex128)
        ncv = H.shape[0]
        t = dict(dtype=dt, device=dev)
        H0 = torch.tensor(H, **t)
        bufs = [H0.clone(),
                torch.tensor(opt.get("rnorm", src[name + "_rn"]
                                     * opt.get("scale", 1.0)), dtype=rdt,
                             device=dev),
                torch.tensor(opt.get("brk", -1), dtype=torch.int32, device=dev),
                torch.tensor(0, dtype=torch.int32, device=dev),
                torch.tensor([3, 1, 2, 0], dtype=torch.int64, device=dev),
                torch.zeros(ncv, ncv, **t), torch.zeros(2, **t),
                torch.zeros(ccc.packet_size(ncv), dtype=torch.float64,
                            device=dev)]
        p = _params(ccc, dname, which, nev)
        last = opt.get("is_last", False)

        def kernel(**clocks):
            bufs[0].copy_(H0)
            ccc.cplx_cycle(*bufs, p, last, **clocks)

        ccc.SWEEPS_PER_EV = opt.get("sweeps_per_ev", per_ev)
        try:
            kernel()
            for nm, i in (("H", 0), ("Q", 5), ("sk", 6), ("packet", 7)):
                outs[f"{key}_{nm}"] = torch.view_as_real(bufs[i]).cpu().numpy() \
                    if bufs[i].is_complex() else bufs[i].cpu().numpy()
            if (dname == "complex64" and which == "LM" and not opt
                    and key.endswith("convdiff_LM_0") and ncv in want):
                ms = timing.alternating_ms([kernel], flush)[0]
                clk = torch.zeros(ccc.clock_size(ncv), dtype=torch.int64,
                                  device=dev)
                kernel(clocks=clk)
                rows.append({"ncv": ncv, "nev": nev, "ms": ms,
                             "shared": bool(ccc.fits_shared(ncv)),
                             "clocks": chip_smoke._rn_clocks(
                                 ccc, clk.cpu().numpy()),
                             "shifts": int(bufs[7][ccc.P_NP])})
        finally:
            ccc.SWEEPS_PER_EV = per_ev
    torch.cuda.synchronize()
    np.savez(out, **outs)
    print(json.dumps({"rows": rows}), flush=True)
    return 0


def _run(root: Path, inputs: Path, out: Path, build_only=False):
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


def _differ(a, b) -> list:
    """The cases (key prefixes) where any output of two runs differs."""
    return sorted({k.rsplit("_", 1)[0] for k in a.files
                   if a[k].tobytes() != b[k].tobytes()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", type=Path)
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
        print("cplx_cycle_compare: needs a CUDA device and --base",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import chip_smoke

    gpu = chip_smoke._gpu_line()
    print(gpu, flush=True)
    tmp = tempfile.TemporaryDirectory()
    out = Path(tmp.name)
    inputs = out / "inputs.npz"
    roots = {"base": args.base.resolve(), "this": REPO}
    builds = {k: _run(r, inputs, out / f"build_{k}.npz", True)
              for k, r in roots.items()}
    _inputs(inputs)
    for k, proc in builds.items():
        print(f"build {k}: {_last_json(proc)['build_s']:.1f} s", flush=True)
    runs = []
    for i, k in enumerate(("base", "this", "this", "base")):
        path = out / f"run{i}_{k}.npz"
        rows = _last_json(_run(roots[k], inputs, path))["rows"]
        runs.append((k, path, rows))
    print(f"cplx_cycle device-only ms ('LM', complex64, convdiff, seed 0; "
          f"runs base, this, this, base); card {gpu}", flush=True)
    table = []
    for j, ncv in enumerate(timed()):
        r = [rows[j] for _, _, rows in runs]
        cells = ", ".join(f"{k} {x['ms']:.4f}" for (k, _, _), x in zip(runs, r))
        print(f"  ncv={ncv} nev={r[0]['nev']} ({r[0]['shifts']} shifts; this "
              f"tree's workspace {'shared' if r[1]['shared'] else 'global'}, "
              f"the base's {'shared' if r[0]['shared'] else 'global'}): "
              f"{cells}", flush=True)
        for (k, _, _), x in list(zip(runs, r))[:2]:
            print(f"    {k} tree's clocks (SM cycles, one launch): "
                  + ", ".join(f"{a} {b}" for a, b in x["clocks"].items()),
                  flush=True)
        table.append({"ncv": ncv, "nev": r[0]["nev"], "shifts": r[0]["shifts"],
                      "runs": [{"tree": k, "ms": x["ms"], "shared": x["shared"],
                                "clocks": x["clocks"]}
                               for (k, _, _), x in zip(runs, r)]})
    cases = _cases(sizes())
    a, b, c, d = (np.load(path) for _, path, _ in runs)
    differ = _differ(a, b)
    repeats = {"this": _differ(b, c), "base": _differ(a, d)}
    groups = {}
    for key, *_ in cases:
        dname, ncv, source, _, kind = key.split("_")
        tag = f"{source} {kind if not kind.isdigit() else 'arnoldi'}"
        groups.setdefault((dname, int(ncv), tag), []).append(key not in differ)
    print(f"outputs (H, Q, sk, packet) over {len(cases)} cases equal bit "
          "for bit at: " + ", ".join(f"{d} {n} {t} ({len(eq)})" for (d, n, t), eq
                                     in sorted(groups.items()) if all(eq))
          + "; differ at: " + (", ".join(f"{d} {n} {t} ({eq.count(False)} of "
                                         f"{len(eq)} cases)"
                                         for (d, n, t), eq in
                                         sorted(groups.items())
                                         if not all(eq)) or "none"),
          flush=True)
    print(f"each tree's two runs differ at: {repeats}", flush=True)
    print(json.dumps({"card": gpu, "sizes": list(sizes()), "times": table,
                      "cases": len(cases), "differ": differ,
                      "repeats_differ": repeats}), flush=True)
    return 1 if differ or any(repeats.values()) else 0


if __name__ == "__main__":
    sys.exit(main())

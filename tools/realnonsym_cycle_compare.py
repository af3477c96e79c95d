#!/usr/bin/env python3
"""The real reduced-space kernel of two checkouts side by side, on a card.

    python3 tools/realnonsym_cycle_compare.py --base DIR

``DIR`` holds another checkout of the repository (``git archive`` of the
commit to compare with, unpacked where ``.gitignore`` lists it, such as
``_final/base``). Each checkout builds its own kernels
(``arpack_ng_tpu_torch.ops.cuda_lib``, both builds at once) and runs its
``csrc/realnonsym_cycle.cu`` through its wrapper,
``cuda_realnonsym_cycle.realnonsym_cycle``, in a process of its own, in the
order base, this, this, base, on the same inputs:

* Arnoldi Hessenbergs of phase 9's convection-diffusion matrix
  (``chip_smoke._arnoldi_hessenberg``), float32 and float64, every
  ``which``, two seeds, at each ncv of ``SIZES`` (nev = 8 at ncv = 32, else
  max(1, ncv // 4)): 68 is the last ncv whose workspace fits in shared
  memory, 69 the first past it;
* the implicit redo: the Hessenberg whose explicit chase loses the
  Hessenberg form in the twin (conv-diff nx = 10, 'LR', ncv = 24, the
  case of ``tests/test_torch_realnonsym_device.py``), and inputs whose
  guard threshold is set to 1e-300 (the redo then always runs);
* each early exit: an extension that stopped short (``brk`` = 3), a
  converged cycle (rnorm 1e-30: done), a last cycle (``is_last``), and a
  Schur loop cut by its sweep count (``SWEEPS_PER_EV`` = 1).

Prints each checkout's device-only median ('LM', float32, seed 0, each
call after a copy restoring H, as phase 9 times it) in each of the four
runs, with the phase clocks of each checkout whose wrapper takes a stamp
buffer, and whether every output (H, Q, sk, the packet) of this checkout
equals the base's bit for bit, case by case (and each checkout's two runs
each other's), and the cases in which the base's kernel took the implicit
redo. The last line is a JSON object with all of it. Exits
non-zero if any output differs.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
SIZES = (3, 8, 32, 48, 68, 69, 100)
DTYPES = ("float32", "float64")
WHICH = ("LM", "SM", "LR", "SR", "LI", "SI")
SEEDS = (0, 1)
#: the timed inputs ('LM', seed 0, float32)
TIMED = (32, 69, 100)


def _nev(ncv: int) -> int:
    return 8 if ncv == 32 else max(1, ncv // 4)


def _guard_input():
    """(H, rnorm) of the first cycle whose explicit chase loses the
    Hessenberg form in the twin, on conv-diff nx = 10, 'LR', ncv = 24, tol
    1e-10 (the port on the CPU)."""
    from unittest import mock

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core import device_realnonsym as drn
    from arpack_ng_tpu_torch.models import convection_diffusion_2d
    from arpack_ng_tpu_torch.ops import cuda_realnonsym_cycle as crc

    seen, real = [], drn.realnonsym_cycle

    def spy(H, rnorm, brk, force, cnt, Q, sk, packet, p, is_last):
        H0 = H.numpy().copy()
        real(H, rnorm, brk, force, cnt, Q, sk, packet, p, is_last)
        if packet[crc.P_IMPL] and not seen:
            seen.append((H0, float(rnorm)))

    op, _ = convection_diffusion_2d(10, dtype=np.float64, device="cpu")
    with mock.patch.object(drn, "realnonsym_cycle", spy):
        pt.eigs(op, k=6, which="LR", ncv=24, tol=1e-10, maxiter=500,
                v0=np.random.default_rng(0).uniform(-1, 1, 100))
    return seen[0]


def _cases():
    """(key, input, dtype, which, nev, options) of every case."""
    out = []
    for dname in DTYPES:
        for ncv in SIZES:
            for which in WHICH:
                for seed in SEEDS:
                    out.append((f"{dname}_{ncv}_{which}_{seed}", f"a{ncv}_{seed}",
                                dname, which, _nev(ncv), {}))
        for ncv in (8, 32, 69):
            for which in ("LM", "SR"):
                out.append((f"{dname}_{ncv}_{which}_forced-redo", f"a{ncv}_0",
                            dname, which, _nev(ncv), {"eps23": 1e-300}))
        for ncv in (32, 69):
            for exit_, opt in (("brk", {"brk": 3}), ("done", {"rnorm": 1e-30}),
                               ("last", {"is_last": True}),
                               ("sweeps", {"sweeps_per_ev": 1})):
                out.append((f"{dname}_{ncv}_LM_{exit_}", f"a{ncv}_0", dname,
                            "LM", _nev(ncv), opt))
    out.append(("float64_24_LR_guard", "guard", "float64", "LR", 6, {}))
    return out


def _inputs(path: Path) -> None:
    sys.path.insert(0, str(REPO))
    import chip_smoke

    arrs = {}
    for ncv in SIZES:
        for seed in SEEDS:
            H, rn = chip_smoke._arnoldi_hessenberg(ncv, seed)
            arrs[f"a{ncv}_{seed}"], arrs[f"a{ncv}_{seed}_rn"] = H, rn
    H, rn = _guard_input()
    arrs["guard"], arrs["guard_rn"] = H, rn
    np.savez(path, **arrs)


def _params(crc, dname, which, nev, opt):
    f = np.finfo(dname)
    R = f.dtype.type
    return crc.Params(which=which, nev=nev,
                      tol=float(R(1e-5 if dname == "float32" else 1e-10)),
                      eps23=opt.get("eps23", float(R(f.eps ** (2 / 3)))),
                      eps_m=float(f.eps), safmin=float(f.tiny))


def _worker(root: Path, inputs: Path, out: Path, build_only: bool) -> int:
    sys.path.insert(0, str(root))
    import torch

    from arpack_ng_tpu_torch.bench import timing
    from arpack_ng_tpu_torch.ops import cuda_lib
    from arpack_ng_tpu_torch.ops import cuda_realnonsym_cycle as crc

    t0 = time.perf_counter()
    cuda_lib.load()
    if build_only:
        print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)
        return 0
    dev = torch.device("cuda", 0)
    src = np.load(inputs)
    flush = timing.flush_buffer(dev)
    stamps = "clocks" in inspect.signature(crc.realnonsym_cycle).parameters
    per_ev = crc.SWEEPS_PER_EV
    outs, rows = {}, []
    for key, name, dname, which, nev, opt in _cases():
        dt = getattr(torch, dname)
        H = src[name].astype(dname).astype(np.float64)
        ncv = H.shape[0]
        t = dict(dtype=dt, device=dev)
        H0 = torch.tensor(H, **t)
        bufs = [H0.clone(), torch.tensor(opt.get("rnorm", src[name + "_rn"]), **t),
                torch.tensor(opt.get("brk", -1), dtype=torch.int32, device=dev),
                torch.tensor(0, dtype=torch.int32, device=dev),
                torch.tensor([3, 1, 2, 0], dtype=torch.int64, device=dev),
                torch.zeros(ncv, ncv, **t), torch.zeros(2, **t),
                torch.zeros(crc.packet_size(ncv), dtype=torch.float64,
                            device=dev)]
        p = _params(crc, dname, which, nev, opt)
        last = opt.get("is_last", False)

        def kernel(**clocks):
            bufs[0].copy_(H0)
            crc.realnonsym_cycle(*bufs, p, last, **clocks)

        crc.SWEEPS_PER_EV = opt.get("sweeps_per_ev", per_ev)
        try:
            kernel()
            for nm, i in (("H", 0), ("Q", 5), ("sk", 6), ("packet", 7)):
                outs[f"{key}_{nm}"] = bufs[i].cpu().numpy()
            if dname == "float32" and which == "LM" and key.endswith("_0") \
                    and ncv in TIMED:
                ms = timing.alternating_ms([kernel], flush)[0]
                split = None
                if stamps:
                    import chip_smoke  # this checkout's, from root

                    clk = torch.zeros(crc.clock_size(ncv), dtype=torch.int64,
                                      device=dev)
                    kernel(clocks=clk)
                    split = chip_smoke._rn_clocks(crc, clk.cpu().numpy())
                rows.append({"ncv": ncv, "nev": nev, "ms": ms, "clocks": split,
                             "shifts": int(bufs[7][crc.P_NP]),
                             "implicit": int(bufs[7][crc.P_IMPL])})
        finally:
            crc.SWEEPS_PER_EV = per_ev
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
        print("realnonsym_cycle_compare: needs a CUDA device and --base",
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
    print(f"realnonsym_cycle device-only ms ('LM', float32, seed 0; runs "
          f"base, this, this, base); card {gpu}", flush=True)
    table = []
    for j, ncv in enumerate(TIMED):
        r = [rows[j] for _, _, rows in runs]
        cells = ", ".join(f"{k} {x['ms']:.4f}" for (k, _, _), x in zip(runs, r))
        print(f"  ncv={ncv} nev={r[0]['nev']} ({r[0]['shifts']} shifts, "
              f"implicit redo {r[0]['implicit']}): {cells}", flush=True)
        for (k, _, _), x in list(zip(runs, r))[:2]:
            if x["clocks"] is not None:
                print(f"    {k} tree's clocks (SM cycles, one launch): "
                      + ", ".join(f"{a} {b}" for a, b in x["clocks"].items()),
                      flush=True)
        table.append({"ncv": ncv, "nev": r[0]["nev"], "shifts": r[0]["shifts"],
                      "runs": [{"tree": k, "ms": x["ms"], "clocks": x["clocks"]}
                               for (k, _, _), x in zip(runs, r)]})
    a, b, c, d = (np.load(path) for _, path, _ in runs)
    differ = _differ(a, b)
    repeats = {"this": _differ(b, c), "base": _differ(a, d)}
    groups = {}
    for key, *_ in _cases():
        dname, ncv, _, kind = key.split("_")
        tag = kind if not kind.isdigit() else "arnoldi"
        groups.setdefault((dname, int(ncv), tag), []).append(key not in differ)
    print(f"outputs (H, Q, sk, packet) over {len(_cases())} cases equal bit "
          "for bit at: " + ", ".join(f"{d} {n} {t} ({len(eq)})" for (d, n, t), eq
                                     in sorted(groups.items()) if all(eq))
          + "; differ at: " + (", ".join(f"{d} {n} {t} ({eq.count(False)} of "
                                         f"{len(eq)} cases)"
                                         for (d, n, t), eq in
                                         sorted(groups.items())
                                         if not all(eq)) or "none"),
          flush=True)
    print(f"each tree's two runs differ at: {repeats}", flush=True)
    from arpack_ng_tpu_torch.ops.cuda_realnonsym_cycle import P_IMPL
    redo = [key for key, *_ in _cases() if a[f"{key}_packet"][P_IMPL] != 0]
    print(f"the base's kernel took the implicit redo in {len(redo)} cases: "
          + ", ".join(redo), flush=True)
    print(json.dumps({"card": gpu, "times": table, "cases": len(_cases()),
                      "differ": differ, "repeats_differ": repeats,
                      "redo": redo}), flush=True)
    return 1 if differ or any(repeats.values()) else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of arpack_ng_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order; a failing phase raises and the script exits non-zero:

1. device: require CUDA; print the card's name and its ``nvidia-smi``
   name and power limit;
2. build: compile (or load) the CUDA kernels of ``arpack_ng_tpu_torch/csrc``
   with nvcc for sm_90a and print the build time;
3. kernels: every kernel of the main path against its plain PyTorch twin
   on the card, at the flagship shapes (ncv = 32, n = 1,048,576), in
   float32 and bfloat16 storage (plus float64), with median CUDA-event
   times of kernel and twin;
4. flagship solve through ``eigsh``: the 2-D Dirichlet Laplacian at
   nx = 1024 (n = 1,048,576), float32, k = 8, ncv = 32, which = 'LA',
   tol = 1e-5, first with the default selective reorthogonalization (the
   main path, whose kernel launches are counted) and then with
   ``reorth='dgks'``.  Each returned value must lie within 1e-4*|lambda|
   of an analytic eigenvalue and each residual ||Av - lambda v|| / |lambda|
   (scipy CSR, float64, on the host) must be <= 1e-3;
5. basis defect: 30 selective cycles at the floor tolerance must keep
   ``||V V^T - I||_max`` below ``64 sqrt(eps_f32)``.

    python3 chip_smoke.py --profile

runs phases 1-2 and then, in place of phases 3-5, the restart-cycle
profile of the flagship behind ``PERF.md`` section 5: for each reorth
variant the wall per Lanczos step over steady cycles, the card's busy
share and largest device items under ``torch.profiler``, and the host's
``cProfile``.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  The script needs no
network and exits non-zero without a CUDA device or outside the
repository.
"""
from __future__ import annotations

import argparse
import cProfile
import io
import json
import pstats
import statistics
import subprocess
import sys
import time

import numpy as np

NCV = 32
NX = 1024
N = NX * NX
KS = (8, 16, 24, 32)
ROWS = (8, 16, 24, 32)
REPS = 20
#: representative shapes for the JSON line: most events stream one 8-row
#: bucket; the restart keeps kev ~ 9-12 rows, i.e. the 16-row bucket
JSON_K, JSON_ROWS = 8, 16


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _median_ms(torch, fn, flush) -> float:
    """Median CUDA-event time of ``fn`` over REPS launches, each after an
    L2 flush (the solver finds the basis cold)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1))
    return statistics.median(times)


def _compare(torch, out, ref, bf16: bool, what: str) -> float:
    scale = float(ref.abs().max())
    if bf16:
        rtol, atol = 1e-2, 1e-2 * scale
    else:
        rtol, atol = 1e-5, 1e-4 * scale
    err = float((out.double() - ref.double()).abs().max())
    if not torch.allclose(out.double(), ref.double(), rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: kernel disagrees with its twin "
                             f"(max abs err {err:.3e}, scale {scale:.3e})")
    return err


def check_kernels(torch, dev, n=N, timed=True):
    from arpack_ng_tpu_torch.ops import cuda_rot, cuda_sel

    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 * 2**20 // 4, dtype=torch.float32, device=dev) \
        if timed else None
    rec = {k: {"err": 0.0, "err_bf16": 0.0, "err_f64": 0.0}
           for k in ("sel_proj", "sel_update", "rotate_rows")}
    rows_out = []
    pairs = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
             (torch.float64, torch.float64))
    for sdt, adt in pairs:
        bf16 = sdt == torch.bfloat16
        tag = {torch.float32: "err", torch.bfloat16: "err_bf16",
               torch.float64: "err_f64"}[sdt]
        V = torch.randn(NCV, n, generator=g, device=dev, dtype=adt).to(sdt)
        br = torch.randn(n, generator=g, device=dev, dtype=adt)
        r0 = torch.randn(n, generator=g, device=dev, dtype=adt)
        for K in KS:
            idx = torch.randperm(NCV, generator=g, device=dev)[:K].to(
                torch.int32)
            s = cuda_sel.sel_proj(idx, V, br)
            s_ref = cuda_sel.sel_proj_plain(idx, V, br)
            rec["sel_proj"][tag] = max(rec["sel_proj"][tag], _compare(
                torch, s, s_ref, bf16, f"sel_proj K={K} {sdt}"))
            coef = torch.randn(K, generator=g, device=dev, dtype=adt)
            coef[K // 2] = 0  # a masked row
            for with_norm in (False, True):
                out = cuda_sel.sel_update(idx, coef, r0.clone(), V,
                                          with_norm=with_norm)
                ref = cuda_sel.sel_update_plain(idx, coef, r0.clone(), V,
                                                with_norm=with_norm)
                if with_norm:
                    _compare(torch, out[1], ref[1], bf16,
                             f"sel_update norm K={K} {sdt}")
                    out, ref = out[0], ref[0]
                rec["sel_update"][tag] = max(rec["sel_update"][tag], _compare(
                    torch, out, ref, bf16, f"sel_update K={K} {sdt}"))
            untouched = cuda_sel.sel_update(idx, torch.zeros_like(coef),
                                            r0.clone(), V)
            if not torch.equal(untouched, r0):
                raise AssertionError("sel_update: zero coefficients changed r")
            if timed and sdt != torch.float64:
                t_k = _median_ms(torch, lambda: cuda_sel.sel_proj(idx, V, br),
                                 flush)
                t_p = _median_ms(
                    torch, lambda: cuda_sel.sel_proj_plain(idx, V, br), flush)
                u_k = _median_ms(torch, lambda: cuda_sel.sel_update(
                    idx, coef, r0, V, with_norm=True), flush)
                u_p = _median_ms(torch, lambda: cuda_sel.sel_update_plain(
                    idx, coef, r0, V, with_norm=True), flush)
                rows_out.append(("sel_proj", str(sdt), K, t_k, t_p))
                rows_out.append(("sel_update", str(sdt), K, u_k, u_p))
        Qm, _ = torch.linalg.qr(torch.randn(
            NCV, NCV, generator=torch.Generator().manual_seed(1),
            dtype=torch.float64))
        Q = Qm.to(device=dev, dtype=adt).contiguous()
        for rows in ROWS:
            V1 = V.clone()
            cuda_rot.rotate_rows(Q, V1, rows)
            V2 = cuda_rot.rotate_rows_plain(Q, V.clone(), rows)
            rec["rotate_rows"][tag] = max(rec["rotate_rows"][tag], _compare(
                torch, V1[:rows], V2[:rows], bf16,
                f"rotate_rows rows={rows} {sdt}"))
            if not torch.equal(V1[rows:], V[rows:]):
                raise AssertionError(f"rotate_rows rows={rows}: rows past "
                                     "the bucket changed")
            if timed and sdt != torch.float64:
                t_k = _median_ms(
                    torch, lambda: cuda_rot.rotate_rows(Q, V1, rows), flush)
                t_p = _median_ms(
                    torch, lambda: cuda_rot.rotate_rows_plain(Q, V2, rows),
                    flush)
                rows_out.append(("rotate_rows", str(sdt), rows, t_k, t_p))
        del V, V1, V2
    return rec, rows_out


def _analytic_spectrum(nx: int) -> np.ndarray:
    h = 1.0 / (nx + 1)
    g = 2.0 - 2.0 * np.cos(np.pi * h * np.arange(1, nx + 1))
    return np.sort((g[:, None] + g[None, :]).ravel())


def check_values(vals, vecs, a_sp, spectrum, what):
    if len(vals) != 8:
        raise AssertionError(f"{what}: {len(vals)} values returned, want 8")
    pos = np.clip(np.searchsorted(spectrum, vals), 1, len(spectrum) - 1)
    dist = np.minimum(np.abs(spectrum[pos] - vals),
                      np.abs(spectrum[pos - 1] - vals))
    if np.any(dist > 1e-4 * np.abs(vals)):
        raise AssertionError(f"{what}: values off the analytic spectrum "
                             f"(max dist {dist.max():.3e})")
    v64 = np.asarray(vecs, np.float64)
    res = np.linalg.norm(a_sp @ v64 - v64 * vals[None, :], axis=0) \
        / np.abs(vals)
    if not np.all(np.isfinite(res)) or res.max() > 1e-3:
        raise AssertionError(f"{what}: residual {res.max():.3e} > 1e-3")
    return float(dist.max()), float(res.max())


def flagship(torch, dev, gpu, nx=NX):
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.models import laplacian_2d
    from arpack_ng_tpu_torch.ops import cuda_rot, cuda_sel

    kernels = (cuda_sel.sel_proj, cuda_sel.sel_update, cuda_rot.rotate_rows)
    small, _ = laplacian_2d(64, np.float32, device=dev)  # warm-up
    pt.eigsh(small, k=8, ncv=NCV, which="LA", tol=1e-5)
    op, a_sp = laplacian_2d(nx, np.float32, device=dev)
    spectrum = _analytic_spectrum(nx)
    launches = {}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for reorth in ("selective", "dgks"):
        for fn in kernels:
            fn.launches = 0
        sync()
        t0 = time.perf_counter()
        vals, vecs, out = pt.eigsh(op, k=8, ncv=NCV, which="LA", tol=1e-5,
                                   reorth=reorth, return_stats=True)
        sync()
        wall = time.perf_counter() - t0
        counts = {fn.__name__: fn.launches for fn in kernels}
        if reorth == "selective":
            launches = counts
            idle = [k for k, c in counts.items() if c == 0]
        else:
            idle = [] if counts["rotate_rows"] else ["rotate_rows"]
        if idle:
            raise AssertionError(f"{reorth}: kernels never launched: {idle}")
        dmax, rmax = check_values(vals, vecs, a_sp, spectrum,
                                  f"flagship {reorth}")
        st = out.stats
        print(f"flagship reorth={reorth}: wall {wall:.4f} s "
              f"(solve {st.timers.taupd:.4f} s), cycles {st.n_iter}, "
              f"nopx {st.nopx}, nrorth {st.nrorth}, nrorthr {st.nrorthr}, "
              f"nitref {st.nitref}, nrotr {st.nrotr}, "
              f"{5 * nx * nx * st.nopx / wall / 1e9:.4f} Gnnz/s; "
              f"max value dist {dmax:.2e}, max residual {rmax:.2e}; "
              f"launches {counts}; card {gpu}", flush=True)
        print(f"  values {np.array2string(vals, precision=7)}", flush=True)
    return launches


def basis_defect(torch, dev, gpu, nx=NX):
    """Semi-orthogonality of the selective basis after 30 cycles at the
    floor tolerance, ||V V^T - I||_max < 64 sqrt(eps) (the bar of
    tests/test_reorth.py::test_basis_defect_bounded): checks the omega
    noise model against the card's reductions at full size."""
    from arpack_ng_tpu_torch.config import IRAMConfig
    from arpack_ng_tpu_torch.core.device_sym import FusedSymSolver
    from arpack_ng_tpu_torch.models import laplacian_2d

    op, _ = laplacian_2d(nx, np.float32, device=dev)
    cfg = IRAMConfig(n=op.n, nev=8, ncv=NCV, which="LA", symmetric=True,
                     dtype=np.dtype(np.float32), n_pad=op.n_pad, tol=1e-30,
                     max_iter=30, reorth="selective")
    res = FusedSymSolver(op, cfg).solve()
    V = res.state.V.double()
    eye = torch.eye(NCV, dtype=torch.float64, device=dev)
    defect = float((V @ V.T - eye).abs().max())
    bound = 64 * float(np.sqrt(np.finfo(np.float32).eps))
    print(f"basis defect after {res.n_iter} cycles (nopx {res.stats.nopx}, "
          f"nrorth {res.stats.nrorth}): {defect:.4e} (bound {bound:.4e}); "
          f"card {gpu}", flush=True)
    if not defect < bound:
        raise AssertionError(f"basis defect {defect:.3e} >= {bound:.3e}")


def _device_ms(evt) -> float:
    """Self device time of a profiler average, in ms (the attribute was
    renamed from ``self_cuda_time_total`` in newer torch)."""
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
        us = evt.self_cuda_time_total
    return us / 1e3


def profile_cycles(torch, dev, gpu, nx=NX, warm=3, steady=20, profiled=5):
    """Where the time goes: the flagship's restart cycles at the floor
    tolerance (no cycle exits) for each reorth variant.  Prints the wall per Lanczos
    step over ``steady`` cycles after ``warm`` cycles, then the profiled
    wall of ``profiled`` cycles with the card's busy share (the summed
    device time of every kernel and copy over that wall) and the largest
    device items, then ``cProfile`` of ``profiled`` more cycles."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from arpack_ng_tpu_torch.config import IRAMConfig
    from arpack_ng_tpu_torch.core.arnoldi import make_init
    from arpack_ng_tpu_torch.core.device_sym import (make_sym_head,
                                                     make_sym_tail)
    from arpack_ng_tpu_torch.models import laplacian_2d

    op, _ = laplacian_2d(nx, np.float32, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sort = ("self_device_time_total" if dev.type == "cuda"
            else "self_cpu_time_total")
    for reorth in ("selective", "dgks"):
        cfg = IRAMConfig(n=op.n, nev=8, ncv=NCV, which="LA", symmetric=True,
                         dtype=np.dtype(np.float32), n_pad=op.n_pad,
                         tol=1e-30, max_iter=10**6, reorth=reorth)
        head, tail = make_sym_head(op, cfg), make_sym_tail(op, cfg)
        state = make_init(op, cfg)()

        def cycles(state, m):
            for _ in range(m):
                h = head(state)
                if h.done:
                    raise AssertionError(f"profile {reorth}: a cycle "
                                         "converged")
                state = tail(h, False).state
            return state

        state = cycles(state, warm)
        sync()
        c0, t0 = state.counts, time.perf_counter()
        state = cycles(state, steady)
        sync()
        wall = time.perf_counter() - t0
        steps = state.counts.nopx - c0.nopx
        print(f"profile reorth={reorth}: {steady} cycles after {warm}, "
              f"{wall * 1e3:.4f} ms, {steps} steps, "
              f"{wall * 1e3 / steps:.4f} ms/step, events "
              f"{state.counts.nrorth - c0.nrorth}, event rows "
              f"{state.counts.nrorthr - c0.nrorthr}; card {gpu}", flush=True)

        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            state = cycles(state, profiled)
            sync()
            wall = time.perf_counter() - t0
        avgs = prof.key_averages()
        busy = sum(_device_ms(e) for e in avgs
                   if e.device_type == DeviceType.CUDA)
        print(f"profile reorth={reorth}: {profiled} profiled cycles, wall "
              f"{wall * 1e3:.4f} ms, device busy {busy:.4f} ms "
              f"({100 * busy / (wall * 1e3):.2f}% of the wall); card {gpu}",
              flush=True)
        print(avgs.table(sort_by=sort, row_limit=20,
                         max_name_column_width=60), flush=True)
        if dev.type == "cuda" and not busy > 0:
            raise AssertionError(f"profile {reorth}: no device time traced")

        prof_host = cProfile.Profile()
        prof_host.enable()
        state = cycles(state, profiled)
        sync()
        prof_host.disable()
        buf = io.StringIO()
        pstats.Stats(prof_host, stream=buf).sort_stats("tottime") \
            .print_stats(25)
        print(f"profile reorth={reorth}: cProfile of {profiled} cycles",
              flush=True)
        print(buf.getvalue(), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile the flagship's restart cycles in place "
                         "of the kernel, solve and basis-defect phases")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    gpu = _gpu_line()
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    print(gpu, flush=True)

    from arpack_ng_tpu_torch.ops import cuda_lib
    t0 = time.perf_counter()
    cuda_lib.load()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({cuda_lib.library_path().name})", flush=True)
    log = cuda_lib.library_path().with_suffix(".log")
    if log.exists():
        print(log.read_text().strip(), flush=True)
    if args.profile:
        profile_cycles(torch, dev, gpu)
        return 0

    rec, rows = check_kernels(torch, dev)
    print(f"kernels vs twins at ncv={NCV}, n={N} (median of {REPS}, "
          f"L2 flushed; card {gpu}):", flush=True)
    for kname, sdt, shape, t_k, t_p in rows:
        print(f"  {kname:12s} {sdt:15s} K/rows={shape:2d}: kernel "
              f"{t_k:.4f} ms, twin {t_p:.4f} ms", flush=True)
    print("  max abs err (f32, bf16, f64): "
          + ", ".join(f"{k} {v['err']:.3e} / {v['err_bf16']:.3e} / "
                      f"{v['err_f64']:.3e}" for k, v in rec.items()),
          flush=True)

    launches = flagship(torch, dev, gpu)
    basis_defect(torch, dev, gpu)

    def pick(kname, shape):
        return next(r for r in rows if r[0] == kname
                    and r[1] == "torch.float32" and r[2] == shape)

    src = {"sel_proj": ("arpack_ng_tpu_torch/csrc/sel.cu",
                        "arpack_ng_tpu/ops/pallas_sel.py:90", JSON_K),
           "sel_update": ("arpack_ng_tpu_torch/csrc/sel.cu",
                          "arpack_ng_tpu/ops/pallas_sel.py:141", JSON_K),
           "rotate_rows": ("arpack_ng_tpu_torch/csrc/rot.cu",
                           "arpack_ng_tpu/ops/pallas_rot.py:91", JSON_ROWS)}
    entries = []
    for kname, (source, replaces, shape) in src.items():
        _, _, _, t_k, t_p = pick(kname, shape)
        entries.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[kname],
                        "max_abs_err": rec[kname]["err"], "ms": t_k,
                        "plain_ms": t_p, "shape": f"ncv={NCV} n={N} "
                        f"{'K' if kname != 'rotate_rows' else 'rows'}="
                        f"{shape} float32"})
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

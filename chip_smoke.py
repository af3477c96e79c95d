#!/usr/bin/env python3
"""Smoke run of arpack_ng_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, in order; a failing phase raises and the script exits non-zero:

1. device: require CUDA; print the card's name and its ``nvidia-smi``
   name and power limit;
2. build: compile (or load) the CUDA kernels of ``arpack_ng_tpu_torch/csrc``
   with nvcc for sm_90a (one nvcc per source, in parallel) and print the
   build time;
3. kernels: the event and rotation kernels against their plain PyTorch
   twins on the card, at the flagship shapes (ncv = 32, n = 1,048,576), in
   float32 and bfloat16 storage (plus float64): the event kernels at every
   K 1..32, also at n + 3 and with br and r at a one-value offset (the
   scalar path), two calls equal bit for bit and an all-zero s returning r
   bit for bit; two rotations equal bit for bit; then device-only median
   CUDA-event times of kernel, twin and the one PyTorch call that
   computes the same function (float32; for the
   rotation also bfloat16, with Q rounded to bfloat16), timed in
   alternation, each launch after a read-only L2 flush and a device-side
   wait that covers the host's enqueue; beside them the least time the
   card could take and the host microseconds per call of the wrapper and
   of the library call (events at K = 8/16/24/32, with the fixed cost of a
   call at n = 4096 beside ``torch.mv``); the rotation at rows 8/16/24/32,
   also with fewer columns per thread than the plan's;
4. flagship solve through ``eigsh``: the 2-D Dirichlet Laplacian at
   nx = 1024 (n = 1,048,576), float32, k = 8, ncv = 32, which = 'LA',
   tol = 1e-5, first with the default selective reorthogonalization (the
   main path, whose kernel launches are counted), then again with the
   plain twins in place of the event kernels (a witness of how far their
   summation order alone moves the counters; not counted), and then with
   ``reorth='dgks'``.  Each returned value must lie within 1e-4*|lambda|
   of an analytic eigenvalue and each residual ||Av - lambda v|| / |lambda|
   (scipy CSR, float64, on the host) must be <= 1e-3;
5. basis defect: 30 selective cycles at the floor tolerance must keep
   ``||V V^T - I||_max`` below ``64 sqrt(eps_f32)``;
6. the CGS, DIA and PSELL kernels against their twins at full size, timed
   as in phase 3 beside ``torch.mv``/``torch.addmv`` (CGS) and cuSPARSE CSR
   (``torch.mv`` of a ``torch.sparse_csr_tensor``; DIA and PSELL): CGS at
   ncv = 32, n = 1,048,576, every row count 1..32 in float32, bfloat16 and
   float64 storage, also at n + 3 and with w at a 4-byte offset, two calls
   bit-equal, a zero h an exact no-op; timed at rows 8/16/24/32 (float32
   and bfloat16); DIA on the flagship Laplacian's table;
   PSELL (and the ELL gather) on the RCM-ordered
   ``fem_triangulation(1_048_576)``, two calls bit-equal, beside the bound
   of every packed slot and that of the nonzero slots alone;
7. sparse-entry solves through ``eigsh`` on the default device, k = 8,
   ncv = 32, which = 'LA', tol = 1e-5: (a) the flagship's scipy CSR matrix
   (imported as DIA), (b) the same with ``reorth='dgks',
   cgs_kernel='pallas'``, both under the phase-4 gates, then (b) again
   with the plain twins in place of the CGS kernels and with the kernels
   but ``||r||^2`` summed in float64 (witnesses of how far the summation
   order alone moves its counters; same gates, not counted), and (c) the
   RCM-ordered FEM matrix through ``format='psell'`` and ``format='auto'``
   (ELL): residuals ``<= 1e-3``, the two value sets within 1e-4*|lambda|,
   and the phase within 120 s.  Each path's kernel launches are counted
   from zero and must be positive.  Phases 4 and 7 print each solve's
   counters beside those recorded in ``PERF.md``.

    python3 chip_smoke.py --profile

runs phases 1-2 and then, in place of phases 3-7, the restart-cycle
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
#: device-side wait before each timed launch, in SM clock cycles (~1 ms at
#: 1.98 GHz): longer than any wrapper's host enqueue
SLEEP_CYCLES = 2_000_000
#: L2 flush: a read of this many bytes (the H100's L2 holds 50 MB)
FLUSH_BYTES = 128 * 2**20
#: enqueues behind each host cost per call
HOST_CALLS = 200
#: representative shapes for the JSON line: most events stream one 8-row
#: bucket; the restart keeps kev ~ 9-12 rows, i.e. the 16-row bucket, which
#: is also the first bucket of the dgks steps after a restart
JSON_K, JSON_ROWS = 8, 16
FEM_POINTS = 1_048_576
#: each solve's counters as ``PERF.md`` records them for the current
#: kernels (every kernel sums in a fixed order, so they repeat exactly; the
#: twin witness of the selective solve gives cycles 288, nopx 6278, nrorth
#: 2248)
RECORDED_COUNTERS = {
    "flagship selective": "cycles 299, nopx 6446, nrorth 2270",
    "flagship dgks": "cycles 320, nopx 6962",
    "(a)": "cycles 311, nopx 6783",
    "(b)": "cycles 381, nopx 7832",
    "(c)": "cycles 1, nopx 33",
}
#: wall limit of the FEM phase (7c), seconds
FEM_MAX_S = 120.0
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and FLOP/s outside
#: the tensor cores by accumulation dtype
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.float32": 67e12, "torch.float64": 34e12}


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _flush_buffer(torch, dev):
    """A buffer larger than the 50 MB L2; a read of it evicts the operands
    of the next launch (the solver finds the basis cold)."""
    return torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)


def _alternating_ms(torch, fns, flush) -> list:
    """Device-only median time (ms) of each of ``fns``, timed in turns over
    REPS rounds (forward order, then reverse: kernel, library, library,
    kernel, ...).  Before each launch: a read-only pass over ``flush`` and a
    device-side wait of SLEEP_CYCLES, so that the card is still busy when
    the host has enqueued the timed call and ``t0`` .. ``t1`` holds only the
    call's own device work."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    marks = [[] for _ in fns]
    for rep in range(REPS):
        order = range(len(fns)) if rep % 2 == 0 else \
            range(len(fns) - 1, -1, -1)
        for i in order:
            flush.sum()
            torch.cuda._sleep(SLEEP_CYCLES)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fns[i]()
            t1.record()
            marks[i].append((t0, t1))
    torch.cuda.synchronize()
    return [statistics.median(a.elapsed_time(b) for a, b in m)
            for m in marks]


def _host_us(torch, fn) -> float:
    """Host microseconds per call of ``fn``: ``time.perf_counter`` over
    HOST_CALLS enqueues (the solver is host-bound, so this cost is real on
    its path)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / HOST_CALLS * 1e6


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


def _bound(nbytes: float, flops: float, acc: str):
    """Least time the card could take, in ms: the larger of the bytes over
    the memory rate and the operations over the peak rate of ``acc``."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / PEAK_FLOPS[acc] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def _timed_row(torch, flush, name, sdt, shape, nbytes, flops, acc, kernel,
               plain, library=None, extra=None):
    """One timed entry: kernel, twin, the library call (or None) and the
    ``extra`` calls (name -> call: the ELL gather beside PSELL, the
    rotation under narrower words) timed in alternation, beside the bound;
    where there is a library call, also both host costs per call."""
    bound, by = _bound(nbytes, flops, acc)
    fns = {k: f for k, f in (("ms", kernel), ("plain_ms", plain),
                             ("library_ms", library),
                             *(extra or {}).items())
           if f is not None}
    row = {"name": name, "dtype": sdt, "shape": shape, "library_ms": None,
           "bound_ms": bound, "bound_by": by, "bytes": nbytes}
    row.update(zip(fns, _alternating_ms(torch, list(fns.values()), flush)))
    if library is not None:
        row["host_us"] = _host_us(torch, kernel)
        row["library_host_us"] = _host_us(torch, library)
    return row


def _sel_cases(torch, cuda_sel, V, vec, g, bf16, what, err):
    """Every K 1..NCV against the twins, rows picked by index: the
    projection and the in-place update with and without the fused norm (a
    zero coefficient in each), two calls equal bit for bit, and an all-zero
    s returning r bit for bit.  The largest error of each kernel goes into
    ``err``."""
    dev = V.device
    for K in range(1, NCV + 1):
        tag = f"K={K} {what}"
        idx = torch.randperm(NCV, generator=g, device=dev)[:K].to(torch.int32)
        s = cuda_sel.sel_proj(idx, V, vec)
        err["sel_proj"] = max(err["sel_proj"], _compare(
            torch, s, cuda_sel.sel_proj_plain(idx, V, vec), bf16,
            f"sel_proj {tag}"))
        if not torch.equal(s, cuda_sel.sel_proj(idx, V, vec)):
            raise AssertionError(f"sel_proj {tag}: two calls differ")
        coef = torch.randn(K, generator=g, device=dev, dtype=vec.dtype)
        coef[K // 2] = 0  # a masked row
        for with_norm in (False, True):
            r = vec.clone()
            out = cuda_sel.sel_update(idx, coef, r, V, with_norm=with_norm)
            ref = cuda_sel.sel_update_plain(idx, coef, vec.clone(), V,
                                            with_norm=with_norm)
            if with_norm:
                _compare(torch, out[1], ref[1], bf16, f"sel_update norm {tag}")
                again = cuda_sel.sel_update(idx, coef, vec.clone(), V, True)
                if not (torch.equal(out[0], again[0])
                        and torch.equal(out[1], again[1])):
                    raise AssertionError(f"sel_update {tag}: two calls "
                                         "differ")
                out, ref = out[0], ref[0]
            if out is not r:
                raise AssertionError(f"sel_update {tag}: not in place")
            err["sel_update"] = max(err["sel_update"], _compare(
                torch, out, ref, bf16, f"sel_update {tag}"))
        zero = cuda_sel.sel_update(idx, torch.zeros_like(coef), vec.clone(),
                                   V, True)[0]
        if not torch.equal(zero, vec):
            raise AssertionError(f"sel_update {tag}: zero s changed r")


def _fixed_cost(torch, cuda_sel, V, br, flush, n=4096, K=8):
    """The event kernels and ``torch.mv`` at K = 8 rows of n = 4096 values,
    timed as the full-size rows: what a call costs that moves next to no
    bytes (launch, ramp, the last block's sum and the method's own floor)."""
    Vs, bs = V[:, :n].contiguous(), br[:n].contiguous()
    idx = torch.arange(K, dtype=torch.int32, device=V.device)
    coef, rs = bs[:K].clone(), bs.clone()
    ms = _alternating_ms(torch, [
        lambda: cuda_sel.sel_proj(idx, Vs, bs),
        lambda: cuda_sel.sel_update(idx, coef, rs, Vs, with_norm=True),
        lambda: torch.mv(Vs[:K], bs)], flush)
    print(f"  fixed cost, K={K} rows of n={n} float32: sel_proj {ms[0]:.4f} "
          f"ms, sel_update+norm {ms[1]:.4f} ms, torch.mv {ms[2]:.4f} ms",
          flush=True)


def check_kernels(torch, dev, n=N, timed=True):
    """Phase 3: the event kernels at every K 1..32 in float32, bfloat16 and
    float64 storage, at n and at n + 3 (a tail past the last 16-byte
    vector), with br and r aligned and at a one-value offset (the scalar
    path), timed at K = 8/16/24/32; then the rotation."""
    from arpack_ng_tpu_torch.ops import cuda_rot, cuda_sel

    g = torch.Generator(device=dev).manual_seed(0)
    flush = _flush_buffer(torch, dev) if timed else None
    rec = {k: {"err": 0.0, "err_bf16": 0.0, "err_f64": 0.0}
           for k in ("sel_proj", "sel_update", "rotate_rows")}
    rows_out = []
    pairs = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
             (torch.float64, torch.float64))
    for sdt, adt in pairs:
        bf16 = sdt == torch.bfloat16
        tag = {torch.float32: "err", torch.bfloat16: "err_bf16",
               torch.float64: "err_f64"}[sdt]
        e = {"sel_proj": 0.0, "sel_update": 0.0}
        for m in (n, n + 3):
            Vm = torch.randn(NCV, m, generator=g, device=dev,
                             dtype=adt).to(sdt)
            buf = torch.randn(m + 1, generator=g, device=dev, dtype=adt)
            _sel_cases(torch, cuda_sel, Vm, buf[:m], g, bf16,
                       f"n={m} {sdt}", e)
            _sel_cases(torch, cuda_sel, Vm, buf[1:], g, bf16,
                       f"n={m} {sdt} at +{buf.element_size()} bytes", e)
            del Vm, buf
        for k, v in e.items():
            rec[k][tag] = v
        V = torch.randn(NCV, n, generator=g, device=dev, dtype=adt).to(sdt)
        br = torch.randn(n, generator=g, device=dev, dtype=adt)
        r0 = torch.randn(n, generator=g, device=dev, dtype=adt)
        for K in KS if timed and sdt != torch.float64 else ():
            idx = torch.randperm(NCV, generator=g, device=dev)[:K].to(
                torch.int32)
            # every coefficient non-zero: the kernel reads all K rows, as
            # the bound counts
            coef = torch.randn(K, generator=g, device=dev, dtype=adt)
            f32 = sdt == torch.float32
            idx_l = idx.long()
            sb, ab, acc = V.element_size(), br.element_size(), str(adt)
            rows_out.append(_timed_row(
                torch, flush, "sel_proj", str(sdt), K,
                K * n * sb + n * ab + K * ab, 2 * K * n, acc,
                lambda: cuda_sel.sel_proj(idx, V, br),
                lambda: cuda_sel.sel_proj_plain(idx, V, br),
                (lambda: V.index_select(0, idx_l) @ br)
                if f32 else None))
            rows_out.append(_timed_row(
                torch, flush, "sel_update", str(sdt), K,
                K * n * sb + 2 * n * ab + K * ab, 2 * K * n + 2 * n, acc,
                lambda: cuda_sel.sel_update(idx, coef, r0, V,
                                            with_norm=True),
                lambda: cuda_sel.sel_update_plain(idx, coef, r0, V,
                                                  with_norm=True),
                (lambda: torch.addmv(r0, V.index_select(0, idx_l).T,
                                     coef, alpha=-1)) if f32 else None))
        if timed and sdt == torch.float32:
            _fixed_cost(torch, cuda_sel, V, br, flush)
        Qm, _ = torch.linalg.qr(torch.randn(
            NCV, NCV, generator=torch.Generator().manual_seed(1),
            dtype=torch.float64))
        Q = Qm.to(device=dev, dtype=adt).contiguous()
        Qs = Q.to(sdt)  # the library call's Q for bfloat16 storage
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
            if not torch.equal(V1, cuda_rot.rotate_rows(Q, V.clone(), rows)):
                raise AssertionError(f"rotate_rows rows={rows} {sdt}: two "
                                     "calls differ")
            if timed and sdt != torch.float64:
                sb = V.element_size()
                # the register kernel at the narrower word widths beside
                # the plan's
                pv = cuda_rot.plan(NCV, rows, n, sb, 4, 16)
                words = {f"word{v * sb}_ms":
                         cuda_rot.regs_plan(pv.bucket, v, n, 4)
                         for v in (1, 2, 4) if v < pv.vec}
                rows_out.append(_timed_row(
                    torch, flush, "rotate_rows", str(sdt), rows,
                    (NCV + rows) * n * sb + NCV * rows * Q.element_size(),
                    2 * NCV * rows * n, str(adt),
                    lambda: cuda_rot.rotate_rows(Q, V1, rows),
                    lambda: cuda_rot.rotate_rows_plain(Q, V2, rows),
                    lambda: Qs[:, :rows].T @ V,
                    extra={k: (lambda p=p: cuda_rot.launch(Q, V1, rows, p))
                           for k, p in words.items()}))
                rows_out[-1]["word"] = pv.vec * sb
        del V, V1, V2
    return rec, rows_out


def _cgs_cases(torch, cuda_cgs, V, w, bf16, what, err):
    """Every row count 1..NCV against the twins, w left untouched; the
    largest error of each kernel goes into ``err``."""
    w0 = w.clone()
    for rows in range(1, NCV + 1):
        tag = f"rows={rows} {what}"
        h = cuda_cgs.cgs_proj(V, w, rows)
        err["cgs_proj"] = max(err["cgs_proj"], _compare(
            torch, h, cuda_cgs.cgs_proj_plain(V, w, rows), bf16,
            f"cgs_proj {tag}"))
        for with_norm in (False, True):
            out = cuda_cgs.cgs_update(w, h, V, with_norm)
            ref = cuda_cgs.cgs_update_plain(w, h, V, with_norm)
            if with_norm:
                _compare(torch, out[1], ref[1], bf16,
                         f"cgs_update norm {tag}")
                out, ref = out[0], ref[0]
            err["cgs_update"] = max(err["cgs_update"], _compare(
                torch, out, ref, bf16, f"cgs_update {tag}"))
    if not torch.equal(w, w0):
        raise AssertionError(f"cgs_update changed w ({what})")


def _cgs_accuracy(torch, cuda_cgs, V, w, gpu):
    """Kernel and library call against a float64 reference (float32
    storage): the largest error relative to the largest value, for h, r
    and ||r||^2."""
    for rows in ROWS:
        Vd, wd = V[:rows].double(), w.double()
        h_ex = Vd @ wd
        h_k, h_l = cuda_cgs.cgs_proj(V, w, rows), torch.mv(V[:rows], w)
        r_ex = wd - h_k.double() @ Vd
        (r_k, n_k), r_l = cuda_cgs.cgs_update(w, h_k, V, True), \
            torch.addmv(w, V[:rows].T, h_k, alpha=-1)
        n_ex, n_l = torch.dot(r_ex, r_ex), torch.dot(r_l, r_l)

        def rel(a, ref):
            return float((a.double() - ref).abs().max() / ref.abs().max())
        print(f"  float64 reference, rows={rows}: h kernel "
              f"{rel(h_k, h_ex):.3e}, torch.mv {rel(h_l, h_ex):.3e}; r kernel "
              f"{rel(r_k, r_ex):.3e}, addmv {rel(r_l, r_ex):.3e}; ||r||^2 "
              f"kernel {rel(n_k, n_ex):.3e}, addmv + dot {rel(n_l, n_ex):.3e}"
              f"; card {gpu}", flush=True)


def check_cgs(torch, dev, gpu, n=N, timed=True):
    """Phase 6, CGS: ``cgs_proj`` and ``cgs_update`` (with and without the
    fused norm) against their twins in float32, bfloat16
    and float64 storage: every row count 1..32, at n and at n + 3 (a tail
    past the last 16-byte vector), with w at a 4-byte offset (the scalar
    path); two calls equal bit for bit; a zero h returns w bit for bit.
    Timed at rows 8/16/24/32, n = N, float32 and bfloat16 storage, beside
    the twin and ``torch.mv``/``torch.addmv`` (which leaves out the fused
    norm)."""
    from arpack_ng_tpu_torch.ops import cuda_cgs

    g = torch.Generator(device=dev).manual_seed(2)
    flush = _flush_buffer(torch, dev) if timed else None
    err, rows_out = {"cgs_proj": {}, "cgs_update": {}}, []
    for sdt in (torch.float32, torch.bfloat16, torch.float64):
        bf16, f32 = sdt == torch.bfloat16, sdt == torch.float32
        adt = torch.float64 if sdt == torch.float64 else torch.float32
        e = {"cgs_proj": 0.0, "cgs_update": 0.0}
        for m in (n, n + 3):
            V = torch.randn(NCV, m, generator=g, device=dev, dtype=adt).to(sdt)
            buf = torch.randn(m + 1, generator=g, device=dev, dtype=adt)
            w = buf[:m]
            _cgs_cases(torch, cuda_cgs, V, w, bf16, f"n={m} {sdt}", e)
            _cgs_cases(torch, cuda_cgs, V, buf[1:], bf16,
                       f"n={m} {sdt} w at +{buf.element_size()} bytes", e)
            for rows in (5, 16, 32):
                h = cuda_cgs.cgs_proj(V, w, rows)
                r, nrm = cuda_cgs.cgs_update(w, h, V, True)
                r2, nrm2 = cuda_cgs.cgs_update(w, h, V, True)
                if not (torch.equal(h, cuda_cgs.cgs_proj(V, w, rows))
                        and torch.equal(r, r2) and torch.equal(nrm, nrm2)):
                    raise AssertionError(f"cgs rows={rows} n={m} {sdt}: two "
                                         "calls differ")
                zero = cuda_cgs.cgs_update(w, torch.zeros_like(h), V)
                if not torch.equal(zero, w):
                    raise AssertionError(f"cgs_update rows={rows} n={m} "
                                         f"{sdt}: zero h changed w")
            del V, buf
        for k in err:
            err[k][str(sdt)] = e[k]
        if not timed or sdt == torch.float64:
            continue
        V = torch.randn(NCV, n, generator=g, device=dev).to(sdt)
        w = torch.randn(n, generator=g, device=dev)
        sb = V.element_size()
        for rows in ROWS:
            h = cuda_cgs.cgs_proj(V, w, rows)
            rows_out.append(_timed_row(
                torch, flush, "cgs_proj", str(sdt), rows,
                rows * n * sb + 4 * (n + rows), 2 * rows * n, "torch.float32",
                lambda: cuda_cgs.cgs_proj(V, w, rows),
                lambda: cuda_cgs.cgs_proj_plain(V, w, rows),
                (lambda: torch.mv(V[:rows], w)) if f32 else None))
            for with_norm in (False, True):
                rows_out.append(_timed_row(
                    torch, flush,
                    "cgs_update" + ("+norm" if with_norm else ""), str(sdt),
                    rows, rows * n * sb + 4 * (2 * n + rows),
                    2 * rows * n + 2 * n * with_norm, "torch.float32",
                    lambda: cuda_cgs.cgs_update(w, h, V, with_norm),
                    lambda: cuda_cgs.cgs_update_plain(w, h, V, with_norm),
                    (lambda: torch.addmv(w, V[:rows].T, h, alpha=-1))
                    if f32 else None))
        if f32:
            _cgs_accuracy(torch, cuda_cgs, V, w, gpu)
        del V
    return err, rows_out


def _csr_on(torch, a, dev):
    """The cuSPARSE CSR yardstick: ``a`` as a torch sparse CSR tensor."""
    return torch.sparse_csr_tensor(
        torch.from_numpy(a.indptr.astype(np.int64)),
        torch.from_numpy(a.indices.astype(np.int64)),
        torch.from_numpy(a.data), size=a.shape).to(dev)


def check_dia(torch, dev, nx=NX, timed=True):
    """Phase 6, DIA: the flagship Laplacian's 5-diagonal table, float32 and
    float64, against the twin (same order and rounding, so equal bit for
    bit) and cuSPARSE CSR."""
    from arpack_ng_tpu_torch.config import pad_dim
    from arpack_ng_tpu_torch.models import laplacian_2d
    from arpack_ng_tpu_torch.ops import cuda_dia
    from arpack_ng_tpu_torch.ops.sparse import dia_table

    _, a_sp = laplacian_2d(nx, device=dev)
    n = a_sp.shape[0]
    n_pad = pad_dim(n, 1024)
    flush = _flush_buffer(torch, dev) if timed else None
    err, rows_out = {}, []
    g = torch.Generator(device=dev).manual_seed(3)
    for dtype in (np.float32, np.float64):
        a = a_sp.astype(dtype)
        offs, dtab = dia_table(a, n_pad)
        offs, dtab = torch.from_numpy(offs).to(dev), \
            torch.from_numpy(dtab).to(dev)
        x = torch.zeros(n_pad, dtype=dtab.dtype, device=dev)
        x[:n] = torch.randn(n, generator=g, device=dev, dtype=dtab.dtype)
        y = cuda_dia.dia_matvec(offs, dtab, x, n)
        ref = cuda_dia.dia_matvec_plain(offs, dtab, x, n)
        err[str(dtab.dtype)] = _compare(torch, y, ref, False,
                                        f"dia_matvec {dtype.__name__}")
        if y[n:].any():
            raise AssertionError("dia_matvec: pad rows not zero")
        if not timed:
            continue
        csr = _csr_on(torch, a, dev)
        xs = x[:n]
        nd, ab = dtab.shape[0], dtab.element_size()
        rows_out.append(_timed_row(
            torch, flush, "dia_matvec", str(dtab.dtype), nd,
            nd * n_pad * ab + 2 * n_pad * ab + 8 * nd, 2 * a.nnz,
            str(dtab.dtype), lambda: cuda_dia.dia_matvec(offs, dtab, x, n),
            lambda: cuda_dia.dia_matvec_plain(offs, dtab, x, n),
            lambda: torch.mv(csr, xs)))
    return err, rows_out


def fem_matrix(points=FEM_POINTS):
    """``fem_triangulation(points)`` in reverse Cuthill-McKee order (host,
    float64 CSR) and the seconds it took to build."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from arpack_ng_tpu_torch.models import fem_triangulation

    t0 = time.perf_counter()
    a = fem_triangulation(points)
    p = np.asarray(reverse_cuthill_mckee(a, symmetric_mode=True))
    return a[p][:, p].tocsr(), time.perf_counter() - t0


def check_psell(torch, dev, fem, gpu, timed=True):
    """Phase 6, PSELL: the uniform-W packing of the RCM-ordered FEM matrix,
    float32 and float64, against the twin, cuSPARSE CSR and the plain ELL
    gather of ``format='ell'``; two calls equal bit for bit.  Two bounds:
    every packed slot's value and metadata (``slot_bound_ms``, PRs 2-3),
    and what the inputs need (``bound_ms``): the nonzero slots, the tile
    lengths and panels, x and y."""
    from arpack_ng_tpu_torch.ops import cuda_psell, psell
    from arpack_ng_tpu_torch.ops.sparse import _to_ell, ell_matvec

    n = fem.shape[0]
    flush = _flush_buffer(torch, dev) if timed else None
    err, rows_out = {}, []
    g = torch.Generator(device=dev).manual_seed(4)
    for dtype in (np.float32, np.float64):
        a = fem.astype(dtype)
        t0 = time.perf_counter()
        pk = psell.pack_psell_uniform(a)
        tiles = cuda_psell.psell_tiles(pk, dev)
        t_pack = time.perf_counter() - t0
        ntiles = pk.vals.shape[0]
        print(f"psell {dtype.__name__}: n {n}, nnz {pk.nnz}, W {pk.W}, "
              f"tiles {ntiles}, slot fill {pk.nnz / (ntiles * 1024):.4f}, "
              f"pack {t_pack:.2f} s", flush=True)
        x = torch.randn(n, generator=g, device=dev,
                        dtype=tiles.vals.dtype)
        y = cuda_psell.psell_matvec(tiles, x)
        ref = cuda_psell.psell_matvec_plain(tiles, x)
        err[str(tiles.vals.dtype)] = _compare(
            torch, y, ref, False, f"psell_matvec {dtype.__name__}")
        if not torch.equal(y, cuda_psell.psell_matvec(tiles, x)):
            raise AssertionError("psell_matvec is not deterministic")
        if not timed:
            continue
        csr = _csr_on(torch, a, dev)
        cols_np, vals_np, _ = _to_ell(a, pk.n_pad)
        cols = torch.from_numpy(cols_np).long().to(dev)
        vals = torch.from_numpy(vals_np).to(dev)
        xp = torch.zeros(pk.n_pad, dtype=x.dtype, device=dev)
        xp[:n] = x
        ab = x.element_size()
        ptr_bytes = 4 * (pk.n_pad // 1024 + 1)
        live = int((tiles.tile_len > 0).sum())
        slot_bytes = ntiles * 1024 * (ab + 4) + 4 * ntiles + ptr_bytes \
            + (n + pk.n_pad) * ab
        row = _timed_row(
            torch, flush, "psell_matvec", str(x.dtype), pk.W,
            pk.nnz * (ab + 4) + 4 * ntiles + 4 * live + ptr_bytes
            + (n + pk.n_pad) * ab,
            2 * pk.nnz, str(x.dtype),
            lambda: cuda_psell.psell_matvec(tiles, x),
            lambda: cuda_psell.psell_matvec_plain(tiles, x),
            lambda: torch.mv(csr, x),
            extra={"ell_ms": lambda: ell_matvec(cols, vals, xp)})
        row["slot_bytes"] = slot_bytes
        row["slot_bound_ms"] = _bound(slot_bytes, 2 * pk.nnz,
                                      str(x.dtype))[0]
        row["csr_bytes"] = a.nnz * (ab + 8) + (n + 1) * 8 + 2 * n * ab
        rows_out.append(row)
        print(f"  psell {row['ms']:.4f} ms, twin {row['plain_ms']:.4f} ms, "
              f"cuSPARSE CSR {row['library_ms']:.4f} ms, ELL gather "
              f"{row['ell_ms']:.4f} ms; bound of every packed slot "
              f"{row['slot_bound_ms']:.4f} ms ({slot_bytes / 1e6:.1f} MB, "
              f"{100 * row['slot_bound_ms'] / row['ms']:.1f}% of it), of "
              f"what the inputs need {row['bound_ms']:.4f} ms "
              f"({row['bytes'] / 1e6:.1f} MB, "
              f"{100 * row['bound_ms'] / row['ms']:.1f}%); live tiles "
              f"{live} of {ntiles}; CSR stores "
              f"{row['csr_bytes'] / 1e6:.1f} MB; card {gpu}", flush=True)
        del csr, cols, vals
    return err, rows_out


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
        if reorth == "selective":
            _sel_witness(torch, dev, gpu, op, a_sp, spectrum)
        print(f"  recorded: {RECORDED_COUNTERS['flagship ' + reorth]}",
              flush=True)
        print(f"  values {np.array2string(vals, precision=7)}", flush=True)
    return launches


def _sel_witness(torch, dev, gpu, op, a_sp, spectrum):
    """Phase 4's selective solve again with the plain twins in place of the
    event kernels: they sum in another order, which alone can move the
    counters of this clustered spectrum.  Same gates; its launches are not
    the main path's."""
    from unittest import mock

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core import arnoldi
    from arpack_ng_tpu_torch.ops import cuda_sel

    with mock.patch.object(arnoldi, "sel_proj", cuda_sel.sel_proj_plain), \
            mock.patch.object(arnoldi, "sel_update",
                              cuda_sel.sel_update_plain):
        (vals, vecs, out), wall, _ = _counted(torch, dev, (), lambda: pt.eigsh(
            op, k=8, ncv=NCV, which="LA", tol=1e-5, return_stats=True))
    dmax, rmax = check_values(vals, vecs, a_sp, spectrum,
                              "flagship selective witness, twins")
    print(f"  witness, twins in place of the event kernels: wall {wall:.4f} "
          f"s, {_stats_line(out.stats)}; max value dist {dmax:.2e}, max "
          f"residual {rmax:.2e}; card {gpu}", flush=True)


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


def _counted(torch, dev, need, fn):
    """Run ``fn`` with every kernel's launch count set to 0 just before and
    read just after; fail if a kernel of ``need`` was never launched.
    Returns ``(fn(), wall seconds, counts)``."""
    from arpack_ng_tpu_torch.ops import (cuda_cgs, cuda_dia, cuda_psell,
                                         cuda_rot, cuda_sel)

    every = (cuda_sel.sel_proj, cuda_sel.sel_update, cuda_rot.rotate_rows,
             cuda_cgs.cgs_proj, cuda_cgs.cgs_update, cuda_dia.dia_matvec,
             cuda_psell.psell_matvec)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for k in every:
        k.launches = 0
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in every}
    idle = [k for k in need if counts[k] == 0]
    if idle:
        raise AssertionError(f"kernels never launched: {idle}")
    return out, wall, counts


def _stats_line(st) -> str:
    return (f"cycles {st.n_iter}, nopx {st.nopx}, nrorth {st.nrorth}, "
            f"nrorthr {st.nrorthr}, nitref {st.nitref}, nrotr {st.nrotr}")


def _dgks_witnesses(torch, dev, gpu, op, a_sp, spectrum, kw):
    """Phase 7b's solve again, with the plain twins in place of the CGS
    kernels, and with the kernels but ``||r||^2`` summed in float64: each
    rounds the CGS passes in another order, which alone moves the counters
    of this clustered spectrum.  Same gates; the launches are not the main
    path's."""
    from unittest import mock

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core import arnoldi
    from arpack_ng_tpu_torch.ops import cuda_cgs

    def norm64(w, h, V, with_norm=False):
        r = cuda_cgs.cgs_update(w, h, V)
        if not with_norm:
            return r
        r64 = r.double()
        return r, torch.dot(r64, r64).to(r.dtype)

    for tag, proj, update in (
            ("twins", cuda_cgs.cgs_proj_plain, cuda_cgs.cgs_update_plain),
            ("kernels, ||r||^2 in float64", cuda_cgs.cgs_proj, norm64)):
        with mock.patch.object(arnoldi, "cgs_proj", proj), \
                mock.patch.object(arnoldi, "cgs_update", update):
            (vals, vecs, out), wall, _ = _counted(
                torch, dev, (), lambda: pt.eigsh(
                    op, reorth="dgks", cgs_kernel="pallas", **kw))
        dmax, rmax = check_values(vals, vecs, a_sp, spectrum,
                                  f"(b) witness, {tag}")
        print(f"sparse (b) witness, {tag}: wall {wall:.4f} s, "
              f"{_stats_line(out.stats)}; max value dist {dmax:.2e}, max "
              f"residual {rmax:.2e}; card {gpu}", flush=True)


def sparse_solves(torch, dev, gpu, fem, nx=NX, device=None):
    """Phase 7: solves through the scipy-sparse entry of ``eigsh`` on the
    default device (``device=None``).  Returns the launches of each
    kernel in the path that exercises it."""
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.models import laplacian_2d

    dkw = {} if device is None else {"device": device}
    kw = dict(k=8, ncv=NCV, which="LA", tol=1e-5, return_stats=True)
    _, a_sp = laplacian_2d(nx, device=dev)
    spectrum = _analytic_spectrum(nx)
    op = pt.from_scipy(a_sp, dtype=np.float32, hermitian=True, **dkw)
    if op.format != "dia" or op.device.type != dev.type:
        raise AssertionError(f"flagship CSR imported as {op.format} on "
                             f"{op.device}, want dia on {dev.type}")
    launches = {}
    for tag, need, fn in (
            ("(a) eigsh(A_csr)", ("dia_matvec",),
             lambda: pt.eigsh(a_sp, dtype=np.float32, **kw, **dkw)),
            ("(b) eigsh(A_csr) dgks, cgs_kernel='pallas'",
             ("cgs_proj", "cgs_update", "dia_matvec", "rotate_rows"),
             lambda: pt.eigsh(op, reorth="dgks", cgs_kernel="pallas",
                              **kw))):
        (vals, vecs, out), wall, counts = _counted(torch, dev, need, fn)
        dmax, rmax = check_values(vals, vecs, a_sp, spectrum, tag)
        print(f"sparse {tag}: format dia, wall {wall:.4f} s, "
              f"{_stats_line(out.stats)}; max value dist {dmax:.2e}, max "
              f"residual {rmax:.2e}; launches {counts}; card {gpu}",
              flush=True)
        print(f"  recorded: {RECORDED_COUNTERS[tag[:3]]}", flush=True)
        for k in need:
            launches.setdefault(k, counts[k])
    _dgks_witnesses(torch, dev, gpu, op, a_sp, spectrum, kw)

    t0 = time.perf_counter()
    found = {}
    for fmt in ("psell", "auto"):
        need = ("psell_matvec",) if fmt == "psell" else ()
        t1 = time.perf_counter()
        op = pt.from_scipy(fem, dtype=np.float32, hermitian=True,
                           format=fmt, **dkw)
        t_import = time.perf_counter() - t1
        if op.format != ("psell" if fmt == "psell" else "ell"):
            raise AssertionError(f"FEM format={fmt} imported as {op.format}")
        (vals, vecs, out), wall, counts = _counted(
            torch, dev, need, lambda: pt.eigsh(op, **kw))
        if len(vals) != 8:
            raise AssertionError(f"FEM {fmt}: {len(vals)} values, want 8")
        v64 = np.asarray(vecs, np.float64)
        res = np.linalg.norm(fem @ v64 - v64 * vals[None, :], axis=0) \
            / np.abs(vals)
        if not np.all(np.isfinite(res)) or res.max() > 1e-3:
            raise AssertionError(f"FEM {fmt}: residual {res.max():.3e}")
        found[fmt] = vals
        print(f"sparse (c) FEM n={fem.shape[0]} format={fmt} -> "
              f"{op.format}: import {t_import:.2f} s, solve {wall:.4f} s, "
              f"{_stats_line(out.stats)}; max residual {res.max():.2e}; "
              f"launches {counts}; card {gpu}", flush=True)
        print(f"  recorded: {RECORDED_COUNTERS['(c)']}", flush=True)
        print(f"  values {np.array2string(vals, precision=7)}", flush=True)
        if need:
            launches["psell_matvec"] = counts["psell_matvec"]
    gap = np.abs(found["psell"] - found["auto"])
    if np.any(gap > 1e-4 * np.abs(found["auto"])):
        raise AssertionError(f"FEM: psell and ell values differ by "
                             f"{gap.max():.3e}")
    elapsed = time.perf_counter() - t0
    print(f"sparse (c): {elapsed:.2f} s (limit {FEM_MAX_S:.0f} s), values "
          f"agree within {gap.max():.3e}", flush=True)
    if elapsed > FEM_MAX_S:
        raise AssertionError(f"FEM phase took {elapsed:.1f} s")
    return launches


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


def kernel_entries(rows, launches, errs):
    """The ``kernels`` JSON entries: each kernel at the float32 shape its
    solve runs most (the update of the dgks path carries the fused norm),
    with the launches of the path that exercises it."""
    src = {"sel_proj": ("sel.cu", "pallas_sel.py:90", JSON_K),
           "sel_update": ("sel.cu", "pallas_sel.py:141", JSON_K),
           "rotate_rows": ("rot.cu", "pallas_rot.py:91", JSON_ROWS),
           "cgs_proj": ("cgs.cu", "pallas_cgs.py:58", JSON_ROWS),
           "cgs_update": ("cgs.cu", "pallas_cgs.py:116", JSON_ROWS),
           "dia_matvec": ("dia.cu", "pallas_dia.py:47", None),
           "psell_matvec": ("psell.cu", "pallas_psell.py:262", None)}
    entries = []
    for kname, (source, replaces, shape) in src.items():
        timed = "cgs_update+norm" if kname == "cgs_update" else kname
        r = next(r for r in rows if r["name"] == timed
                 and r["dtype"] == "torch.float32"
                 and (shape is None or r["shape"] == shape))
        entries.append({
            "name": kname, "route": "cuda",
            "source": f"arpack_ng_tpu_torch/csrc/{source}",
            "replaces": f"arpack_ng_tpu/ops/{replaces}",
            "launches": launches[kname], "max_abs_err": errs[kname],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "lib_ms": r["library_ms"],
            "host_us": r["host_us"], "library_host_us": r["library_host_us"],
            "shape": f"{timed} shape={r['shape']} float32"})
    return entries


def _print_rows(rows) -> None:
    for r in rows:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        host = "" if "host_us" not in r else \
            (f"; host {r['host_us']:.1f} us/call, library "
             f"{r['library_host_us']:.1f} us/call")
        if "word" in r:
            host += f"; {r['word']}-byte words (the plan's), " + ", ".join(
                f"{k[4:-3]}-byte {v:.4f} ms" for k, v in r.items()
                if k.startswith("word") and k.endswith("_ms"))
        print(f"  {r['name']:15s} {r['dtype']:15s} shape={r['shape']:2d}: "
              f"kernel {r['ms']:.4f} ms, twin {r['plain_ms']:.4f} ms, "
              f"library {lib} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {r['bytes'] / 1e6:.1f} MB, "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of it){host}",
              flush=True)


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
    print(f"kernels vs twins at ncv={NCV}, n={N} (device-only median of "
          f"{REPS} in alternation, L2 flushed by a read; card {gpu}):",
          flush=True)
    _print_rows(rows)
    print("  max abs err (f32, bf16, f64): "
          + ", ".join(f"{k} {v['err']:.3e} / {v['err_bf16']:.3e} / "
                      f"{v['err_f64']:.3e}" for k, v in rec.items()),
          flush=True)

    launches = flagship(torch, dev, gpu)
    basis_defect(torch, dev, gpu)

    err_cgs, rows_cgs = check_cgs(torch, dev, gpu)
    err_dia, rows_dia = check_dia(torch, dev)
    fem, t_fem = fem_matrix()
    print(f"fem_triangulation({FEM_POINTS}) + RCM: {t_fem:.2f} s",
          flush=True)
    err_ps, rows_ps = check_psell(torch, dev, fem, gpu)
    print(f"phase 6 kernels vs twins (device-only median of {REPS} in "
          f"alternation, L2 flushed by a read; card {gpu}):", flush=True)
    _print_rows(rows_cgs + rows_dia + rows_ps)
    errs = {**{k: v["torch.float32"] for k, v in err_cgs.items()},
            "dia_matvec": err_dia["torch.float32"],
            "psell_matvec": err_ps["torch.float32"]}
    print(f"  max abs err: cgs {err_cgs}, dia {err_dia}, psell {err_ps}",
          flush=True)
    # each kernel's launches come from the first solve that runs it
    for k, v in sparse_solves(torch, dev, gpu, fem).items():
        launches.setdefault(k, v)
    errs.update({k: rec[k]["err"] for k in rec})

    entries = kernel_entries(rows + rows_cgs + rows_dia + rows_ps, launches,
                             errs)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

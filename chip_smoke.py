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
   also with fewer columns per thread than the plan's.  Then the event
   kernels as the main path launches them, over all 32 rows with K read
   from device memory: K = 0 leaves r bit for bit, every K 1..32 equals a
   call over the K rows alone bit for bit, timed at K = 0/8/16/24/32; and
   the reduced-space kernel (``csrc/sym_cycle.cu``) against its numpy twin
   on Lanczos tridiagonals (float32, float64; ncv = 32 with its workspace
   in shared memory, and the first ncv past it, the matrices in global
   memory), timed device-only at ncv = 32 beside the twin's host wall and
   the library form (``torch.linalg.eigh`` and the QR loop on the card,
   with their syncs), with the kernel's phase clocks (QL, head, shift
   sweep, tail) and the sweep's per-shift clocks;
4. flagship solve through ``eigsh``: the 2-D Dirichlet Laplacian at
   nx = 1024 (n = 1,048,576), float32, k = 8, ncv = 32, which = 'LA',
   tol = 1e-5, first with the default selective reorthogonalization (the
   main path: the device restart loop, its extensions replayed as CUDA
   graphs, one packet read per cycle, whose kernel launches are counted
   per replay; its cycles must fall in 194-322, the span of both reduced
   spaces' counts over seeds 0-4, ``tools/flagship_seeds.py``, and its
   cycles / nopx / nrorth must be the reduced-space kernel's recorded
   237 / 5335 / 1868, ``KERNEL_COUNTERS``), then
   the same loop with the reduced space on the host as before (a witness
   that must repeat the host loop's 299 / 6446 / 2270 exactly), then with
   the plain twins in place of the event kernels (a witness of how far
   their summation order alone moves the counters; not counted), and then
   with ``reorth='dgks'`` (the host loop).  Each returned value must lie
   within 1e-4*|lambda| of an analytic eigenvalue and each residual
   ||Av - lambda v|| / |lambda| (scipy CSR, float64, on the host) must be
   <= 1e-3;
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
   of every packed slot and that of the nonzero slots alone; beside them
   the ELL gather's bare ``xp[cols]`` and ``take_flat`` on the same columns
   (float32), equal bit for bit;
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
   counters beside those recorded in ``PERF.md``;
8. the gather kernels (``take_flat``, ``take_lanes``) against their twins
   at the gather probe's shapes, equal bit for bit (a gather does no
   arithmetic), with indices 0 and n - 1, tails past the last 16-byte
   word, a misaligned index buffer and a misaligned x, and ``take_lanes``
   also at 5 and 16384 rows; each timed as in phase 3 beside its twin, its
   library call (``index_select``; ``torch.gather``) and the empty kernel
   (the harness's launch floor), ``take_lanes`` at 2048 and 16384 rows;
   then the gather probe's six forms once (``arpack_ng_tpu_torch.bench.
   gather_primitives``: the main path of these kernels, whose launches are
   counted);
9. ``eigs`` at full width: the convection-diffusion operator of
   ``benchmarks/bench_nonsym.py`` (nx = 1024, rho = 100, float32, k = 8,
   ncv = 32, which = 'LM'): (a) the reference's timing protocol, 2 warm
   cycles and 20 timed cycles at tol = 1e-30 (ms/cycle), then the basis
   defect ``||V V^T - I||_max <= 64 sqrt(eps)`` after one more extension;
   (b) a solve to tol = 1e-5 through ``eigs`` (at most EIGS_MAX_RESTARTS
   restarts; at nx = EIGS_SOLVE_NX = 512, see there) and (c) the same
   through ``eigs(A_csr)`` (DIA) with ``cgs_kernel='pallas'``: 8 or 9 values, conjugate-closed, every
   residual ``||Av - lambda v|| / |lambda| <= 1e-3`` (scipy CSR, float64,
   complex vectors, on the host), the rotation kernel launched, and the
   phase within EIGS_MAX_S.  No value is held to the analytic spectrum: the
   operator is strongly non-normal, and float32 pairs converged by
   residual may lie in its pseudospectrum;
10. the hybrid driver and complex dtypes at full width, float32 /
   complex64, k = 8, ncv = 32, tol = 1e-5: (a) the flagship through
   ``eigsh(strategy='hybrid')`` (the reduced space on the host in float64,
   the event and rotation kernels) under the phase-4 gates; (b)
   ``eigs(strategy='hybrid', cgs_kernel='pallas')`` on the conv-diff
   operator at nx = 1024, the cell phase 9b-c cuts to 512: every returned
   value's residual ``<= 1e-3`` and closed under conjugation, the value
   count and info code reported (does the float64 reduced space return
   the 8 the fused real driver loses?); (c) a complex Hermitian operator
   ``T_c (x) I + I (x) T_0`` at nx = 1024 (``T_c = tridiag(-1 - ic, 2,
   -1 + ic)``, c = 0.5, ``T_0 = tridiag(-1, 2, -1)``), imported by the
   complex ``from_scipy`` (DIA), through ``eigsh(which='LA')`` under
   'auto' (the device loop: ``sym_cycle`` and the rotation kernel on the
   basis' real view) and 'hybrid': real values within 1e-4*|lambda| of the
   analytic spectrum, residuals ``<= 1e-3`` (complex128, host); (d)
   ``eigs`` on ``convection_diffusion_2d(512, complex64)`` under 'auto'
   (the hybrid driver), cut to nx = 512 to compare with 9b: 8 values,
   residuals ``<= 1e-3``; how far its values lie from 9b's as sets is
   reported beside 9c's distance from 9b (both drivers' float32 values lie
   in the operator's pseudospectrum, above its real spectrum); 10c's
   'auto' solve again with the reduced space on the host (a witness, not
   counted); the phase within P10_MAX_S;
11. the rest of mode 1 at full width, float32 / complex64, k = 8,
   ncv = 32, tol = 1e-5: (a) ``eigs(A_csr, strategy='fused')`` on the
   conv-diff operator at nx = 1024 imported as DIA (complexified: two DIA
   launches per complex matvec; the copy that gives the kernel contiguous
   real and imaginary parts timed beside the two launches) and (b)
   ``eigs(strategy='fused')`` on ``convection_diffusion_2d(1024,
   complex64)``: every residual ``<= 1e-3``, (a)'s values closed under
   conjugation within 1e-3 relative but for the last (a complex driver
   may cut a pair at k), count, info, cycles and ms per cycle reported; a
   count below 8 there (the float32 reduced space's shortfall against the
   float64 re-test, as the fused real driver shows at 1024) is reported
   and the count gated (8) at nx = P11_CUT_NX; (c) the flagship through
   ``eigsh(restart='thick')`` under the phase-4 gates, then with
   ``select=`` (Ritz values 0, 2 and 5 of the exit order: those three of
   (c)'s values exactly, their vectors under the gates); (d) the flagship
   through ``eigsh(shift_fn=f)``, f returning the unwanted Ritz values
   largest bound first, under the phase-4 gates, f called once per
   restart; (e) ``eigs_realified`` on ``convection_diffusion_2d(512,
   complex64)``'s matrix (2n = 524,288 rows through the real DIA kernel
   and the fused real driver): 8 recovered values, residuals ``<= 1e-3``
   (complex128, host); the phase within P11_MAX_S;
12. the spectral transforms, their linear solvers and ``svds`` at full
   width, float64 unless stated (each path's launches counted from zero):
   (a) the main path, dsdrv2's use at the flagship's size: ``eigsh`` (k =
   8, 'LM', ncv = 32, tol = 1e-8) on ``shift_invert_operator(mode=3,
   sigma=0)`` of the 2-D Laplacian at nx = P12_NX (n = 1,048,576), each
   inner solve ``make_iterative_solve`` (CG, tol = 1e-10) with
   ``ilu0_preconditioner(symmetric=True, sweeps=3)``: the shifted product
   (``from_scipy(format='dia')``) and both IC(0) triangles run the DIA
   kernel (first checked bit-equal to its twin on the triangles' tables);
   gates: every value within 1e-6*|lambda| of the analytic spectrum, every
   residual ``||Av - lambda v|| / max(1, |lambda|) <= 1e-6``, the DIA kernel
   launched; reported: cycles, nopx, CG iterations per solve, ms per CG
   iteration and the share of its loop test's device read (the same
   iterations with and without it, in turns), host set-up apart; (b)
   dsdrv3-6's pencil ``K = tridiag(-1, 2, -1)/h``, ``M = tridiag(1, 4,
   1)h/6`` through ``eigsh(K, M=M, sigma=P12_SIGMA, mode=...)`` (the host
   factorization's explicit inverse, capturable: the device loop's graphs)
   at n = P12_DENSE_N, modes 'normal', 'buckling' and 'cayley', k = 4,
   and mode 2 (no sigma, 'LM') at n = P12_MODE2_N: values within
   1e-8*|lambda| of the closed form, ``||Kv - lambda Mv|| / max(1,
   |lambda|) <= 1e-8``, the host factorization's seconds beside the wall
   (Cayley: ARPACK's own residual, scipy's dsaupd/dseupd on the same
   pencil and start vector, printed beside it); (c) ``eigs`` shift-invert on
   ``convection_diffusion_2d(P12_EIGS_NX, rho=P12_RHO)`` through the dense
   routes: a real shift, a complex shift on the real problem (the real
   part, Rayleigh-quotient values, dndrv5), mode 4 (``part='imag'``, M =
   I, dndrv6) and complex128 with a complex shift (zndrv2); then
   matrix-free BiCGSTAB with ``ilu0_preconditioner`` (sigma = 0, nx =
   P12_BICG_NX, the DIA kernel for the product and both triangles): at
   least 6 values, each within 1e-8*|lambda| of scipy's shift-invert
   values, residuals ``/ max(1, |lambda|) <= 1e-8`` (BiCGSTAB: 1e-6); (d)
   ``svds`` of a float32 ``A`` (P12_SVD_SHAPE, 1 GiB) made on the card
   from seeded orthonormal factors with singular values 10..3 on top,
   k = 8, methods 'normal' and 'augmented': ``s`` within 1e-4 relative,
   ``||Av - su||/s`` and ``||A^T u - sv||/s <= 1e-3``; the phase within
   P12_MAX_S;
13. the banded and block solvers at full width (each path's launches
   counted from zero): (a) the main path, the reference's n = 2^20 "done
   bar": ``eigsh_banded`` on ``tridiag(-1, 2, -1)``, float64, sigma =
   P13_SIGMA, k = 4, 'LM', tol = 1e-10, shift-invert by block cyclic
   reduction in its full-length DIA form (every sweep a chain of DIA
   launches); before it, on the same factor: BCR in the DIA form (probe
   residual printed), one solve through the DIA kernel equal to the same
   solve through its twin (gate 1e-12), the DIA launches of one OP
   apply, and ms per apply in the DIA form and in the compacted form (a
   second factor with the memory gate at 0 bytes), device-only in
   alternation; the solve at the reference's default ncv (one cycle, run
   eagerly) and at ncv = P13_NCV (it restarts: the device loop replays
   its graphs, each holding its applies' DIA launches); gates: values
   within 1e-8 of ``2 - 2 cos(j pi/(n+1))``, residuals ``<= 1e-8``; (b)
   the pencil ``K = tridiag(-1, 2, -1)``, ``M = tridiag(1, 4, 1)/6`` at n
   = 2^20, sigma = P13_GEN_SIGMA: values within ``1e-8 |lambda|`` of the
   closed form, ``||Kv - lambda Mv|| <= 1e-8``; mode 2 (M factored by BCR)
   **cut to n = 2000** as the reference's test (ncv = 32, maxiter = 3000):
   gates 1e-6; (c) ``eigs_banded`` on the 1-D convection-diffusion band
   (rho = 10): a real shift 1.0 **cut to n = 2^16** (a float64 Ritz
   vector's residual floor, ~1e-14 ||A||, is 3.8e-8 at n = 2^20, above
   its 1e-8 gate), residuals ``<= 1e-8``; a complex shift 1+5j,
   ``part='real'`` (realified, b = 2) **cut to n = 2^15** (at 2^20 the
   operator's top values lie ~5e-6 apart relative: no convergence in 500
   restarts), residuals ``<= 1e-7``; the realified factor at n = 2^20,
   over the DIA form's memory gate, so in the compacted form: one solve
   held by ``||S x - v|| / ||v|| <= 1e-10`` and timed; (d)
   ``eigsh_block`` (float32, k = 8, ncv = 32, b = 1, 2, 4) beside the
   scalar selective ``eigsh`` on the same operator: the flagship's CSR
   through ``from_scipy`` (DIA with the block product), tol = 1e-5, under
   phase 4's gates with the multiplet convention, and
   ``bench_block.py``'s dia65 (65 diagonals) at n = 2^20, tol = 1e-4: top
   value within ``1e-4 |lambda|`` of the scalar's, residuals ``<= 1e-3``
   by the block DIA twin on the card in float64; wall, cycles, matvecs,
   ms per cycle, the share of ``eigh`` of T in it and ms per block
   apply; (e) the block DIA kernel against its twin on both tables, b in
   {1, 2, 4, 8}, float32 and float64, at n and n + 3, bit for bit (and
   each column against the single kernel), timed beside its bound, b
   single launches and ``torch.sparse.mm`` (cuSPARSE SpMM); the phase
   within P13_MAX_S;
14. the file entry points (each path's launches counted from zero): (a)
   the main path: the flagship's Laplacian written as a MatrixMarket file
   (``io.matrix_market.write_matrix``, then read back: both seconds
   printed), then ``python -m arpack_ng_tpu_torch.cli --A lap.mtx --nbEV
   8 --nbCV 32 --mag LA --tol 1e-5 --simplePrec --json`` in its own
   process on the card, then the same in this process (the reference
   CLI's reorthogonalization, dgks: the rotation and DIA kernels); gates:
   rc 0, 8 values within 1e-4*|lambda| of the analytic spectrum, the CLI's
   own residuals ``<= 1e-3``; (b) the run with ``--maxIt P14_CUT --dump``
   (rc 1), then ``--restart`` from the file: its cycles, nopx, nrorth, nrotr
   and values must be the unbroken run's exactly; (c) the flagship on the
   device loop (``eigsh``'s config, CUDA graphs) stopped at the boundary
   after P14_CUT cycles (``FusedSymSolver.multi``), ``save_state``,
   ``load_state`` into a fresh solver, resumed: the totals must be
   ``KERNEL_COUNTERS['flagship selective']``, the values phase 4's gates;
   (d) the ``--slv`` menu: CG with the IC(0) preconditioner for
   shift-invert at sigma = 0 on the Laplacian at nx = P14_SI_NX, float64
   (values within 1e-6*|lambda| of the analytic spectrum, residuals ``/
   max(1, |lambda|) <= 1e-6``), and LU for dsdrv3-6's pencil at n =
   P14_PENCIL_N (1e-8); (e) the seven examples of
   ``arpack_ng_tpu_torch.examples`` once each, residuals under
   P14_EXAMPLE_RES, the event, rotation, PSELL and reduced-space kernels
   launched; the phase within P14_MAX_S.

    python3 chip_smoke.py --profile

runs phases 1-2 and then, in place of phases 3-9, the restart-cycle
profile of the flagship behind ``PERF.md`` section 5: for each reorth
variant (selective: the device loop; dgks: the host loop) the wall per
Lanczos step over steady cycles, the card's busy share and largest device
items under ``torch.profiler``, and the host's ``cProfile``.

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
import subprocess
import sys
import time

import numpy as np

from arpack_ng_tpu_torch.bench import timing

NCV = 32
NX = 1024
N = NX * NX
KS = (8, 16, 24, 32)
ROWS = (8, 16, 24, 32)
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
#: the selective flagship's (cycles, nopx, nrorth) on the host loop
#: (PERF.md); the device loop with the reduced space on the host repeats them
HOST_LOOP_COUNTERS = (299, 6446, 2270)
#: the gate on the main path's cycles: the span of the selective
#: flagship's cycles over start-vector seeds 0-4 on the card, with the
#: reduced-space kernel (194-297) and with the host loop's reduced space
#: (210-322) (``tools/flagship_seeds.py``, chip run 6 of PR 7; PERF.md
#: section 6): the kernel's rounding moves the count within it
SELECTIVE_BAND = (194, 322)
#: the counters of the device-loop solves with the reduced-space kernel at
#: the default seed, (cycles, nopx, nrorth) and (cycles, nopx): the kernel
#: fixes the order of every sum, so they repeat exactly, and they witness
#: that its bits are those recorded in PERF.md (a change that keeps each
#: value's operations and order must repeat them).  A change meant to move
#: the kernel's bits updates them, inside SELECTIVE_BAND.
KERNEL_COUNTERS = {"flagship selective": (237, 5335, 1868),
                   "(a)": (236, 5321)}
#: the reduced-space kernel against its twin (phase 3 and
#: tests/test_torch_gpu.py): the largest gap each check allows, in the
#: units of ``_sym_gaps``, about twice the largest the kernel showed (chip
#: runs 7-8 of PR 7, here and in the card tests).  The float32 values catch
#: an eigensolve in float32 in every case (``tools/reduced_rounding_cpu.py``:
#: 3.3e-7 or more; the kernel's are equal); T and Q catch its QR in some.
#: Past the shared-memory limit (ncv = 136 on the flagship's spectrum) Q's
#: kept columns and the residual's new part meet close Ritz values, which
#: leave them undetermined past 5.7e-4 there: ``SYM_LIMITS_GLOBAL``
#: overrides.
SYM_LIMITS = {
    "torch.float32": dict(values=1e-7, T=5e-5, Q=2e-5, sigmak=5e-6,
                          resid=1e-5),
    "torch.float64": dict(values=1e-9, T=1e-7, Q=1e-7, sigmak=1e-7,
                          resid=1e-7)}
SYM_LIMITS_GLOBAL = {"torch.float32": dict(Q=1e-3, resid=1e-3),
                     "torch.float64": {}}
#: the kernels the selective flagship must launch
SELECTIVE_PATH = ("sel_proj", "sel_update", "rotate_rows", "sym_cycle")
#: wall limit of the FEM phase (7c), seconds
FEM_MAX_S = 120.0
#: phase 9: grid of the convection-diffusion operator (bench_nonsym.py:34-38)
#: for the timed cycles (a) and for the solves (b, c); restart cap of the
#: solves; wall limit of the phase, seconds.  The solves run at nx = 512,
#: the largest grid of 1024, 768 and 512 whose default-seed float32 solve
#: ends with 8 or 9 values on the H100: at 1024 (6 values) and 768 (7) the
#: float32 reduced space counts 8 converged where the float64 re-test of
#: the extraction finds fewer (reference info -14; PERF.md section 6)
EIGS_NX = 1024
EIGS_SOLVE_NX = 512
EIGS_MAX_RESTARTS = 300
EIGS_MAX_S = 150.0
#: phase 10c: the imaginary part of the Hermitian tridiagonal's
#: off-diagonal; phase 10's restart cap (10b, 10d) and wall limit, seconds
#: (about three times the 42 s it takes on an H100 at 700 W, PERF.md
#: section 6)
HERM_C = 0.5
P10_MAX_RESTARTS = 1000
P10_MAX_S = 120.0
#: phase 11: the restart cap of its solves (11d, caller's shifts without
#: nev inflation, took 861 cycles on an H100, PERF.md section 6), its wall
#: limit (seconds; 63 s there) and the grid of 11e and of 11a-b's count
#: gate where the float32 reduced space falls short at nx = 1024
P11_MAX_RESTARTS = 2000
P11_MAX_S = 240.0
P11_CUT_NX = 512
#: phase 12: the main path's grid (12a: shift-invert of the flagship's
#: Laplacian through CG with the IC(0) preconditioner) and the CG cap of
#: its inner solves; the read share's CG iterations; the dense routes'
#: dimension (12b, modes 3-5) and mode 2's (its top values lie ~(pi/n)^2
#: apart); the shift between the pencil's two lowest values; the eigs grid
#: (12c, dense routes), its convection (rho = 10: at the bench's 100, T's
#: eigenvector condition ((1+c)/(1-c))^((nx-1)/2) with c = 0.77 is ~1e28,
#: so no float64 eigenvalue, scipy's included, is accurate enough for a
#: value gate) and shifts; the BiCGSTAB grid and cap; the svds shape
#: (12d); the phase's wall limit, seconds (1.9 times the 158 s it took on
#: an H100 at 700 W, PERF.md section 5)
P12_NX = 1024
P12_CG_MAXITER = 20_000
P12_READ_ITS = 500
P12_DENSE_N = 4096
P12_MODE2_N = 512
P12_SIGMA = 25.0
P12_EIGS_NX = 64
P12_RHO = 10.0
P12_SHIFTS = (1.0, 1.0 + 0.05j)
P12_ZSHIFT = 0.3 + 0.2j
P12_BICG_NX = 256
P12_BICG_MAXITER = 5_000
P12_SVD_SHAPE = (65_536, 4_096)
P12_MAX_S = 300.0
#: phase 13: the banded and block solvers.  The main path's dimension (13a:
#: the reference's n = 2^20 "done bar", tests/test_bandsolve.py:208-224)
#: and shift, with 13a's restarting ncv below; the generalized pencil's
#: shift (13b); mode 2's dimension, cut as the reference's test cuts it
#: (its top values cluster: ncv = 32, maxiter = 3000 at n = 2000); the
#: convection of 13c's band, its complex shift and the dimensions of its
#: real- and complex-shift solves (cut: see _banded_eigs); the block sizes
#: and restart cap of 13d (bench_block.py's cap), the half-width of its 65-diagonal operator
#: (bench_block.py:build_dia(n, 32)); the timed rounds of one BCR apply;
#: the phase's wall limit, seconds (2.6 times the ~115 s its parts took on
#: an H100 at 700 W, 13d 73 s of it)
P13_N = 1 << 20
P13_SIGMA = 1.234567
#: 13a's second solve: an ncv at which it restarts (the reference's
#: default, 20, converges in the loop's eager first cycle)
P13_NCV = 10
P13_GEN_SIGMA = 0.7
P13_MODE2_N = 2000
P13_RHO = 10.0
P13_ZSIGMA = 1.0 + 5.0j
P13_CD_REAL_N = 1 << 16
P13_CD_COMPLEX_N = 1 << 15
P13_BLOCKS = (1, 2, 4)
#: the block size whose run gives the block kernel's launches and timed
#: row in the kernels line (the flagship's multiplicity-2 pairs)
P13_JSON_B = 2
P13_BLOCK_MAXITER = 3000
P13_NDIAG = 32
P13_SOLVE_REPS = 10
P13_MAX_S = 300.0
#: phase 14: the file entry points.  The CLI's main path reads the
#: flagship's Laplacian (nx = NX) from a .mtx file; the cycle after which
#: 14b dumps and 14c stops the device loop (half a solve's cycles where
#: a solve takes fewer); 14d's CG + IC(0) shift-invert grid (float64) and
#: its LU pencil's size (the explicit inverse is n_pad^2, the reference's
#: limit too) and shift; the phase's wall limit, seconds
P14_CUT = 100
P14_SI_NX = 256
P14_PENCIL_N = 4096
P14_SIGMA = 25.0
P14_MAX_S = 180.0
#: 14e: each example's residual gate, relative to max(1, max |value|)
P14_EXAMPLE_RES = {"dssimp": 1e-3, "dnsimp": 1e-8, "dsdrv4_shift_invert":
                   1e-6, "zndrv1": 1e-8, "svd": 1e-8, "validate_f64": 1e-2,
                   "irregular_sparse": 1e-3}
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and FLOP/s outside
#: the tensor cores by accumulation dtype; its SMs (one block of the
#: reduced-space kernel runs on one)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"torch.float32": 67e12, "torch.float64": 34e12}
SMS = 132


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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
    row.update(zip(fns, timing.alternating_ms(list(fns.values()), flush)))
    if library is not None:
        row["host_us"] = timing.host_us(kernel)
        row["library_host_us"] = timing.host_us(library)
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
    ms = timing.alternating_ms([
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
    flush = timing.flush_buffer(dev) if timed else None
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
    rec["rotate_rows"]["err_c64"] = _rotate_complex(torch, cuda_rot, dev, g,
                                                    n, flush, rows_out)
    return rec, rows_out


def _rotate_complex(torch, cuda_rot, dev, g, n, flush, rows_out):
    """The rotation of a complex64 basis by a real Q (the Hermitian
    restart), which runs the kernel on the basis' real view, against the
    twin ``Q[:, :rows]^T V`` as a complex GEMM: every bucket, rows past it
    untouched, two calls bit-equal; timed at 16 rows.  Returns the largest
    error."""
    Vc = torch.complex(torch.randn(NCV, n, generator=g, device=dev),
                       torch.randn(NCV, n, generator=g, device=dev))
    Qm, _ = torch.linalg.qr(torch.randn(
        NCV, NCV, generator=torch.Generator().manual_seed(2),
        dtype=torch.float64))
    Q = Qm.to(device=dev, dtype=torch.float32).contiguous()
    err = 0.0
    for rows in ROWS:
        V1 = cuda_rot.rotate_rows(Q, Vc.clone(), rows)
        ref = Q[:, :rows].T.to(Vc.dtype) @ Vc
        err = max(err, _compare(torch, torch.view_as_real(V1[:rows]),
                                torch.view_as_real(ref), False,
                                f"rotate_rows complex64 rows={rows}"))
        if not torch.equal(V1[rows:], Vc[rows:]):
            raise AssertionError(f"rotate_rows complex64 rows={rows}: rows "
                                 "past the bucket changed")
        if not torch.equal(V1, cuda_rot.rotate_rows(Q, Vc.clone(), rows)):
            raise AssertionError(f"rotate_rows complex64 rows={rows}: two "
                                 "calls differ")
    if flush is not None:
        rows, Qc = JSON_ROWS, Q.to(Vc.dtype)
        row = _timed_row(
            torch, flush, "rotate_rows", "torch.complex64", rows,
            (NCV + rows) * n * 8 + NCV * rows * 4, 2 * NCV * rows * 2 * n,
            "torch.float32", lambda: cuda_rot.rotate_rows(Q, V1, rows),
            lambda: cuda_rot.rotate_rows_plain(
                Q, torch.view_as_real(V1).view(NCV, -1), rows),
            lambda: Qc[:, :rows].T @ Vc)
        row["name"] = "rotate_rows_c64"
        rows_out.append(row)
    return err


def check_word_events(torch, dev, n=N):
    """Phase 3, the event kernels as the selective loop launches them on
    every step: over all NCV rows, K read from device memory.  K = 0 leaves
    r bit for bit and s zero; every K 1..32 equals a call over the K rows
    alone bit for bit (s, r and the norm); then timed at K = 0 (a step
    without an event) and K = 8, 16, 24, 32 beside the twin and the
    library call."""
    from arpack_ng_tpu_torch.ops import cuda_sel

    g = torch.Generator(device=dev).manual_seed(7)
    V = torch.randn(NCV, n, generator=g, device=dev)
    br = torch.randn(n, generator=g, device=dev)
    r0 = torch.randn(n, generator=g, device=dev)
    idx = torch.randperm(NCV, generator=g, device=dev).to(torch.int32)
    coef = torch.randn(NCV, generator=g, device=dev)
    words = {K: torch.full((), K, dtype=torch.int32, device=dev)
             for K in range(NCV + 1)}
    if cuda_sel.sel_proj(idx, V, br, word=words[0]).any():
        raise AssertionError("sel_proj word 0 wrote a value")
    r = r0.clone()
    cuda_sel.sel_update(idx, coef, r, V, True, word=words[0])
    if not torch.equal(r, r0):
        raise AssertionError("sel_update word 0 changed r")
    err = {"sel_proj": 0.0, "sel_update": 0.0}
    for K in range(1, NCV + 1):
        sw = cuda_sel.sel_proj(idx, V, br, word=words[K])
        if not (torch.equal(sw[:K], cuda_sel.sel_proj(idx[:K], V, br))
                and not sw[K:].any()):
            raise AssertionError(f"sel_proj word {K} differs from K rows")
        err["sel_proj"] = max(err["sel_proj"], _compare(
            torch, sw, cuda_sel.sel_proj_plain(idx, V, br, words[K]), False,
            f"sel_proj word {K}"))
        rw, nw = cuda_sel.sel_update(idx, coef, r0.clone(), V, True,
                                     word=words[K])
        rh, nh = cuda_sel.sel_update(idx[:K], coef[:K].clone(), r0.clone(),
                                     V, True)
        if not (torch.equal(rw, rh) and torch.equal(nw, nh)):
            raise AssertionError(f"sel_update word {K} differs from K rows")
        err["sel_update"] = max(err["sel_update"], _compare(
            torch, rw, cuda_sel.sel_update_plain(idx, coef, r0.clone(), V,
                                                 False, words[K]), False,
            f"sel_update word {K}"))
    flush = timing.flush_buffer(dev)
    rows_out = []
    for K in (0,) + KS:
        w = words[K]
        idx_l = idx[:max(K, 1)].long()
        rows_out.append(_timed_row(
            torch, flush, "sel_proj_word", "torch.float32", K,
            K * n * 4 + n * 4 + K * 4, 2 * K * n, "torch.float32",
            lambda: cuda_sel.sel_proj(idx, V, br, word=w),
            lambda: cuda_sel.sel_proj_plain(idx, V, br, w),
            lambda: V.index_select(0, idx_l) @ br))
        rows_out.append(_timed_row(
            torch, flush, "sel_update_word", "torch.float32", K,
            K * n * 4 + 2 * n * 4 + K * 4, 2 * K * n + 2 * n,
            "torch.float32",
            lambda: cuda_sel.sel_update(idx, coef, r0, V, True, word=w),
            lambda: cuda_sel.sel_update_plain(idx, coef, r0, V, True, w),
            lambda: torch.addmv(r0, V.index_select(0, idx_l).T,
                                coef[:max(K, 1)], alpha=-1)))
    return err, rows_out


def _lanczos_tridiag(ncv=NCV, n=4096, seed=0):
    """T (diagonal, subdiagonal with rnorm last) of ncv Lanczos steps with
    full reorthogonalization on the flagship's spectrum (host, float64):
    the 2-D Laplacian's eigenvalues at nx = 64, from a random start."""
    rng = np.random.default_rng(seed)
    lam = _analytic_spectrum(64)[-n:]
    Vl = np.zeros((ncv + 1, n))
    v = rng.uniform(-1, 1, n)
    Vl[0] = v / np.linalg.norm(v)
    d, e = np.zeros(ncv), np.zeros(ncv)
    for j in range(ncv):
        w = lam * Vl[j]
        for _ in range(2):
            w -= Vl[:j + 1].T @ (Vl[:j + 1] @ w)
        d[j] = Vl[j] @ (lam * Vl[j])
        e[j] = np.linalg.norm(w)
        Vl[j + 1] = w / e[j]
    return d, e


def _sym_library(torch, T, rnorm, nev, np_eff):
    """The library form of one cycle's reduced space on the card (the
    yardstick, used nowhere in the port): ``torch.linalg.eigh`` (which
    checks its info on the host), the bounds, then ``np_eff``
    ``torch.linalg.qr`` steps with Q accumulated, as the host loop's
    numpy code runs them."""
    evals, S = torch.linalg.eigh(T)
    bounds = torch.abs(rnorm * S[-1])
    order = torch.argsort(evals, stable=True)
    shifts = evals[order][:np_eff]
    eye = torch.eye(T.shape[0], dtype=T.dtype, device=T.device)
    Tc, Q = T, eye
    for i in range(np_eff):
        q, _ = torch.linalg.qr(Tc - shifts[i] * eye)
        Tc = q.T @ Tc @ q
        Q = Q @ q
    torch.cuda.synchronize()
    return bounds, Q


def _sym_gaps(twin, other, d, ncv):
    """How far one reduced-space result lies from the twin's, in the units
    of ``SYM_LIMITS``: Ritz values and bounds, the new T and the residual's
    new part over T's scale; Q's kept columns and sigmak.  Also whether the
    packet's counts (done, nconv, nev_eff, np_eff) are equal."""
    from arpack_ng_tpu_torch.ops import cuda_sym_cycle as csc

    (ta, tb, tQ, tsk, tpk), (ka, kb, kQ, ksk, kpk) = twin, other
    scale = float(np.abs(d).max())
    k = int(tpk[csc.P_NEV])
    out = {"values": float(np.abs(kpk[csc.P_HEAD + 2 * ncv:]
                                  - tpk[csc.P_HEAD + 2 * ncv:]).max() / scale),
           "counts_equal": all(kpk[i] == tpk[i] for i in (
               csc.P_DONE, csc.P_NCONV, csc.P_NEV, csc.P_NP, csc.P_INFO))}
    if not tpk[csc.P_DONE]:
        out.update(
            T=float(max(np.abs(ka[:k] - ta[:k]).max(),
                        np.abs(kb[:k - 1] - tb[:k - 1]).max()) / scale),
            Q=float(np.abs(kQ[:, :k] - tQ[:, :k]).max()),
            sigmak=float(abs(ksk[0] - tsk[0])),
            resid=float(np.abs(ksk[1] * kQ[:, k] - tsk[1] * tQ[:, k]).max()
                        / scale))
    return out


def _sym_run(torch, csc, d, e, dt, where, p):
    ncv = d.shape[0]
    t = dict(dtype=dt, device=where)
    bufs = [torch.tensor(d, **t), torch.tensor(e, **t),
            torch.tensor(e[-1], **t),
            torch.tensor(-1, dtype=torch.int32, device=where),
            torch.tensor(0, dtype=torch.int32, device=where),
            torch.zeros(4, dtype=torch.int64, device=where),
            torch.zeros(ncv, ncv, **t), torch.zeros(2, **t),
            torch.zeros(csc.packet_size(ncv), dtype=torch.float64,
                        device=where)]
    csc.sym_cycle(*bufs, p, False)
    return [x.double().cpu().numpy() for x in
            (bufs[0], bufs[1], bufs[6], bufs[7], bufs[8])]


def check_sym_cycle(torch, dev, gpu):
    """Phase 3, the reduced-space kernel (``csrc/sym_cycle.cu``) against
    its numpy twin, for each ``which``, on Lanczos tridiagonals of the
    flagship's spectrum (four at ncv = 32, nev = 8, the workspace in shared
    memory, and one at the first ncv past it, the matrices in global
    memory, with the same 24 shifts), float32 (the flagship's) and
    float64: the counts equal and every gap within ``SYM_LIMITS``; then
    timed at ncv = 32, 'LA': the kernel device-only
    (each call after two copies restoring its inputs), the twin's host wall
    per call, and the library form's wall per call (``torch.linalg.eigh``
    + the QR loop on the card, with their syncs)."""
    from arpack_ng_tpu_torch.ops import cuda_sym_cycle as csc

    ncv = NCV
    err = {}
    row = None
    for dt in (torch.float32, torch.float64):
        f = np.finfo(np.float32 if dt == torch.float32 else np.float64)
        top = next(m for m in range(ncv, 1000)
                   if not csc.fits_shared(m + 1, dt.itemsize))
        over = []
        for m in (ncv, top + 1):
            lim = dict(SYM_LIMITS[str(dt)])
            if m > ncv:
                lim.update(SYM_LIMITS_GLOBAL[str(dt)])
            # past the shared-memory limit: nev = m - 24, the flagship's 24
            # exact shifts (a longer sweep of close shifts amplifies any two
            # QRs' rounding, the twin's included)
            worst = {}
            for which in csc.WHICH:
                p = csc.Params(which=which, nev=8 if m == ncv else m - 24,
                               tol=1e-5 if dt == torch.float32 else 1e-10,
                               eps23=float(f.eps ** (2 / 3)),
                               eps_m=float(f.eps))
                for seed in range(4 if m == ncv else 1):
                    d, e = _lanczos_tridiag(ncv=m, seed=seed)
                    kern = _sym_run(torch, csc, d, e, dt, dev, p)
                    twin = _sym_run(torch, csc, d, e, dt, torch.device("cpu"),
                                    p)
                    g = _sym_gaps(twin, kern, d, m)
                    if not g.pop("counts_equal"):
                        raise AssertionError(f"sym_cycle {dt} {which} seed "
                                             f"{seed} ncv {m}: counts differ")
                    for key, v in g.items():
                        worst[key] = max(worst.get(key, 0.0), v)
            print(f"  sym_cycle vs twin {dt} ncv={m}, largest gaps over every "
                  "which: " + ", ".join(f"{k} {v:.3e} (limit {lim[k]:.0e})"
                                         for k, v in worst.items()),
                  flush=True)
            over += [(m, k) for k, v in worst.items() if v > lim[k]]
            if m == ncv:
                err[str(dt)] = worst["Q"]
        if over:
            raise AssertionError(f"sym_cycle {dt}: kernel and twin differ "
                                 f"past the limits at {over}")
        p = csc.Params(which="LA", nev=8, tol=1e-5 if dt == torch.float32
                       else 1e-10, eps23=float(f.eps ** (2 / 3)),
                       eps_m=float(f.eps))
        if dt != torch.float32:
            continue
        d, e = _lanczos_tridiag(seed=0)
        t = dict(dtype=dt, device=dev)
        a0, b0 = torch.tensor(d, **t), torch.tensor(e, **t)
        bufs = [a0.clone(), b0.clone(), torch.tensor(e[-1], **t),
                torch.tensor(-1, dtype=torch.int32, device=dev),
                torch.tensor(0, dtype=torch.int32, device=dev),
                torch.zeros(4, dtype=torch.int64, device=dev),
                torch.zeros(ncv, ncv, **t), torch.zeros(2, **t),
                torch.zeros(csc.packet_size(ncv), dtype=torch.float64,
                            device=dev)]

        def kernel(clocks=None):
            bufs[0].copy_(a0)
            bufs[1].copy_(b0)
            csc.sym_cycle(*bufs, p, False, clocks=clocks)

        kernel()
        np_eff = int(bufs[8][csc.P_NP])
        cpu = [x.cpu() for x in bufs]
        host = [x.clone() for x in cpu]

        def twin():
            host[0].copy_(cpu[0])
            host[1].copy_(cpu[1])
            csc.sym_cycle_plain(*host, p, False)

        Td = torch.diag(a0) + torch.diag(b0[:-1], 1) + torch.diag(b0[:-1], -1)
        rn = b0[-1]
        walls = {}
        for name, fn in (("plain_ms", twin),
                         ("library_ms", lambda: _sym_library(
                             torch, Td, rn, 8, np_eff))):
            fn()
            ts = []
            for _ in range(timing.REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                ts.append((time.perf_counter() - t0) * 1e3)
            walls[name] = float(np.median(ts))
        ms = timing.alternating_ms([kernel], timing.flush_buffer(dev))[0]
        clocks = _sym_clocks(torch, csc, kernel, dev, np_eff)
        # operations this input needs: the QL sweeps (~60 ncv^2) and, per
        # shift, Q <- Q q (~ncv^3 for the Hessenberg q), forming q and the
        # three diagonals of q^T T q (~18 ncv^2)
        flops = 60 * ncv ** 2 + np_eff * (ncv ** 3 + 18 * ncv ** 2)
        bound = flops / (PEAK_FLOPS["torch.float32"] / SMS) * 1e3
        row = {"name": "sym_cycle", "dtype": "torch.float32", "shape": ncv,
               "ms": ms, "plain_ms": walls["plain_ms"],
               "library_ms": walls["library_ms"], "bound_ms": bound,
               "bound_by": "operations", "bytes": 0, "flops": flops,
               "bound_note": "operations over one SM's float32 rate (the "
                             "kernel is one block), not the card's roofline; "
                             "its limit is its dependent chains",
               "np_eff": np_eff, "clocks": clocks}
        print(f"  sym_cycle ncv={ncv} float32 ({np_eff} shifts): kernel "
              f"{ms:.4f} ms device-only, twin {walls['plain_ms']:.4f} ms "
              f"host, library (eigh + {np_eff} QR on the card, with syncs) "
              f"{walls['library_ms']:.4f} ms; bound {bound:.6f} ms "
              f"({flops} flops over one SM's float32 rate, "
              f"{100 * bound / ms:.2f}% of it); card {gpu}", flush=True)
        phases = ("ql", "head", "sweep", "tail")
        total = sum(clocks[k] for k in phases)
        print(f"  sym_cycle phase clocks (median of {timing.REPS} launches, "
              f"SM cycles of thread 0; ms = share of the device-only time): "
              + ", ".join(f"{k} {clocks[k]} ({100 * clocks[k] / total:.1f}%, "
                          f"{ms * clocks[k] / total:.4f} ms)"
                          for k in phases)
              + f"; total {total}; per shift (SM cycles, mean over the "
              f"{np_eff} shifts): start to start "
              f"{clocks['shift_start_gap']:.0f}, last entry to last entry "
              f"{clocks['shift_end_gap']:.0f}, start to last entry "
              f"{clocks['shift_span']:.0f} (the first shift, which waits on "
              f"no other, {clocks['first_span']:.0f}); Q warps after the "
              f"last entry "
              f"{clocks['q_after_last']:.0f}; card {gpu}", flush=True)
    return err, row


def _sym_clocks(torch, csc, kernel, dev, np_eff):
    """The reduced-space kernel's phase split: ``timing.REPS`` launches with
    a stamp buffer, the median SM cycles of each phase (QL, head, sweep,
    tail: the differences of consecutive stamps); and, from the sweep's
    per-shift stamps, the median over launches of: the mean gap between
    consecutive shifts' starts and between their last published entries,
    the mean span of one shift, and how long the Q warps ran on after the
    last shift's last entry."""
    ncv = NCV
    nc = len(csc.CLOCKS)
    clk = torch.zeros(csc.clock_size(ncv), dtype=torch.int64, device=dev)
    runs, sweep = [], []
    for _ in range(timing.REPS):
        kernel(clk)
        c = clk.cpu().numpy()
        runs.append(np.diff(c[:nc]))
        sh = c[nc:nc + 3 * ncv].reshape(ncv, 3)[:np_eff]
        qd = c[nc + 3 * ncv:nc + 4 * ncv][:np_eff]
        sweep.append([np.diff(sh[:, 0]).mean(), np.diff(sh[:, 2]).mean(),
                      (sh[:, 2] - sh[:, 0]).mean(), sh[0, 2] - sh[0, 0],
                      qd[-1] - sh[-1, 2]])
    med = np.median(np.array(runs), axis=0)
    out = {k: int(v) for k, v in zip(("ql", "head", "sweep", "tail"), med)}
    sw = np.median(np.array(sweep), axis=0)
    out.update({k: float(v) for k, v in zip(
        ("shift_start_gap", "shift_end_gap", "shift_span", "first_span",
         "q_after_last"),
        sw)})
    return out


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
    flush = timing.flush_buffer(dev) if timed else None
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
    flush = timing.flush_buffer(dev) if timed else None
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
    from arpack_ng_tpu_torch.ops import cuda_gather, cuda_psell, psell
    from arpack_ng_tpu_torch.ops.sparse import _to_ell, ell_matvec

    n = fem.shape[0]
    flush = timing.flush_buffer(dev) if timed else None
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
        extra = {"ell_ms": lambda: ell_matvec(cols, vals, xp)}
        if x.dtype == torch.float32:
            # the bare gather of ell_matvec beside take_flat on the same
            # columns (int32)
            cols32 = torch.from_numpy(cols_np).to(dev)
            if not torch.equal(cuda_gather.take_flat(xp, cols32), xp[cols]):
                raise AssertionError("take_flat differs from xp[cols] on the "
                                     "FEM's ELL columns")
            extra["gather_ms"] = lambda: xp[cols]
            extra["take_flat_ms"] = lambda: cuda_gather.take_flat(
                xp, cols32, check_range=False)
        row = _timed_row(
            torch, flush, "psell_matvec", str(x.dtype), pk.W,
            pk.nnz * (ab + 4) + 4 * ntiles + 4 * live + ptr_bytes
            + (n + pk.n_pad) * ab,
            2 * pk.nnz, str(x.dtype),
            lambda: cuda_psell.psell_matvec(tiles, x),
            lambda: cuda_psell.psell_matvec_plain(tiles, x),
            lambda: torch.mv(csr, x), extra=extra)
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
        if "take_flat_ms" in row:
            nel = cols_np.size
            tb = row["take_flat_bound_ms"] = _bound(
                4 * (2 * nel + pk.n_pad), 0, str(x.dtype))[0]
            print(f"  ELL columns ({cols_np.shape[0]} x {cols_np.shape[1]}, "
                  f"x of {pk.n_pad} values): bare gather xp[cols] (int64) "
                  f"{row['gather_ms']:.4f} ms, take_flat (int32) "
                  f"{row['take_flat_ms']:.4f} ms, bit-equal; take_flat's "
                  f"bound {tb:.4f} ms ({100 * tb / row['take_flat_ms']:.1f}% "
                  f"of it); card {gpu}", flush=True)
        del csr, cols, vals
    return err, rows_out


def _analytic_spectrum(nx: int) -> np.ndarray:
    h = 1.0 / (nx + 1)
    g = 2.0 - 2.0 * np.cos(np.pi * h * np.arange(1, nx + 1))
    return np.sort((g[:, None] + g[None, :]).ravel())


def check_values(vals, vecs, a_sp, spectrum, what, count=8):
    if len(vals) != count:
        raise AssertionError(f"{what}: {len(vals)} values returned, want "
                             f"{count}")
    pos = np.clip(np.searchsorted(spectrum, vals), 1, len(spectrum) - 1)
    dist = np.minimum(np.abs(spectrum[pos] - vals),
                      np.abs(spectrum[pos - 1] - vals))
    if np.any(dist > 1e-4 * np.abs(vals)):
        raise AssertionError(f"{what}: values off the analytic spectrum "
                             f"(max dist {dist.max():.3e})")
    if not np.isrealobj(vals):
        raise AssertionError(f"{what}: complex values returned")
    v64 = np.asarray(vecs, np.complex128 if np.iscomplexobj(vecs)
                     else np.float64)
    res = np.linalg.norm(a_sp @ v64 - v64 * vals[None, :], axis=0) \
        / np.abs(vals)
    if not np.all(np.isfinite(res)) or res.max() > 1e-3:
        raise AssertionError(f"{what}: residual {res.max():.3e} > 1e-3")
    return float(dist.max()), float(res.max())


def _loop_line(st) -> str:
    """The device loop's dispatch counters of a selective solve."""
    return (f"packets {st.packets} (cycles {st.n_iter}), graphs captured "
            f"{st.graphs_captured}, replayed {st.graph_replays}; launches "
            f"per replay by start k {st.replay_launches}")


def _in_band(st, what):
    lo, hi = SELECTIVE_BAND
    if not lo <= st.n_iter <= hi:
        raise AssertionError(f"{what}: {st.n_iter} cycles, outside the "
                             f"recorded band {lo}-{hi}")


def _kernel_counters(st, tag):
    """The gate of ``KERNEL_COUNTERS``: the solve's counters exactly."""
    want = KERNEL_COUNTERS[tag]
    got = (st.n_iter, st.nopx, st.nrorth)[:len(want)]
    if got != want:
        raise AssertionError(f"{tag}: counters {got}, want the reduced-space "
                             f"kernel's recorded {want}")


def flagship(torch, dev, gpu, nx=NX):
    """Phase 4: the selective flagship through ``eigsh`` (the main path:
    the device restart loop, extensions replayed as CUDA graphs, the
    reduced space as one kernel, one packet per cycle), its two witnesses,
    then ``reorth='dgks'`` (the host loop)."""
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.models import laplacian_2d

    small, _ = laplacian_2d(64, np.float32, device=dev)  # warm-up
    pt.eigsh(small, k=8, ncv=NCV, which="LA", tol=1e-5)
    op, a_sp = laplacian_2d(nx, np.float32, device=dev)
    spectrum = _analytic_spectrum(nx)
    kw = dict(k=8, ncv=NCV, which="LA", tol=1e-5, return_stats=True)
    (vals, vecs, out), wall, counts = _counted(
        torch, dev, SELECTIVE_PATH, lambda: pt.eigsh(op, **kw))
    dmax, rmax = check_values(vals, vecs, a_sp, spectrum,
                              "flagship selective")
    st = out.stats
    if st.packets != st.n_iter or st.graph_replays != st.n_iter - 1:
        raise AssertionError(f"flagship selective: {st.packets} packets, "
                             f"{st.graph_replays} replays for {st.n_iter} "
                             "cycles (want one packet per cycle, every "
                             "cycle after the first replayed)")
    steps = st.nopx - 1
    print(f"flagship reorth=selective: wall {wall:.4f} s "
          f"({wall * 1e3 / steps:.4f} ms per step), {_stats_line(st)}, "
          f"{5 * nx * nx * st.nopx / wall / 1e9:.4f} Gnnz/s; max value dist "
          f"{dmax:.2e}, max residual {rmax:.2e}; launches {counts}; card "
          f"{gpu}", flush=True)
    print(f"  device loop: {_loop_line(st)}", flush=True)
    print(f"  recorded (host loop): "
          f"{RECORDED_COUNTERS['flagship selective']}; the gate's band (the "
          f"seed sweep's span) {SELECTIVE_BAND[0]}-{SELECTIVE_BAND[1]} "
          f"cycles; the kernel's: {KERNEL_COUNTERS['flagship selective']}",
          flush=True)
    print(f"  values {np.array2string(vals, precision=7)}", flush=True)
    launches = {k: counts[k] for k in SELECTIVE_PATH}
    # the gates of the selective loop are held after every run has printed
    gates = [lambda: _in_band(st, "flagship selective"),
             lambda: _kernel_counters(st, "flagship selective"),
             _reduced_witness(torch, dev, gpu, op, a_sp, spectrum, kw)]
    _sel_witness(torch, dev, gpu, op, a_sp, spectrum)

    (vals, vecs, out), wall, counts = _counted(
        torch, dev, ("rotate_rows",),
        lambda: pt.eigsh(op, reorth="dgks", **kw))
    dmax, rmax = check_values(vals, vecs, a_sp, spectrum, "flagship dgks")
    print(f"flagship reorth=dgks: wall {wall:.4f} s, "
          f"{_stats_line(out.stats)}, "
          f"{5 * nx * nx * out.stats.nopx / wall / 1e9:.4f} Gnnz/s; max value "
          f"dist {dmax:.2e}, max residual {rmax:.2e}; launches {counts}; "
          f"card {gpu}", flush=True)
    print(f"  recorded: {RECORDED_COUNTERS['flagship dgks']}", flush=True)
    print(f"  values {np.array2string(vals, precision=7)}", flush=True)
    for gate in gates:
        gate()
    return launches


def _host_sym_cycle(*args):
    """The reduced space as the host loop computed it: the kernel's
    buffers copied to the host, its numpy twin, the results copied back."""
    from arpack_ng_tpu_torch.ops import cuda_sym_cycle as csc

    bufs, (p, is_last) = args[:9], args[9:]
    cpu = [t.cpu() for t in bufs]
    csc.sym_cycle_plain(*cpu, p, is_last)
    for i in (0, 1, 6, 7, 8):  # a, b, Q, sk, packet
        bufs[i].copy_(cpu[i])


def _reduced_witness(torch, dev, gpu, op, a_sp, spectrum, kw):
    """The selective solve again with the reduced space on the host as
    before (the loop's reduced-space call patched to the numpy twin on
    host copies): every other piece of the loop is the main path's, so it
    must repeat the host loop's counters exactly.  Its launches are not
    the main path's.  Returns its gate."""
    from unittest import mock

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core import device_sym

    with mock.patch.object(device_sym, "sym_cycle", _host_sym_cycle):
        (vals, vecs, out), wall, counts = _counted(
            torch, dev, (), lambda: pt.eigsh(op, **kw))
    dmax, rmax = check_values(vals, vecs, a_sp, spectrum,
                              "flagship selective witness, host reduced")
    st = out.stats
    got = (st.n_iter, st.nopx, st.nrorth)
    print(f"  witness, reduced space on the host: wall {wall:.4f} s, "
          f"{_stats_line(st)}; {_loop_line(st)}; max value dist {dmax:.2e}, "
          f"max residual {rmax:.2e}; sym_cycle launches "
          f"{counts['sym_cycle']}; card {gpu}", flush=True)

    def gate():
        if got != HOST_LOOP_COUNTERS:
            raise AssertionError(f"host-reduced witness: cycles/nopx/nrorth "
                                 f"{got}, want the host loop's "
                                 f"{HOST_LOOP_COUNTERS}")

    return gate


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
    from arpack_ng_tpu_torch.ops import (cuda_cgs, cuda_dia, cuda_gather,
                                         cuda_psell, cuda_rot, cuda_sel,
                                         cuda_sym_cycle)

    every = (cuda_sel.sel_proj, cuda_sel.sel_update, cuda_rot.rotate_rows,
             cuda_cgs.cgs_proj, cuda_cgs.cgs_update, cuda_dia.dia_matvec,
             cuda_dia.dia_block_matvec, cuda_psell.psell_matvec,
             cuda_gather.take_flat, cuda_gather.take_lanes,
             cuda_sym_cycle.sym_cycle)
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
            ("(a) eigsh(A_csr)", ("dia_matvec", "sym_cycle"),
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
        if out.stats.packets:
            print(f"  device loop: {_loop_line(out.stats)}", flush=True)
        print(f"  recorded: {RECORDED_COUNTERS[tag[:3]]}", flush=True)
        if tag[:3] in KERNEL_COUNTERS:
            print(f"  the kernel's: {KERNEL_COUNTERS[tag[:3]]}", flush=True)
            _kernel_counters(out.stats, tag[:3])
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


def _gather_cases(torch, cuda_gather, inp, x_off):
    """Both gather kernels against their twins, bit for bit: ``take_flat``
    with the probe's indices and 0 and n - 1 written in at both ends, tails
    of 1-3 past the last 16-byte word, an index buffer one value in (single
    values) and x 4 bytes past a 16-byte boundary; ``take_lanes`` at the
    probe's rows and at 5 rows."""
    from arpack_ng_tpu_torch.bench.gather_primitives import N, W

    X2 = inp["X2"]
    cols = inp["cols2"].clone()
    flat = cols.view(-1)
    flat[:2], flat[-2:] = torch.tensor([0, N - 1]), torch.tensor([N - 1, 0])
    lidx = inp["lidx"].clone()
    lidx[0, :2], lidx[-1, -2:] = torch.tensor([0, W - 1]), \
        torch.tensor([W - 1, 0])
    for where, x in (("aligned x", X2), ("x one value in", x_off)):
        for what, c in (("boundary indices", cols), ("tail 1", flat[:1]),
                        ("tail 3", flat[:1003]),
                        ("misaligned", flat[1:4098])):
            if not torch.equal(cuda_gather.take_flat(x, c),
                               cuda_gather.take_flat_plain(x, c)):
                raise AssertionError(f"take_flat ({where}, {what}) differs "
                                     "from its twin")
    for r in (lidx.shape[0], 5):
        if not torch.equal(cuda_gather.take_lanes(X2[:r], lidx[:r]),
                           cuda_gather.take_lanes_plain(X2[:r], lidx[:r])):
            raise AssertionError(f"take_lanes ({r} rows) differs from its "
                                 "twin")
    return {"take_flat": 0.0, "take_lanes": 0.0}


def check_gather(torch, dev, gpu):
    """Phase 8: the gather kernels bit-equal to their twins; ``take_flat``
    at the probe's shape and ``take_lanes`` at the probe's 2048 rows and at
    16384 (8 MiB per operand, where bytes and not the launch set the time),
    each timed beside its twin, its library call and the empty kernel (the
    harness's launch floor, ``floor_ms``), all in one alternation; then the
    gather probe's six forms once, with every kernel launch counted.
    Returns ``(errs, rows, launches)``."""
    from arpack_ng_tpu_torch.bench import gather_primitives as gp
    from arpack_ng_tpu_torch.ops import cuda_gather

    inp = gp.make_inputs(dev)
    x_off = torch.empty(gp.N + 1, device=dev)[1:]
    x_off.copy_(inp["x"])
    errs = _gather_cases(torch, cuda_gather, inp, x_off)
    flush = timing.flush_buffer(dev)
    X2, x, cols, cols2, lidx = (inp[k] for k in ("X2", "x", "cols", "cols2",
                                                 "lidx"))
    rng = np.random.default_rng(1)
    rows16 = 16 * 1024
    X16 = torch.from_numpy(rng.standard_normal(
        (rows16, gp.W)).astype(np.float32)).to(dev)
    lidx16 = torch.from_numpy(rng.integers(
        0, gp.W, (rows16, gp.W)).astype(np.int32)).to(dev)
    if not torch.equal(cuda_gather.take_lanes(X16, lidx16),
                       cuda_gather.take_lanes_plain(X16, lidx16)):
        raise AssertionError(f"take_lanes ({rows16} rows) differs from its "
                             "twin")
    floor = {"floor_ms": lambda: cuda_gather.noop(dev)}
    rows = [
        _timed_row(torch, flush, "take_flat", "torch.float32", cols2.shape[0],
                   4 * (2 * gp.NEL + gp.N), 0, "torch.float32",
                   lambda: cuda_gather.take_flat(X2, cols2,
                                                 check_range=False),
                   lambda: cuda_gather.take_flat_plain(X2, cols2),
                   lambda: x.index_select(0, cols), extra=floor)]
    for Xr, lr in ((X2, lidx), (X16, lidx16)):
        rows.append(_timed_row(
            torch, flush, "take_lanes", "torch.float32", lr.shape[0],
            4 * 3 * lr.numel(), 0, "torch.float32",
            lambda Xr=Xr, lr=lr: cuda_gather.take_lanes(Xr, lr,
                                                        check_range=False),
            lambda Xr=Xr, lr=lr: cuda_gather.take_lanes_plain(Xr, lr),
            lambda Xr=Xr, lr=lr: torch.gather(Xr, 1, lr), extra=floor))
    print(f"gather kernels vs twins at n={gp.N}, {gp.NEL} elements; "
          f"take_lanes also at {rows16} rows (device-only median of "
          f"{timing.REPS} in alternation with the empty kernel, L2 flushed "
          f"by a read; card {gpu}):", flush=True)
    _print_rows(rows)
    print(f"gather probe, six forms (card {gpu}):", flush=True)
    _, wall, counts = _counted(torch, dev, ("take_flat", "take_lanes"),
                               lambda: gp.run(dev))
    launches = {k: counts[k] for k in ("take_flat", "take_lanes")}
    print(f"  probe wall {wall:.2f} s; launches {launches}", flush=True)
    return errs, rows, launches


def check_nonsym(vals, vecs, a_sp, what, counted=True):
    """8 or 9 values (a conjugate pair is never split; ``counted=False``:
    any number), closed under conjugation, every residual ||Av - lambda v||
    / |lambda| <= 1e-3 (scipy CSR, float64, complex vectors)."""
    if counted and len(vals) not in (8, 9):
        raise AssertionError(f"{what}: {len(vals)} values returned, want 8 "
                             "or 9")
    for v in vals[vals.imag != 0]:
        if np.min(np.abs(vals - np.conj(v))) > 1e-12 * abs(v):
            raise AssertionError(f"{what}: the conjugate of {v} is missing")
    v = np.asarray(vecs, np.complex128)
    res = np.linalg.norm(a_sp @ v - v * vals[None, :], axis=0) \
        / np.abs(vals)
    if not np.all(np.isfinite(res)) or res.max() > 1e-3:
        raise AssertionError(f"{what}: residual {res.max():.3e} > 1e-3")
    return float(res.max())


def eigs_cycles(torch, dev, gpu, nx=EIGS_NX):
    """Phase 9a: the reference's timing protocol for the non-symmetric
    driver (bench_nonsym.py --fused): 2 warm cycles, then 20 timed cycles
    at tol = 1e-30, then one more extension and the basis defect."""
    from arpack_ng_tpu_torch.config import IRAMConfig
    from arpack_ng_tpu_torch.core.arnoldi import make_init
    from arpack_ng_tpu_torch.core.device_realnonsym import (
        make_realnonsym_head, make_realnonsym_tail)
    from arpack_ng_tpu_torch.models import convection_diffusion_2d

    op, _ = convection_diffusion_2d(nx, dtype=np.float32, device=dev)
    cfg = IRAMConfig(n=op.n, nev=8, ncv=NCV, which="LM", symmetric=False,
                     dtype=np.dtype(np.float32), n_pad=op.n_pad, tol=1e-30,
                     max_iter=10_000)
    head, tail = make_realnonsym_head(op, cfg), make_realnonsym_tail(op, cfg)

    def cycles(state, m, last=False):
        for i in range(m):
            state = tail(head(state), last and i == m - 1).state
        return state

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def run():
        state = cycles(make_init(op, cfg)(), 2)
        sync()
        c0, t0 = state.counts, time.perf_counter()
        state = cycles(state, 20)
        sync()
        return state, c0, time.perf_counter() - t0

    (state, c0, wall), _, counts = _counted(torch, dev, ("rotate_rows",), run)
    state = cycles(state, 1, last=True)  # a full factorization
    V = state.V.double()
    eye = torch.eye(NCV, dtype=torch.float64, device=dev)
    defect = float((V @ V.T - eye).abs().max())
    bound = 64 * float(np.sqrt(np.finfo(np.float32).eps))
    c = state.counts
    print(f"eigs (a) conv-diff nx={nx} float32, 20 cycles after 2: "
          f"{wall * 1e3 / 20:.4f} ms/cycle (wall {wall:.4f} s; nopx "
          f"{c.nopx - c0.nopx}, nrorth {c.nrorth - c0.nrorth}, nitref "
          f"{c.nitref - c0.nitref}, nrotr {c.nrotr - c0.nrotr} over the 20 "
          f"and the last extension); basis defect {defect:.4e} (bound "
          f"{bound:.4e}); launches {counts}; card {gpu}", flush=True)
    if not defect <= bound:
        raise AssertionError(f"eigs basis defect {defect:.3e} > {bound:.3e}")


def eigs_solves(torch, dev, gpu, nx=EIGS_SOLVE_NX, device=None):
    """Phase 9b-c: solves to tol = 1e-5 through ``eigs``, on the stencil
    operator and on its scipy CSR matrix (DIA, CGS kernels; imported on the
    default device, ``device=None``), under the gates of
    :func:`check_nonsym`.  Returns the launches of (b) and the values of
    (b) and (c) by tag."""
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.models import convection_diffusion_2d

    op, a_sp = convection_diffusion_2d(nx, dtype=np.float32, device=dev)
    kw = dict(k=8, ncv=NCV, which="LM", tol=1e-5,
              maxiter=EIGS_MAX_RESTARTS, return_stats=True)
    launches, found = {}, {}
    for tag, need, fn in (
            ("(b) eigs(op)", ("rotate_rows",), lambda: pt.eigs(op, **kw)),
            ("(c) eigs(A_csr), cgs_kernel='pallas'",
             ("rotate_rows", "cgs_proj", "cgs_update", "dia_matvec"),
             lambda: pt.eigs(a_sp, dtype=np.float32, cgs_kernel="pallas",
                             device=device, **kw))):
        (vals, vecs, out), wall, counts = _counted(torch, dev, need, fn)
        print(f"eigs {tag} conv-diff nx={nx}: wall {wall:.4f} s, "
              f"{_stats_line(out.stats)}; {len(vals)} values, extraction "
              f"info {out.info}; launches {counts}; card {gpu}", flush=True)
        print(f"  values {np.array2string(vals, precision=8)}", flush=True)
        rmax = check_nonsym(vals, vecs, a_sp, f"eigs {tag}")
        print(f"  max residual {rmax:.2e}", flush=True)
        if not launches:
            launches = {k: counts[k] for k in need}
        found[tag[:3]] = vals
    return launches, found


def _hermitian_operator(nx, c=HERM_C):
    """Phase 10c's test input: ``A = T_c (x) I + I (x) T_0`` (scipy CSR,
    complex128), ``T_c = tridiag(-1 - ic, 2, -1 + ic)``, ``T_0 =
    tridiag(-1, 2, -1)``, and its analytic spectrum, ascending:
    ``4 - 2 sqrt(1 + c^2) cos(j pi h) - 2 cos(k pi h)``, h = 1/(nx + 1)."""
    import scipy.sparse as sp

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


def _set_gap(got, ref) -> float:
    """The largest relative distance from a value of ``got`` to its own
    (distinct) value of ``ref``: how far ``got`` is from lying among
    ``ref`` as sets (``ref`` may hold one more, a conjugate partner that
    the real driver keeps at the boundary)."""
    free = list(range(len(ref)))
    worst = 0.0
    for v in got:
        i = min(free, key=lambda j: abs(ref[j] - v))
        free.remove(i)
        worst = max(worst, abs(ref[i] - v) / abs(v))
    return worst


def _convdiff_top(nx, rho=100.0) -> float:
    """The largest eigenvalue of ``convection_diffusion_2d(nx, rho)``,
    which is real: ``4 + 2 sqrt(1 - c^2) cos(pi h) + 2 cos(pi h)``,
    c = rho h / 2 < 1."""
    h = 1.0 / (nx + 1)
    c = rho * h / 2.0
    return 4.0 + (2.0 * np.sqrt(1.0 - c * c) + 2.0) * np.cos(np.pi * h)


def new_paths(torch, dev, gpu, vals_9, nx=NX, eigs_nx=EIGS_NX,
              cd_nx=EIGS_SOLVE_NX):
    """Phase 10: the hybrid driver and complex dtypes at full width (see
    the module docstring).  Returns each path's kernel launches."""
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.models import (convection_diffusion_2d,
                                            laplacian_2d)

    t0 = time.perf_counter()
    paths = {}
    kw = dict(k=8, ncv=NCV, tol=1e-5, return_stats=True)

    # (a) the flagship through the hybrid driver
    op, a_sp = laplacian_2d(nx, np.float32, device=dev)
    tag = "10a eigsh(flagship, strategy='hybrid')"
    (vals, vecs, out), wall, counts = _counted(
        torch, dev, ("sel_proj", "sel_update", "rotate_rows"),
        lambda: pt.eigsh(op, which="LA", strategy="hybrid", **kw))
    dmax, rmax = check_values(vals, vecs, a_sp, _analytic_spectrum(nx), tag)
    st = out.stats
    print(f"{tag}: wall {wall:.4f} s ({wall * 1e3 / st.n_iter:.4f} ms per "
          f"cycle), {_stats_line(st)}; max value dist {dmax:.2e}, max "
          f"residual {rmax:.2e}; launches {counts}; card {gpu}", flush=True)
    print(f"  values {np.array2string(vals, precision=7)}", flush=True)
    paths["10a"] = counts
    del op, vecs

    # (b) eigs on the conv-diff cell at nx = 1024, the hybrid driver
    op, a_sp = convection_diffusion_2d(eigs_nx, dtype=np.float32, device=dev)
    tag = (f"10b eigs(conv-diff nx={eigs_nx}, strategy='hybrid', "
           "cgs_kernel='pallas')")
    (vals, vecs, out), wall, counts = _counted(
        torch, dev, ("rotate_rows", "cgs_proj", "cgs_update"),
        lambda: pt.eigs(op, which="LM", strategy="hybrid",
                        cgs_kernel="pallas", maxiter=P10_MAX_RESTARTS, **kw))
    st = out.stats
    print(f"{tag}: wall {wall:.4f} s ({wall * 1e3 / st.n_iter:.4f} ms per "
          f"cycle), {_stats_line(st)}; {len(vals)} values, extraction info "
          f"{out.info}; launches {counts}; card {gpu}", flush=True)
    print(f"  values {np.array2string(vals, precision=8)}", flush=True)
    rmax = check_nonsym(vals, vecs, a_sp, tag, counted=False)
    print(f"  max residual {rmax:.2e}; the fused real driver's float32 "
          f"reduced space returned 6 here (info -14); the hybrid's float64 "
          f"one returns {len(vals)} (info {out.info})", flush=True)
    paths["10b"] = counts
    del op, vecs

    # (c) a complex Hermitian operator through both drivers
    a_h, spectrum = _hermitian_operator(nx)
    op = pt.from_scipy(a_h, dtype=np.complex64, hermitian=True, device=dev)
    if op.format != "dia" or op.dtype != np.complex64:
        raise AssertionError(f"10c: imported as {op.format} {op.dtype}, "
                             "want dia complex64")
    found = {}
    for strategy, need in (("auto", ("rotate_rows", "sym_cycle")),
                           ("hybrid", ("rotate_rows",))):
        tag = f"10c eigsh(Hermitian nx={nx} complex64, strategy={strategy!r})"
        (vals, vecs, out), wall, counts = _counted(
            torch, dev, need,
            lambda: pt.eigsh(op, which="LA", strategy=strategy, **kw))
        dmax, rmax = check_values(vals, vecs, a_h, spectrum, tag)
        st = out.stats
        print(f"{tag}: wall {wall:.4f} s, {_stats_line(st)}; max value dist "
              f"{dmax:.2e}, max residual {rmax:.2e}; launches {counts}; card "
              f"{gpu}", flush=True)
        if st.packets:
            print(f"  device loop: {_loop_line(st)}", flush=True)
        print(f"  values {np.array2string(vals, precision=7)}", flush=True)
        paths[f"10c {strategy}"] = counts
        found[strategy] = vals
        del vecs
    _hermitian_witness(torch, dev, gpu, op, a_h, spectrum, kw)
    del op, a_h

    # (d) complex eigs by default (the hybrid driver), cut to nx = 512
    op, a_sp = convection_diffusion_2d(cd_nx, dtype=np.complex64,
                                       device=dev)
    tag = f"10d eigs(conv-diff nx={cd_nx} complex64, strategy='auto')"
    (vals, vecs, out), wall, counts = _counted(
        torch, dev, (), lambda: pt.eigs(op, which="LM",
                                        maxiter=P10_MAX_RESTARTS, **kw))
    st = out.stats
    print(f"{tag}: wall {wall:.4f} s ({wall * 1e3 / st.n_iter:.4f} ms per "
          f"cycle), {_stats_line(st)}; {len(vals)} values, extraction info "
          f"{out.info}; launches {counts}; card {gpu}", flush=True)
    print(f"  values {np.array2string(vals, precision=8)}", flush=True)
    v = np.asarray(vecs, np.complex128)
    res = np.linalg.norm(a_sp @ v - v * vals[None, :], axis=0) / np.abs(vals)
    if len(vals) != 8 or not np.all(np.isfinite(res)) or res.max() > 1e-3:
        raise AssertionError(f"{tag}: {len(vals)} values, max residual "
                             f"{res.max():.3e}")
    # the operator's spectrum is real; float32 pairs converged by residual
    # lie in its pseudospectrum, so the two drivers' value sets (and 9b's
    # and 9c's) are reported, not held, against each other
    top = _convdiff_top(cd_nx)
    print(f"  max residual {res.max():.2e}; as a set among 9b's values "
          f"within {_set_gap(vals, vals_9['(b)']):.3e} relative (9c among "
          f"9b's: {_set_gap(vals_9['(c)'], vals_9['(b)']):.3e}); above the "
          f"real spectrum's top {top:.8f} by {vals.real.max() - top:.3e} "
          f"(9b {vals_9['(b)'].real.max() - top:.3e})", flush=True)
    paths["10d"] = counts

    elapsed = time.perf_counter() - t0
    print(f"phase 10: {elapsed:.2f} s (limit {P10_MAX_S:.0f} s); 10c "
          f"'auto' and 'hybrid' values within "
          f"{np.abs(found['auto'] - found['hybrid']).max():.3e}", flush=True)
    if elapsed > P10_MAX_S:
        raise AssertionError(f"phase 10 took {elapsed:.1f} s")
    return paths


def _hermitian_witness(torch, dev, gpu, op, a_h, spectrum, kw):
    """Phase 10c's 'auto' solve again with the reduced space on the host
    (the numpy twin of the kernel, as phase 4's witness): how far the
    kernel's rounding alone moves its cycles on this spectrum.  Same value
    gates; the launches are not the path's."""
    from unittest import mock

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core import device_sym

    with mock.patch.object(device_sym, "sym_cycle", _host_sym_cycle):
        (vals, vecs, out), wall, _ = _counted(
            torch, dev, (), lambda: pt.eigsh(op, which="LA", **kw))
    dmax, rmax = check_values(vals, vecs, a_h, spectrum,
                              "10c witness, reduced space on the host")
    print(f"  witness, reduced space on the host: wall {wall:.4f} s, "
          f"{_stats_line(out.stats)}; max value dist {dmax:.2e}, max "
          f"residual {rmax:.2e}; card {gpu}", flush=True)


def _complex_residuals(vals, vecs, a_sp, what, closed=False) -> float:
    """Every residual ``||Av - lambda v|| / |lambda| <= 1e-3`` (complex128,
    host); ``closed``: each value but the last (a complex driver may cut a
    pair at k) has its conjugate among the values within 1e-3 relative."""
    v = np.asarray(vecs, np.complex128)
    res = np.linalg.norm(a_sp @ v - v * vals[None, :], axis=0) / np.abs(vals)
    if not len(vals) or not np.all(np.isfinite(res)) or res.max() > 1e-3:
        raise AssertionError(f"{what}: {len(vals)} values, residuals {res}")
    for x in vals[:-1] if closed else ():
        if np.min(np.abs(vals - np.conj(x))) > 1e-3 * abs(x):
            raise AssertionError(f"{what}: the conjugate of {x} is missing")
    return float(res.max())


def _fused_eigs(torch, dev, gpu, tag, make, need, closed, nx, cut_nx):
    """11a-b: one ``eigs(strategy='fused')`` solve at ``nx`` under
    :func:`_complex_residuals`; with fewer than 8 values there, the same at
    ``cut_nx`` gated on 8.  ``make(nx) -> (A, a_sp)``.  Returns the
    launches at ``nx``."""
    import arpack_ng_tpu_torch as pt

    kw = dict(k=8, ncv=NCV, tol=1e-5, which="LM", strategy="fused",
              maxiter=P11_MAX_RESTARTS, return_stats=True, device=dev)
    launches = None
    for grid in (nx, cut_nx):
        A, a_sp = make(grid)
        what = f"{tag} nx={grid}"
        (vals, vecs, out), wall, counts = _counted(
            torch, dev, need, lambda: pt.eigs(A, **kw))
        st = out.stats
        print(f"{what}: wall {wall:.4f} s ({wall * 1e3 / st.n_iter:.4f} ms "
              f"per cycle), {_stats_line(st)}; {len(vals)} values, "
              f"extraction info {out.info}; launches {counts}; card {gpu}",
              flush=True)
        print(f"  values {np.array2string(vals, precision=8)}", flush=True)
        rmax = _complex_residuals(vals, vecs, a_sp, what, closed)
        print(f"  max residual {rmax:.2e}", flush=True)
        launches = launches or counts
        del A, vecs
        if len(vals) == 8:
            return launches
        if grid == cut_nx:
            raise AssertionError(f"{what}: {len(vals)} values, want 8")
        print(f"  {len(vals)} of 8 at nx={grid}: the complex64 reduced "
              f"space counts converged values the float64 re-test of the "
              f"extraction does not (info {out.info}), as the reference's "
              f"does; the count is gated at nx={cut_nx}", flush=True)
    return launches


def _complexify_cost(torch, dev, gpu, A, a_sp):
    """11a's complexified matvec beside the DIA kernel's two launches on
    contiguous real and imaginary parts and the split alone (device-only,
    in alternation); equal to two twin products bit for bit."""
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core.device_nonsym import (complexify_operator,
                                                        split_complex)
    from arpack_ng_tpu_torch.ops import cuda_dia, sparse

    op = pt.from_scipy(A, dtype=np.float32, device=dev)
    opc = complexify_operator(op)
    n = op.n
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.zeros(op.n_pad, dtype=torch.complex64, device=dev)
    x[:n] = torch.randn(n, generator=g, device=dev, dtype=torch.complex64)
    xy = split_complex(x)
    y, _ = opc.apply(x, x)
    offs, dtab = sparse.dia_table(A.astype(np.float32), op.n_pad)
    offs, dtab = torch.from_numpy(offs), torch.from_numpy(dtab).to(dev)
    for part, half in ((y.real, xy[0]), (y.imag, xy[1])):
        if not torch.equal(part, cuda_dia.dia_matvec_plain(offs, dtab, half,
                                                           n)):
            raise AssertionError("11a: complexified DIA product differs from "
                                 "the twin's")
    flush = timing.flush_buffer(dev)
    ms = timing.alternating_ms(
        [lambda: opc.apply(x, x),
         lambda: (op.apply(xy[0], xy[0]), op.apply(xy[1], xy[1])),
         lambda: split_complex(x)], flush)
    print(f"  complexified DIA matvec ({op.format}, {dtab.shape[0]} "
          f"diagonals, n={n}): {ms[0]:.4f} ms, of which two kernel launches "
          f"on contiguous parts {ms[1]:.4f} ms and the (2, n) split "
          f"{ms[2]:.4f} ms (device-only median of {timing.REPS}, "
          f"alternating; bit-equal to two twin products); card {gpu}",
          flush=True)


def mode1_paths(torch, dev, gpu, nx=NX, eigs_nx=EIGS_NX,
                cut_nx=P11_CUT_NX):
    """Phase 11: ``eigs(strategy='fused')``, ``restart='thick'``,
    ``select=``, ``shift_fn`` and ``eigs_realified`` at full width (see the
    module docstring).  Returns each path's kernel launches."""
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.models import (convection_diffusion_2d,
                                            laplacian_2d)
    from arpack_ng_tpu_torch.ops.realify import eigs_realified

    t0 = time.perf_counter()
    paths = {}

    # (a) real conv-diff as DIA through the complexified fused driver
    def csr(grid):
        a_sp = convection_diffusion_2d(grid, dtype=np.float32, device=dev)[1]
        return a_sp.astype(np.float32), a_sp

    paths["11a"] = _fused_eigs(
        torch, dev, gpu, "11a eigs(conv-diff A_csr, strategy='fused')",
        csr, ("dia_matvec",), True, eigs_nx, cut_nx)
    _complexify_cost(torch, dev, gpu, *csr(eigs_nx))

    # (b) the complex conv-diff stencil through the fused complex driver
    def stencil(grid):
        return convection_diffusion_2d(grid, dtype=np.complex64, device=dev)

    paths["11b"] = _fused_eigs(
        torch, dev, gpu, "11b eigs(conv-diff complex64, strategy='fused')",
        stencil, (), False, eigs_nx, cut_nx)

    # (c)-(d) the flagship: thick restart (and select=), caller's shifts
    op, a_sp = laplacian_2d(nx, np.float32, device=dev)
    spectrum = _analytic_spectrum(nx)
    kw = dict(k=8, ncv=NCV, tol=1e-5, which="LA", maxiter=P11_MAX_RESTARTS,
              return_stats=True)
    need = ("sel_proj", "sel_update", "rotate_rows")
    calls = []

    def shift_fn(ritz, bounds):
        calls.append(len(ritz))
        return ritz[np.argsort(-np.abs(bounds), kind="stable")]

    for path, tag, extra in (
            ("11c", "11c eigsh(flagship, restart='thick')",
             dict(restart="thick")),
            ("11d", "11d eigsh(flagship, shift_fn=f)",
             dict(shift_fn=shift_fn))):
        (vals, vecs, out), wall, counts = _counted(
            torch, dev, need, lambda: pt.eigsh(op, **extra, **kw))
        dmax, rmax = check_values(vals, vecs, a_sp, spectrum, tag)
        st = out.stats
        print(f"{tag}: wall {wall:.4f} s ({wall * 1e3 / st.n_iter:.4f} ms "
              f"per cycle), {_stats_line(st)}; max value dist {dmax:.2e}, "
              f"max residual {rmax:.2e}; launches {counts}; card {gpu}",
              flush=True)
        print(f"  values {np.array2string(vals, precision=7)}", flush=True)
        paths[path] = counts
        del vecs
        if path == "11c":
            found = vals
        elif len(calls) != st.n_iter - 1:
            raise AssertionError(f"{tag}: f called {len(calls)} times over "
                                 f"{st.n_iter - 1} restarts")
    mask = np.zeros(NCV, bool)
    mask[[0, 2, 5]] = True
    tag = "11c eigsh(flagship, restart='thick', select=[0, 2, 5])"
    (vals, vecs, out), wall, _ = _counted(
        torch, dev, need,
        lambda: pt.eigsh(op, restart="thick", select=mask, **kw))
    dmax, rmax = check_values(vals, vecs, a_sp, spectrum, tag, count=3)
    gap = max(np.min(np.abs(found - v)) / abs(v) for v in vals)
    if gap > 1e-6:
        raise AssertionError(f"{tag}: {vals} not among 11c's values")
    print(f"{tag}: wall {wall:.4f} s, {_stats_line(out.stats)}; values "
          f"{np.array2string(vals, precision=7)} (among 11c's within "
          f"{gap:.1e}), max value dist {dmax:.2e}, max residual "
          f"{rmax:.2e}; card {gpu}", flush=True)
    del op, vecs

    # (e) the complex conv-diff matrix realified: 2n rows, real DIA kernel
    a_sp = convection_diffusion_2d(cut_nx, dtype=np.complex64,
                                   device=dev)[1]
    tag = f"11e eigs_realified(conv-diff nx={cut_nx} complex64)"
    (vals, vecs), wall, counts = _counted(
        torch, dev, ("dia_matvec", "rotate_rows"),
        lambda: eigs_realified(a_sp.astype(np.complex64), k=8, which="LM",
                               tol=1e-5, ncv=NCV, maxiter=P11_MAX_RESTARTS,
                               device=dev))
    if len(vals) != 8:
        raise AssertionError(f"{tag}: {len(vals)} values recovered, want 8")
    rmax = _complex_residuals(vals, vecs, a_sp, tag)
    print(f"{tag}: wall {wall:.4f} s; {len(vals)} values, max residual "
          f"{rmax:.2e}; launches {counts}; card {gpu}", flush=True)
    print(f"  values {np.array2string(vals, precision=8)}", flush=True)
    paths["11e"] = counts

    elapsed = time.perf_counter() - t0
    print(f"phase 11: {elapsed:.2f} s (limit {P11_MAX_S:.0f} s)", flush=True)
    if elapsed > P11_MAX_S:
        raise AssertionError(f"phase 11 took {elapsed:.1f} s")
    return paths


def _gate_pairs(vals, vecs, a_sp, ref, rel, res_max, what, m_sp=None,
                count=None):
    """Every value within ``rel*|lambda|`` of a value of ``ref`` and every
    residual ``||A v - lambda M v|| / max(1, |lambda|) <= res_max``
    (float64 or complex128, on the host; ``M = I`` without ``m_sp``); at
    least ``count`` values.  Returns (max distance, max residual)."""
    vals, ref = np.asarray(vals), np.asarray(ref)
    if not len(vals) or (count is not None and len(vals) < count):
        raise AssertionError(f"{what}: {len(vals)} values returned")
    dist = np.array([np.min(np.abs(ref - x)) / abs(x) for x in vals])
    cplx = np.iscomplexobj(vals) or np.iscomplexobj(vecs)
    v = np.asarray(vecs, np.complex128 if cplx else np.float64)
    mv = m_sp @ v if m_sp is not None else v
    res = np.linalg.norm(a_sp @ v - mv * vals[None, :], axis=0) \
        / np.maximum(1.0, np.abs(vals))
    if not np.all(np.isfinite(res)) or dist.max() > rel \
            or res.max() > res_max:
        raise AssertionError(f"{what}: value distances {dist}, residuals "
                             f"{res} (gates {rel:.0e}, {res_max:.1e})")
    return float(dist.max()), float(res.max())


def _host_seconds(mod, name, sink):
    """Patch ``mod.name`` to append each call's host seconds to ``sink``."""
    from unittest import mock

    fn = getattr(mod, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            sink.append(time.perf_counter() - t0)

    return mock.patch.object(mod, name, timed)


def _iters(its) -> str:
    its = np.asarray(its)
    return (f"{len(its)} solves, iterations min / median / max {its.min()} "
            f"/ {np.median(its):g} / {its.max()} (total {its.sum()})")


def _cg_read_share(torch, dev, matvec, pc, b, its=P12_READ_ITS):
    """ms per CG iteration with the loop test's read (``solvers._cg`` at
    tol 0) and without it (``cg_start`` and ``its`` times ``cg_step``, one
    sync at the end), in turns (read, free, free, read, read, free), on
    the same right-hand side: the read's share is ``1 - free / read``."""
    from arpack_ng_tpu_torch.ops import solvers

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def with_reads():
        if solvers._cg(matvec, b, None, 0.0, its, pc)[1] != its:
            raise AssertionError("CG stopped before its iteration count")

    def read_free():
        c, _ = solvers.cg_start(matvec, b, None, 0.0, pc)
        for _ in range(its):
            c = solvers.cg_step(matvec, c, pc)

    times = ([], [])
    for i in (0, 1, 1, 0, 0, 1):
        sync()
        t0 = time.perf_counter()
        (with_reads, read_free)[i]()
        sync()
        times[i].append(time.perf_counter() - t0)
    return [float(np.median(t)) * 1e3 / its for t in times]


def _shift_invert_main(torch, dev, gpu, nx, need):
    """12a, the main path: ``eigsh`` on ``shift_invert_operator`` (mode 3,
    sigma = 0) of the 2-D Laplacian, each inner solve CG with the IC(0)
    preconditioner, the shifted product and both triangles DIA products.
    Returns the kernel launches."""
    import warnings

    import scipy.sparse as sp

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.models import laplacian_2d
    from arpack_ng_tpu_torch.ops import cuda_dia, solvers, transforms
    from arpack_ng_tpu_torch.ops.sparse import dia_table

    sigma, n = 0.0, nx * nx
    a_sp = laplacian_2d(nx, np.float64, device="cpu")[1]
    shifted = (a_sp - sigma * sp.identity(n)).tocsr()
    t0 = time.perf_counter()
    op_s = pt.from_scipy(shifted, format="dia", device=dev)
    t_dia = time.perf_counter() - t0
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        # a Jacobi fallback would leave the triangles out
        warnings.simplefilter("error")
        pc = solvers.ilu0_preconditioner(shifted, symmetric=True, sweeps=3,
                                         n_pad=op_s.n_pad, device=dev)
    t_ilu = time.perf_counter() - t0
    # the kernel on the preconditioner's table shapes (one sign of offset
    # each), bit-equal to its twin; not counted
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
    for tri in (sp.tril(shifted, -1), sp.triu(shifted, 1)):
        offs, tab = dia_table(tri.tocsr(), n)
        offs, tab = torch.from_numpy(offs).to(dev), torch.from_numpy(tab).to(
            dev)
        if not torch.equal(cuda_dia.dia_matvec(offs, tab, x, n),
                           cuda_dia.dia_matvec_plain(offs, tab, x, n)):
            raise AssertionError("12a: the DIA kernel differs from its twin "
                                 f"on a strict triangle {offs.tolist()}")
    solve = solvers.make_iterative_solve(
        op_s.a_apply, symmetric=True, tol=1e-10, maxiter=P12_CG_MAXITER,
        precond=pc)
    op = transforms.shift_invert_operator(
        n, np.float64, solve, sigma=sigma, mode=3, n_pad=op_s.n_pad,
        hermitian=True, a_apply=op_s.a_apply, device=dev)
    tag = f"12a eigsh(shift-invert sigma=0, CG + IC(0), nx={nx})"
    (vals, vecs, out), wall, counts = _counted(
        torch, dev, need("dia_matvec", "sym_cycle"),
        lambda: pt.eigsh(op, k=8, which="LM", ncv=NCV, tol=1e-8,
                         return_stats=True))
    its = np.asarray(solve.iterations)
    if its.max() >= P12_CG_MAXITER:
        raise AssertionError(f"{tag}: a CG solve ran to its cap")
    dmax, rmax = _gate_pairs(vals, vecs, a_sp, _analytic_spectrum(nx)[:256],
                             1e-6, 1e-6, tag, count=8)
    del vecs
    st = out.stats
    print(f"{tag}: wall {wall:.4f} s (host, not in it: from_scipy "
          f"{t_dia:.2f} s, ilu0_preconditioner {t_ilu:.2f} s); "
          f"{_stats_line(st)}; CG: {_iters(its)}, "
          f"{wall * 1e3 / its.sum():.4f} ms per CG iteration (the solve's "
          f"wall over its CG iterations); max value dist {dmax:.2e}, max "
          f"residual {rmax:.2e}; launches {counts} "
          f"({counts['dia_matvec'] / its.sum():.2f} DIA per CG iteration); "
          f"card {gpu}", flush=True)
    print(f"  values {np.array2string(vals, precision=10)}", flush=True)
    b = torch.zeros(op_s.n_pad, dtype=torch.float64, device=dev)
    b[:n] = x
    ms_read, ms_free = _cg_read_share(torch, dev, op_s.a_apply, pc, b)
    print(f"  CG iteration: {ms_read:.4f} ms with the loop test's read, "
          f"{ms_free:.4f} ms without (median of 3 runs of {P12_READ_ITS} "
          f"iterations in turns): the read's share "
          f"{100 * (1 - ms_free / ms_read):.1f}%; card {gpu}", flush=True)
    return counts


def _dsdrv_pencil(n):
    """dsdrv3-6's pencil ``K = tridiag(-1, 2, -1)/h``, ``M = tridiag(1, 4,
    1)h/6`` (h = 1/(n+1)) and its values ``(6/h^2)(1 - cos j pi h)/(2 + cos
    j pi h)``, ascending."""
    import scipy.sparse as sp

    h = 1.0 / (n + 1)
    k = (sp.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n)) / h).tocsr()
    m = (sp.diags([1.0, 4.0, 1.0], [-1, 0, 1], shape=(n, n))
         * (h / 6)).tocsr()
    th = np.arange(1, n + 1) * np.pi * h
    return k, m, np.sort(6 / h ** 2 * (1 - np.cos(th)) / (2 + np.cos(th)))


def _dense_modes(torch, dev, gpu, n, n2, need):
    """12b: ``eigsh(K, M=M, ...)`` through the built-in dense routes
    (the host factorization's explicit inverse, capturable: the device
    loop with graphs), modes 3-5 at ``n`` and mode 2 at ``n2``.  Returns
    each path's launches."""
    import scipy.sparse.linalg as spla

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.ops import transforms

    paths = {}
    cases = [(mode, n, dict(sigma=P12_SIGMA, mode=mode, tol=1e-10))
             for mode in ("normal", "buckling", "cayley")]
    cases.append(("mode 2", n2, dict(ncv=NCV, tol=1e-10, maxiter=2000)))
    for mode, dim, kw in cases:
        k, m, lam = _dsdrv_pencil(dim)
        v0 = np.random.default_rng(12).uniform(-1, 1, dim)
        tag = f"12b eigsh(K, M=M, {mode}, n={dim})"
        fact = []
        with _host_seconds(transforms, "_dense_inv", fact), \
                _host_seconds(transforms, "from_dense", fact):
            (vals, vecs, out), wall, counts = _counted(
                torch, dev, need("sym_cycle"),
                lambda: pt.eigsh(k, M=m, k=4, which="LM", v0=v0,
                                 return_stats=True, device=dev, **kw))
        note = ""
        if mode == "cayley":
            # a witness, not gated: ARPACK's own Cayley mode (scipy's
            # dsaupd/dseupd, the same pencil and start vector), whose
            # operator takes K v into the solve
            w, z = spla.eigsh(k.tocsc(), k=4, M=m.tocsc(), sigma=P12_SIGMA,
                              mode="cayley", which="LM", tol=1e-10, v0=v0)
            r_arpack = float(np.max(np.linalg.norm(
                k @ z - (m @ z) * w[None, :], axis=0) / np.maximum(1, w)))
            note = f" (ARPACK's on the host: {r_arpack:.2e})"
        dmax, rmax = _gate_pairs(vals, vecs, k, lam, 1e-8, 1e-8, tag,
                                 m_sp=m, count=4)
        del vecs
        print(f"{tag}: wall {wall:.4f} s, of which the host factorization "
              f"and inverse {sum(fact):.4f} s; {_stats_line(out.stats)}; "
              f"max value dist {dmax:.2e}, max residual {rmax:.2e}{note}; "
              f"launches {counts}; card {gpu}", flush=True)
        print(f"  values {np.array2string(vals, precision=10)}", flush=True)
        paths[f"12b {mode}"] = counts
    return paths


def _eigs_transforms(torch, dev, gpu, nx, bicg_nx, need):
    """12c: ``eigs`` shift-invert through the dense routes (a real shift,
    a complex shift on the real problem: the real part and Rayleigh
    quotients; the imaginary part, mode 4; complex128 with a complex
    shift) and matrix-free through BiCGSTAB with the ILU(0) preconditioner.
    Returns each path's launches."""
    import warnings

    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.models import convection_diffusion_2d
    from arpack_ng_tpu_torch.ops import solvers, transforms

    paths = {}
    a = convection_diffusion_2d(nx, rho=P12_RHO, dtype=np.float64,
                                device="cpu")[1]
    n = nx * nx
    kw = dict(k=6, ncv=NCV, tol=1e-10, return_stats=True)
    s_re, s_cx = P12_SHIFTS
    near = spla.eigs(a.tocsc(), k=60, sigma=s_re, return_eigenvectors=False)
    zshift = P12_ZSHIFT
    az = a.astype(np.complex128)
    cases = [
        ("real", f"eigs(sigma={s_re})", a, near,
         lambda: pt.eigs(a, sigma=s_re, device=dev, **kw)),
        ("complex shift", f"eigs(sigma={s_cx}), real part + Rayleigh",
         a, near,
         lambda: pt.eigs(a, sigma=s_cx, device=dev, **kw)),
        ("imag", f"eigs(build_nonsym_operator(M=I, sigma={s_cx}, "
         "part='imag'))", a, near,
         lambda: pt.eigs(transforms.build_nonsym_operator(
             a, M=sp.identity(n), sigma=s_cx, part="imag", device=dev),
             **kw)),
        ("complex128", f"eigs(complex128, sigma={zshift})", az,
         spla.eigs(az.tocsc(), k=60, sigma=zshift,
                   return_eigenvectors=False),
         lambda: pt.eigs(az, sigma=zshift, device=dev, **kw)),
    ]
    for key, what, mat, ref, run in cases:
        tag = f"12c {what}, nx={nx}"
        (vals, vecs, out), wall, counts = _counted(torch, dev, (), run)
        dmax, rmax = _gate_pairs(vals, vecs, mat, ref, 1e-8, 1e-8, tag,
                                 count=6)
        print(f"{tag}: wall {wall:.4f} s; {len(vals)} values, info "
              f"{out.info}; {_stats_line(out.stats)}; max value dist "
              f"{dmax:.2e} (scipy's 60 nearest), max residual {rmax:.2e}; "
              f"launches {counts}; card {gpu}", flush=True)
        print(f"  values {np.array2string(vals, precision=8)}", flush=True)
        paths[f"12c {key}"] = counts

    # matrix-free: BiCGSTAB with ILU(0), the DIA kernel for the product and
    # both triangles
    a = convection_diffusion_2d(bicg_nx, rho=P12_RHO, dtype=np.float64,
                                device="cpu")[1]
    n = bicg_nx * bicg_nx
    t0 = time.perf_counter()
    op_s = pt.from_scipy(a, format="dia", device=dev)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pc = solvers.ilu0_preconditioner(a, n_pad=op_s.n_pad, device=dev)
    t_host = time.perf_counter() - t0
    solve = solvers.make_iterative_solve(
        op_s.a_apply, symmetric=False, tol=1e-12, maxiter=P12_BICG_MAXITER,
        precond=pc)
    op = transforms.shift_invert_operator(
        n, np.float64, solve, sigma=0.0, mode=3, n_pad=op_s.n_pad,
        a_apply=op_s.a_apply, device=dev)
    tag = f"12c eigs(shift-invert sigma=0, BiCGSTAB + ILU(0), nx={bicg_nx})"
    (vals, vecs, out), wall, counts = _counted(
        torch, dev, need("dia_matvec"), lambda: pt.eigs(op, **kw))
    its = np.asarray(solve.iterations)
    if its.max() >= P12_BICG_MAXITER:
        raise AssertionError(f"{tag}: a BiCGSTAB solve ran to its cap")
    ref = spla.eigs(a.tocsc(), k=24, sigma=0.0, return_eigenvectors=False)
    dmax, rmax = _gate_pairs(vals, vecs, a, ref, 1e-8, 1e-6, tag, count=6)
    del vecs
    print(f"{tag}: wall {wall:.4f} s (host, not in it: from_scipy and "
          f"ilu0_preconditioner {t_host:.2f} s); {len(vals)} values; "
          f"{_stats_line(out.stats)}; BiCGSTAB: {_iters(its)}, "
          f"{wall * 1e3 / its.sum():.4f} ms per iteration; max value dist "
          f"{dmax:.2e} (scipy's 24 nearest), max residual {rmax:.2e}; "
          f"launches {counts}; card {gpu}", flush=True)
    paths["12c bicgstab"] = counts
    return paths


def _svds_full(torch, dev, gpu, shape, need):
    """12d: ``svds`` of a float32 ``A = U diag(s) V^T`` made on the card
    from seeded orthonormal factors (top eight singular values 10..3, the
    rest 1..0.01), through both methods.  Returns each path's launches."""
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.utils.precision import pin_full_precision

    pin_full_precision()
    m, n = shape
    s_true = np.concatenate([np.arange(10.0, 2.0, -1.0),
                             np.linspace(1.0, 0.01, n - 8)])
    g = torch.Generator(device=dev).manual_seed(12)
    t0 = time.perf_counter()
    u = torch.linalg.qr(torch.randn(m, n, generator=g, device=dev)).Q
    v = torch.linalg.qr(torch.randn(n, n, generator=g, device=dev)).Q
    A = (u * torch.from_numpy(s_true).float().to(dev)) @ v.T
    del u, v
    t_make = time.perf_counter() - t0
    want = s_true[:8][::-1]
    paths = {}
    for method in ("normal", "augmented"):
        tag = f"12d svds({m} x {n} float32, k=8, method='{method}')"
        (uu, s, vh), wall, counts = _counted(
            torch, dev, need("sym_cycle"),
            lambda: pt.svds(A, k=8, tol=1e-6, method=method, device=dev))
        err = float(np.max(np.abs(s - want) / want))
        vd = torch.from_numpy(vh.T.astype(np.float32)).to(dev)
        ud = torch.from_numpy(uu.astype(np.float32)).to(dev)
        sd = torch.from_numpy(s.astype(np.float32)).to(dev)
        r_u = float(((A @ vd - ud * sd).norm(dim=0) / sd).max())
        r_v = float(((A.T @ ud - vd * sd).norm(dim=0) / sd).max())
        if not err <= 1e-4 or not r_u <= 1e-3 or not r_v <= 1e-3:
            raise AssertionError(f"{tag}: s {s} (want {want}), rel err "
                                 f"{err:.2e}, ||Av - su||/s {r_u:.2e}, "
                                 f"||A^T u - sv||/s {r_v:.2e}")
        print(f"{tag}: wall {wall:.4f} s (A made in {t_make:.2f} s), "
              f"cycles {counts['sym_cycle']} (one reduced-space launch "
              f"each); max rel err of s {err:.2e}, max ||Av - su||/s "
              f"{r_u:.2e}, "
              f"||A^T u - sv||/s {r_v:.2e}; launches {counts}; card {gpu}",
              flush=True)
        paths[f"12d {method}"] = counts
    return paths


def transform_paths(torch, dev, gpu, nx=P12_NX, dense_n=P12_DENSE_N,
                    mode2_n=P12_MODE2_N, eigs_nx=P12_EIGS_NX,
                    bicg_nx=P12_BICG_NX, svd_shape=P12_SVD_SHAPE):
    """Phase 12: the spectral transforms, their linear solvers and
    ``svds`` at full width (see the module docstring).  Returns each
    path's kernel launches."""
    def need(*kernels):
        # a wrapper counts only the kernel launches a card makes
        return kernels if dev.type == "cuda" else ()

    t0 = time.perf_counter()
    paths = {"12a": _shift_invert_main(torch, dev, gpu, nx, need)}
    paths.update(_dense_modes(torch, dev, gpu, dense_n, mode2_n, need))
    paths.update(_eigs_transforms(torch, dev, gpu, eigs_nx, bicg_nx, need))
    paths.update(_svds_full(torch, dev, gpu, svd_shape, need))
    elapsed = time.perf_counter() - t0
    print(f"phase 12: {elapsed:.2f} s (limit {P12_MAX_S:.0f} s)", flush=True)
    if elapsed > P12_MAX_S:
        raise AssertionError(f"phase 12 took {elapsed:.1f} s")
    return paths


def _band(n, diags):
    """LAPACK band storage of the Toeplitz band ``{offset: value}`` (the
    helper of the reference's tests/test_bandsolve.py)."""
    kl, ku = -min(diags), max(diags)
    ab = np.zeros((kl + ku + 1, n))
    for d, v in diags.items():
        if d >= 0:
            ab[ku - d, d:] = v
        else:
            ab[ku - d, : n + d] = v
    return ab, kl, ku


def _nearest_dist(vals, spectrum) -> np.ndarray:
    """Each value's distance to the nearest of the ascending ``spectrum``."""
    vals = np.asarray(vals)
    pos = np.clip(np.searchsorted(spectrum, vals), 1, len(spectrum) - 1)
    return np.minimum(np.abs(spectrum[pos] - vals),
                      np.abs(spectrum[pos - 1] - vals))


def _device_bytes(torch, dev) -> int:
    return torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0


def _bcr_checks(torch, dev, gpu, ab, kl, ku, n):
    """13a's checks before the solve, on the factor of ``A - sigma I`` that
    ``eigsh_banded`` builds: BCR in its DIA form (probe residual printed);
    one solve through the DIA kernel against the same solve through its
    twin on the same tables; the DIA launches of one OP apply; the same
    solve on a second factor in the compacted form (the gate at 0 bytes on
    the instance); both forms' ms per apply, device-only, in alternation.
    Returns the DIA launches of one apply."""
    from unittest import mock

    from arpack_ng_tpu_torch.config import pad_dim
    from arpack_ng_tpu_torch.ops import bandsolve, cuda_dia, sparse

    sb, skl, sku = bandsolve.shifted_band(ab, kl, ku, None, 0, 0, P13_SIGMA,
                                          n)
    m0 = _device_bytes(torch, dev)
    t0 = time.perf_counter()
    fac = bandsolve.BandedFactor(sb, skl, sku, dtype=np.float64, n=n,
                                 device=dev)
    t_fac = time.perf_counter() - t0
    m1 = _device_bytes(torch, dev)
    if (fac.method, fac.form) != ("cr", "dia"):
        raise AssertionError(f"13a: the factor is {fac.method} in the "
                             f"{fac.form} form, not BCR in its DIA form")
    g = torch.Generator(device=dev).manual_seed(13)
    v = torch.zeros(pad_dim(n), dtype=torch.float64, device=dev)
    v[:n] = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
    cuda_dia.dia_matvec.launches = 0
    x = fac.solve(v)
    per_apply = cuda_dia.dia_matvec.launches
    with mock.patch.object(sparse, "dia_matvec", cuda_dia.dia_matvec_plain):
        x_twin = fac.solve(v)
    rel = float((x - x_twin).norm() / x_twin.norm())
    sx = fac._band_mv(x[:n].contiguous())
    resid = float((sx - v[:n]).norm() / v[:n].norm())
    compact = bandsolve.BandedFactor.__new__(bandsolve.BandedFactor)
    compact._DIA_CR_MAX_BYTES = 0
    t0 = time.perf_counter()
    compact.__init__(sb, skl, sku, dtype=np.float64, n=n, device=dev)
    t_comp = time.perf_counter() - t0
    m2 = _device_bytes(torch, dev)
    rel_c = float((compact.solve(v) - x).norm() / x.norm())
    # the kernel sums as its twin does (gate 1e-12; it is 0 on the card);
    # the two forms round apart, and the forward gap and the residual
    # grow with cond(S) (gates 1e-10)
    if not rel <= 1e-12 or not rel_c <= 1e-10 or not resid <= 1e-10 \
            or compact.form != "compact":
        raise AssertionError(
            f"13a: BCR solve: kernel vs twin {rel:.2e} (gate 1e-12), "
            f"compacted ({compact.form}) vs DIA form {rel_c:.2e}, ||S x - v|| "
            f"/ ||v|| {resid:.2e} (gates 1e-10)")
    ms = ("not measured", "not measured")
    if dev.type == "cuda":
        ms = tuple(f"{t:.4f}" for t in timing.alternating_ms(
            [lambda: fac.solve(v), lambda: compact.solve(v)],
            timing.flush_buffer(dev), P13_SOLVE_REPS))
    print(f"13a factor of A - {P13_SIGMA} I (n={n}, float64): method "
          f"{fac.method}, form {fac.form}, probe residual "
          f"{fac.probe_residual:.3e}, host {t_fac:.2f} s, "
          f"{(m1 - m0) / 2**20:.0f} MiB on the card ({len(fac._dia_bwd)} "
          f"levels); one solve (refine=1): {per_apply} DIA launches, kernel "
          f"vs twin on the same tables rel diff {rel:.3e}, ||S x - v|| / "
          f"||v|| {resid:.3e}; compacted form: host {t_comp:.2f} s, "
          f"{(m2 - m1) / 2**20:.0f} MiB, rel diff to the DIA form "
          f"{rel_c:.3e}; ms per apply (device-only median of "
          f"{P13_SOLVE_REPS} in alternation, L2 flushed): DIA form {ms[0]}, "
          f"compacted {ms[1]}; card {gpu}", flush=True)
    return per_apply


def _banded_main(torch, dev, gpu, n, need):
    """13a, the main path: ``eigsh_banded`` on ``tridiag(-1, 2, -1)`` at
    ``n``, float64, sigma = P13_SIGMA, k = 4, 'LM', tol = 1e-10: BCR in its
    DIA form through the device loop.  First at the reference's default
    ncv (20: one cycle, which the loop runs eagerly as its warm-up), then
    at ncv = P13_NCV, where the solve restarts and the loop replays its
    CUDA graphs, each replay holding its OP applies' DIA launches.  Returns
    the launches of the second."""
    from arpack_ng_tpu_torch.ops import banded

    ab, kl, ku = _band(n, {-1: -1.0, 0: 2.0, 1: -1.0})
    per_apply = _bcr_checks(torch, dev, gpu, ab, kl, ku, n)
    a_sp = banded._ab_to_sparse(ab, kl, ku, n)
    lam = np.sort(2 - 2 * np.cos(np.arange(1, n + 1) * np.pi / (n + 1)))
    for ncv in (None, P13_NCV):
        tag = (f"13a eigsh_banded(tridiag(-1, 2, -1), n={n}, "
               f"sigma={P13_SIGMA}, k=4, ncv={ncv or 'default'}, float64)")
        rec = _Recorded()
        with rec.patch():
            (vals, vecs, out), wall, counts = _counted(
                torch, dev, need("dia_matvec", "sym_cycle"),
                lambda: banded.eigsh_banded(ab, kl, ku, k=4, ncv=ncv,
                                            sigma=P13_SIGMA, which="LM",
                                            tol=1e-10, dtype=np.float64,
                                            return_stats=True, device=dev))
        (fac, t_fac), = rec.factors
        if (fac.method, fac.form) != ("cr", "dia"):
            raise AssertionError(f"{tag}: factor {fac.method} / {fac.form}")
        del fac, rec
        dist = _nearest_dist(vals, lam)
        _, rmax = _gate_pairs(vals, vecs, a_sp, lam, 1e-8, 1e-8, tag,
                              count=4)
        del vecs
        if dist.max() > 1e-8:
            raise AssertionError(f"{tag}: values {dist.max():.2e} from the "
                                 "closed form (gate 1e-8)")
        st = out.stats
        if ncv and dev.type == "cuda" and not (
                st.graph_replays and all(
                    d.get("dia_matvec", 0) >= per_apply
                    for d in st.replay_launches.values())):
            raise AssertionError(f"{tag}: no graph replayed with its DIA "
                                 f"launches ({_loop_line(st)})")
        solve_s = wall - t_fac
        print(f"{tag}: wall {wall:.4f} s, of which the host factor "
              f"{t_fac:.2f} s; {_stats_line(st)}; {counts['dia_matvec']} DIA "
              f"launches ({per_apply} per OP apply; "
              f"{counts['dia_matvec'] / st.nopx:.1f} per nopx), "
              f"{solve_s * 1e3 / st.nopx:.4f} ms of the wall after the factor "
              f"per OP apply; max dist to 2 - 2 cos(j pi/(n+1)) "
              f"{dist.max():.2e}, max residual {rmax:.2e}; launches {counts}; "
              f"card {gpu}", flush=True)
        print(f"  device loop: {_loop_line(st)}", flush=True)
        print(f"  values {np.array2string(vals, precision=12)}", flush=True)
    return counts


def _banded_pencil(torch, dev, gpu, n, mode2_n, need):
    """13b: the pencil ``K = tridiag(-1, 2, -1)``, ``M = tridiag(1, 4,
    1)/6`` through ``eigsh_banded``: shift-invert at sigma = P13_GEN_SIGMA
    at ``n`` (values ``(2 - 2 cos t)/((4 + 2 cos t)/6)``, t = j pi/(n+1)),
    and mode 2 (``OP = inv(M) K``, M factored by BCR) at ``mode2_n``.
    Returns each path's launches."""
    from arpack_ng_tpu_torch.ops import banded

    paths = {}
    for tag, dim, kw, gate in (
            (f"13b eigsh_banded(K, mb=M, sigma={P13_GEN_SIGMA}, n={n})", n,
             dict(sigma=P13_GEN_SIGMA, tol=1e-10), 1e-8),
            (f"13b eigsh_banded(K, mb=M, mode 2, n={mode2_n})", mode2_n,
             dict(tol=1e-8, ncv=32, maxiter=3000, solver="cr"), 1e-6)):
        ab, kl, ku = _band(dim, {-1: -1.0, 0: 2.0, 1: -1.0})
        mb = _band(dim, {-1: 1 / 6, 0: 4 / 6, 1: 1 / 6})[0]
        t = np.arange(1, dim + 1) * np.pi / (dim + 1)
        lam = np.sort((2 - 2 * np.cos(t)) / ((4 + 2 * np.cos(t)) / 6))
        (vals, vecs, out), wall, counts = _counted(
            torch, dev, need("dia_matvec", "sym_cycle"),
            lambda: banded.eigsh_banded(ab, kl, ku, k=4, mb=mb, which="LM",
                                        dtype=np.float64, return_stats=True,
                                        device=dev, **kw))
        dmax, rmax = _gate_pairs(vals, vecs, banded._ab_to_sparse(
            ab, kl, ku, dim), lam, gate, gate, tag,
            m_sp=banded._ab_to_sparse(mb, kl, ku, dim), count=4)
        print(f"{tag}: wall {wall:.4f} s, {_stats_line(out.stats)}; max "
              f"relative value dist {dmax:.2e}, max ||Kv - lambda Mv|| / "
              f"max(1, |lambda|) {rmax:.2e} (gates {gate:.0e}); launches "
              f"{counts}; card {gpu}", flush=True)
        print(f"  values {np.array2string(vals, precision=12)}", flush=True)
        paths[tag[:3] + (" mode 2" if "mode 2" in tag else " shift-invert")] \
            = counts
    return paths


class _Recorded:
    """``banded.BandedFactor`` patched to record each factor built and its
    host seconds (``factors``)."""

    def __init__(self):
        from arpack_ng_tpu_torch.ops import bandsolve

        self.factors = []
        rec = self

        class Factor(bandsolve.BandedFactor):
            def __init__(self, *args, **kwargs):
                t0 = time.perf_counter()
                super().__init__(*args, **kwargs)
                rec.factors.append((self, time.perf_counter() - t0))

        self.cls = Factor

    def patch(self):
        from unittest import mock

        from arpack_ng_tpu_torch.ops import banded
        return mock.patch.object(banded, "BandedFactor", self.cls)


def _realified_factor(torch, dev, gpu, ab, kl, ku, n):
    """13c at ``n``: the realified factor of ``A - P13_ZSIGMA I`` (b = 2)
    built as ``eigs_banded`` builds it, over the DIA form's memory gate, so
    in the compacted form; one ``solve_parts`` held by its residual
    ``||S x - v|| / ||v||`` (S applied through the band's real and
    imaginary parts, gate 1e-10) and timed device-only."""
    from arpack_ng_tpu_torch.config import pad_dim
    from arpack_ng_tpu_torch.ops import bandsolve

    sb, skl, sku = bandsolve.shifted_band(ab, kl, ku, None, 0, 0,
                                          P13_ZSIGMA, n)
    t0 = time.perf_counter()
    fac = bandsolve.BandedFactor(sb, skl, sku, dtype=np.float64, n=n,
                                 device=dev)
    t_fac = time.perf_counter() - t0
    # (a rehearsal at a smaller n fits the DIA form under the gate)
    if fac.method != "cr" or not fac.realified \
            or (n >= P13_N and fac.form != "compact"):
        raise AssertionError(f"13c: the realified factor is {fac.method} in "
                             f"the {fac.form} form")
    g = torch.Generator(device=dev).manual_seed(15)
    v = torch.zeros(pad_dim(n), dtype=torch.float64, device=dev)
    v[:n] = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
    xr, xi = (x[:n].contiguous() for x in fac.solve_parts(v))
    rr = fac._band_mv_re(xr, xi) - v[:n]
    ri = fac._band_mv_im(xr, xi)
    resid = float(torch.sqrt(rr.norm() ** 2 + ri.norm() ** 2) / v.norm())
    if not resid <= 1e-10:
        raise AssertionError(f"13c: realified solve residual {resid:.2e}")
    ms = "not measured"
    if dev.type == "cuda":
        ms = timing.alternating_ms([lambda: fac.solve_parts(v)],
                                   timing.flush_buffer(dev),
                                   P13_SOLVE_REPS)[0]
        ms = f"{ms:.4f}"
    print(f"13c realified factor of A - {P13_ZSIGMA} I (n={n}, float64): "
          f"form {fac.form}, b = {fac.b}, probe residual "
          f"{fac.probe_residual:.3e}, host {t_fac:.2f} s; ||S x - v|| / "
          f"||v|| {resid:.3e} (gate 1e-10); ms per solve_parts (refine=1, "
          f"device-only median of {P13_SOLVE_REPS}, L2 flushed) {ms}; card "
          f"{gpu}", flush=True)


def _banded_eigs(torch, dev, gpu, n, n_real, n_cplx, need):
    """13c: ``eigs_banded`` on the 1-D convection-diffusion band (rho =
    P13_RHO, h = 1/(n+1)): a real shift 1.0 at ``n_real`` and P13_ZSIGMA
    with ``part='real'`` (realified, b = 2) at ``n_cplx``, gates: residuals
    ``<= 1e-8`` / ``1e-7``, the reference tests' (at n = 3000); then the
    realified factor at ``n``, over the DIA form's memory gate, in the
    compacted form (:func:`_realified_factor`).  Both solves are cut from
    2^20: a float64 Ritz vector's residual has a floor of about ``1e-14
    ||A||`` (3.8e-8 at n = 2^20, ``||A|| = 4.2e6``, with one refinement
    step or two), above the real shift's 1e-8 gate; and the complex
    shift's operator ``Re 1/(lambda - sigma)`` peaks at lambda = 6, where
    its top values lie ~5e-6 apart relative at n = 2^20 (no convergence
    in 500 restarts there).  The distance to the closed form ``2/h - 2
    sqrt(1/h^2 - rho^2/4) cos(j pi h)`` is reported.  Returns each path's
    launches."""
    from arpack_ng_tpu_torch.ops import banded

    def band(dim):
        h = 1.0 / (dim + 1)
        ab, kl, ku = _band(dim, {-1: -1.0 / h - P13_RHO / 2, 0: 2.0 / h,
                                 1: -1.0 / h + P13_RHO / 2})
        lam = np.sort(2 / h - 2 * np.sqrt(1 / h ** 2 - P13_RHO ** 2 / 4)
                      * np.cos(np.arange(1, dim + 1) * np.pi * h))
        return ab, kl, ku, lam

    paths = {}
    for dim, sigma, res_max in ((n_real, 1.0, 1e-8),
                                (n_cplx, P13_ZSIGMA, 1e-7)):
        ab, kl, ku, lam = band(dim)
        tag = (f"13c eigs_banded(conv-diff rho={P13_RHO}, n={dim}, "
               f"sigma={sigma})")
        rec = _Recorded()
        with rec.patch():
            (vals, vecs, out), wall, counts = _counted(
                torch, dev, need("dia_matvec"),
                lambda: banded.eigs_banded(
                    ab, kl, ku, k=4, sigma=sigma, which="LM", tol=1e-10,
                    dtype=np.float64, return_stats=True, device=dev))
        (fac, t_fac), = rec.factors
        if fac.method != "cr":
            raise AssertionError(f"{tag}: factor {fac.method}, want cr")
        _, rmax = _gate_pairs(vals, vecs, banded._ab_to_sparse(ab, kl, ku,
                                                               dim),
                              vals, 0.0, res_max, tag, count=4)
        del vecs
        dist = _nearest_dist(vals.real, lam)
        print(f"{tag}: wall {wall:.4f} s (factor: {fac.form} form, b = "
              f"{fac.b}, realified {fac.realified}, host {t_fac:.2f} s), "
              f"{_stats_line(out.stats)}; max residual {rmax:.2e} (gate "
              f"{res_max:.0e}); max |Im| {np.abs(vals.imag).max():.2e}, max "
              f"dist of Re to the closed form {dist.max():.2e} (not gated); "
              f"launches {counts}; card {gpu}", flush=True)
        print(f"  values {np.array2string(vals, precision=10)}", flush=True)
        paths[f"13c sigma={sigma}"] = counts
    _realified_factor(torch, dev, gpu, *band(n)[:3], n)
    return paths


def dia65(n, ndiag=P13_NDIAG, seed=0):
    """``benchmarks/bench_block.py``'s ``build_dia(n, ndiag, float32,
    seed)``: a symmetric diagonally dominant matrix with ``2 ndiag + 1``
    diagonals (offsets 0, +-step, ..., +-ndiag*step), as the offsets and
    row-aligned float32 diagonals (no scipy assembly)."""
    rng = np.random.default_rng(seed)
    offsets = [0]
    diags = [(2.0 * ndiag + rng.standard_normal(n)).astype(np.float32)]
    step = max(1, ndiag // 8)
    for o in sorted({(i + 1) * step for i in range(ndiag)}):
        d = (rng.standard_normal(n) * 0.5).astype(np.float32)
        d[n - o:] = 0.0
        offsets += [o, -o]
        diags += [d, np.roll(d, o)]
    return offsets, diags


def _dia_operator(offsets, diags, n, dev):
    """A mode-1 DIA operator with its block product over one table."""
    from arpack_ng_tpu_torch.config import pad_dim
    from arpack_ng_tpu_torch.ops.operator import Operator
    from arpack_ng_tpu_torch.ops.sparse import _dia_products

    n_pad = pad_dim(n)
    mv, blk = _dia_products(offsets, diags, n, n_pad, dev)

    def apply(v, bv):
        w = mv(v)
        return w, w

    return Operator(n=n, dtype=np.float32, apply=apply, bmat="I", mode=1,
                    a_apply=mv, n_pad=n_pad, hermitian=True, format="dia",
                    device=dev, capturable=True, apply_block=blk)


def _eigh_ms(torch, dev, ncv=NCV, reps=50) -> float:
    """Host ms of one ``torch.linalg.eigh`` of a float64 ncv x ncv matrix
    on the card, sync included (the block cycle's reduced eigensolve)."""
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    T = torch.randn(ncv, ncv, device=dev, dtype=torch.float64)
    T = T + T.T
    torch.linalg.eigh(T)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        torch.linalg.eigh(T)
    sync()
    return (time.perf_counter() - t0) * 1e3 / reps


def _block_apply_ms(torch, dev, op, b) -> str:
    if dev.type != "cuda":
        return "not measured"
    X = torch.randn(b, op.n_pad, device=dev)
    X[:, op.n:] = 0
    ms = timing.alternating_ms([lambda: op.apply_block(X)],
                               timing.flush_buffer(dev))[0]
    return f"{ms:.4f}"


def _multiplets(vals, spectrum) -> str:
    """Copies captured of each distinct spectrum value nearest to a
    returned value, beside its multiplicity in the spectrum."""
    pos = np.clip(np.searchsorted(spectrum, vals), 1, len(spectrum) - 1)
    near = np.where(np.abs(spectrum[pos] - vals)
                    < np.abs(spectrum[pos - 1] - vals),
                    spectrum[pos], spectrum[pos - 1])
    out = []
    for lam in np.unique(np.round(near, 9)):
        mult = int(np.sum(np.abs(spectrum - lam) <= 1e-9 * abs(lam)))
        got = int(np.sum(np.abs(near - lam) <= 1e-9 * abs(lam)))
        out.append(f"{lam:.7f}: {got} of {mult}")
    return ", ".join(out)


def _block_solves(torch, dev, gpu, nx, n65, need):
    """13d: ``eigsh_block`` (float32, k = 8, ncv = 32) beside the scalar
    selective ``eigsh`` on the same operator: (i) the flagship's CSR through
    ``from_scipy`` (DIA, with the block product), tol = 1e-5, under phase
    4's gates with the multiplet convention; (ii) ``dia65`` at ``n65``, tol =
    1e-4: the top value within 1e-4*|lambda| of the scalar solve's,
    residuals ``<= 1e-3`` by the DIA twin on the card in float64.  Returns
    each path's launches."""
    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core.block import eigsh_block
    from arpack_ng_tpu_torch.models import laplacian_2d

    paths = {}
    eigh_ms = _eigh_ms(torch, dev)
    a_sp = laplacian_2d(nx, np.float32, device="cpu")[1]
    spectrum = _analytic_spectrum(nx)
    op = pt.from_scipy(a_sp, dtype=np.float32, hermitian=True, device=dev)
    if op.format != "dia" or op.apply_block is None:
        raise AssertionError("13d: the flagship's CSR is not DIA with a "
                             "block product")
    offs65, diags65 = dia65(n65)
    op65 = _dia_operator(offs65, diags65, n65, dev)
    for key, label, A, tol in (("(i)", "flagship CSR", op, 1e-5),
                               ("(ii)", f"dia65 n={n65}", op65, 1e-4)):
        kw = dict(k=8, ncv=NCV, tol=tol)
        (vals, vecs, out), wall, counts = _counted(
            torch, dev, need("sym_cycle"),
            lambda: pt.eigsh(A, which="LA", return_stats=True, **kw))
        st = out.stats
        if key == "(i)":
            check_values(vals, vecs, a_sp, spectrum, f"13d{key} scalar")
        top = float(np.max(vals))
        print(f"13d{key} {label} scalar eigsh (selective, tol={tol}): wall "
              f"{wall:.4f} s, {_stats_line(st)}, "
              f"{wall * 1e3 / st.nopx:.4f} ms of wall per matvec; top "
              f"{top:.7f}; card {gpu}", flush=True)
        paths[f"13d{key} scalar"] = counts
        for b in P13_BLOCKS:
            tag = f"13d{key} {label} eigsh_block(b={b}, tol={tol})"
            (vals, vecs, info), wall, counts = _counted(
                torch, dev, need("dia_block_matvec", "rotate_rows"),
                lambda: eigsh_block(A, block_size=b, maxiter=P13_BLOCK_MAXITER,
                                    dtype=np.float32, **kw))
            if key == "(i)":
                dmax, rmax = check_values(vals, vecs, a_sp, spectrum, tag)
                note = (f"max value dist {dmax:.2e}, max residual "
                        f"{rmax:.2e}; copies {_multiplets(vals, spectrum)}")
            else:
                rmax = _dia65_residual(torch, dev, offs65, diags65, n65,
                                       vals, vecs)
                gap = abs(np.max(vals) - top) / abs(top)
                if not gap <= 1e-4 or not rmax <= 1e-3:
                    raise AssertionError(f"{tag}: top {np.max(vals)} vs "
                                         f"scalar {top} ({gap:.2e}), residual "
                                         f"{rmax:.2e}")
                note = (f"top {np.max(vals):.7f} ({gap:.2e} from the "
                        f"scalar's), max residual {rmax:.2e}")
            cyc_ms = wall * 1e3 / info["iters"]
            print(f"{tag}: wall {wall:.4f} s, cycles {info['iters']} (cap "
                  f"{P13_BLOCK_MAXITER}), {info['nconv']} of 8 converged by "
                  f"their bounds, matvecs {info['matvecs']}, {cyc_ms:.4f} ms "
                  f"per cycle "
                  f"(eigh of T {eigh_ms:.4f} ms of it, "
                  f"{100 * eigh_ms / cyc_ms:.1f}%), block apply "
                  f"{_block_apply_ms(torch, dev, A, b)} ms device-only; "
                  f"{note}; launches {counts}; card {gpu}", flush=True)
            paths[f"13d{key} b={b}"] = counts
        del vecs
    return paths


def _dia65_residual(torch, dev, offsets, diags, n, vals, vecs) -> float:
    """max ||A v - lambda v|| / |lambda| of the dia65 pairs in float64 by
    the block DIA twin on the card (host offsets, float64 table)."""
    from arpack_ng_tpu_torch.config import pad_dim
    from arpack_ng_tpu_torch.ops import cuda_dia
    from arpack_ng_tpu_torch.ops.sparse import _dia_tab

    n_pad = pad_dim(n)
    tab = torch.from_numpy(_dia_tab(diags, n, n_pad, np.float64)).to(dev)
    V = torch.zeros((len(vals), n_pad), dtype=torch.float64, device=dev)
    V[:, :n] = torch.from_numpy(np.ascontiguousarray(vecs.T)).to(dev)
    AV = cuda_dia.dia_block_matvec_plain(torch.tensor(offsets), tab, V, n)
    lam = torch.from_numpy(np.asarray(vals, np.float64)).to(dev)
    res = (AV - lam[:, None] * V).norm(dim=1) / lam.abs()
    return float(res.max())


def _dia_csr(torch, offs, dtab, n):
    """The DIA table as a torch sparse CSR tensor (the cuSPARSE yardstick
    of the block product), built on the card."""
    import warnings

    i = torch.arange(n, device=dtab.device)
    rows, cols, vals = [], [], []
    for k, o in enumerate(offs.tolist()):
        j = i + o
        m = (j >= 0) & (j < n) & (dtab[k, :n] != 0)
        rows.append(i[m])
        cols.append(j[m])
        vals.append(dtab[k, :n][m])
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows),
                                               torch.cat(cols)]),
                                  torch.cat(vals), (n, n),
                                  check_invariants=False).coalesce()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "CSR ... beta"
        return coo.to_sparse_csr()


def check_dia_block(torch, dev, gpu, nx=NX, n65=P13_N, timed=True):
    """13e: the block DIA kernel against its twin on the flagship's 5
    diagonals and on dia65's 65, b in {1, 2, 4, 8}, float32 and float64, at
    n and n + 3: equal bit for bit to the twin, each column to the single
    kernel, two calls to each other; timed at n (device-only, in
    alternation) beside its bound ``(nd + 2b) n_pad itemsize / 3.35 TB/s``,
    ``b`` launches of the single kernel and ``torch.sparse.mm`` of the CSR
    with ``X^T``.  Returns (max abs err by dtype, timed rows)."""
    from arpack_ng_tpu_torch.config import pad_dim
    from arpack_ng_tpu_torch.models import laplacian_2d
    from arpack_ng_tpu_torch.ops import cuda_dia
    from arpack_ng_tpu_torch.ops.sparse import _dia_tab, _to_dia

    flush = timing.flush_buffer(dev) if timed else None
    g = torch.Generator(device=dev).manual_seed(14)
    tables = (("dia_block", *_to_dia(laplacian_2d(nx, np.float64,
                                                  device="cpu")[1]),
               nx * nx),
              ("dia_block65", *dia65(n65), n65))
    err, rows = {}, []
    for name, offsets, diags, n in tables:
        offs = torch.tensor(offsets, dtype=torch.int64, device=dev)
        for dtype in (np.float32, np.float64):
            tdt = torch.float32 if dtype == np.float32 else torch.float64
            csr = None
            for nn in (n, n + 3):
                n_pad = pad_dim(nn, 1024)
                tab = torch.from_numpy(_dia_tab(diags, n, n_pad, dtype)
                                       ).to(dev)
                if nn > n:
                    tab[:, n:nn] = torch.randn(len(offsets), nn - n,
                                               generator=g, device=dev,
                                               dtype=tdt)
                for b in (1, 2, 4, 8):
                    X = torch.randn(b, n_pad, generator=g, device=dev,
                                    dtype=tdt)
                    Y = cuda_dia.dia_block_matvec(offs, tab, X, nn)
                    same = torch.equal(Y, cuda_dia.dia_block_matvec_plain(
                        offs, tab, X, nn)) and torch.equal(
                        Y, cuda_dia.dia_block_matvec(offs, tab, X, nn)) \
                        and all(torch.equal(Y[c], cuda_dia.dia_matvec(
                            offs, tab, X[c], nn)) for c in range(b)) \
                        and not Y[:, nn:].any()
                    if not same:
                        raise AssertionError(
                            f"13e {name} {dtype.__name__} n={nn} b={b}: the "
                            "block kernel is not bit-equal to its twin, "
                            "itself and the single kernel per column")
                    err[str(tdt)] = 0.0
                    if not timed or nn > n:
                        continue
                    if csr is None:
                        csr = _dia_csr(torch, offs, tab, n)
                    Xt = X.T.contiguous()
                    isz = X.element_size()
                    nd = len(offsets)
                    row = _timed_row(
                        torch, flush, name, str(tdt), b,
                        (nd + 2 * b) * n_pad * isz + 8 * nd,
                        2.0 * csr._nnz() * b, str(tdt),
                        lambda: cuda_dia.dia_block_matvec(offs, tab, X, n),
                        lambda: cuda_dia.dia_block_matvec_plain(offs, tab, X,
                                                                n),
                        lambda: torch.sparse.mm(csr, Xt),
                        extra={"single_ms": lambda: [
                            cuda_dia.dia_matvec(offs, tab, X[c], n)
                            for c in range(b)]})
                    rows.append(row)
            del csr
    return err, rows


def banded_block_paths(torch, dev, gpu, n=P13_N, mode2_n=P13_MODE2_N,
                       n_real=P13_CD_REAL_N, n_cplx=P13_CD_COMPLEX_N, nx=NX,
                       n65=P13_N):
    """Phase 13: the banded and block solvers (see the module docstring).
    Returns (each path's kernel launches, 13e's errors, 13e's rows)."""
    def need(*kernels):
        # a wrapper counts only the kernel launches a card makes
        return kernels if dev.type == "cuda" else ()

    t0 = time.perf_counter()
    paths = {"13a": _banded_main(torch, dev, gpu, n, need)}
    paths.update(_banded_pencil(torch, dev, gpu, n, mode2_n, need))
    paths.update(_banded_eigs(torch, dev, gpu, n, n_real, n_cplx, need))
    paths.update(_block_solves(torch, dev, gpu, nx, n65, need))
    err, rows = check_dia_block(torch, dev, gpu, nx, n65,
                                timed=dev.type == "cuda")
    elapsed = time.perf_counter() - t0
    print(f"phase 13 block DIA kernel vs twin (device-only median of "
          f"{timing.REPS} in alternation, L2 flushed by a read; card {gpu}):",
          flush=True)
    _print_rows(rows)
    print(f"phase 13: {elapsed:.2f} s (limit {P13_MAX_S:.0f} s)", flush=True)
    if elapsed > P13_MAX_S:
        raise AssertionError(f"phase 13 took {elapsed:.1f} s")
    return paths, err, rows


def _cli_inproc(argv):
    """``arpack_ng_tpu_torch.cli.main(argv + ['--json'])`` in this
    process.  Returns ``(rc, its JSON line, the IRAMSolver result)``."""
    import contextlib
    from unittest import mock

    from arpack_ng_tpu_torch import cli
    from arpack_ng_tpu_torch.core import iram

    got = []
    solve = iram.IRAMSolver.solve

    def recorded(self, *args, **kwargs):
        got.append(solve(self, *args, **kwargs))
        return got[-1]

    buf = io.StringIO()
    with mock.patch.object(iram.IRAMSolver, "solve", recorded), \
            contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv) + ["--json"])
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), \
        (got[-1] if got else None)


def _cli_gate(rc, out, spectrum, rel, res_max, what, count):
    """rc 0, ``count`` real values each within ``rel*|lambda|`` of the
    sorted ``spectrum``, and the CLI's own residuals (``||A v - lambda B
    v|| / max(1, |lambda|)``, arpackSolver::checkEigVec) ``<= res_max``.
    Returns (values, max distance, max residual)."""
    if rc != 0 or out is None:
        raise AssertionError(f"{what}: rc {rc}")
    vals = np.asarray(out["values_real"])
    res = np.asarray(out["residuals"])
    if len(vals) != count or np.any(np.asarray(out["values_imag"]) != 0):
        raise AssertionError(f"{what}: {len(vals)} values {vals}, want "
                             f"{count} real")
    pos = np.clip(np.searchsorted(spectrum, vals), 1, len(spectrum) - 1)
    dist = np.minimum(np.abs(spectrum[pos] - vals),
                      np.abs(spectrum[pos - 1] - vals)) / np.abs(vals)
    if dist.max() > rel or len(res) != count or not np.all(
            np.isfinite(res)) or res.max() > res_max:
        raise AssertionError(f"{what}: value distances {dist}, residuals "
                             f"{res} (gates {rel:.0e}, {res_max:.0e})")
    return vals, float(dist.max()), float(res.max())


def _cli_main(torch, dev, gpu, tmp, nx, need):
    """14a: the flagship's Laplacian written as a .mtx file, then
    ``python -m arpack_ng_tpu_torch.cli`` on it in its own process (the
    command line a user runs), then the same in this process with the
    kernel launches counted (the reference CLI's reorthogonalization,
    dgks: the rotation and DIA kernels).  Returns (the argv, the path's
    launches, the in-process run's JSON and result)."""
    import os

    from arpack_ng_tpu_torch.io import matrix_market as mm
    from arpack_ng_tpu_torch.models import laplacian_2d

    a_sp = laplacian_2d(nx, np.float32, device="cpu")[1]
    path = os.path.join(tmp, "lap.mtx")
    t0 = time.perf_counter()
    mm.write_matrix(path, a_sp)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = mm.read_matrix(path)
    t_read = time.perf_counter() - t0
    if back.nnz != a_sp.nnz:
        raise AssertionError(f"14a: {back.nnz} non-zeros read back, wrote "
                             f"{a_sp.nnz}")
    del back
    print(f"14a {path.rsplit(os.sep, 1)[-1]}: n = {nx * nx}, {a_sp.nnz} "
          f"stored non-zeros, {os.path.getsize(path) / 1e6:.1f} MB of text; "
          f"write_matrix {t_write:.2f} s, read_matrix (scipy mmread) "
          f"{t_read:.2f} s (host)", flush=True)
    spectrum = _analytic_spectrum(nx)
    argv = ["--A", path, "--nbEV", "8", "--nbCV", str(NCV), "--mag", "LA",
            "--tol", "1e-5", "--simplePrec"]
    if dev.type == "cpu":
        argv.append("--cpu")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [here] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "arpack_ng_tpu_torch.cli",
                        *argv, "--json"], capture_output=True, text=True,
                       env=env, cwd=here, timeout=600)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"14a: the CLI process exited "
                             f"{r.returncode}: {r.stderr[-3000:]}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    vals, dmax, rmax = _cli_gate(0, out, spectrum, 1e-4, 1e-3,
                                 "14a CLI process", 8)
    print(f"14a python -m arpack_ng_tpu_torch.cli {' '.join(argv[2:])} "
          f"--json (its own process): rc 0, wall {wall:.2f} s (process "
          f"start, read, operator, solve, residual check; the CLI's "
          f"elapsed_s {out['elapsed_s']:.2f} s), cycles {out['n_iter']}, "
          f"nconv {out['nconv']}; max value dist {dmax:.2e}, max residual "
          f"{rmax:.2e}; card {gpu}", flush=True)
    print(f"  values {np.array2string(vals, precision=7)}", flush=True)
    (rc, out, res), wall, counts = _counted(
        torch, dev, need("rotate_rows", "dia_matvec"),
        lambda: _cli_inproc(argv))
    vals, dmax, rmax = _cli_gate(rc, out, spectrum, 1e-4, 1e-3,
                                 "14a cli.main", 8)
    print(f"14a cli.main (in process): wall {wall:.2f} s, "
          f"{_stats_line(res.stats)}; max value dist {dmax:.2e}, max "
          f"residual {rmax:.2e}; launches {counts}; card {gpu}", flush=True)
    return argv, {"14a": counts}, (out, res)


def _cli_dump_restart(torch, dev, gpu, tmp, argv, full, cut, need):
    """14b: 14a's run stopped at ``--maxIt cut`` with ``--dump``
    (rc 1), then ``--restart`` from the file with the full ``--maxIt``:
    its cycles, counters and values must be the unbroken run's exactly."""
    import os

    from arpack_ng_tpu_torch.io import checkpoint as ckpt

    full_out, full_res = full
    cut = cut if full_out["n_iter"] > cut else full_out["n_iter"] // 2
    ck = os.path.join(tmp, "cli.npz")
    kernels = need("rotate_rows", "dia_matvec")
    saves, loads = [], []
    with _host_seconds(ckpt, "save_state", saves), \
            _host_seconds(ckpt, "load_state", loads):
        (rc1, o1, _), w1, c1 = _counted(
            torch, dev, kernels,
            lambda: _cli_inproc(argv + ["--maxIt", str(cut), "--dump", ck]))
        (rc2, o2, r2), w2, c2 = _counted(
            torch, dev, kernels, lambda: _cli_inproc(argv + ["--restart", ck]))
    if rc1 != 1 or o1["n_iter"] != cut:
        raise AssertionError(f"14b: the --maxIt {cut} run gave rc {rc1}, "
                             f"{o1['n_iter']} cycles (want rc 1, {cut})")
    got = (o2["n_iter"], r2.stats.nopx, r2.stats.nrorth, r2.stats.nrotr)
    want = (full_out["n_iter"], full_res.stats.nopx, full_res.stats.nrorth,
            full_res.stats.nrotr)
    if rc2 != 0 or got != want or o2["values_real"] != \
            full_out["values_real"]:
        raise AssertionError(f"14b: the resumed run gave rc {rc2}, cycles "
                             f"/ nopx / nrorth / nrotr {got}, values "
                             f"{o2['values_real']}; the unbroken run {want}, "
                             f"{full_out['values_real']}")
    print(f"14b --maxIt {cut} --dump: rc 1, wall {w1:.2f} s; --restart: "
          f"rc 0, wall {w2:.2f} s, cycles / nopx / nrorth / nrotr {got}, "
          f"values equal to the unbroken run's bit for bit; save_state "
          f"{saves[0]:.3f} s, load_state {loads[0]:.3f} s (host, to and "
          f"from the card), file {os.path.getsize(ck) / 2 ** 20:.1f} MiB "
          f"(V {NCV * full_res.state.V.shape[1] * 4 / 2 ** 20:.1f} MiB); "
          f"card {gpu}", flush=True)
    return {"14b dump": c1, "14b restart": c2}


def _device_loop_resume(torch, dev, gpu, tmp, nx, cut, need):
    """14c: the flagship on the device loop (``eigsh``'s config: selective,
    CUDA graphs), stopped at the boundary after ``cut`` cycles, dumped,
    loaded into a fresh solver and resumed: the totals must be the
    unbroken solve's (at the flagship's size on the card:
    ``KERNEL_COUNTERS``), the values and residuals phase 4's gates."""
    import os

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core.device_sym import FusedSymSolver
    from arpack_ng_tpu_torch.io import checkpoint as ckpt
    from arpack_ng_tpu_torch.models import laplacian_2d

    op, a_sp = laplacian_2d(nx, np.float32, device=dev)
    cfg = pt.IRAMConfig(n=op.n, nev=8, ncv=NCV, which="LA", tol=1e-5,
                        max_iter=10 * op.n, symmetric=True,
                        dtype=np.dtype(np.float32), n_pad=op.n_pad,
                        reorth="selective")
    if dev.type == "cuda" and nx == NX:
        want = KERNEL_COUNTERS["flagship selective"]
    else:
        st = pt.eigsh(op, k=8, ncv=NCV, which="LA", tol=1e-5,
                      return_stats=True)[2].stats
        want = (st.n_iter, st.nopx, st.nrorth)
    cut = min(cut, want[0] // 2)
    ck = os.path.join(tmp, "loop.npz")
    times = {}

    def run():
        first = FusedSymSolver(op, cfg)
        out = first.multi(first.init_state(), cut)
        if out.done or out.state.iter != cut or out.state.k >= NCV:
            raise AssertionError(f"14c: no boundary after {cut} cycles")
        t0 = time.perf_counter()
        ckpt.save_state(ck, out.state, cfg)
        times["save"] = time.perf_counter() - t0
        del out, first
        t0 = time.perf_counter()
        st, _ = ckpt.load_state(ck, cfg=cfg, device=dev)
        times["load"] = time.perf_counter() - t0
        return FusedSymSolver(op, cfg).solve(state=st)

    res, wall, counts = _counted(torch, dev, need(*SELECTIVE_PATH), run)
    st = res.stats
    got = (st.n_iter, st.nopx, st.nrorth)
    e = pt.extract(op, cfg, res)
    dmax, rmax = check_values(e.values, e.vectors, a_sp,
                              _analytic_spectrum(nx), "14c")
    print(f"14c device loop to cycle {cut}, save_state {times['save']:.3f} "
          f"s, file {os.path.getsize(ck) / 2 ** 20:.1f} MiB, load_state "
          f"{times['load']:.3f} s, resumed in a fresh solver: wall "
          f"{wall:.2f} s, {_stats_line(st)} (want {want}); resumed loop: "
          f"{_loop_line(st)}; max value dist {dmax:.2e}, max residual "
          f"{rmax:.2e}; launches {counts}; card {gpu}", flush=True)
    if got != want or st.packets != st.n_iter - cut:
        raise AssertionError(f"14c: resumed totals {got}, {st.packets} "
                             f"packets; want {want}, {want[0] - cut}")
    return {"14c": counts}


def _cli_solvers(torch, dev, gpu, tmp, si_nx, pencil_n, need):
    """14d: the ``--slv`` menu on the card: CG with the IC(0)
    preconditioner (``--slvItrPC ILU``) for shift-invert at sigma = 0 on
    the Laplacian, float64; LU for dsdrv3-6's generalized pencil."""
    import os

    from arpack_ng_tpu_torch.io import matrix_market as mm
    from arpack_ng_tpu_torch.models import laplacian_2d

    cpu = ["--cpu"] if dev.type == "cpu" else []
    paths = {}
    a_sp = laplacian_2d(si_nx, np.float64, device="cpu")[1]
    lap = os.path.join(tmp, "lap_si.mtx")
    mm.write_matrix(lap, a_sp)
    k_sp, m_sp, closed = _dsdrv_pencil(pencil_n)
    kf, mf = os.path.join(tmp, "K.mtx"), os.path.join(tmp, "M.mtx")
    mm.write_matrix(kf, k_sp)
    mm.write_matrix(mf, m_sp)
    for tag, argv, spectrum, rel, count in (
            (f"CG + IC(0), nx={si_nx}",
             ["--A", lap, "--nbEV", "8", "--nbCV", str(NCV), "--shiftReal",
              "0", "--invert", "--slv", "CG", "--slvItrPC", "ILU", "--tol",
              "1e-8"], _analytic_spectrum(si_nx), 1e-6, 8),
            (f"LU pencil, n={pencil_n}",
             ["--A", kf, "--B", mf, "--genPb", "--shiftReal",
              str(P14_SIGMA), "--invert", "--slv", "LU", "--nbEV", "4",
              "--tol", "1e-10"], closed, 1e-8, 4)):
        (rc, out, res), wall, counts = _counted(
            torch, dev, need("dia_matvec"), lambda: _cli_inproc(argv + cpu))
        vals, dmax, rmax = _cli_gate(rc, out, spectrum, rel, rel,
                                     f"14d {tag}", count)
        print(f"14d --slv {tag}: wall {wall:.2f} s, {_stats_line(res.stats)};"
              f" max value dist {dmax:.2e}, max residual {rmax:.2e}; "
              f"launches {counts}; card {gpu}", flush=True)
        print(f"  values {np.array2string(vals, precision=10)}", flush=True)
        paths[f"14d {tag.split(',')[0]}"] = counts
    return paths


def _examples(torch, dev, gpu, sizes, need):
    """14e: each of the port's examples once, its printed residuals under
    ``P14_EXAMPLE_RES``; between them they launch the event, rotation,
    PSELL and reduced-space kernels."""
    import importlib

    from arpack_ng_tpu_torch.examples import EXAMPLES

    def run_all():
        out = {}
        for name in EXAMPLES:
            mod = importlib.import_module(
                f"arpack_ng_tpu_torch.examples.{name}")
            t0 = time.perf_counter()
            vals, res = mod.main(*sizes.get(name, ()), device=dev)
            out[name] = (time.perf_counter() - t0, vals, res)
        return out

    out, wall, counts = _counted(
        torch, dev, need("sel_proj", "sel_update", "rotate_rows",
                         "psell_matvec", "sym_cycle"), run_all)
    for name, (t, vals, res) in out.items():
        lim = P14_EXAMPLE_RES[name] * max(1.0, float(np.max(np.abs(vals))))
        if not len(vals) or not np.all(np.isfinite(res)) or res.max() > lim:
            raise AssertionError(f"14e {name}: residuals {res} (gate "
                                 f"{lim:.1e})")
        print(f"14e {name}: {t:.2f} s, {len(vals)} values, max residual "
              f"{res.max():.2e}", flush=True)
    print(f"14e examples: {wall:.2f} s; launches {counts}; card {gpu}",
          flush=True)
    return {"14e": counts}


def cli_paths(torch, dev, gpu, nx=NX, si_nx=P14_SI_NX,
              pencil_n=P14_PENCIL_N, cut=P14_CUT, example_sizes=None):
    """Phase 14: the file entry points (see the module docstring), each
    path's kernel launches counted from zero.  Returns them."""
    import tempfile

    def need(*kernels):
        # a wrapper counts only the kernel launches a card makes
        return kernels if dev.type == "cuda" else ()

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        argv, paths, full = _cli_main(torch, dev, gpu, tmp, nx, need)
        paths.update(_cli_dump_restart(torch, dev, gpu, tmp, argv, full, cut,
                                       need))
        paths.update(_device_loop_resume(torch, dev, gpu, tmp, nx, cut,
                                         need))
        paths.update(_cli_solvers(torch, dev, gpu, tmp, si_nx, pencil_n,
                                  need))
    paths.update(_examples(torch, dev, gpu, example_sizes or {}, need))
    elapsed = time.perf_counter() - t0
    print(f"phase 14: {elapsed:.2f} s (limit {P14_MAX_S:.0f} s)", flush=True)
    if elapsed > P14_MAX_S:
        raise AssertionError(f"phase 14 took {elapsed:.1f} s")
    return paths


def _device_ms(evt) -> float:
    """Self device time of a profiler average, in ms (the attribute was
    renamed from ``self_cuda_time_total`` in newer torch)."""
    us = getattr(evt, "self_device_time_total", None)
    if us is None:
        us = evt.self_cuda_time_total
    return us / 1e3


def _profile_table(torch, prof, wall, what, gpu, sort, dev):
    """The card's busy share over ``wall`` and the largest device items;
    returns the busy device milliseconds."""
    from torch.autograd import DeviceType

    avgs = prof.key_averages()
    busy = sum(_device_ms(e) for e in avgs
               if e.device_type == DeviceType.CUDA)
    print(f"profile {what}: wall {wall * 1e3:.4f} ms, device busy "
          f"{busy:.4f} ms ({100 * busy / (wall * 1e3):.2f}% of the wall); "
          f"card {gpu}", flush=True)
    print(avgs.table(sort_by=sort, row_limit=20, max_name_column_width=60),
          flush=True)
    if dev.type == "cuda" and not busy > 0:
        raise AssertionError(f"profile {what}: no device time traced")
    return busy


def _host_profile(fn, what):
    prof_host = cProfile.Profile()
    prof_host.enable()
    fn()
    prof_host.disable()
    buf = io.StringIO()
    pstats.Stats(prof_host, stream=buf).sort_stats("tottime").print_stats(25)
    print(f"profile {what}: cProfile", flush=True)
    print(buf.getvalue(), flush=True)


def profile_cycles(torch, dev, gpu, nx=NX, warm=3, steady=20, profiled=5):
    """Where the time goes: the flagship's restart cycles at the floor
    tolerance (no cycle exits).  Selective (the device loop, the main
    path): a solve of ``warm`` cycles and one of ``warm + steady``; their
    difference is the wall of ``steady`` steady cycles (each solve captures
    its graphs in its first cycles), per Lanczos step; then both solves
    under ``torch.profiler`` (the card's busy share over each solve, the
    largest device items, and the steady share: the difference of their
    device times over the difference of the unprofiled walls) and the
    longer under ``cProfile``.  dgks (the host loop): the wall per step over ``steady``
    cycles after ``warm``, then ``profiled`` cycles under each profiler."""
    from torch.profiler import ProfilerActivity, profile

    from arpack_ng_tpu_torch.config import IRAMConfig
    from arpack_ng_tpu_torch.core.arnoldi import make_init
    from arpack_ng_tpu_torch.core.device_sym import (FusedSymSolver,
                                                     make_sym_head,
                                                     make_sym_tail)
    from arpack_ng_tpu_torch.models import laplacian_2d

    op, _ = laplacian_2d(nx, np.float32, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    sort = ("self_device_time_total" if dev.type == "cuda"
            else "self_cpu_time_total")

    def cfg_of(reorth, cycles):
        return IRAMConfig(n=op.n, nev=8, ncv=NCV, which="LA", symmetric=True,
                          dtype=np.dtype(np.float32), n_pad=op.n_pad,
                          tol=1e-30, max_iter=cycles, reorth=reorth)

    def solve(cycles):
        sync()
        t0 = time.perf_counter()
        res = FusedSymSolver(op, cfg_of("selective", cycles)).solve()
        sync()
        return res, time.perf_counter() - t0

    solve(warm)
    (r1, w1), (r2, w2) = solve(warm), solve(warm + steady)
    steps = r2.stats.nopx - r1.stats.nopx
    wall = w2 - w1
    print(f"profile reorth=selective (device loop): {steady} cycles after "
          f"{warm}, {wall * 1e3:.4f} ms, {steps} steps, "
          f"{wall * 1e3 / steps:.4f} ms/step, events "
          f"{r2.stats.nrorth - r1.stats.nrorth}, event rows "
          f"{r2.stats.nrorthr - r1.stats.nrorthr}; solve of {warm + steady}"
          f" cycles {w2 * 1e3:.4f} ms, graphs captured "
          f"{r2.stats.graphs_captured}, replays {r2.stats.graph_replays}, "
          f"packets {r2.stats.packets}; card {gpu}", flush=True)
    busy = []
    for cycles in (warm, warm + steady):
        with profile(activities=activities) as prof:
            _, wall = solve(cycles)
        busy.append(_profile_table(torch, prof, wall, f"reorth=selective, "
                                   f"a solve of {cycles} cycles", gpu, sort,
                                   dev))
    print(f"profile reorth=selective, steady: device busy "
          f"{busy[1] - busy[0]:.4f} ms over the {steady} cycles' wall "
          f"{(w2 - w1) * 1e3:.4f} ms (unprofiled): "
          f"{100 * (busy[1] - busy[0]) / ((w2 - w1) * 1e3):.2f}%; card {gpu}",
          flush=True)
    _host_profile(lambda: solve(warm + steady),
                  f"reorth=selective, a solve of {warm + steady} cycles")

    cfg = cfg_of("dgks", 10**6)
    head, tail = make_sym_head(op, cfg), make_sym_tail(op, cfg)
    state = make_init(op, cfg)()

    def cycles(state, m):
        for _ in range(m):
            h = head(state)
            if h.done:
                raise AssertionError("profile dgks: a cycle converged")
            state = tail(h, False).state
        return state

    state = cycles(state, warm)
    sync()
    c0, t0 = state.counts, time.perf_counter()
    state = cycles(state, steady)
    sync()
    wall = time.perf_counter() - t0
    steps = state.counts.nopx - c0.nopx
    print(f"profile reorth=dgks: {steady} cycles after {warm}, "
          f"{wall * 1e3:.4f} ms, {steps} steps, {wall * 1e3 / steps:.4f} "
          f"ms/step; card {gpu}", flush=True)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        state = cycles(state, profiled)
        sync()
        wall = time.perf_counter() - t0
    _profile_table(torch, prof, wall, f"reorth=dgks, {profiled} cycles", gpu,
                   sort, dev)
    _host_profile(lambda: (cycles(state, profiled), sync()),
                  f"reorth=dgks, {profiled} cycles")


def kernel_entries(rows, launches, errs, phases):
    """The ``kernels`` JSON entries: each kernel at the float32 shape its
    solve runs most (the update of the dgks path carries the fused norm),
    with the launches of the path that exercises it and, in
    ``launches_phase10`` to ``launches_phase14``, those of each path of
    phases 10-14 (``phases``: phase -> path -> counts)."""
    from arpack_ng_tpu_torch.bench import gather_primitives as gp

    ops = "arpack_ng_tpu/ops/"
    probe = "benchmarks/bench_gather_primitives.py"
    # name -> (source, the TPU kernel (or the reference's device ops) it
    # replaces, the timed row, its shape, the wrapper whose launches count)
    src = {"sel_proj": ("sel.cu", ops + "pallas_sel.py:90", "sel_proj_word",
                        JSON_K, "sel_proj"),
           "sel_update": ("sel.cu", ops + "pallas_sel.py:141",
                          "sel_update_word", JSON_K, "sel_update"),
           "rotate_rows": ("rot.cu", ops + "pallas_rot.py:91", "rotate_rows",
                           JSON_ROWS, "rotate_rows"),
           "rotate": ("rot.cu", ops + "pallas_rot.py:44", "rotate_rows", NCV,
                      "rotate_rows"),
           "cgs_proj": ("cgs.cu", ops + "pallas_cgs.py:58", "cgs_proj",
                        JSON_ROWS, "cgs_proj"),
           "cgs_update": ("cgs.cu", ops + "pallas_cgs.py:116",
                          "cgs_update+norm", JSON_ROWS, "cgs_update"),
           "dia_matvec": ("dia.cu", ops + "pallas_dia.py:47", "dia_matvec",
                          None, "dia_matvec"),
           "psell_matvec": ("psell.cu", ops + "pallas_psell.py:262",
                            "psell_matvec", None, "psell_matvec"),
           "take_flat": ("gather.cu", probe + ":118", "take_flat", None,
                         "take_flat"),
           "take_lanes": ("gather.cu", probe + ":139", "take_lanes",
                          gp.N // gp.W, "take_lanes"),
           "sym_cycle": ("sym_cycle.cu", "arpack_ng_tpu/core/device_sym.py"
                         ":141", "sym_cycle", None, "sym_cycle"),
           "dia_block": ("dia.cu", ops + "sparse.py:118", "dia_block",
                         P13_JSON_B, "dia_block_matvec")}
    entries = []
    for kname, (source, replaces, timed, shape, counter) in src.items():
        r = next(r for r in rows if r["name"] == timed
                 and r["dtype"] == "torch.float32"
                 and (shape is None or r["shape"] == shape))
        entries.append({
            "name": kname, "route": "cuda",
            "source": f"arpack_ng_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": launches[counter], "max_abs_err": errs[counter],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "lib_ms": r["library_ms"],
            "host_us": r.get("host_us"),
            "library_host_us": r.get("library_host_us"),
            "shape": f"{timed} shape={r['shape']} float32",
            **{f"launches_phase{ph}": {p: c[counter]
                                       for p, c in paths.items()}
               for ph, paths in phases.items()},
            **{k: r[k] for k in ("bound_note", "floor_ms") if k in r}})
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
        if "floor_ms" in r:
            host += f"; floor {r['floor_ms']:.4f} ms"
        if "single_ms" in r:
            host += (f"; {r['shape']} launches of the single kernel "
                     f"{r['single_ms']:.4f} ms")
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
          f"{timing.REPS} in alternation, L2 flushed by a read; card {gpu}):",
          flush=True)
    _print_rows(rows)
    print("  max abs err (f32, bf16, f64): "
          + ", ".join(f"{k} {v['err']:.3e} / {v['err_bf16']:.3e} / "
                      f"{v['err_f64']:.3e}" for k, v in rec.items())
          + f"; rotate_rows on a complex64 basis' real view "
          f"{rec['rotate_rows']['err_c64']:.3e}", flush=True)

    err_word, rows_word = check_word_events(torch, dev)
    print(f"event kernels over {NCV} rows, K read from the device (word), vs "
          f"twin and library (device-only median of {timing.REPS} in "
          f"alternation, L2 flushed by a read; K = 0 is a step without an "
          f"event; card {gpu}):", flush=True)
    _print_rows(rows_word)
    err_sym, row_sym = check_sym_cycle(torch, dev, gpu)
    rows += rows_word + [row_sym]

    launches = flagship(torch, dev, gpu)
    basis_defect(torch, dev, gpu)

    err_cgs, rows_cgs = check_cgs(torch, dev, gpu)
    err_dia, rows_dia = check_dia(torch, dev)
    fem, t_fem = fem_matrix()
    print(f"fem_triangulation({FEM_POINTS}) + RCM: {t_fem:.2f} s",
          flush=True)
    err_ps, rows_ps = check_psell(torch, dev, fem, gpu)
    print(f"phase 6 kernels vs twins (device-only median of {timing.REPS} in "
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
    errs.update({k: max(rec[k]["err"], err_word.get(k, 0.0)) for k in rec})
    errs["sym_cycle"] = err_sym["torch.float32"]
    del fem

    err_g, rows_g, launches_g = check_gather(torch, dev, gpu)
    launches.update(launches_g)
    errs.update(err_g)

    t0 = time.perf_counter()
    eigs_cycles(torch, dev, gpu)
    _, vals_9 = eigs_solves(torch, dev, gpu)
    elapsed = time.perf_counter() - t0
    print(f"eigs phase: {elapsed:.2f} s (limit {EIGS_MAX_S:.0f} s)",
          flush=True)
    if elapsed > EIGS_MAX_S:
        raise AssertionError(f"eigs phase took {elapsed:.1f} s")

    phases = {10: new_paths(torch, dev, gpu, vals_9),
              11: mode1_paths(torch, dev, gpu),
              12: transform_paths(torch, dev, gpu)}
    phases[13], err_blk, rows_blk = banded_block_paths(torch, dev, gpu)
    phases[14] = cli_paths(torch, dev, gpu)
    # the block kernel's main path: 13d(i), the flagship at b = P13_JSON_B
    launches["dia_block_matvec"] = \
        phases[13][f"13d(i) b={P13_JSON_B}"]["dia_block_matvec"]
    errs["dia_block_matvec"] = err_blk["torch.float32"]
    entries = kernel_entries(rows + rows_cgs + rows_dia + rows_ps + rows_g
                             + rows_blk, launches, errs, phases)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

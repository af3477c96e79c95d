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
   with ``reorth='dgks'`` on the same device loop (the read-free CGS +
   DGKS step: graphs captured, every cycle after the first replayed, one
   packet per cycle and per extension the host finished; its cycles in
   DGKS_BAND, 176-348, the span over seeds 0-4 of both reduced spaces,
   ``tools/flagship_seeds.py --reorth dgks``, and its cycles / nopx /
   nrorth the kernel's recorded 241 / 5390 / 5384) and again with the
   reduced space on
   the host (a witness that must repeat the host loop's 320 / 6962 / 6956
   exactly).  Each returned value must lie
   within 1e-4*|lambda| of an analytic eigenvalue and each residual
   ||Av - lambda v|| / |lambda| (scipy CSR, float64, on the host) must be
   <= 1e-3.  Each dgks path (4, 7b, 9a-c, 10b, 14a, 16a) prints the
   extensions the host finished (``arnoldi.reruns``: ``redo``, a failed
   refinement; ``breakdown``), summed up before the kernels line;
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
   cgs_kernel='pallas'`` (the device loop, its host-reduced witness
   repeating the host loop's 381 / 7832), both under the phase-4 gates
   and the device loop's dispatch gates, then (b) again
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
9. ``eigs`` at full width: first the real reduced-space kernel
   (``csrc/realnonsym_cycle.cu``) against its numpy twin on Arnoldi
   Hessenbergs of the convection-diffusion matrix (float32 and float64,
   every which; ncv = 32 with its workspace in shared memory and ncv = 69,
   the first past it), the counts and flags equal, every gap within
   ``RN_LIMITS``, two launches bit-equal, then timed at ncv = 32 beside
   the twin's host wall, the library form's wall (``torch.linalg.eig`` and
   the shifts' QR on the card, synced) and its bound; then the
   convection-diffusion operator of ``benchmarks/bench_nonsym.py`` (nx =
   1024, rho = 100, float32, k = 8, ncv = 32, which = 'LM'): (a) the
   reference's timing protocol, 2 warm cycles and 20 timed cycles at tol =
   1e-30 (ms/cycle) through ``FusedRealNonsymSolver.multi`` on the device
   loop (one reduced-space launch per cycle), beside the host loop's
   ms/cycle in the same run, then the basis defect ``||V V^T - I||_max <=
   64 sqrt(eps)`` after one more extension; (b) a solve to tol = 1e-5
   through ``eigs`` (at most EIGS_MAX_RESTARTS restarts; at nx =
   EIGS_SOLVE_NX = 512, see there) and (c) the same through
   ``eigs(A_csr)`` (DIA) with ``cgs_kernel='pallas'``, both on the device
   loop: 8 or 9 values, conjugate-closed, every residual ``||Av - lambda
   v|| / |lambda| <= 1e-3`` (scipy CSR, float64, complex vectors, on the
   host), the rotation and reduced-space kernels launched, graphs
   captured, every cycle after the first replayed, one packet and one
   reduced-space launch per cycle and host rerun, the cycles in
   EIGS_BAND; (b) again with the reduced space on the host (the witness)
   and on the host loop, which must agree in cycles, nopx and nrorth; the
   phase within EIGS_MAX_S.  No value is held to the analytic spectrum: the
   operator is strongly non-normal, and float32 pairs converged by
   residual may lie in its pseudospectrum;
10. the hybrid driver and complex dtypes at full width, float32 /
   complex64, k = 8, ncv = 32, tol = 1e-5; every hybrid solve runs the
   device loop (``core/iram.IRAMSolver``: a CUDA graph per start k, one
   packet a cycle and host rerun, the reduced space on the host), and
   (a)-(c)'s again on the eager host loop (``_host_loop``), which must
   give the same values and vectors bit for bit and equal cycles, nopx,
   nrorth, nrorthr and launches (both walls and ms per step printed): (a)
   the flagship through ``eigsh(strategy='hybrid')`` (the reduced space
   on the host in float64, the event and rotation kernels) under the
   phase-4 gates; (b)
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
   (the hybrid driver, its complex restart a GEMM), cut to nx = 512 to
   compare with 9b: 8 values,
   residuals ``<= 1e-3``; how far its values lie from 9b's as sets is
   reported beside 9c's distance from 9b (both drivers' float32 values lie
   in the operator's pseudospectrum, above its real spectrum); 10c's
   'auto' solve again with the reduced space on the host (a witness, not
   counted); the phase within P10_MAX_S;
11. the rest of mode 1 at full width, float32 / complex64, k = 8,
   ncv = 32, tol = 1e-5: first the complex reduced-space kernel
   (``csrc/cplx_cycle.cu``, row 13) against its numpy twin on complex
   Arnoldi Hessenbergs (a complex matrix, the convection-diffusion matrix
   from a complex and from a real start, a normal matrix; complex64 and
   complex128; ncv in ``CX_NCVS``, 3 to 100, past the shared-memory
   limit at 52; every which at ncv = 32), the counts equal, the chase's
   shift count np_eff, the kept block's values the packet's kept values,
   every gap within ``CX_LIMITS`` (the cases whose conditioning exempts a
   check named, the normal matrix's none), two launches bit-equal, a done, a last and a breakdown cycle leaving
   H, Q and sk, then timed at ncv = 32 beside the twin's host wall, the
   library form's wall (``torch.linalg.eig`` and the shifts' QR on the
   card, synced), its bound and the first design's time (``CX_FIRST_MS``),
   with its stamps (the shift choice, the reflector chain, the tail behind
   it; outside the phase's clock); then (a)
   ``eigs(A_csr, strategy='fused')`` on the
   conv-diff operator at nx = 1024 imported as DIA (complexified: two DIA
   launches per complex matvec; the copy that gives the kernel contiguous
   real and imaginary parts timed beside the two launches) and (b)
   ``eigs(strategy='fused')`` on ``convection_diffusion_2d(1024,
   complex64)``, both on the device loop (``FusedNonsymSolver``: a CUDA
   graph per start k, one packet and one row-13 launch per cycle and host
   rerun): every residual ``<= 1e-3``, (a)'s values closed under
   conjugation within 1e-3 relative but for the last (a complex driver
   may cut a pair at k), count, info, cycles, ms per cycle, packets,
   graphs and launches reported; each again with the reduced space on
   the host (the twin patched in, the witness) and on the host loop
   (``HostLoopSolver.solve``), which must agree in cycles, nopx and
   nrorth, their ms per cycle beside the kernel's; 8 values and info 0
   at nx = 1024; (c) the flagship through
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
   (``from_scipy(format='dia')``) runs the DIA kernel, each of the six
   IC(0) triangle sweeps one launch of its epilogue form
   (``dia_matvec_sub``; first held bit for bit against its twins on the
   triangles' tables in its three forms and timed at these float64 shapes
   beside ``dia_kernel`` and ``torch.addmv``), every other vector pass a
   fused update kernel (``cg_xr``, ``cg_p_test``; first held bit for bit
   against the twins' ``cg_step`` over five iterations on the operator's
   own vectors); the operator declared ``capturable``: each solve one
   CUDA-graph WHILE node (``ops/cuda_krylov_loop``; before 12a, the
   loop-test kernel against the host's test on edge inputs, alone and
   before a node whose body ends with ``cg_p_test``, and the update
   kernels against their twins in every dtype on edge inputs, the test
   they end with against the host's, each timed); gates: every value
   within 1e-6*|lambda| of the analytic spectrum, every residual ``||Av -
   lambda v|| / max(1, |lambda|) <= 1e-6``, no solve at its cap, per CG
   iteration exactly one DIA product, six sweeps, one ``cg_xr`` and one
   ``cg_p_test`` and no loop-test launch, before each solve one product
   and six sweeps, one loop-test launch before each node, graphs
   captured and replayed, one packet a cycle; the witnesses, the same
   solve at the same width through the host loop (``capturable=False``),
   bit for bit in values, vectors, each solve's iterations, cycles, nopx,
   nrorth, nrorthr and launches, and on the graphs with the update
   kernels' twins patched in (torch ops, the test kernel ending each
   body), bit for bit in values, vectors, iterations and counters;
   reported: cycles, nopx, CG iterations per solve, the solves on the
   graphs, ms per CG iteration (the solve's wall over its iterations), and
   one iteration with the loop test's read, without it and as a WHILE
   node (in turns), beside its bytes as written and its least bytes over
   3.35 TB/s, host set-up apart; (b)
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
   P12_BICG_NX, the DIA kernel for the products, its epilogue form for
   the triangle sweeps, the update kernels ``bicg_p``, ``bicg_s``,
   ``bicg_r``, ``bicg_x_test``, first held bit for bit against the twins'
   ``bicgstab_step`` over five iterations on the operator's vectors; on
   the graphs, its solves WHILE nodes, graphs captured, the launches per
   iteration exact): at
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
   by the block DIA twin on the card in float64; each cycle after the
   first a replay of the solve's one CUDA graph, then the same solve with
   the operator declared not capturable (every cycle eager): equal
   cycles, matvecs and launches, values and vectors bit for bit; wall,
   cycles, matvecs, ms per cycle on the graph and eager, the share of
   ``eigh`` of T in it and ms per block apply; (e) the block DIA kernel against its twin on both tables, b in
   {1, 2, 4, 8}, float32 and float64, at n and n + 3, bit for bit (and
   each column against the single kernel), timed beside its bound, b
   single launches and ``torch.sparse.mm`` (cuSPARSE SpMM), each timed
   shape's plan printed (runs, tile rows, shared bytes and blocks per SM),
   then untimed the case list of ``tests/torch_dia_cases.py`` (both
   dtypes, b = 1-9, 16, 17) under the same equalities; the phase within
   P13_MAX_S;
14. the file entry points (each path's launches counted from zero): (a)
   the main path: the flagship's Laplacian written as a MatrixMarket file
   (``io.matrix_market.write_matrix``, then read back: both seconds
   printed), then ``python -m arpack_ng_tpu_torch.cli --A lap.mtx --nbEV
   8 --nbCV 32 --mag LA --tol 1e-5 --simplePrec --json`` in its own
   process on the card, then the same in this process (the reference
   CLI's reorthogonalization, dgks, on the hybrid's device loop: the
   rotation and DIA kernels); gates: rc 0, 8 values within 1e-4*|lambda|
   of the analytic spectrum, the CLI's own residuals ``<= 1e-3``, the
   in-process run's cycles / nopx / nrorth the host step's 299 / 6379 /
   6372, a graph replayed every cycle after the first and a packet read
   a cycle (its wall printed beside the one recorded on the host loop
   while the step read back); (b) the run with ``--maxIt P14_CUT
   --dump`` (rc 1), then ``--restart`` from the file, on graphs: its
   cycles, nopx, nrorth, nrotr and values must be the unbroken run's
   exactly; (c) the flagship on the
   device loop (``eigsh``'s config, CUDA graphs) stopped at the boundary
   after P14_CUT cycles (``FusedSymSolver.multi``), ``save_state``,
   ``load_state`` into a fresh solver, resumed: the totals must be
   ``KERNEL_COUNTERS['flagship selective']``, the values phase 4's gates;
   (d) the ``--slv`` menu: CG with the IC(0) preconditioner for
   shift-invert at sigma = 0 on the Laplacian at nx = P14_SI_NX, float64
   (values within 1e-6*|lambda| of the analytic spectrum, residuals ``/
   max(1, |lambda|) <= 1e-6``; the hybrid's graphs, its solves WHILE
   nodes), and LU for dsdrv3-6's pencil at n =
   P14_PENCIL_N (1e-8); (e) the seven examples of
   ``arpack_ng_tpu_torch.examples`` once each, residuals under
   P14_EXAMPLE_RES, the event, rotation, PSELL and reduced-space kernels
   launched; the phase within P14_MAX_S;
15. the distribution layer (``mesh=``, each path's launches counted from
   zero): (a) the main path, a world of one under NCCL (its collectives
   captured in the device loop's CUDA graphs): the flagship through
   ``eigsh(mesh=)``, first on ``laplacian_2d_sharded(nx, nx)`` (the halo
   operator) and then on ``laplacian_2d`` lifted onto the mesh (its input
   all-gathered); a world of one sums nothing, so each must give the
   kernel's counters ``KERNEL_COUNTERS['flagship selective']`` exactly,
   under phase 4's value and residual gates, with one packet per cycle
   and every cycle after the first replayed; printed: the collectives per
   step by kind, the graphs and replays, the wall beside phase 4's, the
   launches; (b) P15_RANKS spawned ranks on the one card under gloo
   (NCCL does not run two ranks on one device; the transport is printed):
   the same solve on ``laplacian_2d_sharded``, the ranks' values equal bit
   for bit, each rank under phase 4's value and residual gates (not its
   cycle band, which was measured on one rank's sums); printed: the
   counters, the collectives per step and their share of the solve's
   wall (each collective timed between device syncs); (c) the same ranks:
   ``eigs(strategy='hybrid')`` on ``convection_diffusion_2d(EIGS_SOLVE_NX)``
   under phase 9's gates and ``svds`` of 12d's matrix (method 'normal')
   under 12d's gates, values bit-equal across the ranks; the phase within
   P15_MAX_S, the ranks' own collectives within P15_COLLECTIVE_TIMEOUT_S;
16. the C ABI (``native/src/capi.cc`` built unchanged against the port's
   ``native_bridge`` by ``arpack_ng_tpu_torch.native_capi``, loaded in this
   process with ``ctypes.PyDLL``; each path's launches counted from zero):
   (a) the main path, the flagship's CSR (nx = 1024, float32) through
   ``atpu_eigsh_csr_s`` (k = 8, ncv = 32, 'LA', tol = 1e-5; the bridge's
   hybrid driver with the reference bridge's dgks: the rotation kernel and
   the DIA kernel, ``from_scipy`` importing the CSR as DIA; the event
   kernels are not on this path); gates: rc 0, nconv >= 8, phase 4's
   value and residual gates, the rotation and DIA kernels launched, the
   bridge of this process ran the solve, and its cycles / nopx / nrorth
   the host step's 299 / 6379 / 6372, on the hybrid's device loop (a
   graph replayed every cycle after the first, a packet a cycle);
   ``atpu_stat_c``'s counters and the wall printed beside 10a's; (b) ``atpu_eigsh_matvec_s`` with a C
   callback (``csrc/stencil5.c``, the same 5-point stencil) **cut to nx =
   P16_MV_NX**: every OP*x crosses to the host and back; same gates, the
   rotation kernel launched; ms per round trip and ``tmvopx``'s share of
   the wall printed; (c) the unchanged ``native/tests/test_capi.c``
   against the port's library as a subprocess on the default device: rc
   0 and ``C-ABI OK`` (its parallel block skips in a world of one); the
   phase within P16_MAX_S.

    python3 chip_smoke.py --profile

runs phases 1-2 and then, in place of phases 3-9, the restart-cycle
profile of the flagship behind ``PERF.md`` section 5: for each reorth
variant on the device loop (selective, then dgks), and for dgks on the
host loop with the host's step, the wall per Lanczos step over steady
cycles, the card's busy share and largest device items under
``torch.profiler``, and the host's ``cProfile``.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  The script needs no
network and exits non-zero without a CUDA device or outside the
repository.
"""
from __future__ import annotations

import argparse
import contextlib
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
                   "(a)": (236, 5321),
                   "flagship dgks": (241, 5390, 5384)}
#: the dgks solves' counters on the host loop (PERF.md), (cycles, nopx,
#: nrorth) of the flagship and (cycles, nopx) of 7b: the dgks device loop
#: with the reduced space on the host repeats them exactly (its read-free
#: steps compute the host step's bits)
DGKS_HOST_COUNTERS = {"flagship dgks": (320, 6962, 6956), "(b)": (381, 7832)}
#: the gate on the dgks flagship's cycles on the device loop: the span of
#: its cycles over start-vector seeds 0-4 on the card, with the
#: reduced-space kernel (241-348) and with the host loop's reduced space
#: (176-320) (``tools/flagship_seeds.py --reorth dgks``; PERF.md section 6)
DGKS_BAND = (176, 348)
#: the dgks counters (cycles, nopx, nrorth) of the CLI (14a) and the C ABI
#: (16a): the hybrid driver's reduced space is on the host, so the
#: read-free extension repeats the host step's run exactly
HYBRID_DGKS_COUNTERS = (299, 6379, 6372)
#: walls recorded while the dgks step read back every step (PERF.md;
#: NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's
RECORDED_WALLS = {"flagship dgks": "5.56-5.80 s", "14a": "5.65 s",
                  "16a": "4.24-5.10 s"}
#: the kernels the dgks flagship must launch on the device loop
DGKS_PATH = ("rotate_rows", "sym_cycle")
#: the extensions the host finished by path (``arnoldi.reruns``: a failed
#: dgks refinement or doubtful event, ``redo``; a breakdown)
RERUNS = {}
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
#: the kernel every 11a-b solve on the device loop must launch
P11_PATH = ("cplx_cycle",)
#: the kernels the real eigs loop must launch (9a-c), and the gate on 9b's
#: and 9c's cycles: the span of 9b's and 9c's cycles over start-vector
#: seeds 0-4 on the card, with the real reduced-space kernel (40-48) and
#: with its twin on the host (40-48) (``tools/eigs_seeds.py`` on an NVIDIA
#: H100 80GB HBM3 at 700 W; PERF.md section 6)
EIGS_PATH = ("rotate_rows", "realnonsym_cycle")
EIGS_BAND = (40, 48)
#: the real reduced-space kernel against its twin (phase 9 and
#: tests/test_torch_gpu.py): the largest gap each check allows, in the
#: units of ``_rn_gaps`` (sorted Ritz values over max |lambda|, bounds over
#: their max, Q's kept columns, sigmak, Hc's kept block over max |H0|);
#: and the band around the chase's guard (a factor on either side of its
#: limit, eps23 max|H0|) in which the two may decide the implicit redo
#: differently (the explicit chase's loss there is rounding amplified by
#: near-zero pivots; PERF.md section 6): the kernel's restart is then held
#: to the relation its own decision promises
RN_GUARD_BAND = 64.0
RN_LIMITS = {
    "torch.float64": dict(values=1e-12, bounds=1e-10, Q=1e-9, sigmak=1e-9,
                          H=1e-9),
    "torch.float32": dict(values=1e-12, bounds=1e-10, Q=1e-5, sigmak=1e-5,
                          H=1e-5)}
#: row 13, the complex reduced-space kernel against its twin (phase 11 and
#: tests/test_torch_gpu.py): the largest gap each check allows, in the units
#: of ``_cx_gaps`` (the sorted values over max |lambda| and the bounds over
#: their max, each against the twin's at its place or one either side; how
#: far the packet's which-keys fall from ascending, over max |lambda|; the
#: values of the shifted Hc's kept block against the packet's kept values,
#: over max |lambda|; the kept columns' space; where the sorted order is the
#: twin's, Q's kept columns, sigmak and Hc's kept block over max |H0|, entry
#: by entry; the restart's Arnoldi relation over max |H0|); the outputs are
#: rounded to complex64 in phase 11's dtype.  Its cases: the sizes (ncv = 3
#: to past ``max_shared_ncv``, 52) and the sources of ``_cx_hessenberg``;
#: the 'normal' source is conditioned well enough at every size that no
#: check is exempt there
CX_LIMITS = {
    "torch.complex128": dict(values=1e-12, bounds=1e-10, sorted=1e-12,
                             kept=1e-11, space=1e-9, Q=1e-9, sigmak=1e-9,
                             H=1e-9, relation=1e-12),
    "torch.complex64": dict(values=1e-12, bounds=1e-10, sorted=1e-12,
                            kept=1e-5, space=1e-5, Q=1e-5, sigmak=1e-5,
                            H=1e-5, relation=1e-4)}
CX_NCVS = (3, 8, NCV, 53, 100)
#: row 13's first design at ncv = 32, complex64, 'LM' on the same input, ms
#: device-only on an H100 at 700 W (PERF.md section 6), printed beside this
#: run's time
CX_FIRST_MS = 3.1940
CX_SOURCES = ("complex", "convdiff", "realified", "normal")
#: phase 10c: the imaginary part of the Hermitian tridiagonal's
#: off-diagonal; phase 10's restart cap (10b, 10d) and wall limit, seconds
#: (about three times the 42 s it takes on an H100 at 700 W, PERF.md
#: section 6)
HERM_C = 0.5
P10_MAX_RESTARTS = 1000
P10_MAX_S = 120.0
#: phase 11: the restart cap of its solves (11d, caller's shifts without
#: nev inflation, took 861 cycles on an H100, PERF.md section 6), its wall
#: limit (seconds; 63-76 s there) and the grid of 11e
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
#: (``distributed_laplacian`` runs as a world of one there)
P14_EXAMPLE_RES = {"dssimp": 1e-3, "dnsimp": 1e-8, "dsdrv4_shift_invert":
                   1e-6, "zndrv1": 1e-8, "svd": 1e-8, "validate_f64": 1e-2,
                   "irregular_sparse": 1e-3, "distributed_laplacian": 1e-3}
#: phase 15: the ranks of 15b-c (gloo on the one card), the seconds one of
#: their collectives may wait before it raises, and the phase's wall
#: limit, seconds
P15_RANKS = 2
P15_COLLECTIVE_TIMEOUT_S = 300
P15_MAX_S = 300.0
#: phase 16: the matrix-free path's grid (16b; each OP*x crosses to the
#: host and back, so it is cut from NX), the test client's time limit and
#: the phase's wall limit, seconds
P16_MV_NX = 256
P16_CLIENT_S = 300
P16_MAX_S = 90.0
#: walls and solver stats of earlier phases that phases 15-16 print beside
#: their own
WALLS = {}
STATS = {}
#: 12a's CG pace (ms per iteration: read, free, graph) and bytes
CG_PACE = {}
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


def _arnoldi_hessenberg(ncv, seed, nx=48, rho=100.0):
    """H and rnorm of ncv Arnoldi steps (two CGS passes) on phase 9's
    convection-diffusion matrix at a host size (float64, a seeded start):
    the Hessenbergs the real eigs loop hands its reduced space."""
    from arpack_ng_tpu_torch.models import convection_diffusion_2d

    _, a = convection_diffusion_2d(nx, rho=rho, dtype=np.float64,
                                   device="cpu")
    return _arnoldi_on(a, ncv, seed)


def _arnoldi_on(a, ncv, seed):
    """H and rnorm of ncv Arnoldi steps (two CGS passes) on the matrix
    ``a`` (float64) from a start drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    n = a.shape[0]
    V = np.zeros((ncv + 1, n))
    H = np.zeros((ncv, ncv))
    v = rng.uniform(-1, 1, n)
    V[0] = v / np.linalg.norm(v)
    for j in range(ncv):
        w = a @ V[j]
        for _ in range(2):
            h = V[:j + 1] @ w
            w = w - V[:j + 1].T @ h
            H[:j + 1, j] += h
        rn = np.linalg.norm(w)
        if j + 1 < ncv:
            H[j + 1, j] = rn
        V[j + 1] = w / rn
    return H, rn


def _rn_params(crc, dt, which, nev):
    f = np.finfo(np.float32 if dt == "torch.float32" else np.float64)
    R = f.dtype.type
    return crc.Params(which=which, nev=nev,
                      tol=float(R(1e-5 if dt == "torch.float32" else 1e-10)),
                      eps23=float(R(f.eps ** (2 / 3))), eps_m=float(f.eps),
                      safmin=float(f.tiny))


def _rn_buffers(torch, crc, H, rnorm, dt, where):
    ncv = H.shape[0]
    t = dict(dtype=dt, device=where)
    return [torch.tensor(H, **t), torch.tensor(rnorm, **t),
            torch.tensor(-1, dtype=torch.int32, device=where),
            torch.tensor(0, dtype=torch.int32, device=where),
            torch.zeros(4, dtype=torch.int64, device=where),
            torch.zeros(ncv, ncv, **t), torch.zeros(2, **t),
            torch.zeros(crc.packet_size(ncv), dtype=torch.float64,
                        device=where)]


def _rn_run(torch, crc, H, rnorm, dt, where, p, is_last=False):
    bufs = _rn_buffers(torch, crc, H, rnorm, dt, where)
    crc.realnonsym_cycle(*bufs, p, is_last)
    return [x.double().cpu().numpy() for x in
            (bufs[0], bufs[5], bufs[6], bufs[7])]


def _rn_gaps(crc, twin, other, H0):
    """How far one real reduced-space result lies from the twin's, in the
    units of ``RN_LIMITS``; whether the packet's counts and flags (done,
    nconv, nev_eff, np_eff, info, the implicit chase) are equal; and the
    other's restart relation ``|H0 Q_k - Q_{k+1} Hc[:k+1, :k]|`` over max
    |H0| (not gated against the twin: reported).  Where the two decided
    the implicit redo differently, Q, sigmak and Hc are not compared
    (``implicit_equal`` False)."""
    (tH, tQ, tsk, tpk), (kH, kQ, ksk, kpk) = twin, other
    ncv, P = H0.shape[0], crc.P_HEAD
    lam = np.hypot(tpk[P:P + ncv], tpk[P + ncv:P + 2 * ncv]).max()
    bnd = tpk[P + 2 * ncv:P + 3 * ncv]
    out = {"values": float(np.abs(kpk[P:P + 2 * ncv]
                                  - tpk[P:P + 2 * ncv]).max() / lam),
           "bounds": float(np.abs(kpk[P + 2 * ncv:P + 3 * ncv] - bnd).max()
                           / max(bnd.max(), 1e-300)),
           "counts_equal": all(kpk[i] == tpk[i] for i in (
               crc.P_DONE, crc.P_NCONV, crc.P_NEV, crc.P_NP, crc.P_INFO)),
           "implicit_equal": kpk[crc.P_IMPL] == tpk[crc.P_IMPL]}
    if not tpk[crc.P_DONE]:
        k = int(tpk[crc.P_NEV])
        scale = np.abs(H0).max()
        out["relation"] = float(np.abs(H0 @ kQ[:, :k] - kQ[:, :k + 1]
                                       @ kH[:k + 1, :k]).max() / scale)
        if out["implicit_equal"]:
            out.update(
                Q=float(np.abs(kQ[:, :k] - tQ[:, :k]).max()),
                sigmak=float(abs(ksk[0] - tsk[0])),
                H=float(np.abs(kH[:k + 1, :k] - tH[:k + 1, :k]).max()
                        / scale))
    return out


def _rn_library(torch, crc, H, rnorm, shifts):
    """The library form of one cycle's real reduced space on the card (the
    yardstick, used nowhere in the port): ``torch.linalg.eig`` (values and
    the vectors the bounds need; it syncs), the bounds, then one
    ``torch.linalg.qr`` per shift (a real shift, or a conjugate pair as
    one double shift) with Q accumulated, as the host loop's numpy chase
    runs them."""
    w, X = torch.linalg.eig(H)
    bounds = rnorm * torch.abs(X[-1]) / torch.linalg.vector_norm(X, dim=0)
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    Hc, Q = H, eye
    for mur, mui in shifts:
        if mui > 0:
            M = Hc @ Hc - (2.0 * mur) * Hc + (mur * mur + mui * mui) * eye
        else:
            M = Hc - mur * eye
        q, _ = torch.linalg.qr(M)
        Hc = torch.triu(q.T @ Hc @ q, -1)
        Q = Q @ q
    torch.cuda.synchronize()
    return bounds, Q


def _reflector_flops(n, js, m, q_rows):
    """Flops of Householder reflectors of order ``m`` at the rows ``js`` of
    an n x n Hessenberg T, applied from both sides, and to ``q_rows`` rows
    of an accumulated Q: reflector j changes rows j..j+m-1 from column j-1
    on (4 m flops a column) and columns j..j+m-1 down to row j+m (4 m a
    row)."""
    flops = 0
    for j in js:
        mj = min(m, n - j)
        flops += 4 * mj * ((n - max(j - 1, 0)) + min(j + mj + 1, n) + q_rows)
    return flops


def _rn_ops(crc, H, rnorm, p):
    """The operations this input needs: the QR sweeps of its Schur form and
    the shifts of its chase as the twin takes them (counted on its
    ``np.linalg.qr`` calls and its implicit chases; a double shift, of
    order 3, where the shifted matrix has a second subdiagonal): each
    reflector that changes something (one per nonzero subdiagonal entry of
    the shifted matrix; n - 1 in an implicit chase) applied to the
    Hessenberg T from both sides over the rows and columns it reaches, to
    Q's last row in the Schur sweeps (the bounds need no more of it) and
    to all of Q in the chase; dtrevc's back-substitution over the rows each
    eigenvector solves (row l of eigenvector i: 2 (i - l) flops) with its
    last component and norm; and the guard's check of the kept columns,
    ``(Q^T H0 Q)[:, :k]`` (3 n^2 k).  Returns ``(flops, detail, head)``,
    the head the twin's."""
    from unittest import mock

    n = H.shape[0]
    real_qr, real_implicit = np.linalg.qr, crc._implicit_q
    tally = {"schur": [0, 0, 0], "chase": [0, 0, 0]}
    where = ["schur"]

    def qr(M, *args, **kwargs):
        double = bool(np.any(np.diag(M, -2) != 0))
        js = np.nonzero(np.diag(M, -1) != 0)[0]
        t = tally[where[0]]
        t[int(double)] += 1
        t[2] += _reflector_flops(n, js, 3 if double else 2,
                                 1 if where[0] == "schur" else n)
        return real_qr(M, *args, **kwargs)

    def implicit_q(Hc, mur, mui):
        t = tally["chase"]
        t[int(mui > 0)] += 1
        t[2] += _reflector_flops(n, range(n - 1), 3 if mui > 0 else 2, n)
        return real_implicit(Hc, mur, mui)

    with mock.patch.object(np.linalg, "qr", qr), \
            mock.patch.object(crc, "_implicit_q", implicit_q):
        h = crc.head_plain(H, rnorm, p)
        where[0] = "chase"
        if not h.done:
            crc.shifts_plain(H, h, p)
    (s1, s2, fs), (c1, c2, fc) = tally["schur"], tally["chase"]
    trevc = (n - 1) * n * (n + 1) // 3 + 2 * n * (n + 1)
    guard = 0 if h.done else 3 * n * n * h.nev_eff
    return fs + fc + trevc + guard, (
        f"{s1} single and {s2} double Schur sweeps, {c1} real and {c2} "
        f"double shifts"), h


def _rn_guard_case(crc, H, rn, p, kern, g, lim, what):
    """A case where the kernel and the twin decided the implicit redo
    apart: the twin's explicit chase must have lost within
    ``RN_GUARD_BAND`` of the guard's limit, and the kernel's restart keep
    the relation its own decision promises (the guard's limit after the
    explicit chase, 10 times RN_LIMITS' H after the redo)."""
    h = crc.head_plain(H, np.float64(rn), p)
    _, _, lost, limit = crc.explicit_chase(H, h, p)
    impl = kern[3][crc.P_IMPL]
    allowed = max(0.0 if impl else p.eps23, 10 * lim["H"])
    if not (limit / RN_GUARD_BAND < lost < limit * RN_GUARD_BAND) \
            or g["relation"] > allowed:
        raise AssertionError(
            f"{what}: implicit redo {bool(impl)} on the card, "
            f"{not impl} in the twin, whose explicit chase lost "
            f"{lost / limit:.3e} of the guard's limit; the kernel's "
            f"relation {g['relation']:.3e} (allowed {allowed:.1e})")


def check_realnonsym_cycle(torch, dev, gpu):
    """Phase 9, the real reduced-space kernel (``csrc/realnonsym_cycle.cu``)
    against its numpy twin on Arnoldi Hessenbergs of the convection-
    diffusion matrix (ncv = 32, nev = 8, every ``which``, three seeds, the
    workspace in shared memory; the first ncv past it, 69, the matrices in
    global memory, one seed), float32 (phase 9's) and float64: the
    packet's counts and flags equal, every gap within ``RN_LIMITS``, two
    launches equal bit for bit; then timed at ncv = 32, 'LM', float32: the
    kernel device-only (each call after a copy restoring H), the twin's
    host wall per call and the library form's wall per call
    (``torch.linalg.eig`` + the shifts' QR loop on the card, synced).
    Returns ``(err, row)``: the float32 gaps' largest value gap, the timed
    row of the kernels line."""
    from arpack_ng_tpu_torch.ops import cuda_realnonsym_cycle as crc

    ncv, top = NCV, crc.max_shared_ncv() + 1
    err = {}
    borderline = []
    for dt in (torch.float32, torch.float64):
        lim = RN_LIMITS[str(dt)]
        rdt = np.float32 if dt == torch.float32 else np.float64
        over = []
        for m, seeds in ((ncv, 3), (top, 1)):
            worst = {}
            for which in crc.WHICH:
                p = _rn_params(crc, str(dt), which, 8 if m == ncv else m // 4)
                for seed in range(seeds):
                    H, rn = _arnoldi_hessenberg(m, seed)
                    H = H.astype(rdt).astype(np.float64)
                    kern = _rn_run(torch, crc, H, rn, dt, dev, p)
                    twin = _rn_run(torch, crc, H, rn, dt, torch.device("cpu"),
                                   p)
                    g = _rn_gaps(crc, twin, kern, H)
                    what = f"realnonsym_cycle {dt} {which} seed {seed} ncv {m}"
                    if not g.pop("counts_equal"):
                        raise AssertionError(
                            f"{what}: counts differ, kernel "
                            f"{kern[3][:crc.P_HEAD]} twin "
                            f"{twin[3][:crc.P_HEAD]}")
                    if not g.pop("implicit_equal"):
                        _rn_guard_case(crc, H, rn, p, kern, g, lim, what)
                        borderline.append((str(dt)[6:], m, which, seed))
                    for key, v in g.items():
                        worst[key] = max(worst.get(key, 0.0), v)
                    if m == ncv and seed == 0:
                        again = _rn_run(torch, crc, H, rn, dt, dev, p)
                        if not all(np.array_equal(a, b)
                                   for a, b in zip(kern, again)):
                            raise AssertionError(
                                f"realnonsym_cycle {dt} {which}: two "
                                "launches differ")
            print(f"  realnonsym_cycle vs twin {dt} ncv={m}, largest gaps "
                  f"over every which (implicit redo decided apart, within "
                  f"the guard's band, so far: {borderline}): " + ", ".join(
                      f"{k} {v:.3e}" + (f" (limit {lim[k]:.0e})"
                                        if k in lim else "")
                      for k, v in worst.items()), flush=True)
            over += [(m, k) for k, v in worst.items()
                     if k in lim and v > lim[k]]
            if m == ncv:
                err[str(dt)] = worst["values"]
        if over:
            raise AssertionError(f"realnonsym_cycle {dt}: kernel and twin "
                                 f"differ past the limits at {over}")
    # the timed row: ncv = 32, 'LM', float32, seed 0
    p = _rn_params(crc, "torch.float32", "LM", 8)
    H, rn = _arnoldi_hessenberg(ncv, 0)
    H = H.astype(np.float32).astype(np.float64)
    bufs = _rn_buffers(torch, crc, H, rn, torch.float32, dev)
    H0 = bufs[0].clone()

    def kernel():
        bufs[0].copy_(H0)
        crc.realnonsym_cycle(*bufs, p, False)

    cpu = _rn_buffers(torch, crc, H, rn, torch.float32, torch.device("cpu"))
    H0c = cpu[0].clone()

    def twin():
        cpu[0].copy_(H0c)
        crc.realnonsym_cycle_plain(*cpu, p, False)

    flops, detail, h = _rn_ops(crc, H, np.float64(rn), p)
    shifts = crc.shift_pool(h, p.nev)
    Hd = torch.tensor(H, dtype=torch.float64, device=dev)
    walls = {}
    for name, fn in (("plain_ms", twin), ("library_ms", lambda: _rn_library(
            torch, crc, Hd, rn, shifts))):
        fn()
        ts = []
        for _ in range(timing.REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        walls[name] = float(np.median(ts))
    ms = timing.alternating_ms([kernel], timing.flush_buffer(dev))[0]
    clk = torch.zeros(crc.clock_size(ncv), dtype=torch.int64, device=dev)
    bufs[0].copy_(H0)
    crc.realnonsym_cycle(*bufs, p, False, clocks=clk)
    clocks = _rn_clocks(crc, clk.cpu().numpy())
    bound = flops / (PEAK_FLOPS["torch.float64"] / SMS) * 1e3
    row = {"name": "realnonsym_cycle", "dtype": "torch.float32",
           "shape": ncv, "ms": ms, "plain_ms": walls["plain_ms"],
           "library_ms": walls["library_ms"], "bound_ms": bound,
           "bound_by": "operations", "bytes": 0, "flops": flops,
           "bound_note": "operations this input needs (the Householder "
                         "reflectors of its Schur sweeps and shifts over "
                         "the Hessenberg rows and columns they reach, "
                         "dtrevc's rows, the guard) over one SM's float64 "
                         "rate (the kernel is one block and computes in "
                         "double), not the card's roofline",
           "np_eff": h.np_eff, "clocks": clocks}
    print(f"  realnonsym_cycle ncv={ncv} float32 ({detail}): kernel "
          f"{ms:.4f} ms device-only, twin {walls['plain_ms']:.4f} ms host, "
          f"library (eig + {len(shifts)} QR on the card, with syncs) "
          f"{walls['library_ms']:.4f} ms; bound {bound:.6f} ms ({flops} "
          f"flops over one SM's float64 rate, {100 * bound / ms:.2f}% of "
          f"it); card {gpu}", flush=True)
    print("  realnonsym_cycle phase clocks (SM cycles, one launch; the QR "
          "steps' parts summed over its sweeps and shifts): " + ", ".join(
              f"{k} {v}" for k, v in clocks.items()), flush=True)
    return err, row


def _rn_clocks(crc, c):
    """A reduced-space kernel's stamp buffer (rows 12 and 13) as named
    numbers: each phase's SM cycles (the difference of consecutive
    stamps), the QR steps' parts summed over the Schur sweeps and the
    chase's shifts, and the counts of both."""
    nc, nl = len(crc.CLOCKS), len(crc.LAPS)
    out = dict(zip(crc.CLOCKS[1:], np.diff(c[:nc]).tolist()))
    out.update(zip(crc.LAPS, c[nc:nc + nl].tolist()))
    out.update(zip(crc.COUNTS, c[nc + nl:].tolist()))
    return out


def _cx_arnoldi_on(a, ncv, seed, cplx=True):
    """H and rnorm of ncv complex Arnoldi steps (two CGS passes) on the
    matrix ``a`` from a start drawn from ``seed``: complex, or with
    ``cplx`` False real (a real ``a`` then gives a real-valued H, as the
    complexified real operator does)."""
    rng = np.random.default_rng(seed)
    n = a.shape[0]
    V = np.zeros((ncv + 1, n), np.complex128)
    H = np.zeros((ncv, ncv), np.complex128)
    v = rng.uniform(-1, 1, n) + (1j * rng.uniform(-1, 1, n) if cplx else 0)
    V[0] = v / np.linalg.norm(v)
    for j in range(ncv):
        w = a @ V[j]
        for _ in range(2):
            h = V[:j + 1].conj() @ w
            w = w - V[:j + 1].T @ h
            H[:j + 1, j] += h
        rn = np.linalg.norm(w)
        if j + 1 < ncv:
            H[j + 1, j] = rn
        V[j + 1] = w / rn
    return H, rn


def _cx_hessenberg(ncv, seed, source, nx=24, rho=50.0):
    """Row 13's inputs: the Hessenberg the complex cycle hands its reduced
    space, from ``source``: 'complex' (the convection-diffusion matrix
    plus a seeded imaginary diagonal in [0, 1): no conjugate pairs, so no
    ties), 'convdiff' (the real matrix from a complex start, as 11b's
    complex64 stencil runs), 'realified' (the real matrix from a real
    start, as 11a's complexified operator runs: a real-valued H) or
    'normal' (a seeded normal matrix of order 8 ncv, values of modulus in
    [0.2, 1) at seeded angles, from a complex start: Ritz values of
    condition near 1 and a chase whose Q moves less than 1e-10 under a
    rounding of H at every ncv, where the others' grow with ncv)."""
    import scipy.sparse as sp

    from arpack_ng_tpu_torch.models import convection_diffusion_2d

    if source == "normal":
        rng = np.random.default_rng(200 + seed)
        n = 8 * ncv
        lam = rng.uniform(0.2, 1, n) * np.exp(2j * np.pi * rng.uniform(0, 1,
                                                                       n))
        u, _ = np.linalg.qr(rng.standard_normal((n, n))
                            + 1j * rng.standard_normal((n, n)))
        return _cx_arnoldi_on((u * lam) @ u.conj().T, ncv, seed)
    a = convection_diffusion_2d(nx, rho=rho, dtype=np.float64,
                                device="cpu")[1].astype(np.complex128)
    if source == "complex":
        d = np.random.default_rng(100 + seed).uniform(0, 1, a.shape[0])
        a = (a + sp.diags(1j * d)).tocsr()
    return _cx_arnoldi_on(a, ncv, seed, cplx=source != "realified")


def _cx_params(ccc, dt, which, nev, tol=None):
    f = np.finfo(np.float32 if dt == "torch.complex64" else np.float64)
    R = f.dtype.type
    if tol is None:
        tol = 1e-5 if dt == "torch.complex64" else 1e-10
    return ccc.Params(which=which, nev=nev, tol=float(R(tol)),
                      eps23=float(R(f.eps ** (2 / 3))), eps_m=float(f.eps))


def _cx_buffers(torch, ccc, H, rnorm, dt, where, brk=-1):
    ncv = H.shape[0]
    t = dict(dtype=dt, device=where)
    rdt = torch.float32 if dt == torch.complex64 else torch.float64
    return [torch.tensor(H, **t), torch.tensor(rnorm, dtype=rdt, device=where),
            torch.tensor(brk, dtype=torch.int32, device=where),
            torch.tensor(0, dtype=torch.int32, device=where),
            torch.tensor([3, 1, 2, 0], dtype=torch.int64, device=where),
            torch.zeros(ncv, ncv, **t), torch.zeros(2, **t),
            torch.zeros(ccc.packet_size(ncv), dtype=torch.float64,
                        device=where)]


def _cx_run(torch, ccc, H, rnorm, dt, where, p, is_last=False, brk=-1,
            shifts=False):
    """One complex reduced space on ``where``: ``(H, Q, sk, packet)`` as
    it leaves them, in complex128 and float64; with ``shifts`` (a CUDA
    ``where``) the kernel's count of the shifts its chase applied (its
    stamp buffer's last word) after them."""
    bufs = _cx_buffers(torch, ccc, H, rnorm, dt, where, brk)
    clk = None
    if shifts:
        clk = torch.zeros(ccc.clock_size(H.shape[0]), dtype=torch.int64,
                          device=where)
    ccc.cplx_cycle(*bufs, p, is_last, clocks=clk)
    out = [x.to(torch.complex128).cpu().numpy() for x in
           (bufs[0], bufs[5], bufs[6])] + [bufs[7].cpu().numpy()]
    return out + [int(clk[-1])] if shifts else out


def _cx_cond(H):
    """eps times the largest eigenvalue condition number of H times
    ||H||_2 over max |lambda|: the relative error a backward-stable
    eigensolve may leave in H's values, and the scale of what two of them
    may disagree by."""
    import scipy.linalg as sla

    w, vl, vr = sla.eig(H, left=True, right=True)
    kappa = 1.0 / np.abs(np.sum(vl.conj() * vr, axis=0))
    return float(np.finfo(np.float64).eps * kappa.max()
                 * np.linalg.norm(H, 2) / np.abs(w).max())


def _near(a, b):
    """Each entry of ``a`` against ``b``'s at its place or one place
    either side (two members of a conjugate pair tie on a which-key up to
    rounding, so their sorted order follows the last bits): the largest
    such distance."""
    n = len(a)
    d = np.abs(a[:, None] - b[None, :])
    idx = np.arange(n)
    band = np.abs(idx[:, None] - idx[None, :]) <= 1
    return float(np.max(np.min(np.where(band, d, np.inf), axis=1)))


def _cx_shifts(ccc, pk, ncv, nev):
    """The shifts a packet's head gives the chase, in order."""
    P = ccc.P_HEAD
    h = ccc.Head(r_s=pk[P:P + ncv] + 1j * pk[P + ncv:P + 2 * ncv],
                 b_s=pk[P + 2 * ncv:P + 3 * ncv], nconv=0, done=False,
                 nev_eff=int(pk[ccc.P_NEV]), np_eff=int(pk[ccc.P_NP]))
    return np.array(ccc.shift_pool(h, nev))


def _cx_kept(ccc, H, pk):
    """The values of a shifted Hc's kept block ``Hc[:k, :k]`` against the
    packet's kept (unshifted) values ``r_s[np_eff:]``, as sets: the larger
    of the two one-sided distances.  Exact shifts leave the kept values as
    the block's values; a shift skipped, added or taken from the wrong
    values does not."""
    ncv, P, k = H.shape[0], ccc.P_HEAD, int(pk[ccc.P_NEV])
    kept = pk[P + ncv - k:P + ncv] + 1j * pk[P + 2 * ncv - k:P + 2 * ncv]
    e = np.linalg.eigvals(H[:k, :k])
    d = np.abs(e[:, None] - kept[None, :])
    return float(max(d.min(axis=1).max(), d.min(axis=0).max()))


def _cx_gaps(ccc, twin, other, H0, p):
    """How far one complex reduced-space result lies from the twin's, in
    the units of ``CX_LIMITS``: the sorted values (over max |lambda|) and
    bounds (over their max), each against the twin's at its place or one
    either side; how far the other's which-keys fall from ascending
    (``sorted``); whether the packet's counts (done, nconv, nev_eff,
    np_eff, info) are equal and the chase took the twin's shifts in the
    twin's order (``same_order``: a conjugate pair's members tie on the
    which-key and on their bounds up to rounding); where shifts were
    applied, the other's kept block against its packet's kept values
    (:func:`_cx_kept`) and the twin's own (``twin_kept``); the other's
    restart relation ``|H0 Q_k - Q_{k+1} Hc[:k+1, :k]|`` over max |H0| and
    the twin's (``twin_relation``); where the chase took the twin's
    shifts in any order, the kept columns' spaces, ``|Q_k Q_k^H - Q'_k
    Q'_k^H|`` (where a pair straddles the cut, either member may be the
    one shifted, and each choice keeps its own space); and, where the
    shifts and their order are the twin's, Q's kept columns, sigmak and
    Hc's kept block entry by entry (over max |H0|)."""
    (tH, tQ, tsk, tpk), (kH, kQ, ksk, kpk) = twin[:4], other[:4]
    ncv, P = H0.shape[0], ccc.P_HEAD
    tr = tpk[P:P + ncv] + 1j * tpk[P + ncv:P + 2 * ncv]
    kr = kpk[P:P + ncv] + 1j * kpk[P + ncv:P + 2 * ncv]
    tb, kb = tpk[P + 2 * ncv:P + 3 * ncv], kpk[P + 2 * ncv:P + 3 * ncv]
    lam = np.abs(tr).max()
    counts = all(kpk[i] == tpk[i] for i in (
        ccc.P_DONE, ccc.P_NCONV, ccc.P_NEV, ccc.P_NP, ccc.P_INFO))
    ts, ks = (_cx_shifts(ccc, x, ncv, p.nev) for x in (tpk, kpk))
    key = ccc.which_key(p.which, kr)
    out = {"values": _near(kr, tr) / lam,
           "bounds": _near(kb, tb) / max(tb.max(), 1e-300),
           "sorted": float(max(np.max(key[:-1] - key[1:]), 0.0)) / lam,
           "counts_equal": counts,
           "same_order": bool(counts and ts.shape == ks.shape and np.all(
               np.abs(ks - ts) <= 1e-6 * lam))}
    same_set = counts and ts.shape == ks.shape and (not len(ts) or max(
        np.abs(ks[:, None] - ts[None, :]).min(axis=1).max(),
        np.abs(ts[:, None] - ks[None, :]).min(axis=1).max()) <= 1e-6 * lam)
    if not tpk[ccc.P_DONE]:
        k = int(tpk[ccc.P_NEV])
        scale = np.abs(H0).max()

        def relation(H, Q):
            return float(np.abs(H0 @ Q[:, :k] - Q[:, :k + 1]
                                @ H[:k + 1, :k]).max() / scale)

        out["relation"] = relation(kH, kQ)
        out["twin_relation"] = relation(tH, tQ)
        if tQ.any():
            out["kept"] = _cx_kept(ccc, kH, kpk) / lam
            out["twin_kept"] = _cx_kept(ccc, tH, tpk) / lam
        if same_set:
            out["space"] = float(np.abs(kQ[:, :k] @ kQ[:, :k].conj().T
                                        - tQ[:, :k] @ tQ[:, :k].conj().T
                                        ).max())
        if out["same_order"]:
            out.update(
                Q=float(np.abs(kQ[:, :k] - tQ[:, :k]).max()),
                sigmak=float(abs(ksk[0] - tsk[0])),
                H=float(np.abs(kH[:k + 1, :k] - tH[:k + 1, :k]).max()
                        / scale))
    return out


def _cx_faults(g, lim, cond):
    """The gaps of :func:`_cx_gaps` past their limits, and the limit each
    was held to (None: exempt).  Values, bounds and the keys' order within
    ``CX_LIMITS`` or 100 times the input's eigenvalue condition
    (``_cx_cond``), whichever is larger.  Where that condition exceeds the
    value limit (``ill``), Q, its space, sigmak and Hc are exempt (their
    differences grow with it) and held by the Arnoldi relation, within its
    limit or 10 times the twin's own.  The kept block's values within their
    limit, or, where the twin's own kept block misses its limit (the
    explicit chase is forward unstable on an ill-conditioned H), within 10
    times the twin's.  Returns ``(faults, used, exempt)``, ``exempt`` the
    names of the checks an input's conditioning exempted."""
    ill = 100 * cond > lim["values"]
    used = {k: max(lim[k], 100 * cond)
            for k in ("values", "bounds", "sorted")}
    exempt = []
    if "relation" in g:
        used["relation"] = max(lim["relation"], 10 * g["twin_relation"])
    if "kept" in g:
        used["kept"] = lim["kept"]
        if g["twin_kept"] > lim["kept"]:
            used["kept"] = 10 * g["twin_kept"]
            exempt.append("kept")
    for k in ("space", "Q", "sigmak", "H"):
        if k in g:
            used[k] = None if ill else lim[k]
            if ill:
                exempt.append(k)
    bad = [(k, g[k], v) for k, v in used.items()
           if v is not None and g[k] > v]
    return bad, used, exempt


def _cx_library(torch, H, rnorm, shifts):
    """The library form of one cycle's complex reduced space on the card
    (the yardstick, used nowhere in the port): ``torch.linalg.eig``
    (values and the vectors the bounds need; it syncs), the bounds, then
    one ``torch.linalg.qr`` per shift with Q accumulated, as the host
    loop's numpy chase runs them."""
    w, X = torch.linalg.eig(H)
    bounds = rnorm * torch.abs(X[-1]) / torch.linalg.vector_norm(X, dim=0)
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    Hc, Q = H, eye
    for mu in shifts:
        q, _ = torch.linalg.qr(Hc - complex(mu) * eye)
        Hc = torch.triu(q.conj().T @ Hc @ q, -1)
        Q = Q @ q
    torch.cuda.synchronize()
    return bounds, Q


def _cx_ops(ccc, H, rnorm, p):
    """The operations this input needs: the QR sweeps of its Schur form and
    the shifts of its chase as the twin takes them (counted on its
    ``np.linalg.qr`` calls): each reflector of order 2 (one per nonzero
    subdiagonal entry of the shifted matrix, in complex arithmetic, 4 real
    operations to a complex one) applied to the Hessenberg T from both
    sides over the rows and columns it reaches, to Q's last row in the
    Schur sweeps (the bounds need no more of it) and to all of Q in the
    chase; dtrevc's back-substitution over the rows each eigenvector
    solves with its last component and norm.  Returns ``(flops, detail,
    head)``, the head the twin's."""
    from unittest import mock

    n = H.shape[0]
    real_qr = np.linalg.qr
    tally = {"schur": [0, 0], "chase": [0, 0]}
    where = ["schur"]

    def qr(M, *args, **kwargs):
        js = np.nonzero(np.diag(M, -1) != 0)[0]
        t = tally[where[0]]
        t[0] += 1
        t[1] += 4 * _reflector_flops(n, js, 2,
                                     1 if where[0] == "schur" else n)
        return real_qr(M, *args, **kwargs)

    with mock.patch.object(np.linalg, "qr", qr):
        h = ccc.head_plain(H, rnorm, p)
        where[0] = "chase"
        if not h.done:
            ccc.shifts_plain(H, h, p)
    (s, fs), (c, fc) = tally["schur"], tally["chase"]
    trevc = 4 * ((n - 1) * n * (n + 1) // 3 + 2 * n * (n + 1))
    return fs + fc + trevc, f"{s} Schur sweeps, {c} shifts", h


def _cx_case_faults(ccc, twin, kern, H, p, lim, cond, what, worst,
                    order_apart, exempt):
    """One case of row 13's check (:func:`check_cplx_cycle`, and
    tests/test_torch_gpu.py): the packet's counts equal, the chase's shift
    count (the kernel's stamp, ``kern[4]``) np_eff where the twin applied
    shifts and 0 where it did not, every gap of :func:`_cx_gaps` within
    the limit :func:`_cx_faults` holds it to.  Records each gap's largest
    share of its limit in ``worst`` (key -> (gap, limit)), the case in
    ``order_apart`` where its sorted order is not the twin's, and its
    exempt checks in ``exempt``.  Returns the faults."""
    bad = []
    g = _cx_gaps(ccc, twin, kern, H, p)
    if not g.pop("counts_equal"):
        bad.append((what, "counts", kern[3][:ccc.P_HEAD],
                    twin[3][:ccc.P_HEAD]))
    if not g.pop("same_order"):
        order_apart.append(what[11:])
    want = int(twin[3][ccc.P_NP]) if twin[1].any() else 0
    if kern[4] != want:
        bad.append((what, "shifts applied", kern[4], "want", want))
    faults, used, ex = _cx_faults(g, lim, cond)
    bad += [(what,) + f for f in faults]
    if ex:
        exempt[what[11:]] = ex
    for k, u in used.items():
        share = g[k] / u if u else -1.0
        if k not in worst or share > worst[k][2]:
            worst[k] = (g[k], u, share)
    return bad


def check_cplx_cycle(torch, dev, gpu):
    """Row 13, the complex reduced-space kernel (``csrc/cplx_cycle.cu``)
    against its numpy twin on complex Arnoldi Hessenbergs
    (``_cx_hessenberg``: a complex matrix, the convection-diffusion matrix
    from a complex start and from a real one, a normal matrix), complex64
    (phase 11's) and complex128, ncv in ``CX_NCVS`` (3 to 100, past
    ``max_shared_ncv``; every which at ncv = 32, LM and LI at the others)
    under :func:`_cx_case_faults`: the packet's counts equal, np_eff
    shifts applied, every gap within the limit :func:`_cx_faults` holds it
    to (the limits used and the exempt cases printed; the normal source
    may take no exemption), two launches equal bit for bit; a done cycle, a last cycle and a breakdown
    leave H, Q and sk as they were; then timed at ncv = 32, 'LM',
    complex64 on the convection-diffusion source: the kernel device-only
    (each call after a copy restoring H, in alternation with an empty
    call), the twin's host wall per call and the library form's wall per
    call (``torch.linalg.eig`` + the shifts' QR loop on the card,
    synced).  Returns ``(err, row)``: the complex64 largest value gap at
    ncv = 32, the timed row of the kernels line."""
    from arpack_ng_tpu_torch.ops import cuda_cplx_cycle as ccc

    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    err = {}
    bad = []
    order_apart = []
    exempt = {}
    for dt in (torch.complex64, torch.complex128):
        lim = CX_LIMITS[str(dt)]
        cdt = np.complex64 if dt == torch.complex64 else np.complex128
        for m in CX_NCVS:
            worst = {}
            for source in CX_SOURCES:
                H, rn = _cx_hessenberg(m, m, source)
                H = H.astype(cdt).astype(np.complex128)
                cond = _cx_cond(H)
                for which in (ccc.WHICH if m == NCV else ("LM", "LI")):
                    p = _cx_params(ccc, str(dt), which, max(1, m // 4))
                    kern = _cx_run(torch, ccc, H, rn, dt, dev, p, shifts=True)
                    twin = _cx_run(torch, ccc, H, rn, dt, cpu, p)
                    what = f"cplx_cycle {str(dt)[6:]} ncv {m} {source} {which}"
                    bad += _cx_case_faults(ccc, twin, kern, H, p, lim, cond,
                                           what, worst, order_apart, exempt)
                    if m == NCV and which == "LM" and source == "convdiff":
                        again = _cx_run(torch, ccc, H, rn, dt, dev, p,
                                        shifts=True)
                        if not all(np.array_equal(a, b)
                                   for a, b in zip(kern, again)):
                            bad.append((what, "two launches differ"))
                        err[str(dt)] = _cx_gaps(ccc, twin, kern, H,
                                                p)["values"]
            print(f"  cplx_cycle vs twin {dt} ncv={m} "
                  f"({'shared' if ccc.fits_shared(m) else 'global'} "
                  f"workspace), each gap at its largest share of the limit "
                  f"it was held to: " + ", ".join(
                      f"{k} {v:.3e}" + (" (exempt)" if u is None
                                        else f" of {u:.1e}")
                      for k, (v, u, _) in worst.items()), flush=True)
        # the exits: done (a tolerance every value meets), last, breakdown
        H, rn = _cx_hessenberg(20, 1, "convdiff")
        H = H.astype(cdt).astype(np.complex128)
        for case, p, is_last, brk in (
                ("done", _cx_params(ccc, str(dt), "LM", 4, tol=0.5), False,
                 -1),
                ("last", _cx_params(ccc, str(dt), "SR", 4), True, -1),
                ("breakdown", _cx_params(ccc, str(dt), "LM", 4), False, 7)):
            kern = _cx_run(torch, ccc, H, rn, dt, dev, p, is_last, brk,
                           shifts=True)
            twin = _cx_run(torch, ccc, H, rn, dt, cpu, p, is_last, brk)
            what = f"cplx_cycle {str(dt)[6:]} {case}"
            if not (np.array_equal(kern[0], H) and not kern[1].any()
                    and not kern[2].any()):
                bad.append((what, "H, Q or sk changed"))
            if case == "breakdown":
                if not np.array_equal(kern[3], twin[3]):
                    bad.append((what, "packet differs from the twin's"))
                continue
            if case == "done" and not kern[3][ccc.P_DONE]:
                bad.append((what, "not done"))
            bad += _cx_case_faults(ccc, twin, kern, H, p, lim, _cx_cond(H),
                                   what, {}, [], exempt)
            if not np.array_equal(kern[3][ccc.P_HEAD + 3 * 20:],
                                  twin[3][ccc.P_HEAD + 3 * 20:]):
                bad.append((what, "packet H is not the input's"))
    print(f"  cplx_cycle: sorted orders apart from the twin's (conjugate "
          f"pairs tied up to rounding; held by the invariant gaps): "
          f"{order_apart}", flush=True)
    print(f"  cplx_cycle: checks the input's conditioning exempted, by case "
          f"(Q, space, sigmak, H: eigenvalue condition past the value "
          f"limit; kept: the twin's own kept block past its limit): "
          f"{exempt}", flush=True)
    loose = sorted(w for w in exempt if " normal " in w)
    if loose:
        bad.append(("the normal source took exemptions", loose))
    if bad:
        raise AssertionError(f"cplx_cycle: kernel and twin differ: {bad}")
    # the timed row: ncv = 32, 'LM', complex64, the conv-diff source
    dt = torch.complex64
    p = _cx_params(ccc, str(dt), "LM", 8)
    H, rn = _cx_hessenberg(NCV, 0, "convdiff")
    H = H.astype(np.complex64).astype(np.complex128)
    bufs = _cx_buffers(torch, ccc, H, rn, dt, dev)
    H0 = bufs[0].clone()

    def kernel():
        bufs[0].copy_(H0)
        ccc.cplx_cycle(*bufs, p, False)

    cbufs = _cx_buffers(torch, ccc, H, rn, dt, cpu)
    H0c = cbufs[0].clone()

    def twin():
        cbufs[0].copy_(H0c)
        ccc.cplx_cycle_plain(*cbufs, p, False)

    flops, detail, h = _cx_ops(ccc, H, np.float64(np.float32(rn)), p)
    shifts = ccc.shift_pool(h, p.nev)
    Hd = torch.tensor(H, dtype=torch.complex128, device=dev)
    walls = {}
    for name, fn in (("plain_ms", twin), ("library_ms", lambda: _cx_library(
            torch, Hd, float(np.float32(rn)), shifts))):
        fn()
        ts = []
        for _ in range(timing.REPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t1) * 1e3)
        walls[name] = float(np.median(ts))
    ms = timing.alternating_ms([kernel], timing.flush_buffer(dev))[0]
    clk = torch.zeros(ccc.clock_size(NCV), dtype=torch.int64, device=dev)
    bufs[0].copy_(H0)
    ccc.cplx_cycle(*bufs, p, False, clocks=clk)
    clocks = _rn_clocks(ccc, clk.cpu().numpy())
    bound = flops / (PEAK_FLOPS["torch.float64"] / SMS) * 1e3
    row = {"name": "cplx_cycle", "dtype": "torch.complex64",
           "shape": NCV, "ms": ms, "plain_ms": walls["plain_ms"],
           "library_ms": walls["library_ms"], "bound_ms": bound,
           "bound_by": "operations", "bytes": 0, "flops": flops,
           "bound_note": "operations this input needs (the complex "
                         "Householder reflectors of its Schur sweeps and "
                         "shifts over the Hessenberg rows and columns they "
                         "reach, dtrevc's rows) over one SM's float64 rate "
                         "(the kernel is one block and computes in "
                         "complex128), not the card's roofline",
           "np_eff": h.np_eff, "clocks": clocks}
    print(f"  cplx_cycle ncv={NCV} complex64 ({detail}): kernel {ms:.4f} ms "
          f"device-only (the first design {CX_FIRST_MS:.4f} ms, "
          f"{CX_FIRST_MS / ms:.2f}x), twin {walls['plain_ms']:.4f} ms host, "
          f"library "
          f"(eig + {len(shifts)} QR on the card, with syncs) "
          f"{walls['library_ms']:.4f} ms; bound {bound:.6f} ms ({flops} "
          f"flops over one SM's float64 rate, {100 * bound / ms:.2f}% of "
          f"it); check and timing {time.perf_counter() - t0:.1f} s; card "
          f"{gpu}", flush=True)
    steps = max(clocks["sweeps"] + clocks["shifts"], 1)
    print("  cplx_cycle phase clocks (SM cycles, one launch; the QR steps' "
          "shift choice, reflector chain and the tail behind it summed over "
          "its sweeps and shifts): " + ", ".join(
              f"{k} {v}" for k, v in clocks.items())
          + f"; a QR step: chain {clocks['chain'] / steps:.0f} "
          f"({clocks['chain'] / steps / NCV:.0f} a reflector), tail "
          f"{clocks['tail'] / steps:.0f}, shift {clocks['shift'] / steps:.0f}",
          flush=True)
    return err, row


def _host_cplx_cycle(*args):
    """The complex reduced space on the host (:func:`_on_host`)."""
    from arpack_ng_tpu_torch.ops import cuda_cplx_cycle as ccc

    _on_host(ccc.cplx_cycle_plain, args, (0, 5, 6, 7))  # H, Q, sk, pk


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


def _in_band(st, what, band=SELECTIVE_BAND):
    lo, hi = band
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


def _loop_gate(st, what):
    """The device loop's dispatch: graphs captured on the card, every cycle
    after the first replayed, one packet per cycle and one more for each
    extension the host finished (``RERUNS[what]``)."""
    rr = sum(RERUNS.get(what, {}).values())
    if st.packets != st.n_iter + rr or st.graph_replays != st.n_iter - 1 \
            or not st.graphs_captured:
        raise AssertionError(f"{what}: {st.packets} packets, "
                             f"{st.graphs_captured} graphs, "
                             f"{st.graph_replays} replays for {st.n_iter} "
                             f"cycles and {rr} host reruns (want a packet per "
                             "cycle and rerun, every cycle after the first "
                             "replayed)")


def flagship(torch, dev, gpu, nx=NX):
    """Phase 4: the selective flagship through ``eigsh`` (the main path:
    the device restart loop, extensions replayed as CUDA graphs, the
    reduced space as one kernel, one packet per cycle), its two witnesses,
    then ``reorth='dgks'`` on the same device loop and its host-reduced
    witness."""
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
    WALLS["4"] = wall
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

    def check(v, x, what):
        return check_values(v, x, a_sp, spectrum, what)

    # the gates of both loops are held after every run has printed
    gates = [lambda: _in_band(st, "flagship selective"),
             lambda: _kernel_counters(st, "flagship selective"),
             _reduced_witness(torch, dev, gpu, "flagship selective",
                              HOST_LOOP_COUNTERS, lambda: pt.eigsh(op, **kw),
                              check)]
    _sel_witness(torch, dev, gpu, op, a_sp, spectrum)

    (vals, vecs, out), wall, counts = _counted(
        torch, dev, DGKS_PATH, lambda: pt.eigsh(op, reorth="dgks", **kw),
        tag="flagship dgks")
    dmax, rmax = check_values(vals, vecs, a_sp, spectrum, "flagship dgks")
    sd = out.stats
    steps = sd.nopx - 1
    print(f"flagship reorth=dgks (device loop): wall {wall:.4f} s "
          f"({wall * 1e3 / steps:.4f} ms per step), {_stats_line(sd)}, "
          f"{5 * nx * nx * sd.nopx / wall / 1e9:.4f} Gnnz/s; host reruns "
          f"{RERUNS['flagship dgks']}; max value dist {dmax:.2e}, max "
          f"residual {rmax:.2e}; launches {counts}; card {gpu}", flush=True)
    print(f"  device loop: {_loop_line(sd)}", flush=True)
    print(f"  recorded (host loop): {RECORDED_COUNTERS['flagship dgks']}, "
          f"nrorth {DGKS_HOST_COUNTERS['flagship dgks'][2]}, wall "
          f"{RECORDED_WALLS['flagship dgks']}; the gate's band (the seed "
          f"sweep's span) {DGKS_BAND[0]}-{DGKS_BAND[1]} cycles; the kernel's: "
          f"{KERNEL_COUNTERS['flagship dgks']}", flush=True)
    print(f"  values {np.array2string(vals, precision=7)}", flush=True)
    gates += [lambda: _loop_gate(sd, "flagship dgks"),
              lambda: _in_band(sd, "flagship dgks", DGKS_BAND),
              lambda: _kernel_counters(sd, "flagship dgks"),
              _reduced_witness(torch, dev, gpu, "flagship dgks",
                               DGKS_HOST_COUNTERS["flagship dgks"],
                               lambda: pt.eigsh(op, reorth="dgks", **kw),
                               check)]
    for gate in gates:
        gate()
    return launches


def _on_host(plain, args, outs):
    """A reduced space as the host loop computes it: the kernel's buffers
    (all of ``args`` but the last two, ``p`` and ``is_last``) copied to
    the host, its numpy twin ``plain``, the buffers ``outs`` copied
    back."""
    bufs = args[:-2]
    cpu = [t.cpu() for t in bufs]
    plain(*cpu, *args[-2:])
    for i in outs:
        bufs[i].copy_(cpu[i])


def _host_sym_cycle(*args):
    """The symmetric reduced space on the host (:func:`_on_host`)."""
    from arpack_ng_tpu_torch.ops import cuda_sym_cycle as csc

    _on_host(csc.sym_cycle_plain, args, (0, 1, 6, 7, 8))  # a, b, Q, sk, pk


def _host_realnonsym_cycle(*args):
    """The real reduced space on the host (:func:`_on_host`)."""
    from arpack_ng_tpu_torch.ops import cuda_realnonsym_cycle as crc

    _on_host(crc.realnonsym_cycle_plain, args, (0, 5, 6, 7))  # H, Q, sk, pk


def _reduced_witness(torch, dev, gpu, what, want, solve, check):
    """A device-loop solve (``solve()``) again with the reduced space on
    the host as before (the loop's reduced-space call patched to the numpy
    twin on host copies): every other piece of the loop is the main
    path's, so it must repeat the host loop's counters ``want`` (cycles,
    nopx and nrorth, or the first two) exactly; ``check(vals, vecs,
    what)`` is the solve's value gate.  Its launches are not the main
    path's.  Returns its gate."""
    from unittest import mock

    from arpack_ng_tpu_torch.core import device_sym

    tag = f"{what} witness, host reduced"
    with mock.patch.object(device_sym, "sym_cycle", _host_sym_cycle):
        (vals, vecs, out), wall, counts = _counted(torch, dev, (), solve,
                                                   tag=tag)
    dmax, rmax = check(vals, vecs, tag)
    st = out.stats
    got = (st.n_iter, st.nopx, st.nrorth)[:len(want)]
    print(f"  {what} witness, reduced space on the host: wall {wall:.4f} s, "
          f"{_stats_line(st)}; host reruns {RERUNS[tag]}; {_loop_line(st)}; "
          f"max value dist {dmax:.2e}, max residual {rmax:.2e}; sym_cycle "
          f"launches {counts['sym_cycle']}; card {gpu}", flush=True)

    def gate():
        if got != want:
            raise AssertionError(f"{what} host-reduced witness: counters "
                                 f"{got}, want the host loop's {want}")

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


def _counted(torch, dev, need, fn, tag=None):
    """Run ``fn`` with every kernel's launch count set to 0 just before and
    read just after; fail if a kernel of ``need`` was never launched.
    With ``tag``, the host's reruns of read-free extensions in ``fn`` go
    into ``RERUNS[tag]``.  Returns ``(fn(), wall seconds, counts)``."""
    from arpack_ng_tpu_torch.core import arnoldi
    from arpack_ng_tpu_torch.ops import (cuda_cgs, cuda_cplx_cycle, cuda_dia,
                                         cuda_gather, cuda_krylov_loop,
                                         cuda_psell, cuda_realnonsym_cycle,
                                         cuda_rot, cuda_sel, cuda_sym_cycle)

    every = (cuda_sel.sel_proj, cuda_sel.sel_update, cuda_rot.rotate_rows,
             cuda_cgs.cgs_proj, cuda_cgs.cgs_update, cuda_dia.dia_matvec,
             cuda_dia.dia_matvec_sub, cuda_dia.dia_block_matvec,
             cuda_psell.psell_matvec, cuda_gather.take_flat,
             cuda_gather.take_lanes, cuda_sym_cycle.sym_cycle,
             cuda_realnonsym_cycle.realnonsym_cycle,
             cuda_cplx_cycle.cplx_cycle, cuda_krylov_loop.krylov_test,
             *cuda_krylov_loop.UPDATES)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for k in every:
        k.launches = 0
    for k in arnoldi.reruns:
        arnoldi.reruns[k] = 0
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    wall = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in every}
    if tag is not None:
        RERUNS[tag] = dict(arnoldi.reruns)
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
             ("cgs_proj", "cgs_update", "dia_matvec", "rotate_rows",
              "sym_cycle"),
             lambda: pt.eigsh(op, reorth="dgks", cgs_kernel="pallas",
                              **kw))):
        path = f"7{tag[:3]}"
        (vals, vecs, out), wall, counts = _counted(torch, dev, need, fn,
                                                   tag=path)
        dmax, rmax = check_values(vals, vecs, a_sp, spectrum, tag)
        st = out.stats
        print(f"sparse {tag}: format dia, wall {wall:.4f} s "
              f"({wall * 1e3 / (st.nopx - 1):.4f} ms per step), "
              f"{_stats_line(st)}; host reruns {RERUNS[path]}; max value "
              f"dist {dmax:.2e}, max residual {rmax:.2e}; launches {counts}; "
              f"card {gpu}", flush=True)
        print(f"  device loop: {_loop_line(st)}", flush=True)
        print(f"  recorded: {RECORDED_COUNTERS[tag[:3]]}", flush=True)
        if tag[:3] in KERNEL_COUNTERS:
            print(f"  the kernel's: {KERNEL_COUNTERS[tag[:3]]}", flush=True)
            _kernel_counters(st, tag[:3])
        if dev.type == "cuda":
            _loop_gate(st, path)
        for k in need:
            launches.setdefault(k, counts[k])
    _reduced_witness(
        torch, dev, gpu, "7(b)", DGKS_HOST_COUNTERS["(b)"],
        lambda: pt.eigsh(op, reorth="dgks", cgs_kernel="pallas", **kw),
        lambda v, x, what: check_values(v, x, a_sp, spectrum, what))()
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
    at tol = 1e-30, through ``FusedRealNonsymSolver.multi`` on the device
    loop (the main path: its extensions replayed as CUDA graphs, the
    reduced space one kernel launch, one packet per cycle; each ``multi``
    run starts a loop, whose first cycle runs eagerly and whose graphs are
    captured in it), then the same protocol on the host loop (the numpy
    head and tail: the reduced space on the host, one read per
    extension) in the same run; then one more extension and the basis
    defect.  Returns the device loop's ms per cycle."""
    from arpack_ng_tpu_torch.config import IRAMConfig
    from arpack_ng_tpu_torch.core.arnoldi import make_init
    from arpack_ng_tpu_torch.core.device_realnonsym import (
        FusedRealNonsymSolver, make_realnonsym_head, make_realnonsym_tail)
    from arpack_ng_tpu_torch.models import convection_diffusion_2d
    from arpack_ng_tpu_torch.ops import cuda_realnonsym_cycle as crc

    op, _ = convection_diffusion_2d(nx, dtype=np.float32, device=dev)
    cfg = IRAMConfig(n=op.n, nev=8, ncv=NCV, which="LM", symmetric=False,
                     dtype=np.dtype(np.float32), n_pad=op.n_pad, tol=1e-30,
                     max_iter=10_000)
    solver = FusedRealNonsymSolver(op, cfg)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def run_device():
        out = solver.multi(solver.init_state(), 2)
        sync()
        l0 = crc.realnonsym_cycle.launches
        c0, t0 = out.state.counts, time.perf_counter()
        out = solver.multi(out.state, 20)
        sync()
        wall = time.perf_counter() - t0
        return out.state, c0, wall, crc.realnonsym_cycle.launches - l0

    (state, c0, wall, timed), _, counts = _counted(
        torch, dev, EIGS_PATH, run_device, tag="9a")
    reruns = dict(RERUNS["9a"])
    c = state.counts
    print(f"eigs (a) conv-diff nx={nx} float32, device loop "
          f"(FusedRealNonsymSolver.multi), 20 cycles after 2: "
          f"{wall * 1e3 / 20:.4f} ms/cycle (wall {wall:.4f} s; nopx "
          f"{c.nopx - c0.nopx}, nrorth {c.nrorth - c0.nrorth}, nitref "
          f"{c.nitref - c0.nitref}, nrotr {c.nrotr - c0.nrotr}; "
          f"realnonsym_cycle launches in the 20: {timed}); host reruns "
          f"{reruns}; launches {counts}; card {gpu}", flush=True)
    if dev.type == "cuda" and timed != 20 + sum(reruns.values()):
        raise AssertionError(f"9a: {timed} reduced-space launches for 20 "
                             f"cycles and {reruns} host reruns")
    head, tail = make_realnonsym_head(op, cfg), make_realnonsym_tail(op, cfg)

    def cycles(st, m, last=False):
        for i in range(m):
            st = tail(head(st), last and i == m - 1).state
        return st

    def run_host():
        st = cycles(make_init(op, cfg)(), 2)
        sync()
        h0, t0 = st.counts, time.perf_counter()
        st = cycles(st, 20)
        sync()
        return st, h0, time.perf_counter() - t0

    (hst, h0, hwall), _, _ = _counted(torch, dev, ("rotate_rows",), run_host,
                                      tag="9a host loop")
    hc = hst.counts
    print(f"  host loop (the reduced space in numpy on the host), 20 cycles "
          f"after 2: {hwall * 1e3 / 20:.4f} ms/cycle (wall {hwall:.4f} s; "
          f"nopx {hc.nopx - h0.nopx}); device loop / host loop "
          f"{wall / hwall:.4f}; host reruns {RERUNS['9a host loop']}; card "
          f"{gpu}", flush=True)
    state = cycles(state, 1, last=True)  # a full factorization
    V = state.V.double()
    eye = torch.eye(NCV, dtype=torch.float64, device=dev)
    defect = float((V @ V.T - eye).abs().max())
    bound = 64 * float(np.sqrt(np.finfo(np.float32).eps))
    print(f"  basis defect after the 22 cycles and one extension "
          f"{defect:.4e} (bound {bound:.4e}); card {gpu}", flush=True)
    if not defect <= bound:
        raise AssertionError(f"eigs basis defect {defect:.3e} > {bound:.3e}")
    return wall * 1e3 / 20


def _eigs_loop_gates(st, counts, tag, cuda=True):
    """The real loop's dispatch: graphs captured, every cycle after the
    first replayed, one packet per cycle and host rerun, and one
    reduced-space launch per packet (off the card: the packets alone); the
    cycles in ``EIGS_BAND``."""
    if not cuda:
        if st.packets != st.n_iter + sum(RERUNS[tag].values()):
            raise AssertionError(f"{tag}: {st.packets} packets for "
                                 f"{st.n_iter} cycles")
    else:
        _loop_gate(st, tag)
    if cuda and counts["realnonsym_cycle"] != st.packets:
        raise AssertionError(f"{tag}: {counts['realnonsym_cycle']} "
                             f"reduced-space launches for {st.packets} "
                             "packets")
    _in_band(st, tag, EIGS_BAND)


def eigs_solves(torch, dev, gpu, nx=EIGS_SOLVE_NX, device=None):
    """Phase 9b-c: solves to tol = 1e-5 through ``eigs``, on the stencil
    operator and on its scipy CSR matrix (DIA, CGS kernels; imported on the
    default device, ``device=None``), on the device loop, under the gates
    of :func:`check_nonsym` and :func:`_eigs_loop_gates`; then (b) again
    with the reduced space on the host (the witness: the loop's
    reduced-space call patched to the numpy twin on host copies) and on
    the host loop (``HostLoopSolver.solve``), which must agree in cycles,
    nopx and nrorth.  Returns the launches of (b) and the values of (b)
    and (c) by tag."""
    from unittest import mock

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core import device_realnonsym as drn
    from arpack_ng_tpu_torch.core.iram import HostLoopSolver
    from arpack_ng_tpu_torch.models import convection_diffusion_2d

    op, a_sp = convection_diffusion_2d(nx, dtype=np.float32, device=dev)
    kw = dict(k=8, ncv=NCV, which="LM", tol=1e-5,
              maxiter=EIGS_MAX_RESTARTS, return_stats=True)
    launches, found, gates = {}, {}, []
    for tag, need, fn in (
            ("(b) eigs(op)", EIGS_PATH, lambda: pt.eigs(op, **kw)),
            ("(c) eigs(A_csr), cgs_kernel='pallas'",
             EIGS_PATH + ("cgs_proj", "cgs_update", "dia_matvec"),
             lambda: pt.eigs(a_sp, dtype=np.float32, cgs_kernel="pallas",
                             device=device, **kw))):
        t9 = f"9{tag[1]}"
        (vals, vecs, out), wall, counts = _counted(torch, dev, need, fn,
                                                   tag=t9)
        st = out.stats
        print(f"eigs {tag} conv-diff nx={nx}: wall {wall:.4f} s, "
              f"{_stats_line(st)}; {len(vals)} values, extraction "
              f"info {out.info}; host reruns {RERUNS[t9]}; launches "
              f"{counts}; card {gpu}", flush=True)
        print(f"  device loop: {_loop_line(st)}", flush=True)
        print(f"  values {np.array2string(vals, precision=8)}", flush=True)
        rmax = check_nonsym(vals, vecs, a_sp, f"eigs {tag}")
        print(f"  max residual {rmax:.2e}", flush=True)
        gates.append(lambda st=st, counts=counts, t9=t9:
                     _eigs_loop_gates(st, counts, t9, dev.type == "cuda"))
        if not launches:
            launches = {k: counts[k] for k in need}
        found[tag[:3]] = vals
    wit = {}
    for name, patch in (
            ("witness, reduced space on the host", mock.patch.object(
                drn, "realnonsym_cycle", _host_realnonsym_cycle)),
            ("host loop", mock.patch.object(drn.FusedRealNonsymSolver,
                                            "solve", HostLoopSolver.solve))):
        tag = f"9b {name}"
        with patch:
            (vals, vecs, out), wall, counts = _counted(
                torch, dev, (), lambda: pt.eigs(op, **kw), tag=tag)
        rmax = check_nonsym(vals, vecs, a_sp, f"eigs (b) {name}")
        st = out.stats
        wit[name] = (st.n_iter, st.nopx, st.nrorth)
        print(f"  (b) {name}: wall {wall:.4f} s, {_stats_line(st)}; "
              f"{len(vals)} values; host reruns {RERUNS[tag]}; packets "
              f"{st.packets}; max residual {rmax:.2e}; realnonsym_cycle "
              f"launches {counts['realnonsym_cycle']}; card {gpu}",
              flush=True)
    print(f"  9b-c cycles gate (EIGS_BAND, the seed sweep's span): "
          f"{EIGS_BAND[0]}-{EIGS_BAND[1]}", flush=True)
    for gate in gates:
        gate()
    if len(set(wit.values())) != 1:
        raise AssertionError(f"9b: the host-reduced witness and the host "
                             f"loop disagree: {wit}")
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


def _hybrid_host_loop():
    """A context in which every ``IRAMSolver`` runs its host loop
    (``_host_loop``: ``make_iram_head`` / ``make_iram_tail``, the eager
    extension and ``restart_tail`` every cycle), the twin of its device
    loop."""
    from unittest import mock

    from arpack_ng_tpu_torch.core import iram

    real = iram.IRAMSolver.__init__

    def init(self, *args, **kwargs):
        real(self, *args, **kwargs)
        self._host_loop = True

    return mock.patch.object(iram.IRAMSolver, "__init__", init)


def _step_ms(wall, st) -> float:
    """Wall ms per Lanczos step (per OP*x)."""
    return wall * 1e3 / st.nopx


def _hybrid_line(wall, st) -> str:
    """A hybrid solve's wall, ms per step and dispatch counters."""
    return (f"wall {wall:.4f} s ({_step_ms(wall, st):.4f} ms per step, "
            f"{wall * 1e3 / st.n_iter:.4f} ms per cycle); graphs captured "
            f"{st.graphs_captured}, replays {st.graph_replays}, packets "
            f"{st.packets} ({st.packets / st.n_iter:.3f} per cycle)")


def _hybrid_twin(torch, dev, gpu, tag, fn, need, graph):
    """The hybrid solve ``fn`` (``-> (vals, vecs, out)``) again on the
    host loop (:func:`_hybrid_host_loop`), against ``graph = ((vals, vecs,
    out), wall, launches)`` from the device loop: values and vectors bit
    for bit, equal cycles, nopx, nrorth, nrorthr and kernel launches.  On a
    card the graph run must have replayed a graph every cycle after the
    first and read one packet a cycle and rerun.  Prints both walls."""
    (vals, vecs, out), wall, counts = graph
    st = out.stats
    if dev.type == "cuda":
        _loop_gate(st, tag)
    with _hybrid_host_loop():
        (v2, x2, o2), w2, c2 = _counted(torch, dev, need, fn)
    s2 = o2.stats
    keys = ("n_iter", "nopx", "nrorth", "nrorthr")
    got = tuple(getattr(st, k) for k in keys)
    want = tuple(getattr(s2, k) for k in keys)
    same = np.array_equal(vals, v2) and np.array_equal(vecs, x2)
    if got != want or not same or counts != c2 or s2.packets:
        raise AssertionError(
            f"{tag}: graphs {got}, launches {counts}; host loop {want}, "
            f"launches {c2} (packets {s2.packets}); values and vectors "
            f"bit-equal {same}")
    print(f"  {tag} on graphs: {_hybrid_line(wall, st)}; on the eager host "
          f"loop: wall {w2:.4f} s ({_step_ms(w2, s2):.4f} ms per step); "
          f"{w2 / wall:.2f}x; values, vectors, cycles / nopx / nrorth / "
          f"nrorthr {got} and launches equal; card {gpu}", flush=True)
    return w2


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

    # (a) the flagship through the hybrid driver (on graphs), then its
    # host-loop twin
    op, a_sp = laplacian_2d(nx, np.float32, device=dev)
    tag = "10a eigsh(flagship, strategy='hybrid')"
    need = ("sel_proj", "sel_update", "rotate_rows")
    run = _counted(
        torch, dev, need,
        lambda: pt.eigsh(op, which="LA", strategy="hybrid", **kw), tag="10a")
    (vals, vecs, out), wall, counts = run
    dmax, rmax = check_values(vals, vecs, a_sp, _analytic_spectrum(nx), tag)
    st = out.stats
    print(f"{tag}: {_hybrid_line(wall, st)}, {_stats_line(st)}; host reruns "
          f"{RERUNS['10a']}; max value dist {dmax:.2e}, max residual "
          f"{rmax:.2e}; launches {counts}; card {gpu}", flush=True)
    print(f"  values {np.array2string(vals, precision=7)}", flush=True)
    WALLS["10a host loop"] = _hybrid_twin(
        torch, dev, gpu, "10a", lambda: pt.eigsh(
            op, which="LA", strategy="hybrid", **kw), need, run)
    paths["10a"] = counts
    WALLS["10a"], STATS["10a"] = wall, st
    del op, vecs, run

    # (b) eigs on the conv-diff cell at nx = 1024, the hybrid driver
    op, a_sp = convection_diffusion_2d(eigs_nx, dtype=np.float32, device=dev)
    tag = (f"10b eigs(conv-diff nx={eigs_nx}, strategy='hybrid', "
           "cgs_kernel='pallas')")
    need = ("rotate_rows", "cgs_proj", "cgs_update")

    def solve_b():
        return pt.eigs(op, which="LM", strategy="hybrid", cgs_kernel="pallas",
                       maxiter=P10_MAX_RESTARTS, **kw)

    run = _counted(torch, dev, need, solve_b, tag="10b")
    (vals, vecs, out), wall, counts = run
    st = out.stats
    print(f"{tag}: {_hybrid_line(wall, st)}, {_stats_line(st)}; "
          f"{len(vals)} values, extraction info {out.info}; host reruns "
          f"{RERUNS['10b']}; launches {counts}; card {gpu}", flush=True)
    print(f"  values {np.array2string(vals, precision=8)}", flush=True)
    rmax = check_nonsym(vals, vecs, a_sp, tag, counted=False)
    print(f"  max residual {rmax:.2e}; the fused real driver's float32 "
          f"reduced space returned 6 here (info -14); the hybrid's float64 "
          f"one returns {len(vals)} (info {out.info})", flush=True)
    WALLS["10b host loop"] = _hybrid_twin(torch, dev, gpu, "10b", solve_b,
                                          need, run)
    paths["10b"] = counts
    WALLS["10b"], STATS["10b"] = wall, st
    del op, vecs, run

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

        def solve_c():
            return pt.eigsh(op, which="LA", strategy=strategy, **kw)

        run = _counted(torch, dev, need, solve_c, tag=f"10c {strategy}")
        (vals, vecs, out), wall, counts = run
        dmax, rmax = check_values(vals, vecs, a_h, spectrum, tag)
        st = out.stats
        print(f"{tag}: wall {wall:.4f} s ({_step_ms(wall, st):.4f} ms per "
              f"step), {_stats_line(st)}; max value dist {dmax:.2e}, max "
              f"residual {rmax:.2e}; launches {counts}; card {gpu}",
              flush=True)
        if st.packets:
            print(f"  device loop: {_loop_line(st)}", flush=True)
        print(f"  values {np.array2string(vals, precision=7)}", flush=True)
        if strategy == "hybrid":
            WALLS["10c host loop"] = _hybrid_twin(
                torch, dev, gpu, "10c hybrid", solve_c, need, run)
            WALLS["10c"], STATS["10c"] = wall, st
        paths[f"10c {strategy}"] = counts
        found[strategy] = vals
        del vecs, run
    _hermitian_witness(torch, dev, gpu, op, a_h, spectrum, kw)
    del op, a_h

    # (d) complex eigs by default (the hybrid driver), cut to nx = 512
    op, a_sp = convection_diffusion_2d(cd_nx, dtype=np.complex64,
                                       device=dev)
    tag = f"10d eigs(conv-diff nx={cd_nx} complex64, strategy='auto')"
    (vals, vecs, out), wall, counts = _counted(
        torch, dev, (), lambda: pt.eigs(op, which="LM",
                                        maxiter=P10_MAX_RESTARTS, **kw),
        tag="10d")
    st = out.stats
    if dev.type == "cuda":
        _loop_gate(st, "10d")
    print(f"{tag}: {_hybrid_line(wall, st)}, {_stats_line(st)}; "
          f"{len(vals)} values, extraction info {out.info}; launches "
          f"{counts}; card {gpu}", flush=True)
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


def _cx_loop_gates(st, counts, what, cuda=True):
    """The complex loop's dispatch: on a card graphs captured, every cycle
    after the first replayed (:func:`_loop_gate`), one packet per cycle
    and host rerun, and one reduced-space launch per packet."""
    if cuda:
        _loop_gate(st, what)
        if counts["cplx_cycle"] != st.packets:
            raise AssertionError(f"{what}: {counts['cplx_cycle']} "
                                 f"reduced-space launches for {st.packets} "
                                 "packets")
    elif st.packets != st.n_iter + sum(RERUNS[what].values()):
        raise AssertionError(f"{what}: {st.packets} packets for "
                             f"{st.n_iter} cycles")


def _fused_eigs(torch, dev, gpu, tag, make, need, closed, nx):
    """11a-b: one ``eigs(strategy='fused')`` solve at ``nx`` on the device
    loop (``cplx_cycle`` the kernel on the card) under
    :func:`_complex_residuals` and :func:`_cx_loop_gates`, gated on 8
    values and info 0; the same solve again as two witnesses: the device
    loop with the reduced space on the host (``cplx_cycle`` patched to its
    twin on host copies) and the host loop (``HostLoopSolver.solve``),
    which must agree in cycles, nopx and nrorth.  ``make(nx) -> (A,
    a_sp)``.  Returns the kernel solve's launches."""
    from unittest import mock

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.core import device_nonsym as dn
    from arpack_ng_tpu_torch.core.iram import HostLoopSolver

    kw = dict(k=8, ncv=NCV, tol=1e-5, which="LM", strategy="fused",
              maxiter=P11_MAX_RESTARTS, return_stats=True, device=dev)
    A, a_sp = make(nx)
    what = f"{tag} nx={nx}"
    (vals, vecs, out), wall, counts = _counted(
        torch, dev, need + P11_PATH, lambda: pt.eigs(A, **kw), tag=what)
    st = out.stats
    print(f"{what}: wall {wall:.4f} s ({wall * 1e3 / st.n_iter:.4f} ms "
          f"per cycle), {_stats_line(st)}; {len(vals)} values, "
          f"extraction info {out.info}; host reruns {RERUNS[what]}; "
          f"{_loop_line(st)}; launches {counts}; card {gpu}", flush=True)
    print(f"  values {np.array2string(vals, precision=8)}", flush=True)
    rmax = _complex_residuals(vals, vecs, a_sp, what, closed)
    print(f"  max residual {rmax:.2e}", flush=True)
    _cx_loop_gates(st, counts, what, dev.type == "cuda")
    if len(vals) != 8 or out.info != 0:
        raise AssertionError(f"{what}: {len(vals)} values, info "
                             f"{out.info}, want 8 and 0")
    del vecs
    walls = {"device loop, row 13": wall / st.n_iter}
    wit = {}
    for name, patch in (
            ("witness, reduced space on the host", mock.patch.object(
                dn, "cplx_cycle", _host_cplx_cycle)),
            ("host loop", mock.patch.object(
                dn.FusedNonsymSolver, "solve", HostLoopSolver.solve))):
        wtag = f"{what} {name}"
        with patch:
            (wv, wx, wo), ww, wc = _counted(
                torch, dev, (), lambda: pt.eigs(A, **kw), tag=wtag)
        ws = wo.stats
        wit[name] = (ws.n_iter, ws.nopx, ws.nrorth)
        walls[name] = ww / ws.n_iter
        wr = _complex_residuals(wv, wx, a_sp, wtag, closed)
        print(f"  {name}: wall {ww:.4f} s ({ww * 1e3 / ws.n_iter:.4f} ms per "
              f"cycle), {_stats_line(ws)}; {len(wv)} values, info "
              f"{wo.info}; host reruns {RERUNS[wtag]}; packets "
              f"{ws.packets}, graphs captured {ws.graphs_captured}, "
              f"replayed {ws.graph_replays}; max residual {wr:.2e}; "
              f"cplx_cycle launches {wc['cplx_cycle']}; card {gpu}",
              flush=True)
        del wx
    if len(set(wit.values())) != 1:
        raise AssertionError(f"{what}: the host-reduced witness and the "
                             f"host loop disagree: {wit}")
    print(f"  {tag}: ms per cycle " + ", ".join(
        f"{k} {1e3 * v:.4f}" for k, v in walls.items())
        + f"; the witnesses' cycles / nopx / nrorth {wit['host loop']} "
        f"equal", flush=True)
    return counts


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
        csr, ("dia_matvec",), True, eigs_nx)
    _complexify_cost(torch, dev, gpu, *csr(eigs_nx))

    # (b) the complex conv-diff stencil through the fused complex driver
    def stencil(grid):
        return convection_diffusion_2d(grid, dtype=np.complex64, device=dev)

    paths["11b"] = _fused_eigs(
        torch, dev, gpu, "11b eigs(conv-diff complex64, strategy='fused')",
        stencil, (), False, eigs_nx)

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


def check_krylov_test(torch, dev, gpu):
    """Phase 12's loop test (``csrc/krylov_loop.cu``, row 14) against the
    host loop's test, ``it < maxiter and |r.r| > atol2``, on the card's
    values, in float32 and float64, on the edge inputs: ``|r.r|`` equal to
    ``atol2`` and one ulp either side, nan, ``it = maxiter - 1``,
    ``maxiter = 0`` and ``b = 0`` (``atol2 = |r.r| = 0``): launched alone
    (its decision written out), and before a WHILE node whose body is
    ``cg_p_test`` (the body's last kernel, which runs the test at the end
    of each iteration) on a fixed ``|r.r|``, so that the loop runs while
    the test holds (the count it logs must be where the host's loop would
    stop); then BiCGSTAB's ``rho == 0`` flag on 1, 0, -0 and a complex 0.
    Timed beside the plain PyTorch test on the card.  Returns (0.0: every
    decision equal, or it raises; the timed row)."""
    from arpack_ng_tpu_torch.core.loop import CapturedGraph
    from arpack_ng_tpu_torch.ops import cuda_krylov_loop as kl

    def t(x, dt):
        return torch.tensor(x, dtype=dt, device=dev)

    bad, lines = [], []
    stream = pool = None
    if dev.type == "cuda":
        stream = torch.cuda.Stream(device=dev)
        pool = torch.cuda.MemPool()
        kl.body_stream(dev)
    for dt in (torch.float32, torch.float64):
        npd = np.float32 if dt == torch.float32 else np.float64
        one = npd(1.0)
        cases = (("|r.r| = atol2", one, one, 0, 5),
                 ("one ulp above", np.nextafter(one, npd(2)), one, 0, 5),
                 ("one ulp below", np.nextafter(one, npd(0)), one, 0, 5),
                 ("nan", np.nan, one, 0, 5),
                 ("it = maxiter - 1", 2.0, one, 4, 5),
                 ("maxiter = 0", 2.0, one, 0, 0),
                 ("b = 0", 0.0, 0.0, 0, 5))
        for name, rr, a2, it0, maxiter in cases:
            rr_d, a2_d = t(rr, dt), t(a2, dt)
            host = it0 < maxiter and bool(torch.abs(rr_d) > a2_d)
            stop = maxiter if host else it0
            it = t(it0, torch.int32)
            go = t(0, torch.int32)
            kl.krylov_test(rr_d, a2_d, it, maxiter, bump=0, go=go)
            alone = bool(go.item())
            log = kl.IterationLog(dev)
            st = _upd_state(torch, dev, dt, 64, 7, False)

            def body(test):
                return kl.cg_p_test(st["rzn"], st["rz"], st["z"], st["p"],
                                    st["pap"], rr=rr_d, test=test)

            if dev.type == "cuda":
                stream.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(stream):
                    graph = CapturedGraph(
                        lambda: kl.run_while(rr_d, a2_d, it.fill_(it0),
                                             maxiter, body, log=log,
                                             pool=pool),
                        torch.cuda.graph_pool_handle())
                    graph.replay()
                torch.cuda.synchronize(dev)
            else:
                kl.run_while(rr_d, a2_d, it.fill_(it0), maxiter, body,
                             log=log)
            logged = log.drain()
            lines.append(f"{str(dt)[6:]} {name}: host {host}, kernel "
                         f"{alone}, node stops at {logged}")
            if alone != host or logged != [stop]:
                bad.append(lines[-1])
        for rho in (1.0, 0.0, -0.0, 0j):
            cdt = (torch.complex64 if dt == torch.float32
                   else torch.complex128) if isinstance(rho, complex) else dt
            rho_d = t(rho, cdt)
            brk = t(False, torch.bool)
            kl.krylov_test(t(2.0, dt), t(1.0, dt), t(0, torch.int32), 5,
                           bump=0, rho=rho_d, brk=brk)
            if bool(brk.item()) != bool(rho_d == 0):
                bad.append(f"{str(dt)[6:]} rho {rho}: flag {bool(brk)}")
    print(f"12 loop test (kernel vs the host test, alone and before a WHILE "
          f"node whose body ends with it): " + "; ".join(lines), flush=True)
    if bad:
        raise AssertionError(f"loop test differs from the host's: {bad}")
    if dev.type != "cuda":
        return 0.0, None
    flush = timing.flush_buffer(dev)
    rr, a2 = t(2.0, torch.float64), t(1.0, torch.float64)
    it = t(0, torch.int32)
    maxiter = 1 << 30
    row = _timed_row(
        torch, flush, "krylov_test", "torch.float64", 1, 8 + 8 + 4 + 4, 2,
        "torch.float64",
        lambda: kl.krylov_test(rr, a2, it, maxiter, bump=1),
        lambda: torch.logical_and(it.add_(1) < maxiter, rr > a2))
    row["bound_note"] = ("|r.r|, atol2 and the counter read, the counter "
                         "written: 24 bytes; the launch's own latency is "
                         "what it costs (floor_ms)")
    from arpack_ng_tpu_torch.ops import cuda_gather
    row["floor_ms"] = timing.alternating_ms(
        [lambda: cuda_gather.noop(dev)], flush)[0]
    _print_rows([row])
    return 0.0, row


def _bit_faults(torch, got, want) -> int:
    """Entries of ``got`` whose bits differ from ``want``'s (a nan where
    ``want`` has a nan counts as equal: the card's nans are canonical)."""
    g, w = (torch.view_as_real(t) if t.is_complex() else t
            for t in (got, want))
    g, w = g.reshape(-1), w.reshape(-1)
    if g.shape != w.shape or g.dtype != w.dtype:
        return max(g.numel(), w.numel(), 1)
    gn, wn = torch.isnan(g), torch.isnan(w)
    ib = {2: torch.int16, 4: torch.int32, 8: torch.int64}[g.element_size()]
    same = (g.view(ib) == w.view(ib)) | (gn & wn)
    return int((~same).sum())


def _max_err(torch, got, want) -> float:
    """The largest ``|got - want|`` over entries finite in both."""
    d = (got - want).abs()
    d = d[torch.isfinite(d)]
    return float(d.max()) if d.numel() else 0.0


def _upd_state(torch, dev, dtype, n, seed, edge):
    """Seeded vectors and 0-d scalars for the update kernels; ``edge``
    puts a nan, an infinity, signed zeros and (complex) a nan imaginary
    part into the vectors."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def vec():
        v = torch.randn(n, generator=g, device=dev, dtype=dtype)
        if edge:
            v[0] = float("nan")
            v[1] = float("inf")
            v[2] = -0.0
            v[3] = 0.0
            if dtype.is_complex:
                v[4] = complex(1.5, float("nan"))
                v[5] = complex(-0.0, 2.0)
        return v

    def sca():
        return torch.randn((), generator=g, device=dev, dtype=dtype) + 0.5

    names = ("x", "r", "p", "ap", "z", "v", "vn", "s", "t", "ph", "sh",
             "rhat")
    st = {k: vec() for k in names}
    st.update({k: sca() for k in ("rz", "pap", "rzn", "rho_new", "rho",
                                  "alpha", "omega", "rv", "ts", "tt")})
    return st


def krylov_update_faults(torch, dev, dtype, n, seed=25, edge=True):
    """Each fused update kernel of ``ops/cuda_krylov_loop`` against its
    plain twin (torch ops) on the card, bit for bit, on seeded vectors of
    length ``n`` (with ``edge``: the values of :func:`_upd_state`), the
    restart's selects both ways, the ``rho == 0`` flag both ways, ``z``
    aliasing ``r``.  Returns ``(faults, err)``: a list of the differing
    outputs, and per kernel its largest finite difference."""
    from arpack_ng_tpu_torch.ops import cuda_krylov_loop as kl

    faults, err = [], {f.__name__: 0.0 for f in kl.UPDATES}
    tag = f"{str(dtype)[6:]} n={n}"

    def hold(name, what, got, want):
        err[name] = max(err[name], _max_err(torch, got, want))
        bad = _bit_faults(torch, got, want)
        if bad:
            faults.append(f"{name} {what} ({tag}): {bad} entries differ")

    st = _upd_state(torch, dev, dtype, n, seed, edge)
    c = {k: v.clone() for k, v in st.items()}
    rz_prev = torch.zeros_like(st["rz"])
    kl.cg_xr(c["rz"], c["pap"], c["x"], c["r"], c["p"], c["ap"], rz_prev)
    xn, rn = kl.cg_xr_plain(st["rz"], st["pap"], st["x"], st["r"], st["p"],
                            st["ap"])
    hold("cg_xr", "x", c["x"], xn)
    hold("cg_xr", "r", c["r"], rn)
    hold("cg_xr", "rz_prev", rz_prev, st["rz"])
    for alias in (False, True):
        c = {k: v.clone() for k, v in st.items()}
        z = c["r"] if alias else c["z"]
        kl.cg_p_test(c["rzn"], st["rz"], z, c["p"], c["rz"])
        want = kl.cg_p_plain(st["rzn"], st["rz"], st["r"] if alias
                             else st["z"], st["p"])
        hold("cg_p_test", f"p{' (z is r)' if alias else ''}", c["p"], want)
        hold("cg_p_test", "rz", c["rz"], st["rzn"])
    for restart in (False, True):
        brk = torch.tensor(restart, device=dev)
        c = {k: v.clone() for k, v in st.items()}
        kl.bicg_p(brk, c["rho_new"], c["rho"], c["alpha"], c["omega"],
                  c["r"], c["p"], c["v"])
        want = kl.bicg_p_plain(brk, st["rho_new"], st["rho"], st["alpha"],
                               st["omega"], st["r"], st["p"], st["v"])
        hold("bicg_p", f"p (restart {restart})", c["p"], want)
    c = {k: v.clone() for k, v in st.items()}
    s_out = kl.bicg_s(c["rho_new"], c["rv"], c["r"], c["vn"], c["v"],
                      c["rho"], c["alpha"])
    al, s_want = kl.bicg_s_plain(st["rho_new"], st["rv"], st["r"], st["vn"])
    hold("bicg_s", "s", s_out, s_want)
    hold("bicg_s", "v", c["v"], st["vn"])
    hold("bicg_s", "alpha", c["alpha"], al)
    hold("bicg_s", "rho", c["rho"], st["rho_new"])
    c = {k: v.clone() for k, v in st.items()}
    kl.bicg_r(c["ts"], c["tt"], c["s"], c["t"], c["r"], c["omega"])
    om, r_want = kl.bicg_r_plain(st["ts"], st["tt"], st["s"], st["t"])
    hold("bicg_r", "r", c["r"], r_want)
    hold("bicg_r", "omega", c["omega"], om)
    for zero in (False, True):
        c = {k: v.clone() for k, v in st.items()}
        rho = torch.zeros_like(st["rho"]) if zero else st["rho"]
        brk = torch.tensor(not zero, device=dev)
        kl.bicg_x_test(c["alpha"], c["omega"], c["x"], c["ph"], c["sh"], rho,
                       c["rhat"], c["r"], brk)
        want = kl.bicg_x_plain(st["alpha"], st["omega"], st["x"], st["ph"],
                               st["sh"])
        hold("bicg_x_test", f"x (rho = 0: {zero})", c["x"], want)
        hold("bicg_x_test", f"rhat (rho = 0: {zero})", c["rhat"],
             st["r"] if zero else st["rhat"])
        if bool(brk.item()) is not zero:
            faults.append(f"bicg_x_test brk ({tag}): {bool(brk)}, want "
                          f"{zero}")
    return faults, err


def fused_test_faults(torch, dev):
    """The loop test as the body's last kernel runs it (``cg_p_test`` and
    ``bicg_x_test`` with a ``LoopTest``) against the host loop's test,
    ``it + 1 < maxiter and |rr| > atol2``, on the card's values in every
    dtype: ``|rr|`` equal to ``atol2`` and one ulp either side, nan, a
    complex ``rr`` off the real axis, ``it = maxiter - 2`` and ``maxiter -
    1``, ``maxiter = 0``; the decision written out, the counter bumped, a
    loop that ends logged.  Returns the list of differing cases."""
    from arpack_ng_tpu_torch.ops import cuda_krylov_loop as kl

    bad = []
    for dtype in kl.UPDATE_CODES:
        rdt = torch.empty((), dtype=dtype).real.dtype
        npd = np.float32 if rdt == torch.float32 else np.float64
        one = npd(1.0)
        cases = [(one, 0, 5), (np.nextafter(one, npd(2)), 0, 5),
                 (np.nextafter(one, npd(0)), 0, 5), (np.nan, 0, 5),
                 (2.0, 3, 5), (2.0, 4, 5), (2.0, 0, 0)]
        if dtype.is_complex:
            cases.append((complex(0.6, 0.8), 0, 5))
            cases.append((complex(0.6, 0.81), 0, 5))
        st = _upd_state(torch, dev, dtype, 64, 7, False)
        for rr, it0, maxiter in cases:
            rr_d = torch.tensor(rr, dtype=dtype, device=dev)
            atol2 = torch.tensor(1.0, dtype=rdt, device=dev)
            host = it0 + 1 < maxiter and bool(torch.abs(rr_d) > atol2)
            for name in ("cg_p_test", "bicg_x_test"):
                log = kl.IterationLog(dev)
                log.add_node([])
                test = kl.LoopTest(
                    atol2, torch.tensor(it0, dtype=torch.int32, device=dev),
                    maxiter, log, 0,
                    go=torch.zeros((), dtype=torch.int32, device=dev))
                c = {k: v.clone() for k, v in st.items()}
                if name == "cg_p_test":
                    kl.cg_p_test(c["rzn"], c["rz"], c["z"], c["p"], c["pap"],
                                 rr=rr_d, test=test)
                else:
                    kl.bicg_x_test(c["alpha"], c["omega"], c["x"], c["ph"],
                                   c["sh"], c["rho"], c["rhat"], c["r"],
                                   torch.zeros((), dtype=torch.bool,
                                               device=dev), rr=rr_d,
                                   test=test)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                got = bool(test.go.item())
                logged = log.drain()
                want_log = [] if host else [it0 + 1]
                if got is not host or int(test.it.item()) != it0 + 1 \
                        or logged != want_log:
                    bad.append(f"{name} {str(dtype)[6:]} rr={rr} it={it0} "
                               f"maxiter={maxiter}: go {got} (host {host}), "
                               f"it {int(test.it.item())}, log {logged}")
    return bad


def _timed_updates(torch, dev, flush, n, kernels):
    """The update kernels ``kernels`` timed beside their twins at ``n``
    float64 (the shape their main path gives them), each beside its bound
    (the vectors it reads and writes once; a few flops a value)."""
    from arpack_ng_tpu_torch.ops import cuda_krylov_loop as kl

    st = _upd_state(torch, dev, torch.float64, n, 11, False)
    rz_prev = st["rz"].clone()
    brk = torch.zeros((), dtype=torch.bool, device=dev)
    # name -> (vectors moved, flops a value, kernel, twin)
    spec = {
        "cg_xr": (6, 4, lambda: kl.cg_xr(
            st["rz"], st["pap"], st["x"], st["r"], st["p"], st["ap"],
            rz_prev), lambda: kl.cg_xr_plain(
            st["rz"], st["pap"], st["x"], st["r"], st["p"], st["ap"])),
        "cg_p_test": (3, 2, lambda: kl.cg_p_test(
            st["rzn"], rz_prev, st["z"], st["p"], st["rz"]),
            lambda: kl.cg_p_plain(st["rzn"], rz_prev, st["z"], st["p"])),
        "bicg_p": (4, 4, lambda: kl.bicg_p(
            brk, st["rho_new"], st["rho"], st["alpha"], st["omega"],
            st["r"], st["p"], st["v"]), lambda: kl.bicg_p_plain(
            brk, st["rho_new"], st["rho"], st["alpha"], st["omega"],
            st["r"], st["p"], st["v"])),
        "bicg_s": (4, 2, lambda: kl.bicg_s(
            st["rho_new"], st["rv"], st["r"], st["vn"], st["v"], st["rho"],
            st["alpha"]), lambda: kl.bicg_s_plain(
            st["rho_new"], st["rv"], st["r"], st["vn"])),
        "bicg_r": (3, 2, lambda: kl.bicg_r(
            st["ts"], st["tt"], st["s"], st["t"], st["r"], st["omega"]),
            lambda: kl.bicg_r_plain(st["ts"], st["tt"], st["s"], st["t"])),
        "bicg_x_test": (4, 4, lambda: kl.bicg_x_test(
            st["alpha"], st["omega"], st["x"], st["ph"], st["sh"], st["rho"],
            st["rhat"], st["r"], brk), lambda: kl.bicg_x_plain(
            st["alpha"], st["omega"], st["x"], st["ph"], st["sh"]))}
    rows = []
    for name in kernels:
        vecs, flops, kern, plain = spec[name]
        rows.append(_timed_row(torch, flush, name, "torch.float64", n,
                               vecs * n * 8, flops * n, "torch.float64",
                               kern, plain))
    return rows


def check_krylov_updates(torch, dev, gpu, cg_n, bicg_n):
    """Phase 12's fused update kernels (``csrc/krylov_loop.cu``, row 14
    redesigned) against their twins, bit for bit, on edge inputs in
    float32, float64, complex64 and complex128 (an odd length, a nan, an
    infinity, signed zeros, a complex nan part) and on seeded vectors at
    the main paths' lengths (12a's ``cg_n``, 12c's ``bicg_n``, float64);
    the loop test they end with against the host's (:func:`
    fused_test_faults`); each timed at its main path's length beside its
    twin and bound.  Returns ``(err: kernel -> max abs err, rows)``."""
    from arpack_ng_tpu_torch.ops import cuda_krylov_loop as kl

    err = {f.__name__: 0.0 for f in kl.UPDATES}
    faults = []
    runs = [(dt, 65_536 + 3, True) for dt in kl.UPDATE_CODES] + \
        [(torch.float64, cg_n, False), (torch.float64, bicg_n, False)]
    for dt, n, edge in runs:
        f, e = krylov_update_faults(torch, dev, dt, n, edge=edge)
        faults += f
        err = {k: max(err[k], e[k]) for k in err}
    faults += fused_test_faults(torch, dev)
    print(f"12 fused update kernels vs twins (bit for bit, every dtype, edge "
          f"inputs at n = 65539, seeded float64 at n = {cg_n} and {bicg_n}; "
          f"the loop test they end with vs the host's): "
          f"{'all equal' if not faults else faults}; max abs err {err}",
          flush=True)
    if faults:
        raise AssertionError(f"update kernels differ from their twins: "
                             f"{faults}")
    if dev.type != "cuda":
        return err, []
    flush = timing.flush_buffer(dev)
    rows = _timed_updates(torch, dev, flush, cg_n, ("cg_xr", "cg_p_test")) \
        + _timed_updates(torch, dev, flush, bicg_n,
                         ("bicg_p", "bicg_s", "bicg_r", "bicg_x_test"))
    print(f"12 fused update kernels (float64, device-only median of "
          f"{timing.REPS} in alternation, L2 flushed by a read; card {gpu}):",
          flush=True)
    _print_rows(rows)
    return err, rows


def _cg_read_share(torch, dev, matvec, pc, b, its=P12_READ_ITS):
    """ms per CG iteration with the loop test's read (``solvers._cg`` at
    tol 0: the update kernels, the last writing the decision, read back),
    without it (``its`` in-place iterations, ``solvers._cg_iteration``,
    one sync at the end) and as one CUDA-graph WHILE node (the solve of
    ``make_iterative_solve`` captured once, then replayed: the test kernel
    decides on the card), in turns (read, free, graph, graph, free, read,
    read, free, graph), on the same right-hand side.  The graph's solves
    must each run ``its`` iterations."""
    from arpack_ng_tpu_torch.core.loop import CapturedGraph
    from arpack_ng_tpu_torch.ops import solvers

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def with_reads():
        if solvers._cg(matvec, b, None, 0.0, its, pc)[1] != its:
            raise AssertionError("CG stopped before its iteration count")

    def read_free():
        c, _ = solvers.cg_start(matvec, b, None, 0.0, pc)
        carry = solvers._cg_carry(c, pc)
        for _ in range(its):
            solvers._cg_iteration(matvec, carry, pc)

    forms = [with_reads, read_free]
    if dev.type == "cuda":
        solve = solvers.make_iterative_solve(matvec, symmetric=True,
                                             tol=0.0, maxiter=its,
                                             precond=pc)
        solve.bind(dev)
        stream = torch.cuda.Stream(device=dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            graph = CapturedGraph(lambda: solve(b),
                                  torch.cuda.graph_pool_handle())

        def on_graph():
            with torch.cuda.stream(stream):
                graph.replay()

        forms.append(on_graph)
    times = [[] for _ in forms]
    for i in (0, 1, 2, 2, 1, 0, 0, 1, 2):
        if i >= len(forms):
            continue
        sync()
        t0 = time.perf_counter()
        forms[i]()
        sync()
        times[i].append(time.perf_counter() - t0)
    if dev.type == "cuda":
        if solve.iterations != [its] * 3 or not all(solve.on_graph):
            raise AssertionError(f"the graph's CG solves ran "
                                 f"{solve.iterations}, not {its} each")
    return [float(np.median(t)) * 1e3 / its for t in times] + \
        [None] * (3 - len(forms))


def _cg_bytes(n_pad, nd_a, nd_l, nd_lt, sweeps=3):
    """Bytes one IC(0)-preconditioned CG iteration moves as the code is
    written (``solvers._cg_iteration``: each DIA launch, dot and update
    kernel reads its inputs once and writes its output once, 8-byte
    values): Ap (the table, p, Ap), p.Ap, ``cg_xr`` (x, r, p, Ap read; x,
    r written), the L sweeps (the table, z, rn, the output; the last also
    dinv), the L^T sweeps, r.z and r.r, ``cg_p_test`` (z, p read; p
    written); and the least any code could move: each input vector and
    table read once, each output vector written once."""
    def sweep(nd):
        return nd + 3
    w = (nd_a + 2) + 2 + 6
    w += sweeps * sweep(nd_l) + 1 + sweeps * sweep(nd_lt)
    w += 2 + 2 + 3
    least = 3 + nd_a + nd_l + nd_lt + 1 + 4          # x r p, tables; x r z p
    return 8 * n_pad * w, 8 * n_pad * least


def _twin_cg_p_test(rzn, rz_prev, z, p, rz, *, rr=None, test=None):
    """``cuda_krylov_loop.cg_p_test`` by its twin's torch ops on the card,
    the loop test by the test kernel (a graph cannot hold the twin's
    host read)."""
    from arpack_ng_tpu_torch.ops import cuda_krylov_loop as kl

    kl.cg_p_inplace_plain(rzn, rz_prev, z, p, rz)
    if test is not None:
        return kl.krylov_test(rr.abs(), test.atol2, test.it,
                              test.maxiter, bump=1, handle=test.handle,
                              log=test.log, node=test.node, go=test.go)
    return None


def _lockstep(torch, what, step_fn, twin_fn, carry, c, fields, its=5):
    """``its`` iterations of the in-place kernel form (``step_fn(carry)``,
    ``carry`` a copy of ``c``'s tensors) beside the twins' step (``c =
    twin_fn(c)``) from one state, on a main
    path's real operator and vectors: after each, the buffers ``fields``
    (index in ``carry``, index in ``c``) equal bit for bit.  Returns the
    faults."""
    faults = []
    for k in range(its):
        step_fn(carry)
        c = twin_fn(c)
        for i, j in fields:
            bad = _bit_faults(torch, carry[i], c[j])
            if bad:
                faults.append(f"{what} iteration {k + 1}, buffer {i}: {bad} "
                              "entries differ")
    return faults


def _dia_f64_rows(torch, dev, gpu, shifted, n, flush):
    """Row 7 at 12a's float64 shapes: ``dia_kernel`` on the shifted
    Laplacian (5 diagonals) and on the IC(0) strict triangles (2
    diagonals), and its epilogue forms on the lower triangle, each beside
    its twin, its bound and the library call (``torch.mv`` of the CSR
    matrix; for ``y - A z`` ``torch.addmv(y, A_csr, z, alpha=-1)``,
    cuSPARSE).  The forms are first held bit for bit against their twins.
    Returns the rows."""
    import scipy.sparse as sp

    from arpack_ng_tpu_torch.ops import cuda_dia
    from arpack_ng_tpu_torch.ops.sparse import dia_table

    g = torch.Generator(device=dev).manual_seed(13)

    def vec():
        return torch.randn(n, generator=g, device=dev, dtype=torch.float64)

    x, y, d = vec(), vec(), vec().abs() + 0.25
    rows, faults = [], []
    for name, mat in (("shifted", shifted), ("lower", sp.tril(shifted, -1)),
                      ("upper", sp.triu(shifted, 1))):
        mat = mat.tocsr()
        offs, tab = (torch.from_numpy(a).to(dev) for a in dia_table(mat, n))
        nd = tab.shape[0]
        for form in (cuda_dia.SUB, cuda_dia.SCALE_SUB, cuda_dia.SUB_SCALED):
            got = cuda_dia.dia_matvec_sub(offs, tab, x, n, y, d, form)
            want = cuda_dia.dia_matvec_sub_plain(offs, tab, x, n, y, d, form)
            bad = _bit_faults(torch, got, want)
            if bad:
                faults.append(f"{name} form {form}: {bad}")
        csr = _csr_on(torch, mat, dev)
        rows.append(_timed_row(
            torch, flush, "dia_matvec", "torch.float64", nd,
            (nd + 2) * n * 8 + 8 * nd, 2 * mat.nnz, "torch.float64",
            lambda: cuda_dia.dia_matvec(offs, tab, x, n),
            lambda: cuda_dia.dia_matvec_plain(offs, tab, x, n),
            lambda: torch.mv(csr, x)))
        rows[-1]["table"] = name
        if name != "lower":
            continue
        for form, label in ((cuda_dia.SUB, "y - Az"),
                            (cuda_dia.SCALE_SUB, "d(y - Az)"),
                            (cuda_dia.SUB_SCALED, "y - d(Az)")):
            extra = 0 if form == cuda_dia.SUB else 1
            rows.append(_timed_row(
                torch, flush, "dia_matvec_sub", "torch.float64", nd,
                (nd + 3 + extra) * n * 8 + 8 * nd,
                2 * mat.nnz + (1 + extra) * n, "torch.float64",
                lambda f=form: cuda_dia.dia_matvec_sub(offs, tab, x, n, y, d,
                                                       f),
                lambda f=form: cuda_dia.dia_matvec_sub_plain(
                    offs, tab, x, n, y, d, f),
                (lambda: torch.addmv(y, csr, x, alpha=-1))
                if form == cuda_dia.SUB else None))
            rows[-1]["table"], rows[-1]["form"] = name, label
    print(f"12a row 7 at float64 (n = {n}): the epilogue forms vs their "
          f"twins on the shifted product and both IC(0) triangles: "
          f"{'bit for bit' if not faults else faults}; timed (device-only "
          f"median of {timing.REPS} in alternation, L2 flushed by a read; "
          f"library torch.mv / torch.addmv of the CSR matrix, cuSPARSE; "
          f"card {gpu}):", flush=True)
    if faults:
        raise AssertionError(f"dia_matvec_sub differs from its twin: "
                             f"{faults}")
    for r in rows:
        print(f"   [{r['table']}{', ' + r['form'] if 'form' in r else ''}]",
              flush=True)
        _print_rows([r])
    return rows


def _shift_invert_main(torch, dev, gpu, nx, need):
    """12a, the main path: ``eigsh`` on ``shift_invert_operator`` (mode 3,
    sigma = 0) of the 2-D Laplacian, each inner solve CG with the IC(0)
    preconditioner, the shifted product a DIA launch and each of the six
    triangle sweeps a launch of its epilogue form, the vector passes the
    fused update kernels.  Returns ``(launches, row 7's float64 rows)``."""
    import warnings
    from unittest import mock

    import scipy.sparse as sp

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.models import laplacian_2d
    from arpack_ng_tpu_torch.ops import cuda_krylov_loop as kl
    from arpack_ng_tpu_torch.ops import solvers, transforms

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
    cuda = dev.type == "cuda"
    # row 7 at these float64 shapes, its epilogue forms bit for bit their
    # twins on the preconditioner's tables; not counted
    dia_rows = _dia_f64_rows(torch, dev, gpu, shifted, n,
                             timing.flush_buffer(dev)) if cuda else []
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
    b = torch.zeros(op_s.n_pad, dtype=torch.float64, device=dev)
    b[:n] = x
    # the update kernels on this operator's real vectors: five in-place
    # iterations beside the twins' cg_step, bit for bit; not counted
    c, _ = solvers.cg_start(op_s.a_apply, b, None, 1e-10, pc)
    faults = _lockstep(
        torch, "12a CG", lambda s: solvers._cg_iteration(op_s.a_apply, s, pc),
        lambda c: solvers.cg_step(op_s.a_apply, c, pc),
        solvers._cg_carry([t.clone() for t in c], pc), c,
        ((0, 0), (1, 1), (2, 2), (3, 3), (4, 4)))
    print(f"12a update kernels on the operator's vectors (5 iterations "
          f"beside cg_step, the twins): "
          f"{'bit for bit' if not faults else faults}", flush=True)
    if faults:
        raise AssertionError(f"12a: the update kernels differ from the "
                             f"twins: {faults}")

    def run(capturable, twins=False):
        solve = solvers.make_iterative_solve(
            op_s.a_apply, symmetric=True, tol=1e-10,
            maxiter=P12_CG_MAXITER, precond=pc)
        op = transforms.shift_invert_operator(
            n, np.float64, solve, sigma=sigma, mode=3, n_pad=op_s.n_pad,
            hermitian=True, a_apply=op_s.a_apply, device=dev,
            capturable=capturable)
        kernels = ("dia_matvec", "dia_matvec_sub", "sym_cycle") \
            + (() if twins else ("cg_xr", "cg_p_test")) \
            + (("krylov_test",) if capturable else ())
        res = _counted(torch, dev, need(*kernels),
                       lambda: pt.eigsh(op, k=8, which="LM", ncv=NCV,
                                        tol=1e-8, return_stats=True))
        return res, solve

    tag = f"12a eigsh(shift-invert sigma=0, CG + IC(0), nx={nx})"
    ((vals, vecs, out), wall, counts), solve = run(True)
    its = np.asarray(solve.iterations)
    on_graph = np.asarray(solve.on_graph)
    if its.max() >= P12_CG_MAXITER:
        raise AssertionError(f"{tag}: a CG solve ran to its cap")
    dmax, rmax = _gate_pairs(vals, vecs, a_sp, _analytic_spectrum(nx)[:256],
                             1e-6, 1e-6, tag, count=8)
    st = out.stats
    # per CG iteration: the product, 6 sweeps (the epilogue form), cg_xr and
    # cg_p_test (the loop test in it); before each solve the product and
    # the sweeps of r = b - A x, z = M^-1 r, and one test before each node
    want = {"dia_matvec": its.sum() + len(its),
            "dia_matvec_sub": 6 * (its.sum() + len(its)),
            "cg_xr": its.sum(), "cg_p_test": its.sum(),
            "krylov_test": on_graph.sum()}
    if cuda and (any(counts[k] != v for k, v in want.items())
                 or not on_graph.all() or not st.graphs_captured
                 or not st.graph_replays or st.packets != st.n_iter):
        raise AssertionError(
            f"{tag}: launches {counts} (want {want}), {on_graph.sum()} "
            f"solves on the graphs, graphs {st.graphs_captured}, replays "
            f"{st.graph_replays}, packets {st.packets} for {st.n_iter} "
            f"cycles")
    g_its = its[on_graph].sum()
    print(f"{tag}: wall {wall:.4f} s (host, not in it: from_scipy "
          f"{t_dia:.2f} s, ilu0_preconditioner {t_ilu:.2f} s); "
          f"{_stats_line(st)}; graphs captured {st.graphs_captured}, "
          f"replayed {st.graph_replays}, packets read {st.packets} (one a "
          f"cycle); CG: {_iters(its)}, {on_graph.sum()} solves ({g_its} "
          f"iterations) as WHILE nodes (the first, eager cycle's each in a "
          f"graph of its own, the rest in the device loop's graphs); "
          f"{wall * 1e3 / its.sum():.4f} ms per CG "
          f"iteration (the solve's wall over its CG iterations); max value "
          f"dist {dmax:.2e}, max residual {rmax:.2e}; launches {counts} "
          f"(per CG iteration 1 DIA product, 6 sweeps, cg_xr and cg_p_test, "
          f"no separate loop test; one test before each node); card {gpu}",
          flush=True)
    print(f"  values {np.array2string(vals, precision=10)}", flush=True)
    key = (st.n_iter, st.nopx, st.nrorth, st.nrorthr)
    # the witnesses: the same solve through the host loop, and on the
    # graphs with the update kernels' twins (torch ops, the test kernel
    # ending the body), each bit for bit
    ((w_vals, w_vecs, w_out), w_wall, w_counts), w_solve = run(False)
    ws = w_out.stats
    same = (np.array_equal(vals, w_vals), np.array_equal(vecs, w_vecs),
            w_solve.iterations == list(its),
            (ws.n_iter, ws.nopx, ws.nrorth, ws.nrorthr) == key,
            all(w_counts[k] == counts[k] for k in counts
                if k != "krylov_test"))
    del w_vecs
    print(f"  witness through the host loop (capturable=False, the same "
          f"full width nx={nx}; the update kernels, the decision read back "
          f"each iteration): wall {w_wall:.4f} s, {_stats_line(ws)}, graphs "
          f"{ws.graphs_captured}; {w_wall * 1e3 / its.sum():.4f} ms per CG "
          f"iteration; bit for bit (values, vectors, iterations, counters, "
          f"launches): {same}", flush=True)
    if not all(same):
        raise AssertionError(f"{tag}: the graphs and the host loop differ "
                             f"{same}")
    with mock.patch.object(kl, "cg_xr", kl.cg_xr_inplace_plain), \
            mock.patch.object(kl, "cg_p_test", _twin_cg_p_test):
        ((t_vals, t_vecs, t_out), t_wall, t_counts), t_solve = run(
            True, twins=True)
    ts = t_out.stats
    same = (np.array_equal(vals, t_vals), np.array_equal(vecs, t_vecs),
            t_solve.iterations == list(its),
            (ts.n_iter, ts.nopx, ts.nrorth, ts.nrorthr) == key)
    del vecs, t_vecs
    print(f"  witness with the update kernels' twins (torch ops on the card, "
          f"the test kernel ending each body; on the graphs, full width): "
          f"wall {t_wall:.4f} s, {_stats_line(ts)}, graphs "
          f"{ts.graphs_captured}; {t_wall * 1e3 / its.sum():.4f} ms per CG "
          f"iteration; loop tests {t_counts['krylov_test']}; bit for bit "
          f"(values, vectors, iterations, counters): {same}", flush=True)
    if not all(same):
        raise AssertionError(f"{tag}: the kernels and their twins differ "
                             f"{same}")
    ms_read, ms_free, ms_graph = _cg_read_share(torch, dev, op_s.a_apply,
                                                pc, b)
    nd_a = shifted.todia().offsets.size
    nd_l = sp.tril(shifted, -1).todia().offsets.size
    code_b, least_b = _cg_bytes(op_s.n_pad, nd_a, nd_l, nd_l)
    graph_ms = "not measured" if ms_graph is None else f"{ms_graph:.4f} ms"
    print(f"  CG iteration: {ms_read:.4f} ms with the loop test's read, "
          f"{ms_free:.4f} ms without (eager), {graph_ms} as a WHILE node "
          f"of a graph (median of 3 runs of {P12_READ_ITS} iterations in "
          f"turns): the read's share of the eager iteration "
          f"{100 * (1 - ms_free / ms_read):.1f}%; bytes per iteration as "
          f"written {code_b / 1e6:.1f} MB "
          f"({code_b / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s"
          + ("" if ms_graph is None else
             f", {100 * code_b / HBM_BYTES_PER_S * 1e3 / ms_graph:.1f}% of "
             f"the node's pace") + f"), at least {least_b / 1e6:.1f} MB "
          f"({least_b / HBM_BYTES_PER_S * 1e3:.4f} ms); card {gpu}",
          flush=True)
    CG_PACE.update(read=ms_read, free=ms_free, graph=ms_graph,
                   code_bytes=code_b, least_bytes=least_b,
                   its=int(its.sum()), graph_its=int(g_its))
    return counts, dia_rows


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
    # the update kernels on this operator's real vectors: five in-place
    # iterations beside the twins' bicgstab_step, bit for bit; not counted
    g = torch.Generator(device=dev).manual_seed(12)
    b = torch.zeros(op_s.n_pad, dtype=torch.float64, device=dev)
    b[:n] = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
    c, _ = solvers.bicgstab_start(op_s.a_apply, b, None, 1e-12)
    faults = _lockstep(
        torch, "12c BiCGSTAB",
        lambda s: solvers._bicg_iteration(op_s.a_apply, s, pc),
        lambda c: solvers.bicgstab_step(op_s.a_apply, c, pc),
        solvers._bicg_carry([t.clone() for t in c]), c,
        tuple((i, i) for i in range(8)))
    print(f"12c update kernels on the operator's vectors (5 iterations "
          f"beside bicgstab_step, the twins): "
          f"{'bit for bit' if not faults else faults}", flush=True)
    if faults:
        raise AssertionError(f"12c: the update kernels differ from the "
                             f"twins: {faults}")
    solve = solvers.make_iterative_solve(
        op_s.a_apply, symmetric=False, tol=1e-12, maxiter=P12_BICG_MAXITER,
        precond=pc)
    op = transforms.shift_invert_operator(
        n, np.float64, solve, sigma=0.0, mode=3, n_pad=op_s.n_pad,
        a_apply=op_s.a_apply, device=dev, capturable=True)
    tag = f"12c eigs(shift-invert sigma=0, BiCGSTAB + ILU(0), nx={bicg_nx})"
    (vals, vecs, out), wall, counts = _counted(
        torch, dev, need("dia_matvec", "dia_matvec_sub", "krylov_test",
                         "bicg_p", "bicg_s", "bicg_r", "bicg_x_test"),
        lambda: pt.eigs(op, **kw))
    its = np.asarray(solve.iterations)
    if its.max() >= P12_BICG_MAXITER:
        raise AssertionError(f"{tag}: a BiCGSTAB solve ran to its cap")
    st = out.stats
    on_graph = np.asarray(solve.on_graph)
    # per iteration two products, 12 sweeps and the four update kernels;
    # before each solve r = b - A x and one test
    want = {"dia_matvec": 2 * its.sum() + len(its),
            "dia_matvec_sub": 12 * its.sum(), "bicg_p": its.sum(),
            "bicg_s": its.sum(), "bicg_r": its.sum(),
            "bicg_x_test": its.sum(), "krylov_test": on_graph.sum()}
    if dev.type == "cuda" and (not on_graph.all()
                               or any(counts[k] != v
                                      for k, v in want.items())):
        raise AssertionError(f"{tag}: graphs {st.graphs_captured}, "
                             f"{on_graph.sum()} solves on them, launches "
                             f"{counts} (want {want})")
    ref = spla.eigs(a.tocsc(), k=24, sigma=0.0, return_eigenvectors=False)
    dmax, rmax = _gate_pairs(vals, vecs, a, ref, 1e-8, 1e-6, tag, count=6)
    del vecs
    print(f"{tag}: wall {wall:.4f} s (host, not in it: from_scipy and "
          f"ilu0_preconditioner {t_host:.2f} s); {len(vals)} values; "
          f"{_stats_line(st)}; graphs captured {st.graphs_captured}, "
          f"replayed {st.graph_replays}, packets {st.packets}; BiCGSTAB: "
          f"{_iters(its)}, {on_graph.sum()} solves as WHILE nodes (in "
          f"graphs of their own in an eager cycle, else the loop's); "
          f"{wall * 1e3 / its.sum():.4f} ms per iteration; max value dist "
          f"{dmax:.2e} (scipy's 24 nearest), max residual {rmax:.2e}; "
          f"launches {counts}; card {gpu}", flush=True)
    paths["12c bicgstab"] = counts
    return paths


def _svds_full(torch, dev, gpu, shape, need, mesh=None,
               methods=("normal", "augmented"), tag0="12d"):
    """12d: ``svds`` of a float32 ``A = U diag(s) V^T`` made on the card
    from seeded orthonormal factors (top eight singular values 10..3, the
    rest 1..0.01), through ``methods`` (with ``mesh``: row-partitioned on
    it, 15c).  Returns each path's launches."""
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
    for method in methods:
        tag = f"{tag0} svds({m} x {n} float32, k=8, method='{method}')"
        (uu, s, vh), wall, counts = _counted(
            torch, dev, need("sym_cycle"),
            lambda: pt.svds(A, k=8, tol=1e-6, method=method, device=dev,
                            mesh=mesh))
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
        paths[f"{tag0} {method}"] = counts
        if mesh is not None:
            paths[f"{tag0} {method}"] = dict(counts=counts, s=s, wall=wall)
    return paths


def transform_paths(torch, dev, gpu, nx=P12_NX, dense_n=P12_DENSE_N,
                    mode2_n=P12_MODE2_N, eigs_nx=P12_EIGS_NX,
                    bicg_nx=P12_BICG_NX, svd_shape=P12_SVD_SHAPE):
    """Phase 12: the spectral transforms, their linear solvers and
    ``svds`` at full width (see the module docstring).  Returns each
    path's kernel launches and row 7's float64 rows (12a's shapes)."""
    def need(*kernels):
        # a wrapper counts only the kernel launches a card makes
        return kernels if dev.type == "cuda" else ()

    t0 = time.perf_counter()
    paths = {}
    paths["12a"], dia_rows = _shift_invert_main(torch, dev, gpu, nx, need)
    paths.update(_dense_modes(torch, dev, gpu, dense_n, mode2_n, need))
    paths.update(_eigs_transforms(torch, dev, gpu, eigs_nx, bicg_nx, need))
    paths.update(_svds_full(torch, dev, gpu, svd_shape, need))
    elapsed = time.perf_counter() - t0
    print(f"phase 12: {elapsed:.2f} s (limit {P12_MAX_S:.0f} s)", flush=True)
    if elapsed > P12_MAX_S:
        raise AssertionError(f"phase 12 took {elapsed:.1f} s")
    return paths, dia_rows


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
    mv, blk, _ = _dia_products(offsets, diags, n, n_pad, dev)

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
            with _replays_counted() as replays:
                (vals, vecs, info), wall, counts = _counted(
                    torch, dev, need("dia_block_matvec", "rotate_rows"),
                    lambda: eigsh_block(A, block_size=b,
                                        maxiter=P13_BLOCK_MAXITER,
                                        dtype=np.float32, **kw))
            if dev.type == "cuda" and len(replays) != info["iters"] - 1:
                raise AssertionError(f"{tag}: {len(replays)} graph replays "
                                     f"for {info['iters']} cycles (want "
                                     "every cycle after the first)")
            eager = _block_eager(torch, dev, tag, A, b, kw, need,
                                 (vals, vecs, info, wall, counts))
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
                  f"per cycle on one graph ({len(replays)} replays; "
                  f"{eager}) "
                  f"(eigh of T {eigh_ms:.4f} ms of it, "
                  f"{100 * eigh_ms / cyc_ms:.1f}%), block apply "
                  f"{_block_apply_ms(torch, dev, A, b)} ms device-only; "
                  f"{note}; launches {counts}; card {gpu}", flush=True)
            paths[f"13d{key} b={b}"] = counts
        del vecs
    return paths


@contextlib.contextmanager
def _replays_counted():
    """Yields a list that gains an entry on every CUDA graph replay
    (``core/loop.CapturedGraph.replay``) inside the context."""
    from unittest import mock

    from arpack_ng_tpu_torch.core import loop

    seen, real = [], loop.CapturedGraph.replay

    def replay(self):
        seen.append(self)
        return real(self)

    with mock.patch.object(loop.CapturedGraph, "replay", replay):
        yield seen


def _block_eager(torch, dev, tag, A, b, kw, need, graph) -> str:
    """13d's block solve again with ``A`` declared not capturable (every
    cycle eager), against ``graph = (vals, vecs, info, wall, launches)``
    from the solve on one CUDA graph per solve: equal cycles, matvecs and
    launches, values and vectors bit for bit.  Returns the eager wall and
    ms per cycle, to print."""
    import dataclasses

    from arpack_ng_tpu_torch.core.block import eigsh_block

    vals, vecs, info, wall, counts = graph
    (v2, x2, i2), w2, c2 = _counted(
        torch, dev, need("dia_block_matvec", "rotate_rows"),
        lambda: eigsh_block(dataclasses.replace(A, capturable=False),
                            block_size=b, maxiter=P13_BLOCK_MAXITER,
                            dtype=np.float32, **kw))
    same = np.array_equal(vals, v2) and np.array_equal(vecs, x2)
    if info != i2 or counts != c2 or not same:
        raise AssertionError(f"{tag}: graph {info}, launches {counts}; eager "
                             f"{i2}, launches {c2}; values and vectors "
                             f"bit-equal {same}")
    return (f"eager: wall {w2:.4f} s, {w2 * 1e3 / i2['iters']:.4f} ms per "
            f"cycle, {w2 / wall:.2f}x; cycles, matvecs, launches, values "
            f"and vectors equal")


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
    with ``X^T``, with the launch's plan (runs, tile rows, shared bytes and
    blocks per SM: ``cuda_dia.block_plan``, held to the library's
    ``block_config``).  Then, untimed, the case list of
    ``tests/torch_dia_cases.py`` in both dtypes at b = 1-9, 16, 17, under
    the same equalities.  Returns (max abs err by dtype, timed rows)."""
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
                    if timed:
                        _print_dia_plan(torch, cuda_dia, name, offsets, n,
                                        n_pad, b, tdt)
            del csr
    _dia_case_list(torch, dev, cuda_dia)
    return err, rows


def _print_dia_plan(torch, cuda_dia, name, offsets, n, n_pad, b, tdt):
    """13e: the block kernel's launch for a timed shape, the host's plan
    held to the library's own sizes."""
    plan = cuda_dia.block_plan(offsets, n, b, tdt)
    cfg = cuda_dia.block_config(len(offsets), b, n_pad, tdt)
    if (cfg["tile"], cfg["window"], cfg["smem"]) != (
            plan["tile"], plan["window"], plan["smem"]):
        raise AssertionError(f"13e {name} b={b}: block_plan {plan} differs "
                             f"from the library's {cfg}")
    spans = ", ".join(f"{hi - lo}" for _, _, lo, hi in plan["runs"])
    print(f"  13e plan {name} {tdt} b={b}: {len(plan['runs'])} runs (spans "
          f"{spans}; window span {plan['span']}), T = {cfg['tile']} rows, "
          f"{cfg['smem']} shared bytes a block, {cfg['blocks_per_sm']} "
          f"blocks per SM, grid {cfg['grid']}", flush=True)


def _dia_case_list(torch, dev, cuda_dia):
    """13e, untimed: the block kernel on ``tests/torch_dia_cases.py``'s
    cases, bit for bit its twin and the single kernel per column."""
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_dia_cases as cases

    count = 0
    for name in cases.CASES:
        for dtype in (np.float32, np.float64):
            for b in cases.BLOCKS:
                offs, tab, X, n = (torch.from_numpy(a).to(dev) if
                                   isinstance(a, np.ndarray) else a
                                   for a in cases.make(name, dtype, b))
                Y = cuda_dia.dia_block_matvec(offs, tab, X, n)
                if not (torch.equal(Y, cuda_dia.dia_block_matvec_plain(
                        offs, tab, X, n)) and all(
                        torch.equal(Y[c], cuda_dia.dia_matvec(offs, tab, X[c],
                                                              n))
                        for c in range(b)) and not Y[:, n:].any()):
                    raise AssertionError(
                        f"13e case {name} {dtype.__name__} b={b}: the block "
                        "kernel is not bit-equal to its twin and the single "
                        "kernel per column")
                count += 1
    print(f"13e case list (tests/torch_dia_cases.py): {count} products of "
          f"{len(cases.CASES)} cases, float32 and float64, b = "
          f"{', '.join(map(str, cases.BLOCKS))}: bit-equal to the twin and "
          "to the single kernel per column", flush=True)


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
        lambda: _cli_inproc(argv), tag="14a")
    vals, dmax, rmax = _cli_gate(rc, out, spectrum, 1e-4, 1e-3,
                                 "14a cli.main", 8)
    st = res.stats
    if dev.type == "cuda":
        _loop_gate(st, "14a")
    print(f"14a cli.main (in process): {_hybrid_line(wall, st)} (recorded "
          f"on the host loop while the dgks step read back every step: "
          f"{RECORDED_WALLS['14a']}), {_stats_line(st)}; host reruns "
          f"{RERUNS['14a']}; max value dist {dmax:.2e}, max residual "
          f"{rmax:.2e}; launches {counts}; card {gpu}", flush=True)
    got = (st.n_iter, st.nopx, st.nrorth)
    if dev.type == "cuda" and nx == NX and got != HYBRID_DGKS_COUNTERS:
        raise AssertionError(f"14a cli.main: cycles/nopx/nrorth {got}, want "
                             f"the host step's {HYBRID_DGKS_COUNTERS}")
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
    if dev.type == "cuda" and not (r2.stats.graphs_captured
                                   and r2.stats.graph_replays):
        raise AssertionError("14b: the resumed run replayed no graph")
    print(f"14b --maxIt {cut} --dump: rc 1, wall {w1:.2f} s; --restart: "
          f"rc 0, wall {w2:.2f} s (graphs captured "
          f"{r2.stats.graphs_captured}, replays {r2.stats.graph_replays}, "
          f"packets {r2.stats.packets}), cycles / nopx / nrorth / nrotr {got}, "
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
        cg = "CG" in argv
        (rc, out, res), wall, counts = _counted(
            torch, dev, need("dia_matvec", *(("dia_matvec_sub", "cg_xr",
                                              "cg_p_test", "krylov_test")
                                             if cg else ())),
            lambda: _cli_inproc(argv + cpu))
        vals, dmax, rmax = _cli_gate(rc, out, spectrum, rel, rel,
                                     f"14d {tag}", count)
        st = res.stats
        if cg and dev.type == "cuda" and not (st.graphs_captured
                                              and st.graph_replays):
            raise AssertionError(f"14d {tag}: no graphs ({st.graphs_captured}"
                                 f" captured, {st.graph_replays} replays)")
        print(f"14d --slv {tag}: wall {wall:.2f} s, {_stats_line(st)}; "
              f"graphs captured {st.graphs_captured}, replayed "
              f"{st.graph_replays}; max value dist {dmax:.2e}, max residual "
              f"{rmax:.2e}; launches {counts}; card {gpu}", flush=True)
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


def _free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _per_step(coll, steps) -> str:
    return ", ".join(f"{k} {v / steps:.3f}" for k, v in sorted(coll.items())
                     if v)


def _mesh_world_one(torch, dev, gpu, nx, need):
    """15a: the flagship on a world of one under NCCL, through the halo
    operator and the gathered stencil, each held to the single path's
    counters exactly.  Returns each path's launches."""
    import torch.distributed as dist

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.models import laplacian_2d
    from arpack_ng_tpu_torch.models.distributed import laplacian_2d_sharded
    from arpack_ng_tpu_torch.parallel import make_mesh

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    paths = {}
    try:
        mesh = make_mesh(device=dev)
        print(f"15a {mesh}: backend {mesh.backend}, collectives captured "
              f"in CUDA graphs: {mesh.capturable}", flush=True)
        small, _ = laplacian_2d_sharded(64, 64, mesh, np.float32)
        pt.eigsh(small, k=8, ncv=NCV, which="LA", tol=1e-5, mesh=mesh)
        spectrum = _analytic_spectrum(nx)
        kw = dict(k=8, ncv=NCV, which="LA", tol=1e-5, return_stats=True,
                  mesh=mesh)
        for tag, make in (
                ("15a halo", lambda: laplacian_2d_sharded(nx, nx, mesh,
                                                          np.float32)),
                ("15a gathered", lambda: laplacian_2d(nx, np.float32,
                                                      device=dev))):
            op, a_sp = make()
            (vals, vecs, out), wall, counts = _counted(
                torch, dev, need(*SELECTIVE_PATH),
                lambda: pt.eigsh(op, **kw))
            dmax, rmax = check_values(vals, vecs, a_sp, spectrum, tag)
            st = out.stats
            _kernel_counters(st, "flagship selective")
            replays = st.n_iter - 1 if (dev.type == "cuda"
                                        and mesh.capturable) else 0
            if st.packets != st.n_iter or st.graph_replays != replays:
                raise AssertionError(f"{tag}: {st.packets} packets, "
                                     f"{st.graph_replays} replays for "
                                     f"{st.n_iter} cycles")
            steps = st.nopx - 1
            w4 = WALLS.get("4")
            beside = "" if w4 is None else \
                f" (phase 4's single path in this run: {w4:.4f} s)"
            print(f"{tag} (flagship nx={nx}, world of one, {mesh.transport})"
                  f": wall {wall:.4f} s{beside}, {wall * 1e3 / steps:.4f} "
                  f"ms per step; {_stats_line(st)}; the kernel's "
                  f"{KERNEL_COUNTERS['flagship selective']}: equal; max "
                  f"value dist {dmax:.2e}, max residual {rmax:.2e}; "
                  f"collectives {dict(st.collectives)}, per step "
                  f"{_per_step(st.collectives, steps)}; {_loop_line(st)}; "
                  f"launches {counts}; card {gpu}", flush=True)
            paths[tag] = counts
            del op, a_sp, vecs
    finally:
        dist.destroy_process_group()
    return paths


def _rank_paths(rank, ranks, port, out_dir, device="cuda", sizes=None):
    """One rank of 15b-c, a process of its own on the card's gloo world
    (``device="cpu"``: on the CPU, a rehearsal); ``sizes``: ``(nx, cd_nx,
    m, n)``, the flagship's grid, the conv-diff grid and the svds shape.
    Its results go to ``<out_dir>/rank<rank>.pkl`` (a failed gate
    raises)."""
    import datetime
    import pickle

    import torch
    import torch.distributed as dist

    import arpack_ng_tpu_torch as pt
    from arpack_ng_tpu_torch.models import convection_diffusion_2d
    from arpack_ng_tpu_torch.models.distributed import laplacian_2d_sharded
    from arpack_ng_tpu_torch.ops import cuda_lib
    from arpack_ng_tpu_torch.parallel import make_mesh

    nx, cd_nx, m, n = sizes or (NX, EIGS_SOLVE_NX) + P12_SVD_SHAPE
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        cuda_lib.load()
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=ranks,
        timeout=datetime.timedelta(seconds=P15_COLLECTIVE_TIMEOUT_S))
    mesh = make_mesh(device=dev)
    res = {"transport": mesh.transport}

    def need(*kernels):
        return kernels if dev.type == "cuda" else ()

    # 15b: the flagship's solve on the halo operator, collectives timed
    op, a_sp = laplacian_2d_sharded(nx, nx, mesh, np.float32)
    mesh.timed = True
    (vals, vecs, out), wall, counts = _counted(
        torch, dev, need(*SELECTIVE_PATH),
        lambda: pt.eigsh(op, k=8, ncv=NCV, which="LA", tol=1e-5, mesh=mesh,
                         return_stats=True))
    mesh.timed = False
    dmax, rmax = check_values(vals, vecs, a_sp, _analytic_spectrum(nx),
                              f"15b rank {rank}")
    st = out.stats
    res["15b"] = dict(vals=vals, wall=wall, counts=counts, dmax=dmax,
                      rmax=rmax, stats=_stats_line(st), nopx=st.nopx,
                      collectives=dict(st.collectives),
                      seconds=dict(mesh.seconds), loop=_loop_line(st))
    del op, a_sp, vecs

    # 15c: the hybrid eigs on the gathered conv-diff stencil, then svds
    op, a_sp = convection_diffusion_2d(cd_nx, dtype=np.float32, device=dev)
    (vals, vecs, out), wall, counts = _counted(
        torch, dev, need("rotate_rows"),
        lambda: pt.eigs(op, k=8, ncv=NCV, which="LM", tol=1e-5,
                        maxiter=EIGS_MAX_RESTARTS, strategy="hybrid",
                        mesh=mesh, return_stats=True))
    rmax = check_nonsym(vals, vecs, a_sp, f"15c eigs rank {rank}")
    res["15c eigs"] = dict(vals=vals, wall=wall, counts=counts, rmax=rmax,
                           stats=_stats_line(out.stats), info=out.info,
                           collectives=dict(out.stats.collectives))
    del op, a_sp, vecs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    res.update(_svds_full(torch, dev, f"rank {rank}", (m, n), need,
                          mesh=mesh, methods=("normal",), tag0="15c"))
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()


def _spawn_ranks(torch, dev, ranks, sizes):
    """15b-c: ``ranks`` processes of this script on ``dev``, each running
    :func:`_rank_paths`; returns their results by rank.  Every process is
    stopped before this returns."""
    import pickle
    import tempfile

    if dev.type == "cuda":
        torch.cuda.empty_cache()
    port = str(_free_port())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        logs = [open(f"{tmp}/rank{r}.log", "w+") for r in range(ranks)]
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--rank", str(r), "--ranks",
             str(ranks), "--port", port, "--out", tmp, "--device",
             dev.type, "--sizes", ",".join(map(str, sizes))],
            stdout=logs[r], stderr=subprocess.STDOUT) for r in range(ranks)]
        deadline = time.perf_counter() + P15_MAX_S
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs) \
                        or time.perf_counter() > deadline:
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        rcs = [p.returncode for p in procs]
        if any(rcs):
            for r, f in enumerate(logs):
                f.seek(0)
                print(f"15 rank {r} (rc {rcs[r]}):\n{f.read()[-4000:]}",
                      flush=True)
            raise AssertionError(f"15b-c ranks failed: {rcs}")
        out = []
        for r in range(ranks):
            with open(f"{tmp}/rank{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        for f in logs:
            f.close()
    return out


def mesh_paths(torch, dev, gpu, nx=NX, ranks=P15_RANKS,
               cd_nx=EIGS_SOLVE_NX, svd_shape=P12_SVD_SHAPE):
    """Phase 15: the distribution layer (see the module docstring).
    Returns each path's kernel launches (rank 0's for 15b-c)."""
    def need(*kernels):
        return kernels if dev.type == "cuda" else ()

    t0 = time.perf_counter()
    paths = _mesh_world_one(torch, dev, gpu, nx, need)
    out = _spawn_ranks(torch, dev, ranks, (nx, cd_nx) + tuple(svd_shape))
    for tag in ("15b", "15c eigs", "15c normal"):
        for r in out[1:]:
            for k in ("vals", "s"):
                if k in out[0][tag] and not np.array_equal(out[0][tag][k],
                                                           r[tag][k]):
                    raise AssertionError(f"{tag}: the ranks' {k} differ")
    b = out[0]["15b"]
    steps = b["nopx"] - 1
    share = sum(b["seconds"].values()) / b["wall"]
    print(f"15b flagship nx={nx} on {ranks} ranks of one card "
          f"({out[0]['transport']}): wall {b['wall']:.4f} s (collectives "
          f"timed between syncs), {b['stats']}; values equal on the ranks "
          f"bit for bit; max value dist {b['dmax']:.2e}, max residual "
          f"{b['rmax']:.2e} (rank 0; every rank gated); collectives "
          f"{b['collectives']}, per step {_per_step(b['collectives'], steps)}"
          f"; their seconds {b['seconds']}, {100 * share:.2f}% of the wall; "
          f"{b['loop']}; launches {b['counts']}; card {gpu}", flush=True)
    print(f"  values {np.array2string(b['vals'], precision=7)}", flush=True)
    c = out[0]["15c eigs"]
    print(f"15c eigs(strategy='hybrid') conv-diff nx={cd_nx} on "
          f"{ranks} ranks: wall {c['wall']:.4f} s, {c['stats']}; "
          f"{len(c['vals'])} values, equal on the ranks, info {c['info']}, "
          f"max residual {c['rmax']:.2e}; collectives {c['collectives']}; "
          f"launches {c['counts']}; card {gpu}", flush=True)
    s = out[0]["15c normal"]
    print(f"15c svds on {ranks} ranks: wall {s['wall']:.4f} s, s "
          f"{np.array2string(s['s'], precision=6)} equal on the ranks; card "
          f"{gpu}", flush=True)
    paths.update({"15b": b["counts"], "15c eigs": c["counts"],
                  "15c svds": s["counts"]})
    elapsed = time.perf_counter() - t0
    print(f"phase 15: {elapsed:.2f} s (limit {P15_MAX_S:.0f} s)", flush=True)
    if elapsed > P15_MAX_S:
        raise AssertionError(f"phase 15 took {elapsed:.1f} s")
    return paths


def _capi_out(nconv, evals, evecs, n):
    """The values and ``(n, nconv)`` vectors a C entry point wrote (vector
    j at offset j*n), in float64."""
    m = nconv.value
    return (evals[:m].astype(np.float64),
            evecs[:m * n].reshape(m, n).T.astype(np.float64))


def _capi_csr(torch, dev, gpu, lib, nx, need):
    """16a: the flagship's CSR through ``atpu_eigsh_csr_s`` in this
    process.  Returns the path's launches."""
    import ctypes

    from arpack_ng_tpu_torch import native_bridge, native_capi
    from arpack_ng_tpu_torch.models import laplacian_2d

    a_sp = laplacian_2d(nx, np.float32, device="cpu")[1]
    a32 = a_sp.astype(np.float32)
    n, k = a32.shape[0], 8
    indptr = a32.indptr.astype(np.int64)
    indices = a32.indices.astype(np.int64)
    data = np.ascontiguousarray(a32.data)
    evals = np.zeros(2 * k, np.float32)
    evecs = np.zeros(2 * k * n, np.float32)
    nconv = ctypes.c_int64()
    native_bridge.stats_reset()
    tag = f"16a atpu_eigsh_csr_s(flagship nx={nx})"
    rc, wall, counts = _counted(
        torch, dev, need("rotate_rows", "dia_matvec"),
        lambda: lib.atpu_eigsh_csr_s(
            n, indptr.ctypes.data, indices.ctypes.data, data.ctypes.data,
            a32.nnz, k, b"LA", 1e-5, NCV, 0, evals.ctypes.data,
            evecs.ctypes.data, ctypes.byref(nconv)), tag="16a")
    if rc != 0 or nconv.value < k:
        raise AssertionError(f"{tag}: rc {rc}, nconv {nconv.value}")
    vals, vecs = _capi_out(nconv, evals, evecs, n)
    dmax, rmax = check_values(vals, vecs, a_sp, _analytic_spectrum(nx), tag,
                              count=nconv.value)
    st = native_capi.stat_c(lib)
    own = native_bridge._last_stats
    if own is None or own.nopx != st[0]:
        raise AssertionError(f"{tag}: the C call did not run this process's "
                             f"bridge (stat_c nopx {st[0]})")
    beside = ""
    if "10a" in STATS:
        s10 = STATS["10a"]
        beside = (f"; 10a (eigsh strategy='hybrid', selective) in this run: "
                  f"wall {WALLS['10a']:.4f} s, cycles {s10.n_iter}, nopx "
                  f"{s10.nopx}, nrorth {s10.nrorth}, nitref {s10.nitref}, "
                  f"nrstrt {s10.nrstrt}")
    if dev.type == "cuda":
        _loop_gate(own, "16a")
    print(f"{tag}: rc {rc}, nconv {nconv.value}, {_hybrid_line(wall, own)} "
          f"(recorded on the host loop while the dgks step read back every "
          f"step: {RECORDED_WALLS['16a']}), cycles "
          f"{own.n_iter}; stat_c nopx {st[0]}, nbx {st[1]}, nrorth {st[2]}, "
          f"nitref {st[3]}, nrstrt {st[4]}, tsaupd {st[5]:.4f} s"
          f"{beside}; host reruns {RERUNS['16a']}; max value dist "
          f"{dmax:.2e}, max residual {rmax:.2e}; launches {counts}; card "
          f"{gpu}", flush=True)
    print(f"  values {np.array2string(vals, precision=7)}", flush=True)
    got = (own.n_iter, int(st[0]), int(st[2]))
    if dev.type == "cuda" and nx == NX and got != HYBRID_DGKS_COUNTERS:
        raise AssertionError(f"{tag}: cycles/nopx/nrorth {got}, want the "
                             f"host step's {HYBRID_DGKS_COUNTERS}")
    return counts


def _capi_matvec(torch, dev, gpu, lib, nx, need):
    """16b: ``atpu_eigsh_matvec_s`` with the C stencil of
    ``csrc/stencil5.c`` as the operator (cut to ``nx``: every OP*x crosses
    to the host and back).  Returns the path's launches."""
    import ctypes

    from arpack_ng_tpu_torch import native_bridge, native_capi
    from arpack_ng_tpu_torch.models import laplacian_2d

    a_sp = laplacian_2d(nx, np.float32, device="cpu")[1]
    n, k = nx * nx, 8
    stencil = ctypes.CDLL(str(native_capi.build_stencil()))
    fn = ctypes.cast(stencil.atpu_stencil5_s, ctypes.c_void_p).value
    ctx = ctypes.c_int64(nx)
    evals = np.zeros(2 * k, np.float32)
    evecs = np.zeros(2 * k * n, np.float32)
    nconv = ctypes.c_int64()
    tag = f"16b atpu_eigsh_matvec_s(C stencil nx={nx})"
    rc, wall, counts = _counted(
        torch, dev, need("rotate_rows"),
        lambda: lib.atpu_eigsh_matvec_s(
            n, fn, ctypes.addressof(ctx), k, b"LA", 1e-5, NCV, 0,
            evals.ctypes.data, evecs.ctypes.data, ctypes.byref(nconv)))
    if rc != 0 or nconv.value < k:
        raise AssertionError(f"{tag}: rc {rc}, nconv {nconv.value}")
    vals, vecs = _capi_out(nconv, evals, evecs, n)
    dmax, rmax = check_values(vals, vecs, a_sp, _analytic_spectrum(nx), tag,
                              count=nconv.value)
    st = native_capi.stat_c(lib)
    own = native_bridge._last_stats
    tmv = own.timers.tmvopx
    print(f"{tag}: rc {rc}, nconv {nconv.value}, wall {wall:.4f} s, cycles "
          f"{own.n_iter}, nopx {st[0]}, nrorth {st[2]}; OP*x round trips "
          f"(device -> pinned host -> C -> device) {tmv * 1e3 / st[0]:.4f} "
          f"ms each, tmvopx {tmv:.4f} s = {100 * tmv / wall:.1f}% of the "
          f"wall; max value dist {dmax:.2e}, max residual {rmax:.2e}; "
          f"launches {counts}; card {gpu}", flush=True)
    return counts


def _capi_client(torch, dev, gpu):
    """16c: the unchanged ``native/tests/test_capi.c`` against the port's
    library, a process of its own on the default device."""
    from arpack_ng_tpu_torch import native_bridge, native_capi
    t0 = time.perf_counter()
    exe = native_capi.build_client(native_capi.NATIVE / "tests"
                                   / "test_capi.c")
    t_build = time.perf_counter() - t0
    env = native_capi.client_env()
    if dev.type == "cuda":
        env.pop(native_bridge.DEVICE_ENV, None)
    t0 = time.perf_counter()
    r = subprocess.run([str(exe)], capture_output=True, text=True, env=env,
                       timeout=P16_CLIENT_S)
    wall = time.perf_counter() - t0
    if r.returncode != 0 or "C-ABI OK" not in r.stdout:
        raise AssertionError(f"16c test_capi: rc {r.returncode}\n"
                             f"{(r.stdout + r.stderr)[-3000:]}")
    lines = "; ".join(x for x in r.stdout.strip().splitlines())
    print(f"16c native/tests/test_capi.c (unchanged, its own process, "
          f"device {env.get(native_bridge.DEVICE_ENV, 'cuda')}): rc 0, "
          f"built in {t_build:.2f} s, ran in {wall:.2f} s; {lines}; card "
          f"{gpu}", flush=True)


def capi_paths(torch, dev, gpu, nx=NX, mv_nx=P16_MV_NX):
    """Phase 16: the C ABI (see the module docstring).  Returns the
    in-process paths' launches."""
    import os

    from arpack_ng_tpu_torch import native_bridge, native_capi

    def need(*kernels):
        # a wrapper counts only the kernel launches a card makes
        return kernels if dev.type == "cuda" else ()

    t0 = time.perf_counter()
    saved = os.environ.get(native_bridge.DEVICE_ENV)
    if dev.type == "cpu":
        os.environ[native_bridge.DEVICE_ENV] = "cpu"
    try:
        tb = time.perf_counter()
        lib = native_capi.load()
        print(f"16 {native_capi.library_path().name}: built and loaded "
              f"(ctypes.PyDLL) in {time.perf_counter() - tb:.2f} s; "
              f"atpu_device_count() = {lib.atpu_device_count()}", flush=True)
        paths = {"16a": _capi_csr(torch, dev, gpu, lib, nx, need),
                 "16b": _capi_matvec(torch, dev, gpu, lib, mv_nx, need)}
        _capi_client(torch, dev, gpu)
    finally:
        if dev.type == "cpu":
            if saved is None:
                os.environ.pop(native_bridge.DEVICE_ENV, None)
            else:
                os.environ[native_bridge.DEVICE_ENV] = saved
    elapsed = time.perf_counter() - t0
    print(f"phase 16: {elapsed:.2f} s (limit {P16_MAX_S:.0f} s)", flush=True)
    if elapsed > P16_MAX_S:
        raise AssertionError(f"phase 16 took {elapsed:.1f} s")
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
    tolerance (no cycle exits).  For each reorth variant on the device loop
    (selective, the main path, then dgks): a solve of ``warm`` cycles and
    one of ``warm + steady``; their difference is the wall of ``steady``
    steady cycles (each solve captures its graphs in its first cycles),
    per Lanczos step; then both solves under ``torch.profiler`` (the
    card's busy share over each solve, the largest device items, and the
    steady share: the difference of their device times over the
    difference of the unprofiled walls) and the longer under ``cProfile``.
    Then dgks on the host loop with the host's step (each step's decisions
    read back): the wall per step over ``steady`` cycles after ``warm``,
    then ``profiled`` cycles under each profiler."""
    from unittest import mock

    from torch.profiler import ProfilerActivity, profile

    from arpack_ng_tpu_torch.config import IRAMConfig
    from arpack_ng_tpu_torch.core import device_sym
    from arpack_ng_tpu_torch.core.arnoldi import (Extension, make_extend,
                                                  make_init)
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

    for reorth in ("selective", "dgks"):
        def solve(cycles):
            sync()
            t0 = time.perf_counter()
            res = FusedSymSolver(op, cfg_of(reorth, cycles)).solve()
            sync()
            return res, time.perf_counter() - t0

        solve(warm)
        (r1, w1), (r2, w2) = solve(warm), solve(warm + steady)
        s1, s2 = r1.stats, r2.stats
        steps = s2.nopx - s1.nopx
        wall = w2 - w1
        print(f"profile reorth={reorth} (device loop): {steady} cycles after "
              f"{warm}, {wall * 1e3:.4f} ms, {steps} steps, "
              f"{wall * 1e3 / steps:.4f} ms/step, events (nrorth) "
              f"{s2.nrorth - s1.nrorth}, event rows "
              f"{s2.nrorthr - s1.nrorthr}, nitref {s2.nitref - s1.nitref}, "
              f"host reruns (packets past one per cycle) "
              f"{s2.packets - s2.n_iter - s1.packets + s1.n_iter}; solve of "
              f"{warm + steady} cycles {w2 * 1e3:.4f} ms, graphs captured "
              f"{s2.graphs_captured}, replays {s2.graph_replays}, packets "
              f"{s2.packets}; card {gpu}", flush=True)
        busy = []
        for cycles in (warm, warm + steady):
            with profile(activities=activities) as prof:
                _, wall = solve(cycles)
            busy.append(_profile_table(torch, prof, wall,
                                       f"reorth={reorth}, a solve of "
                                       f"{cycles} cycles", gpu, sort, dev))
        print(f"profile reorth={reorth}, steady: device busy "
              f"{busy[1] - busy[0]:.4f} ms over the {steady} cycles' wall "
              f"{(w2 - w1) * 1e3:.4f} ms (unprofiled): "
              f"{100 * (busy[1] - busy[0]) / ((w2 - w1) * 1e3):.2f}%; card "
              f"{gpu}", flush=True)
        _host_profile(lambda: solve(warm + steady),
                      f"reorth={reorth}, a solve of {warm + steady} cycles")

    cfg = cfg_of("dgks", 10**6)
    with mock.patch.object(device_sym, "make_extend",
                           lambda o, c: Extension(make_extend(o, c).stepwise)):
        head = make_sym_head(op, cfg)
    tail = make_sym_tail(op, cfg)
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
    print(f"profile reorth=dgks (host loop, the host's step): {steady} "
          f"cycles after {warm}, {wall * 1e3:.4f} ms, {steps} steps, "
          f"{wall * 1e3 / steps:.4f} ms/step; card {gpu}", flush=True)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        state = cycles(state, profiled)
        sync()
        wall = time.perf_counter() - t0
    _profile_table(torch, prof, wall, f"reorth=dgks (host loop, the host's "
                   f"step), {profiled} cycles", gpu, sort, dev)
    _host_profile(lambda: (cycles(state, profiled), sync()),
                  f"reorth=dgks (host loop, the host's step), {profiled} "
                  "cycles")


def kernel_entries(rows, launches, errs, phases):
    """The ``kernels`` JSON entries: each kernel at the float32 shape its
    solve runs most (the complex reduced space at complex64; the update of
    the dgks path carries the fused norm),
    with the launches of the path that exercises it and, in
    ``launches_phase10`` to ``launches_phase16``, those of each path of
    phases 10-16 (``phases``: phase -> path -> counts)."""
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
           "realnonsym_cycle": ("realnonsym_cycle.cu",
                                "arpack_ng_tpu/core/device_realnonsym.py:346",
                                "realnonsym_cycle", None, "realnonsym_cycle"),
           "cplx_cycle": ("cplx_cycle.cu",
                          "arpack_ng_tpu/core/device_nonsym.py:202",
                          "cplx_cycle", None, "cplx_cycle"),
           "dia_block": ("dia.cu", ops + "sparse.py:118", "dia_block",
                         P13_JSON_B, "dia_block_matvec"),
           "krylov_test": ("krylov_loop.cu", ops + "solvers.py:58",
                           "krylov_test", None, "krylov_test"),
           "dia_matvec_sub": ("dia.cu", ops + "solvers.py:359",
                              "dia_matvec_sub", None, "dia_matvec_sub"),
           "cg_xr": ("krylov_loop.cu", ops + "solvers.py:65", "cg_xr", None,
                     "cg_xr"),
           "cg_p_test": ("krylov_loop.cu", ops + "solvers.py:70",
                         "cg_p_test", None, "cg_p_test"),
           "bicg_p": ("krylov_loop.cu", ops + "solvers.py:97", "bicg_p",
                      None, "bicg_p"),
           "bicg_s": ("krylov_loop.cu", ops + "solvers.py:101", "bicg_s",
                      None, "bicg_s"),
           "bicg_r": ("krylov_loop.cu", ops + "solvers.py:105", "bicg_r",
                      None, "bicg_r"),
           "bicg_x_test": ("krylov_loop.cu", ops + "solvers.py:106",
                           "bicg_x_test", None, "bicg_x_test")}
    f64 = {"krylov_test", "dia_matvec_sub", "cg_xr", "cg_p_test", "bicg_p",
           "bicg_s", "bicg_r", "bicg_x_test"}
    entries = []
    for kname, (source, replaces, timed, shape, counter) in src.items():
        dt = "torch.complex64" if kname == "cplx_cycle" else \
            "torch.float64" if kname in f64 else "torch.float32"
        r = next(r for r in rows if r["name"] == timed and r["dtype"] == dt
                 and (shape is None or r["shape"] == shape)
                 and r.get("form", "y - Az") == "y - Az")
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
            "shape": f"{timed} shape={r['shape']} {r['dtype'][6:]}",
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
    # a rank of phase 15b-c, started by the script itself
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--ranks", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--sizes", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if args.rank is not None:
        _rank_paths(args.rank, args.ranks, args.port, args.out, args.device,
                    tuple(int(x) for x in args.sizes.split(",")))
        return 0

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
    err_rn, row_rn = check_realnonsym_cycle(torch, dev, gpu)
    rows.append(row_rn)
    errs["realnonsym_cycle"] = err_rn["torch.float32"]
    eigs_cycles(torch, dev, gpu)
    launches_9, vals_9 = eigs_solves(torch, dev, gpu)
    # the real reduced space's main path: 9b, eigs on the stencil operator
    launches["realnonsym_cycle"] = launches_9["realnonsym_cycle"]
    elapsed = time.perf_counter() - t0
    print(f"eigs phase: {elapsed:.2f} s (limit {EIGS_MAX_S:.0f} s)",
          flush=True)
    if elapsed > EIGS_MAX_S:
        raise AssertionError(f"eigs phase took {elapsed:.1f} s")

    phases = {10: new_paths(torch, dev, gpu, vals_9)}
    err_cx, row_cx = check_cplx_cycle(torch, dev, gpu)
    rows.append(row_cx)
    errs["cplx_cycle"] = err_cx["torch.complex64"]
    phases[11] = mode1_paths(torch, dev, gpu)
    # the complex reduced space's main path: 11a, eigs(A_csr, 'fused')
    launches["cplx_cycle"] = phases[11]["11a"]["cplx_cycle"]
    err_kt, row_kt = check_krylov_test(torch, dev, gpu)
    rows.append(row_kt)
    errs["krylov_test"] = err_kt
    err_up, rows_up = check_krylov_updates(torch, dev, gpu, P12_NX ** 2,
                                           P12_BICG_NX ** 2)
    rows += rows_up
    errs.update(err_up)
    phases[12], rows_dia64 = transform_paths(torch, dev, gpu)
    rows += rows_dia64
    errs["dia_matvec_sub"] = 0.0          # bit for bit, or phase 12 raised
    # the loop test's and the update kernels' main paths: 12a, CG
    # shift-invert on the graphs (the sweeps too); 12c for BiCGSTAB
    for k in ("krylov_test", "cg_xr", "cg_p_test", "dia_matvec_sub"):
        launches[k] = phases[12]["12a"][k]
    for k in ("bicg_p", "bicg_s", "bicg_r", "bicg_x_test"):
        launches[k] = phases[12]["12c bicgstab"][k]
    phases[13], err_blk, rows_blk = banded_block_paths(torch, dev, gpu)
    phases[14] = cli_paths(torch, dev, gpu)
    phases[15] = mesh_paths(torch, dev, gpu)
    phases[16] = capi_paths(torch, dev, gpu)
    # the block kernel's main path: 13d(i), the flagship at b = P13_JSON_B
    launches["dia_block_matvec"] = \
        phases[13][f"13d(i) b={P13_JSON_B}"]["dia_block_matvec"]
    errs["dia_block_matvec"] = err_blk["torch.float32"]
    entries = kernel_entries(rows + rows_cgs + rows_dia + rows_ps + rows_g
                             + rows_blk, launches, errs, phases)
    print(f"extensions the host finished, by path (redo: a failed dgks "
          f"refinement or a doubtful event; breakdown: rnorm <= 0): "
          f"{RERUNS}", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

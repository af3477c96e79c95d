// The reduced space of one symmetric restart cycle for NVIDIA Hopper
// (sm_90a), in one launch of one thread block.
//
// Replaces the ops the reference runs on its device for the ncv x ncv
// tridiagonal T of the selective restart loop (dsaup2's reduced work,
// arpack_ng_tpu/core/device_sym.py): jnp.linalg.eigh (:141), dsgets and
// dsconv, the zero-bound removal and nev inflation (:104-149), and the
// exact-shift sweep with accumulated Q (a lax.scan of jnp.linalg.qr,
// :272-288) with its deflation sweep and sign normalization (dsapps).  No
// Pallas kernel did this; PyTorch's torch.linalg.eigh checks its LAPACK info
// on the host (a sync, which a CUDA graph cannot hold), and 24 separate
// 32 x 32 factorizations would be launch latency.
//
// Bound: neither bytes (a few KB) nor flops (~ 3 * np * ncv^3 / 2 for the
// products, about 0.5 MFLOP at ncv = 32) but the length of the dependent
// chains, each step of which waits on the last: the implicit QL (~ncv^2
// Givens rotations, each a dlapy2 and two divisions in double) and, per
// exact shift, the Householder QR of T - mu I (ncv - 1 reflectors, each a
// dlapy2 and two divisions) and the forming of each column of its q
// (dorg2r's order: up to ncv dependent steps).  A double division or
// square root is a software sequence of dependent DFMAs on one thread.
// Every value must keep its bits (the flagship's restart count follows
// them), so the design shortens no chain; it overlaps them:
// * The shifts run as a wavefront across warps, not one after another.
//   Shift s + 1's reflector k reads only d[k..k+1], e[k..k+1] of the T that
//   shift s makes, and shift s makes entry i of that T from the columns i,
//   i + 1 of its q, which need only its reflectors 0..i + 1.  So shift s + 1
//   runs a few positions behind shift s, and SWEEP_PAIRS shifts are in
//   flight, each on three warps that hand over item by item: lane 0 of a
//   reflector warp runs its reflector chain and publishes each reflector at
//   once; a column warp forms each column of q as soon as its reflectors
//   exist, its lanes in step, each on its own column, PASS_STEPS steps per
//   pass, so the columns' chains overlap one another and the reflector
//   chain, and writes q into a matrix of its own (column-major, packed:
//   q is upper Hessenberg); an entry warp forms each entry of the new T
//   (lanes over r, the warp's tree) from that matrix as soon as its two
//   columns exist, and publishes it.  (The reflector chains of several
//   shifts on the lanes of one warp would take turns: they are never ready
//   together.)  Progress crosses warps through
//   words tagged with the shift (a release store; a reader polls with
//   relaxed loads and takes one acquire fence), never a __syncthreads per
//   shift; all warps of the block are resident, so waiting is safe.  The
//   T's live in a ring of SWEEP_PAIRS + 1 slots: a slot is rewritten only by
//   the entry warp that read it last.
// * Q <- Q q, a product no chain waits on, runs on its own QACC_WARPS
//   warps, one shift after another behind the sweep, synchronized among
//   themselves by a named barrier, reading the column warp's q matrix; Q
//   is kept column-major, each Q warp takes whole columns and each lane up
//   to four rows of one at a time, four independent sums that share the
//   loads of q.  A column warp starts a shift once the entry warp and the Q
//   warps are done with its matrix's last one (`qdone`).  At large ncv the
//   Q warps set the sweep's pace (n^3 / 2 products per shift).
// Every value keeps the operations and the order of the sequential sweep
// (the same reflector formulas, q columns, lane-over-r sums and sequential
// Q q) as one shift after another: the output equals that of the kernel
// with a block barrier per shift, which this design replaced, bit for bit
// up to ncv 128 (past it nvcc unrolls the two kernels' entry-sum loops
// differently, and the last bits move).  The QL stays one
// thread's chain: at ncv = 32 it is nearly three quarters of the time.
//
// The QL (thread 0; implicit QL with Wilkinson shifts accumulating only the
// last row of the eigenvectors, as ARPACK's dstqrb) and the parallel head
// (the stable rank sorts of dsgets, dsconv) run before the sweep.  The QR
// follows LAPACK's dgeqr2/dorg2r conventions (dlarfg's beta = -sign(alpha)
// dlapy2(alpha, |x|), tau = (beta - alpha) / beta, x scaled by
// 1 / (alpha - beta)), so Q and the new T agree with numpy's (LAPACK's) QR to
// rounding; the eigenvalues agree with LAPACK's eigensolver to rounding, not
// bit for bit.  The eigensolve and each QR run in double and round their
// results to the compute type, where numpy's float32 eigh and qr (which
// compute in double) round theirs: in float32 throughout, the flagship's
// clustered spectrum converged in half the cycles to values 3e-4 above the
// top of its spectrum (PERF.md, section 6).
//
// The workspace has two parts, which claim shared memory in this order:
// the vectors (in double the QL's and the reflector ring, then the T ring
// and the Ritz vectors), the chains' data; the matrices (the column warps'
// q, packed: q is upper Hessenberg; Q and its product).  Both live in one
// block's shared memory up to ncv 111 in float32, 78 in float64; past that
// the matrices go to a global-memory buffer the caller passes (`work`;
// part_bytes, smem_parts), and past ncv 1018 / 763 the vectors too; the
// progress words stay in shared memory.  (The q matrices in shared memory
// with Q in global memory were slower than both in global memory, which
// leaves the L1 cache more room.)
//
// An extension that stopped short (`brk` not -1: a step that met
// rnorm <= 0, or a doubtful event) leaves everything untouched: the host
// finishes the extension first and calls again.
#include "common.cuh"

#include <cfloat>

namespace atpt {
namespace {

constexpr int SYM_THREADS = 512;
// Shifts in flight, each on three warps, a reflector warp (lane 0), a
// column warp and an entry warp: role r (in that order) of pair p runs shifts
// p, p + SWEEP_PAIRS, ... on warp r SWEEP_PAIRS + (p + r) % SWEEP_PAIRS; the
// remaining QACC_WARPS warps accumulate Q.
constexpr int SWEEP_PAIRS = 4;
constexpr int QACC_WARPS = SYM_THREADS / 32 - 3 * SWEEP_PAIRS;  // Q <- Q q
constexpr int QACC_BARRIER = 1;     // named barrier of the Q warps
constexpr int T_SLOTS = SWEEP_PAIRS + 1;  // the T ring
constexpr int R_SLOTS = 8;          // the reflector ring
constexpr int PASS_STEPS = 4;       // column steps per pass of a column warp's loop
constexpr unsigned FULL = 0xffffffffu;
// ncv-length vectors of A in the workspace: 9 of the head and tail and the
// T ring (d, e per slot)
constexpr int SYM_VECTORS = 9 + 2 * T_SLOTS;
// ... and of double: the QL's three, the reflector ring (tau, v1 per slot)
constexpr int SYM_DVECTORS = 3 + 2 * R_SLOTS;
// shared memory a block may use, less room for the static words
constexpr int SYM_MAX_SMEM = 232448 - 256;
constexpr int SYM_PARTS = 2;        // the workspace's parts (part_bytes)
constexpr int SYM_QL_ITERS = 30;     // QL iterations allowed per eigenvalue
// Phase stamps (clock64(), when the caller passes a buffer): thread 0's at
// entry, after the QL, after dsgets/dsconv (the head), after the shift
// sweep, exit (a cycle that exits early stamps its exit in every later
// slot); then, for each shift s < ncv, its start and its last reflector
// (reflector warp), its last entry (entry warp), and the end of Q q_s (Q
// warps): SYM_CLOCKS + 4 ncv in all.
constexpr int SYM_CLOCKS = 5;
enum { C_ENTRY = 0, C_QL, C_HEAD, C_SWEEP, C_EXIT };

// dsgets' selectors
enum { LA = 0, SA = 1, LM = 2, SM = 3, BE = 4 };

// The packet the host reads once per cycle (ops/cuda_sym_cycle.py), float64:
// DONE, NCONV, NEV, NP, INFO, BRK, FORCE, RNORM, 4 counters, then a, b,
// the which-sorted Ritz values and their bounds (ncv each).
enum { P_DONE = 0, P_NCONV, P_NEV, P_NP, P_INFO, P_BRK, P_FORCE, P_RNORM, P_CNT, P_HEAD = 12 };

struct SymArgs {
  int ncv, nev0, which, inflate, is_last;
  double tol, eps23, eps_m;
  void* a;          // (ncv,) diagonal of T; the new one after the shifts
  void* b;          // (ncv,) b[i] couples i and i + 1 (i < ncv - 1)
  const void* rnorm;
  const int* brk;   // first step with rnorm <= 0, -2 after a doubtful event, or -1
  const int* force;
  const long long* cnt;
  void* Q;          // (ncv, ncv) row-major: the accumulated shifts' Q
  void* sk;         // (2,): sigmak, betak
  double* packet;
  void* work;       // the parts of the workspace past smem_parts, or NULL
  long long* clk;   // NULL, or SYM_CLOCKS + 4 ncv clock64() stamps (C_* above)
  int smem_parts;   // the parts of the workspace in shared memory
};

// Offset of column c in a packed q (column-major, column c rows 0..min(c +
// 3, n - 1): q's nonzeros end at row c + 1, and the entry sums read two
// zeros past them); q_off(n, n) is the packed size.
__host__ __device__ __forceinline__ int q_off(int c, int n) {
  const int k0 = n > 4 ? n - 4 : 0;
  return c <= k0 ? c * (c + 7) / 2 : k0 * (k0 + 7) / 2 + (c - k0) * n;
}

// Bytes of the workspace's parts: 0 the vectors (SYM_DVECTORS doubles, then
// SYM_VECTORS of A, ncv each), 1 the matrices (the column warps' packed q,
// then Q and its product, ncv x ncv each, column-major).
__host__ __device__ __forceinline__ long long part_bytes(int part, int n, int itemsize) {
  const long long nn = n;
  if (part == 0) return SYM_DVECTORS * nn * 8 + SYM_VECTORS * nn * itemsize;
  return (SWEEP_PAIRS * static_cast<long long>(q_off(n, n)) + 2 * nn * nn) * itemsize;
}

// The parts that fit in shared memory, claimed in order.
inline int smem_parts(int n, int itemsize) {
  long long used = 0;
  int k = 0;
  while (k < SYM_PARTS && used + part_bytes(k, n, itemsize) <= SYM_MAX_SMEM)
    used += part_bytes(k++, n, itemsize);
  return k;
}

// The Q warps' barrier (QACC_WARPS * 32 threads), apart from __syncthreads.
__device__ __forceinline__ void qacc_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(QACC_BARRIER), "n"(QACC_WARPS * 32) : "memory");
}

__device__ double lapy2(double x, double y) {
  const double xa = fabs(x), ya = fabs(y);
  const double w = fmax(xa, ya), z = fmin(xa, ya);
  if (z == 0.0) return w;
  const double t = z / w;
  return w * sqrt(1.0 + t * t);
}

template <typename A>
__device__ A which_key(int which, A v) {
  switch (which) {
    case SA: return -v;
    case LM: return fabs(v);
    case SM: return -fabs(v);
    default: return v;
  }
}

// Position of key[i] in a stable ascending sort of key[0..n).
template <typename A>
__device__ int stable_rank(const A* key, int n, int i) {
  const A k = key[i];
  int r = 0;
  for (int j = 0; j < n; ++j) r += (key[j] < k) || (key[j] == k && j < i);
  return r;
}

// dsgets' 'BE' arrangement over the ascending order: [unwanted middle, low
// half, high half], the low half nev / 2.
__device__ int be_src(int i, int ncv, int nev) {
  const int lo = nev / 2, hi = nev - lo, np = ncv - nev;
  return i < np ? lo + i : (i < np + lo ? i - np : (ncv - hi) + (i - np - lo));
}

// Implicit QL with Wilkinson shifts on the tridiagonal (d, e), e[i] coupling
// i and i + 1, in double; z is the last row of the eigenvector matrix (the
// identity at entry).  On return d holds the eigenvalues (unsorted).  False
// if an eigenvalue took more than SYM_QL_ITERS iterations.  The three never
// overlap (__restrict__: the compiler may read ahead across the stores).
__device__ bool tridiag_ql(double* __restrict__ d, double* __restrict__ e,
                           double* __restrict__ z, int n, double eps) {
  e[n - 1] = 0.0;
  for (int l = 0; l < n; ++l) {
    int iter = 0, m;
    do {
      for (m = l; m < n - 1; ++m)
        if (fabs(e[m]) <= eps * (fabs(d[m]) + fabs(d[m + 1]))) break;
      if (m == l) break;
      if (iter++ == SYM_QL_ITERS) return false;
      double g = (d[l + 1] - d[l]) / (2.0 * e[l]);
      double r = lapy2(g, 1.0);
      g = d[m] - d[l] + e[l] / (g + copysign(r, g));
      double s = 1.0, c = 1.0, p = 0.0;
      int i;
      for (i = m - 1; i >= l; --i) {
        const double f = s * e[i], bb = c * e[i];
        r = lapy2(f, g);
        e[i + 1] = r;
        if (r == 0.0) {
          d[i + 1] -= p;
          e[m] = 0.0;
          break;
        }
        s = f / r;
        c = g / r;
        g = d[i + 1] - p;
        r = (d[i] - g) * s + 2.0 * c * bb;
        p = s * r;
        d[i + 1] = g + p;
        g = c * r - bb;
        const double zf = z[i + 1];
        z[i + 1] = s * z[i] + c * zf;
        z[i] = c * z[i] - s * zf;
      }
      if (r == 0.0 && i >= l) continue;
      d[l] -= p;
      e[l] = g;
      e[m] = 0.0;
    } while (true);
  }
  return true;
}

// The Householder QR of T - mu I (T = tridiag(d, e)) by LAPACK's dgeqr2,
// one reflector per step: reflector k is I - tau[k] v v^T with v = (1,
// v1[k]) on rows k, k + 1.  T - mu I is formed in A, as numpy forms it; the
// QR runs in double.  Row k of the partly reduced matrix holds two entries
// right of the diagonal that later columns read (r0, r1: set by qr_start,
// carried from step to step); every other entry a reflector meets is an
// original one or zero.  Step k reads d[k + 1], e[k] and e[k + 1].
template <typename A>
__device__ __forceinline__ void qr_start(const A* d, const A* e, A mu, int n, double& r0,
                                         double& r1) {
  r0 = static_cast<double>(static_cast<A>(d[0] - mu));
  r1 = n > 1 ? static_cast<double>(e[0]) : 0.0;
}

template <typename A>
__device__ __forceinline__ void qr_step(const A* __restrict__ d, const A* __restrict__ e, A mu,
                                        int n, int k, double& r0, double& r1,
                                        double* __restrict__ tau, double* __restrict__ v1) {
  const double alpha = r0, x = e[k];
  double m1 = static_cast<double>(static_cast<A>(d[k + 1] - mu));
  double e1 = k + 2 < n ? static_cast<double>(e[k + 1]) : 0.0;
  if (x == 0.0) {
    tau[k] = 0.0;
    v1[k] = 0.0;
  } else {
    const double beta = -copysign(lapy2(alpha, x), alpha);
    const double t = (beta - alpha) / beta;
    const double v = x * (1.0 / (alpha - beta));
    tau[k] = t;
    v1[k] = v;
    const double w = r1 + m1 * v;  // column k + 1 (dlarf: w = A^T v, A -= tau v w^T)
    m1 = m1 + v * (-t * w);
    if (k + 2 < n) {  // column k + 2: row k is zero there
      const double w2 = e1 * v;
      e1 = e1 + v * (-t * w2);
    }
  }
  r0 = m1;
  r1 = e1;
}

// This lane's part of entry (row, col) of (q^T T) q, |row - col| <= 1:
// sum_r M[row][r] q[r][col] with M = q^T T over r = lane, lane + 32, ...
// (the warp's tree adds the lanes' parts).  qr, qc: columns row and col of
// q.  Terms past r = last meet only q's structural zeros (a column c ends at
// row c + 1), so the lanes stop there: the sum is that over every r, and
// T's entries past last, which the shift before may not have published
// yet, are never read.
template <typename A>
__device__ __forceinline__ A diag_part(const A* qr, const A* qc, const A* d, const A* e, int n,
                                       int last, int lane) {
  A acc = A(0);
  for (int r = lane; r <= last; r += 32) {
    A m = qr[r] * d[r];
    if (r > 0) m = qr[r - 1] * e[r - 1] + m;
    if (r < n - 1) m = m + qr[r + 1] * e[r];
    acc += m * qc[r];
  }
  return acc;
}

// The reflector chain of exact shift s, on lane 0 of its reflector warp:
// reflector k as soon as the entry warp of shift s - 1 has published entries
// 0..k + 1 of this shift's T, each published at once (rprog, tagged with the
// shift).  The slot's last reader, the column warp of shift s - R_SLOTS, is
// done: this warp finished shift s - SWEEP_PAIRS, whose last reflector
// waited for every shift before s - SWEEP_PAIRS to finish its T.
template <typename A>
__device__ void reflect_shift(int s, int n, A mu, const A* Tr, const int* tready, double* refl,
                              int* rprog, long long* trace) {
  const A* d = Tr + (s % T_SLOTS) * 2 * n;
  const A* e = d + n;
  const int* in_word = tready + s % T_SLOTS;
  int* out_word = rprog + s % R_SLOTS;
  const int tag = s * (n + 1);
  double* tau = refl + (s % R_SLOTS) * 2 * n;
  double* v1 = tau + n;
  if (trace != nullptr) trace[0] = clock64();
  double r0 = 0.0, r1 = 0.0;
  int avail = 0;  // entries of this shift's T known to be published
  for (int k = 0; k < n - 1; ++k) {
    if (avail < k + 2) avail = wait_geq(in_word, tag + k + 2) - tag;
    if (k == 0) qr_start(d, e, mu, n, r0, r1);
    qr_step(d, e, mu, n, k, r0, r1, tau, v1);
    st_release(out_word, tag + k + 1);
  }
  if (trace != nullptr) trace[1] = clock64();
}

// The q columns of exact shift s, on its column warp.  Column c of
// q = H_0 H_1 ... H_{n-2} is formed in dorg2r's order (reflectors last to
// first on e_c, in double, rounded to A): reflector i touches rows i and
// i + 1 only, so row i + 1 is final once it has run, and one pair of values
// is carried down the column; it needs reflectors 0..min(c, n - 2).  Lane l
// forms the columns l, l + 32, ..., PASS_STEPS steps per pass of the loop
// (which share its polls and votes), the lanes in step: a column starts as
// soon as its reflectors exist, and columns finish in order.  Column c goes
// to column c of the warp's packed q matrix (qm; its two rows past c + 1,
// q's structural zeros, stay the zeros the kernel wrote at its start); the
// count done is published (cdone, tagged with the shift) for the entry warp
// and the Q warps.
template <typename A>
__device__ void column_shift(int s, int n, const int* tready, const double* refl,
                             const int* rprog, int* cdone, const int* qdone, A* qm, int lane) {
  const int tag = s * (n + 1);
  const int* ref_word = rprog + s % R_SLOTS;
  const double* tau = refl + (s % R_SLOTS) * 2 * n;
  const double* v1 = tau + n;
  if (lane == 0) {
    if (s >= SWEEP_PAIRS)  // the entry warp is done with the last shift's columns
      wait_geq(tready + (s + 1 - SWEEP_PAIRS) % T_SLOTS, (s + 1 - SWEEP_PAIRS) * (n + 1) + n);
    wait_geq(qdone, s + 1 - SWEEP_PAIRS);  // the Q warps are done with qm's last shift
  }
  __syncwarp();
  int col = lane, i = -1, nref = 0, done = 0;
  double cur = 0.0, carry = 0.0, ti = 0.0, vi = 0.0;  // ti, vi: tau[i], v1[i], read ahead
  while (done < n) {
    // poll the reflectors only while a lane waits for one
    if (__any_sync(FULL, i < 0 && col < n && nref <= min(col, n - 2)))
      nref = warp_poll(ref_word, tag + nref, lane) - tag;
    if (i < 0 && col < n && nref > min(col, n - 2)) {
      i = min(col, n - 2);
      cur = col <= n - 2 ? 1.0 : 0.0;
      carry = col <= n - 2 ? 0.0 : 1.0;
      ti = tau[i];
      vi = v1[i];
    }
    bool fin = false;
    A* qc = qm + q_off(col, n);
#pragma unroll
    for (int step = 0; step < PASS_STEPS; ++step) {
      if (i >= 0) {  // one step down column col
        if (ti != 0.0) {
          const double w = cur + carry * vi;
          const double t = -ti * w;
          cur = cur + t;
          carry = carry + vi * t;
        }
        qc[i + 1] = static_cast<A>(carry);
        carry = cur;
        cur = 0.0;
        if (--i < 0) {
          qc[0] = static_cast<A>(carry);
          fin = true;
          col += 32;
        } else {
          ti = tau[i];
          vi = v1[i];
        }
      }
    }
    const int nd = __popc(__ballot_sync(FULL, fin));
    if (nd > 0) {
      done += nd;
      __syncwarp();  // the columns' writes before the count
      if (lane == 0) st_release(cdone, tag + done);
    }
  }
}

// The new T of exact shift s, on its entry warp: entry i (the
// diagonals (i, i), (i, i + 1), (i + 1, i), symmetrized) as soon as columns
// i and i + 1 of q (qm, packed) are done, published at once (tready,
// tagged with the shift).
template <typename A>
__device__ void entry_shift(int s, int n, A* Tr, int* tready, const int* cdone, const A* qm,
                            int lane, long long* trace) {
  const A* d = Tr + (s % T_SLOTS) * 2 * n;
  const A* e = d + n;
  A* dn = Tr + ((s + 1) % T_SLOTS) * 2 * n;
  A* en = dn + n;
  int* out_word = tready + (s + 1) % T_SLOTS;
  const int tag = s * (n + 1), out0 = (s + 1) * (n + 1);
  int done = 0;
  for (int i = 0; i < n; ++i) {
    if (done < min(i + 2, n)) {
      int v = lane == 0 ? wait_geq(cdone, tag + min(i + 2, n)) : 0;
      done = __shfl_sync(FULL, v, 0) - tag;
      __syncwarp();
    }
    const int last = min(i + 2, n - 1);  // columns i and i + 1 end at rows i + 1, i + 2
    const A* qi = qm + q_off(i, n);
    const A* qj = qm + q_off(i + 1, n);
    A vd = diag_part(qi, qi, d, e, n, last, lane), vu = A(0), vl = A(0);
    if (i < n - 1) {
      vu = diag_part(qi, qj, d, e, n, last, lane);
      vl = diag_part(qj, qi, d, e, n, last, lane);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {  // three warp_sum trees, interleaved
      vd += __shfl_down_sync(FULL, vd, off);
      vu += __shfl_down_sync(FULL, vu, off);
      vl += __shfl_down_sync(FULL, vl, off);
    }
    if (lane == 0) {
      dn[i] = vd;
      en[i] = i < n - 1 ? A(0.5) * (vu + vl) : A(0);  // symmetrized
      st_release(out_word, out0 + i + 1);
    }
  }
  if (trace != nullptr && lane == 0) trace[3 * s + 2] = clock64();
  __syncwarp();
}

// Q <- Q q_s for s = 0..np - 1 on the Q warps (thread t of nq), ping-pong
// between Q and W (the product ends in W for an odd np), as soon as shift
// s's column warp has written all of q_s into its matrix (qs + (s %
// SWEEP_PAIRS) q_off(n, n), packed; its cdone word).  Q and W are
// column-major, entry (r, c) at [c n + r]; warp w of the Q warps takes the
// columns c = w, w + nq / 32, ..., lane l the rows l, l + 32, l + 64, l + 96
// at once (then l + 128, ...), each row's sum in order over j.
template <typename A>
__device__ void accumulate_q(int np, int n, A* Q, A* W, const A* qs, const int* cdone,
                             int* qdone, int t, int nq, long long* trace) {
  for (int s = 0; s < np; ++s) {
    const A* q = qs + (s % SWEEP_PAIRS) * q_off(n, n);
    if (t == 0) wait_geq(cdone + s % SWEEP_PAIRS, s * (n + 1) + n);
    qacc_sync();
    // q is upper Hessenberg: column c has rows 0..c + 1
    for (int c = t >> 5; c < n; c += nq >> 5) {
      const A* qc = q + q_off(c, n);
      const int jn = min(c + 1, n - 1);
      for (int r = t & 31; r < n; r += 128) {
        const bool h1 = r + 32 < n, h2 = r + 64 < n, h3 = r + 96 < n;
        A acc0 = A(0), acc1 = A(0), acc2 = A(0), acc3 = A(0);
        for (int j = 0; j <= jn; ++j) {
          const A qv = qc[j];
          const A* Qj = Q + j * n + r;
          acc0 += Qj[0] * qv;
          if (h1) acc1 += Qj[32] * qv;
          if (h2) acc2 += Qj[64] * qv;
          if (h3) acc3 += Qj[96] * qv;
        }
        A* Wc = W + c * n + r;
        Wc[0] = acc0;
        if (h1) Wc[32] = acc1;
        if (h2) Wc[64] = acc2;
        if (h3) Wc[96] = acc3;
      }
    }
    qacc_sync();
    if (t == 0) st_release(qdone, s + 1);  // q_s's buffer is free
    if (trace != nullptr && t == 0) trace[s] = clock64();
    A* swap = Q;
    Q = W;
    W = swap;
  }
}

// GMEM: the parts of the workspace past g.smem_parts are in g.work (global
// memory), else both are in dynamic shared memory.
template <typename A, bool GMEM>
__global__ void __launch_bounds__(SYM_THREADS, 1) sym_cycle_kernel(SymArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = g.ncv, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // each part in shared memory after the parts before it, or in g.work after
  // the parts before it that are there too
  const int ks = GMEM ? g.smem_parts : SYM_PARTS;
  const long long b0 = part_bytes(0, n, sizeof(A));
  unsigned char* gw = static_cast<unsigned char*>(g.work);
  unsigned char* p0 = ks > 0 ? smem_raw : gw;
  unsigned char* p1 = ks > 1 ? smem_raw + b0 : gw + (ks > 0 ? 0 : b0);
  // part 0: double vectors first (8-byte aligned), then the A vectors
  double* dv = reinterpret_cast<double*>(p0);
  double *ev = dv, *ew = dv + n, *z = dv + 2 * n, *refl = dv + 3 * n;
  A* Tr = reinterpret_cast<A*>(dv + SYM_DVECTORS * n);  // the T ring: slot j holds d, then e
  A* v = Tr + T_SLOTS * 2 * n;
  A* qs = reinterpret_cast<A*>(p1);  // part 1: a packed q matrix per column warp,
  A* Q = qs + SWEEP_PAIRS * q_off(n, n);  // then Q and W, column-major
  A* W = Q + n * n;
  A *evs = v, *bnd = v + n, *rs = v + 2 * n, *bs = v + 3 * n, *rsi = v + 4 * n;
  A *bsi = v + 5 * n, *sh = v + 6 * n, *key = v + 7 * n, *sgn = v + 8 * n;
  A *dc = Tr, *ec = Tr + n;  // the cycle's T: ring slot 0
  __shared__ int s_brk, s_nconv, s_nev, s_np, s_done, s_info;
  __shared__ int s_tready[T_SLOTS], s_rprog[R_SLOTS], s_cdone[SWEEP_PAIRS], s_qdone;
  A* a = static_cast<A*>(g.a);
  A* b = static_cast<A*>(g.b);
  double* pk = g.packet;
  const A rnorm = *static_cast<const A*>(g.rnorm);
  const int np0 = n - g.nev0;
  // stamp phase `from` and every later one (the exit overwrites the rest)
  auto stamp = [&](int from) {
    if (g.clk != nullptr && tid == 0) {
      const long long t = clock64();
      for (int i = from; i < SYM_CLOCKS; ++i) g.clk[i] = t;
    }
  };
  stamp(C_ENTRY);

  if (tid == 0) {
    s_brk = *g.brk;
    pk[P_BRK] = s_brk;
    pk[P_FORCE] = *g.force;
    pk[P_RNORM] = static_cast<double>(rnorm);
    for (int i = 0; i < 4; ++i) pk[P_CNT + i] = static_cast<double>(g.cnt[i]);
  }
  __syncthreads();
  if (s_brk != -1) {
    stamp(C_QL);
    return;
  }

  // ---- dseigt: eigenvalues and last eigenvector components of T, in
  // double, rounded to A (numpy's eigh of an A matrix runs in double) ----
  for (int i = tid; i < n; i += SYM_THREADS) {
    dc[i] = a[i];
    ec[i] = i < n - 1 ? b[i] : A(0);
    ev[i] = static_cast<double>(dc[i]);
    ew[i] = static_cast<double>(ec[i]);
    z[i] = i == n - 1 ? 1.0 : 0.0;
  }
  __syncthreads();
  if (tid == 0) s_info = tridiag_ql(ev, ew, z, n, DBL_EPSILON) ? 0 : -8;
  __syncthreads();
  stamp(C_QL);
  // ascending, as LAPACK returns them; bounds |rnorm * S[ncv-1, :]| in A
  for (int i = tid; i < n; i += SYM_THREADS) {
    const int r = stable_rank(ev, n, i);
    evs[r] = static_cast<A>(ev[i]);
    bnd[r] = fabs(rnorm * static_cast<A>(z[i]));
  }
  __syncthreads();
  // ---- dsgets: wanted last ----
  if (g.which == BE) {
    for (int i = tid; i < n; i += SYM_THREADS) {
      rs[i] = evs[be_src(i, n, g.nev0)];
      bs[i] = bnd[be_src(i, n, g.nev0)];
    }
  } else {
    for (int i = tid; i < n; i += SYM_THREADS) key[i] = which_key(g.which, evs[i]);
    __syncthreads();
    for (int i = tid; i < n; i += SYM_THREADS) {
      const int r = stable_rank(key, n, i);
      rs[r] = evs[i];
      bs[r] = bnd[i];
    }
  }
  __syncthreads();
  // ---- dsconv, zero-bound removal, nev inflation ----
  if (tid == 0) {
    const A tol = static_cast<A>(g.tol), eps23 = static_cast<A>(g.eps23);
    int nconv = 0, nz = 0;
    for (int i = np0; i < n; ++i) nconv += bs[i] <= tol * fmax(eps23, fabs(rs[i]));
    for (int i = 0; i < np0; ++i) nz += bs[i] == A(0);
    int np_eff = np0 - nz, nev_eff = g.nev0 + nz;
    const int done = nconv >= g.nev0 || np_eff == 0;
    if (g.inflate) {
      int nev_inf = nev_eff + min(nconv, np_eff / 2);
      if (nev_inf == 1 && n >= 6) {
        nev_inf = n / 2;
      } else if (nev_inf == 1 && n > 3) {
        nev_inf = 2;
      }
      nev_eff = min(nev_inf, n - 1);
      np_eff = n - nev_eff;
    }
    s_nconv = nconv;
    s_nev = nev_eff;
    s_np = np_eff;
    s_done = done;
    pk[P_DONE] = done;
    pk[P_NCONV] = nconv;
    pk[P_NEV] = nev_eff;
    pk[P_NP] = np_eff;
    pk[P_INFO] = s_info;
  }
  __syncthreads();
  stamp(C_HEAD);
  const int nev_eff = s_nev, np_eff = s_np;
  for (int i = tid; i < n; i += SYM_THREADS) {
    pk[P_HEAD + 2 * n + i] = static_cast<double>(rs[i]);
    pk[P_HEAD + 3 * n + i] = static_cast<double>(bs[i]);
    if (g.which == BE) {  // the BE split moves with the inflated nev
      rsi[i] = evs[be_src(i, n, nev_eff)];
      bsi[i] = bnd[be_src(i, n, nev_eff)];
    } else {
      rsi[i] = rs[i];
      bsi[i] = bs[i];
    }
  }
  if (s_done || g.is_last || s_info != 0) {  // exit before dsapps
    for (int i = tid; i < n; i += SYM_THREADS) {
      pk[P_HEAD + i] = static_cast<double>(dc[i]);
      pk[P_HEAD + n + i] = i < n - 1 ? static_cast<double>(ec[i]) : static_cast<double>(rnorm);
    }
    stamp(C_SWEEP);
    return;
  }
  __syncthreads();
  // ---- exact shifts: the np_eff least wanted, largest bound first ----
  for (int i = tid; i < np0; i += SYM_THREADS)
    key[i] = i < np_eff ? -fabs(bsi[i]) : static_cast<A>(INFINITY);
  for (int i = tid; i < n * n; i += SYM_THREADS) Q[i] = (i / n == i % n) ? A(1) : A(0);
  for (int i = tid; i < SWEEP_PAIRS * q_off(n, n); i += SYM_THREADS) qs[i] = A(0);
  for (int i = tid; i < T_SLOTS; i += SYM_THREADS) s_tready[i] = i == 0 ? n : -1;  // T_0: all n
  for (int i = tid; i < R_SLOTS; i += SYM_THREADS) s_rprog[i] = 0;
  for (int i = tid; i < SWEEP_PAIRS; i += SYM_THREADS) s_cdone[i] = 0;
  if (tid == 0) s_qdone = 0;
  __syncthreads();
  for (int i = tid; i < np0; i += SYM_THREADS) sh[stable_rank(key, np0, i)] = rsi[i];
  __syncthreads();
  long long* trace = g.clk == nullptr ? nullptr : g.clk + SYM_CLOCKS;
  if (warp < 3 * SWEEP_PAIRS) {
    // warp w runs on scheduler w % 4: a shift's three warps go to three
    // different schedulers (role r of shift p on warp r SWEEP_PAIRS + (p + r) %
    // SWEEP_PAIRS), so its chains do not share an issue slot
    const int role = warp / SWEEP_PAIRS, p = (warp - role) % SWEEP_PAIRS;
    A* qm = qs + p * q_off(n, n);
    for (int s = p; s < np_eff; s += SWEEP_PAIRS) {
      if (role == 0) {
        if (lane == 0)
          reflect_shift(s, n, sh[s], Tr, s_tready, refl, s_rprog,
                        trace == nullptr ? nullptr : trace + 3 * s);
      } else if (role == 1) {
        column_shift(s, n, s_tready, refl, s_rprog, s_cdone + p, &s_qdone, qm, lane);
      } else {
        entry_shift(s, n, Tr, s_tready, s_cdone + p, qm, lane, trace);
      }
    }
  } else {
    accumulate_q(np_eff, n, Q, W, qs, s_cdone, &s_qdone, tid - 3 * SWEEP_PAIRS * 32,
                 QACC_WARPS * 32, trace == nullptr ? nullptr : trace + 3 * n);
  }
  __syncthreads();
  const A* Qf = np_eff & 1 ? W : Q;
  dc = Tr + (np_eff % T_SLOTS) * 2 * n;
  ec = dc + n;
  stamp(C_SWEEP);
  // ---- deflation sweep, subdiagonal sign normalization (dsapps) ----
  if (tid == 0) {
    const A eps_m = static_cast<A>(g.eps_m);
    A phi = A(1);
    sgn[0] = phi;  // the diagonal similarity's signs
    for (int i = 0; i < n - 1; ++i) {
      const A big = fabs(dc[i]) + fabs(dc[i + 1]);
      if (fabs(ec[i]) <= eps_m * big) ec[i] = A(0);
      phi *= ec[i] >= A(0) ? A(1) : A(-1);
      sgn[i + 1] = phi;
      ec[i] = fabs(ec[i]);
    }
  }
  __syncthreads();
  A* Qg = static_cast<A*>(g.Q);
  for (int k = tid; k < n * n; k += SYM_THREADS) {  // Qf column-major, Qg row-major
    const int c = k / n, r = k % n;
    Qg[r * n + c] = Qf[k] * sgn[c];
  }
  for (int i = tid; i < n; i += SYM_THREADS) {
    a[i] = dc[i];
    if (i < n - 1) b[i] = ec[i];
    pk[P_HEAD + i] = static_cast<double>(dc[i]);
    pk[P_HEAD + n + i] = i < n - 1 ? static_cast<double>(ec[i]) : static_cast<double>(rnorm);
  }
  if (tid == 0) {
    A* sk = static_cast<A*>(g.sk);
    sk[0] = Qf[(nev_eff - 1) * n + n - 1] * sgn[nev_eff - 1];
    sk[1] = nev_eff < n ? ec[nev_eff - 1] : A(0);
  }
  stamp(C_EXIT);
}

// The parts of the workspace that fit in shared memory go there; the rest
// go to g.work, which the caller passes (8-byte aligned, the bytes of the
// parts past smem_parts) where they do not all fit.
template <typename A>
int sym_cycle_typed(SymArgs g, cudaStream_t st) {
  if (g.ncv < 2 || g.nev0 < 1 || g.nev0 >= g.ncv || g.which < LA || g.which > BE)
    return static_cast<int>(cudaErrorInvalidValue);
  g.smem_parts = smem_parts(g.ncv, sizeof(A));
  long long bytes = 0;
  for (int p = 0; p < g.smem_parts; ++p) bytes += part_bytes(p, g.ncv, sizeof(A));
  const bool gmem = g.smem_parts < SYM_PARTS;
  if (gmem && (g.work == nullptr || (reinterpret_cast<uintptr_t>(g.work) & 7u) != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = gmem ? sym_cycle_kernel<A, true> : sym_cycle_kernel<A, false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<1, SYM_THREADS, static_cast<size_t>(bytes), st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace atpt

extern "C" {

// One cycle's reduced space (see the head note).  code 0: float, 2: double
// (the dtype codes of common.cuh); which: 0 LA, 1 SA, 2 LM, 3 SM, 4 BE.
// `work`: NULL where the whole workspace fits in shared memory, else a
// global buffer for the parts that do not (part_bytes, smem_parts).
// `clocks`: NULL (the solver's call), or 5 + 4 ncv int64 for the stamps
// (SYM_CLOCKS).
int atpt_sym_cycle(int code, int ncv, int nev0, int which, int inflate, int is_last,
                   double tol, double eps23, double eps_m, void* a, void* b, const void* rnorm,
                   const void* brk, const void* force, const void* cnt, void* Q, void* sk,
                   void* packet, void* work, void* clocks, void* stream) {
  const atpt::SymArgs g{ncv, nev0, which, inflate, is_last, tol, eps23, eps_m, a, b, rnorm,
                        static_cast<const int*>(brk), static_cast<const int*>(force),
                        static_cast<const long long*>(cnt), Q, sk, static_cast<double*>(packet),
                        work, static_cast<long long*>(clocks), 0};
  auto st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0: return atpt::sym_cycle_typed<float>(g, st);
    case 2: return atpt::sym_cycle_typed<double>(g, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

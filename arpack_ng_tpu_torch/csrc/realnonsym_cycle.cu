// The reduced space of one real non-symmetric restart cycle for NVIDIA
// Hopper (sm_90a), in one launch of one thread block.
//
// Replaces the ops the reference runs on its device for the ncv x ncv
// Hessenberg H of the dgks Arnoldi loop (dnaup2's reduced work,
// arpack_ng_tpu/core/device_realnonsym.py:346-508): the real Schur form by
// explicit Wilkinson and double-shift QR sweeps (make_real_schur, :115), the
// block eigenvalues (:172), dtrevc's back-substitution in (re, im) pair
// arithmetic for the Ritz bounds (make_real_last_components, :201), dngets'
// which-sort with conjugate pairs adjacent and its straddle rule, dnconv, the
// zero-bound removal, nev inflation and the straddle re-check (:377-432), and
// dnapps' explicit chase with accumulated Q (a lax.scan of jnp.linalg.qr,
// :434-480).  No Pallas kernel did this; PyTorch's torch.linalg.eigvals and
// qr check their LAPACK info on the host (a sync), and each cycle would be
// some hundred launches of 32 x 32 factorizations.  The port repairs one
// fault of the reference: where the explicit chase lost the Hessenberg form
// in the columns the restart keeps (max |(Q^T H0 Q - Hc)[:, :nev_eff]| >
// eps23 max |H0|), the shifts are applied again by dnapps' implicit bulge
// chases (Householder reflectors of order 2 or 3).
//
// H is the Arnoldi Hessenberg (every caller's is upper Hessenberg: the
// extension writes rows 0..j + 1 of column j, the restart triu(Hc, -1)); the
// QR steps read nothing below its first subdiagonal.
//
// Bound: neither bytes (a few KB in and out) nor the card's flops, but one
// SM and the length of the dependent chains.  The Schur form takes about two
// explicit QR steps per Ritz value and the chase one per shift (51 and 13 at
// ncv = 32), each the Householder QR of a shifted Hessenberg (dgeqr2, in
// LAPACK's conventions: beta = -sign(alpha) dlapy2(alpha, |x|), tau = (beta -
// alpha) / beta, x scaled by 1 / (alpha - beta)), its q (dorg2r's backward
// accumulation) and the similarity triu(q^T T q, -1).  Reflector j waits on
// reflector j - 1's update of column j: a square root, a dlapy2 and two
// double divisions in sequence, ~30 reflectors a step.  That chain sets the
// pace; the design overlaps the rest of the step with it and keeps every
// value's bits (the restart count of the solve follows them):
// * The factorization runs on warp 0 with no block barrier: every lane forms
//   reflector j itself from column j (the same values on each, no
//   broadcast), keeps x scaled in registers and applies the reflector to its
//   own column right of it, preloaded; __syncwarp between reflectors, and
//   each reflector published to the other warps as soon as it exists.
// * q on warp 1, a lane per column: column c meets reflectors c, c - 1, ...,
//   0 and no other column, so it starts once reflector c is published, its
//   rows j + 1, j + 2 carried in registers.
// * Column c of W = T q and of the new T, triu(q^T W, -1), on the other six
//   warps in turn, as soon as q's columns up to c + 1 are done; one block
//   barrier ends the step.  The next step's deflation and shift read the
//   bottom of the new T, so steps do not overlap.
// * The shifted matrix and the products over their nonzero terms only (T's
//   lower band, each column of q past its last nonzero row); only Q's last
//   row in the Schur sweeps (dtrevc reads no other row of the Schur
//   vectors), the chase's Q q after the step; the guard on the kept columns
//   only.  Each entry keeps its ascending sum; the terms left out are exact
//   zeros, which add nothing to a sum that starts at +0.
// * dtrevc a thread per eigenvalue, its vector a column of the scratch (the
//   lanes of a warp on neighbouring words).
// * Where nvcc's FMA contraction of a plain expression depends on the code
//   around it, the operation is written out (__fma_rn, __dmul_rn, __dadd_rn,
//   __dsub_rn) as the first design's build contracted it; without that the
//   implicit redo, whose source is unchanged, moved in its last bits.
// Its outputs (H, Q, sk, the whole packet) equal, bit for bit, those of the
// first design it replaced (a block barrier per reflector and per column of
// q, three dense products a step): tools/realnonsym_cycle_compare.py holds
// two commits' kernels side by side.  The chase's shifts still run one after
// another, and the implicit redo keeps the first design's dense form.
//
// Precision: every value is computed in double and the results are rounded to
// the problem's type A (float or double); the thresholds (the deflation
// tests, dtrevc's clamps, the convergence test and the chase's guard) are
// A's.  The double shift squares the condition number, and in float the
// guard's threshold eps^(2/3) is about 4e-5.  Conjugate partners take their
// values from one block formula, so they tie bit for bit on every sort key
// and bound.
//
// Memory: six ncv x ncv matrices of double (H0, the working T or Hc, Q, the
// QR's M, its q and a product) and 18 ncv-vectors, in dynamic shared memory
// up to ncv 68 (work_bytes <= 232,192 bytes), else in a global buffer the
// caller passes (`work`); the kernel is built for each place, so that the
// shared one is addressed as shared memory.
//
// A cycle that ends the solve (done or is_last) applies no shifts and leaves
// H, Q and sk untouched; so does an extension that stopped short (`brk` not
// -1), which the host finishes before it calls again.
#include "common.cuh"

#include <cfloat>

namespace atpt {
namespace {

constexpr int RN_THREADS = 256;
constexpr int RN_MATRICES = 6;
constexpr int RN_VECTORS = 18;
constexpr long long RN_MAX_SMEM = 232448 - 256;
constexpr unsigned RN_FULL = 0xffffffffu;
enum { RN_LM = 0, RN_SM, RN_LR, RN_SR, RN_LI, RN_SI };
// Stamps (clock64(), thread 0, when the caller passes a buffer): the phases'
// ends, a cycle that exits early stamping its exit in every later slot (C_*);
// then the SM cycles summed over the Schur sweeps and the chase's shifts of
// the shift choice and shifted matrix, the reflector chain, the tail of q and
// the new T's columns behind it, and the step's end (the chase's Q q, the
// deflation; A_*); then the Schur sweeps and the chase's shifts run (N_*).
constexpr int RN_CLOCKS = 8;
enum { C_ENTRY = 0, C_SCHUR, C_TREVC, C_GETS, C_CHASE, C_GUARD, C_REDO, C_EXIT };
enum { A_SHIFT = RN_CLOCKS, A_QR, A_TAIL, A_POST, N_SWEEPS, N_SHIFTS, RN_CLOCK_SLOTS };
// packet offsets (ops/cuda_realnonsym_cycle.py; the header is cuda_sym_cycle's)
constexpr int P_DONE = 0, P_NCONV = 1, P_NEV = 2, P_NP = 3, P_INFO = 4, P_BRK = 5,
              P_FORCE = 6, P_RNORM = 7, P_CNT = 8, P_IMPL = 12, P_HEAD = 13;

struct RnArgs {
  int ncv, nev0, which, is_last, sweeps;
  double tol, eps23, eps_m, safmin;
  void* H;
  const void* rnorm;
  const int* brk;
  const int* force;
  const long long* cnt;
  void* Q;
  void* sk;
  double* packet;
  double* work;
  long long* clk;  // NULL, or RN_CLOCK_SLOTS stamps and counts
};

// Thread 0 adds the cycles since `mark` to laps[slot - A_SHIFT] (registers:
// a global read here would stall the warp that runs the QR) and moves the
// mark; `word`: a shared word to order the clock read after.
__device__ __forceinline__ void lap(const long long* clk, int slot, long long* laps,
                                    long long& mark, const int* word) {
  if (clk != nullptr && threadIdx.x == 0) {
    const long long t = clock_after(word);
    laps[slot - A_SHIFT] += t - mark;
    mark = t;
  }
}

__host__ __device__ inline long long work_bytes(int n) {
  return (static_cast<long long>(RN_MATRICES) * n * n + static_cast<long long>(RN_VECTORS) * n) *
         8;
}

// C = A B, or A^T B with `ta` (n x n, row-major); C is neither A nor B.
__device__ void matmul(double* C, const double* A, const double* B, int n, bool ta) {
  for (int k = threadIdx.x; k < n * n; k += blockDim.x) {
    const int r = k / n, c = k % n;
    double acc = 0.0;
    if (ta) {
      for (int m = 0; m < n; ++m) acc = __fma_rn(A[m * n + r], B[m * n + c], acc);
    } else {
      for (int m = 0; m < n; ++m) acc = __fma_rn(A[r * n + m], B[m * n + c], acc);
    }
    C[k] = acc;
  }
  __syncthreads();
}

__device__ void set_eye(double* A, int n) {
  for (int k = threadIdx.x; k < n * n; k += blockDim.x) A[k] = (k / n == k % n) ? 1.0 : 0.0;
  __syncthreads();
}

__device__ void copy_mat(double* dst, const double* src, int n) {
  for (int k = threadIdx.x; k < n * n; k += blockDim.x) dst[k] = src[k];
  __syncthreads();
}

// Zero negligible subdiagonals, |h| <= eps (|d_i| + |d_{i+1}|) (dnapps.f:328-336;
// a zero sum counts as 1); keep[i] = whether subdiagonal i stays (or NULL).
__device__ __forceinline__ void deflate(double* T, int n, double eps, double* keep) {
  for (int i = threadIdx.x; i < n - 1; i += blockDim.x) {
    double big = fabs(T[i * n + i]) + fabs(T[(i + 1) * n + i + 1]);
    if (big == 0.0) big = 1.0;
    const bool k = fabs(T[(i + 1) * n + i]) > eps * big;
    if (!k) T[(i + 1) * n + i] = 0.0;
    if (keep != nullptr) keep[i] = k ? 1.0 : 0.0;
  }
  __syncthreads();
}

// The discriminant of the (i, i + 1) block, ((a - d) / 2)^2 + b c: negative for
// a conjugate pair.  One formula for both members of a pair.
__device__ __forceinline__ double bdisc(const double* T, int n, int i) {
  const double half = __dmul_rn(__dsub_rn(T[i * n + i], T[(i + 1) * n + i + 1]), 0.5);
  return __fma_rn(half, half, __dmul_rn(T[i * n + i + 1], T[(i + 1) * n + i]));
}

// ---- one explicit QR step (a Schur sweep, or one shift of the chase) ----
// Every value keeps the operations of the sequential form (a dense shifted
// matrix, dgeqr2's reflectors, q by dorg2r's backward loop, dense products),
// in their order: the restart count of a solve follows the last bits.  What
// moves is who computes each value and when, and a sum leaves out only terms
// that are exact zeros by structure (below T's lower band, past the last
// nonzero row of a column of q), which add nothing to a sum that starts at
// +0.

// The Schur sweep's active block and shift, on every warp with no barrier
// (lanes over the subdiagonals, a ballot for the last active one): the last
// subdiagonal that stays and is no converged complex 2x2 block's; a real
// Wilkinson shift (mode 0, sa the root nearer a22) or the pair as one double
// shift (mode 1, sa = s, sb = p).  True when no block is active.
__device__ __forceinline__ bool schur_shift(const double* T, const double* keep, int n, int lane,
                                            int& mode, double& sa, double& sb) {
  int m = -1;
  for (int i0 = 0; i0 < n - 1; i0 += 32) {
    const int i = i0 + lane;
    bool act = false;
    if (i < n - 1) {
      const bool ki = keep[i] != 0.0;
      const bool left0 = i == 0 || keep[i - 1] == 0.0;
      const bool right0 = i == n - 2 || keep[i + 1] == 0.0;
      // a converged complex 2x2 block (outer couplings gone) stays
      const bool conv2 = ki && left0 && right0 && bdisc(T, n, i) < 0.0;
      act = ki && !conv2;
    }
    const unsigned b = __ballot_sync(RN_FULL, act);
    if (b != 0u) m = i0 + 31 - __clz(static_cast<int>(b));
  }
  if (m < 0) return true;
  const double a11 = T[m * n + m], a12 = T[m * n + m + 1];
  const double a21 = T[(m + 1) * n + m], a22 = T[(m + 1) * n + m + 1];
  const double s = a11 + a22, p = __fma_rn(a11, a22, -__dmul_rn(a12, a21));
  const double dsc = __fma_rn(__dmul_rn(s, s), 0.25, -p);  // s^2 / 4 - p
  if (dsc >= 0.0) {  // a real Wilkinson shift: the root nearer a22
    const double r = sqrt(fmax(dsc, 0.0));
    const double mu1 = __fma_rn(s, 0.5, r), mu2 = __fma_rn(s, 0.5, -r);
    mode = 0;
    sa = fabs(mu1 - a22) < fabs(mu2 - a22) ? mu1 : mu2;
  } else {  // the conjugate pair as one double shift
    mode = 1;
    sa = s;
    sb = p;
  }
  return false;
}

// shifted_band and q_product give thread t the column c = t % n of their
// result and, RN_ROWS at a time, the rows 4g..4g + 3, 4(g + G).., ... (g = t
// / n, G = blockDim.x / n): one pass over the sum's index m serves the four
// rows' sums (each in its own register, over its own nonzero terms, in
// ascending order) and loads column c's factor once.
constexpr int RN_ROWS = 4;

__device__ __forceinline__ int row_groups(int n) {
  return max(1, static_cast<int>(blockDim.x) / n);
}

// M = T - a I (mode 0) or T^2 - a T + b I (mode 1: a double shift), for the
// Hessenberg T: the entries on and above M's lower band (1, or 2), each T^2
// sum over its nonzero terms; nothing reads M below its band (the QR stops
// at each column's last nonzero row).
__device__ __forceinline__ void shifted_band(double* M, const double* T, int n, int mode, double a,
                                             double b) {
  const int band = mode == 0 ? 1 : 2;
  const int G = row_groups(n);
  if (mode == 0) {
    for (int t = threadIdx.x; t < G * n; t += blockDim.x) {
      const int c = t % n;
      for (int r = t / n; r < n && r <= c + band; r += G)
        M[r * n + c] = r == c ? T[r * n + c] - a : T[r * n + c];
    }
  } else {
    for (int t = threadIdx.x; t < G * n; t += blockDim.x) {
      const int c = t % n, hi = min(n - 1, c + 1);
      for (int r0 = RN_ROWS * (t / n); r0 < n && r0 <= c + band; r0 += RN_ROWS * G) {
        double acc[RN_ROWS];
#pragma unroll
        for (int i = 0; i < RN_ROWS; ++i) acc[i] = 0.0;
        for (int m = max(0, r0 - 1); m <= hi; ++m) {
          const double tv = T[m * n + c];
#pragma unroll
          for (int i = 0; i < RN_ROWS; ++i) {
            const int r = r0 + i;
            if (r < n && m >= r - 1) acc[i] = __fma_rn(T[r * n + m], tv, acc[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < RN_ROWS; ++i) {
          const int r = r0 + i, k = r * n + c;
          if (r < n && r <= c + band)
            M[k] = __dadd_rn(__fma_rn(-a, T[k], acc[i]), r == c ? b : 0.0);
        }
      }
    }
  }
  __syncthreads();
}

// One QR step's work is split over the warps, which hand it over through two
// progress words in shared memory (tagged with the step, so that they only
// grow; csrc/common.cuh's release stores and acquire polls) instead of a
// block barrier: warp 0 runs the reflector chain and publishes each
// reflector (prog[0]); warp 1 forms q's columns as soon as their reflectors
// exist and publishes how many are done (prog[1]); the other warps, the
// entry warps, form column c of W = T q and of T' = triu(q^T W, -1) as soon
// as q's columns up to c + 1 are done.  One block barrier ends the step.
constexpr int RN_ENTRY_WARPS = RN_THREADS / 32 - 2;
constexpr int RN_PASS_STEPS = 4;  // column steps per pass of the column warp's loop

// The Householder QR of M (lower band `band`, 1 or 2; in place: R on and
// above the diagonal, the reflectors' v below it, dgeqr2) on warp 0, in
// LAPACK's conventions: reflector j's dlarfg (beta = -sign(alpha)
// dlapy2(alpha, |x|), tau = (beta - alpha) / beta, x scaled by 1 / (alpha -
// beta)), then the reflector applied to the columns right of it, a lane per
// column (the columns are independent), __syncwarp between.  tau[j], and
// ext[j] the last row of reflector j's nonzeros; lane 0 publishes each
// reflector (prog[0], tag + j + 1) once they and column j are written.  |x|^2
// is the sum of the two squares below the diagonal (with at most two rows
// in the band, the warp tree of lane partials the first design took adds
// just these two); every lane forms the reflector itself (the same values
// on each: no broadcast), keeps x scaled in registers and preloads its
// first column, which no reflector's arithmetic waits on.
__device__ __forceinline__ void qr_factor(double* M, double* tau, int* ext, int n, int band,
                                          int lane, int* prog, int tag) {
  for (int j = 0; j < n; ++j) {
    const int r1 = j + 1, r2 = j + 2, rmax = min(n - 1, j + band), c0 = j + 1 + lane;
    const double alpha = M[j * n + j];
    const double x1 = r1 <= rmax ? M[r1 * n + j] : 0.0;
    const double x2 = r2 <= rmax ? M[r2 * n + j] : 0.0;
    // this lane's first column, rows j..j + 2
    const double m0 = c0 < n ? M[j * n + c0] : 0.0;
    const double m1 = c0 < n && r1 <= rmax ? M[r1 * n + c0] : 0.0;
    const double m2 = c0 < n && r2 <= rmax ? M[r2 * n + c0] : 0.0;
    const double ss = __dadd_rn(__dmul_rn(x1, x1), __dmul_rn(x2, x2));
    const int e = x2 != 0.0 ? r2 : (x1 != 0.0 ? r1 : j);
    const double xnorm = sqrt(ss);
    double t = 0.0, scal = 0.0, beta = alpha;
    if (xnorm != 0.0) {  // dlarfg: else H = I (tau = 0), R's diagonal alpha
      beta = -copysign(hypot(alpha, xnorm), alpha);
      t = (beta - alpha) / beta;
      scal = 1.0 / (alpha - beta);
    }
    // x scaled (the sequential form scaled M's rows j + 1.. in place)
    const double v1 = scal != 0.0 ? __dmul_rn(x1, scal) : x1;
    const double v2 = scal != 0.0 ? __dmul_rn(x2, scal) : x2;
    if (t != 0.0) {
      for (int c = c0; c < n; c += 32) {
        const double y0 = c == c0 ? m0 : M[j * n + c];
        const double y1 = c == c0 ? m1 : (e >= r1 ? M[r1 * n + c] : 0.0);
        const double y2 = c == c0 ? m2 : (e >= r2 ? M[r2 * n + c] : 0.0);
        double w = y0;
        if (e >= r1) w = __fma_rn(v1, y1, w);
        if (e >= r2) w = __fma_rn(v2, y2, w);
        const double tw = __dmul_rn(t, w);
        M[j * n + c] = __dsub_rn(y0, tw);
        if (e >= r1) M[r1 * n + c] = __fma_rn(-tw, v1, y1);
        if (e >= r2) M[r2 * n + c] = __fma_rn(-tw, v2, y2);
      }
    }
    __syncwarp();
    if (lane == 0) {  // column j, which every lane has read
      M[j * n + j] = beta;
      if (scal != 0.0 && e >= r1) M[r1 * n + j] = v1;
      if (scal != 0.0 && e >= r2) M[r2 * n + j] = v2;
      tau[j] = t;
      ext[j] = e;
      st_release(prog, tag + j + 1);
    }
  }
}

// q = H_0 H_1 ... H_{n-1} by dorg2r's backward accumulation on warp 1:
// column c meets reflectors c, c - 1, ..., 0, in that order, and no other
// column, so it starts as soon as reflector c exists (prog[0]).  Lane l forms
// the columns l, l + 32, ..., RN_PASS_STEPS steps per pass of the loop
// (which share its polls and votes), the lanes in step: columns finish in
// order, and the count done is published (prog[1]).  Reflector j meets rows
// j..j + 2 of the column (M's band is at most 2), row j still the
// identity's and rows j + 1, j + 2 carried in registers from the reflector
// before (row j + 2 is final after it; rows past n - 1 clamped to it, whose
// own value is written after them); each lane reads the next reflector's
// data one step ahead.  A term of a row past ext[j], or a reflector with tau
// = 0, enters as an exact zero, which leaves a value that is not -0 (none of
// q's is: they start +0 or 1 and only sums change them) as it was.  qb[c]:
// the last row of column c that may be nonzero (no one reads q past it).
__device__ __forceinline__ void q_columns(double* __restrict__ q, const double* __restrict__ M,
                                          const double* __restrict__ tau,
                                          const int* __restrict__ ext, int* __restrict__ qb, int n,
                                          int lane, int* prog, int tag) {
  int col = lane, j = -1, nref = 0, done = 0, bot = 0, en = 0;
  double y1 = 0.0, y2 = 0.0, tn = 0.0, v1n = 0.0, v2n = 0.0;
  while (done < n) {
    // poll the reflectors only while a lane waits for one
    if (__any_sync(RN_FULL, j < 0 && col < n && nref <= col))
      nref = warp_poll(prog, tag + nref, lane) - tag;
    if (j < 0 && col < n && nref > col) {
      j = bot = col;
      y1 = y2 = 0.0;
      tn = tau[j];
      en = ext[j];
      v1n = M[min(j + 1, n - 1) * n + j];
      v2n = M[min(j + 2, n - 1) * n + j];
    }
    // every lane runs every step, an idle one (j < 0) on reflector 0 with
    // its stores dropped and its registers garbage until its next column
    // starts: a branch in this loop costs more than the step
    bool fin = false;
#pragma unroll
    for (int step = 0; step < RN_PASS_STEPS; ++step) {
      const bool act = j >= 0;
      const int jj = max(j, 0), e = en;
      const double t = tn;
      const double v1 = e >= jj + 1 ? v1n : 0.0, v2 = e >= jj + 2 ? v2n : 0.0;
      const int jn = max(jj - 1, 0);  // the next reflector's data
      tn = tau[jn];
      en = ext[jn];
      v1n = M[(jn + 1) * n + jn];
      v2n = M[min(jn + 2, n - 1) * n + jn];
      const double y0 = jj == col ? 1.0 : 0.0;
      const double w = __fma_rn(v2, y2, __fma_rn(v1, y1, y0));
      const double tw = __dmul_rn(t, w);
      const double z0 = __dsub_rn(y0, tw);
      const double z1 = __fma_rn(-tw, v1, y1);
      const double z2 = __fma_rn(-tw, v2, y2);
      bot = max(bot, e);
      if (act) q[min(jj + 2, n - 1) * n + col] = z2;  // row j + 2 is final
      if (act && jj == 0) {  // the column's last step
        q[col] = z0;
        q[n + col] = z1;
        qb[col] = bot;
      }
      y2 = z1;
      y1 = z0;
      fin = fin || (act && jj == 0);
      j -= act;
    }
    if (fin) col += 32;
    const int nd = __popc(__ballot_sync(RN_FULL, fin));
    if (nd > 0) {
      done += nd;
      __syncwarp();  // the columns' writes before the count
      if (lane == 0) st_release(prog + 1, tag + done);
    }
  }
}

// A warp waits until q's columns 0..want - 1 are done (`seen`: the count it
// knew; returns the count it saw): lane 0 polls, the lanes' reads are
// ordered after its acquire.
__device__ __forceinline__ int columns_done(const int* prog, int tag, int want, int seen,
                                            int lane) {
  if (seen < want) {
    int v = 0;
    if (lane == 0) {  // the poll sleeps between reads, leaving the SM's issue
                      // slots and shared memory to the chains
      while ((v = ld_relaxed(prog + 1)) < tag + want) __nanosleep(100);
      fence_acquire();
    }
    seen = __shfl_sync(RN_FULL, v, 0) - tag;
    __syncwarp();
  }
  return seen;
}

// Entry warp k of RN_ENTRY_WARPS: the columns c = k, k + RN_ENTRY_WARPS, ...
// of W = T q (into wc, this warp's vector; lanes over the rows, row r over
// T's nonzero columns m = r - 1..qb[c], q's column c first copied to qc) and
// of T' = triu(q^T W, -1) (into Tn's column c; entry (r, c), r <= c + 1,
// over the rows up to the last nonzero one of q's column r and of W's,
// qb[c] + 1; the lanes in step over m); in the Schur sweeps also qn[c], the
// last row of Q q (lane 31; dtrevc reads no other row of the Schur
// vectors).  Every entry is summed in ascending order.
__device__ __forceinline__ void entries(const double* T, double* Tn, const double* q, const int* qb,
                                        const double* Q, double* qn, double* qc, double* wc, int n,
                                        int k, int lane, const int* prog, int tag) {
  int done = 0;
  for (int c = k; c < n; c += RN_ENTRY_WARPS) {
    done = columns_done(prog, tag, c + 1, done, lane);
    const int hi = qb[c];
    for (int r = lane; r <= hi; r += 32) qc[r] = q[r * n + c];
    __syncwarp();
    for (int r = lane; r < n; r += 32) {
      double w = 0.0;
#pragma unroll 4
      for (int m = max(0, r - 1); m <= hi; ++m) w = __fma_rn(T[r * n + m], qc[m], w);
      wc[r] = w;
    }
    if (qn != nullptr && lane == 31) {
      double z = 0.0;
      for (int m = 0; m <= hi; ++m) z = __fma_rn(Q[(n - 1) * n + m], qc[m], z);
      qn[c] = z;
    }
    done = columns_done(prog, tag, min(c + 2, n), done, lane);
    __syncwarp();  // wc
    const int wb = hi + 1;
    for (int r = lane; r < n; r += 32) {
      const int h = r <= c + 1 ? min(qb[r], wb) : -1;
      double acc = 0.0;
#pragma unroll 4
      for (int m = 0; m <= h; ++m) acc = __fma_rn(q[m * n + r], wc[m], acc);
      Tn[r * n + c] = acc;
    }
    __syncwarp();  // qc and wc are this warp's next column's
  }
}

// One QR step of M (shifted_band, lower band `band`) on T: q into q, T' =
// triu(q^T T q, -1) into Tn and, with qn, the last row of Q q into qn.  scr:
// 2 RN_ENTRY_WARPS vectors for the entry warps; step: the QR steps before
// this one in the launch (the progress words' tag).
__device__ __forceinline__ void qr_step(const double* T, double* Tn, double* M, double* q,
                                        double* tau, int* ext, int* qb, const double* Q,
                                        double* qn, double* scr, int n, int band, int step,
                                        int* prog, const long long* clk, long long* laps,
                                        long long& mark) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, tag = step * (n + 1);
  if (warp == 0) {
    qr_factor(M, tau, ext, n, band, lane, prog, tag);
    lap(clk, A_QR, laps, mark, prog);
  } else if (warp == 1) {
    q_columns(q, M, tau, ext, qb, n, lane, prog, tag);
  } else {
    const int k = warp - 2;
    entries(T, Tn, q, qb, Q, qn, scr + 2 * k * n, scr + (2 * k + 1) * n, n, k, lane, prog, tag);
  }
  __syncthreads();
  lap(clk, A_TAIL, laps, mark, prog);
}

// Qn = Q q (the chase), each entry in ascending order over q's nonzero rows
// (qb[c]).
__device__ __forceinline__ void q_product(double* Qn, const double* Q, const double* q,
                                          const int* qb, int n) {
  const int G = row_groups(n);
  for (int t = threadIdx.x; t < G * n; t += blockDim.x) {
    const int c = t % n, hi = qb[c];
    for (int r0 = RN_ROWS * (t / n); r0 < n; r0 += RN_ROWS * G) {
      double z[RN_ROWS];
#pragma unroll
      for (int i = 0; i < RN_ROWS; ++i) z[i] = 0.0;
      for (int m = 0; m <= hi; ++m) {
        const double qv = q[m * n + c];
#pragma unroll
        for (int i = 0; i < RN_ROWS; ++i)
          if (r0 + i < n) z[i] = __fma_rn(Q[(r0 + i) * n + m], qv, z[i]);
      }
#pragma unroll
      for (int i = 0; i < RN_ROWS; ++i)
        if (r0 + i < n) Qn[(r0 + i) * n + c] = z[i];
    }
  }
  __syncthreads();
}

// T <- triu(q^T T q, -1), then Q <- Q q (through W; returns the new Q's buffer,
// the old one becomes the scratch W).
__device__ double* similarity(double* T, double*& Q, double* q, double* W, int n) {
  matmul(W, T, q, n, false);
  matmul(T, q, W, n, true);
  for (int k = threadIdx.x; k < n * n; k += blockDim.x)
    if (k / n > k % n + 1) T[k] = 0.0;
  __syncthreads();
  matmul(W, Q, q, n, false);
  double* old = Q;
  Q = W;
  return old;
}

// The q of one shift applied by an implicit bulge chase (dnapps): reflectors of
// order 2 (real shift) or 3 (a conjugate pair, mui > 0) down the Hessenberg H,
// on a working copy M.  xv: 3 doubles; sh: 2 doubles of shared memory.
__device__ void implicit_q(const double* H, double* M, double* q, int n, double mur, double mui,
                           double* xv, double* sh) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int nb = mui > 0.0 ? 3 : 2;
  for (int k = tid; k < n * n; k += nt) {
    M[k] = H[k];
    q[k] = (k / n == k % n) ? 1.0 : 0.0;
  }
  __syncthreads();
  for (int j = 0; j < n - 1; ++j) {
    if (tid == 0) {
      int m = nb;
      if (j == 0) {
        if (mui > 0.0) {
          const double m2 = mur + mur, mm = __fma_rn(mur, mur, __dmul_rn(mui, mui));
          xv[0] = __dadd_rn(mm, __fma_rn(-m2, H[0], __fma_rn(H[0], H[0], __dmul_rn(H[n], H[1]))));
          xv[1] = __dmul_rn(__dsub_rn(__dadd_rn(H[n + 1], H[0]), m2), H[n]);
          xv[2] = __dmul_rn(H[n], H[2 * n + 1]);
        } else {
          xv[0] = H[0] - mur;
          xv[1] = H[n];
        }
      } else {
        m = min(nb, n - j);
        for (int k = 0; k < m; ++k) xv[k] = M[(j + k) * n + j - 1];
      }
      double ss = 0.0;
      for (int k = 0; k < m; ++k) ss = __fma_rn(xv[k], xv[k], ss);
      xv[0] += copysign(sqrt(ss), xv[0]);
      double vv = 0.0;
      for (int k = 0; k < m; ++k) vv = __fma_rn(xv[k], xv[k], vv);
      sh[0] = vv == 0.0 ? 0.0 : 2.0 / vv;
      sh[1] = m;
    }
    __syncthreads();
    const double beta = sh[0];
    const int m = static_cast<int>(sh[1]);
    if (beta != 0.0) {
      for (int c = tid; c < n; c += nt) {
        double t = 0.0;
        for (int k = 0; k < m; ++k) t = __fma_rn(xv[k], M[(j + k) * n + c], t);
        for (int k = 0; k < m; ++k)
          M[(j + k) * n + c] = __fma_rn(-beta, __dmul_rn(xv[k], t), M[(j + k) * n + c]);
      }
      __syncthreads();
      for (int r = tid; r < n; r += nt) {
        double t = 0.0, tq = 0.0;
        for (int k = 0; k < m; ++k) {
          t = __fma_rn(M[r * n + j + k], xv[k], t);
          tq = __fma_rn(q[r * n + j + k], xv[k], tq);
        }
        for (int k = 0; k < m; ++k) {
          M[r * n + j + k] = __fma_rn(-beta, __dmul_rn(t, xv[k]), M[r * n + j + k]);
          q[r * n + j + k] = __fma_rn(-beta, __dmul_rn(tq, xv[k]), q[r * n + j + k]);
        }
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ double which_key(int which, double wr, double wi) {
  switch (which) {
    case RN_LM: return hypot(wr, wi);
    case RN_SM: return -hypot(wr, wi);
    case RN_LR: return wr;
    case RN_SR: return -wr;
    case RN_LI: return fabs(wi);
    default: return -fabs(wi);
  }
}

// Whether a conjugate pair straddles index b of the sorted values.
__device__ bool straddle(const double* wr, const double* wi, int n, int b) {
  if (b < 1 || b > n - 1) return false;
  return wi[b - 1] > 0.0 && wi[b] < 0.0 && wr[b - 1] == wr[b] && wi[b - 1] == -wi[b];
}

// dtrevc for eigen-index i of the quasi-triangular T: its eigenvector (re, im)
// in columns i of ur, ui, solved from the bottom row up with its clamps; returns
// |last component| of the unit eigenvector of H = Qs T Qs^T.
__device__ double last_component(int i, const double* T, const double* Qs, double* ur,
                                 double* ui, const double* wr, const double* wi,
                                 const double* pst, const double* psec, int n, double small,
                                 double small2, double tiny) {
  const int s = psec[i] != 0.0 ? i - 1 : i;
  const bool is_pair = pst[s] != 0.0;
  const int e = s + (is_pair ? 1 : 0);
  const int s1 = min(s + 1, n - 1);
  const double lr = wr[i], li = fabs(wi[i]);
  // seeds: a 1x1 block u[s] = 1; a 2x2 block a null vector of it
  const double a = T[s * n + s], d = T[s1 * n + s1];
  const double b = is_pair ? T[s * n + s1] : 0.0, c = is_pair ? T[s1 * n + s] : 0.0;
  const bool use_b = fabs(b) >= fabs(c);
  const double ssr = is_pair ? (use_b ? b : lr - d) : 1.0;
  const double ssi = (is_pair && !use_b) ? li : 0.0;
  const double ser = use_b ? lr - a : c;
  const double sei = use_b ? li : 0.0;
  // eigenvector i is column i of ur, ui (row m at [m n + i]): the lanes of a
  // warp, on neighbouring eigen-indices, read and write neighbouring words
  double* u = ur + i;
  double* v = ui + i;
  for (int m = 0; m < n; ++m) u[m * n] = v[m * n] = 0.0;
  bool skip = false;
  for (int l = n - 1; l >= 0; --l) {
    double cr = 0.0, ci = 0.0;
    for (int m = l + 1; m < n; ++m) {
      cr += T[l * n + m] * u[m * n];
      ci += T[l * n + m] * v[m * n];
    }
    const bool solve = l < s && !skip;
    bool solved_skip;
    if (l > 0 && T[l * n + l - 1] != 0.0) {
      // rows (l - 1, l) coupled: the complex 2x2 solved jointly
      const int lm1 = l - 1;
      double crm = 0.0, cim = 0.0;
      for (int m = l + 1; m < n; ++m) {
        crm += T[lm1 * n + m] * u[m * n];
        cim += T[lm1 * n + m] * v[m * n];
      }
      const double a11r = T[lm1 * n + lm1] - lr, a11i = -li;
      const double a12 = T[lm1 * n + l], a21 = T[l * n + lm1];
      const double a22r = T[l * n + l] - lr, a22i = -li;
      double detr = a11r * a22r - a11i * a22i - a12 * a21;
      double deti = a11r * a22i + a11i * a22r;
      double dmag2 = detr * detr + deti * deti;
      if (!(dmag2 >= small2)) {
        detr = small;
        deti = 0.0;
        dmag2 = small2;
      }
      const double b1r = -crm, b1i = -cim, b2r = -cr, b2i = -ci;
      const double x1r = a22r * b1r - a22i * b1i - a12 * b2r;
      const double x1i = a22r * b1i + a22i * b1r - a12 * b2i;
      const double x2r = a11r * b2r - a11i * b2i - a21 * b1r;
      const double x2i = a11r * b2i + a11i * b2r - a21 * b1i;
      if (solve) {
        u[lm1 * n] = (x1r * detr + x1i * deti) / dmag2;
        v[lm1 * n] = (x1i * detr - x1r * deti) / dmag2;
        u[l * n] = (x2r * detr + x2i * deti) / dmag2;
        v[l * n] = (x2i * detr - x2r * deti) / dmag2;
      }
      solved_skip = true;
    } else {
      double denr = T[l * n + l] - lr, deni = -li;
      double dmag2 = denr * denr + deni * deni;
      if (!(dmag2 >= small2)) {
        denr = small;
        deni = 0.0;
        dmag2 = small2;
      }
      if (solve) {
        u[l * n] = (-cr * denr - ci * deni) / dmag2;
        v[l * n] = (-ci * denr + cr * deni) / dmag2;
      }
      solved_skip = false;
    }
    // the eigen-index seeds its block at the block's end row e, or skips the
    // row after a seeded pair or a joint solve
    const bool at_e = !solve && l == e && !skip;
    if (at_e) {
      u[e * n] = ser;
      v[e * n] = sei;
      u[s * n] = ssr;
      if (is_pair) v[s * n] = ssi;
    }
    skip = solve ? solved_skip : (at_e && is_pair);
  }
  double nrm = 0.0, pr = 0.0, pi = 0.0;
  for (int m = 0; m < n; ++m) {
    nrm += u[m * n] * u[m * n] + v[m * n] * v[m * n];
    pr += Qs[(n - 1) * n + m] * u[m * n];
    pi += Qs[(n - 1) * n + m] * v[m * n];
  }
  return hypot(pr, pi) / fmax(sqrt(nrm), tiny);
}

// GMEM: the workspace is in g.work (global memory), else in dynamic shared
// memory (the compiler then addresses it as shared memory).
template <typename A, bool GMEM>
__global__ void __launch_bounds__(RN_THREADS, 1) realnonsym_cycle_kernel(RnArgs g) {
  extern __shared__ __align__(16) double rn_smem[];
  __shared__ double s_red[33];
  __shared__ double s_sh[2];  // the implicit chase's beta and order
  __shared__ int s_int[4];    // brk, done, nev_eff, np_eff
  __shared__ int s_prog[2];   // the QR steps' progress words (qr_step)
  const int n = g.ncv, nn = n * n, tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  double* base = GMEM ? g.work : rn_smem;
  double* H0 = base;
  double* T = base + nn;  // the Schur form's T, then the chase's Hc
  double* Qa = base + 2 * nn;
  double* M = base + 3 * nn;
  double* q = base + 4 * nn;
  double* W = base + 5 * nn;
  // the vectors: the first 2 RN_ENTRY_WARPS are the entry warps' while a QR
  // step runs (scr), and those of the other phases that no step reads
  double* vec = base + RN_MATRICES * nn;
  double* scr = vec;
  double *wr = vec, *wi = vec + n, *key = vec + 2 * n, *wrs = vec + 3 * n, *wis = vec + 4 * n;
  double *bs = vec + 5 * n, *keep = vec + 6 * n, *pst = vec + 7 * n, *psec = vec + 8 * n;
  double* xv = vec + 9 * n;
  double *out = vec + 12 * n, *bnd = vec + 13 * n, *swr = vec + 14 * n, *swi = vec + 15 * n;
  double *tau = vec + 16 * n, *ext = vec + 17 * n;
  // free while the QR steps run: q's last nonzero rows, the new last row of
  // the Schur vectors
  int* qb = reinterpret_cast<int*>(bnd);
  double* qn = out;
  int* exti = reinterpret_cast<int*>(ext);  // the last row of each reflector
  A* Hg = static_cast<A*>(g.H);
  double* pk = g.packet;
  const double rnorm = static_cast<double>(*static_cast<const A*>(g.rnorm));
  const int psize = P_HEAD + 3 * n + nn;
  long long* clk = g.clk;
  long long mark = 0, laps[RN_CLOCK_SLOTS - A_SHIFT] = {};
  // stamp phase `from` and every later one (the exit overwrites the rest),
  // and the laps and counts so far
  auto stamp = [&](int from) {
    if (clk != nullptr && tid == 0) {
      const long long t = clock_after(s_prog);
      for (int i = from; i < RN_CLOCKS; ++i) clk[i] = t;
      for (int i = A_SHIFT; i < RN_CLOCK_SLOTS; ++i) clk[i] = laps[i - A_SHIFT];
    }
  };
  for (int k = tid; k < psize; k += nt) pk[k] = 0.0;
  if (tid < 2) s_prog[tid] = 0;
  __syncthreads();
  stamp(C_ENTRY);
  if (tid == 0) {
    s_int[0] = *g.brk;
    pk[P_BRK] = s_int[0];
    pk[P_FORCE] = *g.force;
    pk[P_RNORM] = rnorm;
    for (int i = 0; i < 4; ++i) pk[P_CNT + i] = static_cast<double>(g.cnt[i]);
  }
  __syncthreads();
  if (s_int[0] != -1) {
    stamp(C_SCHUR);
    return;
  }

  // max |H0| (the guard's scale)
  double hm = 0.0;
  for (int k = tid; k < nn; k += nt) {
    H0[k] = static_cast<double>(Hg[k]);
    T[k] = H0[k];
    Qa[k] = (k / n == k % n) ? 1.0 : 0.0;
    hm = fmax(hm, fabs(H0[k]));
  }
  const double hmax = block_max(hm, s_red);

  // ---- dneigh: the real Schur form by explicit QR sweeps ----
  int step = 0;  // the QR steps so far (both loops)
  for (int sweep = 0; sweep < g.sweeps; ++sweep) {
    if (clk != nullptr && tid == 0) mark = clock_after(s_prog);
    deflate(T, n, g.eps_m, keep);
    int mode = 0;
    double sa = 0.0, sb = 0.0;
    if (schur_shift(T, keep, n, lane, mode, sa, sb)) break;
    shifted_band(M, T, n, mode, sa, sb);
    lap(clk, A_SHIFT, laps, mark, s_prog);
    qr_step(T, W, M, q, tau, exti, qb, Qa, qn, scr, n, mode + 1, step++, s_prog, clk, laps, mark);
    double* swap = T;
    T = W;
    W = swap;
    for (int c = tid; c < n; c += nt) Qa[(n - 1) * n + c] = qn[c];
    lap(clk, A_POST, laps, mark, s_prog);
    if (clk != nullptr && tid == 0) ++laps[N_SWEEPS - A_SHIFT];
  }
  deflate(T, n, g.eps_m, nullptr);
  stamp(C_SCHUR);

  // ---- the block eigenvalues (dlanv2's role) and the Ritz bounds ----
  double tmax = 0.0;
  for (int k = tid; k < nn; k += nt) tmax = fmax(tmax, fabs(T[k]));
  const double tnorm = fmax(block_max(tmax, s_red), 1.0);
  for (int i = tid; i < n; i += nt) {
    const bool ps = i < n - 1 && T[(i + 1) * n + i] != 0.0;
    const bool sc = i > 0 && T[i * n + i - 1] != 0.0;
    pst[i] = ps;
    psec[i] = sc;
    if (ps) {
      const double disc = bdisc(T, n, i);
      const double mean = (T[i * n + i] + T[(i + 1) * n + i + 1]) / 2.0;
      wr[i] = disc < 0.0 ? mean : mean + sqrt(fmax(disc, 0.0));
      wi[i] = disc < 0.0 ? sqrt(fmax(-disc, 0.0)) : 0.0;
    } else if (sc) {
      const double disc = bdisc(T, n, i - 1);
      const double mean = (T[(i - 1) * n + i - 1] + T[i * n + i]) / 2.0;
      wr[i] = disc < 0.0 ? mean : mean - sqrt(fmax(disc, 0.0));
      wi[i] = disc < 0.0 ? -sqrt(fmax(-disc, 0.0)) : 0.0;
    } else {
      wr[i] = T[i * n + i];
      wi[i] = 0.0;
    }
  }
  __syncthreads();
  {
    const double small = g.eps_m * tnorm;
    for (int i = tid; i < n; i += nt)
      out[i] = last_component(i, T, Qa, M, q, wr, wi, pst, psec, n, small, small * small,
                              g.safmin);
  }
  __syncthreads();
  // a pair's second member takes its first's value
  for (int i = tid; i < n; i += nt) {
    bnd[i] = rnorm * (psec[i] != 0.0 ? out[i - 1] : out[i]);
    key[i] = which_key(g.which, wr[i], wi[i]);
  }
  __syncthreads();
  stamp(C_TREVC);
  // ---- dngets: the stable which-sort, wanted last ----
  for (int i = tid; i < n; i += nt) {
    const int r = stable_rank(key, n, i);
    wrs[r] = wr[i];
    wis[r] = wi[i];
    bs[r] = bnd[i];
  }
  __syncthreads();
  const int np0 = n - g.nev0;
  if (tid == 0) {
    // a pair split at the nev0 cut grows kev by one (dngets.f:165-176)
    const int str0 = straddle(wrs, wis, n, np0);
    const int np1 = np0 - str0, nev1 = g.nev0 + str0;
    int nconv = 0, nz = 0;
    for (int i = np1; i < n; ++i) nconv += bs[i] <= g.tol * fmax(g.eps23, hypot(wrs[i], wis[i]));
    for (int i = 0; i < np1; ++i) nz += bs[i] == 0.0;
    int np_eff = np1 - nz, nev_eff = nev1 + nz;
    const int done = nconv >= g.nev0 || np_eff == 0;
    // nev inflation (dnaup2.f:673-693)
    int nev_inf = nev_eff + min(nconv, np_eff / 2);
    if (nev_inf == 1 && n >= 6) {
      nev_inf = n / 2;
    } else if (nev_inf == 1 && n > 3) {
      nev_inf = 2;
    }
    nev_eff = min(nev_inf, n - 1);
    np_eff = n - nev_eff;
    // the moved boundary re-checked: grow kev, or take both members as shifts
    if (straddle(wrs, wis, n, np_eff)) {
      const int step = np_eff > 1 ? 1 : -1;
      np_eff -= step;
      nev_eff += step;
    }
    s_int[1] = done;
    s_int[2] = nev_eff;
    s_int[3] = np_eff;
    pk[P_DONE] = done;
    pk[P_NCONV] = nconv;
    pk[P_NEV] = nev_eff;
    pk[P_NP] = np_eff;
    pk[P_INFO] = 0;
  }
  for (int i = tid; i < n; i += nt) {
    pk[P_HEAD + i] = wrs[i];
    pk[P_HEAD + n + i] = wis[i];
    pk[P_HEAD + 2 * n + i] = bs[i];
  }
  __syncthreads();
  const int nev_eff = s_int[2], np_eff = s_int[3];
  if (s_int[1] || g.is_last) {  // exit before dnapps: H as it was
    for (int k = tid; k < nn; k += nt) pk[P_HEAD + 3 * n + k] = H0[k];
    stamp(C_GETS);
    return;
  }

  // ---- dnapps: the shift pool, largest bound first, pairs adjacent ----
  for (int i = tid; i < np0; i += nt) key[i] = i < np_eff ? -fabs(bs[i]) : INFINITY;
  __syncthreads();
  for (int i = tid; i < np0; i += nt) {
    const int r = stable_rank(key, np0, i);
    swr[r] = wrs[i];
    swi[r] = wis[i];
  }
  __syncthreads();
  stamp(C_GETS);
  int implicit = 0;
  copy_mat(T, H0, n);
  set_eye(Qa, n);
  for (int i = 0; i < np0 && i < np_eff; ++i) {
    const double mur = swr[i], mui = swi[i];
    if (mui < 0.0) continue;  // a pair's second member: applied with the first
    if (clk != nullptr && tid == 0) mark = clock_after(s_prog);
    const int mode = mui > 0.0;
    shifted_band(M, T, n, mode, mode ? mur + mur : mur, __fma_rn(mur, mur, __dmul_rn(mui, mui)));
    lap(clk, A_SHIFT, laps, mark, s_prog);
    qr_step(T, W, M, q, tau, exti, qb, Qa, nullptr, scr, n, mode + 1, step++, s_prog, clk, laps,
            mark);
    q_product(M, Qa, q, qb, n);  // into M, free after the step
    double* swap = T;
    T = W;
    W = swap;
    swap = Qa;
    Qa = M;
    M = swap;
    deflate(T, n, g.eps_m, nullptr);
    lap(clk, A_POST, laps, mark, s_prog);
    if (clk != nullptr && tid == 0) ++laps[N_SHIFTS - A_SHIFT];
  }
  stamp(C_CHASE);
  // the explicit chase's loss in the kept columns (a near-zero pivot):
  // (Q^T H0 Q - Hc)[:, :nev_eff], column by column
  for (int k = tid; k < n * nev_eff; k += nt) {
    const int r = k / nev_eff, c = k % nev_eff;
    double acc = 0.0;
    for (int m = max(0, r - 1); m < n; ++m) acc = __fma_rn(H0[r * n + m], Qa[m * n + c], acc);
    W[r * n + c] = acc;
  }
  __syncthreads();
  double lost = 0.0;
  for (int k = tid; k < n * nev_eff; k += nt) {
    const int r = k / nev_eff, c = k % nev_eff;
    double acc = 0.0;
    for (int m = 0; m < n; ++m) acc = __fma_rn(Qa[m * n + r], W[m * n + c], acc);
    lost = fmax(lost, fabs(acc - T[r * n + c]));
  }
  lost = block_max(lost, s_red);
  stamp(C_GUARD);
  if (lost > g.eps23 * hmax) {  // the shifts again, by implicit bulge chases
    implicit = 1;
    copy_mat(T, H0, n);
    set_eye(Qa, n);
    for (int i = 0; i < np0 && i < np_eff; ++i) {
      const double mur = swr[i], mui = swi[i];
      if (mui < 0.0) continue;
      implicit_q(T, M, q, n, mur, mui, xv, s_sh);
      W = similarity(T, Qa, q, W, n);
      deflate(T, n, g.eps_m, nullptr);
    }
  }
  stamp(C_REDO);

  A* Qg = static_cast<A*>(g.Q);
  for (int k = tid; k < nn; k += nt) {
    const A h = static_cast<A>(T[k]);
    Hg[k] = h;
    pk[P_HEAD + 3 * n + k] = static_cast<double>(h);
    Qg[k] = static_cast<A>(Qa[k]);
  }
  if (tid == 0) {
    A* sk = static_cast<A*>(g.sk);
    sk[0] = static_cast<A>(Qa[(n - 1) * n + nev_eff - 1]);
    sk[1] = static_cast<A>(T[nev_eff * n + nev_eff - 1]);
    pk[P_IMPL] = implicit;
  }
  stamp(C_EXIT);
}

template <typename A>
int realnonsym_cycle_typed(RnArgs g, cudaStream_t st) {
  if (g.ncv < 3 || g.nev0 < 1 || g.nev0 >= g.ncv || g.which < RN_LM || g.which > RN_SI ||
      g.sweeps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = work_bytes(g.ncv);
  const bool shared = bytes <= RN_MAX_SMEM;
  if (shared) {
    g.work = nullptr;
  } else if (g.work == nullptr || (reinterpret_cast<uintptr_t>(g.work) & 7u) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = shared ? static_cast<int>(bytes) : 0;
  auto kern = shared ? realnonsym_cycle_kernel<A, false> : realnonsym_cycle_kernel<A, true>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<1, RN_THREADS, static_cast<size_t>(smem), st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace atpt

extern "C" {

// One cycle's reduced space (see the head note).  code 0: float, 2: double
// (the dtype codes of common.cuh); which: 0 LM, 1 SM, 2 LR, 3 SR, 4 LI, 5 SI.
// `work`: NULL where the workspace fits in shared memory, else a global buffer
// of its bytes (work_bytes).  `clocks`: NULL (the solver's call), or
// RN_CLOCK_SLOTS int64 for the stamps.
int atpt_realnonsym_cycle(int code, int ncv, int nev0, int which, int is_last, int sweeps,
                          double tol, double eps23, double eps_m, double safmin, void* H,
                          const void* rnorm, const void* brk, const void* force, const void* cnt,
                          void* Q, void* sk, void* packet, void* work, void* clocks,
                          void* stream) {
  const atpt::RnArgs g{ncv,
                       nev0,
                       which,
                       is_last,
                       sweeps,
                       tol,
                       eps23,
                       eps_m,
                       safmin,
                       H,
                       rnorm,
                       static_cast<const int*>(brk),
                       static_cast<const int*>(force),
                       static_cast<const long long*>(cnt),
                       Q,
                       sk,
                       static_cast<double*>(packet),
                       static_cast<double*>(work),
                       static_cast<long long*>(clocks)};
  auto st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0: return atpt::realnonsym_cycle_typed<float>(g, st);
    case 2: return atpt::realnonsym_cycle_typed<double>(g, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

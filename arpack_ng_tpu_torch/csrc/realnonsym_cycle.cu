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
// Bound: neither bytes (a few KB in and out) nor the card's flops, but one
// SM's and the length of the dependent chains: each sweep or shift is a QR of
// a shifted Hessenberg (reflector j waits on reflector j - 1's update; each
// is a lane's hypot and two double divisions between two block barriers),
// its q, and three dense ncv x ncv products; the Schur form takes about two
// sweeps per Ritz value.  The design is the plain one: one block, every
// matrix dense and row-major, the QR by Householder reflectors in LAPACK's
// conventions (dgeqr2: beta = -sign(alpha) dlapy2(alpha, |x|), tau = (beta -
// alpha) / beta, x scaled by 1 / (alpha - beta); dorg2r's backward
// accumulation of q), so Q's column signs, and sigmak's, agree with numpy's
// (LAPACK's) QR, which the plain twin calls; each reflector applied over its
// nonzero rows only (one or two below the diagonal; the zeros past them add
// nothing); products with a thread per entry; the sequential decisions (the
// Schur form's active block and shift, dngets' counts) on thread 0; the sorts
// as stable ranks, a thread per value; dtrevc a thread per eigenvalue, each
// solving its own eigenvector from the bottom row up as the twin's vectorized
// code does per row.
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
// QR's M, its q and a product) and 16 ncv-vectors, in dynamic shared memory
// up to ncv 68 (work_bytes <= 232,192 bytes), else in a global buffer the
// caller passes (`work`).
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
constexpr int RN_VECTORS = 16;
constexpr long long RN_MAX_SMEM = 232448 - 256;
constexpr unsigned RN_FULL = 0xffffffffu;
enum { RN_LM = 0, RN_SM, RN_LR, RN_SR, RN_LI, RN_SI };
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
};

__host__ __device__ inline long long work_bytes(int n) {
  return (static_cast<long long>(RN_MATRICES) * n * n + static_cast<long long>(RN_VECTORS) * n) *
         8;
}

// The largest |v| over the block (every thread passes its partial; all return
// the maximum).  `red`: 33 doubles of shared memory.
__device__ double block_max(double v, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmax(v, __shfl_down_sync(RN_FULL, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    double m = red[0];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) m = fmax(m, red[w]);
    red[32] = m;
  }
  __syncthreads();
  const double out = red[32];
  __syncthreads();
  return out;
}

// C = A B, or A^T B with `ta` (n x n, row-major); C is neither A nor B.
__device__ void matmul(double* C, const double* A, const double* B, int n, bool ta) {
  for (int k = threadIdx.x; k < n * n; k += blockDim.x) {
    const int r = k / n, c = k % n;
    double acc = 0.0;
    if (ta) {
      for (int m = 0; m < n; ++m) acc += A[m * n + r] * B[m * n + c];
    } else {
      for (int m = 0; m < n; ++m) acc += A[r * n + m] * B[m * n + c];
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
__device__ void deflate(double* T, int n, double eps, double* keep) {
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
  const double half = (T[i * n + i] - T[(i + 1) * n + i + 1]) / 2.0;
  return half * half + T[i * n + i + 1] * T[(i + 1) * n + i];
}

// Householder QR of M (in place: R on and above the diagonal, the reflectors'
// v below it, dgeqr2) and q = H_0 H_1 ... H_{n-1} (dorg2r), in LAPACK's
// conventions; tau, ext: n doubles.  ext[j] is the last row of reflector j's
// nonzeros (a shifted Hessenberg has one or two below the diagonal): the
// products skip the exact zeros past it, which add nothing to a sum.
__device__ void qr_q(double* M, double* q, double* tau, double* ext, int n) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  for (int j = 0; j < n; ++j) {
    if (tid < 32) {
      double ss = 0.0, last = j;
      for (int r = j + 1 + lane; r < n; r += 32) {
        const double x = M[r * n + j];
        ss += x * x;
        if (x != 0.0) last = r;
      }
      ss = warp_sum(ss);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        last = fmax(last, __shfl_down_sync(RN_FULL, last, off));
      double scal = 0.0;
      if (lane == 0) {
        const double alpha = M[j * n + j], xnorm = sqrt(ss);
        double t = 0.0;
        if (xnorm != 0.0) {  // dlarfg: else H = I (tau = 0), R's diagonal alpha
          const double beta = -copysign(hypot(alpha, xnorm), alpha);
          t = (beta - alpha) / beta;
          scal = 1.0 / (alpha - beta);
          M[j * n + j] = beta;
        }
        tau[j] = t;
        ext[j] = last;
      }
      scal = __shfl_sync(RN_FULL, scal, 0);
      if (scal != 0.0)
        for (int r = j + 1 + lane; r < n; r += 32) M[r * n + j] *= scal;
    }
    __syncthreads();
    const double t = tau[j];
    const int e = static_cast<int>(ext[j]);
    if (t != 0.0) {
      for (int c = j + 1 + tid; c < n; c += nt) {
        double w = M[j * n + c];
        for (int r = j + 1; r <= e; ++r) w += M[r * n + j] * M[r * n + c];
        const double tw = t * w;
        M[j * n + c] -= tw;
        for (int r = j + 1; r <= e; ++r) M[r * n + c] -= M[r * n + j] * tw;
      }
    }
    __syncthreads();
  }
  for (int k = tid; k < n * n; k += nt) q[k] = (k / n == k % n) ? 1.0 : 0.0;
  __syncthreads();
  for (int j = n - 1; j >= 0; --j) {
    const double t = tau[j];
    const int e = static_cast<int>(ext[j]);
    if (t != 0.0) {
      for (int c = j + tid; c < n; c += nt) {
        double w = q[j * n + c];
        for (int r = j + 1; r <= e; ++r) w += M[r * n + j] * q[r * n + c];
        const double tw = t * w;
        q[j * n + c] -= tw;
        for (int r = j + 1; r <= e; ++r) q[r * n + c] -= M[r * n + j] * tw;
      }
    }
    __syncthreads();
  }
}

// M = T - a I (mode 0) or T^2 - a T + b I (mode 1: a double shift).
__device__ void shifted(double* M, const double* T, int n, int mode, double a, double b) {
  if (mode == 0) {
    for (int k = threadIdx.x; k < n * n; k += blockDim.x)
      M[k] = k / n == k % n ? T[k] - a : T[k];
    __syncthreads();
    return;
  }
  matmul(M, T, T, n, false);
  for (int k = threadIdx.x; k < n * n; k += blockDim.x)
    M[k] = (M[k] - a * T[k]) + (k / n == k % n ? b : 0.0);
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
          xv[0] = H[0] * H[0] + H[1] * H[n] - (2.0 * mur) * H[0] + (mur * mur + mui * mui);
          xv[1] = H[n] * (H[0] + H[n + 1] - 2.0 * mur);
          xv[2] = H[n] * H[2 * n + 1];
        } else {
          xv[0] = H[0] - mur;
          xv[1] = H[n];
        }
      } else {
        m = min(nb, n - j);
        for (int k = 0; k < m; ++k) xv[k] = M[(j + k) * n + j - 1];
      }
      double ss = 0.0;
      for (int k = 0; k < m; ++k) ss += xv[k] * xv[k];
      xv[0] += copysign(sqrt(ss), xv[0]);
      double vv = 0.0;
      for (int k = 0; k < m; ++k) vv += xv[k] * xv[k];
      sh[0] = vv == 0.0 ? 0.0 : 2.0 / vv;
      sh[1] = m;
    }
    __syncthreads();
    const double beta = sh[0];
    const int m = static_cast<int>(sh[1]);
    if (beta != 0.0) {
      for (int c = tid; c < n; c += nt) {
        double t = 0.0;
        for (int k = 0; k < m; ++k) t += xv[k] * M[(j + k) * n + c];
        for (int k = 0; k < m; ++k) M[(j + k) * n + c] -= beta * (xv[k] * t);
      }
      __syncthreads();
      for (int r = tid; r < n; r += nt) {
        double t = 0.0, tq = 0.0;
        for (int k = 0; k < m; ++k) {
          t += M[r * n + j + k] * xv[k];
          tq += q[r * n + j + k] * xv[k];
        }
        for (int k = 0; k < m; ++k) {
          M[r * n + j + k] -= beta * (t * xv[k]);
          q[r * n + j + k] -= beta * (tq * xv[k]);
        }
      }
    }
    __syncthreads();
  }
}

// Does key j come before key i in the stable ascending order (NaN last)?
__device__ __forceinline__ bool before(double kj, int j, double ki, int i) {
  const bool nj = isnan(kj), ni = isnan(ki);
  if (nj != ni) return ni;
  if (nj) return j < i;
  return kj < ki || (kj == ki && j < i);
}

__device__ __forceinline__ int stable_rank(const double* key, int n, int i) {
  const double ki = key[i];
  int r = 0;
  for (int j = 0; j < n; ++j) r += before(key[j], j, ki, i);
  return r;
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
// in rows i of ur, ui, solved from the bottom row up with its clamps; returns
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
  double* u = ur + static_cast<long long>(i) * n;
  double* v = ui + static_cast<long long>(i) * n;
  for (int m = 0; m < n; ++m) u[m] = v[m] = 0.0;
  bool skip = false;
  for (int l = n - 1; l >= 0; --l) {
    double cr = 0.0, ci = 0.0;
    for (int m = l + 1; m < n; ++m) {
      cr += T[l * n + m] * u[m];
      ci += T[l * n + m] * v[m];
    }
    const bool solve = l < s && !skip;
    bool solved_skip;
    if (l > 0 && T[l * n + l - 1] != 0.0) {
      // rows (l - 1, l) coupled: the complex 2x2 solved jointly
      const int lm1 = l - 1;
      double crm = 0.0, cim = 0.0;
      for (int m = l + 1; m < n; ++m) {
        crm += T[lm1 * n + m] * u[m];
        cim += T[lm1 * n + m] * v[m];
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
        u[lm1] = (x1r * detr + x1i * deti) / dmag2;
        v[lm1] = (x1i * detr - x1r * deti) / dmag2;
        u[l] = (x2r * detr + x2i * deti) / dmag2;
        v[l] = (x2i * detr - x2r * deti) / dmag2;
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
        u[l] = (-cr * denr - ci * deni) / dmag2;
        v[l] = (-ci * denr + cr * deni) / dmag2;
      }
      solved_skip = false;
    }
    // the eigen-index seeds its block at the block's end row e, or skips the
    // row after a seeded pair or a joint solve
    const bool at_e = !solve && l == e && !skip;
    if (at_e) {
      u[e] = ser;
      v[e] = sei;
      u[s] = ssr;
      if (is_pair) v[s] = ssi;
    }
    skip = solve ? solved_skip : (at_e && is_pair);
  }
  double nrm = 0.0, pr = 0.0, pi = 0.0;
  for (int m = 0; m < n; ++m) {
    nrm += u[m] * u[m] + v[m] * v[m];
    pr += Qs[(n - 1) * n + m] * u[m];
    pi += Qs[(n - 1) * n + m] * v[m];
  }
  return hypot(pr, pi) / fmax(sqrt(nrm), tiny);
}

template <typename A>
__global__ void __launch_bounds__(RN_THREADS, 1) realnonsym_cycle_kernel(RnArgs g) {
  extern __shared__ __align__(16) double rn_smem[];
  __shared__ double s_red[33];
  __shared__ double s_sh[4];
  __shared__ int s_int[8];  // brk, stop, mode, done, nev_eff, np_eff
  const int n = g.ncv, nn = n * n, tid = threadIdx.x, nt = blockDim.x;
  double* base = g.work != nullptr ? g.work : rn_smem;
  double* H0 = base;
  double* T = base + nn;  // the Schur form's T, then the chase's Hc
  double* Qa = base + 2 * nn;
  double* M = base + 3 * nn;
  double* q = base + 4 * nn;
  double* W = base + 5 * nn;
  double* vec = base + RN_MATRICES * nn;
  double *wr = vec, *wi = vec + n, *out = vec + 2 * n, *bnd = vec + 3 * n, *key = vec + 4 * n;
  double *wrs = vec + 5 * n, *wis = vec + 6 * n, *bs = vec + 7 * n, *swr = vec + 8 * n;
  double *swi = vec + 9 * n, *tau = vec + 10 * n, *keep = vec + 11 * n, *pst = vec + 12 * n;
  double *psec = vec + 13 * n, *xv = vec + 14 * n, *ext = vec + 15 * n;
  A* Hg = static_cast<A*>(g.H);
  double* pk = g.packet;
  const double rnorm = static_cast<double>(*static_cast<const A*>(g.rnorm));
  const int psize = P_HEAD + 3 * n + nn;

  for (int k = tid; k < psize; k += nt) pk[k] = 0.0;
  __syncthreads();
  if (tid == 0) {
    s_int[0] = *g.brk;
    pk[P_BRK] = s_int[0];
    pk[P_FORCE] = *g.force;
    pk[P_RNORM] = rnorm;
    for (int i = 0; i < 4; ++i) pk[P_CNT + i] = static_cast<double>(g.cnt[i]);
  }
  __syncthreads();
  if (s_int[0] != -1) return;

  for (int k = tid; k < nn; k += nt) {
    H0[k] = static_cast<double>(Hg[k]);
    T[k] = H0[k];
    Qa[k] = (k / n == k % n) ? 1.0 : 0.0;
  }
  __syncthreads();

  // ---- dneigh: the real Schur form by explicit QR sweeps ----
  for (int sweep = 0; sweep < g.sweeps; ++sweep) {
    deflate(T, n, g.eps_m, keep);
    if (tid == 0) {
      int m = -1;
      for (int i = 0; i < n - 1; ++i) {
        const bool ki = keep[i] != 0.0;
        const bool left0 = i == 0 || keep[i - 1] == 0.0;
        const bool right0 = i == n - 2 || keep[i + 1] == 0.0;
        // a converged complex 2x2 block (outer couplings gone) stays
        const bool conv2 = ki && left0 && right0 && bdisc(T, n, i) < 0.0;
        if (ki && !conv2) m = i;
      }
      s_int[1] = m < 0;
      if (m >= 0) {
        const double a11 = T[m * n + m], a12 = T[m * n + m + 1];
        const double a21 = T[(m + 1) * n + m], a22 = T[(m + 1) * n + m + 1];
        const double s = a11 + a22, p = a11 * a22 - a12 * a21;
        const double dsc = s * s / 4.0 - p;
        if (dsc >= 0.0) {  // a real Wilkinson shift: the root nearer a22
          const double r = sqrt(fmax(dsc, 0.0));
          const double mu1 = s / 2.0 + r, mu2 = s / 2.0 - r;
          s_int[2] = 0;
          s_sh[0] = fabs(mu1 - a22) < fabs(mu2 - a22) ? mu1 : mu2;
        } else {  // the conjugate pair as one double shift
          s_int[2] = 1;
          s_sh[0] = s;
          s_sh[1] = p;
        }
      }
    }
    __syncthreads();
    if (s_int[1]) break;
    shifted(M, T, n, s_int[2], s_sh[0], s_sh[1]);
    qr_q(M, q, tau, ext, n);
    W = similarity(T, Qa, q, W, n);
  }
  deflate(T, n, g.eps_m, nullptr);

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
    s_int[3] = done;
    s_int[4] = nev_eff;
    s_int[5] = np_eff;
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
  const int nev_eff = s_int[4], np_eff = s_int[5];
  if (s_int[3] || g.is_last) {  // exit before dnapps: H as it was
    for (int k = tid; k < nn; k += nt) pk[P_HEAD + 3 * n + k] = H0[k];
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
  int implicit = 0;
  for (int pass = 0; pass < 2; ++pass) {
    copy_mat(T, H0, n);
    set_eye(Qa, n);
    for (int i = 0; i < np0 && i < np_eff; ++i) {
      const double mur = swr[i], mui = swi[i];
      if (mui < 0.0) continue;  // a pair's second member: applied with the first
      if (pass == 0) {
        shifted(M, T, n, mui > 0.0, mui > 0.0 ? 2.0 * mur : mur, mur * mur + mui * mui);
        qr_q(M, q, tau, ext, n);
      } else {
        implicit_q(T, M, q, n, mur, mui, xv, s_sh + 2);
      }
      W = similarity(T, Qa, q, W, n);
      deflate(T, n, g.eps_m, nullptr);
    }
    if (pass == 1) break;
    // the explicit chase's loss in the kept columns (a near-zero pivot)
    matmul(W, H0, Qa, n, false);
    matmul(M, Qa, W, n, true);
    double lost = 0.0, hmax = 0.0;
    for (int k = tid; k < nn; k += nt) {
      if (k % n < nev_eff) lost = fmax(lost, fabs(M[k] - T[k]));
      hmax = fmax(hmax, fabs(H0[k]));
    }
    lost = block_max(lost, s_red);
    hmax = block_max(hmax, s_red);
    if (!(lost > g.eps23 * hmax)) break;
    implicit = 1;
  }

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
  cudaError_t err = cudaFuncSetAttribute(realnonsym_cycle_kernel<A>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  realnonsym_cycle_kernel<A><<<1, RN_THREADS, static_cast<size_t>(smem), st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace atpt

extern "C" {

// One cycle's reduced space (see the head note).  code 0: float, 2: double
// (the dtype codes of common.cuh); which: 0 LM, 1 SM, 2 LR, 3 SR, 4 LI, 5 SI.
// `work`: NULL where the workspace fits in shared memory, else a global buffer
// of its bytes (work_bytes).
int atpt_realnonsym_cycle(int code, int ncv, int nev0, int which, int is_last, int sweeps,
                          double tol, double eps23, double eps_m, double safmin, void* H,
                          const void* rnorm, const void* brk, const void* force, const void* cnt,
                          void* Q, void* sk, void* packet, void* work, void* stream) {
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
                       static_cast<double*>(work)};
  auto st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0: return atpt::realnonsym_cycle_typed<float>(g, st);
    case 2: return atpt::realnonsym_cycle_typed<double>(g, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

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
// chains: the QL sweeps and each QR factorization are sequential.  The
// design keeps its workspace in one block: T, the Ritz data, the
// accumulated Q, the current shift's Q and one work matrix (3 ncv^2 + 14 ncv
// values and 5 ncv doubles).  It lives in shared memory where it fits the
// 227 KB a block may use (ncv <= 135 in float32, ncv <= 95 in float64), and
// otherwise, with the same layout, in a global-memory buffer the caller
// passes (`work`; 1.6 MB at ncv = 256 in float64).  Thread 0 runs the sequential parts
// (implicit QL with Wilkinson shifts accumulating only the last row of the
// eigenvectors, as ARPACK's dstqrb; each Householder QR of the tridiagonal
// T - mu I, which touches O(1) entries per column); the block runs the
// parallel parts: the stable rank sorts of dsgets, forming each Q column by
// column (dorg2r's order), the three diagonals of Q^T T Q (a warp per
// entry) and Q <- Q q.
// The QR follows LAPACK's dgeqr2/dorg2r conventions (dlarfg's
// beta = -sign(alpha) dlapy2(alpha, |x|), tau = (beta - alpha) / beta, x
// scaled by 1 / (alpha - beta)), so Q and the new T agree with numpy's
// (LAPACK's) QR to rounding; the eigenvalues agree with LAPACK's
// eigensolver to rounding, not bit for bit.  The eigensolve and each QR run
// in double and round their results to the compute type, where numpy's
// float32 eigh and qr (which compute in double) round theirs: in float32
// throughout, the flagship's clustered spectrum converged in half the
// cycles to values 3e-4 above the top of its spectrum (PERF.md, section 6).
//
// An extension that stopped short (`brk` not -1: a step that met
// rnorm <= 0, or a doubtful event) leaves everything untouched: the host
// finishes the extension first and calls again.
#include "common.cuh"

#include <cfloat>

namespace atpt {
namespace {

constexpr int SYM_THREADS = 256;
constexpr int SYM_WARPS = SYM_THREADS / 32;
constexpr int SYM_VECTORS = 14;      // ncv-length vectors of A in shared memory
constexpr int SYM_DVECTORS = 5;      // ... and of double
constexpr int SYM_MAX_SMEM = 232448;  // bytes of shared memory a block may use
constexpr int SYM_QL_ITERS = 30;     // QL iterations allowed per eigenvalue

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
  void* work;       // the workspace in global memory, past the shared-memory limit
};

inline long long work_bytes(int ncv, int itemsize) {
  const long long n = ncv;
  return (3 * n * n + SYM_VECTORS * n) * itemsize + SYM_DVECTORS * n * 8;
}

template <typename A>
__device__ A lapy2(A x, A y) {
  const A xa = fabs(x), ya = fabs(y);
  const A w = fmax(xa, ya), z = fmin(xa, ya);
  if (z == A(0)) return w;
  const A t = z / w;
  return w * sqrt(A(1) + t * t);
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
// i and i + 1; z is the last row of the eigenvector matrix (the identity at
// entry).  On return d holds the eigenvalues (unsorted).  False if an
// eigenvalue took more than SYM_QL_ITERS iterations.
template <typename A>
__device__ bool tridiag_ql(A* d, A* e, A* z, int n, A eps) {
  e[n - 1] = A(0);
  for (int l = 0; l < n; ++l) {
    int iter = 0, m;
    do {
      for (m = l; m < n - 1; ++m)
        if (fabs(e[m]) <= eps * (fabs(d[m]) + fabs(d[m + 1]))) break;
      if (m == l) break;
      if (iter++ == SYM_QL_ITERS) return false;
      A g = (d[l + 1] - d[l]) / (A(2) * e[l]);
      A r = lapy2(g, A(1));
      g = d[m] - d[l] + e[l] / (g + copysign(r, g));
      A s = A(1), c = A(1), p = A(0);
      int i;
      for (i = m - 1; i >= l; --i) {
        const A f = s * e[i], bb = c * e[i];
        r = lapy2(f, g);
        e[i + 1] = r;
        if (r == A(0)) {
          d[i + 1] -= p;
          e[m] = A(0);
          break;
        }
        s = f / r;
        c = g / r;
        g = d[i + 1] - p;
        r = (d[i] - g) * s + A(2) * c * bb;
        p = s * r;
        d[i + 1] = g + p;
        g = c * r - bb;
        const A zf = z[i + 1];
        z[i + 1] = s * z[i] + c * zf;
        z[i] = c * z[i] - s * zf;
      }
      if (r == A(0) && i >= l) continue;
      d[l] -= p;
      e[l] = g;
      e[m] = A(0);
    } while (true);
  }
  return true;
}

// The reflectors of the Householder QR of T - mu I (T = tridiag(d, e)) by
// LAPACK's dgeqr2: reflector k is I - tau[k] v v^T with v = (1, v1[k]) on
// rows k, k + 1.  T - mu I is formed in A, as numpy forms it; the QR runs
// in double.  Row k of the partly reduced matrix holds two entries right
// of the diagonal that later columns read (r0, r1); every other entry a
// reflector meets is an original one or zero.
template <typename A>
__device__ void qr_reflectors(const A* d, const A* e, A mu, double* tau, double* v1, int n) {
  double r0 = static_cast<double>(static_cast<A>(d[0] - mu));
  double r1 = n > 1 ? static_cast<double>(e[0]) : 0.0;
  for (int k = 0; k < n - 1; ++k) {
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
  tau[n - 1] = 0.0;
  v1[n - 1] = 0.0;
}

// Column c of q = H_0 H_1 ... H_{n-2} (dorg2r's order: reflectors last to
// first on e_c), in double, rounded to A into q.  Reflector i touches rows
// i and i + 1 only, so row i + 1 is final once it has run: one pair of
// values is carried down the column.
template <typename A>
__device__ void q_column(const double* tau, const double* v1, A* q, int n, int c) {
  for (int r = c + 2; r < n; ++r) q[r * n + c] = A(0);
  int i = min(c, n - 2);
  double cur = c <= n - 2 ? 1.0 : 0.0, carry = c <= n - 2 ? 0.0 : 1.0;
  for (; i >= 0; --i) {
    if (tau[i] != 0.0) {
      const double w = cur + carry * v1[i];
      const double t = -tau[i] * w;
      cur = cur + t;
      carry = carry + v1[i] * t;
    }
    q[(i + 1) * n + c] = static_cast<A>(carry);
    carry = cur;
    cur = 0.0;
  }
  q[c] = static_cast<A>(carry);
}

// GMEM: the workspace is g.work (global memory), else dynamic shared memory;
// one layout for both.
template <typename A, bool GMEM>
__global__ void __launch_bounds__(SYM_THREADS, 1) sym_cycle_kernel(SymArgs g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n = g.ncv, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // double vectors first (8-byte aligned), then the A matrices and vectors
  double* dv = reinterpret_cast<double*>(GMEM ? static_cast<unsigned char*>(g.work) : smem_raw);
  double *ev = dv, *ew = dv + n, *z = dv + 2 * n, *tau = dv + 3 * n, *v1 = dv + 4 * n;
  A* Q = reinterpret_cast<A*>(dv + SYM_DVECTORS * n);
  A* q = Q + n * n;
  A* W = q + n * n;
  A* v = W + n * n;
  A *dc = v, *ec = v + n, *evs = v + 2 * n, *bnd = v + 3 * n, *rs = v + 4 * n;
  A *bs = v + 5 * n, *rsi = v + 6 * n, *bsi = v + 7 * n, *sh = v + 8 * n;
  A *dn = v + 9 * n, *en = v + 10 * n, *key = v + 11 * n, *up = v + 12 * n, *lo = v + 13 * n;
  __shared__ int s_brk, s_nconv, s_nev, s_np, s_done, s_info;
  A* a = static_cast<A*>(g.a);
  A* b = static_cast<A*>(g.b);
  double* pk = g.packet;
  const A rnorm = *static_cast<const A*>(g.rnorm);
  const int np0 = n - g.nev0;

  if (tid == 0) {
    s_brk = *g.brk;
    pk[P_BRK] = s_brk;
    pk[P_FORCE] = *g.force;
    pk[P_RNORM] = static_cast<double>(rnorm);
    for (int i = 0; i < 4; ++i) pk[P_CNT + i] = static_cast<double>(g.cnt[i]);
  }
  __syncthreads();
  if (s_brk != -1) return;

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
    return;
  }
  __syncthreads();
  // ---- exact shifts: the np_eff least wanted, largest bound first ----
  for (int i = tid; i < np0; i += SYM_THREADS)
    key[i] = i < np_eff ? -fabs(bsi[i]) : static_cast<A>(INFINITY);
  for (int i = tid; i < n * n; i += SYM_THREADS) Q[i] = (i / n == i % n) ? A(1) : A(0);
  __syncthreads();
  for (int i = tid; i < np0; i += SYM_THREADS) sh[stable_rank(key, np0, i)] = rsi[i];
  __syncthreads();
  for (int s = 0; s < np_eff; ++s) {
    if (tid == 0) qr_reflectors(dc, ec, sh[s], tau, v1, n);
    __syncthreads();
    // q = H_0 H_1 ... H_{n-2}, one column per thread
    for (int c = tid; c < n; c += SYM_THREADS) q_column(tau, v1, q, n, c);
    __syncthreads();
    // the three diagonals of (q^T T) q: entry (i, j) = sum_r M[i][r] q[r][j]
    // with M = q^T T, for (i, i), (i, i + 1) and (i + 1, i); one warp per
    // entry, its lanes over r, then the warp's tree
    for (int t = warp; t < 3 * n; t += SYM_WARPS) {
      const int kind = t / n, i = t % n;
      if (kind > 0 && i == n - 1) continue;
      const int row = kind == 2 ? i + 1 : i, col = kind == 1 ? i + 1 : i;
      A acc = A(0);
      for (int r = lane; r < n; r += 32) {
        A m = q[r * n + row] * dc[r];
        if (r > 0) m = q[(r - 1) * n + row] * ec[r - 1] + m;
        if (r < n - 1) m = m + q[(r + 1) * n + row] * ec[r];
        acc += m * q[r * n + col];
      }
      acc = warp_sum(acc);
      if (lane == 0) (kind == 0 ? dn : kind == 1 ? up : lo)[i] = acc;
    }
    // Q <- Q q (q is upper Hessenberg)
    for (int k = tid; k < n * n; k += SYM_THREADS) {
      const int r = k / n, c = k % n;
      A acc = A(0);
      for (int j = 0; j <= min(c + 1, n - 1); ++j) acc += Q[r * n + j] * q[j * n + c];
      W[k] = acc;
    }
    __syncthreads();
    for (int i = tid; i < n; i += SYM_THREADS)  // symmetrized
      en[i] = i < n - 1 ? A(0.5) * (up[i] + lo[i]) : A(0);
    A* swap = Q;
    Q = W;
    W = swap;
    for (int i = tid; i < n; i += SYM_THREADS) {
      dc[i] = dn[i];
      ec[i] = en[i];
    }
    __syncthreads();
  }
  // ---- deflation sweep, subdiagonal sign normalization (dsapps) ----
  if (tid == 0) {
    const A eps_m = static_cast<A>(g.eps_m);
    A phi = A(1);
    dn[0] = phi;  // dn: the diagonal similarity's signs
    for (int i = 0; i < n - 1; ++i) {
      const A big = fabs(dc[i]) + fabs(dc[i + 1]);
      if (fabs(ec[i]) <= eps_m * big) ec[i] = A(0);
      phi *= ec[i] >= A(0) ? A(1) : A(-1);
      dn[i + 1] = phi;
      ec[i] = fabs(ec[i]);
    }
  }
  __syncthreads();
  A* Qg = static_cast<A*>(g.Q);
  for (int k = tid; k < n * n; k += SYM_THREADS) Qg[k] = Q[k] * dn[k % n];
  for (int i = tid; i < n; i += SYM_THREADS) {
    a[i] = dc[i];
    if (i < n - 1) b[i] = ec[i];
    pk[P_HEAD + i] = static_cast<double>(dc[i]);
    pk[P_HEAD + n + i] = i < n - 1 ? static_cast<double>(ec[i]) : static_cast<double>(rnorm);
  }
  if (tid == 0) {
    A* sk = static_cast<A*>(g.sk);
    sk[0] = Q[(n - 1) * n + nev_eff - 1] * dn[nev_eff - 1];
    sk[1] = nev_eff < n ? ec[nev_eff - 1] : A(0);
  }
}

// The workspace in shared memory where it fits, else in g.work, which must
// then hold work_bytes (8-byte aligned).
template <typename A>
int sym_cycle_typed(const SymArgs& g, cudaStream_t st) {
  if (g.ncv < 2 || g.nev0 < 1 || g.nev0 >= g.ncv || g.which < LA || g.which > BE)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = work_bytes(g.ncv, sizeof(A));
  if (bytes > SYM_MAX_SMEM) {
    if (g.work == nullptr || (reinterpret_cast<uintptr_t>(g.work) & 7u) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    sym_cycle_kernel<A, true><<<1, SYM_THREADS, 0, st>>>(g);
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaFuncSetAttribute(sym_cycle_kernel<A, false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  sym_cycle_kernel<A, false><<<1, SYM_THREADS, static_cast<int>(bytes), st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace atpt

extern "C" {

// One cycle's reduced space (see the head note).  code 0: float, 2: double
// (the dtype codes of common.cuh); which: 0 LA, 1 SA, 2 LM, 3 SM, 4 BE.
// `work`: NULL, or a global buffer of the workspace's bytes where it does not
// fit shared memory.
int atpt_sym_cycle(int code, int ncv, int nev0, int which, int inflate, int is_last,
                   double tol, double eps23, double eps_m, void* a, void* b, const void* rnorm,
                   const void* brk, const void* force, const void* cnt, void* Q, void* sk,
                   void* packet, void* work, void* stream) {
  const atpt::SymArgs g{ncv, nev0, which, inflate, is_last, tol, eps23, eps_m, a, b, rnorm,
                        static_cast<const int*>(brk), static_cast<const int*>(force),
                        static_cast<const long long*>(cnt), Q, sk, static_cast<double*>(packet),
                        work};
  auto st = static_cast<cudaStream_t>(stream);
  switch (code) {
    case 0: return atpt::sym_cycle_typed<float>(g, st);
    case 2: return atpt::sym_cycle_typed<double>(g, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"

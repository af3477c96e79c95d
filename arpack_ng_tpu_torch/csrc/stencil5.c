/* The 2-D Dirichlet Laplacian's 5-point stencil (diagonal 4, neighbours
 * -1) on an nx * nx grid as a C operator for the C ABI's matrix-free
 * entry points (atpu_eigsh_matvec_s / _d): ctx points at an int64_t nx.
 * The function's first argument is atpu_int, 64 bits wide here (the
 * library's default LP64 interface).  Built by
 * arpack_ng_tpu_torch/native_capi.py (build_stencil). */
#include <stdint.h>

#define STENCIL(T, NAME)                                                   \
  void NAME(int64_t n, const T *x, T *y, void *ctx) {                     \
    const int64_t nx = *(const int64_t *)ctx;                              \
    for (int64_t i = 0; i < n; ++i) {                                      \
      const int64_t r = i / nx, c = i % nx;                                \
      T v = (T)4 * x[i];                                                   \
      if (r > 0) v -= x[i - nx];                                           \
      if (r + 1 < nx) v -= x[i + nx];                                      \
      if (c > 0) v -= x[i - 1];                                            \
      if (c + 1 < nx) v -= x[i + 1];                                       \
      y[i] = v;                                                            \
    }                                                                      \
  }

STENCIL(float, atpu_stencil5_s)
STENCIL(double, atpu_stencil5_d)

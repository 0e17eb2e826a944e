// Batched block-tridiagonal solve (block Thomas) with m x m blocks,
// 1 <= m <= 8, for Hopper (sm_90a): the canopy's longwave (m = 3, f64) and
// MLC (m = 4) solves and the block plans of the compiled steppers.
//
// block_thomas_small — replaces the JAX package's two lax.scan sweeps of
//   block_thomas, mpp_tpu/ops/block_thomas.py:22-122 (forward scan at
//   l.113, back substitution at l.120), with small_solve (l.45-86) at
//   each level.  There is no pl.pallas_call on this path.
//
// What it computes: x with T x = b, exactly the function of the plain
// version ops/block_thomas.block_thomas: per level k
//   denom_k = D_k - L_k Cp_{k-1},
//   [Cp_k | dp_k] = small_solve(denom_k, [U_k | b_k - L_k dp_{k-1}]),
// then x_k = dp_k - Cp_k x_{k+1}.  small_solve's contract holds inside
// each block: m = 1 divides; m = 2 takes the adjugate divided by det, no
// pivoting; 3 <= m <= 8 runs Gauss-Jordan with partial pivoting: at
// column j the pivot is the row of the largest |entry| at rows >= j, ties
// to the lowest row and a NaN counted as the largest (the first NaN
// wins), as torch.argmax and jnp.argmax pick it; rows j and p swap, every
// other row is eliminated, and each row is divided by its diagonal.  No
// pivoting across levels (the eliminated diagonal blocks must stay
// invertible: block diagonal dominance).  L[s, 0] and U[s, n-1] are never
// read.  Divisions are IEEE `/`; the products' summation order and the
// contraction into FMAs may differ from cuBLAS's, so kernel and plain
// agree to rounding, not bit for bit.  The small solve repeats the plain
// form's operations one for one: its products are rounded apart from the
// sums (mul(), never contracted into an FMA), whole rows swap and every
// row but the pivot row is updated in every column, as the plain form's
// vectorized step does, so its own results are the plain form's for the
// same block.
// NaN: a system's lanes exchange values only among themselves, so a NaN
// in one system's blocks reaches that system's x and no other's.
//
// Layout: L, D, U row-major [nsys, n, m, m], b and x [nsys, n, m],
// contiguous (the wrapper flattens leading dims into nsys); cp a global
// scratch [nsys, n, m, m] (the first n-1 levels' Cp, read back by the back
// substitution; dp is kept in x and overwritten by the solution).
// Pointers are device pointers, the launch goes on the caller's stream,
// nothing is allocated or synchronised here, and the launcher returns
// cudaGetLastError() (0 on success).  f32 and f64, any n >= 1.
//
// Bound on the H100: bytes.  L, D, U and b are read once and x written once:
// (3 m^2 + 2 m) values a level; at [4096, 93, 4] f64 170.7 MB, 0.051 ms at
// 3.35 TB/s.  The operations (~500 flops a level at m = 4) take under
// 0.006 ms.  What holds it off the bound is the dependent chain of each
// level (m pivot steps, each a shuffle, a division and a row update) and
// the Cp scratch (n m^2 values written and read back a system, 57 % more
// bytes at m = 4; its last levels are still in L2 when the back
// substitution reads them first).
//
// Design: a system is m consecutive lanes of a warp, lane i holding block
// row i (floor(32 / m) systems a warp, one warp a block, so 4096 systems
// at m = 4 are 512 warps, ~4 an SM).  A level: lane i reads row i of L_k,
// D_k, U_k and b_k (the next level's rows are loaded before this level's
// chain, so the load latency hides behind it); gets row r of Cp_{k-1} and
// dp_{k-1}[r] from lane r by shuffles for its row of the products; then
// the m pivot steps: every lane of the system scans column j of rows
// j..m-1 by shuffles in row order (the same pivot in every lane), takes
// the pivot row and, at rows j and p, the swapped row by shuffles, and
// updates its row; last it divides its row by its diagonal and holds row i
// of Cp_k and dp_k[i] for the next level.  Every array index is static
// (m is a template parameter, the loops unrolled), so the rows stay in
// registers.  The back substitution runs the levels down with a ring of
// kBackAhead levels of Cp and dp loaded ahead of the chain.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
// levels of Cp and dp the back substitution loads ahead of its chain
constexpr int kBackAhead = 4;

template <typename T>
__device__ __forceinline__ T from(T v, int lane) {
  return __shfl_sync(kAll, v, lane);
}

// a product rounded on its own (the plain form's separate multiply)
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}


// true where a beats b for the pivot: larger, or a NaN against a number
template <typename T>
__device__ __forceinline__ bool beats(T a, T b) {
  return a > b || (a != a && b == b);
}

template <typename T, int M>
__global__ void __launch_bounds__(kWarp)
block_thomas_small_kernel(const T* __restrict__ L, const T* __restrict__ D,
                          const T* __restrict__ U, const T* __restrict__ b,
                          T* cp, T* x, int nsys, int n) {
  constexpr int S = kWarp / M;          // systems a warp
  constexpr int W = 2 * M + 1;          // [denom | U | rhs] of a row
  const int lane = threadIdx.x;
  const int slot = lane / M;
  const int i = lane - slot * M;        // this lane's block row
  const int base = slot * M;            // the lane of row 0
  const long long s = static_cast<long long>(blockIdx.x) * S + slot;
  const bool live = slot < S && s < nsys;
  // row i of the system's level 0: blocks and b / x
  const size_t r0 = live ? (static_cast<size_t>(s) * n * M + i) * M : 0;
  const size_t v0 = live ? static_cast<size_t>(s) * n * M + i : 0;

  // this level's rows of L, D, U and b; dead lanes hold zeros
  T lr[M], dr[M], ur[M], br;
  auto load = [&](int k, T (&l)[M], T (&d)[M], T (&u)[M], T& bv) {
    const size_t o = r0 + static_cast<size_t>(k) * M * M;
#pragma unroll
    for (int c = 0; c < M; ++c) {
      l[c] = (live && k > 0) ? L[o + c] : T(0);
      d[c] = live ? D[o + c] : T(0);
      u[c] = (live && k < n - 1) ? U[o + c] : T(0);
    }
    bv = live ? b[v0 + static_cast<size_t>(k) * M] : T(0);
  };
  load(0, lr, dr, ur, br);

  T cpr[M];                              // row i of Cp_{k-1}
#pragma unroll
  for (int c = 0; c < M; ++c) cpr[c] = T(0);
  T dpr = T(0);                          // dp_{k-1}[i]
  for (int k = 0; k < n; ++k) {
    T nl[M], nd[M], nu[M], nb;
    if (k + 1 < n) load(k + 1, nl, nd, nu, nb);
    T row[W];
    T rhs = br;
#pragma unroll
    for (int c = 0; c < M; ++c) row[c] = dr[c];
    if (k > 0) {
      // L_k Cp_{k-1} and L_k dp_{k-1}, row i: row r of Cp from lane r
      T acc[M], accb = T(0);
#pragma unroll
      for (int c = 0; c < M; ++c) acc[c] = T(0);
#pragma unroll
      for (int r = 0; r < M; ++r) {
#pragma unroll
        for (int c = 0; c < M; ++c)
          acc[c] = fma(lr[r], from(cpr[c], base + r), acc[c]);
        accb = fma(lr[r], from(dpr, base + r), accb);
      }
#pragma unroll
      for (int c = 0; c < M; ++c) row[c] = dr[c] - acc[c];
      rhs = br - accb;
    }
#pragma unroll
    for (int c = 0; c < M; ++c) row[M + c] = ur[c];
    row[2 * M] = rhs;

    if constexpr (M == 1) {
      cpr[0] = row[1] / row[0];
      dpr = row[2] / row[0];
    } else if constexpr (M == 2) {
      // the adjugate divided by det (no pivoting): the other row by shuffle
      T o[W];
#pragma unroll
      for (int c = 0; c < W; ++c) o[c] = from(row[c], base + 1 - i);
      const bool top = i == 0;
      const T a = top ? row[0] : o[0], bq = top ? row[1] : o[1];
      const T cq = top ? o[0] : row[0], d = top ? o[1] : row[1];
      const T det = mul(a, d) - mul(bq, cq);
#pragma unroll
      for (int c = 0; c < M + 1; ++c) {
        const T B0 = top ? row[M + c] : o[M + c];
        const T B1 = top ? o[M + c] : row[M + c];
        const T v = top ? mul(d, B0) - mul(bq, B1)
                        : mul(-cq, B0) + mul(a, B1);
        if (c < M) cpr[c] = v / det;
        else dpr = v / det;
      }
    } else {
#pragma unroll
      for (int j = 0; j < M; ++j) {
        // the pivot: rows j..M-1 of column j, scanned in row order
        int p = j;
        T best = fabs(from(row[j], base + j));
#pragma unroll
        for (int r = j + 1; r < M; ++r) {
          const T v = fabs(from(row[j], base + r));
          if (beats(v, best)) {
            best = v;
            p = r;
          }
        }
        // rows j and p swap; every lane gets the pivot row (row p's)
        T piv[W];
#pragma unroll
        for (int c = 0; c < W; ++c) {
          const T a = from(row[c], base + p);
          const T o = from(row[c], base + j);
          piv[c] = a;
          if (i == j) row[c] = a;
          else if (i == p) row[c] = o;
        }
        // every row minus fac times the pivot row, fac 0 at row j
        const T fac = i == j ? T(0) : row[j] / piv[j];
#pragma unroll
        for (int c = 0; c < W; ++c) row[c] = row[c] - mul(fac, piv[c]);
      }
      T diag = row[0];
#pragma unroll
      for (int c = 1; c < M; ++c)
        if (c == i) diag = row[c];
#pragma unroll
      for (int c = 0; c < M; ++c) cpr[c] = row[M + c] / diag;
      dpr = row[2 * M] / diag;
    }

    if (live) {
      if (k < n - 1) {
        T* out = cp + r0 + static_cast<size_t>(k) * M * M;
#pragma unroll
        for (int c = 0; c < M; ++c) out[c] = cpr[c];
      }
      x[v0 + static_cast<size_t>(k) * M] = dpr;
    }
    if (k + 1 < n) {
#pragma unroll
      for (int c = 0; c < M; ++c) {
        lr[c] = nl[c];
        dr[c] = nd[c];
        ur[c] = nu[c];
      }
      br = nb;
    }
  }

  // back substitution: x_k = dp_k - Cp_k x_{k+1}, x_{n-1} = dp_{n-1}; the
  // ring holds levels k, k-1, .. of row i of Cp (this lane's own stores)
  // and of dp (in x), loaded kBackAhead levels ahead
  T xn = dpr;
  T rc[kBackAhead][M], rd[kBackAhead];
  auto fetch = [&](int k, T (&c_)[M], T& d_) {
    if (live && k >= 0) {
      const T* src = cp + r0 + static_cast<size_t>(k) * M * M;
#pragma unroll
      for (int c = 0; c < M; ++c) c_[c] = src[c];
      d_ = x[v0 + static_cast<size_t>(k) * M];
    } else {
#pragma unroll
      for (int c = 0; c < M; ++c) c_[c] = T(0);
      d_ = T(0);
    }
  };
#pragma unroll
  for (int q = 0; q < kBackAhead; ++q) fetch(n - 2 - q, rc[q], rd[q]);
  for (int k0 = n - 2; k0 >= 0; k0 -= kBackAhead) {
#pragma unroll
    for (int q = 0; q < kBackAhead; ++q) {
      const int k = k0 - q;
      if (k < 0) break;                  // the same in every lane
      T acc = T(0);
#pragma unroll
      for (int c = 0; c < M; ++c) acc = fma(rc[q][c], from(xn, base + c), acc);
      xn = rd[q] - acc;
      if (live) x[v0 + static_cast<size_t>(k) * M] = xn;
      fetch(k - kBackAhead, rc[q], rd[q]);
    }
  }
}

template <typename T, int M>
int launch(const void* L, const void* D, const void* U, const void* b,
           void* cp, void* x, int nsys, int n, cudaStream_t stream) {
  constexpr int S = kWarp / M;
  const long long blocks = (static_cast<long long>(nsys) + S - 1) / S;
  block_thomas_small_kernel<T, M><<<static_cast<unsigned>(blocks), kWarp, 0,
                                    stream>>>(
      static_cast<const T*>(L), static_cast<const T*>(D),
      static_cast<const T*>(U), static_cast<const T*>(b), static_cast<T*>(cp),
      static_cast<T*>(x), nsys, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_m(const void* L, const void* D, const void* U, const void* b,
             void* cp, void* x, int nsys, int n, int m, void* stream) {
  if (nsys <= 0 || n <= 0) return cudaSuccess;
  if (n > 1 && cp == nullptr) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return launch<T, 1>(L, D, U, b, cp, x, nsys, n, s);
    case 2: return launch<T, 2>(L, D, U, b, cp, x, nsys, n, s);
    case 3: return launch<T, 3>(L, D, U, b, cp, x, nsys, n, s);
    case 4: return launch<T, 4>(L, D, U, b, cp, x, nsys, n, s);
    case 5: return launch<T, 5>(L, D, U, b, cp, x, nsys, n, s);
    case 6: return launch<T, 6>(L, D, U, b, cp, x, nsys, n, s);
    case 7: return launch<T, 7>(L, D, U, b, cp, x, nsys, n, s);
    case 8: return launch<T, 8>(L, D, U, b, cp, x, nsys, n, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// cp: the scratch [nsys, n, m, m] (may be null when n == 1)
int mpp_block_thomas_small_f32(const void* L, const void* D, const void* U,
                               const void* b, void* cp, void* x, int nsys,
                               int n, int m, void* stream) {
  return launch_m<float>(L, D, U, b, cp, x, nsys, n, m, stream);
}

int mpp_block_thomas_small_f64(const void* L, const void* D, const void* U,
                               const void* b, void* cp, void* x, int nsys,
                               int n, int m, void* stream) {
  return launch_m<double>(L, D, U, b, cp, x, nsys, n, m, stream);
}

}  // extern "C"

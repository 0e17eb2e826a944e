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
// form's operations one for one in both forms: its products are rounded
// apart from the sums (mul(), never contracted into an FMA), whole rows
// swap and every row but the pivot row is updated in every column (the
// pivot row too, by 0 times itself), as the plain form's vectorized step
// does, so its own results are the plain form's for the same block.
// NaN: a system's values meet no other system's (one thread, or lanes that
// exchange values only among themselves), so a NaN in one system's blocks
// reaches that system's x and no other's.
//
// Layout: L, D, U row-major [nsys, n, m, m], b and x [nsys, n, m],
// contiguous (the wrapper flattens leading dims into nsys); scr a global
// scratch (the first n-1 levels' Cp, and in the thread form dp, read back
// by the back substitution; mpp_block_thomas_small_scratch gives its size).
// Pointers are device pointers, the launch goes on the caller's stream,
// nothing is allocated or synchronised here, and the launcher returns
// cudaGetLastError() (0 on success).  f32 and f64, any n >= 1.
//
// Bound on the H100: bytes.  L, D, U and b are read once and x written once:
// (3 m^2 + 2 m) values a level; at [4096, 93, 4] f64 170.7 MB, 0.051 ms at
// 3.35 TB/s.  The operations (~500 flops a level at m = 4) take under
// 0.006 ms.  What holds the kernel off it is a system's dependent chain of
// a level, 93 levels deep: 4096 systems are 128 warps at a system a thread
// (one scheduler of an SM's four busy) or 512 at m lanes a system, so
// nothing hides the chain.  In the thread form the solve, not the loads,
// sets the time, and a level's time follows the count of its IEEE
// divisions (32 at m = 4), each a dependent DFMA chain closed by the
// library's slow-path branch, run one after another (PERF.md section 6,
// row 13; tools/resident_variants.py --bts's loads_only build).
//
// Two forms; the wrapper's rule (hopper_kernels.bts_form) picks one by m and
// dtype, one threshold a dtype, from their device times at the canopy's
// [4096, 93, m] (tools/resident_variants.py --bts-forms): "thread" to m = 3
// in f64 and m = 5 in f32, "lanes" past that (at f32 m = 2, which no path
// solves, lanes read faster).
//
// "thread" (m <= kThreadMax): one system a thread, 32 systems a block.  A
//   level's [denom | U | rhs], Cp_{k-1} and dp_{k-1} live in registers (~60
//   values at m = 4), every index static, so the pivot scan is compares and
//   selects, the swap selects, the row updates independent products and
//   differences: no shuffles, no barriers.  Each thread streams its own
//   system's level blocks through a ring of S stages in its own part of
//   shared memory with cp.async (16 bytes a copy where the blocks are
//   16-byte aligned, else a value a copy), S - 1 levels ahead of its chain
//   (S to 12, kRingBytes a block).  A thread's part starts an odd number of
//   16-byte units from its neighbour's, so the 16-byte shared loads of a
//   quarter warp hit distinct banks.  [Cp_k | dp_k] goes to the scratch
//   level-major within a block, 16-byte piece j of lane l at ((k * pieces +
//   j) * 32 + l), so a warp's stores and the back substitution's reads of a
//   piece are 512 contiguous bytes; the back substitution streams them
//   through its own ring the same way.
// "lanes" (the kernel's first form, m <= 8): a system is m consecutive
//   lanes of a warp, lane i holding block row i (floor(32 / m) systems a
//   warp, one warp a block).  A level: lane i reads row i of L_k, D_k, U_k
//   and b_k (the next level's rows are loaded before this level's chain,
//   so the load latency hides behind it); gets row r of Cp_{k-1} and
//   dp_{k-1}[r] from lane r by shuffles for its row of the products; then
//   the m pivot steps: every lane of the system scans column j of rows
//   j..m-1 by shuffles in row order (the same pivot in every lane); lane p
//   takes row j by shuffles and every other lane row p, the pivot row (one
//   shuffle a value, where the first form took both rows in every lane),
//   and each lane updates its row; last it divides its row by its
//   diagonal and holds row i of Cp_k and dp_k[i] for the next level.
//   Every array index is static (m is a template parameter, the loops
//   unrolled), so the rows stay in registers.  Where m does not divide 32,
//   the lanes a warp's systems leave over hold identity blocks and the
//   quotients go through quot(): `/` sends every zero numerator to its
//   slow path, and with zero blocks there every division of those lanes
//   went there while the warp waited (why m = 3 once read slower than m =
//   4).  Cp goes to the scratch strided like D; the back substitution runs
//   the levels down with a ring of kBackAhead levels of Cp and dp loaded
//   ahead of the chain.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "column_tiles.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
// levels of Cp and dp the lanes form's back substitution loads ahead
constexpr int kBackAhead = 4;
// the thread form: systems a block (a lane each), the largest m it is
// built for, and the shared memory its rings aim at a block
constexpr int kSys = 32;
constexpr int kThreadMax = 5;
constexpr int kRingBytes = 160 * 1024;
// the forms, as the launcher's `form` argument
constexpr int kThread = 0, kLanes = 1;

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

// a / d, the bits of `/`, with no slow path for a zero numerator: `/`
// sends every zero numerator to its slow path (a call), and a zero over a
// finite nonzero d is the signed zero a * d, so the division runs on 1
// and the zero is taken from the product
template <typename T>
__device__ __forceinline__ T quot(T a, T d) {
  const bool zero = a == T(0) && d != T(0) && fabs(d) < T(INFINITY);
  const T q = (zero ? T(1) : a) / d;
  return zero ? mul(a, d) : q;
}

__host__ __device__ constexpr int round_up(int a, int q) {
  return (a + q - 1) / q * q;
}
// the smallest odd multiple of q that is >= a
__host__ __device__ constexpr int odd_up(int a, int q) {
  return (round_up(a, q) / q % 2 ? round_up(a, q) / q
                                 : round_up(a, q) / q + 1) * q;
}
__host__ __device__ constexpr int clamp_to(int a, int lo, int hi) {
  return a < lo ? lo : (a > hi ? hi : a);
}

// The thread form's shared layout for m x m blocks of T: a level's record
// L | D | U | b, each section 16-byte aligned (PB, PV values); the back
// substitution's record [Cp | dp] (Q values, Q / V 16-byte pieces); S and
// SB stages; a thread's part PER values (an odd number of 16-byte units).
template <typename T, int M>
struct ThreadShape {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int PB = round_up(M * M, V);
  static constexpr int PV = round_up(M, V);
  static constexpr int REC = 3 * PB + PV;
  static constexpr int Q = round_up(M * (M + 1), V);
  static constexpr int BUDGET = kRingBytes / kSys / sizeof(T);
  static constexpr int S = clamp_to(BUDGET / REC, 2, 12);
  static constexpr int SB = clamp_to(BUDGET / Q, 2, 12);
  static constexpr int PER = odd_up(S * REC > SB * Q ? S * REC : SB * Q, V);
  static constexpr int SMEM = kSys * PER * sizeof(T);
};

template <typename T> struct Vec16;
template <> struct Vec16<double> { using type = double2; };
template <> struct Vec16<float> { using type = float4; };

__device__ __forceinline__ void unpack(const double2& v, double* e) {
  e[0] = v.x;
  e[1] = v.y;
}
__device__ __forceinline__ void unpack(const float4& v, float* e) {
  e[0] = v.x;
  e[1] = v.y;
  e[2] = v.z;
  e[3] = v.w;
}
__device__ __forceinline__ double2 pack(const double* e) {
  return make_double2(e[0], e[1]);
}
__device__ __forceinline__ float4 pack(const float* e) {
  return make_float4(e[0], e[1], e[2], e[3]);
}

// cp.async of 16 bytes, global -> shared, past L1; a miss fetches the
// 256-byte block (the next levels of the same system follow)
__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

// the copies of N values src -> dst (dst 16-byte aligned): 16 bytes a copy
// where `vec` (src 16-byte aligned, N a multiple of 16 bytes), else a value
// a copy; does not commit
template <typename T, int N>
__device__ __forceinline__ void copy_in(T* dst, const T* src, bool vec) {
  constexpr int V = 16 / sizeof(T);
  if constexpr (N % V == 0) {
    if (vec) {
#pragma unroll
      for (int q = 0; q < N; q += V) cp16(dst + q, src + q);
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < N; ++q) mpp::cp_async<sizeof(T)>(dst + q, src + q);
}

// N values from 16-byte aligned shared memory, 16 bytes a load
template <typename T, int N>
__device__ __forceinline__ void lds(const T* p, T (&out)[N]) {
  using VT = typename Vec16<T>::type;
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int q = 0; q < N; q += V) {
    T e[V];
    unpack(*reinterpret_cast<const VT*>(p + q), e);
#pragma unroll
    for (int t = 0; t < V; ++t)
      if (q + t < N) out[q + t] = e[t];
  }
}

// One level of one system in registers: [Cp_k | dp_k] from the level's
// blocks and [Cp_{k-1} | dp_{k-1}] (cpv, dpv, overwritten); `first` (k =
// 0): no products; `last` (k = n - 1): U_k taken as zero.
template <typename T, int M>
__device__ __forceinline__ void level_step(const T (&lr)[M * M],
                                           const T (&dr)[M * M],
                                           const T (&ur)[M * M],
                                           const T (&br)[M], bool first,
                                           bool last, T (&cpv)[M][M],
                                           T (&dpv)[M]) {
  constexpr int W = 2 * M + 1;
  T w[M][W];
  if (!first) {
    // L_k Cp_{k-1} and L_k dp_{k-1}
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc[M], accb = T(0);
#pragma unroll
      for (int c = 0; c < M; ++c) acc[c] = T(0);
#pragma unroll
      for (int r = 0; r < M; ++r) {
#pragma unroll
        for (int c = 0; c < M; ++c)
          acc[c] = fma(lr[i * M + r], cpv[r][c], acc[c]);
        accb = fma(lr[i * M + r], dpv[r], accb);
      }
#pragma unroll
      for (int c = 0; c < M; ++c) w[i][c] = dr[i * M + c] - acc[c];
      w[i][2 * M] = br[i] - accb;
    }
  } else {
#pragma unroll
    for (int i = 0; i < M; ++i) {
#pragma unroll
      for (int c = 0; c < M; ++c) w[i][c] = dr[i * M + c];
      w[i][2 * M] = br[i];
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int c = 0; c < M; ++c) w[i][M + c] = last ? T(0) : ur[i * M + c];

  if constexpr (M == 1) {
    cpv[0][0] = w[0][1] / w[0][0];
    dpv[0] = w[0][2] / w[0][0];
  } else if constexpr (M == 2) {
    // the adjugate divided by det (no pivoting)
    const T a = w[0][0], bq = w[0][1], cq = w[1][0], d = w[1][1];
    const T det = mul(a, d) - mul(bq, cq);
#pragma unroll
    for (int c = 0; c < M + 1; ++c) {
      const T B0 = w[0][M + c], B1 = w[1][M + c];
      const T v0 = mul(d, B0) - mul(bq, B1);
      const T v1 = mul(-cq, B0) + mul(a, B1);
      if (c < M) {
        cpv[0][c] = v0 / det;
        cpv[1][c] = v1 / det;
      } else {
        dpv[0] = v0 / det;
        dpv[1] = v1 / det;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < M; ++j) {
      // the pivot: rows j..M-1 of column j, scanned in row order
      int p = j;
      T best = fabs(w[j][j]);
#pragma unroll
      for (int r = j + 1; r < M; ++r) {
        const T v = fabs(w[r][j]);
        if (beats(v, best)) {
          best = v;
          p = r;
        }
      }
      // rows j and p swap (selects: at most one r is p)
#pragma unroll
      for (int r = j + 1; r < M; ++r) {
        const bool sw = p == r;
#pragma unroll
        for (int c = 0; c < W; ++c) {
          const T a = w[j][c], o = w[r][c];
          w[j][c] = sw ? o : a;
          w[r][c] = sw ? a : o;
        }
      }
      // every row minus fac times the pivot row, fac 0 at row j
      T piv[W];
#pragma unroll
      for (int c = 0; c < W; ++c) piv[c] = w[j][c];
#pragma unroll
      for (int i = 0; i < M; ++i) {
        const T fac = i == j ? T(0) : w[i][j] / piv[j];
#pragma unroll
        for (int c = 0; c < W; ++c) w[i][c] = w[i][c] - mul(fac, piv[c]);
      }
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const T diag = w[i][i];
#pragma unroll
      for (int c = 0; c < M; ++c) cpv[i][c] = w[i][M + c] / diag;
      dpv[i] = w[i][2 * M] / diag;
    }
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kSys)
bts_thread_kernel(const T* __restrict__ L, const T* __restrict__ D,
                  const T* __restrict__ U, const T* __restrict__ b,
                  T* __restrict__ scr, T* __restrict__ x, int nsys, int n,
                  int vec_blk, int vec_b) {
  using Sh = ThreadShape<T, M>;
  using VT = typename Vec16<T>::type;
  constexpr int V = Sh::V, S = Sh::S, SB = Sh::SB;
  constexpr int NP = Sh::Q / V;           // 16-byte pieces of a record
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x;
  const long long s = static_cast<long long>(blockIdx.x) * kSys + lane;
  if (s >= nsys) return;                   // no barrier in this form
  T* mine = reinterpret_cast<T*>(smem_raw) + lane * Sh::PER;
  const size_t sys0 = static_cast<size_t>(s) * n;   // the system's level 0
  // this block's scratch: piece j of level k of lane l at
  // ((k * NP + j) * kSys + l) * V
  T* scr_blk = scr + static_cast<size_t>(blockIdx.x) * n * NP * kSys * V;

  // level k's blocks into stage k % S (L not at k = 0, U not at n - 1);
  // one commit group a level, empty past the last
  auto issue = [&](int k) {
    if (k < n) {
      T* dst = mine + (k % S) * Sh::REC;
      const size_t o = (sys0 + k) * (M * M);
      if (k > 0) copy_in<T, M * M>(dst, L + o, vec_blk);
      copy_in<T, M * M>(dst + Sh::PB, D + o, vec_blk);
      if (k < n - 1) copy_in<T, M * M>(dst + 2 * Sh::PB, U + o, vec_blk);
      copy_in<T, M>(dst + 3 * Sh::PB, b + (sys0 + k) * M, vec_b);
    }
    mpp::cp_async_commit();
  };
#pragma unroll
  for (int q = 0; q < S - 1; ++q) issue(q);

  T cpv[M][M], dpv[M];                     // Cp_{k-1}, dp_{k-1}
#pragma unroll
  for (int i = 0; i < M; ++i) {
    dpv[i] = T(0);
#pragma unroll
    for (int c = 0; c < M; ++c) cpv[i][c] = T(0);
  }
  for (int k = 0; k < n; ++k) {
    issue(k + S - 1);
    mpp::cp_async_wait<S - 1>();           // level k has landed
    const T* st = mine + (k % S) * Sh::REC;
    T lr[M * M], dr[M * M], ur[M * M], br[M];
    lds<T, M * M>(st, lr);
    lds<T, M * M>(st + Sh::PB, dr);
    lds<T, M * M>(st + 2 * Sh::PB, ur);
    lds<T, M>(st + 3 * Sh::PB, br);
    level_step<T, M>(lr, dr, ur, br, k == 0, k == n - 1, cpv, dpv);

    if (k < n - 1) {
      // [Cp_k | dp_k] to the scratch, 16 bytes a store
      T rec[Sh::Q];
#pragma unroll
      for (int i = 0; i < M; ++i) {
#pragma unroll
        for (int c = 0; c < M; ++c) rec[i * M + c] = cpv[i][c];
        rec[M * M + i] = dpv[i];
      }
#pragma unroll
      for (int q = M * (M + 1); q < Sh::Q; ++q) rec[q] = T(0);
#pragma unroll
      for (int j = 0; j < NP; ++j)
        *reinterpret_cast<VT*>(
            scr_blk + ((static_cast<size_t>(k) * NP + j) * kSys + lane) * V) =
            pack(rec + j * V);
    }
  }

  // back substitution: x_k = dp_k - Cp_k x_{k+1}, x_{n-1} = dp_{n-1}; level
  // k's record through stage (n - 2 - k) % SB of this thread's part
  mpp::cp_async_wait<0>();
  T xn[M];
#pragma unroll
  for (int i = 0; i < M; ++i) {
    xn[i] = dpv[i];
    x[(sys0 + n - 1) * M + i] = xn[i];
  }
  auto issue_back = [&](int k) {
    if (k >= 0) {
      T* dst = mine + ((n - 2 - k) % SB) * Sh::Q;
      const T* src =
          scr_blk + (static_cast<size_t>(k) * NP * kSys + lane) * V;
#pragma unroll
      for (int j = 0; j < NP; ++j) cp16(dst + j * V, src + j * kSys * V);
    }
    mpp::cp_async_commit();
  };
#pragma unroll
  for (int q = 0; q < SB - 1; ++q) issue_back(n - 2 - q);
  for (int k = n - 2; k >= 0; --k) {
    issue_back(k - (SB - 1));
    mpp::cp_async_wait<SB - 1>();
    T rc[Sh::Q];
    lds<T, Sh::Q>(mine + ((n - 2 - k) % SB) * Sh::Q, rc);
    T xk[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      T acc = T(0);
#pragma unroll
      for (int c = 0; c < M; ++c) acc = fma(rc[i * M + c], xn[c], acc);
      xk[i] = rc[M * M + i] - acc;
    }
#pragma unroll
    for (int i = 0; i < M; ++i) {
      xn[i] = xk[i];
      x[(sys0 + k) * M + i] = xk[i];
    }
  }
}

template <typename T, int M>
__global__ void __launch_bounds__(kWarp)
bts_lanes_kernel(const T* __restrict__ L, const T* __restrict__ D,
                 const T* __restrict__ U, const T* __restrict__ b, T* cp,
                 T* x, int nsys, int n) {
  constexpr int S = kWarp / M;          // systems a warp
  constexpr int W = 2 * M + 1;          // [denom | U | rhs] of a row
  // lanes the warp's systems leave over (32 % m): they hold identity
  // blocks and every quotient goes through quot(), so that none of their
  // divisions (0 / 0 with zero blocks) takes `/`'s slow path while the
  // warp waits; where no lane is left over, plain `/` (quot() costs a few
  // per cent there)
  constexpr bool kLeftover = kWarp % M != 0;
  const auto div = [](T a, T d) { return kLeftover ? quot(a, d) : a / d; };
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
      d[c] = live ? D[o + c] : T(kLeftover && c == i ? 1 : 0);
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
      cpr[0] = div(row[1], row[0]);
      dpr = div(row[2], row[0]);
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
        if (c < M) cpr[c] = div(v, det);
        else dpr = div(v, det);
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
        // rows j and p swap: lane p takes row j's, every other lane row
        // p's, the pivot row (lane p's own row), one shuffle a value
        const int src = base + (i == p ? j : p);
        T piv[W];
#pragma unroll
        for (int c = 0; c < W; ++c) {
          const T v = from(row[c], src);
          piv[c] = i == p ? row[c] : v;
          if (i == j || i == p) row[c] = v;
        }
        // every row minus fac times the pivot row, fac 0 at row j
        const T fac = i == j ? T(0) : div(row[j], piv[j]);
#pragma unroll
        for (int c = 0; c < W; ++c) row[c] = row[c] - mul(fac, piv[c]);
      }
      T diag = row[0];
#pragma unroll
      for (int c = 1; c < M; ++c)
        if (c == i) diag = row[c];
#pragma unroll
      for (int c = 0; c < M; ++c) cpr[c] = div(row[M + c], diag);
      dpr = div(row[2 * M], diag);
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
int launch_lanes(const void* L, const void* D, const void* U, const void* b,
                 void* scr, void* x, int nsys, int n, cudaStream_t stream) {
  constexpr int S = kWarp / M;
  const long long blocks = (static_cast<long long>(nsys) + S - 1) / S;
  bts_lanes_kernel<T, M><<<static_cast<unsigned>(blocks), kWarp, 0,
                           stream>>>(
      static_cast<const T*>(L), static_cast<const T*>(D),
      static_cast<const T*>(U), static_cast<const T*>(b),
      static_cast<T*>(scr), static_cast<T*>(x), nsys, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int M>
int launch_thread(const void* L, const void* D, const void* U,
                  const void* b, void* scr, void* x, int nsys, int n,
                  cudaStream_t stream) {
  using Sh = ThreadShape<T, M>;
  static std::atomic<bool> done[mpp::kMaxDevices];
  const cudaError_t e = mpp::allow_smem(done, bts_thread_kernel<T, M>,
                                        bts_thread_kernel<T, M>);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto at = [](const void* p) {
    return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
  };
  const int vec_blk = at(L) && at(D) && at(U) && (M * M) % Sh::V == 0;
  const int vec_b = at(b) && M % Sh::V == 0;
  const long long blocks = (static_cast<long long>(nsys) + kSys - 1) / kSys;
  bts_thread_kernel<T, M>
      <<<static_cast<unsigned>(blocks), kSys, Sh::SMEM, stream>>>(
          static_cast<const T*>(L), static_cast<const T*>(D),
          static_cast<const T*>(U), static_cast<const T*>(b),
          static_cast<T*>(scr), static_cast<T*>(x), nsys, n, vec_blk, vec_b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int M>
int launch(const void* L, const void* D, const void* U, const void* b,
           void* scr, void* x, int nsys, int n, int form,
           cudaStream_t stream) {
  if (form == kLanes)
    return launch_lanes<T, M>(L, D, U, b, scr, x, nsys, n, stream);
  if constexpr (M <= kThreadMax) {
    if (form == kThread)
      return launch_thread<T, M>(L, D, U, b, scr, x, nsys, n, stream);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
int launch_m(const void* L, const void* D, const void* U, const void* b,
             void* scr, void* x, int nsys, int n, int m, int form,
             void* stream) {
  if (nsys <= 0 || n <= 0) return cudaSuccess;
  if (n > 1 && scr == nullptr) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 1: return launch<T, 1>(L, D, U, b, scr, x, nsys, n, form, s);
    case 2: return launch<T, 2>(L, D, U, b, scr, x, nsys, n, form, s);
    case 3: return launch<T, 3>(L, D, U, b, scr, x, nsys, n, form, s);
    case 4: return launch<T, 4>(L, D, U, b, scr, x, nsys, n, form, s);
    case 5: return launch<T, 5>(L, D, U, b, scr, x, nsys, n, form, s);
    case 6: return launch<T, 6>(L, D, U, b, scr, x, nsys, n, form, s);
    case 7: return launch<T, 7>(L, D, U, b, scr, x, nsys, n, form, s);
    case 8: return launch<T, 8>(L, D, U, b, scr, x, nsys, n, form, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// values of the scratch a launch of `form` needs for nsys systems of n
// levels of m x m blocks of elem-byte values (0 at n = 1): lanes, Cp of
// every level strided like D; thread, [Cp | dp] of every level padded to
// 16 bytes, for the systems rounded up to a whole block
long long mpp_block_thomas_small_scratch(int nsys, int n, int m, int elem,
                                         int form) {
  if (nsys <= 0 || n <= 1 || m < 1) return 0;
  if (form == kThread)
    return static_cast<long long>((nsys + kSys - 1) / kSys) * kSys * n *
           round_up(m * (m + 1), 16 / elem);
  return static_cast<long long>(nsys) * n * m * m;
}

// scr: the scratch of mpp_block_thomas_small_scratch's size (may be null
// when n == 1); form: 0 thread, 1 lanes
int mpp_block_thomas_small_f32(const void* L, const void* D, const void* U,
                               const void* b, void* scr, void* x, int nsys,
                               int n, int m, int form, void* stream) {
  return launch_m<float>(L, D, U, b, scr, x, nsys, n, m, form, stream);
}

int mpp_block_thomas_small_f64(const void* L, const void* D, const void* U,
                               const void* b, void* scr, void* x, int nsys,
                               int n, int m, int form, void* stream) {
  return launch_m<double>(L, D, U, b, scr, x, nsys, n, m, form, stream);
}

}  // extern "C"

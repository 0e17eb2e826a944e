// GMRES(m)'s inner step and cycle update for Hopper (sm_90a), under every
// Krylov solve of the port (batched/ilu_gmres.gmres_cycles: the compiled
// steppers' "petsc" plans, the serial SNES, the TH-SPAC network, the MLC
// and radiation solves).
//
// gmres_arnoldi — replaces the body of the JAX package's Arnoldi step
//   astep (mpp_tpu/batched/ilu_gmres.py:225-257) after its preconditioned
//   matvec, with the Givens fori_loop rot (l.237-244) inside it;
// gmres_update — replaces the truncated back substitution's fori_loop
//   (l.262-269), the correction x + y V (l.270) and the while_loop body's
//   bookkeeping (l.277-281).
// There is no pl.pallas_call on this path: XLA compiles the loops into one
// device program, which the port ran as hundreds of eager ops a step.
//
// What they compute, per column c of the batch (the plain forms
// hopper_kernels.gmres_arnoldi_plain / gmres_update_plain):
//   arnoldi, step j of a cycle, given w = M A V_j:
//     h_i = <V_i, w> (i <= j), w' = w - sum_i h_i V_i (classical
//     Gram-Schmidt), hlast = ||w'||, V_{j+1} = w' / (hlast, or 1 where it is
//     0); the column [h_0..h_j, hlast] through the earlier rotations i < j
//     in order, then the new rotation from jnp.hypot's formula (hi * sqrt(1
//     + (lo/hi)^2), not CUDA's hypot, which rounds otherwise) with the d ==
//     0 guard; cs_j, sn_j, g_j, g_{j+1}, H[:, j]; conv = |g_{j+1}| <= tol,
//     mj = j + 1 where a column first converges, found |= conv; with cap,
//     mj = j + 1 for every column not found (the caller's maxiter).
//   update, once a cycle: y from the mj-truncated back substitution (rows
//     mj - 1 down to 0, y_k = 0 for k >= mj), x += y V[:mj] and its += mj
//     for the columns not done, done |= found.
// The plain forms contract the whole zero-filled basis; the kernels read
// only the rows, columns and entries the cycle wrote (V's rows <= j, H's
// columns and g's entries < mj), so the caller makes the basis once a
// solve, unfilled.  The rotations, the new rotation, g and the back
// substitution's divide round every product and sum alone, as the plain
// form's eager ops do (__dmul_rn / __dadd_rn: no FMA contraction); the
// dot products, the norm and the corrections are FMA chains and tree sums
// in an order of their own, so kernel and plain form agree to rounding,
// not bit for bit.  NaN: a column's values are read by its own warp or
// cluster and by no other, so a NaN stays in its column (it never
// converges, so it keeps the loop running, as in the plain form).
//
// The host's two predicates are device words (flags, 3 bytes, torch.bool),
// so the caller's sync reads one word and no eager op computes them:
//   flags[j % 2] — after step j, 1 if every column is found or done: step j
//     clears it where a column is neither (it was set to 1 by step j - 1,
//     by the last update or by the caller) and sets flags[(j + 1) % 2];
//   flags[2] — after an update, 1 if a column is left not done: the steps
//     clear it (every cycle runs one at least), the update sets it where a
//     column is left, and sets flags[0] and flags[1] for the next cycle.
// Every write of a flag by several threads writes the same value.
//
// Two forms, one launch each, picked by the wrapper's rule by shape
// (hopper_kernels.gmres_form), never on a failure:
//
// form 0, "warp" (many short columns, (q)'s [8192, 128]): a warp a
// column, kWarpCols columns a block, V's rows streamed coalesced by the
// lanes (kRows rows a pass, w's element loaded once a pass), the
// reductions by shuffles; lane 0 runs the rotations (the column, cs and sn
// staged in shared memory) and the back substitution's chain (H's
// mj x mj block staged in shared memory first).
//
// form 1, "cluster" (few long columns, (r)'s [1, 6000] to (v3)'s
// [1, 95232]): a thread-block cluster a column, CS CTAs (the wrapper's
// plan: n / GMRES_CTA_ELEMS, at most 16) of up to kCtaThreads threads, each
// CTA a range of the column's rows.  A step: each CTA's partial dots
// (warps by shuffles, then the CTA's warps in order in shared memory); a
// cluster barrier; every CTA sums the CS partials in rank order through
// distributed shared memory, so every CTA holds the same h; its rows of w'
// and its partial sum of squares; a barrier; the same for ||w'||; rank 0
// runs the rotations.  Three cluster barriers a step (the last so that no
// CTA leaves while a peer reads its shared memory).  The update: every
// CTA runs the back substitution (the same inputs and order, so the same
// y) and corrects its rows; a cluster barrier before rank 0 writes done,
// which every CTA reads first.
//
// w [ncol, n]; V [ncol, m + 1, n]; H [ncol, m + 1, m]; cs, sn [ncol, m];
// g [ncol, m + 1]; tol [ncol]; x [ncol, n] (one float type, f32 or f64);
// mj, its [ncol] int64; found, done [ncol] and flags [3] bytes (0 / 1).
// Pointers are device pointers, the launch goes on the caller's stream,
// nothing is allocated or synchronised here, and the launcher returns
// cudaGetLastError() (0 on success); a refused launch (shared memory past
// the card's, a cluster it cannot place) returns its error.
//
// Bound on the H100: bytes.  A step moves V's rows 0..j and w (read once),
// V_{j+1} and H's column (written once): ((j + 3) n + m + 1) values a
// column, (q)'s [8192, 128] f64 at j = 29 0.27 GB, 0.081 ms at 3.35 TB/s,
// against ~(4 j + 7) n flops a column (0.5 a byte).  Each form reads V's
// rows twice (the dots, then the correction: CGS needs every h before the
// first row of w'); at one long column the second read finds V in L2
// ((v3)'s basis is 23.6 MB), at (q) it does not.
// ---------------------------------------------------------------------------

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>
#include <cstddef>

#include "column_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kRows = 4;          // rows of V a pass of the dot products
constexpr int kWarpCols = 4;      // columns (warps) a block, warp form
constexpr int kCtaThreads = 512;  // the most threads a CTA, cluster form
constexpr int kMaxCluster = 16;   // with the non-portable attribute

// IEEE operations rounded one by one, as the plain form's eager ops
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double quo(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float quo(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

template <typename T>
__device__ __forceinline__ T infinity();
template <>
__device__ __forceinline__ double infinity<double>() {
  return CUDART_INF;
}
template <>
__device__ __forceinline__ float infinity<float>() {
  return CUDART_INF_F;
}

// the sum over the warp, the same value in every lane (a butterfly: each
// stage adds the same two values in every lane of a pair)
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = add(v, __shfl_xor_sync(kAll, v, o));
  return v;
}

// jnp.hypot as the plain form's _hypot computes it: +inf if either leg is
// infinite, NaN if either is NaN (torch.maximum / minimum propagate it),
// hi where hi == 0, else hi * sqrt(1 + (lo / hi)^2)
template <typename T>
__device__ __forceinline__ T hypot_plain(T a, T b) {
  const T inf = infinity<T>();
  const T x1 = fabs(a), x2 = fabs(b);
  if (x1 == inf || x2 == inf) return inf;
  if (x1 != x1 || x2 != x2) return x1 + x2;   // a NaN
  const T hi = x1 > x2 ? x1 : x2;
  const T lo = x1 > x2 ? x2 : x1;
  if (hi == T(0)) return hi;
  const T q = quo(lo, hi);
  return mul(hi, root(add(T(1), mul(q, q))));
}

// Step j's serial part for column c, one thread: col[0..j] holds h and
// col[j + 1] hlast; cs_s / sn_s the column's rotations i < j.  Leaves the
// rotated Hessenberg column in col[0..j] (col[j + 1] = 0) and writes cs_j,
// sn_j, g_j, g_{j+1}, mj, found and the step's flag.
template <typename T>
__device__ void rotate(T* col, const T* cs_s, const T* sn_s, int j, int m,
                       size_t c, T* cs, T* sn, T* g, const T* tol,
                       long long* mj, unsigned char* found,
                       const unsigned char* done, int cap,
                       unsigned char* flags) {
  T a = col[0];   // the running entry: rotation i - 1's second output
  for (int i = 0; i < j; ++i) {
    const T b = col[i + 1];
    col[i] = add(mul(cs_s[i], a), mul(sn_s[i], b));
    a = add(mul(-sn_s[i], a), mul(cs_s[i], b));
  }
  const T cj = a, cj1 = col[j + 1];
  const T d = hypot_plain(cj, cj1);
  const bool z = d == T(0);
  const T dd = z ? T(1) : d;
  const T cr = z ? T(1) : quo(cj, dd);
  const T sr = z ? T(0) : quo(cj1, dd);
  col[j] = add(mul(cr, cj), mul(sr, cj1));
  col[j + 1] = T(0);
  cs[c * m + j] = cr;
  sn[c * m + j] = sr;
  T* gc = g + c * (m + 1);
  const T gj = gc[j];
  const T gj1 = mul(-sr, gj);
  gc[j + 1] = gj1;
  gc[j] = mul(cr, gj);
  const bool conv = fabs(gj1) <= tol[c];
  bool f = found[c] != 0;
  long long mjv = mj[c];
  if (!f && conv) mjv = j + 1;
  f = f || conv;
  if (cap && !f) mjv = j + 1;
  mj[c] = mjv;
  found[c] = f ? 1 : 0;
  if (!f && done[c] == 0) flags[j & 1] = 0;
}

// this thread's partial dots of rows i0 .. i0 + nr - 1 of column Vc with
// w over the elements e = first, first + stride, ... < last
template <typename T>
__device__ __forceinline__ void partial_dots(const T* __restrict__ Vc,
                                             const T* __restrict__ wc,
                                             int n, int i0, int nr,
                                             int first, int last, int stride,
                                             T (&acc)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = T(0);
  for (int e = first; e < last; e += stride) {
    const T we = wc[e];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < nr)
        acc[r] = fmadd(Vc[static_cast<size_t>(i0 + r) * n + e], we, acc[r]);
  }
}

// w' = w - sum_{i <= j} h_i V_i on this thread's elements, written to row
// j + 1 (not yet normalised); returns their partial sum of squares
template <typename T>
__device__ __forceinline__ T orthogonalise(T* __restrict__ Vc,
                                           const T* __restrict__ wc,
                                           const T* h, int n, int j,
                                           int first, int last, int stride) {
  T* Vn = Vc + static_cast<size_t>(j + 1) * n;
  T ss = T(0);
  for (int e = first; e < last; e += stride) {
    T s = T(0);
#pragma unroll 4
    for (int i = 0; i <= j; ++i)
      s = fmadd(h[i], Vc[static_cast<size_t>(i) * n + e], s);
    const T wn = sub(wc[e], s);
    Vn[e] = wn;
    ss = fmadd(wn, wn, ss);
  }
  return ss;
}

template <typename T>
__device__ __forceinline__ void normalise(T* __restrict__ Vc, int n, int j,
                                          T hlast, int first, int last,
                                          int stride) {
  T* Vn = Vc + static_cast<size_t>(j + 1) * n;
  const T den = hlast == T(0) ? T(1) : hlast;
  for (int e = first; e < last; e += stride) Vn[e] = quo(Vn[e], den);
}

// H[c, :, j] from the rotated column: rows <= j, zeros below
template <typename T>
__device__ __forceinline__ void write_column(T* H, const T* col, size_t c,
                                             int m, int j, int first,
                                             int stride) {
  T* Hc = H + c * static_cast<size_t>(m + 1) * m;
  for (int i = first; i <= m; i += stride)
    Hc[static_cast<size_t>(i) * m + j] = i <= j ? col[i] : T(0);
}

// y (shared, rows < mjv) of the mj-truncated back substitution by one
// warp: Hs the staged mjv x mjv block (row stride m), gc the column's g
template <typename T>
__device__ void back_substitute(const T* Hs, const T* gc, int m, int mjv,
                                T* y) {
  const int lane = threadIdx.x % kWarp;
  for (int r = mjv - 1; r >= 0; --r) {
    T p = T(0);
    for (int k = r + 1 + lane; k < mjv; k += kWarp)
      p = fmadd(Hs[r * m + k], y[k], p);
    p = warp_sum(p);
    if (lane == 0) {
      const T hrr = Hs[r * m + r];
      y[r] = quo(sub(gc[r], p), hrr == T(0) ? T(1) : hrr);
    }
    __syncwarp();
  }
}

// x += y V[:mjv] on this thread's elements of column c
template <typename T>
__device__ __forceinline__ void correct(const T* __restrict__ Vc,
                                        const T* y, T* __restrict__ xc,
                                        int n, int mjv, int first, int last,
                                        int stride) {
  for (int e = first; e < last; e += stride) {
    T s = T(0);
#pragma unroll 4
    for (int i = 0; i < mjv; ++i)
      s = fmadd(y[i], Vc[static_cast<size_t>(i) * n + e], s);
    xc[e] = add(xc[e], s);
  }
}

// ---- form 0: a warp a column -----------------------------------------------

// shared values a warp: the column (m + 2), cs and sn (m each)
__host__ __device__ constexpr int warp_step_values(int m) {
  return 3 * m + 2;
}

template <typename T>
__global__ void __launch_bounds__(kWarpCols* kWarp)
    arnoldi_warp(const T* __restrict__ w, T* __restrict__ V,
                 T* __restrict__ H, T* __restrict__ cs, T* __restrict__ sn,
                 T* __restrict__ g, const T* __restrict__ tol,
                 long long* __restrict__ mj, unsigned char* __restrict__ found,
                 const unsigned char* __restrict__ done,
                 unsigned char* __restrict__ flags, int ncol, int n, int m,
                 int j, int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  T* col = reinterpret_cast<T*>(smem_raw) +
           (threadIdx.x / kWarp) * warp_step_values(m);
  T* cs_s = col + m + 2;
  T* sn_s = cs_s + m;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    flags[(j + 1) & 1] = 1;
    flags[2] = 0;
  }
  const size_t c =
      static_cast<size_t>(blockIdx.x) * kWarpCols + threadIdx.x / kWarp;
  if (c >= static_cast<size_t>(ncol)) return;
  const T* wc = w + c * n;
  T* Vc = V + c * static_cast<size_t>(m + 1) * n;
  for (int i0 = 0; i0 <= j; i0 += kRows) {
    const int nr = min(kRows, j + 1 - i0);
    T acc[kRows];
    partial_dots(Vc, wc, n, i0, nr, lane, n, kWarp, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const T s = warp_sum(acc[r]);
      if (lane == 0 && r < nr) col[i0 + r] = s;
    }
  }
  __syncwarp();
  const T ss = warp_sum(orthogonalise(Vc, wc, col, n, j, lane, n, kWarp));
  const T hlast = root(ss);
  normalise(Vc, n, j, hlast, lane, n, kWarp);
  for (int i = lane; i < j; i += kWarp) {
    cs_s[i] = cs[c * m + i];
    sn_s[i] = sn[c * m + i];
  }
  __syncwarp();   // every lane has read col[0..j]; cs_s, sn_s are staged
  if (lane == 0) {
    col[j + 1] = hlast;
    rotate(col, cs_s, sn_s, j, m, c, cs, sn, g, tol, mj, found, done, cap,
           flags);
  }
  __syncwarp();
  write_column(H, col, c, m, j, lane, kWarp);
}

// shared values a warp: H's block (m x m) and y (m)
__host__ __device__ constexpr int warp_update_values(int m) {
  return m * m + m;
}

template <typename T>
__global__ void __launch_bounds__(kWarpCols* kWarp)
    update_warp(const T* __restrict__ V, const T* __restrict__ H,
                const T* __restrict__ g, const long long* __restrict__ mj,
                const unsigned char* __restrict__ found,
                unsigned char* __restrict__ done, T* __restrict__ x,
                long long* __restrict__ its, unsigned char* __restrict__ flags,
                int ncol, int n, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % kWarp;
  T* Hs = reinterpret_cast<T*>(smem_raw) +
          (threadIdx.x / kWarp) * warp_update_values(m);
  T* y = Hs + m * m;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    flags[0] = 1;
    flags[1] = 1;
  }
  const size_t c =
      static_cast<size_t>(blockIdx.x) * kWarpCols + threadIdx.x / kWarp;
  if (c >= static_cast<size_t>(ncol)) return;
  const bool was_done = done[c] != 0;
  const int mjv = static_cast<int>(mj[c]);
  if (!was_done) {
    const T* Hc = H + c * static_cast<size_t>(m + 1) * m;
    for (int t = lane; t < mjv * mjv; t += kWarp)
      Hs[(t / mjv) * m + t % mjv] = Hc[static_cast<size_t>(t / mjv) * m +
                                       t % mjv];
    __syncwarp();
    back_substitute(Hs, g + c * (m + 1), m, mjv, y);
    correct(V + c * static_cast<size_t>(m + 1) * n, y, x + c * n, n, mjv,
            lane, n, kWarp);
  }
  if (lane == 0) {
    if (!was_done) its[c] += mjv;
    const bool now_done = was_done || found[c] != 0;
    done[c] = now_done ? 1 : 0;
    if (!now_done) flags[2] = 1;
  }
}

// ---- form 1: a thread-block cluster a column -------------------------------

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// shared values a CTA of nw warps: the warps' partial dots ((m + 1) nw,
// later their partial squares), the CTA's partial dots (m + 1, read by the
// peers), the column (m + 2), the partial sum of squares and hlast (2), cs
// and sn (m each)
__host__ __device__ constexpr int cluster_step_values(int m, int nw) {
  return (m + 1) * nw + (m + 1) + (m + 2) + 2 + 2 * m;
}

template <typename T>
__global__ void __launch_bounds__(kCtaThreads)
    arnoldi_cluster(const T* __restrict__ w, T* __restrict__ V,
                    T* __restrict__ H, T* __restrict__ cs,
                    T* __restrict__ sn, T* __restrict__ g,
                    const T* __restrict__ tol, long long* __restrict__ mj,
                    unsigned char* __restrict__ found,
                    const unsigned char* __restrict__ done,
                    unsigned char* __restrict__ flags, int n, int m, int j,
                    int cap, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int nw = blockDim.x / kWarp;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  T* red = reinterpret_cast<T*>(smem_raw);
  T* part = red + (m + 1) * nw;
  T* col = part + (m + 1);
  T* scal = col + (m + 2);
  T* cs_s = scal + 2;
  T* sn_s = cs_s + m;
  const int ctas = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const size_t c = blockIdx.x / ctas;
  const int lo = min(n, rank * chunk), hi = min(n, lo + chunk);
  if (c == 0 && rank == 0 && tid == 0) {
    flags[(j + 1) & 1] = 1;
    flags[2] = 0;
  }
  const T* wc = w + c * n;
  T* Vc = V + c * static_cast<size_t>(m + 1) * n;
  for (int i0 = 0; i0 <= j; i0 += kRows) {
    const int nr = min(kRows, j + 1 - i0);
    T acc[kRows];
    partial_dots(Vc, wc, n, i0, nr, lo + tid, hi, blockDim.x, acc);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const T s = warp_sum(acc[r]);
      if (lane == 0 && r < nr) red[(i0 + r) * nw + warp] = s;
    }
  }
  __syncthreads();
  for (int i = tid; i <= j; i += blockDim.x) {
    T s = T(0);
    for (int k = 0; k < nw; ++k) s = add(s, red[i * nw + k]);
    part[i] = s;
  }
  cluster_sync();   // every CTA's partial dots are published
  for (int i = tid; i <= j; i += blockDim.x) {
    T s = T(0);
    for (int r = 0; r < ctas; ++r) s = add(s, cl.map_shared_rank(part, r)[i]);
    col[i] = s;
  }
  __syncthreads();
  T ss = warp_sum(orthogonalise(Vc, wc, col, n, j, lo + tid, hi,
                                static_cast<int>(blockDim.x)));
  if (lane == 0) red[warp] = ss;   // the dots' partials were read above
  __syncthreads();
  if (tid == 0) {
    T s = T(0);
    for (int k = 0; k < nw; ++k) s = add(s, red[k]);
    scal[0] = s;
  }
  cluster_sync();   // every CTA's partial sum of squares is published
  if (tid == 0) {
    T s = T(0);
    for (int r = 0; r < ctas; ++r) s = add(s, *cl.map_shared_rank(scal, r));
    scal[1] = root(s);
  }
  cluster_arrive();   // this CTA reads no peer's shared memory after here
  __syncthreads();
  const T hlast = scal[1];
  normalise(Vc, n, j, hlast, lo + tid, hi, static_cast<int>(blockDim.x));
  if (rank == 0) {
    for (int i = tid; i < j; i += blockDim.x) {
      cs_s[i] = cs[c * m + i];
      sn_s[i] = sn[c * m + i];
    }
    __syncthreads();
    if (tid == 0) {
      col[j + 1] = hlast;
      rotate(col, cs_s, sn_s, j, m, c, cs, sn, g, tol, mj, found, done, cap,
             flags);
    }
    __syncthreads();
    write_column(H, col, c, m, j, tid, static_cast<int>(blockDim.x));
  }
  cluster_wait();   // no CTA leaves while a peer may read its shared memory
}

// shared values a CTA: H's block (m x m) and y (m)
__host__ __device__ constexpr int cluster_update_values(int m) {
  return m * m + m;
}

template <typename T>
__global__ void __launch_bounds__(kCtaThreads)
    update_cluster(const T* __restrict__ V, const T* __restrict__ H,
                   const T* __restrict__ g, const long long* __restrict__ mj,
                   const unsigned char* __restrict__ found,
                   unsigned char* __restrict__ done, T* __restrict__ x,
                   long long* __restrict__ its,
                   unsigned char* __restrict__ flags, int n, int m,
                   int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x;
  T* Hs = reinterpret_cast<T*>(smem_raw);
  T* y = Hs + m * m;
  const int ctas = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const size_t c = blockIdx.x / ctas;
  const int lo = min(n, rank * chunk), hi = min(n, lo + chunk);
  if (c == 0 && rank == 0 && tid == 0) {
    flags[0] = 1;
    flags[1] = 1;
  }
  const bool was_done = done[c] != 0;
  const int mjv = static_cast<int>(mj[c]);
  if (!was_done) {   // the same for every thread of the cluster
    const T* Hc = H + c * static_cast<size_t>(m + 1) * m;
    for (int t = tid; t < mjv * mjv; t += blockDim.x)
      Hs[(t / mjv) * m + t % mjv] = Hc[static_cast<size_t>(t / mjv) * m +
                                       t % mjv];
    __syncthreads();
    if (tid < kWarp) back_substitute(Hs, g + c * (m + 1), m, mjv, y);
    __syncthreads();
    correct(V + c * static_cast<size_t>(m + 1) * n, y, x + c * n, n, mjv,
            lo + tid, hi, static_cast<int>(blockDim.x));
  }
  cluster_sync();   // every CTA has read done[c]
  if (rank == 0 && tid == 0) {
    if (!was_done) its[c] += mjv;
    const bool now_done = was_done || found[c] != 0;
    done[c] = now_done ? 1 : 0;
    if (!now_done) flags[2] = 1;
  }
}

// ---- launchers -------------------------------------------------------------

// dynamic shared bytes of a launch: kernel 0 arnoldi, 1 update; form 0
// warp, 1 cluster (threads a CTA)
size_t smem_bytes(int kernel, int form, int m, int threads, int elem) {
  const int values =
      form == 0 ? kWarpCols * (kernel == 0 ? warp_step_values(m)
                                           : warp_update_values(m))
                : (kernel == 0 ? cluster_step_values(m, threads / kWarp)
                               : cluster_update_values(m));
  return static_cast<size_t>(values) * elem;
}

// Let every kernel take up to kOnChipBytes of dynamic shared memory, and
// the cluster kernels clusters of 16 CTAs, on the current device; `done`
// records the devices set.
template <typename T>
cudaError_t allow(std::atomic<bool> (&done)[mpp::kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool recorded = dev >= 0 && dev < mpp::kMaxDevices;
  if (recorded && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  const void* fns[] = {reinterpret_cast<const void*>(arnoldi_warp<T>),
                       reinterpret_cast<const void*>(update_warp<T>),
                       reinterpret_cast<const void*>(arnoldi_cluster<T>),
                       reinterpret_cast<const void*>(update_cluster<T>)};
  for (int i = 0; i < 4; ++i) {
    e = cudaFuncSetAttribute(fns[i],
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             mpp::kOnChipBytes);
    if (e != cudaSuccess) return e;
    if (i >= 2) {
      e = cudaFuncSetAttribute(
          fns[i], cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return e;
    }
  }
  if (recorded) done[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

// the launch shape shared by both kernels: 0 if the plan is taken, else
// the error the launcher returns
template <typename T>
int check_plan(int kernel, int ncol, int n, int m, int form, int ctas,
               int chunk, int threads, size_t* smem) {
  if (ncol < 1 || n < 1 || m < 1 || form < 0 || form > 1)
    return cudaErrorInvalidValue;
  if (form == 1 && (ctas < 1 || ctas > kMaxCluster || chunk < 1 ||
                    static_cast<long long>(ctas) * chunk < n ||
                    threads < kWarp || threads > kCtaThreads ||
                    threads % kWarp != 0))
    return cudaErrorInvalidValue;
  *smem = smem_bytes(kernel, form, m, threads, sizeof(T));
  if (*smem > static_cast<size_t>(mpp::kOnChipBytes))
    return cudaErrorInvalidValue;
  static std::atomic<bool> done[mpp::kMaxDevices];
  return static_cast<int>(allow<T>(done));
}

cudaLaunchConfig_t cluster_config(int ncol, int ctas, int threads,
                                  size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ncol) * ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ctas);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
int launch_arnoldi(const void* w, void* V, void* H, void* cs, void* sn,
                   void* g, const void* tol, void* mj, void* found,
                   const void* done, void* flags, int ncol, int n, int m,
                   int j, int cap, int form, int ctas, int chunk,
                   int threads, void* stream) {
  size_t smem = 0;
  if (j < 0 || j >= m) return cudaErrorInvalidValue;
  const int e0 =
      check_plan<T>(0, ncol, n, m, form, ctas, chunk, threads, &smem);
  if (e0 != 0) return e0;
  auto st = static_cast<cudaStream_t>(stream);
  const T* wp = static_cast<const T*>(w);
  T* Vp = static_cast<T*>(V);
  T* Hp = static_cast<T*>(H);
  T* csp = static_cast<T*>(cs);
  T* snp = static_cast<T*>(sn);
  T* gp = static_cast<T*>(g);
  const T* tp = static_cast<const T*>(tol);
  auto* mjp = static_cast<long long*>(mj);
  auto* fp = static_cast<unsigned char*>(found);
  auto* dp = static_cast<const unsigned char*>(done);
  auto* flp = static_cast<unsigned char*>(flags);
  if (form == 0) {
    const unsigned blocks =
        static_cast<unsigned>((ncol + kWarpCols - 1) / kWarpCols);
    arnoldi_warp<T><<<blocks, kWarpCols * kWarp, smem, st>>>(
        wp, Vp, Hp, csp, snp, gp, tp, mjp, fp, dp, flp, ncol, n, m, j, cap);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(ncol, ctas, threads, smem, st, attr);
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, arnoldi_cluster<T>, wp, Vp, Hp, csp, snp, gp,
                         tp, mjp, fp, dp, flp, n, m, j, cap, chunk);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_update(const void* V, const void* H, const void* g, const void* mj,
                  const void* found, void* done, void* x, void* its,
                  void* flags, int ncol, int n, int m, int form, int ctas,
                  int chunk, int threads, void* stream) {
  size_t smem = 0;
  const int e0 =
      check_plan<T>(1, ncol, n, m, form, ctas, chunk, threads, &smem);
  if (e0 != 0) return e0;
  auto st = static_cast<cudaStream_t>(stream);
  const T* Vp = static_cast<const T*>(V);
  const T* Hp = static_cast<const T*>(H);
  const T* gp = static_cast<const T*>(g);
  auto* mjp = static_cast<const long long*>(mj);
  auto* fp = static_cast<const unsigned char*>(found);
  auto* dp = static_cast<unsigned char*>(done);
  T* xp = static_cast<T*>(x);
  auto* ip = static_cast<long long*>(its);
  auto* flp = static_cast<unsigned char*>(flags);
  if (form == 0) {
    const unsigned blocks =
        static_cast<unsigned>((ncol + kWarpCols - 1) / kWarpCols);
    update_warp<T><<<blocks, kWarpCols * kWarp, smem, st>>>(
        Vp, Hp, gp, mjp, fp, dp, xp, ip, flp, ncol, n, m);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(ncol, ctas, threads, smem, st, attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, update_cluster<T>, Vp, Hp,
                                           gp, mjp, fp, dp, xp, ip, flp, n,
                                           m, chunk);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dynamic shared bytes of a launch (kernel 0 gmres_arnoldi, 1
// gmres_update; form 0 warp, 1 cluster with `threads` a CTA; elem the
// value's bytes), as the launchers compute them
long long mpp_gmres_smem(int kernel, int form, int m, int threads,
                         int elem) {
  return static_cast<long long>(smem_bytes(kernel, form, m, threads, elem));
}

// one Arnoldi step j (0 <= j < m) of every column, in place on V's row j +
// 1, H's column j, cs, sn, g, mj, found and flags; cap 1 where the caller's
// maxiter ends the cycle at this step; form 0 warp, 1 cluster (ctas CTAs a
// column of `threads` threads, `chunk` rows of the column each)
int mpp_gmres_arnoldi_f32(const void* w, void* V, void* H, void* cs,
                          void* sn, void* g, const void* tol, void* mj,
                          void* found, const void* done, void* flags,
                          int ncol, int n, int m, int j, int cap, int form,
                          int ctas, int chunk, int threads, void* stream) {
  return launch_arnoldi<float>(w, V, H, cs, sn, g, tol, mj, found, done,
                               flags, ncol, n, m, j, cap, form, ctas, chunk,
                               threads, stream);
}

int mpp_gmres_arnoldi_f64(const void* w, void* V, void* H, void* cs,
                          void* sn, void* g, const void* tol, void* mj,
                          void* found, const void* done, void* flags,
                          int ncol, int n, int m, int j, int cap, int form,
                          int ctas, int chunk, int threads, void* stream) {
  return launch_arnoldi<double>(w, V, H, cs, sn, g, tol, mj, found, done,
                                flags, ncol, n, m, j, cap, form, ctas, chunk,
                                threads, stream);
}

// the cycle's update of every column, in place on x, its, done and flags
int mpp_gmres_update_f32(const void* V, const void* H, const void* g,
                         const void* mj, const void* found, void* done,
                         void* x, void* its, void* flags, int ncol, int n,
                         int m, int form, int ctas, int chunk, int threads,
                         void* stream) {
  return launch_update<float>(V, H, g, mj, found, done, x, its, flags, ncol,
                              n, m, form, ctas, chunk, threads, stream);
}

int mpp_gmres_update_f64(const void* V, const void* H, const void* g,
                         const void* mj, const void* found, void* done,
                         void* x, void* its, void* flags, int ncol, int n,
                         int m, int form, int ctas, int chunk, int threads,
                         void* stream) {
  return launch_update<double>(V, H, g, mj, found, done, x, its, flags, ncol,
                               n, m, form, ctas, chunk, threads, stream);
}

}  // extern "C"

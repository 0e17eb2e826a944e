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
// solve, unfilled.  The rotations, the new rotation, g and every division
// round each product and sum alone, as the plain form's eager ops do
// (__dmul_rn / __dadd_rn / __ddiv_rn: no FMA contraction); the dot
// products, the norm, the corrections and the back substitution's
// numerators are FMA chains and tree sums in an order of their own, so
// kernel and plain form agree to rounding, not bit for bit.  NaN: a
// column's values are read by its own threads or cluster and by no other,
// so a NaN stays in its column (it never converges, so it keeps the loop
// running, as in the plain form).
//
// The host's two predicates are device words (flags, 3 bytes, torch.bool),
// so the caller's sync reads one word and no eager op computes them:
//   flags[j % 2] — after step j, 1 if every column is found or done: step j
//     clears it where a column is neither (it was set to 1 by step j - 1,
//     by the last update or by the caller) and sets flags[(j + 1) % 2];
//   flags[2] — after an update, 1 if a column is left not done: the steps
//     clear it (every cycle runs one at least), the update sets it where a
//     column is left, and sets flags[0] and flags[1] for the next cycle.
// Every write of a flag by several threads writes the same value, and a
// column reads the flag before it writes it (a store of every column to
// one byte would queue at its L2 slice).
//
// Bound on the H100: bytes.  A step moves V's rows 0..j and w (read once),
// V_{j+1} and H's column (written once): ((j + 3) n + m + 1) values a
// column, (q)'s [8192, 128] f64 at j = 15 0.15 GB, 0.046 ms at 3.35 TB/s,
// against ~(4 j + 7) n flops a column (0.5 a byte); the update moves V's
// rows < mj, H's mj x mj block, g and x.  At one long column ((r)'s [1,
// 6000]: 0.8 MB at j = 15, 0.24 us) the bytes are no bound: the step is a
// chain of dependent latencies (loads, reductions, the cluster's
// exchanges, the serial tail), and the design shortens that chain.
//
// The design.  Both kernels hold what a column's threads read in shared
// memory, each thread its own slots (cp.async, every copy in flight at
// once, no register staged; where the slots do not fit the card's 227 KB
// the launcher takes the same kernel unheld, which reads V's rows from
// global memory where it needs them, twice in a step):
//   gmres_arnoldi stages w and V's rows 0..j once and reads them for the
//   dots and again for the correction from its slots; w' stays in the w
//   slot and V_{j+1} is written once, already divided by hlast.  The
//   rows' partial dots (R a launch, the power of two >= j + 1, to 32 a
//   pass in the warp form and 16 in the cluster form) leave each thread
//   through one reduce-scatter of the warp (R - 1 shuffles halve the rows
//   a lane holds, log2(32 / R) more add the lanes of a row), not a
//   butterfly a row.  The per-column scalars of the
//   serial tail (g_j, tol, mj, found, done, cs and sn) are loaded at the
//   kernel's start, and H's column is stored by the column's lanes, a row
//   each.
//   gmres_update stages H's mj x mj block (transposed) and g first and V's
//   rows < mj after them (two commit groups), so the rows load while the
//   back substitution runs: a column-oriented chain on one warp; once y_r
//   is known (lane r's numerator over H[r][r], __ddiv_rn, broadcast by one
//   shuffle) each lane k < r takes H[k][r] y_r off its own running
//   numerator (one FMA): a division, a shuffle and an FMA a row, no
//   reduction.  Its 30 IEEE divisions in a row are most of the update's
//   time at one column.
//
// Two forms, one launch each, picked by the wrapper's rule by shape
// (hopper_kernels.gmres_form), never on a failure:
//
// form 0, "warp" (many short columns, (q)'s [8192, 128]; m <= 32): a warp a
// column, its rows strided over the lanes; 4 columns a block where their
// slots take at most a quarter of the card's shared memory, else one (the
// launcher's plan_shape); the reductions by shuffles, the rotations on
// lane 0, the back substitution on the warp; no block barrier.
//
// form 1, "cluster" (few long columns, (r)'s [1, 6000] to (v3)'s [1,
// 95232]): a thread-block cluster a column, CS CTAs (the wrapper's plan: n
// / GMRES_CTA_ELEMS, at most 16), each CTA E element threads over a range
// of the column's rows and one more warp for the serial tail.  A step:
// each CTA's partial dots (the reduce-scatter, then the CTA's warps in
// order behind a named barrier of the element threads); each CTA copies
// them into every CTA's shared memory, one bulk copy a peer
// (cp.async.bulk shared::cta -> shared::cluster, counted on the
// receiver's mbarrier by its bytes), so every CTA sums the CS partials in
// rank order and holds the same h; its rows of w' and its partial sum of
// squares, pushed into every CTA's shared memory the same way (st.async,
// one value); V_{j+1}.  One cluster barrier a step, split: arrived at the
// start (after the mbarriers are set) and waited for before the first
// copy; no CTA reads a peer's shared memory, and every copy into a CTA
// lands before that CTA leaves (it waits for them; a CTA's own outgoing
// copies have landed before any peer pushes its squares, which it waits
// for too), so no exit barrier.  The tail warp of rank 0 sums h itself,
// applies the j earlier rotations while the element threads form w', and
// waits only for hlast to take the new rotation.  The update: every CTA
// stages H's block and runs the back substitution (the same inputs and
// order, so the same y) while its V rows load, and corrects its rows; one
// cluster barrier, split: arrived once the CTA has read done[c], waited
// for before rank 0 writes it.
//
// w [ncol, n]; V [ncol, m + 1, n]; H [ncol, m + 1, m]; cs, sn [ncol, m];
// g [ncol, m + 1]; tol [ncol]; x [ncol, n] (one float type, f32 or f64);
// mj, its [ncol] int64; found, done [ncol] and flags [3] bytes (0 / 1).
// The host binds these pointers and the plan once a workspace
// (GmresArgs); a launch passes w, j and the stream.  Pointers are device
// pointers, the launch goes on the caller's stream, nothing is allocated
// or synchronised here, and the launcher returns cudaGetLastError() (0 on
// success); a refused launch (shared memory past the card's, a cluster it
// cannot place) returns its error.
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
constexpr int kWarpCols = 4;       // the most columns (warps) a block, warp form
constexpr int kWarpMaxM = 32;       // the warp form's largest m (one pass)
constexpr int kCtaThreads = 512;    // the most element threads a CTA
constexpr int kMaxCluster = 16;     // with the non-portable attribute
constexpr int kBarBytes = 16;       // the cluster step's two mbarriers
constexpr int kClusterRows = 16;    // the most rows a pass, cluster form

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

// One halving exchange of the reduce-scatter and the ones after it: the
// rows a lane holds drop from 2 H to H (the lane whose bit o is set keeps
// the upper half, its partner the lower); unrolled at compile time, so v
// stays in registers
template <typename T, int R, int H>
struct Halve {
  __device__ __forceinline__ static void run(T (&v)[R], int lane) {
    constexpr int o = kWarp * H / R;
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int k = 0; k < H; ++k) {
      const T send = up ? v[k] : v[k + H];
      const T keep = up ? v[k + H] : v[k];
      v[k] = add(keep, __shfl_xor_sync(kAll, send, o));
    }
    Halve<T, R, H / 2>::run(v, lane);
  }
};
template <typename T, int R>
struct Halve<T, R, 0> {
  __device__ __forceinline__ static void run(T (&)[R], int) {}
};

// v[r], this lane's partial of row r < R (R a power of two <= 32); returns
// the warp's sum of row lane / (32 / R), held by every lane of that group
// of 32 / R: R - 1 exchanges halve the rows a lane holds, log2(32 / R)
// more add the group's partials
template <typename T, int R>
__device__ __forceinline__ T reduce_scatter(T (&v)[R], int lane) {
  Halve<T, R, R / 2>::run(v, lane);
  T s = v[0];
#pragma unroll
  for (int o = kWarp / R / 2; o > 0; o >>= 1)
    s = add(s, __shfl_xor_sync(kAll, s, o));
  return s;
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

// The serial tail's inputs of column c, loaded at the kernel's start
template <typename T>
struct Tail {
  T gj, tol;
  long long mj;
  bool found, done;
};

template <typename T>
__device__ __forceinline__ Tail<T> load_tail(const T* g, const T* tol,
                                             const long long* mj,
                                             const unsigned char* found,
                                             const unsigned char* done,
                                             size_t c, int m, int j) {
  return Tail<T>{g[c * (m + 1) + j], tol[c], mj[c], found[c] != 0,
                 done[c] != 0};
}

// The earlier rotations i < j of h[0..j] (col may be h): col[0..j - 1]
// rotated; returns the running entry (rotation j - 1's second output)
template <typename T>
__device__ T rotate_earlier(const T* h, T* col, const T* cs_s,
                            const T* sn_s, int j) {
  T a = h[0];
#pragma unroll 4
  for (int i = 0; i < j; ++i) {
    const T b = h[i + 1];
    col[i] = add(mul(cs_s[i], a), mul(sn_s[i], b));
    a = add(mul(-sn_s[i], a), mul(cs_s[i], b));
  }
  return a;
}

// Step j's new rotation of (a, hlast) for column c: col[j], col[j + 1] = 0,
// cs_j, sn_j, g_j, g_{j+1}, mj, found and the step's flag
template <typename T>
__device__ void rotate_new(T* col, T a, T hlast, int j, int m, size_t c,
                           T* cs, T* sn, T* g, const Tail<T>& tl,
                           long long* mj, unsigned char* found, int cap,
                           unsigned char* flags) {
  const T cj = a, cj1 = hlast;
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
  const T gj1 = mul(-sr, tl.gj);
  gc[j + 1] = gj1;
  gc[j] = mul(cr, tl.gj);
  const bool conv = fabs(gj1) <= tl.tol;
  long long mjv = tl.mj;
  if (!tl.found && conv) mjv = j + 1;
  const bool f = tl.found || conv;
  if (cap && !f) mjv = j + 1;
  mj[c] = mjv;
  found[c] = f ? 1 : 0;
  // read first: thousands of columns storing to one byte queue at its L2
  // slice, and all but the first few find it cleared
  if (!f && !tl.done && flags[j & 1] != 0) flags[j & 1] = 0;
}

// H[c, :, j] from the rotated column: rows <= j, zeros below
template <typename T>
__device__ __forceinline__ void store_column(T* H, const T* col, size_t c,
                                             int m, int j, int first,
                                             int stride) {
  T* Hc = H + c * static_cast<size_t>(m + 1) * m;
  for (int i = first; i <= m; i += stride)
    Hc[static_cast<size_t>(i) * m + j] = i <= j ? col[i] : T(0);
}

// The elements of a column a thread takes: e = lo + t + q S (q < Q, e <
// hi); held, w (then w') in ws[q S] and V's row i in vs[(i Q + q) S] of
// this thread's slots in shared memory
template <typename T>
struct Elems {
  int lo, hi, t, S, Q;
  bool held;
  T* vs;
  T* ws;
  __device__ __forceinline__ int e(int q) const { return lo + t + q * S; }
  // the elements this thread has: e(q) < hi for q < count()
  __device__ __forceinline__ int count() const {
    return lo + t < hi ? (hi - lo - t + S - 1) / S : 0;
  }
};

// cp.async this thread's w and V's rows 0..rows - 1 into its slots (w
// only with `with_w`); waits for nothing
template <typename T>
__device__ __forceinline__ void stage(const Elems<T>& el, const T* wc,
                                      const T* Vc, int n, int rows,
                                      bool with_w) {
  const int nq = el.count();
  for (int q = 0; q < nq; ++q) {
    const int e = el.e(q);
    if (with_w) mpp::cp_async<sizeof(T)>(el.ws + q * el.S, wc + e);
    for (int i = 0; i < rows; ++i)
      mpp::cp_async<sizeof(T)>(el.vs + (i * el.Q + q) * el.S,
                               Vc + static_cast<size_t>(i) * n + e);
  }
  mpp::cp_async_commit();
}

__device__ __forceinline__ void staged() { mpp::cp_async_wait<0>(); }

// this thread's partial dots of rows b0 .. b0 + R - 1 (those <= j) with w:
// held, from its slots an element at a time; else from global memory four
// rows at a time over its elements (each row's sum in element order
// either way)
template <typename T, int R>
__device__ __forceinline__ void partial_dots(const Elems<T>& el,
                                             const T* __restrict__ wc,
                                             const T* __restrict__ Vc,
                                             int n, int b0, int j,
                                             T (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = T(0);
  const int nq = el.count();
  if (el.held) {
    for (int q = 0; q < nq; ++q) {
      const T we = el.ws[q * el.S];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // rows past j: the index clamped to row j, so that no load the
        // compiler hoists past the test leaves the slots
        const T v = el.vs[(min(b0 + r, j) * el.Q + q) * el.S];
        if (b0 + r <= j) acc[r] = fmadd(v, we, acc[r]);
      }
    }
    return;
  }
  constexpr int kRows = R < 4 ? R : 4;
#pragma unroll
  for (int r0 = 0; r0 < R; r0 += kRows) {
    if (b0 + r0 > j) break;
#pragma unroll 4
    for (int q = 0; q < nq; ++q) {
      const int e = el.e(q);
      const T we = wc[e];
#pragma unroll
      for (int r = r0; r < r0 + kRows; ++r) {
        const T v = Vc[static_cast<size_t>(min(b0 + r, j)) * n + e];
        if (b0 + r <= j) acc[r] = fmadd(v, we, acc[r]);
      }
    }
  }
}

// w' = w - sum_{i <= j} h_i V_i on this thread's elements (held: into its
// w slots; else into V's row j + 1, not yet normalised); returns their
// partial sum of squares
template <typename T>
__device__ __forceinline__ T orthogonalise(const Elems<T>& el,
                                           const T* __restrict__ wc, T* Vc,
                                           const T* h, int n, int j) {
  T* Vn = Vc + static_cast<size_t>(j + 1) * n;
  T ss = T(0);
  const int nq = el.count();
  for (int q = 0; q < nq; ++q) {
    const int e = el.e(q);
    T s = T(0);
    T wn;
    if (el.held) {
#pragma unroll 4
      for (int i = 0; i <= j; ++i)
        s = fmadd(h[i], el.vs[(i * el.Q + q) * el.S], s);
      wn = sub(el.ws[q * el.S], s);
      el.ws[q * el.S] = wn;
    } else {   // eight rows' loads in flight along the chain
#pragma unroll 8
      for (int i = 0; i <= j; ++i)
        s = fmadd(h[i], Vc[static_cast<size_t>(i) * n + e], s);
      wn = sub(wc[e], s);
      Vn[e] = wn;
    }
    ss = fmadd(wn, wn, ss);
  }
  return ss;
}

// V_{j+1} = w' / (hlast, or 1 where it is 0) on this thread's elements
template <typename T>
__device__ __forceinline__ void normalise(const Elems<T>& el, T* Vc, int n,
                                          int j, T hlast) {
  T* Vn = Vc + static_cast<size_t>(j + 1) * n;
  const T den = hlast == T(0) ? T(1) : hlast;
  const int nq = el.count();
  for (int q = 0; q < nq; ++q) {
    const int e = el.e(q);
    Vn[e] = quo(el.held ? el.ws[q * el.S] : Vn[e], den);
  }
}

// y (shared, rows < mjv) of the mj-truncated back substitution by one
// warp: Ht H's mjv x mjv block transposed (Ht[r mjv + k] = H[k][r]), gs
// the column's g, num a scratch of mjv values (past 32 rows).  Lane k
// holds row k's running numerator; once y_r = num_r / H[r][r] is known
// (lane r's __ddiv_rn, broadcast by one shuffle) every lane k < r takes
// H[k][r] y_r off its own: a division, a shuffle and an FMA a row, no
// reduction.
template <typename T>
__device__ void back_substitute(const T* Ht, const T* gs, int mjv, T* y,
                                T* num, int lane) {
  if (mjv <= kWarp) {
    T nk = lane < mjv ? gs[lane] : T(0);
    for (int r = mjv - 1; r >= 0; --r) {
      const T hkr = Ht[r * mjv + (lane < r ? lane : r)];
      T yr = T(0);
      if (lane == r) {
        const T hrr = hkr;
        yr = quo(nk, hrr == T(0) ? T(1) : hrr);
        y[r] = yr;
      }
      yr = __shfl_sync(kAll, yr, r);
      if (lane < r) nk = fmadd(-hkr, yr, nk);
    }
    return;
  }
  for (int k = lane; k < mjv; k += kWarp) num[k] = gs[k];
  __syncwarp();
  for (int r = mjv - 1; r >= 0; --r) {
    if (lane == 0) {
      const T hrr = Ht[r * mjv + r];
      y[r] = quo(num[r], hrr == T(0) ? T(1) : hrr);
    }
    __syncwarp();
    const T yr = y[r];
    for (int k = lane; k < r; k += kWarp)
      num[k] = fmadd(-Ht[r * mjv + k], yr, num[k]);
    __syncwarp();
  }
}

// cp.async of H's mjv x mjv block of column c into Ht transposed (Ht[r mjv
// + k] = H[k][r]) and of g's entries < mjv into gs, by `count` threads
// from `first`, as one commit group
template <typename T>
__device__ __forceinline__ void stage_block(const T* H, const T* g, size_t c,
                                            int m, int mjv, T* Ht, T* gs,
                                            int first, int count) {
  const T* Hc = H + c * static_cast<size_t>(m + 1) * m;
  for (int t = first; t < mjv * mjv; t += count) {
    const int k = t / mjv, r = t % mjv;
    mpp::cp_async<sizeof(T)>(Ht + r * mjv + k,
                             Hc + static_cast<size_t>(k) * m + r);
  }
  for (int k = first; k < mjv; k += count)
    mpp::cp_async<sizeof(T)>(gs + k, g + c * (m + 1) + k);
  mpp::cp_async_commit();
}

// x += y V[:mjv] on this thread's elements
template <typename T>
__device__ __forceinline__ void correct(const Elems<T>& el,
                                        const T* __restrict__ Vc,
                                        const T* y, T* __restrict__ xc,
                                        int n, int mjv) {
  const int nq = el.count();
  for (int q = 0; q < nq; ++q) {
    const int e = el.e(q);
    T s = T(0);
    if (el.held) {
#pragma unroll 4
      for (int i = 0; i < mjv; ++i)
        s = fmadd(y[i], el.vs[(i * el.Q + q) * el.S], s);
    } else {
#pragma unroll 8
      for (int i = 0; i < mjv; ++i)
        s = fmadd(y[i], Vc[static_cast<size_t>(i) * n + e], s);
    }
    xc[e] = add(xc[e], s);
  }
}

// ---- form 0: a warp a column -----------------------------------------------

// shared values a column of the step, apart from its slots: h (m + 1), the
// rotated column (m + 2), cs and sn (m each)
__host__ __device__ constexpr int warp_step_values(int m) {
  return (m + 1) + (m + 2) + 2 * m;
}

// shared values a column of the update, apart from its slots: H's block
// (m x m, transposed), g, y and the numerators (m each)
__host__ __device__ constexpr int update_values(int m) {
  return m * m + 3 * m;
}

// a column's (or a CTA's) slots: `rows` rows (the step: w and V's rows
// 0..j; the update: V's rows < m) of Q elements on S threads
__host__ __device__ constexpr long long slot_values(int rows, int Q, int S) {
  return static_cast<long long>(rows) * Q * S;
}

template <typename T, int R>
__global__ void __launch_bounds__(kWarpCols* kWarp)
    arnoldi_warp(const T* __restrict__ w, T* __restrict__ V,
                 T* __restrict__ H, T* __restrict__ cs, T* __restrict__ sn,
                 T* __restrict__ g, const T* __restrict__ tol,
                 long long* __restrict__ mj, unsigned char* __restrict__ found,
                 const unsigned char* __restrict__ done,
                 unsigned char* __restrict__ flags, int ncol, int n, int m,
                 int j, int cap, int held) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cl = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int Q = (n + kWarp - 1) / kWarp;
  T* hs = reinterpret_cast<T*>(smem_raw) +
          static_cast<size_t>(cl) *
              (warp_step_values(m) + (held ? slot_values(j + 2, Q, kWarp)
                                           : 0));
  T* col = hs + (m + 1);
  T* cs_s = col + (m + 2);
  T* sn_s = cs_s + m;
  T* slots = sn_s + m;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    flags[(j + 1) & 1] = 1;
    flags[2] = 0;
  }
  const size_t c = static_cast<size_t>(blockIdx.x) * (blockDim.x / kWarp) + cl;
  if (c >= static_cast<size_t>(ncol)) return;
  const T* wc = w + c * n;
  T* Vc = V + c * static_cast<size_t>(m + 1) * n;
  const Elems<T> el{0, n, lane, kWarp, Q, held != 0,
                    slots + Q * kWarp + lane, slots + lane};
  if (el.held) stage(el, wc, Vc, n, j + 1, true);
  for (int i = lane; i < j; i += kWarp) {
    cs_s[i] = cs[c * m + i];
    sn_s[i] = sn[c * m + i];
  }
  Tail<T> tl{};
  if (lane == 0) tl = load_tail(g, tol, mj, found, done, c, m, j);
  if (el.held) staged();
  T acc[R];
  partial_dots<T, R>(el, wc, Vc, n, 0, j, acc);
  const T p = reduce_scatter<T, R>(acc, lane);
  constexpr int G = kWarp / R;
  if (lane % G == 0 && lane / G <= j) hs[lane / G] = p;
  __syncwarp();   // h; cs_s and sn_s are staged
  const T hlast = root(warp_sum(orthogonalise(el, wc, Vc, hs, n, j)));
  normalise(el, Vc, n, j, hlast);
  if (lane == 0)
    rotate_new(col, rotate_earlier(hs, col, cs_s, sn_s, j), hlast, j, m, c,
               cs, sn, g, tl, mj, found, cap, flags);
  __syncwarp();   // the rotated column
  store_column(H, col, c, m, j, lane, kWarp);
}

template <typename T>
__global__ void __launch_bounds__(kWarpCols* kWarp)
    update_warp(const T* __restrict__ V, const T* __restrict__ H,
                const T* __restrict__ g, const long long* __restrict__ mj,
                const unsigned char* __restrict__ found,
                unsigned char* __restrict__ done, T* __restrict__ x,
                long long* __restrict__ its, unsigned char* __restrict__ flags,
                int ncol, int n, int m, int held) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cl = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int Q = (n + kWarp - 1) / kWarp;
  T* Ht = reinterpret_cast<T*>(smem_raw) +
          static_cast<size_t>(cl) *
              (update_values(m) + (held ? slot_values(m, Q, kWarp) : 0));
  T* gs = Ht + m * m;
  T* y = gs + m;
  T* num = y + m;
  T* slots = num + m;
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    flags[0] = 1;
    flags[1] = 1;
  }
  const size_t c = static_cast<size_t>(blockIdx.x) * (blockDim.x / kWarp) + cl;
  if (c >= static_cast<size_t>(ncol)) return;
  const bool was_done = done[c] != 0;
  const int mjv = static_cast<int>(mj[c]);
  if (!was_done) {
    const T* Vc = V + c * static_cast<size_t>(m + 1) * n;
    const Elems<T> el{0, n, lane, kWarp, Q, held != 0, slots + lane,
                      nullptr};
    stage_block(H, g, c, m, mjv, Ht, gs, lane, kWarp);
    if (el.held) stage<T>(el, nullptr, Vc, n, mjv, false);
    if (el.held)
      mpp::cp_async_wait<1>();   // H's block and g; V's rows may be in flight
    else
      staged();
    __syncwarp();
    back_substitute(Ht, gs, mjv, y, num, lane);
    __syncwarp();   // y
    if (el.held) staged();
    correct(el, Vc, y, x + c * n, n, mjv);
  }
  if (lane == 0) {
    if (!was_done) its[c] += mjv;
    const bool now_done = was_done || found[c] != 0;
    done[c] = now_done ? 1 : 0;
    if (!now_done && flags[2] == 0) flags[2] = 1;   // read first
  }
}

// ---- form 1: a thread-block cluster a column -------------------------------

// The barriers are the non-.aligned forms: the compiler does not see an
// inline barrier as one, so it need not reconverge a warp before it
// (an .aligned barrier reached by a warp still diverged is undefined).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the barrier of the CTA's `count` element threads (its warps but the
// tail's), apart from __syncthreads' barrier 0
__device__ __forceinline__ void elements_sync(int count) {
  asm volatile("barrier.sync 1, %0;\n" :: "r"(count) : "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the address of this CTA's shared address `a` in CTA `rank`'s
__device__ __forceinline__ unsigned peer(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(1) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// the barrier's one arrival, expecting `bytes` of pushes
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// until the barrier's first phase completes (every expected byte landed)
__device__ __forceinline__ void mbar_wait(unsigned bar) {
  unsigned ok = 0;
  while (!ok)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(bar), "r"(0u) : "memory");
}

// one value into a peer's shared memory (cluster address `to`), its bytes
// counted on that peer's barrier (cluster address `bar`)
__device__ __forceinline__ void push(double v, unsigned to, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];\n" :: "r"(to), "l"(__double_as_longlong(v)), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void push(float v, unsigned to, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" :: "r"(to), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

// the copy of `bytes` (a multiple of 16) from this CTA's shared memory
// (`from`, 16-byte aligned) into a peer's (cluster address `to`), counted
// on that peer's barrier (cluster address `bar`) by the copy engine: one
// count a copy, however many values it moves
__device__ __forceinline__ void push_bulk(unsigned to, unsigned from,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];\n"
      :: "r"(to), "r"(from), "r"(bytes), "r"(bar) : "memory");
}
// this thread's shared-memory writes made visible to the copy engine
__device__ __forceinline__ void fence_to_copies() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// values a CTA's partial dots take in its exchange: m + 1 rounded up to 16
// bytes, so every row of the inbox starts 16-byte aligned
__host__ __device__ constexpr int dots_stride(int m, int elem) {
  return ((m + 1) * elem + 15) / 16 * 16 / elem;
}

// shared values a CTA of the cluster step, after its two mbarriers and
// apart from its slots: this CTA's partial dots and every CTA's (P = the
// dots' stride each, 16-byte aligned for the copies), the element warps'
// partial dots (E), h (m + 1), the element warps' partial sums of squares
// (16), every CTA's (CS), the rotated column (m + 2), cs and sn (m each)
__host__ __device__ constexpr int cluster_step_values(int m, int E, int CS,
                                                      int elem) {
  return dots_stride(m, elem) * (CS + 1) + E + (m + 1) +
         kCtaThreads / kWarp + CS + (m + 2) + 2 * m;
}

template <typename T, int R>
__global__ void __launch_bounds__(kCtaThreads + kWarp, 1)
    arnoldi_cluster(const T* __restrict__ w, T* __restrict__ V,
                    T* __restrict__ H, T* __restrict__ cs,
                    T* __restrict__ sn, T* __restrict__ g,
                    const T* __restrict__ tol, long long* __restrict__ mj,
                    unsigned char* __restrict__ found,
                    const unsigned char* __restrict__ done,
                    unsigned char* __restrict__ flags, int n, int m, int j,
                    int cap, int chunk, int held) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int E = static_cast<int>(blockDim.x) - kWarp;
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int CS = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const unsigned bar_dots = smem_u32(smem_raw);
  const unsigned bar_norm = bar_dots + 8;
  const int P = dots_stride(m, sizeof(T));
  T* part = reinterpret_cast<T*>(smem_raw + kBarBytes);
  T* inbox = part + P;
  T* red = inbox + CS * P;
  T* hs = red + E;
  T* ssw = hs + (m + 1);
  T* inbox2 = ssw + kCtaThreads / kWarp;
  T* col = inbox2 + CS;
  T* cs_s = col + (m + 2);
  T* sn_s = cs_s + m;
  T* slots = sn_s + m;
  const size_t c = blockIdx.x / CS;
  const int lo = min(n, rank * chunk), hi = min(n, lo + chunk);
  const int Q = (chunk + E - 1) / E;
  const int rows = j + 1;
  // the bytes of a CTA's partial dots a copy moves
  const unsigned dots_bytes = (rows * sizeof(T) + 15) / 16 * 16;
  if (tid == E) {   // every CTA's partial dots, then partial squares
    mbar_init(bar_dots);
    mbar_init(bar_norm);
    mbar_init_fence();
    mbar_expect(bar_dots, CS * dots_bytes);
    mbar_expect(bar_norm, static_cast<unsigned>(CS * sizeof(T)));
  }
  __syncwarp();
  cluster_arrive();   // this CTA's barriers are set
  if (c == 0 && rank == 0 && tid == 0) {
    flags[(j + 1) & 1] = 1;
    flags[2] = 0;
  }
  const T* wc = w + c * n;
  T* Vc = V + c * static_cast<size_t>(m + 1) * n;
  if (tid >= E) {   // the tail warp
    cluster_wait();
    if (rank != 0) return;
    for (int i = lane; i < j; i += kWarp) {
      cs_s[i] = cs[c * m + i];
      sn_s[i] = sn[c * m + i];
    }
    Tail<T> tl{};
    if (lane == 0) tl = load_tail(g, tol, mj, found, done, c, m, j);
    mbar_wait(bar_dots);
    for (int i = lane; i <= j; i += kWarp) {
      T s = T(0);
      for (int r = 0; r < CS; ++r) s = add(s, inbox[r * P + i]);
      col[i] = s;
    }
    __syncwarp();   // h in col; cs_s and sn_s are staged
    T a = T(0);
    if (lane == 0) a = rotate_earlier(col, col, cs_s, sn_s, j);
    mbar_wait(bar_norm);
    if (lane == 0) {
      T s = T(0);
      for (int r = 0; r < CS; ++r) s = add(s, inbox2[r]);
      rotate_new(col, a, root(s), j, m, c, cs, sn, g, tl, mj, found, cap,
                 flags);
    }
    __syncwarp();   // the rotated column
    store_column(H, col, c, m, j, lane, kWarp);
    return;
  }
  const Elems<T> el{lo, hi, tid, E, Q, held != 0, slots + Q * E + tid,
                    slots + tid};
  if (el.held) {
    stage(el, wc, Vc, n, rows, true);
    staged();
  }
  T acc[R];
  constexpr int G = kWarp / R;
  for (int b0 = 0; b0 <= j; b0 += R) {
    partial_dots<T, R>(el, wc, Vc, n, b0, j, acc);
    const T p = reduce_scatter<T, R>(acc, lane);
    if (lane % G == 0) red[warp * R + lane / G] = p;
    elements_sync(E);   // the warps' partial dots of this pass
    for (int i = tid; i < R && b0 + i <= j; i += E) {
      T s = T(0);
      for (int q = 0; q < E / kWarp; ++q) s = add(s, red[q * R + i]);
      part[b0 + i] = s;
    }
    fence_to_copies();
    elements_sync(E);   // this CTA's partial dots of the pass
  }
  cluster_wait();   // every CTA has set its barriers
  if (tid < CS)     // one copy a CTA
    push_bulk(peer(smem_u32(inbox + rank * P), tid), smem_u32(part),
              dots_bytes, peer(bar_dots, tid));
  mbar_wait(bar_dots);   // every CTA's partial dots
  for (int i = tid; i <= j; i += E) {
    T s = T(0);
    for (int r = 0; r < CS; ++r) s = add(s, inbox[r * P + i]);
    hs[i] = s;
  }
  elements_sync(E);   // h
  const T ss = warp_sum(orthogonalise(el, wc, Vc, hs, n, j));
  if (lane == 0) ssw[warp] = ss;
  elements_sync(E);   // the warps' partial sums of squares
  if (tid == 0) {
    T s = T(0);
    for (int q = 0; q < E / kWarp; ++q) s = add(s, ssw[q]);
    for (int r = 0; r < CS; ++r)
      push(s, peer(smem_u32(inbox2 + rank), r), peer(bar_norm, r));
  }
  mbar_wait(bar_norm);   // every CTA's partial sum of squares
  T s2 = T(0);
  for (int r = 0; r < CS; ++r) s2 = add(s2, inbox2[r]);
  normalise(el, Vc, n, j, root(s2));
}

template <typename T>
__global__ void __launch_bounds__(kCtaThreads, 1)
    update_cluster(const T* __restrict__ V, const T* __restrict__ H,
                   const T* __restrict__ g, const long long* __restrict__ mj,
                   const unsigned char* __restrict__ found,
                   unsigned char* __restrict__ done, T* __restrict__ x,
                   long long* __restrict__ its,
                   unsigned char* __restrict__ flags, int n, int m,
                   int chunk, int held) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int E = static_cast<int>(blockDim.x);
  const int tid = threadIdx.x;
  T* Ht = reinterpret_cast<T*>(smem_raw);
  T* gs = Ht + m * m;
  T* y = gs + m;
  T* num = y + m;
  T* slots = num + m;
  const int CS = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const size_t c = blockIdx.x / CS;
  const int lo = min(n, rank * chunk), hi = min(n, lo + chunk);
  const int Q = (chunk + E - 1) / E;
  if (c == 0 && rank == 0 && tid == 0) {
    flags[0] = 1;
    flags[1] = 1;
  }
  const bool was_done = done[c] != 0;   // the same for the whole cluster
  const int mjv = static_cast<int>(mj[c]);
  __syncwarp();
  cluster_arrive();   // this CTA has read done[c]
  const T* Vc = V + c * static_cast<size_t>(m + 1) * n;
  const Elems<T> el{lo, was_done ? lo : hi, tid, E, Q, held != 0,
                    slots + tid, nullptr};
  if (!was_done) stage_block(H, g, c, m, mjv, Ht, gs, tid, E);
  if (el.held) {
    stage<T>(el, nullptr, Vc, n, mjv, false);
    mpp::cp_async_wait<1>();   // H's block and g; V's rows may be in flight
  } else {
    staged();
  }
  __syncthreads();   // H's block and g
  if (!was_done && tid < kWarp) back_substitute(Ht, gs, mjv, y, num, tid);
  __syncthreads();   // y
  if (el.held) staged();
  correct(el, Vc, y, x + c * n, n, mjv);
  cluster_wait();   // every CTA has read done[c]
  if (rank == 0 && tid == 0) {
    if (!was_done) its[c] += mjv;
    const bool now_done = was_done || found[c] != 0;
    done[c] = now_done ? 1 : 0;
    if (!now_done && flags[2] == 0) flags[2] = 1;   // read first
  }
}

// ---- launchers -------------------------------------------------------------

}  // namespace

// The pointers and the plan of a workspace, bound once by the host
// (hopper_kernels._GmresArgs): form 0 warp (threads 32: a warp a column),
// 1 cluster (ctas CTAs a column, chunk rows and threads element threads a
// CTA)
struct GmresArgs {
  void* V;
  void* H;
  void* cs;
  void* sn;
  void* g;
  const void* tol;
  void* mj;
  void* found;
  void* done;
  void* flags;
  void* x;
  void* its;
  int ncol, n, m, form, ctas, chunk, threads;
};

namespace {

// dynamic shared bytes of a launch without its slots (kernel 0 arnoldi, 1
// update; form 0 warp: kWarpCols columns a block, the most a launch takes;
// form 1 cluster: `threads` element threads, `ctas` CTAs; elem the value's
// bytes): what the form rule checks
long long base_bytes(int kernel, int form, int m, int threads, int ctas,
                     int elem) {
  if (form == 0)
    return static_cast<long long>(kWarpCols) *
           (kernel == 0 ? warp_step_values(m) : update_values(m)) * elem;
  if (kernel == 0)
    return kBarBytes +
           static_cast<long long>(cluster_step_values(m, threads, ctas,
                                                      elem)) * elem;
  return static_cast<long long>(update_values(m)) * elem;
}

// A launch's columns a block (warp form), whether its slots are held, and
// its dynamic shared bytes (-1 where not even the unheld launch fits)
struct Shape {
  int cols, held;
  long long bytes;
};

// the launch of kernel 0 (step j, rows j + 1: the slots hold w and the
// rows) or 1 (the update, rows m): the cluster form holds its slots where
// they fit; the warp form's block takes kWarpCols columns where that is at
// most a quarter of the card's shared memory, else the step one column
// (so that wide slots leave no SM a single block)
Shape plan_shape(int kernel, const GmresArgs& a, int rows, int elem) {
  const int slot_rows = kernel == 0 ? rows + 1 : rows;
  if (a.form == 0) {
    const long long base =
        kernel == 0 ? warp_step_values(a.m) : update_values(a.m);
    const int Q = (a.n + kWarp - 1) / kWarp;
    const long long col = (base + slot_values(slot_rows, Q, kWarp)) * elem;
    const bool wide = kWarpCols * col > mpp::kOnChipBytes / 4;
    // the step reads its rows twice unheld: it holds them in any block
    // that fits; the update reads them once either way, and holds them
    // only where four columns still share a block (its back substitution
    // wants many columns in flight more than its loads do)
    if (kernel == 0 && col <= mpp::kOnChipBytes)
      return wide ? Shape{1, 1, col} : Shape{kWarpCols, 1, kWarpCols * col};
    if (kernel == 1 && !wide) return Shape{kWarpCols, 1, kWarpCols * col};
    return Shape{kWarpCols, 0, kWarpCols * base * elem};
  }
  const long long base = base_bytes(kernel, 1, a.m, a.threads, a.ctas, elem);
  const int Q = (a.chunk + a.threads - 1) / a.threads;
  const long long full = base + slot_values(slot_rows, Q, a.threads) * elem;
  if (full <= mpp::kOnChipBytes) return Shape{1, 1, full};
  return Shape{1, 0, base <= mpp::kOnChipBytes ? base : -1};
}

// the plan, checked: 0 if a launch can take it
int check_args(const GmresArgs& a) {
  if (a.ncol < 1 || a.n < 1 || a.m < 1 || a.form < 0 || a.form > 1)
    return cudaErrorInvalidValue;
  if (a.form == 0 && (a.threads != kWarp || a.m > kWarpMaxM))
    return cudaErrorInvalidValue;
  if (a.form == 1 && (a.ctas < 1 || a.ctas > kMaxCluster || a.chunk < 1 ||
                      static_cast<long long>(a.ctas) * a.chunk < a.n ||
                      a.threads < kWarp || a.threads > kCtaThreads ||
                      a.threads % kWarp != 0))
    return cudaErrorInvalidValue;
  return 0;
}

// the rows of a pass of the dots: the power of two >= j + 1, from 4 to 32
// in the warp form and to kClusterRows in the cluster form (more passes
// past it: 32 accumulators spill in a CTA of 544 threads)
int pass_rows(int j, int form) {
  const int r = j + 1;
  const int most = form == 0 ? 32 : kClusterRows;
  return r <= 4 ? 4 : r <= 8 ? 8 : r <= 16 || most == 16 ? 16 : 32;
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
  const void* warp_fns[] = {
      reinterpret_cast<const void*>(arnoldi_warp<T, 4>),
      reinterpret_cast<const void*>(arnoldi_warp<T, 8>),
      reinterpret_cast<const void*>(arnoldi_warp<T, 16>),
      reinterpret_cast<const void*>(arnoldi_warp<T, 32>),
      reinterpret_cast<const void*>(update_warp<T>)};
  const void* cluster_fns[] = {
      reinterpret_cast<const void*>(arnoldi_cluster<T, 4>),
      reinterpret_cast<const void*>(arnoldi_cluster<T, 8>),
      reinterpret_cast<const void*>(arnoldi_cluster<T, kClusterRows>),
      reinterpret_cast<const void*>(update_cluster<T>)};
  for (const void* fn : warp_fns) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             mpp::kOnChipBytes);
    if (e != cudaSuccess) return e;
  }
  for (const void* fn : cluster_fns) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             mpp::kOnChipBytes);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  if (recorded) done[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

template <typename T>
int ready() {
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

template <typename T, int R>
int launch_step(const T* w, const GmresArgs& a, int j, int cap,
                const Shape& sh, cudaStream_t st) {
  T* V = static_cast<T*>(a.V);
  T* H = static_cast<T*>(a.H);
  T* cs = static_cast<T*>(a.cs);
  T* sn = static_cast<T*>(a.sn);
  T* g = static_cast<T*>(a.g);
  const T* tol = static_cast<const T*>(a.tol);
  auto* mj = static_cast<long long*>(a.mj);
  auto* found = static_cast<unsigned char*>(a.found);
  auto* done = static_cast<const unsigned char*>(a.done);
  auto* flags = static_cast<unsigned char*>(a.flags);
  const size_t smem = static_cast<size_t>(sh.bytes);
  if (a.form == 0) {
    const unsigned blocks =
        static_cast<unsigned>((a.ncol + sh.cols - 1) / sh.cols);
    arnoldi_warp<T, R><<<blocks, sh.cols * kWarp, smem, st>>>(
        w, V, H, cs, sn, g, tol, mj, found, done, flags, a.ncol, a.n, a.m, j,
        cap, sh.held);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int RC = R < kClusterRows ? R : kClusterRows;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(a.ncol, a.ctas, a.threads + kWarp, smem, st, attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, arnoldi_cluster<T, RC>, w, V, H, cs, sn, g, tol, mj, found, done,
      flags, a.n, a.m, j, cap, a.chunk, sh.held);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_arnoldi(const void* w, const GmresArgs* ap, int j, int cap,
                   void* stream) {
  if (ap == nullptr) return cudaErrorInvalidValue;
  const GmresArgs& a = *ap;
  const int e0 = check_args(a);
  if (e0 != 0) return e0;
  if (j < 0 || j >= a.m) return cudaErrorInvalidValue;
  const Shape sh = plan_shape(0, a, j + 1, sizeof(T));
  if (sh.bytes < 0) return cudaErrorInvalidValue;
  const int e1 = ready<T>();
  if (e1 != 0) return e1;
  auto st = static_cast<cudaStream_t>(stream);
  const T* wp = static_cast<const T*>(w);
  switch (pass_rows(j, a.form)) {
    case 4: return launch_step<T, 4>(wp, a, j, cap, sh, st);
    case 8: return launch_step<T, 8>(wp, a, j, cap, sh, st);
    case 16: return launch_step<T, 16>(wp, a, j, cap, sh, st);
    default: return launch_step<T, 32>(wp, a, j, cap, sh, st);
  }
}

template <typename T>
int launch_update(const GmresArgs* ap, void* stream) {
  if (ap == nullptr) return cudaErrorInvalidValue;
  const GmresArgs& a = *ap;
  const int e0 = check_args(a);
  if (e0 != 0) return e0;
  const Shape sh = plan_shape(1, a, a.m, sizeof(T));
  if (sh.bytes < 0) return cudaErrorInvalidValue;
  const int e1 = ready<T>();
  if (e1 != 0) return e1;
  auto st = static_cast<cudaStream_t>(stream);
  const T* V = static_cast<const T*>(a.V);
  const T* H = static_cast<const T*>(a.H);
  const T* g = static_cast<const T*>(a.g);
  auto* mj = static_cast<const long long*>(a.mj);
  auto* found = static_cast<const unsigned char*>(a.found);
  auto* done = static_cast<unsigned char*>(a.done);
  T* x = static_cast<T*>(a.x);
  auto* its = static_cast<long long*>(a.its);
  auto* flags = static_cast<unsigned char*>(a.flags);
  const size_t smem = static_cast<size_t>(sh.bytes);
  if (a.form == 0) {
    const unsigned blocks =
        static_cast<unsigned>((a.ncol + sh.cols - 1) / sh.cols);
    update_warp<T><<<blocks, sh.cols * kWarp, smem, st>>>(
        V, H, g, mj, found, done, x, its, flags, a.ncol, a.n, a.m, sh.held);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(a.ncol, a.ctas, a.threads, smem, st, attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, update_cluster<T>, V, H, g,
                                           mj, found, done, x, its, flags,
                                           a.n, a.m, a.chunk, sh.held);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dynamic shared bytes of a launch without its slots (kernel 0
// gmres_arnoldi, 1 gmres_update; form 0 warp, 4 columns a block, the most
// it takes; 1 cluster with `threads` element threads and `ctas` CTAs;
// elem the value's bytes), as the launchers compute them: what the form
// rule checks
long long mpp_gmres_smem(int kernel, int form, int m, int threads, int ctas,
                         int elem) {
  return base_bytes(kernel, form, m, threads, ctas, elem);
}

// one Arnoldi step j (0 <= j < m) of every column of the workspace `a`,
// given w, in place on V's row j + 1, H's column j, cs, sn, g, mj, found
// and flags; cap 1 where the caller's maxiter ends the cycle at this step
int mpp_gmres_arnoldi_f32(const void* w, const GmresArgs* a, int j, int cap,
                          void* stream) {
  return launch_arnoldi<float>(w, a, j, cap, stream);
}

int mpp_gmres_arnoldi_f64(const void* w, const GmresArgs* a, int j, int cap,
                          void* stream) {
  return launch_arnoldi<double>(w, a, j, cap, stream);
}

// the cycle's update of every column of the workspace `a`, in place on x,
// its, done and flags
int mpp_gmres_update_f32(const GmresArgs* a, void* stream) {
  return launch_update<float>(a, stream);
}

int mpp_gmres_update_f64(const GmresArgs* a, void* stream) {
  return launch_update<double>(a, stream);
}

}  // extern "C"

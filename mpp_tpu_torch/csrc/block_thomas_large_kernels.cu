// Batched block-tridiagonal solve (block Thomas) with m x m blocks, m >= 9,
// for Hopper (sm_90a): the block plans of the compiled steppers past block
// size 8 (vsfm_vchannel "direct" at b = 200, spac_campbell at b = 40, the
// 2-D thermal MMS at b = 20) and the batched MLC from four tree types on
// (m = 2 + 2 ntree).
//
// block_thomas_large — replaces the JAX package's two lax.scan sweeps of
//   block_thomas, mpp_tpu/ops/block_thomas.py:22-122 (forward scan at
//   l.113, back substitution at l.120), with small_solve's m > 8 branch
//   (jnp.linalg.solve, l.68-69) at each level.  There is no
//   pl.pallas_call on this path.
//
// What it computes: x with T x = b, the function of the plain version
// ops/block_thomas.block_thomas at m > 8: per level k
//   denom_k = D_k - L_k Cp_{k-1},
//   [Cp_k | dp_k] = denom_k^-1 [U_k | b_k - L_k dp_{k-1}],
// then x_k = dp_k - Cp_k x_{k+1}.  The level's solve is Gauss-Jordan
// elimination with partial (row) pivoting on the working matrix W = [denom_k
// | U_k | rhs_k] (m x (2m + 1)): at column j the pivot is the row of the
// largest |entry| among the rows not yet pivoted, ties to the lowest row
// and a NaN counted as the largest (the first NaN wins) — LU's pivot
// sequence, with rows numbered as the level's blocks hold them: no row is
// moved, a row's pivot step is recorded instead (pstep, piv) — and column j
// is eliminated from every other row, so that the right-hand part ends as
// X = [Cp_k | dp_k] with row q at W's row piv[q], scaled by its pivot's
// reciprocal.  One pass where LU needs two (getrf's elimination below the
// pivots, then the triangular solve of the m + 1 right-hand columns):
// every column step is a dependent link in the level's chain, and the
// chain, not the arithmetic, sets the time at these shapes.  No pivoting
// across levels (the eliminated diagonal blocks must stay invertible:
// block diagonal dominance).  L[s, 0] and U[s, n-1] are never read; at the
// last level the right-hand part is the rhs alone.  The arithmetic is f64
// for f32 inputs too (the blocks are widened as they are read, x rounded
// once as it is written): a first build whose LU ran in f32 sat farther
// from the f64 solve than twice the plain form's f32 solve at m = 33,
// chip_smoke (z)'s f32 rule.  Sums are FMA chains in an order of their own
// and the pivots' reciprocals multiply, so kernel and plain form agree to
// rounding, not bit for bit.
// NaN: a system's blocks are read by its own thread block or cluster and
// by no other, so a NaN in one system's blocks reaches that system's x and
// no other's.
//
// Two forms, one launch each, picked by the wrapper's rule by shape
// (hopper_kernels.btl_form): never on a failure; a launch the card
// refuses returns its error and the wrapper raises.
//
// form 0, "block" (many systems, narrow blocks): one thread block a
// system, 32 x TY threads (TY = 1 to m = 16, then m / 4 rounded up, at
// most 32), the level loop inside, W in shared memory to m = 119
// (mpp_block_thomas_large_max_on_chip), in the global scratch ws past it.
// A column step: every warp finds the pivot itself from column j (at most
// m values and their pivot steps, reduced by shuffles in the total order,
// so every warp gets the same row without an exchange), takes the pivot's
// reciprocal, and eliminates column j from its rows (the multiplier read
// from W, the pivot row read in place: no row moves, so reading the pivot
// row and writing the others never race); then one __syncthreads.
//
// form 1, "cluster" (few wide systems): a thread-block cluster a system,
// CS CTAs of 256 threads (the wrapper's plan: 8, the portable limit, fewer
// where m has fewer panels, up to 16 where W needs them).  W is split by
// column tiles over the CTAs' shared memory: the denominator's columns in
// panels of kPanel = 16, panel t owned by CTA t % CS, and X's column j with
// denom's column j (the rhs with the CTA of panel m / 16), so the level's
// products L_k [Cp_{k-1} | dp_{k-1}] need nothing from another CTA (column
// j of denom_k reads column j of Cp_{k-1}; L_k is read by every CTA from
// L2), on the f64 tensor cores (mma.sync m8n8k4).  A level, panel by panel:
// the owner runs the panel's 16 Gauss-Jordan steps on the panel's columns
// alone (the pivot search is column-local: no cross-CTA reduction), a row
// a thread in registers, and accumulates the panel's transform M = I - H S
// (S selects the panel's pivot rows R, H is m x 16: step k's multipliers
// become H's column k and update its earlier columns, Gauss-Jordan on the
// identity's selected columns), publishing H, R and the pivots'
// reciprocals in its shared memory; a cluster barrier; every CTA reads
// them through distributed shared memory and updates its trailing columns
// at once, W -= H W[R] (W[R] copied first), a rank-16 update on the tensor
// cores (A = H from the owner, B = W[R] and C = W from its own).  A step
// of the owner: every warp reduces the warps' best candidates (a (key,
// row) pair a warp, written in the step before) to the pivot; the pivot
// row's thread broadcasts its entries and reciprocal; a barrier; every row
// updates and its warp reduces the next column's candidates; a barrier.
// The barrier is split (arrive / wait) for look-ahead: the next panel's
// owner updates that panel's columns first, factors and publishes it and
// arrives, and only then updates the rest of its columns, while the other
// CTAs update theirs; a panel's slot is written again three panels later
// (kSlots), when every CTA has read it.  [Cp_k | dp_k] goes to cp column by
// column from the CTA that owns it; the back substitution runs across the
// cluster, each CTA a range of rows, x_{k+1} gathered from the others'
// shared memory after a cluster barrier.  The chain of 16-step panels is
// the critical path: the other CTAs wait while a panel is factored.  Where
// W and the panel slots do not fit the cluster's shared memory (the plan's
// on_chip false: m > 256) they go to a global scratch, one region a CTA,
// with the same code; rows past the 256 threads stay in shared memory
// during a panel's steps.
//
// Layout: L, D, U row-major [nsys, n, m, m], b and x [nsys, n, m],
// contiguous (the wrapper flattens leading dims into nsys); cp a global f64
// scratch [nsys, n, m, m + 1] (the first n-1 levels' [Cp | dp], read back
// by the back substitution); ws the f64 scratch of the form where W does
// not fit on chip (block: [nsys, m, 2m + 1]; cluster: [nsys, CS, big],
// big = mpp_block_thomas_large_cluster_scratch), else null.  Pointers
// are device pointers, the launch goes on the caller's stream, nothing is
// allocated or synchronised here, and the launcher returns
// cudaGetLastError() (0 on success).  f32 and f64, any n >= 1, any m >= 1.
//
// Bound on the H100: bytes at the batched MLC's [4096, 93, 10] (L, D, U and
// b read once, x written once: (3 m^2 + 2 m) values a level, 0.29 ms in
// f64), operations at one wide system: a level is ~14/3 m^3 flops as
// getrf + getrs count them (chip_smoke.btl_ops), at [1, 30, 200] f64 1.09
// GFLOP, 0.0163 ms at the f64 tensor cores' 67 TFLOP/s.  Neither binds a
// wide system: its level is a chain of m dependent column steps (search,
// reciprocal, update, barrier), 6,000 at [1, 30, 200]; the cluster form
// spreads the arithmetic over CS SMs and keeps W on chip, so the chain is
// what is left.
// ---------------------------------------------------------------------------

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstddef>

#include "column_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kPanel = 16;                // columns of a panel (cluster form)
constexpr int kClusterWarps = 8;
constexpr int kClusterThreads = kClusterWarps * kWarp;
constexpr int kMaxCluster = 16;           // with the non-portable attribute
// panel slots a CTA: panel g in slot g % 3, so a slot is written again
// only three panels later, when every CTA has read it (a CTA arrives at
// the next panel's barrier before it has finished its update with this
// one only when it owns the next panel)
constexpr int kSlots = 3;

// The pivot key of a candidate entry v: the bits of |v| (for IEEE doubles
// their unsigned order is the order of |v|), every NaN one value above
// +Inf (so NaNs tie, and the lower row wins), plus one, so that 0 marks
// no candidate.  Larger key, better pivot; equal keys, the lower row: the
// total order "largest |entry|, ties to the lower row, a NaN the
// largest".
__device__ __forceinline__ unsigned long long pivot_key(double v) {
  const unsigned long long k =
      static_cast<unsigned long long>(__double_as_longlong(v)) &
      0x7fffffffffffffffull;
  return (k > 0x7ff0000000000000ull ? 0x7ff0000000000001ull : k) + 1;
}

// The warp's best (key, row) from each lane's, its rows taken in ascending
// order (a later row wins only with a larger key): three warp reductions
// (redux.sync), the largest key's high word, its low word among the lanes
// that hold that high word, the lowest row among the lanes that hold the
// whole key; pivot_of, its row.  Every lane, and every warp that reduces
// the same candidates, gets the same row.
__device__ __forceinline__ void warp_best(unsigned long long& bk, int& br) {
  const unsigned hi = static_cast<unsigned>(bk >> 32);
  const unsigned mhi = __reduce_max_sync(kAll, hi);
  const unsigned lo = hi == mhi ? static_cast<unsigned>(bk) : 0u;
  const unsigned mlo = __reduce_max_sync(kAll, lo);
  const unsigned row = hi == mhi && lo == mlo ? static_cast<unsigned>(br)
                                               : 0xffffffffu;
  br = static_cast<int>(__reduce_min_sync(kAll, row));
  bk = static_cast<unsigned long long>(mhi) << 32 | mlo;
}
__device__ __forceinline__ int pivot_of(unsigned long long bk, int br) {
  warp_best(bk, br);
  return br;
}

// Called by every warp (block form): the pivot row of column `col` of W
// (row stride ld) among the rows i < m not pivoted before step j (pstep[i]
// >= j: a row pivoted at step j itself still counts, so a warp that reads
// the step's own mark finds the same row).
__device__ __forceinline__ int find_pivot(const double* W, size_t ld, int col,
                                          const int* pstep, int m, int j) {
  unsigned long long bk = 0;
  int br = INT_MAX;
#pragma unroll 4
  for (int i = threadIdx.x % kWarp; i < m; i += kWarp) {
    const unsigned long long k =
        pstep[i] >= j ? pivot_key(W[i * ld + col]) : 0ull;
    if (k > bk) {
      bk = k;
      br = i;
    }
  }
  return pivot_of(bk, br);
}

// the cluster barrier in two halves: arrive (release: this thread's
// writes, the published panel among them, become visible to the cluster)
// and wait (acquire: until every thread of the cluster has arrived)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---- form 0: a thread block a system ---------------------------------------

// warps a block: one to m = 16 (many systems a launch), then one per 4
// rows, at most 32, so that a warp's rows of a column step are one group
__host__ __device__ constexpr int warps_for(int m) {
  return m <= 16 ? 1 : ((m + 3) / 4 < 32 ? (m + 3) / 4 : 32);
}

// shared bytes (every value in f64): W when on chip, the rhs (later the
// back substitution's x_{k+1}), x_k and the pivots' reciprocals (m values
// each), the pivot rows and each row's pivot step (m ints each)
__host__ __device__ constexpr size_t block_smem(int m, bool on_chip) {
  return (static_cast<size_t>(on_chip ? m * (2 * m + 1) : 0) +
          3 * static_cast<size_t>(m)) * sizeof(double) +
         2 * static_cast<size_t>(m) * sizeof(int);
}

// the largest m whose W fits a block's shared memory
int max_on_chip() {
  int m = 1;
  while (block_smem(m + 1, true) <= mpp::kOnChipBytes) ++m;
  return m;
}

template <typename T, bool kOnChip>
__global__ void __launch_bounds__(1024)
btl_block_kernel(const T* __restrict__ L, const T* __restrict__ D,
                 const T* __restrict__ U, const T* __restrict__ b,
                 double* cp, double* ws, T* x, int n, int m) {
  using C = double;                     // the arithmetic, for f32 too
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* sm = reinterpret_cast<C*>(smem_raw);
  const size_t ld = 2 * static_cast<size_t>(m) + 1;
  const size_t s = blockIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y, TY = blockDim.y;
  const int tid = ty * kWarp + tx, nthr = TY * kWarp;
  C* W = kOnChip ? sm : ws + s * m * ld;
  C* r = kOnChip ? sm + m * ld : sm;      // m values
  C* xb = r + m;                          // m values
  C* dinv = xb + m;                       // m values
  int* piv = reinterpret_cast<int*>(dinv + m);
  int* pstep = piv + m;
  const size_t blk = static_cast<size_t>(m) * m;
  const size_t rec = static_cast<size_t>(m) * (m + 1);     // [Cp | dp]
  const int rhs = 2 * m;                                    // W's last column

  for (int k = 0; k < n; ++k) {
    const bool last = k == n - 1;
    const size_t o = (s * n + k) * blk;
    const size_t ov = (s * n + k) * m;
    // W's left part and the rhs: D_k - L_k Cp_{k-1}, b_k - L_k dp_{k-1}
    // ([Cp_{k-1} | dp_{k-1}] is W's right part, its row q at row piv[q]);
    // D_k and b_k at k = 0
    if (k == 0) {
      for (int i = ty; i < m; i += TY)
        for (int c = tx; c < m; c += kWarp)
          W[i * ld + c] = static_cast<C>(D[o + i * m + c]);
      for (int i = tid; i < m; i += nthr) r[i] = static_cast<C>(b[ov + i]);
    } else {
      for (int i = ty; i < m; i += TY) {
        const T* Li = L + o + static_cast<size_t>(i) * m;
        for (int c = tx; c <= m; c += kWarp) {
          C acc = C(0);
          for (int q = 0; q < m; ++q)
            acc = fma(static_cast<C>(Li[q]), W[piv[q] * ld + m + c], acc);
          if (c < m) W[i * ld + c] = static_cast<C>(D[o + i * m + c]) - acc;
          else r[i] = static_cast<C>(b[ov + i]) - acc;
        }
      }
    }
    __syncthreads();
    // W's right part: U_k (not at the last level, whose right-hand part is
    // the rhs alone) and the rhs; every row a pivot candidate
    for (int i = ty; i < m; i += TY) {
      if (!last)
        for (int c = tx; c < m; c += kWarp)
          W[i * ld + m + c] = static_cast<C>(U[o + i * m + c]);
      if (tx == 0) {
        W[i * ld + rhs] = r[i];
        pstep[i] = INT_MAX;
      }
    }
    __syncthreads();

    // Gauss-Jordan: one __syncthreads a column
    const int xbeg = last ? rhs : m;    // the right-hand columns eliminated
    for (int j = 0; j < m; ++j) {
      const int p = find_pivot(W, ld, j, pstep, m, j);
      const C* Wp = W + p * ld;
      const C rcp = __drcp_rn(Wp[j]);      // 1 / pivot, IEEE rounded
      if (tid == 0) {
        pstep[p] = j;
        piv[j] = p;
        dinv[j] = rcp;
      }
      const int nl = m - 1 - j;          // the left columns j+1 .. m-1
      const int nc = nl + rhs + 1 - xbeg;
      // four rows of the warp at a time, every load before the stores
      // (the compiler cannot tell W's rows apart)
      for (int i0 = ty; i0 < m; i0 += 4 * TY) {
        C f[4];
        C* Wr[4];
        bool live[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = i0 + u * TY;
          live[u] = i < m && i != p;
          Wr[u] = W + (live[u] ? i : p) * ld;
          f[u] = live[u] ? Wr[u][j] * rcp : C(0);
        }
        for (int e = tx; e < nc; e += kWarp) {
          const int c = e < nl ? j + 1 + e : xbeg + e - nl;
          const C pv = Wp[c];
          C v[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) v[u] = Wr[u][c];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (live[u]) Wr[u][c] = fma(-f[u], pv, v[u]);
        }
      }
      __syncthreads();
    }
    // X = [Cp_k | dp_k]: row q is W's row piv[q] times the pivot's
    // reciprocal, scaled in place (the next level's products read it
    // there) and stored to cp for the back substitution; at the last level
    // dp alone, x_{n-1}
    if (!last) {
      C* out = cp + (s * n + k) * rec;
      for (int q = ty; q < m; q += TY) {
        C* Xq = W + piv[q] * ld + m;
        const C dq = dinv[q];
        for (int c = tx; c <= m; c += kWarp) {
          const C v = Xq[c] * dq;
          Xq[c] = v;
          out[q * (m + 1) + c] = v;
        }
      }
    } else {
      for (int q = tid; q < m; q += nthr) {
        const C v = W[piv[q] * ld + rhs] * dinv[q];
        r[q] = v;
        x[ov + q] = static_cast<T>(v);
      }
    }
    __syncthreads();
  }

  // back substitution: x_k = dp_k - Cp_k x_{k+1}, x_{n-1} = dp_{n-1}
  C* xa = r;
  for (int k = n - 2; k >= 0; --k) {
    const C* Ck = cp + (s * n + k) * rec;
    const size_t ov = (s * n + k) * m;
    for (int i = ty; i < m; i += TY) {
      const C* Ci = Ck + static_cast<size_t>(i) * (m + 1);
      C acc = C(0);
      for (int c = tx; c < m; c += kWarp) acc = fma(Ci[c], xa[c], acc);
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(kAll, acc, off);
      if (tx == 0) {
        const C v = Ci[m] - acc;
        xb[i] = v;
        x[ov + i] = static_cast<T>(v);
      }
    }
    __syncthreads();
    C* t = xa;
    xa = xb;
    xb = t;
  }
}

// ---- form 1: a thread-block cluster a system -------------------------------

__host__ __device__ constexpr int up8(int v) { return (v + 7) / 8 * 8; }

// The cluster form's layout, the same in every CTA of a cluster (so a CTA
// finds another's arrays at its own offsets).  Per CTA, in f64 values:
// "big" — the W tile (m8 rows x ld: the CTA's denominator columns, then its
// X columns, each part padded to 8, ld odd) and kSlots panel slots (H, m8
// x (kPanel + 1), then the pivot reciprocals and rows, kPanel each), in
// shared memory when on chip, else in the global scratch; then in shared
// memory always: Y (the pivot rows' copy, kPanel x ld), the rhs, the
// pivots' reciprocals and x_{k+1} (m8 each), the back substitution's two
// row slices, the warps' pivot candidates (two buffers of kClusterWarps
// keys and rows, 64-bit words), the pivot row of a panel step (kPanel);
// then the ints: the pivot rows and each row's pivot step.
struct ClusterLayout {
  int m, cs, m8, panels, np, a8, x8, ld, hld, rows;
  size_t slot, big, r, dinv, xfull, xs, key, prow, dbl, ints;

  __host__ __device__ ClusterLayout(int m_, int cs_) : m(m_), cs(cs_) {
    m8 = up8(m);
    panels = (m + kPanel - 1) / kPanel;
    np = (panels + cs - 1) / cs;          // panels a CTA, at most
    a8 = np * kPanel;
    x8 = up8(np * kPanel + 1);
    ld = a8 + x8 + 1;
    hld = kPanel + 1;
    rows = (m + cs - 1) / cs;             // back substitution rows a CTA
    slot = static_cast<size_t>(m8) * hld + 2 * kPanel;
    big = static_cast<size_t>(m8) * ld + kSlots * slot;
    r = static_cast<size_t>(kPanel) * ld;   // offsets past big, in values
    dinv = r + m8;
    xfull = dinv + m8;
    xs = xfull + m8;
    key = xs + 2 * static_cast<size_t>(rows);
    prow = key + 4 * kClusterWarps;
    dbl = prow + kPanel;
    ints = 2 * static_cast<size_t>(m8);
  }
  // shared bytes: with big on chip or not
  __host__ __device__ size_t smem(bool on_chip) const {
    return ((on_chip ? big : 0) + dbl) * sizeof(double) + ints * sizeof(int);
  }
};

// global panel index and width of this CTA's t-th panel (width 0: none)
__device__ __forceinline__ int panel_width(const ClusterLayout& lay, int g) {
  const int w = lay.m - g * kPanel;
  return g < lay.panels ? (w < kPanel ? w : kPanel) : 0;
}

// denominator columns held by CTA `rank`
__device__ __forceinline__ int own_columns(const ClusterLayout& lay,
                                           int rank) {
  int a = 0;
  for (int g = rank; g < lay.panels; g += lay.cs) a += panel_width(lay, g);
  return a;
}

// D = A B + D on the f64 tensor cores, one 8 x 8 x 4 step: a is A[g][t],
// b is B[t][g], d0, d1 are D[g][2t], D[g][2t + 1] (g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma884(double& d0, double& d1, double a,
                                       double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

template <typename T, bool kOnChip>
__global__ void __launch_bounds__(kClusterThreads)
btl_cluster_kernel(const T* __restrict__ L, const T* __restrict__ D,
                   const T* __restrict__ U, const T* __restrict__ b,
                   double* cp, double* ws, T* x, int n, int m) {
  using C = double;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cl = cg::this_cluster();
  const int cs = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const size_t s = blockIdx.x / cs;
  const ClusterLayout lay(m, cs);
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int g8 = lane / 4, t4 = lane % 4;
  const int ld = lay.ld, hld = lay.hld, a8 = lay.a8, m8 = lay.m8;

  C* sm = reinterpret_cast<C*>(smem_raw);
  // big: the W tile and two panel slots, on chip or in this CTA's region
  C* big = kOnChip ? sm : ws + (s * cs + rank) * lay.big;
  C* small = kOnChip ? sm + lay.big : sm;
  C* W = big;
  C* Y = small;
  C* r = small + lay.r;
  C* dinv = small + lay.dinv;
  C* xfull = small + lay.xfull;
  C* xs = small + lay.xs;
  auto* key = reinterpret_cast<unsigned long long*>(small + lay.key);
  C* prow = small + lay.prow;
  int* piv = reinterpret_cast<int*>(small + lay.dbl);
  int* pstep = piv + m8;
  // another CTA's copy of an array of big (W, a slot)
  auto peer_big = [&](C* p, int who) -> const C* {
    if (kOnChip) return cl.map_shared_rank(p, who);
    return p + (static_cast<ptrdiff_t>(who) - rank) *
                   static_cast<ptrdiff_t>(lay.big);
  };

  const int a_r = own_columns(lay, rank);   // my denominator columns
  const int rhs_owner = (m / kPanel) % cs;
  const bool owns_rhs = rhs_owner == rank;
  // my local denominator column l <-> the level's column j
  auto col_of = [&](int l) { return ((l / kPanel) * cs + rank) * kPanel +
                                    l % kPanel; };
  const size_t blk = static_cast<size_t>(m) * m;
  const size_t rec = static_cast<size_t>(m) * (m + 1);

  // zero the tile, both slots and Y: the padding rows and columns stay 0
  for (size_t e = tid; e < lay.big; e += kClusterThreads) big[e] = C(0);
  for (size_t e = tid; e < static_cast<size_t>(kPanel) * ld;
       e += kClusterThreads)
    Y[e] = C(0);
  __syncthreads();

  for (int k = 0; k < n; ++k) {
    const bool last = k == n - 1;
    const size_t o = (s * n + k) * blk;
    const size_t ov = (s * n + k) * m;
    // my denominator columns of D_k - L_k Cp_{k-1} and (the rhs's owner)
    // b_k - L_k dp_{k-1}: [Cp_{k-1} | dp_{k-1}] is my X part, row q at W's
    // row piv[q]; the products on the tensor cores, a warp a block of 8
    // rows, A = L_k from global memory (L2), B = X from shared memory
    const int xr = a_r + (owns_rhs ? 1 : 0);   // my X columns
    if (k == 0) {
      for (int e = tid; e < m * a_r; e += kClusterThreads) {
        const int i = e / a_r, l = e % a_r;
        W[i * ld + l] = static_cast<C>(D[o + i * m + col_of(l)]);
      }
      if (owns_rhs)
        for (int i = tid; i < m; i += kClusterThreads)
          r[i] = static_cast<C>(b[ov + i]);
    } else {
      const int ncb = up8(xr) / 8;
      for (int rb = warp; rb < m8 / 8; rb += kClusterWarps) {
        const int row = rb * 8 + g8;
        const T* Lr = L + o + static_cast<size_t>(row < m ? row : 0) * m;
        for (int cb0 = 0; cb0 < ncb; cb0 += 4) {
          C acc[4][2] = {};
          for (int q0 = 0; q0 < m; q0 += 16) {
            C a[4], bq[4][4];
#pragma unroll
            for (int st = 0; st < 4; ++st) {
              const int q = q0 + 4 * st + t4;
              a[st] = row < m && q < m ? static_cast<C>(Lr[q]) : C(0);
              const C* Xq = W + (q < m ? piv[q] : 0) * ld + a8;
#pragma unroll
              for (int u = 0; u < 4; ++u)
                bq[st][u] = q < m && cb0 + u < ncb ? Xq[(cb0 + u) * 8 + g8]
                                                   : C(0);
            }
#pragma unroll
            for (int st = 0; st < 4; ++st)
#pragma unroll
              for (int u = 0; u < 4; ++u)
                if (cb0 + u < ncb)
                  mma884(acc[u][0], acc[u][1], a[st], bq[st][u]);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int l = (cb0 + u) * 8 + 2 * t4 + h;
              if (cb0 + u >= ncb || row >= m) continue;
              if (l < a_r)
                W[row * ld + l] =
                    static_cast<C>(D[o + row * m + col_of(l)]) - acc[u][h];
              else if (l == a_r && owns_rhs)
                r[row] = static_cast<C>(b[ov + row]) - acc[u][h];
            }
        }
      }
    }
    __syncthreads();
    // my X part: U_k's columns (not at the last level) and the rhs; every
    // row a pivot candidate
    if (!last)
      for (int e = tid; e < m * a_r; e += kClusterThreads) {
        const int i = e / a_r, l = e % a_r;
        W[i * ld + a8 + l] = static_cast<C>(U[o + i * m + col_of(l)]);
      }
    for (int i = tid; i < m; i += kClusterThreads) {
      if (owns_rhs) W[i * ld + a8 + a_r] = r[i];
      pstep[i] = INT_MAX;
    }
    __syncthreads();

    // panel q of this level in slot (k * panels + q) % kSlots of its
    // owner: H (m8 x hld), the pivots' reciprocals, the pivot rows
    auto slot_of = [&](int q) {
      return big + static_cast<size_t>(m8) * ld +
             ((k * lay.panels + q) % kSlots) * lay.slot;
    };
    // The owner's Gauss-Jordan steps of panel q on the panel's own columns,
    // H alongside, published in its slot.  Thread t holds row t's panel
    // entries in registers, v[c]: W's for c >= kk, H's for c < kk (step kk
    // turns entry kk into the row's multiplier, H's column kk); rows past
    // the threads (m > kClusterThreads) stay in shared memory.  A step:
    // every warp finds the pivot row p from the warps' best candidates
    // (kClusterWarps (key, row) pairs); p's entries go to prow; a barrier;
    // every row takes its multiplier f = v[kk] / prow[kk] and v[c] -= f
    // prow[c] for c != kk, and each warp reduces its rows' keys of column
    // kk + 1 to its candidate for the next step (two buffers, so a step's
    // search and the writes for the next never meet); a barrier.
    auto factor = [&](int q) {
      C* H = slot_of(q);
      C* srcp = H + static_cast<size_t>(m8) * hld;
      C* srow = srcp + kPanel;
      const int w = panel_width(lay, q);
      const int lc0 = (q - rank) / cs * kPanel;
      const int j0 = q * kPanel;
      const bool reg = tid < m;
      C v[kPanel];
      const C* Wt = W + static_cast<size_t>(reg ? tid : 0) * ld + lc0;
#pragma unroll
      for (int c = 0; c < kPanel; ++c) v[c] = reg && c < w ? Wt[c] : C(0);
      // this warp's candidate for step kk in slot (kk & 1): the best
      // (key, row) of its threads' rows
      auto publish = [&](int kk, unsigned long long bk, int br) {
        warp_best(bk, br);
        if (lane == 0) {
          key[(kk & 1) * 2 * kClusterWarps + warp] = bk;
          key[(kk & 1) * 2 * kClusterWarps + kClusterWarps + warp] =
              static_cast<unsigned long long>(br);
        }
      };
      {
        unsigned long long bk = reg && pstep[tid] >= j0 ? pivot_key(v[0])
                                                        : 0ull;
        int br = bk ? tid : INT_MAX;
        for (int i = tid + kClusterThreads; i < m; i += kClusterThreads) {
          for (int c = 0; c < kPanel; ++c)
            H[static_cast<size_t>(i) * hld + c] = C(0);
          const unsigned long long k =
              pstep[i] >= j0 ? pivot_key(W[static_cast<size_t>(i) * ld + lc0])
                             : 0ull;
          if (k > bk) {
            bk = k;
            br = i;
          }
        }
        publish(0, bk, br);
      }
      __syncthreads();
      for (int kk = 0; kk < w; ++kk) {
        const int j = j0 + kk;
        const unsigned long long* slot_k =
            key + (kk & 1) * 2 * kClusterWarps;
        const int p =
            pivot_of(lane < kClusterWarps ? slot_k[lane] : 0ull,
                     lane < kClusterWarps
                         ? static_cast<int>(slot_k[kClusterWarps + lane])
                         : INT_MAX);
        if (p == tid) {
#pragma unroll
          for (int c = 0; c < kPanel; ++c) prow[c] = v[c];
        } else if (p >= kClusterThreads && p % kClusterThreads == tid) {
          for (int c = 0; c < kPanel; ++c)
            prow[c] = c < kk ? H[static_cast<size_t>(p) * hld + c]
                      : c < w ? W[static_cast<size_t>(p) * ld + lc0 + c]
                              : C(0);
        }
        if (tid == 0) {
          pstep[p] = j;
          srow[kk] = static_cast<C>(p);
        }
        __syncthreads();
        const C rcp = __drcp_rn(prow[kk]);
        if (tid == 0) srcp[kk] = rcp;
        if (reg) {
          // (v is indexed by unrolled constants only: it stays in registers)
          if (tid == p) {
#pragma unroll
            for (int c = 0; c < kPanel; ++c)
              if (c == kk) v[c] = C(0);     // the pivot row's H entry
          } else {
            C pr[kPanel], vk = C(0);
#pragma unroll
            for (int c = 0; c < kPanel; ++c) {
              pr[c] = prow[c];
              if (c == kk) vk = v[c];
            }
            const C f = vk * rcp;
#pragma unroll
            for (int c = 0; c < kPanel; ++c)
              v[c] = c == kk ? f : fma(-f, pr[c], v[c]);
          }
        }
        // the next column's candidates: my rows' keys, my warp's best
        unsigned long long bk = 0;
        int br = INT_MAX;
        if (reg && kk + 1 < w && tid != p && pstep[tid] >= j) {
          C nx = C(0);
#pragma unroll
          for (int c = 1; c < kPanel; ++c)
            if (c == kk + 1) nx = v[c];
          bk = pivot_key(nx);
          br = tid;
        }
        for (int i = tid + kClusterThreads; i < m; i += kClusterThreads) {
          C* Hi = H + static_cast<size_t>(i) * hld;
          C* Wi = W + static_cast<size_t>(i) * ld + lc0;
          if (i == p) {
            Hi[kk] = C(0);
            continue;
          }
          const C f = Wi[kk] * rcp;
          for (int c = 0; c < kk; ++c) Hi[c] = fma(-f, prow[c], Hi[c]);
          Hi[kk] = f;
          for (int c = kk + 1; c < w; ++c) Wi[c] = fma(-f, prow[c], Wi[c]);
          if (kk + 1 < w && pstep[i] >= j) {
            const unsigned long long k = pivot_key(Wi[kk + 1]);
            if (k > bk) {
              bk = k;
              br = i;
            }
          }
        }
        if (kk + 1 < w) publish(kk + 1, bk, br);
        __syncthreads();
      }
      if (reg) {
        C* Ht = H + static_cast<size_t>(tid) * hld;
#pragma unroll
        for (int c = 0; c < kPanel; ++c) Ht[c] = v[c];
      }
      if (!kOnChip) __threadfence();
    };
    // W -= H W[R] with panel q's H (from its owner) and W[R] (in Y) on my
    // column blocks [lo, hi) of 8 but ex and ex + 1; at the last level the
    // X part is the rhs's block alone.  A warp a block of 8 rows, its A
    // (-H) read once, four column blocks at a time (their loads, then 16
    // mma.sync)
    const int cb_rhs = (a8 + a_r) / 8;
    auto skip = [&](int cb, int ex) {
      return (last && cb >= a8 / 8 && !(owns_rhs && cb == cb_rhs)) ||
             cb == ex || cb == ex + 1;
    };
    auto update = [&](int q, int lo, int hi, int ex) {
      const C* rH = peer_big(slot_of(q), q % cs);
      for (int rb = warp; rb < m8 / 8; rb += kClusterWarps) {
        const int row = rb * 8 + g8;
        C a[kPanel / 4];
#pragma unroll
        for (int kq = 0; kq < kPanel / 4; ++kq)
          a[kq] = -rH[static_cast<size_t>(row) * hld + kq * 4 + t4];
        C* Wrow = W + static_cast<size_t>(row) * ld + 2 * t4;
        for (int cb0 = lo; cb0 < hi; cb0 += 4) {
          bool live[4];
          C d[4][2], bq[4][kPanel / 4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int cb = cb0 + u;
            live[u] = cb < hi && !skip(cb, ex);
            if (live[u]) {
              d[u][0] = Wrow[cb * 8];
              d[u][1] = Wrow[cb * 8 + 1];
#pragma unroll
              for (int kq = 0; kq < kPanel / 4; ++kq)
                bq[u][kq] = Y[(kq * 4 + t4) * ld + cb * 8 + g8];
            }
          }
#pragma unroll
          for (int kq = 0; kq < kPanel / 4; ++kq)
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (live[u]) mma884(d[u][0], d[u][1], a[kq], bq[u][kq]);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (live[u]) {
              Wrow[(cb0 + u) * 8] = d[u][0];
              Wrow[(cb0 + u) * 8 + 1] = d[u][1];
            }
        }
      }
    };

    // the panels, with look-ahead: the next panel's owner updates that
    // panel's columns first, factors and publishes it, and only then
    // updates the rest of its columns, while the other CTAs update theirs
    // The barrier of panel q: its owner arrives when it has published it,
    // the others when they have updated their columns with panel q - 1;
    // every CTA waits on it before reading panel q.
    if (rank == 0) factor(0);
    cluster_arrive();
    for (int q = 0; q < lay.panels; ++q) {
      const int w = panel_width(lay, q);
      cluster_wait();                      // panel q is published
      const C* rslot = peer_big(slot_of(q), q % cs);
      if (tid < w) {
        const int p = static_cast<int>(rslot[m8 * hld + kPanel + tid]);
        piv[q * kPanel + tid] = p;
        dinv[q * kPanel + tid] = rslot[m8 * hld + tid];
        pstep[p] = q * kPanel + tid;
      }
      __syncthreads();
      // my trailing columns: the local denominator columns after panel q's
      // and my X part; W[R] copied to Y first (the update writes W's rows R)
      const int lo = (q >= rank ? (q - rank) / cs + 1 : 0) * kPanel / 8;
      const int hi = (a8 + up8(xr)) / 8;
      for (int e = tid; e < kPanel * (hi - lo) * 8; e += kClusterThreads) {
        const int t = e / ((hi - lo) * 8);
        const int c = lo * 8 + e % ((hi - lo) * 8);
        if (!skip(c / 8, -2))
          Y[t * ld + c] = t < w ? W[static_cast<size_t>(
                                        piv[q * kPanel + t]) * ld + c]
                                : C(0);
      }
      __syncthreads();
      const int next = q + 1;
      if (next < lay.panels && next % cs == rank) {
        const int nb = (next - rank) / cs * kPanel / 8;
        update(q, nb, nb + 2, -2);
        __syncthreads();
        factor(next);
        cluster_arrive();
        update(q, lo, hi, nb);
      } else {
        update(q, lo, hi, -2);
        if (next < lay.panels) cluster_arrive();
      }
      __syncthreads();
    }
    // X = [Cp_k | dp_k] in my columns: row q is W's row piv[q] times its
    // pivot's reciprocal, scaled in place and stored to cp (the rhs alone,
    // to x, at the last level)
    if (!last) {
      C* out = cp + (s * n + k) * rec;
      for (int e = tid; e < m * xr; e += kClusterThreads) {
        const int q = e / xr, l = e % xr;
        C* v = W + static_cast<size_t>(piv[q]) * ld + a8 + l;
        *v *= dinv[q];
        out[q * (m + 1) + (l < a_r ? col_of(l) : m)] = *v;
      }
    } else if (owns_rhs) {
      for (int q = tid; q < m; q += kClusterThreads) {
        C* v = W + static_cast<size_t>(piv[q]) * ld + a8 + a_r;
        *v *= dinv[q];
        x[ov + q] = static_cast<T>(*v);
      }
    }
    __syncthreads();
  }

  // back substitution across the cluster: my rows [r0, r1) of
  // x_k = dp_k - Cp_k x_{k+1}, x_{k+1} gathered from every CTA's slice
  if (n > 1) {
    if (!kOnChip) __threadfence();
    cl.sync();
    const C* rx = peer_big(W, rhs_owner) + a8 + own_columns(lay, rhs_owner);
    for (int q = tid; q < m; q += kClusterThreads)
      xfull[q] = rx[static_cast<size_t>(piv[q]) * ld];
    __syncthreads();
    const int r0 = rank * lay.rows;
    const int r1 = r0 + lay.rows < m ? r0 + lay.rows : m;
    for (int k = n - 2; k >= 0; --k) {
      const C* Ck = cp + (s * n + k) * rec;
      const size_t ov = (s * n + k) * m;
      C* slice = xs + (k & 1) * lay.rows;
      for (int i = r0 + warp; i < r1; i += kClusterWarps) {
        const C* Ci = Ck + static_cast<size_t>(i) * (m + 1);
        C acc = C(0);
        for (int c = lane; c < m; c += kWarp) acc = fma(Ci[c], xfull[c], acc);
#pragma unroll
        for (int off = kWarp / 2; off > 0; off >>= 1)
          acc += __shfl_xor_sync(kAll, acc, off);
        if (lane == 0) {
          const C v = Ci[m] - acc;
          slice[i - r0] = v;
          x[ov + i] = static_cast<T>(v);
        }
      }
      if (k == 0) break;
      cl.sync();
      for (int q = tid; q < m; q += kClusterThreads) {
        const int who = q / lay.rows;
        xfull[q] = cl.map_shared_rank(xs + (k & 1) * lay.rows,
                                      who)[q - who * lay.rows];
      }
      __syncthreads();
    }
  }
  cl.sync();   // no CTA leaves while another may read its shared memory
}

// ---- launchers --------------------------------------------------------------

// Let every kernel take up to kOnChipBytes of dynamic shared memory (above
// 48 KB only after this call), and the cluster kernels clusters of 16
// CTAs, on the current device; `done` records the devices set.
template <typename T>
cudaError_t allow(std::atomic<bool> (&done)[mpp::kMaxDevices]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool recorded = dev >= 0 && dev < mpp::kMaxDevices;
  if (recorded && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  const void* fns[] = {
      reinterpret_cast<const void*>(btl_block_kernel<T, true>),
      reinterpret_cast<const void*>(btl_block_kernel<T, false>),
      reinterpret_cast<const void*>(btl_cluster_kernel<T, true>),
      reinterpret_cast<const void*>(btl_cluster_kernel<T, false>)};
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

template <typename T, bool kOnChip>
int launch_cluster(const T* L, const T* D, const T* U, const T* b, double* cp,
                   double* ws, T* x, int nsys, int n, int m, int cs,
                   size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nsys) * cs);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(cs);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, btl_cluster_kernel<T, kOnChip>, L, D, U, b, cp, ws, x, n, m);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_m(const void* Lv, const void* Dv, const void* Uv, const void* bv,
             void* cpv, void* wsv, void* xv, int nsys, int n, int m, int form,
             int cs, void* stream) {
  if (nsys <= 0 || n <= 0) return cudaSuccess;
  if (m < 1 || form < 0 || form > 1) return cudaErrorInvalidValue;
  if (n > 1 && cpv == nullptr) return cudaErrorInvalidValue;
  static std::atomic<bool> done[mpp::kMaxDevices];
  const cudaError_t e = allow<T>(done);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto st = static_cast<cudaStream_t>(stream);
  const T* L = static_cast<const T*>(Lv);
  const T* D = static_cast<const T*>(Dv);
  const T* U = static_cast<const T*>(Uv);
  const T* b = static_cast<const T*>(bv);
  double* cp = static_cast<double*>(cpv);
  double* ws = static_cast<double*>(wsv);
  T* x = static_cast<T*>(xv);
  if (form == 1) {
    if (cs < 1 || cs > kMaxCluster) return cudaErrorInvalidValue;
    const ClusterLayout lay(m, cs);
    if (lay.smem(true) <= mpp::kOnChipBytes)
      return launch_cluster<T, true>(L, D, U, b, cp, ws, x, nsys, n, m, cs,
                                     lay.smem(true), st);
    if (ws == nullptr || lay.smem(false) > mpp::kOnChipBytes)
      return cudaErrorInvalidValue;
    return launch_cluster<T, false>(L, D, U, b, cp, ws, x, nsys, n, m, cs,
                                    lay.smem(false), st);
  }
  const dim3 block(kWarp, warps_for(m));
  if (m <= max_on_chip()) {
    btl_block_kernel<T, true><<<static_cast<unsigned>(nsys), block,
                                block_smem(m, true), st>>>(L, D, U, b, cp,
                                                           ws, x, n, m);
  } else {
    if (ws == nullptr) return cudaErrorInvalidValue;
    btl_block_kernel<T, false><<<static_cast<unsigned>(nsys), block,
                                 block_smem(m, false), st>>>(L, D, U, b, cp,
                                                             ws, x, n, m);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// the largest m whose working matrix the block form keeps in shared memory
// (the same for f32 and f64: both work in f64); past it the launch needs ws
int mpp_block_thomas_large_max_on_chip(int) { return max_on_chip(); }

// the cluster form at m x m blocks and cs CTAs a system: its dynamic shared
// bytes (on_chip 1: W and the panel slots in shared memory; 0: in the
// scratch) and its scratch values a CTA (where W is not on chip), as the
// launcher computes them
long long mpp_block_thomas_large_cluster_smem(int m, int cs, int on_chip) {
  return static_cast<long long>(ClusterLayout(m, cs).smem(on_chip != 0));
}
long long mpp_block_thomas_large_cluster_scratch(int m, int cs) {
  return static_cast<long long>(ClusterLayout(m, cs).big);
}

// form: 0 block (a thread block a system), 1 cluster (cs CTAs a system);
// cp: the scratch [nsys, n, m, m + 1] of f64 (the levels' [Cp | dp]; may be
// null when n == 1); ws: the block form's working matrices [nsys, m, 2m +
// 1] past its on-chip limit, the cluster form's regions [nsys, cs, big]
// past its own, of f64, else null
int mpp_block_thomas_large_f32(const void* L, const void* D, const void* U,
                               const void* b, void* cp, void* ws, void* x,
                               int nsys, int n, int m, int form, int cs,
                               void* stream) {
  return launch_m<float>(L, D, U, b, cp, ws, x, nsys, n, m, form, cs, stream);
}

int mpp_block_thomas_large_f64(const void* L, const void* D, const void* U,
                               const void* b, void* cp, void* ws, void* x,
                               int nsys, int n, int m, int form, int cs,
                               void* stream) {
  return launch_m<double>(L, D, U, b, cp, ws, x, nsys, n, m, form, cs,
                          stream);
}

}  // extern "C"

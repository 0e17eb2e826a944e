// The SpMV family for Hopper (sm_90a): the matrix-resident chain and
// Jacobi smoother, and the SpMV variants of the measurement harness.
//
// Layout: row-major [ncol, nz] (one column per row, levels contiguous), the
// layout of the port's state; the packed form is [ncol, 3*nz] = [dl | d |
// du] per column.  dl[c, 0] and du[c, nz-1] are never read as off-diagonal
// neighbours.
//
// Arithmetic: every product, sum, difference and quotient goes through the
// round-to-nearest intrinsics (__fmul_rn, __dadd_rn, ...), which nvcc never
// contracts into an FMA.  Each kernel therefore rounds exactly as its plain
// PyTorch version (separate mul/add/div kernels, IEEE division), in the same
// order: y = d*x + lo + hi, the chain's (T x) * scale, the smoother's
// x + omega*(b - T x)/d.
//
// Contract shared by all launchers: device pointers of contiguous tensors,
// the launch on the caller's stream, nothing allocated or synchronised here,
// and the return value is cudaGetLastError() after the launch (0 on
// success; cudaErrorInvalidValue for a shape the kernel does not take).
//
// ---------------------------------------------------------------------------
// spmv_chain — replaces tridiag_spmv_chain, mpp_tpu/ops/pallas_kernels.py:
//   214-247 (pl.pallas_call at l.241): y = (scale*T)^K x.
// jacobi_smooth — replaces tridiag_jacobi_smooth, pallas_kernels.py:250-286
//   (pl.pallas_call at l.280): K sweeps x <- x + omega*(b - T x)/diag(T).
//   Bound on the H100: bytes once K is small.  The chain reads dl, d, du, x
//   and writes y once (5 streams), the smoother also reads b (6 streams);
//   the work is 6 (chain) or 9 (smoother) operations per level and sweep, so
//   at K=30 the operations bound (67 TFLOP/s f32, 34 f64) is about half the
//   bytes bound in f32 and equal to it in f64.  These kernels must not
//   contract, so their arithmetic floor is one instruction per operation
//   at 128 a clock per SM (4 schedulers x 32 lanes), about half the
//   67 TFLOP/s that counts an FMA twice; the smoother's IEEE division adds
//   an MUFU.RCP (16 a clock per SM) and its refinement.  What the TPU
//   kernel buys by keeping T in VMEM across the K applications, these
//   kernels buy by keeping T (and b) on chip.  Three forms, by depth:
//
//   registers (nz <= kRegMaxNz = 512): one warp per column, a blocked
//     layout.  Lane l holds the R = 1, 2, 4, 8 or 16 levels [l*R, l*R + R)
//     (R the least power of two with 32*R >= nz, a template parameter), so
//     a sweep takes two shuffles in all: lane l-1's last old value comes up
//     and lane l+1's first comes down; the other neighbours are the lane's
//     own registers (the earlier layout, level r*32 + lane in slot r,
//     took four shuffles a level).  Each lane loads and stores its own run
//     straight from and to global memory: the warp's R load instructions
//     of an array touch the same R*32 values, which L1 serves after the
//     first.  (Staging the column through shared memory with cp.async, in
//     rows of R + 1 values a lane so that the banks do not conflict, read
//     slower on the card: PERF.md section 6.)  Levels past nz ("pads", only
//     where nz < 32*R) are never stored.  For R > 1 a select holds the
//     pads among a lane's own levels at +0, which level nz-1 reads as its
//     right neighbour; at R = 1 a pad is read only as the shuffled `right`
//     of level nz-1, which that lane zeroes as lane 31 does, so the pads
//     take no select there (one on the sweep's path cost 13 % of the time
//     at [16384, 30] f64, where a sweep is 15 instructions a level).  The
//     edges' missing neighbours are +0 fills times bands forced to +0, the
//     plain form's +0.
//   shared (nz <= max_on_chip, 10752 f32 / 5632 f64 levels for the
//     smoother, 13824 / 6656 for the chain): one CTA of kColThreads
//     threads per column with the bands, b and x in shared memory (x held
//     once and updated in place).  Thread t walks its Q = ceil(nz /
//     kColThreads) levels in order; its two outside neighbours are read
//     before a barrier, and a second barrier ends the sweep.  A thread's
//     run sits at stride Qp = Q | 1 (odd), so the threads' walks fall on
//     distinct banks.  The thresholds are the launcher's own rules,
//     exported as mpp_tridiag_*_max_in_registers / _max_on_chip.
//   streamed (deeper): one CTA per column re-reads the bands (and b) from
//     global memory every sweep and ping-pongs x between y and a scratch
//     [ncol, nz] that the caller allocates, ordered so that the last sweep
//     writes y; a barrier between sweeps.
//
//   Quotient (smoother): the divisor d is the same in all K sweeps, so the
//   f32 register form hoists rd = RN(1/(double)d) out of the sweep loop and
//   takes q = (float)((double)a * rd).  Where q is normal (|q| >= 2^-126)
//   or zero it is RN24(a/d), `/`'s bits: a/d with a normal result is never
//   a midpoint of the 24-bit grid (a midpoint M 2^k, M odd of 25 bits,
//   times d would need >= 25 significant bits to equal a); a non-exact a/d
//   lies at least 2^-49 relative from every midpoint (a - m*d is a non-zero
//   multiple of 2^(ea-48) for a in [2^ea, 2^(ea+1))), and rd and the
//   product each round by at most 2^-53 relative; f32 values, their
//   reciprocals and quotients are normal in f64; an overflow, 0, inf and
//   NaN come out as `/`'s (1/0 = inf, 1/inf = 0, signs by xor); and a zero
//   q means |a/d| <= 2^-150, which `/` also rounds to zero.  Where q is a
//   non-zero subnormal the argument fails: a/d can be exactly a midpoint of
//   the coarser subnormal grid, and the f64 product, off by up to one f64
//   ulp, can round that tie the wrong way (a = 147 2^-145, d = 1568: a/d =
//   1.5 2^-149, `/` gives 2^-148, the product 2^-149).  So a lane whose
//   sweep meets such a q redoes that sweep from its old values with `/`.
//   chip_smoke's subnormal_ties rows and tests/test_torch_spmv_family.py
//   hold such ties bitwise (a build without the redo fails them).  Cost on
//   the sweep's path: two f32<->f64 conversions a level (16 a clock per SM
//   on sm_90, against 128 for FADD), the DMUL and the integer test; no
//   MUFU.RCP, FCHK or slow-path branch a level as `/` has.  Measured at
//   [131072, 256], K=30 (tools/resident_variants.py, its ieee_div variant;
//   NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6): 0.7015 ms on the
//   device against 1.2493 ms with __fdiv_rn in the same layout, so the f32
//   register form takes it.  Every other form, and f64, divides with
//   __fdiv_rn / __ddiv_rn.  A Markstein correction of an f32 reciprocal (no
//   conversions) was tried too and read no faster than `/` on the card; it
//   is not kept.

// spmv_variant — replaces the SpMV kernel of tools/exp_spmv.py:71-99
//   (pallas_kernel, pl.pallas_call at l.92) and its grid-semantics twin
//   (pallas_kernel_cp, l.131-152, pl.pallas_call at l.143): y = T x, f32.
//   A tile of `block` whole columns (the Pallas block_cols) is walked by
//   one thread block in coalesced strides.  The neighbour exchange is a
//   template: "concat" loads x[i-1] and x[i+1] from memory (L1 serves them),
//   "roll" (the Hopper reading of pltpu.roll) takes them from the
//   neighbouring lanes by warp shuffle and loads only at warp edges, then
//   masks at column edges as the roll variant does.  The grid is one block
//   per tile ("parallel" semantics) or persistent, one block per SM walking
//   the tiles in order (the nearest counterpart of "arbitrary", a
//   sequential grid).  Bound: bytes, 5 streams of 4 bytes a level, 5
//   operations.
//
// spmv_packed — replaces packed_kernel, tools/exp_spmv.py:155-189
//   (pl.pallas_call at l.174): y = T x with the bands packed into one
//   [ncol, 3*nz] array.  Bound: bytes, the same 5 streams in 2 inputs.
//   One thread per level; each of the three band segments of a column is
//   read coalesced.
//
// stream_ceiling — no TPU kernel: the harness's elementwise yardstick
//   (tools/exp_spmv.py:205-209, a loop body that XLA fuses into one pass),
//   y = min(a + x*(b - x*c), 2) * 0.9 in one pass over 4 inputs and 1
//   output.  Bound: bytes.
// ---------------------------------------------------------------------------

#include <atomic>
#include <cuda_runtime.h>

#include "column_tiles.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kRegWarps = 4;     // columns (a warp each) per block, registers
constexpr int kRegMaxNz = 512;   // 32 lanes x 16 levels
constexpr int kColThreads = 512; // threads per column, shared and streamed
constexpr int kVariantThreads = 1024;  // threads per block walking one tile
constexpr int kThreads = 256;

template <typename T>
struct Rn;

template <>
struct Rn<float> {
  static __device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
  }
  static __device__ __forceinline__ float div(float a, float b) {
    return __fdiv_rn(a, b);
  }
};

template <>
struct Rn<double> {
  static __device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
  }
  static __device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
  }
  static __device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
  }
  static __device__ __forceinline__ double div(double a, double b) {
    return __ddiv_rn(a, b);
  }
};

// d*x + lo + hi, summed in the plain form's order
template <typename T>
__device__ __forceinline__ T stencil(T d, T x, T lo, T hi) {
  return Rn<T>::add(Rn<T>::add(Rn<T>::mul(d, x), lo), hi);
}

// One level's update from its old value xo and old neighbours xl, xr: the
// chain's (T x) * coef, or the smoother's x + coef*(b - T x)/d.
template <typename T, bool kJacobi>
__device__ __forceinline__ T update(T dl, T d, T du, T b, T xo, T xl, T xr,
                                    T coef) {
  const T s = stencil(d, xo, Rn<T>::mul(dl, xl), Rn<T>::mul(du, xr));
  if constexpr (!kJacobi) {
    return Rn<T>::mul(s, coef);
  } else {
    return Rn<T>::add(xo, Rn<T>::div(Rn<T>::mul(coef, Rn<T>::sub(b, s)), d));
  }
}

// --- registers: one warp a column, lane l holding levels [l*R, l*R + R) ---

// kPad: nz < 32*R, so the levels past nz are pads (the header).
template <typename T, int R, bool kJacobi, bool kPad>
__global__ void __launch_bounds__(kRegWarps * 32)
reg_kernel(const T* __restrict__ dl_g, const T* __restrict__ d_g,
           const T* __restrict__ du_g, const T* __restrict__ b_g,
           const T* __restrict__ x_g, T* __restrict__ y_g, int ncol, int nz,
           int iters, T coef) {
  // the f32 smoother's quotient through a hoisted f64 reciprocal (the
  // header); the chain has none, f64 divides
  constexpr bool kHoist = kJacobi && sizeof(T) == 4;
  // pads among a lane's own levels are held at +0 by a select; at R = 1 a
  // pad is read only as `right`, which the last live lane zeroes instead
  constexpr bool kHold = kPad && R > 1;
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kRegWarps + (threadIdx.x >> 5);
  if (col >= ncol) return;  // warp-uniform: the shuffles see whole warps
  const size_t base = static_cast<size_t>(col) * nz;
  T dl[R], d[R], du[R], b[R], x[R];
  double rd[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t i = base + lane * R + r;
    const bool in = lane * R + r < nz;
    // dl at level 0 and du at nz-1 are +0: times the +0 fills below, the
    // plain form's +0 terms
    dl[r] = (in && lane * R + r > 0) ? dl_g[i] : T(0);
    d[r] = in ? d_g[i] : T(kJacobi ? 1 : 0);
    du[r] = (in && lane * R + r < nz - 1) ? du_g[i] : T(0);
    x[r] = in ? x_g[i] : T(0);
    b[r] = (kJacobi && in) ? b_g[i] : T(0);
    rd[r] = kHoist ? __drcp_rn(static_cast<double>(d[r])) : 0.0;
  }
  const int live = nz - lane * R;  // this lane's levels below nz
  const bool last = live <= R;     // level lane*R + R is past the column
  for (int it = 0; it < iters; ++it) {
    // the two shuffles of a sweep: the lane's outside neighbours
    T left = __shfl_up_sync(kFull, x[R - 1], 1);
    T right = __shfl_down_sync(kFull, x[0], 1);
    if (lane == 0) left = T(0);
    if (last) right = T(0);
    T prev = left;
    if constexpr (kHoist) {
      // the hoisted quotient; a lane with a non-zero subnormal quotient
      // (where it may round a tie the other way: the header) redoes its
      // sweep from the old values with `/`
      T xo[R];
      bool tiny = false;
#pragma unroll
      for (int r = 0; r < R; ++r) xo[r] = x[r];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T s = stencil(d[r], xo[r], Rn<T>::mul(dl[r], prev),
                            Rn<T>::mul(du[r], r + 1 < R ? xo[r + 1] : right));
        const T a = Rn<T>::mul(coef, Rn<T>::sub(b[r], s));
        const T q = __double2float_rn(__dmul_rn(static_cast<double>(a), rd[r]));
        // 2^-149 <= |q| < 2^-126, from its bits without the sign
        tiny = tiny || __float_as_uint(q) * 2u - 1u < 0x00ffffffu;
        if (!kHold || r < live) x[r] = Rn<T>::add(xo[r], q);
        prev = xo[r];
      }
      if (tiny) {
        prev = left;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T v = update<T, true>(dl[r], d[r], du[r], b[r], xo[r], prev,
                                      r + 1 < R ? xo[r + 1] : right, coef);
          if (!kHold || r < live) x[r] = v;
          prev = xo[r];
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const T xo = x[r];
        const T v = update<T, kJacobi>(dl[r], d[r], du[r], b[r], xo, prev,
                                       r + 1 < R ? x[r + 1] : right, coef);
        x[r] = (!kHold || r < live) ? v : xo;
        prev = xo;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r < live) y_g[base + lane * R + r] = x[r];
}

template <typename T, int R, bool kJacobi>
int launch_reg(const T* dl, const T* d, const T* du, const T* b, const T* x,
               T* y, int ncol, int nz, int iters, T coef, cudaStream_t s) {
  auto kernel = nz == 32 * R ? reg_kernel<T, R, kJacobi, false>
                             : reg_kernel<T, R, kJacobi, true>;
  const dim3 grid((ncol + kRegWarps - 1) / kRegWarps);
  kernel<<<grid, kRegWarps * 32, 0, s>>>(dl, d, du, b, x, y, ncol, nz, iters,
                                         coef);
  return static_cast<int>(cudaGetLastError());
}

// --- shared: one CTA a column, the bands, b and x in shared memory ---

// Thread t owns levels [t*Q, t*Q + Q), Q = ceil(nz / kColThreads), stored
// at t*Qp, Qp = Q | 1.
template <typename T, bool kJacobi>
size_t col_smem(int nz) {
  const int q = (nz + kColThreads - 1) / kColThreads;
  return static_cast<size_t>(kJacobi ? 5 : 4) * kColThreads * (q | 1) *
         sizeof(T);
}

// the deepest column of the shared form: the largest Q with Q | 1 within
// kOnChipBytes
template <typename T, bool kJacobi>
constexpr int col_max_on_chip() {
  const int cap = static_cast<int>(
      mpp::kOnChipBytes / ((kJacobi ? 5 : 4) * kColThreads * sizeof(T)));
  return ((cap & 1) ? cap : cap - 1) * kColThreads;
}

template <typename T, bool kJacobi>
__global__ void __launch_bounds__(kColThreads)
shared_kernel(const T* __restrict__ dl_g, const T* __restrict__ d_g,
              const T* __restrict__ du_g, const T* __restrict__ b_g,
              const T* __restrict__ x_g, T* __restrict__ y_g, int nz,
              int iters, T coef) {
  constexpr int kArrays = kJacobi ? 5 : 4;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int q = (nz + kColThreads - 1) / kColThreads;
  const int qp = q | 1;
  const int rows = kColThreads * qp;
  const size_t base = static_cast<size_t>(blockIdx.x) * nz;
  const T* const src[5] = {dl_g + base, d_g + base, du_g + base, x_g + base,
                           kJacobi ? b_g + base : x_g + base};
  for (int i = threadIdx.x; i < nz; i += kColThreads) {
    const int s = (i / q) * qp + i % q;
#pragma unroll
    for (int a = 0; a < kArrays; ++a)
      mpp::cp_async<sizeof(T)>(sm + a * rows + s, src[a] + i);
  }
  mpp::cp_async_commit();
  mpp::cp_async_wait<0>();
  __syncthreads();
  const int first = threadIdx.x * q;
  const int len = max(0, min(q, nz - first));
  const int own = threadIdx.x * qp;
  const T* const dls = sm + own;
  const T* const ds = sm + rows + own;
  const T* const dus = sm + 2 * rows + own;
  T* const xs = sm + 3 * rows + own;
  const T* const bs = sm + (kJacobi ? 4 : 3) * rows + own;
  for (int it = 0; it < iters; ++it) {
    // the run's outside neighbours, old values; +0 fills at the edges
    const T left = (len > 0 && first > 0) ? xs[q - 1 - qp] : T(0);
    const T right = (len > 0 && first + q < nz) ? xs[qp] : T(0);
    __syncthreads();
    T prev = left;
    for (int j = 0; j < len; ++j) {
      const int i = first + j;
      const T xo = xs[j];
      const T v = update<T, kJacobi>(
          i > 0 ? dls[j] : T(0), ds[j], i < nz - 1 ? dus[j] : T(0),
          kJacobi ? bs[j] : T(0), xo, prev, j + 1 < len ? xs[j + 1] : right,
          coef);
      xs[j] = v;
      prev = xo;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nz; i += kColThreads)
    y_g[base + i] = sm[3 * rows + (i / q) * qp + i % q];
}

// --- streamed: one CTA a column, the bands re-read every sweep ---

// Sweep k reads src and writes dst, alternating between the scratch and y so
// that the last sweep writes y.  x, the scratch and y are not __restrict__
// (and not read through the non-coherent path): a sweep reads what the one
// before wrote.
template <typename T, bool kJacobi>
__global__ void __launch_bounds__(kColThreads)
streamed_kernel(const T* __restrict__ dl_g, const T* __restrict__ d_g,
                const T* __restrict__ du_g, const T* __restrict__ b_g,
                const T* x_g, T* scratch, T* y_g, int nz, int iters,
                T coef) {
  const size_t base = static_cast<size_t>(blockIdx.x) * nz;
  dl_g += base;
  d_g += base;
  du_g += base;
  const T* src = x_g + base;
  if (iters == 0) {
    for (int i = threadIdx.x; i < nz; i += kColThreads) y_g[base + i] = src[i];
    return;
  }
  for (int it = 0; it < iters; ++it) {
    T* const dst = ((iters - 1 - it) & 1) ? scratch + base : y_g + base;
    for (int i = threadIdx.x; i < nz; i += kColThreads) {
      dst[i] = update<T, kJacobi>(
          i > 0 ? dl_g[i] : T(0), d_g[i], i < nz - 1 ? du_g[i] : T(0),
          kJacobi ? b_g[base + i] : T(0), src[i],
          i > 0 ? src[i - 1] : T(0), i < nz - 1 ? src[i + 1] : T(0), coef);
    }
    __syncthreads();
    src = dst;
  }
}

// The chain (kJacobi false) or the smoother by depth: registers to
// kRegMaxNz, shared memory to col_max_on_chip, streamed beyond (then
// `scratch`, [ncol, nz], is required when iters > 1).
template <typename T, bool kJacobi>
int launch_column(const void* dl_v, const void* d_v, const void* du_v,
                  const void* b_v, const void* x_v, void* scratch_v,
                  void* y_v, int ncol, int nz, int iters, double coef_d,
                  void* stream) {
  if (ncol < 1 || nz < 1 || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* dl = static_cast<const T*>(dl_v);
  const T* d = static_cast<const T*>(d_v);
  const T* du = static_cast<const T*>(du_v);
  const T* b = static_cast<const T*>(b_v);
  const T* x = static_cast<const T*>(x_v);
  T* scratch = static_cast<T*>(scratch_v);
  T* y = static_cast<T*>(y_v);
  const T coef = static_cast<T>(coef_d);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nz <= kRegMaxNz) {
    const int slots = (nz + 31) / 32;
    if (slots <= 1)
      return launch_reg<T, 1, kJacobi>(dl, d, du, b, x, y, ncol, nz, iters,
                                       coef, s);
    if (slots <= 2)
      return launch_reg<T, 2, kJacobi>(dl, d, du, b, x, y, ncol, nz, iters,
                                       coef, s);
    if (slots <= 4)
      return launch_reg<T, 4, kJacobi>(dl, d, du, b, x, y, ncol, nz, iters,
                                       coef, s);
    if (slots <= 8)
      return launch_reg<T, 8, kJacobi>(dl, d, du, b, x, y, ncol, nz, iters,
                                       coef, s);
    return launch_reg<T, 16, kJacobi>(dl, d, du, b, x, y, ncol, nz, iters,
                                      coef, s);
  }
  if (nz <= col_max_on_chip<T, kJacobi>()) {
    static std::atomic<bool> smem_set[mpp::kMaxDevices];
    const cudaError_t e = mpp::allow_smem(smem_set,
                                          shared_kernel<T, kJacobi>,
                                          shared_kernel<T, kJacobi>);
    if (e != cudaSuccess) return static_cast<int>(e);
    shared_kernel<T, kJacobi><<<ncol, kColThreads,
                                col_smem<T, kJacobi>(nz), s>>>(
        dl, d, du, b, x, y, nz, iters, coef);
  } else {
    if (scratch == nullptr && iters > 1)
      return static_cast<int>(cudaErrorInvalidValue);
    streamed_kernel<T, kJacobi><<<ncol, kColThreads, 0, s>>>(
        dl, d, du, b, x, scratch, y, nz, iters, coef);
  }
  return static_cast<int>(cudaGetLastError());
}

// y = T x over tiles of whole columns (tile_elems = block_cols * nz levels),
// tiles tile, tile + gridDim.x, ...: one tile per block when gridDim.x is
// the tile count, a persistent walk when it is the SM count.
template <bool kRoll>
__global__ void __launch_bounds__(kVariantThreads)
spmv_variant_kernel(const float* __restrict__ dl, const float* __restrict__ d,
                    const float* __restrict__ du,
                    const float* __restrict__ x, float* __restrict__ y,
                    int nz, int tile_elems, int ntiles) {
  const int lane = threadIdx.x & 31;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const size_t start = static_cast<size_t>(tile) * tile_elems;
    // a block-uniform loop: every warp is whole at each shuffle
    for (int j0 = 0; j0 < tile_elems; j0 += blockDim.x) {
      const int j = j0 + threadIdx.x;
      const bool in = j < tile_elems;
      const size_t i = start + j;
      const int k = in ? j % nz : 0;  // tiles start at a column boundary
      const float xi = in ? x[i] : 0.0f;
      float xl, xr;
      if (kRoll) {
        xl = __shfl_up_sync(kFull, xi, 1);
        xr = __shfl_down_sync(kFull, xi, 1);
        if (lane == 0 && in && k > 0) xl = x[i - 1];
        if (lane == 31 && in && k < nz - 1) xr = x[i + 1];
      } else {
        xl = (in && k > 0) ? x[i - 1] : 0.0f;
        xr = (in && k < nz - 1) ? x[i + 1] : 0.0f;
      }
      if (in) {
        const float lo = k > 0 ? __fmul_rn(dl[i], xl) : 0.0f;
        const float hi = k < nz - 1 ? __fmul_rn(du[i], xr) : 0.0f;
        y[i] = stencil(d[i], xi, lo, hi);
      }
    }
  }
}

__global__ void spmv_packed_kernel(const float* __restrict__ t,
                                   const float* __restrict__ x,
                                   float* __restrict__ y, int ncol, int nz) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(ncol) * nz;
  if (i >= total) return;
  const size_t c = i / nz;
  const int k = static_cast<int>(i - c * nz);
  const float* tc = t + c * 3 * nz;
  const float lo = k > 0 ? __fmul_rn(tc[k], x[i - 1]) : 0.0f;
  const float hi = k < nz - 1 ? __fmul_rn(tc[2 * nz + k], x[i + 1]) : 0.0f;
  y[i] = stencil(tc[nz + k], x[i], lo, hi);
}

__global__ void stream_ceiling_kernel(const float* __restrict__ a,
                                      const float* __restrict__ b,
                                      const float* __restrict__ c,
                                      const float* __restrict__ x,
                                      float* __restrict__ y, size_t total) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float xi = x[i];
  const float v =
      __fadd_rn(a[i], __fmul_rn(xi, __fsub_rn(b[i], __fmul_rn(xi, c[i]))));
  y[i] = __fmul_rn(fminf(v, 2.0f), 0.9f);
}

}  // namespace

extern "C" {

// The chain's and the smoother's deepest columns in registers and on chip
// (shared memory) for elem_bytes-sized values (4 or 8); deeper columns take
// the streamed form and its scratch.
int mpp_tridiag_spmv_chain_max_in_registers(int) { return kRegMaxNz; }

int mpp_tridiag_jacobi_smooth_max_in_registers(int) { return kRegMaxNz; }

int mpp_tridiag_spmv_chain_max_on_chip(int elem_bytes) {
  return elem_bytes == 8 ? col_max_on_chip<double, false>()
                         : col_max_on_chip<float, false>();
}

int mpp_tridiag_jacobi_smooth_max_on_chip(int elem_bytes) {
  return elem_bytes == 8 ? col_max_on_chip<double, true>()
                         : col_max_on_chip<float, true>();
}

// scratch: [ncol, nz], required past max_on_chip when iters > 1, else
// unused (may be null)
int mpp_spmv_chain_f32(const void* dl, const void* d, const void* du,
                       const void* x, void* scratch, void* y, int ncol,
                       int nz, int iters, double scale, void* stream) {
  return launch_column<float, false>(dl, d, du, nullptr, x, scratch, y,
                                     ncol, nz, iters, scale, stream);
}

int mpp_spmv_chain_f64(const void* dl, const void* d, const void* du,
                       const void* x, void* scratch, void* y, int ncol,
                       int nz, int iters, double scale, void* stream) {
  return launch_column<double, false>(dl, d, du, nullptr, x, scratch, y,
                                      ncol, nz, iters, scale, stream);
}

int mpp_jacobi_smooth_f32(const void* dl, const void* d, const void* du,
                          const void* b, const void* x, void* scratch,
                          void* y, int ncol, int nz, int iters, double omega,
                          void* stream) {
  return launch_column<float, true>(dl, d, du, b, x, scratch, y, ncol, nz,
                                    iters, omega, stream);
}

int mpp_jacobi_smooth_f64(const void* dl, const void* d, const void* du,
                          const void* b, const void* x, void* scratch,
                          void* y, int ncol, int nz, int iters, double omega,
                          void* stream) {
  return launch_column<double, true>(dl, d, du, b, x, scratch, y, ncol, nz,
                                     iters, omega, stream);
}

// block_cols columns per tile (ncol % block_cols == 0); roll != 0 selects
// the shuffle exchange, persistent != 0 the SM-count grid.
int mpp_spmv_variant_f32(const void* dl, const void* d, const void* du,
                         const void* x, void* y, int ncol, int nz,
                         int block_cols, int roll, int persistent,
                         void* stream) {
  if (block_cols <= 0 || ncol % block_cols != 0 ||
      static_cast<long long>(block_cols) * nz > (1LL << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ntiles = ncol / block_cols;
  const int tile_elems = block_cols * nz;
  int grid = ntiles;
  if (persistent) {
    int dev = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    grid = ntiles < sms ? ntiles : sms;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a0 = static_cast<const float*>(dl);
  const float* a1 = static_cast<const float*>(d);
  const float* a2 = static_cast<const float*>(du);
  const float* a3 = static_cast<const float*>(x);
  float* out = static_cast<float*>(y);
  if (roll) {
    spmv_variant_kernel<true><<<grid, kVariantThreads, 0, s>>>(
        a0, a1, a2, a3, out, nz, tile_elems, ntiles);
  } else {
    spmv_variant_kernel<false><<<grid, kVariantThreads, 0, s>>>(
        a0, a1, a2, a3, out, nz, tile_elems, ntiles);
  }
  return static_cast<int>(cudaGetLastError());
}

int mpp_spmv_packed_f32(const void* t, const void* x, void* y, int ncol,
                        int nz, void* stream) {
  const size_t total = static_cast<size_t>(ncol) * nz;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  spmv_packed_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<const float*>(x),
      static_cast<float*>(y), ncol, nz);
  return static_cast<int>(cudaGetLastError());
}

int mpp_stream_ceiling_f32(const void* a, const void* b, const void* c,
                           const void* x, void* y, int ncol, int nz,
                           void* stream) {
  const size_t total = static_cast<size_t>(ncol) * nz;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  stream_ceiling_kernel<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(c), static_cast<const float*>(x),
      static_cast<float*>(y), total);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

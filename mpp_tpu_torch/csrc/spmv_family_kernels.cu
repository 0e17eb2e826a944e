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
//   bytes bound in f32 and equal to it in f64.  What the TPU kernel buys by
//   keeping T in VMEM across the K applications, these kernels buy by
//   keeping T (and b) in registers.  Design: one warp per column; level
//   i = r*32 + lane sits in register slot r of that lane, so every load and
//   the store are coalesced 32-wide; the neighbours come from
//   __shfl_up_sync / __shfl_down_sync, lane 0 taking lane 31 of slot r-1
//   and lane 31 taking lane 0 of slot r+1.  The K iterations run with no
//   shared memory and no __syncthreads.  Template over R slots, rounded up
//   to 1, 2, 4, 8 or 16: nz <= 512.  Padding slots hold x = 0 and zero
//   bands (d = 1 in the smoother), so they stay 0.
//
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

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kResidentWarps = 8;      // columns per block of the chain/smoother
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

// K applications with the bands (and b) resident in registers; kJacobi
// selects the smoother's update, else the chain's (T x) * coef.
template <typename T, int R, bool kJacobi>
__global__ void __launch_bounds__(kResidentWarps * 32)
resident_kernel(const T* __restrict__ dl_g, const T* __restrict__ d_g,
                const T* __restrict__ du_g, const T* __restrict__ b_g,
                const T* __restrict__ x_g, T* __restrict__ y_g, int ncol,
                int nz, int iters, T coef) {
  const int lane = threadIdx.x & 31;
  const int col = blockIdx.x * kResidentWarps + (threadIdx.x >> 5);
  if (col >= ncol) return;  // warp-uniform: the shuffles below see full warps
  const size_t base = static_cast<size_t>(col) * nz;
  T dl[R], d[R], du[R], b[R], x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * 32 + lane;
    const bool in = i < nz;
    dl[r] = (in && i > 0) ? dl_g[base + i] : T(0);
    du[r] = (in && i < nz - 1) ? du_g[base + i] : T(0);
    d[r] = in ? d_g[base + i] : T(kJacobi ? 1 : 0);
    b[r] = (kJacobi && in) ? b_g[base + i] : T(0);
    x[r] = in ? x_g[base + i] : T(0);
  }
  for (int it = 0; it < iters; ++it) {
    T below = T(0);  // old x at lane 31 of slot r-1
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T xo = x[r];
      T xl = __shfl_up_sync(kFull, xo, 1);
      T xr = __shfl_down_sync(kFull, xo, 1);
      // slot r+1 is not updated yet: its lane 0 is still the old value
      const T above = __shfl_sync(kFull, x[r + 1 < R ? r + 1 : r], 0);
      if (lane == 0) xl = below;
      if (lane == 31) xr = r + 1 < R ? above : T(0);
      below = __shfl_sync(kFull, xo, 31);
      // dl and du are 0 where the plain form has no neighbour term, and the
      // missing neighbour is a +0 fill, so the product is the plain +0
      const T s = stencil(d[r], xo, Rn<T>::mul(dl[r], xl),
                          Rn<T>::mul(du[r], xr));
      x[r] = kJacobi
                 ? Rn<T>::add(xo, Rn<T>::div(Rn<T>::mul(coef,
                                                        Rn<T>::sub(b[r], s)),
                                             d[r]))
                 : Rn<T>::mul(s, coef);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = r * 32 + lane;
    if (i < nz) y_g[base + i] = x[r];
  }
}

template <typename T, bool kJacobi>
int launch_resident(const void* dl, const void* d, const void* du,
                    const void* b, const void* x, void* y, int ncol, int nz,
                    int iters, double coef, void* stream) {
  const int slots = (nz + 31) / 32;
  const dim3 grid((ncol + kResidentWarps - 1) / kResidentWarps);
  const dim3 block(kResidentWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* a0 = static_cast<const T*>(dl);
  const T* a1 = static_cast<const T*>(d);
  const T* a2 = static_cast<const T*>(du);
  const T* a3 = static_cast<const T*>(b);
  const T* a4 = static_cast<const T*>(x);
  T* out = static_cast<T*>(y);
  const T c = static_cast<T>(coef);
  if (slots <= 1) {
    resident_kernel<T, 1, kJacobi><<<grid, block, 0, s>>>(
        a0, a1, a2, a3, a4, out, ncol, nz, iters, c);
  } else if (slots <= 2) {
    resident_kernel<T, 2, kJacobi><<<grid, block, 0, s>>>(
        a0, a1, a2, a3, a4, out, ncol, nz, iters, c);
  } else if (slots <= 4) {
    resident_kernel<T, 4, kJacobi><<<grid, block, 0, s>>>(
        a0, a1, a2, a3, a4, out, ncol, nz, iters, c);
  } else if (slots <= 8) {
    resident_kernel<T, 8, kJacobi><<<grid, block, 0, s>>>(
        a0, a1, a2, a3, a4, out, ncol, nz, iters, c);
  } else if (slots <= 16) {
    resident_kernel<T, 16, kJacobi><<<grid, block, 0, s>>>(
        a0, a1, a2, a3, a4, out, ncol, nz, iters, c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
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

int mpp_spmv_chain_f32(const void* dl, const void* d, const void* du,
                       const void* x, void* y, int ncol, int nz, int iters,
                       double scale, void* stream) {
  return launch_resident<float, false>(dl, d, du, nullptr, x, y, ncol, nz,
                                       iters, scale, stream);
}

int mpp_spmv_chain_f64(const void* dl, const void* d, const void* du,
                       const void* x, void* y, int ncol, int nz, int iters,
                       double scale, void* stream) {
  return launch_resident<double, false>(dl, d, du, nullptr, x, y, ncol, nz,
                                        iters, scale, stream);
}

int mpp_jacobi_smooth_f32(const void* dl, const void* d, const void* du,
                          const void* b, const void* x, void* y, int ncol,
                          int nz, int iters, double omega, void* stream) {
  return launch_resident<float, true>(dl, d, du, b, x, y, ncol, nz, iters,
                                      omega, stream);
}

int mpp_jacobi_smooth_f64(const void* dl, const void* d, const void* du,
                          const void* b, const void* x, void* y, int ncol,
                          int nz, int iters, double omega, void* stream) {
  return launch_resident<double, true>(dl, d, du, b, x, y, ncol, nz, iters,
                                       omega, stream);
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

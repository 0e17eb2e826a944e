// Batched tridiagonal kernels for Hopper (sm_90a): Thomas solve and the
// stencil SpMV y = T x in full and mixed (bf16-stored diagonals) precision.
//
// Layout: every array is row-major [ncol, nz] (one column per row, levels
// contiguous), the layout of the port's Newton state.  dl[c, 0] and
// du[c, nz-1] are never read as off-diagonal neighbours.
//
// Contract shared by all launchers: pointers are device pointers of
// contiguous tensors, the launch goes on the caller's stream, nothing is
// allocated or synchronised here, and the return value is
// cudaGetLastError() after the launch (0 on success).
//
// ---------------------------------------------------------------------------
// thomas  — replaces pallas_thomas, mpp_tpu/ops/pallas_kernels.py:131-211
//           (pl.pallas_call at l.204).
//   Bound on the H100: bytes.  The solve reads 4 streams (dl, d, du, b) and
//   writes x once: 5 * ncol * nz elements, plus the cp scratch written in
//   the forward sweep and read back in the backward sweep.  The arithmetic
//   (5 flops and 2 divisions per level) is far below the card's rate.
//   Design: one thread per column, the simplest correct form.  The level
//   recurrence is serial, so the column axis is the parallel one; the
//   forward carries (cp, bp) stay in registers and the backward sweep
//   re-reads cp and the bp stored in x, which the L2 (50 MB) still holds at
//   the ALM shapes ([16384, 30] f64 is 3.9 MB per stream).  Loads are not
//   coalesced (neighbouring threads are nz elements apart); staging a block
//   of columns through shared memory, the counterpart of the Pallas
//   kernel's in-VMEM transpose, is the next step.  Division is kept as
//   a / denom, as in the plain version (the Pallas kernel uses one
//   reciprocal per level).  No pivoting: diagonally dominant systems only.
//
// tridiag_spmv — replaces tridiag_spmv, pallas_kernels.py:49-73
//           (pl.pallas_call at l.67).
// tridiag_spmv_mixed — replaces tridiag_spmv_mixed, pallas_kernels.py:76-111
//           (pl.pallas_call at l.105).
//   Bound on the H100: bytes, 5 streams of ncol * nz elements (3 bands and
//   x read, y written); the mixed form stores the bands in bf16, 14 bytes a
//   cell instead of 20 in f32.  Design: one thread per element, neighbouring
//   threads on neighbouring addresses, so every stream is coalesced; the two
//   neighbour reads of x hit the same lines as the centre read.  Any nz.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void thomas_kernel(const T* __restrict__ dl,
                              const T* __restrict__ d,
                              const T* __restrict__ du,
                              const T* __restrict__ b,
                              T* __restrict__ cp, T* __restrict__ x,
                              int ncol, int nz) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncol) return;
  const size_t o = static_cast<size_t>(c) * nz;
  T cpm = T(0);
  T bpm = T(0);
  for (int k = 0; k < nz; ++k) {
    const T dlk = dl[o + k];
    const T denom = d[o + k] - dlk * cpm;
    const T cpk = du[o + k] / denom;
    const T bpk = (b[o + k] - dlk * bpm) / denom;
    cp[o + k] = cpk;
    x[o + k] = bpk;
    cpm = cpk;
    bpm = bpk;
  }
  T xn = T(0);
  for (int k = nz - 1; k >= 0; --k) {
    xn = x[o + k] - cp[o + k] * xn;
    x[o + k] = xn;
  }
}

template <typename TB, typename T>
__device__ __forceinline__ T band(TB v) { return static_cast<T>(v); }

template <>
__device__ __forceinline__ float band<__nv_bfloat16, float>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// y = d*x + dl*x[k-1] + du*x[k+1], summed in that order (the plain form's
// d * x + lo + hi).
template <typename TB, typename T>
__global__ void spmv_kernel(const TB* __restrict__ dl,
                            const TB* __restrict__ d,
                            const TB* __restrict__ du,
                            const T* __restrict__ x, T* __restrict__ y,
                            int ncol, int nz) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t total = static_cast<size_t>(ncol) * nz;
  if (i >= total) return;
  const int k = static_cast<int>(i % nz);
  const T xi = x[i];
  const T lo = k > 0 ? band<TB, T>(dl[i]) * x[i - 1] : T(0);
  const T hi = k < nz - 1 ? band<TB, T>(du[i]) * x[i + 1] : T(0);
  y[i] = band<TB, T>(d[i]) * xi + lo + hi;
}

template <typename T>
int launch_thomas(const void* dl, const void* d, const void* du,
                  const void* b, void* cp, void* x, int ncol, int nz,
                  void* stream) {
  const int blocks = (ncol + kThreads - 1) / kThreads;
  thomas_kernel<T><<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dl), static_cast<const T*>(d),
      static_cast<const T*>(du), static_cast<const T*>(b),
      static_cast<T*>(cp), static_cast<T*>(x), ncol, nz);
  return static_cast<int>(cudaGetLastError());
}

template <typename TB, typename T>
int launch_spmv(const void* dl, const void* d, const void* du,
                const void* x, void* y, int ncol, int nz, void* stream) {
  const size_t total = static_cast<size_t>(ncol) * nz;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  spmv_kernel<TB, T><<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const TB*>(dl), static_cast<const TB*>(d),
      static_cast<const TB*>(du), static_cast<const T*>(x),
      static_cast<T*>(y), ncol, nz);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mpp_thomas_f32(const void* dl, const void* d, const void* du,
                   const void* b, void* cp, void* x, int ncol, int nz,
                   void* stream) {
  return launch_thomas<float>(dl, d, du, b, cp, x, ncol, nz, stream);
}

int mpp_thomas_f64(const void* dl, const void* d, const void* du,
                   const void* b, void* cp, void* x, int ncol, int nz,
                   void* stream) {
  return launch_thomas<double>(dl, d, du, b, cp, x, ncol, nz, stream);
}

int mpp_spmv_f32(const void* dl, const void* d, const void* du,
                 const void* x, void* y, int ncol, int nz, void* stream) {
  return launch_spmv<float, float>(dl, d, du, x, y, ncol, nz, stream);
}

int mpp_spmv_f64(const void* dl, const void* d, const void* du,
                 const void* x, void* y, int ncol, int nz, void* stream) {
  return launch_spmv<double, double>(dl, d, du, x, y, ncol, nz, stream);
}

int mpp_spmv_bf16_f32(const void* dl, const void* d, const void* du,
                      const void* x, void* y, int ncol, int nz,
                      void* stream) {
  return launch_spmv<__nv_bfloat16, float>(dl, d, du, x, y, ncol, nz,
                                           stream);
}

}  // extern "C"

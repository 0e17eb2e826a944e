// Batched 2x2 block-tridiagonal solve (block Thomas) for Hopper (sm_90a):
// the Newton direction of the coupled thermal-hydrology (TH) step.
//
// block_thomas2 — replaces pallas_block_thomas2,
//   mpp_tpu/ops/pallas_kernels.py:289-408 (pl.pallas_call at l.399).
//
// What it computes: x with T x = b, T block-tridiagonal with 2x2 blocks,
// exactly what the plain version ops/block_thomas.block_thomas computes
// for m=2: per level k the eliminated diagonal block
//   A_k = D_k - L_k Cp_{k-1},  Cp_k = A_k^-1 U_k,  dp_k = A_k^-1 (b_k - L_k dp_{k-1}),
// each A_k^-1 applied in closed form (the 2x2 adjugate, divided by
// det A_k, as small_solve does), then x_k = dp_k - Cp_k x_{k+1}.
// L[c, 0] and U[c, n-1] are never read as neighbours.
//
// Contract: NO PIVOTING, across levels or inside a block.  The solve is
// only stable when the eliminated diagonal blocks A_k stay well
// conditioned, which holds for block diagonally dominant systems (the TH
// Jacobian at the time steps the stepper takes); a singular A_k gives
// inf/nan, which the Newton's line search then rejects.
//
// Layout: L, D, U and the Cp scratch are row-major [ncol, n, 2, 2] and b, x
// [ncol, n, 2], contiguous (one column per leading index).  Pointers are
// device pointers, the launch goes on the caller's stream, nothing is
// allocated or synchronised here, and the launcher returns
// cudaGetLastError() (0 on success).  Any n >= 1, f32 and f64 (the Pallas
// form needs f32 and n % 8 == 0).
//
// Bound on the H100: bytes.  Per level a column reads 14 values (L, D, U,
// b) and writes 2 (x), plus 4 of Cp written forward and read backward and
// dp kept in x; about 40 flops and one division per level.  At [8192, 64]
// f64 that is 58.7 MB read, 8.4 MB of x and 16.8 MB of Cp, more than the
// 50 MB L2.
//
// Design: one thread per column, the forward carries (Cp 2x2, dp 2) in
// registers, Cp spilled to the scratch only for the back substitution.
// The level recurrence is serial, so columns are the parallel axis, and a
// batch of 8192 columns is only 8192 threads: kThreads = 64 gives 128
// blocks, one on each of 128 of the 132 SMs (256 would give 32 blocks and
// leave 100 SMs idle).  Loads are strided by 4n (blocks) per thread, so
// they are not coalesced; staging a tile of columns through shared memory
// (the Pallas kernel's in-VMEM transpose) is the next step.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;

template <typename T>
__global__ void block_thomas2_kernel(const T* __restrict__ L,
                                     const T* __restrict__ D,
                                     const T* __restrict__ U,
                                     const T* __restrict__ b,
                                     T* __restrict__ cp, T* __restrict__ x,
                                     int ncol, int n) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncol) return;
  const size_t o4 = static_cast<size_t>(c) * n * 4;
  const size_t o2 = static_cast<size_t>(c) * n * 2;
  // carries: Cp_{k-1} (c00 c01 / c10 c11) and dp_{k-1} (p0, p1)
  T c00 = T(0), c01 = T(0), c10 = T(0), c11 = T(0);
  T p0 = T(0), p1 = T(0);
  for (int k = 0; k < n; ++k) {
    const size_t q = o4 + 4 * static_cast<size_t>(k);
    const size_t r = o2 + 2 * static_cast<size_t>(k);
    T a = D[q], bb = D[q + 1], cc = D[q + 2], dd = D[q + 3];
    T r0 = b[r], r1 = b[r + 1];
    if (k > 0) {
      const T l00 = L[q], l01 = L[q + 1], l10 = L[q + 2], l11 = L[q + 3];
      a -= l00 * c00 + l01 * c10;
      bb -= l00 * c01 + l01 * c11;
      cc -= l10 * c00 + l11 * c10;
      dd -= l10 * c01 + l11 * c11;
      r0 -= l00 * p0 + l01 * p1;
      r1 -= l10 * p0 + l11 * p1;
    }
    const T det = a * dd - bb * cc;
    if (k < n - 1) {
      const T u00 = U[q], u01 = U[q + 1], u10 = U[q + 2], u11 = U[q + 3];
      c00 = (dd * u00 - bb * u10) / det;
      c01 = (dd * u01 - bb * u11) / det;
      c10 = (-cc * u00 + a * u10) / det;
      c11 = (-cc * u01 + a * u11) / det;
      cp[q] = c00;
      cp[q + 1] = c01;
      cp[q + 2] = c10;
      cp[q + 3] = c11;
    }
    p0 = (dd * r0 - bb * r1) / det;
    p1 = (-cc * r0 + a * r1) / det;
    x[r] = p0;
    x[r + 1] = p1;
  }
  // back substitution in place: x holds dp, becomes the solution
  T xn0 = x[o2 + 2 * static_cast<size_t>(n - 1)];
  T xn1 = x[o2 + 2 * static_cast<size_t>(n - 1) + 1];
  for (int k = n - 2; k >= 0; --k) {
    const size_t q = o4 + 4 * static_cast<size_t>(k);
    const size_t r = o2 + 2 * static_cast<size_t>(k);
    const T x0 = x[r] - (cp[q] * xn0 + cp[q + 1] * xn1);
    const T x1 = x[r + 1] - (cp[q + 2] * xn0 + cp[q + 3] * xn1);
    x[r] = x0;
    x[r + 1] = x1;
    xn0 = x0;
    xn1 = x1;
  }
}

template <typename T>
int launch_block_thomas2(const void* L, const void* D, const void* U,
                         const void* b, void* cp, void* x, int ncol, int n,
                         void* stream) {
  const int blocks = (ncol + kThreads - 1) / kThreads;
  block_thomas2_kernel<T><<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), static_cast<const T*>(D),
      static_cast<const T*>(U), static_cast<const T*>(b),
      static_cast<T*>(cp), static_cast<T*>(x), ncol, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mpp_block_thomas2_f32(const void* L, const void* D, const void* U,
                          const void* b, void* cp, void* x, int ncol, int n,
                          void* stream) {
  return launch_block_thomas2<float>(L, D, U, b, cp, x, ncol, n, stream);
}

int mpp_block_thomas2_f64(const void* L, const void* D, const void* U,
                          const void* b, void* cp, void* x, int ncol, int n,
                          void* stream) {
  return launch_block_thomas2<double>(L, D, U, b, cp, x, ncol, n, stream);
}

}  // extern "C"

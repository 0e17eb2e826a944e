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
//   writes x once: 5 * ncol * nz elements.  The arithmetic (5 flops and 2
//   divisions per level) is far below the card's rate, but it is a serial
//   recurrence: a level's two divisions wait on the level before.
//   Design (the Pallas kernel's VMEM tile, rethought for an SM; see
//   column_tiles.cuh): a CTA owns a tile of 32 consecutive columns, one a
//   lane of its computing warp, so 16384 columns make 512 CTAs over all 132
//   SMs.  Each plane's tile is one contiguous run of 32 * nz values; its
//   levels stream through a ring of two shared stages of KL levels
//   (64-byte runs a column and plane), filled by the CTA's copy warp with
//   cp.async (coalesced reads, L2::256B fetches): chunk j+1 lands while the
//   computing warp eliminates chunk j.  The computing warp reads a chunk's
//   values into registers before it stores any cp or bp (its stores then
//   cannot hold up its loads), keeps the carries (cp, bp of the last
//   level) in registers and every level's cp and bp in shared memory, so
//   the back sweep touches no global memory; the tile of x leaves from
//   shared memory as coalesced stores: 5 global streams, each touched once.
//   Shared memory a CTA: the ring (16.5 KB) plus nz * 520 B (f64; 260 B
//   f32), which keeps four CTAs an SM at nz = 64 f64 (all 512 resident at
//   once) and six at nz = 30.  Where cp and bp would not fit one CTA's
//   227 KB (nz > 414 in f64, > 829 in f32) they go to the global scratch
//   `cp` and to x instead, read back by each lane in the back sweep.
//   Division is kept as a / denom, as in the plain version (the Pallas
//   kernel uses one reciprocal per level).  No pivoting: diagonally
//   dominant systems only.
//   ptxas (sm_90a, CUDA 12.8): 96 registers (f64, both forms), 80 / 91
//   (f32 on chip / spilled), no spills; 64 threads a CTA.

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

#include "column_tiles.cuh"

namespace {

using mpp::kCols;
using mpp::kRow;
using mpp::kStages;

constexpr int kThreads = 256;

// levels of a chunk: a 64-byte run of each column and plane
template <typename T>
__host__ __device__ constexpr int thomas_chunk() {
  return 64 / static_cast<int>(sizeof(T));
}

template <typename T>
constexpr size_t thomas_ring_bytes() {
  return sizeof(T) * kStages * 4 * thomas_chunk<T>() * kRow;
}

// dynamic shared memory of a CTA; with `on_chip` the ring plus cp (rows of
// kCols) and bp (rows of kRow, stored from there as x)
template <typename T>
size_t thomas_smem(int nz, bool on_chip) {
  return thomas_ring_bytes<T>() +
         (on_chip ? sizeof(T) * static_cast<size_t>(nz) * (kCols + kRow) : 0);
}

// the deepest nz whose cp and bp fit one CTA's shared memory beside the
// ring (414 in f64, 829 in f32); deeper columns take the global scratch
template <typename T>
constexpr int thomas_max_on_chip() {
  return static_cast<int>((mpp::kOnChipBytes - thomas_ring_bytes<T>()) /
                          (sizeof(T) * (kCols + kRow)));
}

// kOnChip: cp and bp in shared memory; else cp in the global scratch cp
// [ncol, nz] and bp in x.
template <typename T, bool kOnChip>
__global__ void __launch_bounds__(mpp::kTileThreads)
thomas_kernel(const T* __restrict__ dl, const T* __restrict__ d,
              const T* __restrict__ du, const T* __restrict__ b,
              T* __restrict__ cp, T* __restrict__ x, int ncol, int nz) {
  constexpr int KL = thomas_chunk<T>();
  constexpr int kStage = 4 * KL * kRow;       // rows: dl, d, du, b chunks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x;               // the computing warp's lanes
  const int c0 = blockIdx.x * kCols;
  const int ct = min(kCols, ncol - c0);       // columns of this tile
  const bool live = lane < ct;
  const size_t base = static_cast<size_t>(c0) * nz;
  // this lane's cp and bp: level k at cpv[k * kCStep] and bpv[k * kBStep]
  T* const cps = ring + kStages * kStage;                  // [nz][kCols]
  T* const bps = cps + static_cast<size_t>(nz) * kCols;    // [nz][kRow]
  const size_t own = base + static_cast<size_t>(lane) * nz;
  T* const cpv = kOnChip ? cps + lane : cp + own;
  T* const bpv = kOnChip ? bps + lane : x + own;
  constexpr int kCStep = kOnChip ? kCols : 1;
  constexpr int kBStep = kOnChip ? kRow : 1;
  const int nchunk = (nz + KL - 1) / KL;
  auto at = [&](const T* plane, int j) {   // chunk j of a plane, column 0
    return plane + base + static_cast<size_t>(j) * KL;
  };
  // the copy warp copies chunk j into its stage
  const bool copier = threadIdx.x >= kCols;
  auto fetch = [&](int j) {
    if (j < nchunk && copier) {
      T* stage = ring + (j % kStages) * kStage;
      T* const dst[4] = {stage, stage + KL * kRow, stage + 2 * KL * kRow,
                         stage + 3 * KL * kRow};
      const T* const src[4] = {at(dl, j), at(d, j), at(du, j), at(b, j)};
      mpp::copy_columns<T, 4>(dst, src, nz, min(KL, nz - j * KL), ct);
    }
    mpp::cp_async_commit();
  };

  for (int j = 0; j < kStages - 1; ++j) fetch(j);
  T cpm = T(0);
  T bpm = T(0);
  for (int j = 0; j < nchunk; ++j) {
    mpp::cp_async_wait<kStages - 2>();   // chunk j has landed
    __syncthreads();                     // ... for every thread's copies
    fetch(j + kStages - 1);              // into the stage chunk j-1 left
    if (live) {
      // the chunk's values, all read before any of its stores
      const T* st = ring + (j % kStages) * kStage + lane;
      T v[4 * KL];
#pragma unroll
      for (int r = 0; r < 4 * KL; ++r) v[r] = st[r * kRow];
      const int k0 = j * KL;
      const int kl = min(KL, nz - k0);
#pragma unroll
      for (int kk = 0; kk < KL; ++kk) {
        if (kk < kl) {
          const T dlk = v[kk];
          const T denom = v[KL + kk] - dlk * cpm;
          cpm = v[2 * KL + kk] / denom;
          bpm = (v[3 * KL + kk] - dlk * bpm) / denom;
          cpv[(k0 + kk) * kCStep] = cpm;
          bpv[(k0 + kk) * kBStep] = bpm;
        }
      }
    }
  }
  // back substitution in place, bp becoming x; each level's loads are
  // issued before the store of the level above
  if (live) {
    T xn = T(0);
    T bk = bpv[(nz - 1) * kBStep];
    T ck = cpv[(nz - 1) * kCStep];
#pragma unroll 4
    for (int k = nz - 1; k >= 0; --k) {
      const T bn = k > 0 ? bpv[(k - 1) * kBStep] : T(0);
      const T cn = k > 0 ? cpv[(k - 1) * kCStep] : T(0);
      xn = bk - ck * xn;
      bpv[k * kBStep] = xn;
      bk = bn;
      ck = cn;
    }
  }
  if (kOnChip) {
    __syncthreads();
    mpp::store_columns(x + base, bps, nz, ct);
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

// cp: the global scratch [ncol, nz], read only where nz exceeds
// thomas_max_on_chip (and then required).
template <typename T>
int launch_thomas(const void* dl, const void* d, const void* du,
                  const void* b, void* cp, void* x, int ncol, int nz,
                  void* stream) {
  const bool on_chip = nz <= thomas_max_on_chip<T>();
  if (!on_chip && cp == nullptr) return cudaErrorInvalidValue;
  static std::atomic<bool> smem_set[mpp::kMaxDevices];
  const cudaError_t attr = mpp::allow_smem(
      smem_set, thomas_kernel<T, true>, thomas_kernel<T, false>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int blocks = (ncol + kCols - 1) / kCols;
  const size_t smem = thomas_smem<T>(nz, on_chip);
  auto s = static_cast<cudaStream_t>(stream);
  auto kernel = on_chip ? thomas_kernel<T, true> : thomas_kernel<T, false>;
  kernel<<<blocks, mpp::kTileThreads, smem, s>>>(
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

// the deepest nz that thomas solves with cp and bp on chip for
// elem_bytes-sized values (4 or 8); deeper columns need the scratch cp
int mpp_thomas_max_on_chip(int elem_bytes) {
  return elem_bytes == 8 ? thomas_max_on_chip<double>()
                         : thomas_max_on_chip<float>();
}

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

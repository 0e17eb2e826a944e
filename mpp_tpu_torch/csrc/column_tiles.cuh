// Column tiles in shared memory, filled by asynchronous copies: the pieces
// shared by the two solve kernels (tridiag_kernels.cu: thomas;
// block_thomas_kernels.cu: block_thomas2).
//
// A CTA owns a tile of kCols consecutive columns of [ncol, values]
// row-major arrays.  It is two warps: the computing warp (threads 0-31, a
// column a lane) and the copy warp (threads 32-63), which streams the
// tile's level chunks through a ring of kStages shared stages with
// cp.async, so that the computing warp's instruction stream is the
// recurrence alone.
//
// Shared arrays are level-major: row e holds value e of the tile's kCols
// columns, so a lane of the computing warp reading row e touches
// consecutive words and no two lanes share a bank.  Rows that are also
// walked down a column (the copies' targets, the tile of x before its
// store) are padded to kRow = kCols + 1 values, so that consecutive
// threads walking down one column land on different banks too.
#pragma once

#include <atomic>
#include <cstddef>
#include <cuda_runtime.h>

namespace mpp {

constexpr int kCols = 32;         // columns of a tile: a lane each
constexpr int kRow = kCols + 1;   // padded row of a shared array
constexpr int kTileThreads = 2 * kCols;   // computing warp + copy warp
// ring depth: chunk j+1 lands while chunk j is eliminated
constexpr int kStages = 2;
// the most dynamic shared memory a CTA can take on Hopper (227 KB): where a
// solve's carries would need more, they go to global memory instead
constexpr int kOnChipBytes = 227 * 1024;

// cp.async of one kBytes-sized value (4 or 8): global -> shared, no
// registers in between; completion is tracked by commit groups.  The
// L2::256B hint makes a miss fetch the whole 256-byte block: a column's
// run of a chunk is only 64 bytes and the next chunks' runs follow it, so
// DRAM serves 256-byte requests instead of 64-byte ones from tens of
// thousands of column streams.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global.L2::256B [%0], [%1], %2;\n"
               :: "r"(s), "l"(gmem), "n"(kBytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kPending of this thread's commit groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// Issued by the copy warp: the copies of `len` contiguous values of each of
// the tile's `ncols` columns, column c starting at src[p] + c * stride,
// into shared rows dst[p] + e * kRow + c (e < len), for every plane
// p < kPlanes.  Consecutive lanes take consecutive values of the flat
// (column, e) index: the global reads coalesce, and the padded rows keep
// the shared writes on distinct banks.  Does not commit.
template <typename T, int kPlanes>
__device__ __forceinline__ void copy_columns(T* const (&dst)[kPlanes],
                                             const T* const (&src)[kPlanes],
                                             size_t stride, int len,
                                             int ncols) {
  const int t = threadIdx.x % kCols;
  int c = t / len, e = t % len;
  const int dc = kCols / len, de = kCols % len;
  for (int i = t; i < ncols * len; i += kCols) {
    const size_t g = c * stride + e;
    const int s = e * kRow + c;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p)
      cp_async<sizeof(T)>(dst[p] + s, src[p] + g);
    c += dc;
    e += de;
    if (e >= len) {
      e -= len;
      ++c;
    }
  }
}

// Store shared rows src + e * kRow + c (e < len, c < ncols) to the
// contiguous global run dst[c * len + e], shared among the CTA's threads:
// coalesced stores, distinct banks.
template <typename T>
__device__ __forceinline__ void store_columns(T* __restrict__ dst,
                                              const T* __restrict__ src,
                                              int len, int ncols) {
  const int nt = blockDim.x;
  int c = threadIdx.x / len, e = threadIdx.x % len;
  const int dc = nt / len, de = nt % len;
  for (int i = threadIdx.x; i < ncols * len; i += nt) {
    dst[i] = src[e * kRow + c];
    c += dc;
    e += de;
    if (e >= len) {
      e -= len;
      ++c;
    }
  }
}

// devices whose attributes a launcher records (beyond them it sets its
// attributes at every launch)
constexpr int kMaxDevices = 64;

// Let both forms of a kernel take up to kOnChipBytes of dynamic shared
// memory (above 48 KB only after this call) on the current device.  The
// attribute belongs to the device, so a launcher sets it at its first
// launch on each device; `done` is its record of those devices.
template <typename K>
cudaError_t allow_smem(std::atomic<bool> (&done)[kMaxDevices], K on_chip,
                       K spilled) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool recorded = dev >= 0 && dev < kMaxDevices;
  if (recorded && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  e = cudaFuncSetAttribute(on_chip,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kOnChipBytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(spilled,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kOnChipBytes);
  if (e != cudaSuccess) return e;
  if (recorded) done[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

}  // namespace mpp

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
// b) and writes 2 (x); about 40 flops and 6 divisions per level.  At
// [8192, 64] f64 that is 58.7 MB read and 8.4 MB written, more than the
// 50 MB L2: a cold stream.
//
// Design (the Pallas kernel's VMEM tile, rethought for an SM; see
// column_tiles.cuh): a CTA owns a tile of 32 consecutive columns, one a
// lane of its computing warp; 8192 columns make 256 CTAs, two on each SM.
// A column's chunk of KL levels is 4*KL contiguous values of L, D and U
// (64 bytes) and 2*KL of b, so a chunk of the tile is 32 strided runs a
// plane; the CTA's copy warp copies them with cp.async (consecutive lanes
// on consecutive values, L2::256B fetches) into a ring of two shared
// stages: chunk j+1 lands while the computing warp eliminates chunk j.
// The computing warp reads a chunk's values into registers before it
// stores any Cp or dp, keeps the forward carries (Cp 2x2, dp 2) in
// registers and every level's Cp and dp in shared memory, so the back
// substitution touches no global memory, and the tile of x (contiguous in
// global memory) leaves from shared memory as coalesced stores.  Shared
// memory a CTA: the ring (14.4 KB) plus n * 1552 B (f64; 776 B f32),
// 111.4 KB at n = 64 f64, which keeps two CTAs an SM (all 256 resident at
// once).  Where Cp and dp would not fit one CTA's 227 KB (n > 140 in f64,
// > 280 in f32) they go to the global scratch `cp` and to x instead, read
// back by each lane in the back substitution.
// ptxas (sm_90a, CUDA 12.8): 88 / 86 registers (f64 on chip / spilled),
// 76 / 75 (f32), no spills; 64 threads a CTA.  What holds it at 40 % of
// its bound at [8192, 64] f64 (PERF.md): two limits of about one size.
// With the recurrence skipped the copies take as long as the kernel
// (64-byte runs from ~33k column streams; two stages, all that two CTAs'
// Cp and dp leave room for); with the copies' waits skipped the
// recurrence does too (six IEEE divisions a level, which the compiler
// does not overlap).
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include "column_tiles.cuh"

namespace {

using mpp::kCols;
using mpp::kRow;
using mpp::kStages;

// levels of a chunk: a 64-byte run of each column of L, D and U
template <typename T>
__host__ __device__ constexpr int block_chunk() {
  return 16 / static_cast<int>(sizeof(T));
}

template <typename T>
constexpr size_t block_ring_bytes() {
  return sizeof(T) * kStages * 14 * block_chunk<T>() * kRow;
}

// dynamic shared memory of a CTA; with `on_chip` the ring plus Cp (4n rows
// of kCols) and dp (2n rows of kRow, stored from there as x)
template <typename T>
size_t block_smem(int n, bool on_chip) {
  return block_ring_bytes<T>() +
         (on_chip ? sizeof(T) * static_cast<size_t>(n) * (4 * kCols + 2 * kRow)
                  : 0);
}

// the deepest n whose Cp and dp fit one CTA's shared memory beside the
// ring (140 in f64, 280 in f32); deeper columns take the global scratch
template <typename T>
constexpr int block_max_on_chip() {
  return static_cast<int>((mpp::kOnChipBytes - block_ring_bytes<T>()) /
                          (sizeof(T) * (4 * kCols + 2 * kRow)));
}

// kOnChip: Cp and dp in shared memory; else Cp in the global scratch cp
// [ncol, n, 2, 2] and dp in x.
template <typename T, bool kOnChip>
__global__ void __launch_bounds__(mpp::kTileThreads)
block_thomas2_kernel(const T* __restrict__ L, const T* __restrict__ D,
                     const T* __restrict__ U, const T* __restrict__ b,
                     T* __restrict__ cp, T* __restrict__ x, int ncol, int n) {
  constexpr int KL = block_chunk<T>();
  // stage rows: L, D, U (4*KL each), b (2*KL)
  constexpr int kStage = 14 * KL * kRow;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x;               // the computing warp's lanes
  const int c0 = blockIdx.x * kCols;
  const int ct = min(kCols, ncol - c0);       // columns of this tile
  const bool live = lane < ct;
  const size_t base4 = static_cast<size_t>(c0) * n * 4;
  const size_t base2 = static_cast<size_t>(c0) * n * 2;
  // this lane's Cp and dp: value (k, j) at cpv[(4k + j) * kCStep] and
  // dpv[(2k + j) * kDStep]
  T* const cps = ring + kStages * kStage;                      // [4n][kCols]
  T* const dps = cps + static_cast<size_t>(n) * 4 * kCols;     // [2n][kRow]
  T* const cpv = kOnChip ? cps + lane
                         : cp + base4 + static_cast<size_t>(lane) * n * 4;
  T* const dpv = kOnChip ? dps + lane
                         : x + base2 + static_cast<size_t>(lane) * n * 2;
  constexpr int kCStep = kOnChip ? kCols : 1;
  constexpr int kDStep = kOnChip ? kRow : 1;
  const int nchunk = (n + KL - 1) / KL;
  const size_t n4 = 4 * static_cast<size_t>(n);
  const size_t n2 = 2 * static_cast<size_t>(n);
  // chunk j of a block plane / of b, column 0
  auto at4 = [&](const T* plane, int j) {
    return plane + base4 + 4 * static_cast<size_t>(j) * KL;
  };
  auto at2 = [&](int j) {
    return b + base2 + 2 * static_cast<size_t>(j) * KL;
  };
  // the copy warp copies chunk j into its stage
  const bool copier = threadIdx.x >= kCols;
  auto fetch = [&](int j) {
    if (j < nchunk && copier) {
      T* stage = ring + (j % kStages) * kStage;
      const int kl = min(KL, n - j * KL);
      T* const dst[3] = {stage, stage + 4 * KL * kRow, stage + 8 * KL * kRow};
      const T* const src[3] = {at4(L, j), at4(D, j), at4(U, j)};
      mpp::copy_columns<T, 3>(dst, src, n4, 4 * kl, ct);
      T* const dstb[1] = {stage + 12 * KL * kRow};
      const T* const srcb[1] = {at2(j)};
      mpp::copy_columns<T, 1>(dstb, srcb, n2, 2 * kl, ct);
    }
    mpp::cp_async_commit();
  };

  for (int j = 0; j < kStages - 1; ++j) fetch(j);
  // carries: Cp_{k-1} (c00 c01 / c10 c11) and dp_{k-1} (p0, p1)
  T c00 = T(0), c01 = T(0), c10 = T(0), c11 = T(0);
  T p0 = T(0), p1 = T(0);
  for (int j = 0; j < nchunk; ++j) {
    mpp::cp_async_wait<kStages - 2>();   // chunk j has landed
    __syncthreads();                     // ... for every thread's copies
    fetch(j + kStages - 1);              // into the stage chunk j-1 left
    if (live) {
      // the chunk's values, all read before any of its stores
      const T* st = ring + (j % kStages) * kStage + lane;
      T v[14 * KL];
#pragma unroll
      for (int r = 0; r < 14 * KL; ++r) v[r] = st[r * kRow];
      const int k0 = j * KL;
      const int kl = min(KL, n - k0);
#pragma unroll
      for (int kk = 0; kk < KL; ++kk) {
        if (kk < kl) {
          const int k = k0 + kk;
          const T* Lk = v + 4 * kk;
          const T* Dk = v + 4 * (KL + kk);
          const T* Uk = v + 4 * (2 * KL + kk);
          const T* bk = v + 12 * KL + 2 * kk;
          T a = Dk[0], bb = Dk[1], cc = Dk[2], dd = Dk[3];
          T r0 = bk[0], r1 = bk[1];
          if (k > 0) {
            a -= Lk[0] * c00 + Lk[1] * c10;
            bb -= Lk[0] * c01 + Lk[1] * c11;
            cc -= Lk[2] * c00 + Lk[3] * c10;
            dd -= Lk[2] * c01 + Lk[3] * c11;
            r0 -= Lk[0] * p0 + Lk[1] * p1;
            r1 -= Lk[2] * p0 + Lk[3] * p1;
          }
          const T det = a * dd - bb * cc;
          if (k < n - 1) {
            c00 = (dd * Uk[0] - bb * Uk[2]) / det;
            c01 = (dd * Uk[1] - bb * Uk[3]) / det;
            c10 = (-cc * Uk[0] + a * Uk[2]) / det;
            c11 = (-cc * Uk[1] + a * Uk[3]) / det;
            T* cpk = cpv + 4 * k * kCStep;
            cpk[0] = c00;
            cpk[kCStep] = c01;
            cpk[2 * kCStep] = c10;
            cpk[3 * kCStep] = c11;
          }
          p0 = (dd * r0 - bb * r1) / det;
          p1 = (-cc * r0 + a * r1) / det;
          T* dpk = dpv + 2 * k * kDStep;
          dpk[0] = p0;
          dpk[kDStep] = p1;
        }
      }
    }
  }
  // back substitution in place, dp becoming the solution; each level's
  // loads are issued before the stores of the level above
  if (live && n > 1) {
    T xn0 = dpv[2 * (n - 1) * kDStep];
    T xn1 = dpv[(2 * (n - 1) + 1) * kDStep];
    auto load = [&](int k, T (&c)[6]) {
      const T* cpk = cpv + 4 * k * kCStep;
      const T* dpk = dpv + 2 * k * kDStep;
      c[0] = cpk[0];
      c[1] = cpk[kCStep];
      c[2] = cpk[2 * kCStep];
      c[3] = cpk[3 * kCStep];
      c[4] = dpk[0];
      c[5] = dpk[kDStep];
    };
    T cur[6], nxt[6];
    load(n - 2, cur);
#pragma unroll 2
    for (int k = n - 2; k >= 0; --k) {
      if (k > 0) load(k - 1, nxt);
      const T x0 = cur[4] - (cur[0] * xn0 + cur[1] * xn1);
      const T x1 = cur[5] - (cur[2] * xn0 + cur[3] * xn1);
      T* dpk = dpv + 2 * k * kDStep;
      dpk[0] = x0;
      dpk[kDStep] = x1;
      xn0 = x0;
      xn1 = x1;
#pragma unroll
      for (int i = 0; i < 6; ++i) cur[i] = nxt[i];
    }
  }
  if (kOnChip) {
    __syncthreads();
    mpp::store_columns(x + base2, dps, 2 * n, ct);
  }
}

// cp: the global scratch [ncol, n, 2, 2], read only where n exceeds
// block_max_on_chip (and then required).
template <typename T>
int launch_block_thomas2(const void* L, const void* D, const void* U,
                         const void* b, void* cp, void* x, int ncol, int n,
                         void* stream) {
  const bool on_chip = n <= block_max_on_chip<T>();
  if (!on_chip && cp == nullptr) return cudaErrorInvalidValue;
  static std::atomic<bool> smem_set[mpp::kMaxDevices];
  const cudaError_t attr = mpp::allow_smem(
      smem_set, block_thomas2_kernel<T, true>,
      block_thomas2_kernel<T, false>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int blocks = (ncol + kCols - 1) / kCols;
  const size_t smem = block_smem<T>(n, on_chip);
  auto s = static_cast<cudaStream_t>(stream);
  auto kernel = on_chip ? block_thomas2_kernel<T, true>
                        : block_thomas2_kernel<T, false>;
  kernel<<<blocks, mpp::kTileThreads, smem, s>>>(
      static_cast<const T*>(L), static_cast<const T*>(D),
      static_cast<const T*>(U), static_cast<const T*>(b),
      static_cast<T*>(cp), static_cast<T*>(x), ncol, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// the deepest n that block_thomas2 solves with Cp and dp on chip for
// elem_bytes-sized values (4 or 8); deeper columns need the scratch cp
int mpp_block_thomas2_max_on_chip(int elem_bytes) {
  return elem_bytes == 8 ? block_max_on_chip<double>()
                         : block_max_on_chip<float>();
}

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

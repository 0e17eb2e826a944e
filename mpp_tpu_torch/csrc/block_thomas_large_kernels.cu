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
// then x_k = dp_k - Cp_k x_{k+1}.  The level's solve is LU with partial
// (row) pivoting applied to the m + 1 right-hand columns as they go, then
// the upper triangular solve column by column, as LAPACK's getrf + getrs
// (torch.linalg.solve) order it.  The pivot rule is block_thomas_small's:
// at column j the pivot is the row of the largest |entry| at rows >= j,
// ties to the lowest row and a NaN counted as the largest (the first NaN
// wins), the same in every thread (a block reduction in that total
// order).  No pivoting across levels (the eliminated diagonal blocks must
// stay invertible: block diagonal dominance).  L[s, 0] and U[s, n-1] are
// never read.  The arithmetic is f64 for f32 inputs too (the blocks are
// widened as they are read, x rounded once as it is written): a first
// build whose LU ran in f32 sat farther from the f64 solve than twice the
// plain form's f32 solve (cuSOLVER's) at m = 33, chip_smoke (z)'s f32
// rule (tests/test_torch_block_thomas_large.py's card cases).  Sums are FMA chains in an order of their own, so kernel and
// plain form agree to rounding, not bit for bit.
// NaN: one thread block runs one system and shares nothing with another,
// so a NaN in one system's blocks reaches that system's x and no other's.
//
// Layout: L, D, U row-major [nsys, n, m, m], b and x [nsys, n, m],
// contiguous (the wrapper flattens leading dims into nsys); cp a global f64
// scratch [nsys, n, m, m + 1] (the first n-1 levels' [Cp | dp], read back
// by the back substitution); ws the f64 working matrices [nsys, m, 2m + 1]
// where they do not fit shared memory (m > mpp_block_thomas_large_max_on_
// chip, 119), else null.  Pointers are
// device pointers, the launch goes on the caller's stream, nothing is
// allocated or synchronised here, and the launcher returns
// cudaGetLastError() (0 on success).  f32 and f64, any n >= 1, any m >= 1.
//
// Bound on the H100: bytes at the batched MLC's [4096, 93, 10] (L, D, U and
// b read once, x written once: (3 m^2 + 2 m) values a level, 0.29 ms in
// f64), operations at one wide system: a level is ~14/3 m^3 flops as
// getrf + getrs count them (the products L_k [Cp | dp], the LU, its solve
// of m + 1 columns; chip_smoke.btl_ops), at [1, 30, 200] f64 1.09 GFLOP,
// 0.0163 ms at the f64 tensor cores' 67 TFLOP/s.  One system runs on one
// SM, so at B = 1 the kernel can reach 1/132 of that rate at best;
// spreading a level over a cluster of SMs is later work.
//
// Design (simple first): one thread block a system, 32 x TY threads (TY =
// 1 to m = 16, then m / 8 rounded up, at most 32), the level loop inside.
// The level's working matrix W = [denom | U | rhs] (m x (2m + 1), row
// stride 2m + 1, so a column walk down W changes bank every row) lives in
// shared memory where it fits the 227 KB a block may take (m <= 119), else
// in the global scratch ws (642 KB at m = 200: L2-resident).  A level: the
// products L_k [Cp_{k-1} | dp_{k-1}] (Cp_{k-1} and dp_{k-1} are still W's
// right part; a warp a row, its lanes across the m + 1 columns, L_k's row
// broadcast from L1) into W's left part and a shared rhs vector; U_k and
// the rhs into the right part; then for j = 0..m-1 the pivot reduction
// (lanes, then warps through shared memory), the swap of rows j and p
// (columns j..2m), and the update of the rows below (each warp a row, the
// multiplier taken by its lanes); then the triangular solve, row j of X
// divided by its diagonal where it is last updated.  [Cp_k | dp_k] goes
// to cp; the back substitution runs the levels down with a warp a row of
// Cp_k x_{k+1} (a shuffle reduction) and x_{k+1} in shared memory.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstddef>

#include "column_tiles.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;

// true where a beats b for the pivot: larger, or a NaN against a number
template <typename T>
__device__ __forceinline__ bool beats(T a, T b) {
  return a > b || (a != a && b == b);
}

// (v, r) <- the better pivot candidate of (v, r) and (v2, r2): the one whose
// |entry| beats the other's, else (equal, or both NaN) the lower row.  A
// total order, so every reduction tree gives every thread the same pivot.
template <typename T>
__device__ __forceinline__ void better(T& v, int& r, T v2, int r2) {
  if (beats(v2, v) || (!beats(v, v2) && r2 < r)) {
    v = v2;
    r = r2;
  }
}

// warps a block: one to m = 16, then one per 8 rows, at most 32
__host__ __device__ constexpr int warps_for(int m) {
  return m <= 16 ? 1 : ((m + 7) / 8 < 32 ? (m + 7) / 8 : 32);
}

// shared bytes (every value in f64): W when on chip, two vectors of m, the
// pivot reduction's 32 values and 32 rows
__host__ __device__ constexpr size_t smem_bytes(int m, bool on_chip) {
  return (static_cast<size_t>(on_chip ? m * (2 * m + 1) : 0) + 2 * m + 32) *
             sizeof(double) + 32 * sizeof(int);
}

// the largest m whose W fits a block's shared memory
int max_on_chip() {
  int m = 1;
  while (smem_bytes(m + 1, true) <= mpp::kOnChipBytes) ++m;
  return m;
}

template <typename T, bool kOnChip>
__global__ void __launch_bounds__(1024)
block_thomas_large_kernel(const T* __restrict__ L, const T* __restrict__ D,
                          const T* __restrict__ U, const T* __restrict__ b,
                          double* cp, double* ws, T* x, int n, int m) {
  using C = double;                     // the arithmetic, for f32 too
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* sm = reinterpret_cast<C*>(smem_raw);
  const int ld = 2 * m + 1;
  const size_t s = blockIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y, TY = blockDim.y;
  const int tid = ty * kWarp + tx, nthr = TY * kWarp;
  C* W = kOnChip ? sm : ws + s * m * ld;
  C* r = kOnChip ? sm + static_cast<size_t>(m) * ld : sm;  // m values
  C* xs = r + m;                                            // m values
  C* redv = xs + m;                                         // 32 values
  int* redi = reinterpret_cast<int*>(redv + kWarp);         // 32 rows
  const size_t blk = static_cast<size_t>(m) * m;
  const size_t rec = static_cast<size_t>(m) * (m + 1);     // [Cp | dp]

  for (int k = 0; k < n; ++k) {
    const size_t o = (s * n + k) * blk;
    const size_t ov = (s * n + k) * m;
    // W's left part and the rhs: D_k - L_k Cp_{k-1}, b_k - L_k dp_{k-1}
    // ([Cp_{k-1} | dp_{k-1}] is W's right part); D_k and b_k at k = 0
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
            acc = fma(static_cast<C>(Li[q]), W[q * ld + m + c], acc);
          if (c < m) W[i * ld + c] = static_cast<C>(D[o + i * m + c]) - acc;
          else r[i] = static_cast<C>(b[ov + i]) - acc;
        }
      }
    }
    __syncthreads();
    // W's right part: U_k (zero at the last level) and the rhs
    for (int i = ty; i < m; i += TY) {
      for (int c = tx; c < m; c += kWarp)
        W[i * ld + m + c] =
            k < n - 1 ? static_cast<C>(U[o + i * m + c]) : C(0);
      if (tx == 0) W[i * ld + 2 * m] = r[i];
    }
    __syncthreads();

    // LU with partial pivoting, the right-hand columns eliminated alongside
    for (int j = 0; j < m; ++j) {
      C bv = C(-1);
      int br = INT_MAX;
      for (int i = j + tid; i < m; i += nthr)
        better(bv, br, fabs(W[i * ld + j]), i);
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1)
        better(bv, br, __shfl_xor_sync(kAll, bv, off),
               __shfl_xor_sync(kAll, br, off));
      if (TY > 1) {
        if (tx == 0) {
          redv[ty] = bv;
          redi[ty] = br;
        }
        __syncthreads();
        for (int w = 0; w < TY; ++w) better(bv, br, redv[w], redi[w]);
      }
      const int p = br;                 // the same in every thread
      if (p != j) {
        for (int c = j + tid; c < ld; c += nthr) {
          const C a = W[j * ld + c];
          W[j * ld + c] = W[p * ld + c];
          W[p * ld + c] = a;
        }
        __syncthreads();
      }
      const C piv = W[j * ld + j];
      for (int i = j + 1 + ty; i < m; i += TY) {
        const C f = W[i * ld + j] / piv;
        for (int c = j + 1 + tx; c < ld; c += kWarp)
          W[i * ld + c] = fma(-f, W[j * ld + c], W[i * ld + c]);
      }
      __syncthreads();
    }
    // the upper triangular solve of the right-hand columns X = W[:, m:]:
    // row j of X divided by U_jj, then taken from the rows above it
    {
      const int j = m - 1;
      const C d = W[j * ld + j];
      for (int c = tid; c <= m; c += nthr) W[j * ld + m + c] /= d;
      __syncthreads();
    }
    for (int j = m - 1; j > 0; --j) {
      for (int i = ty; i < j; i += TY) {
        const C u = W[i * ld + j];
        const C d = W[i * ld + i];
        for (int c = tx; c <= m; c += kWarp) {
          C v = fma(-u, W[j * ld + m + c], W[i * ld + m + c]);
          if (i == j - 1) v /= d;
          W[i * ld + m + c] = v;
        }
      }
      __syncthreads();
    }
    // [Cp_k | dp_k] to the scratch for the back substitution (k < n - 1)
    if (k < n - 1) {
      C* out = cp + (s * n + k) * rec;
      for (int i = ty; i < m; i += TY)
        for (int c = tx; c <= m; c += kWarp)
          out[i * (m + 1) + c] = W[i * ld + m + c];
    }
  }

  // back substitution: x_k = dp_k - Cp_k x_{k+1}, x_{n-1} = dp_{n-1}
  C* xa = r;
  C* xb = xs;
  const size_t last = (s * n + n - 1) * m;
  for (int i = tid; i < m; i += nthr) {
    xa[i] = W[i * ld + 2 * m];
    x[last + i] = static_cast<T>(xa[i]);
  }
  __syncthreads();
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

template <typename T, bool kOnChip>
int launch(const void* L, const void* D, const void* U, const void* b,
           void* cp, void* ws, void* x, int nsys, int n, int m,
           cudaStream_t stream) {
  block_thomas_large_kernel<T, kOnChip>
      <<<static_cast<unsigned>(nsys), dim3(kWarp, warps_for(m)),
         smem_bytes(m, kOnChip), stream>>>(
          static_cast<const T*>(L), static_cast<const T*>(D),
          static_cast<const T*>(U), static_cast<const T*>(b),
          static_cast<double*>(cp), static_cast<double*>(ws),
          static_cast<T*>(x), n, m);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_m(const void* L, const void* D, const void* U, const void* b,
             void* cp, void* ws, void* x, int nsys, int n, int m,
             void* stream) {
  if (nsys <= 0 || n <= 0) return cudaSuccess;
  if (m < 1) return cudaErrorInvalidValue;
  if (n > 1 && cp == nullptr) return cudaErrorInvalidValue;
  static std::atomic<bool> done[mpp::kMaxDevices];
  const cudaError_t e = mpp::allow_smem(
      done, block_thomas_large_kernel<T, true>,
      block_thomas_large_kernel<T, false>);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto st = static_cast<cudaStream_t>(stream);
  if (m <= max_on_chip())
    return launch<T, true>(L, D, U, b, cp, ws, x, nsys, n, m, st);
  if (ws == nullptr) return cudaErrorInvalidValue;
  return launch<T, false>(L, D, U, b, cp, ws, x, nsys, n, m, st);
}

}  // namespace

extern "C" {

// the largest m whose working matrix a block keeps in shared memory (the
// same for f32 and f64: both work in f64); past it the launch needs ws
int mpp_block_thomas_large_max_on_chip(int) { return max_on_chip(); }

// cp: the scratch [nsys, n, m, m + 1] of f64 (the levels' [Cp | dp]; may
// be null when n == 1); ws: the working matrices [nsys, m, 2m + 1] of f64
// (null when m fits shared memory)
int mpp_block_thomas_large_f32(const void* L, const void* D, const void* U,
                               const void* b, void* cp, void* ws, void* x,
                               int nsys, int n, int m, void* stream) {
  return launch_m<float>(L, D, U, b, cp, ws, x, nsys, n, m, stream);
}

int mpp_block_thomas_large_f64(const void* L, const void* D, const void* U,
                               const void* b, void* cp, void* ws, void* x,
                               int nsys, int n, int m, void* stream) {
  return launch_m<double>(L, D, U, b, cp, ws, x, nsys, n, m, stream);
}

}  // extern "C"

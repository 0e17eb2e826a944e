// ILU(0) on a fixed CSR sparsity for Hopper (sm_90a): the numeric IKJ
// factorization and the preconditioner apply (LU)^-1 b, batched over
// systems.
//
// Replaces no Pallas kernel: the JAX package runs both as lax.scan row
// sweeps that XLA compiles into one device loop each,
// mpp_tpu/batched/ilu_gmres.py:121-162 (BatchedILU0.factor, the scan at
// l.140; BatchedILU0.solve, the forward and back scans at l.152 and l.161).
//
// Layout: values are row-major [B, nnz] (the CSR slots of one system a row)
// and right-hand sides [B, n].  The schedule is one contiguous int32 array
// built in numpy once per sparsity (hopper_kernels.ilu0_schedule); its
// header holds the offsets of its sections:
//   factor: [S, lp_ptr, pair_ptr, lp, ld, pij, pik, pkj]
//     step s (s < S, the IKJ steps ordered by wavefront level) divides the
//     slots lp[lp_ptr[s] .. lp_ptr[s+1]) by their pivots ld[..]; then, for
//     t in [pair_ptr[s], pair_ptr[s+1]), f[pij] -= f[pik] * f[pkj], where
//     pik is the slot of the multiplier the step just wrote.
//   apply: [Lf, Lb, the forward sweep's row_ptr, tab_ptr, width, rows, pos,
//     col, then the back sweep's six and dpos]
//     level L of a sweep holds rows[row_ptr[L] .. row_ptr[L+1]); row r of
//     it reads width[L] slots pos[tab_ptr[L] + (r - row_ptr[L]) * width[L]
//     + w] and columns col[..]; pads are slot nnz and column n, and read as
//     zero.  The back sweep divides by f[dpos[r]].
//
// Design: one thread block per system.  The wavefront levels (factor: the
// steps) run as a loop inside the block with __syncthreads() between them;
// the threads of a level take its rows (factor: a step's rows, then after
// a barrier that step's pairs), striding by blockDim for any width.  The
// factor copies its system into the output row and works there in global
// memory (L1 / L2 resident).  The apply keeps y in shared memory up to
// kOnChipBytes (n <= 29056 in f64, 58112 in f32); past that y lives in the
// output row x.  The factor values are read from global memory once an
// apply.
//
// Arithmetic: the plain forms' order, every operation rounded on its own
// (__dmul_rn / __dsub_rn / __ddiv_rn, no FMA contraction): m = f_ik / f_kk,
// then f_ij - (m f_kj), so the factor is the plain form's bit for bit.
// The apply sums each padded row left to right, products first; the plain
// form's torch.sum may associate the row's terms otherwise, so the two
// agree to rounding (1e-12 of max |x| in f64, 1e-5 in f32), not bitwise.
//
// Bound on the H100: neither bytes nor operations.  A level costs a
// barrier plus a chain of dependent loads (index, value, y), so one system
// takes about levels x that latency (th_manoli2014: 2 x 2000 levels an
// apply and 8889 steps a factorization at scale 10).  Many systems fill
// the card (TH: 8192 blocks); one system leaves all but one SM idle,
// which is work for a later change (several blocks a system, or the next
// level's indices and values loaded before the barrier).
//
// Contract shared by the launchers: pointers are device pointers of
// contiguous tensors, the launch goes on the caller's stream, nothing is
// allocated or synchronised here, and the return value is
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>

#include "column_tiles.cuh"

namespace {

__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}

// header entries of the two schedules (hopper_kernels.ilu0_schedule)
enum FactorHeader { kSteps, kLpPtr, kPairPtr, kLp, kLd, kPij, kPik, kPkj };
enum ApplyHeader { kLevelsF, kLevelsB, kSweepF };
constexpr int kSweepFields = 6;   // row_ptr, tab_ptr, width, rows, pos, col
constexpr int kSweepB = kSweepF + kSweepFields;
constexpr int kDpos = kSweepB + kSweepFields;

template <typename T>
__global__ void ilu0_factor_kernel(const T* __restrict__ data,
                                   T* __restrict__ out,
                                   const int* __restrict__ sched, int nnz) {
  const size_t base = static_cast<size_t>(blockIdx.x) * nnz;
  const T* src = data + base;
  T* f = out + base;
  for (int k = threadIdx.x; k < nnz; k += blockDim.x) f[k] = src[k];
  const int steps = sched[kSteps];
  const int* lp_ptr = sched + sched[kLpPtr];
  const int* pair_ptr = sched + sched[kPairPtr];
  const int* lp = sched + sched[kLp];
  const int* ld = sched + sched[kLd];
  const int* pij = sched + sched[kPij];
  const int* pik = sched + sched[kPik];
  const int* pkj = sched + sched[kPkj];
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int t1 = lp_ptr[s + 1];
    for (int t = lp_ptr[s] + threadIdx.x; t < t1; t += blockDim.x) {
      const int p = lp[t];
      f[p] = div_rn(f[p], f[ld[t]]);
    }
    __syncthreads();
    const int q0 = pair_ptr[s], q1 = pair_ptr[s + 1];
    if (q1 > q0) {
      // the slots pij of a step are distinct, and none is read by another
      // pair of the step (pik and pkj lie in pivot rows or at lp)
      for (int t = q0 + threadIdx.x; t < q1; t += blockDim.x) {
        const int q = pij[t];
        f[q] = sub_rn(f[q], mul_rn(f[pik[t]], f[pkj[t]]));
      }
      __syncthreads();
    }
  }
}

// One sweep over its levels; kBack: the upper sweep with the divide.
template <typename T, bool kBack>
__device__ __forceinline__ void sweep(const T* __restrict__ f, T* y,
                                      const int* __restrict__ sched,
                                      int fields, int levels, int n,
                                      int nnz) {
  const int* row_ptr = sched + sched[fields];
  const int* tab_ptr = sched + sched[fields + 1];
  const int* width = sched + sched[fields + 2];
  const int* rows = sched + sched[fields + 3];
  const int* pos = sched + sched[fields + 4];
  const int* col = sched + sched[fields + 5];
  const int* dpos = sched + sched[kDpos];
  for (int L = 0; L < levels; ++L) {
    const int r0 = row_ptr[L], r1 = row_ptr[L + 1];
    const int w_n = width[L];
    const int* lpos = pos + tab_ptr[L];
    const int* lcol = col + tab_ptr[L];
    for (int r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
      const int o = (r - r0) * w_n;
      T s = T(0);
      for (int w = 0; w < w_n; ++w) {
        const int p = lpos[o + w], c = lcol[o + w];
        const T fv = p < nnz ? f[p] : T(0);
        const T yv = c < n ? y[c] : T(0);
        s = add_rn(s, mul_rn(fv, yv));
      }
      const int i = rows[r];
      y[i] = kBack ? div_rn(sub_rn(y[i], s), f[dpos[r]]) : sub_rn(y[i], s);
    }
    __syncthreads();
  }
}

// kShared: y in dynamic shared memory ([n]); else in the output row of x.
template <typename T, bool kShared>
__global__ void ilu0_apply_kernel(const T* __restrict__ fac,
                                  const T* __restrict__ b,
                                  T* __restrict__ x,
                                  const int* __restrict__ sched, int n,
                                  int nnz) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* f = fac + static_cast<size_t>(blockIdx.x) * nnz;
  const T* bb = b + static_cast<size_t>(blockIdx.x) * n;
  T* xx = x + static_cast<size_t>(blockIdx.x) * n;
  T* y = kShared ? reinterpret_cast<T*>(smem_raw) : xx;
  for (int k = threadIdx.x; k < n; k += blockDim.x) y[k] = bb[k];
  __syncthreads();
  sweep<T, false>(f, y, sched, kSweepF, sched[kLevelsF], n, nnz);
  sweep<T, true>(f, y, sched, kSweepB, sched[kLevelsB], n, nnz);
  if (kShared)
    for (int k = threadIdx.x; k < n; k += blockDim.x) xx[k] = y[k];
}

template <typename T>
constexpr int apply_max_on_chip() {
  return static_cast<int>(mpp::kOnChipBytes / sizeof(T));
}

template <typename T>
int launch_factor(const void* data, void* f, const void* sched, int B,
                  int nnz, int threads, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  ilu0_factor_kernel<T><<<B, threads, 0, s>>>(
      static_cast<const T*>(data), static_cast<T*>(f),
      static_cast<const int*>(sched), nnz);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_apply(const void* f, const void* b, void* x, const void* sched,
                 int B, int n, int nnz, int threads, void* stream) {
  static std::atomic<bool> smem_set[mpp::kMaxDevices];
  const cudaError_t attr = mpp::allow_smem(
      smem_set, ilu0_apply_kernel<T, true>, ilu0_apply_kernel<T, false>);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bool shared = n <= apply_max_on_chip<T>();
  const size_t smem = shared ? sizeof(T) * static_cast<size_t>(n) : 0;
  auto kernel = shared ? ilu0_apply_kernel<T, true>
                       : ilu0_apply_kernel<T, false>;
  auto s = static_cast<cudaStream_t>(stream);
  kernel<<<B, threads, smem, s>>>(
      static_cast<const T*>(f), static_cast<const T*>(b), static_cast<T*>(x),
      static_cast<const int*>(sched), n, nnz);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// the largest n whose y the apply keeps in shared memory, for
// elem_bytes-sized values (4 or 8); larger systems keep y in x
int mpp_ilu0_apply_max_on_chip(int elem_bytes) {
  return elem_bytes == 8 ? apply_max_on_chip<double>()
                         : apply_max_on_chip<float>();
}

int mpp_ilu0_factor_f32(const void* data, void* f, const void* sched, int B,
                        int nnz, int threads, void* stream) {
  return launch_factor<float>(data, f, sched, B, nnz, threads, stream);
}

int mpp_ilu0_factor_f64(const void* data, void* f, const void* sched, int B,
                        int nnz, int threads, void* stream) {
  return launch_factor<double>(data, f, sched, B, nnz, threads, stream);
}

int mpp_ilu0_apply_f32(const void* f, const void* b, void* x,
                       const void* sched, int B, int n, int nnz, int threads,
                       void* stream) {
  return launch_apply<float>(f, b, x, sched, B, n, nnz, threads, stream);
}

int mpp_ilu0_apply_f64(const void* f, const void* b, void* x,
                       const void* sched, int B, int n, int nnz, int threads,
                       void* stream) {
  return launch_apply<double>(f, b, x, sched, B, n, nnz, threads, stream);
}

}  // extern "C"

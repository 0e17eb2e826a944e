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
// and right-hand sides [B, n].  The schedule is built once a sparsity on
// the host (ops/ilu0_schedule.py): the rows split into connected
// components, binned into parts that never read each other's slots; each
// part has its own IKJ steps and sweep levels (the whole schedule's,
// restricted to its rows, in the same order).  A kernel reads one int32
// program: a header [parts, program words, value stride, y offset, table
// offset], a table of parts (kFields words each), then the parts'
// sections in local numbering (a part's slots and rows numbered from 0, a
// pad one past the last, which reads a zero):
//   factor record (a wavefront step): [rows, width, (p, d) x rows, (pij,
//     pkj) x rows x width]: row r's multiplier m = f[p] / f[d] goes to p
//     (d < 0: m is in p already, a row continued from an earlier record),
//     then f[pij] -= m * f[pkj] for its pairs, padded with a dummy slot;
//     the rows of a record are independent, so a lane takes a row whole
//     and a record needs one barrier;
//   apply level: [rows, width, local rows, (f, column) x rows x width, back
//     levels: the rows' diagonal f]: y[i] -= sum (f * y) (forward), y[i] =
//     (y[i] - sum) / f_ii (back).
//
// Design: the grid is systems x parts, and every level's dependent chain
// runs through shared memory.  Two forms a kernel, chosen on the host by a
// rule (ILU0Schedule.plan) from the schedule's widths and the limits that
// mpp_ilu0_limit exports, never by a failure:
//   staged: a block copies its part's whole program into shared memory
//     once (cp.async, 16 bytes a copy) and gathers the values of its k
//     systems there (cp.async; for the apply f and b, with the pads'
//     zeros), then walks the steps / levels on shared memory alone and
//     writes the values out once.  A system takes G lanes of a warp (8,
//     16 or 32: the fewest that give the slowest part the fewest rounds,
//     a lane looping over a wider step's rows), 32 / G systems a warp,
//     their lanes mapped to (system, row), with __syncwarp() between
//     records: the systems of a warp share the part, so they stay in
//     lockstep, and no barrier spans a block.  k systems a block, the
//     count that keeps the most systems resident on an SM; the last block
//     of a batch that does not divide runs fewer, no pad system computed.
//     Needs the largest part's program plus one system's values within
//     kOnChipBytes.
//   streamed: past that (th_manoli2014 at scale 10: 599 KB of factor
//     program, 253 KB of f64 values), one system a block of two warps.
//     The copy warp streams the program through a ring of kRingStages
//     stages (chunks at record boundaries, cp.async), the consumer warp
//     runs the chunk that has landed.  The factor keeps its values in
//     shared-memory cells: with each chunk the copy warp gathers the slots
//     the chunk touches first, and after it writes back the slots it
//     touched last, so a cell holds a slot only over its live chunks (the
//     host colours them: 6,082 cells for scale 10's 32,384 slots).  The
//     apply's copy warp gathers beside each chunk the f values its levels
//     read (each slot is read once an apply); y stays in shared memory.
//     A record too big for a stage is cut between rows, and a row too
//     wide into pieces (a factor row's later pieces carry no divisor; an
//     apply row loses its pieces' sums one after another, its back pieces
//     but the last dividing by one).  Cells (factor) or rows of y (apply)
//     past the on-chip limit live in a global scratch (the wrapper's),
//     reached through generic pointers.
// A lane takes a row whole: its up to kChunk pairs' (terms') indices, then
// their values, are loaded by straight-line code fixed at compile time for
// the row's width, and a factor row's operands are loaded before its
// divide.
//
// Arithmetic: the plain forms' order, every operation rounded on its own
// (__dmul_rn / __dsub_rn / __ddiv_rn, no FMA contraction): m = f_ik / f_kk,
// then f_ij - (m f_kj), so the factor is the plain form's bit for bit
// (parts keep each slot's sequence of operations).  The apply sums each
// padded row left to right, products first; the plain form's torch.sum
// may associate the row's terms otherwise, so the two agree to rounding
// (1e-12 of max |x| in f64, 1e-5 in f32), not bitwise.
//
// Bound on the H100: latency, not bytes or operations.  One system's
// record is a chain of ~100 mostly dependent instructions (index
// arithmetic, the width dispatch, two shared-memory round trips, the
// multiply-add chain, an f64 divide), ~0.25-0.3 us on one warp; a chip
// run with the divide taken out read 15 % less, without the warp barrier
// no less.  Many systems (TH: 8192) are limited by the shared memory a
// system takes (~31 f64 systems an SM at (q)'s column), spread over 8
// warps so that their chains overlap.
//
// Contract shared by the launchers: pointers are device pointers of
// contiguous tensors, the launch goes on the caller's stream, nothing is
// allocated or synchronised here, and the return value is
// cudaGetLastError() after the launch (0 on success).

#include <cuda_runtime.h>

#include <atomic>

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

// the program's header and table entries (ops/ilu0_schedule.py)
enum Head { kParts = 0, kProgWords = 1, kStride = 2, kYOff = 3, kTable = 4 };
constexpr int kFields = 8;

constexpr int kMaxThreads = 256;       // the staged forms' widest block
constexpr int kWarp = 32;              // the staged forms' most lanes a system
constexpr int kStreamThreads = 64;     // consumer warp + copy warp
constexpr int kRingStages = mpp::kStages;
constexpr int kStageWords = 4096;      // program words a stage (16 KB)
constexpr int kStageValueBytes = 16384;   // apply: f values a stage

template <typename T>
__host__ __device__ constexpr int stage_values() {
  return kStageValueBytes / static_cast<int>(sizeof(T));
}
__host__ __device__ constexpr size_t factor_ring_bytes() {
  return sizeof(int) * kRingStages * static_cast<size_t>(kStageWords);
}
__host__ __device__ constexpr size_t apply_stage_bytes() {
  return sizeof(int) * static_cast<size_t>(kStageWords) + kStageValueBytes;
}
__host__ __device__ constexpr size_t apply_ring_bytes() {
  return kRingStages * apply_stage_bytes();
}
// the streamed forms' on-chip limits: factor cells, apply rows of y
template <typename T>
__host__ __device__ constexpr int factor_cells() {
  return static_cast<int>((mpp::kOnChipBytes - factor_ring_bytes()) /
                          sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int apply_rows() {
  return static_cast<int>((mpp::kOnChipBytes - apply_ring_bytes()) /
                          sizeof(T));
}

// cp.async of 16 bytes (4 program words), global -> shared
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

// copies of nwords (a multiple of 4, both ends 16-byte aligned) shared
// among nt threads, thread t first; does not commit
__device__ __forceinline__ void copy_words(int* dst, const int* src,
                                           int nwords, int t, int nt) {
  for (int i = 4 * t; i < nwords; i += 4 * nt) cp_async16(dst + i, src + i);
}

// A row's pairs (apply: terms) are handled W at a time by straight-line
// code, W fixed at compile time (1-8, dispatched on the row's width), so
// that all W index loads issue together, then all W value loads, then the
// arithmetic: a chain of two shared-memory round trips a row, not two a
// term.
constexpr int kChunk = 8;

// f[q_k] -= m f[kj_k] for W pairs at e; with kDivide, m = num / den is
// formed between the loads and the updates (the loads do not wait on it)
// and stored to fp after them.  Returns m.
template <typename T, int W, bool kDivide, typename At>
__device__ __forceinline__ T pairs(const int* e, At at, T* fp, T num, T den,
                                   T m) {
  int q[W], kj[W];
  T qv[W], kv[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    q[k] = e[2 * k];
    kj[k] = e[2 * k + 1];
  }
#pragma unroll
  for (int k = 0; k < W; ++k) {
    qv[k] = *at(q[k]);
    kv[k] = *at(kj[k]);
  }
  if (kDivide) m = div_rn(num, den);
#pragma unroll
  for (int k = 0; k < W; ++k) *at(q[k]) = sub_rn(qv[k], mul_rn(m, kv[k]));
  if (kDivide) *fp = m;
  return m;
}

template <typename T, bool kDivide, typename At>
__device__ __forceinline__ T pairs_w(int w, const int* e, At at, T* fp,
                                     T num, T den, T m) {
  switch (w) {
    case 0:
      if (kDivide) {
        m = div_rn(num, den);
        *fp = m;
      }
      return m;
    case 1: return pairs<T, 1, kDivide>(e, at, fp, num, den, m);
    case 2: return pairs<T, 2, kDivide>(e, at, fp, num, den, m);
    case 3: return pairs<T, 3, kDivide>(e, at, fp, num, den, m);
    case 4: return pairs<T, 4, kDivide>(e, at, fp, num, den, m);
    case 5: return pairs<T, 5, kDivide>(e, at, fp, num, den, m);
    case 6: return pairs<T, 6, kDivide>(e, at, fp, num, den, m);
    case 7: return pairs<T, 7, kDivide>(e, at, fp, num, den, m);
    default: return pairs<T, 8, kDivide>(e, at, fp, num, den, m);
  }
}

// One factor record at prog, with its header (nr rows, width w) read
// already: row r's multiplier m = f[p] / f[d] (d < 0: m is in p already),
// then f[pij] -= m f[pkj] for its pairs, on the lanes sub, sub + G, ... of
// the system; the first kChunk pairs' operands are loaded before the
// divide.  The values go through at(cell).
template <typename T, typename At>
__device__ __forceinline__ void factor_step(const int* prog, int nr, int w,
                                           At at, bool active, int sub,
                                           int G) {
  const int* pd = prog + 2;
  const int* tab = pd + 2 * nr;
  if (active)
    for (int r = sub; r < nr; r += G) {
      const int p = pd[2 * r], d = pd[2 * r + 1];
      const int* e = tab + 2 * r * w;
      T* fp = at(p);
      const T num = *fp;
      const int w0 = min(w, kChunk);
      const T m = d >= 0 ? pairs_w<T, true>(w0, e, at, fp, num, *at(d), num)
                         : pairs_w<T, false>(w0, e, at, fp, num, num, num);
      for (int k0 = w0; k0 < w; k0 += kChunk)
        pairs_w<T, false>(min(w - k0, kChunk), e + 2 * k0, at, fp, num, num,
                          m);
    }
  __syncwarp();
}

// sum_k f[p_k] y[c_k] over W terms at e, added to acc left to right
template <typename T, int W, typename Y>
__device__ __forceinline__ T terms(const int* e, const T* fv, Y ya, T acc) {
  int p[W], c[W];
#pragma unroll
  for (int k = 0; k < W; ++k) {
    p[k] = e[2 * k];
    c[k] = e[2 * k + 1];
  }
  T prod[W];
#pragma unroll
  for (int k = 0; k < W; ++k) prod[k] = mul_rn(fv[p[k]], *ya(c[k]));
#pragma unroll
  for (int k = 0; k < W; ++k) acc = add_rn(acc, prod[k]);
  return acc;
}

template <typename T, typename Y>
__device__ __forceinline__ T terms_w(int w, const int* e, const T* fv, Y ya,
                                     T acc) {
  switch (w) {
    case 0: return acc;
    case 1: return terms<T, 1>(e, fv, ya, acc);
    case 2: return terms<T, 2>(e, fv, ya, acc);
    case 3: return terms<T, 3>(e, fv, ya, acc);
    case 4: return terms<T, 4>(e, fv, ya, acc);
    case 5: return terms<T, 5>(e, fv, ya, acc);
    case 6: return terms<T, 6>(e, fv, ya, acc);
    case 7: return terms<T, 7>(e, fv, ya, acc);
    default: return terms<T, 8>(e, fv, ya, acc);
  }
}

// One sweep level at prog, with its header (nr rows, width w) read
// already; f values fv[], y through ya(row).
template <typename T, typename Y>
__device__ __forceinline__ void apply_level(const int* prog, int nr, int w,
                                           const T* fv, Y ya, bool back,
                                           bool active, int sub, int G) {
  const int* rows = prog + 2;
  const int* tab = rows + nr;
  const int* dia = tab + 2 * nr * w;
  if (active)
    for (int r = sub; r < nr; r += G) {
      const int* e = tab + 2 * r * w;
      T* yi = ya(rows[r]);
      const T y0 = *yi;
      const T d = back ? fv[dia[r]] : T(1);
      T acc = T(0);
      for (int k0 = 0; k0 < w; k0 += kChunk)
        acc = terms_w<T>(min(w - k0, kChunk), e + 2 * k0, fv, ya, acc);
      *yi = back ? div_rn(sub_rn(y0, acc), d) : sub_rn(y0, acc);
    }
  __syncwarp();
}

// the words of a factor record and of a sweep level, from their headers
__device__ __forceinline__ int factor_words(int nr, int w) {
  return 2 + 2 * nr + 2 * nr * w;
}
__device__ __forceinline__ int level_words(int nr, int w, bool back) {
  return 2 + nr + 2 * nr * w + (back ? nr : 0);
}

// a staged block's place: its part, first system and systems; a thread's
// system slot and lane among the system's G
struct Staged {
  int part, sys0, nsys, slot, sub;
  bool active;
};

__device__ __forceinline__ Staged staged_place(int B, int k, int G) {
  Staged s;
  const int groups = (B + k - 1) / k;
  s.part = blockIdx.x / groups;
  s.sys0 = (blockIdx.x - s.part * groups) * k;
  s.nsys = min(k, B - s.sys0);
  const int lane = threadIdx.x & 31;
  s.slot = (threadIdx.x >> 5) * (kWarp / G) + lane / G;
  s.sub = lane % G;
  s.active = s.slot < s.nsys;
  return s;
}

// part: [slots, nnz_p, program, program words, steps]
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
ilu0_factor_staged(const T* __restrict__ data, T* __restrict__ out,
                   const int* __restrict__ sched, int B, int nnz, int k,
                   int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Staged w = staged_place(B, k, G);
  const int* pt = sched + sched[kTable] + w.part * kFields;
  const int* slots = sched + pt[0];
  const int nnz_p = pt[1], nsteps = pt[4];
  const int stride = sched[kStride];
  int* prog = reinterpret_cast<int*>(smem_raw);
  T* vals = reinterpret_cast<T*>(
      smem_raw + sizeof(int) * static_cast<size_t>(sched[kProgWords]));
  const int t = threadIdx.x, nt = blockDim.x;
  copy_words(prog, sched + pt[2], pt[3], t, nt);
  for (int i = t; i < w.nsys * nnz_p; i += nt) {
    const int s = i / nnz_p, j = i - s * nnz_p;
    mpp::cp_async<sizeof(T)>(
        vals + s * stride + j,
        data + static_cast<size_t>(w.sys0 + s) * nnz + slots[j]);
  }
  mpp::cp_async_commit();
  mpp::cp_async_wait<0>();
  __syncthreads();
  T* v = vals + w.slot * stride;
  auto at = [v](int c) { return v + c; };
  const int* cur = prog;
  int nr = nsteps > 0 ? cur[0] : 0, wd = nsteps > 0 ? cur[1] : 0;
  for (int s = 0; s < nsteps; ++s) {
    // the next record's header, read ahead of this record's work
    const int size = factor_words(nr, wd);
    const int nr2 = s + 1 < nsteps ? cur[size] : 0;
    const int wd2 = s + 1 < nsteps ? cur[size + 1] : 0;
    factor_step<T>(cur, nr, wd, at, w.active, w.sub, G);
    cur += size;
    nr = nr2;
    wd = wd2;
  }
  __syncthreads();
  for (int i = t; i < w.nsys * nnz_p; i += nt) {
    const int s = i / nnz_p, j = i - s * nnz_p;
    out[static_cast<size_t>(w.sys0 + s) * nnz + slots[j]] =
        vals[s * stride + j];
  }
}

// part: [rows, n_p, slots, nnz_p, program, program words, forward levels,
// back levels]; a system's f at vals[0 .. nnz_p], y at vals[y_off ..]
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
ilu0_apply_staged(const T* __restrict__ fac, const T* __restrict__ b,
                  T* __restrict__ x, const int* __restrict__ sched, int B,
                  int n, int nnz, int k, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Staged w = staged_place(B, k, G);
  const int* pt = sched + sched[kTable] + w.part * kFields;
  const int* rows = sched + pt[0];
  const int* slots = sched + pt[2];
  const int n_p = pt[1], nnz_p = pt[3];
  const int nf = pt[6], nlev = pt[6] + pt[7];
  const int stride = sched[kStride], yoff = sched[kYOff];
  int* prog = reinterpret_cast<int*>(smem_raw);
  T* vals = reinterpret_cast<T*>(
      smem_raw + sizeof(int) * static_cast<size_t>(sched[kProgWords]));
  const int t = threadIdx.x, nt = blockDim.x;
  copy_words(prog, sched + pt[4], pt[5], t, nt);
  for (int i = t; i < w.nsys * nnz_p; i += nt) {
    const int s = i / nnz_p, j = i - s * nnz_p;
    mpp::cp_async<sizeof(T)>(
        vals + s * stride + j,
        fac + static_cast<size_t>(w.sys0 + s) * nnz + slots[j]);
  }
  for (int i = t; i < w.nsys * n_p; i += nt) {
    const int s = i / n_p, j = i - s * n_p;
    mpp::cp_async<sizeof(T)>(
        vals + s * stride + yoff + j,
        b + static_cast<size_t>(w.sys0 + s) * n + rows[j]);
  }
  for (int s = t; s < w.nsys; s += nt) {
    vals[s * stride + nnz_p] = T(0);
    vals[s * stride + yoff + n_p] = T(0);
  }
  mpp::cp_async_commit();
  mpp::cp_async_wait<0>();
  __syncthreads();
  const T* fv = vals + w.slot * stride;
  T* y = vals + w.slot * stride + yoff;
  auto ya = [y](int c) { return y + c; };
  const int* cur = prog;
  int nr = nlev > 0 ? cur[0] : 0, wd = nlev > 0 ? cur[1] : 0;
  for (int L = 0; L < nlev; ++L) {
    const int size = level_words(nr, wd, L >= nf);
    const int nr2 = L + 1 < nlev ? cur[size] : 0;
    const int wd2 = L + 1 < nlev ? cur[size + 1] : 0;
    apply_level<T>(cur, nr, wd, fv, ya, L >= nf, w.active, w.sub, G);
    cur += size;
    nr = nr2;
    wd = wd2;
  }
  __syncthreads();
  for (int i = t; i < w.nsys * n_p; i += nt) {
    const int s = i / n_p, j = i - s * n_p;
    x[static_cast<size_t>(w.sys0 + s) * n + rows[j]] =
        vals[s * stride + yoff + j];
  }
}

// part: [chunks, chunk table, untouched slots, their count, cells]; chunk:
// [words offset, words, steps, gathers, their count, write-backs, their
// count]; gathers and write-backs (cell, slot)
template <typename T, bool kSpill>
__global__ void __launch_bounds__(kStreamThreads)
ilu0_factor_streamed(const T* __restrict__ data, T* __restrict__ out,
                     const int* __restrict__ sched, T* __restrict__ spill,
                     int nnz, int on_chip, int spill_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  int* ring = reinterpret_cast<int*>(smem_raw);
  T* cells = reinterpret_cast<T*>(smem_raw + factor_ring_bytes());
  const int nparts = sched[kParts];
  const int sys = blockIdx.x / nparts, part = blockIdx.x - sys * nparts;
  const int* pt = sched + sched[kTable] + part * kFields;
  const int nch = pt[0];
  const int* chunks = sched + pt[1];
  const T* src = data + static_cast<size_t>(sys) * nnz;
  T* dst = out + static_cast<size_t>(sys) * nnz;
  T* sp = kSpill ? spill + (static_cast<size_t>(sys) * nparts + part) *
                               spill_stride
                 : nullptr;
  auto at = [=](int c) -> T* {
    if constexpr (kSpill) {
      return c < on_chip ? cells + c : sp + (c - on_chip);
    } else {
      return cells + c;
    }
  };
  const bool copier = threadIdx.x >= 32;
  const int lane = threadIdx.x & 31;
  // the copy warp: chunk j's program words and its first-touched slots
  auto fetch = [&](int j) {
    if (copier && j < nch) {
      const int* ch = chunks + j * kFields;
      copy_words(ring + (j % kRingStages) * kStageWords, sched + ch[0],
                 ch[1], lane, 32);
      const int* g = sched + ch[3];
      for (int i = lane; i < ch[4]; i += 32) {
        const int c = g[2 * i], s = g[2 * i + 1];
        if (!kSpill || c < on_chip)
          mpp::cp_async<sizeof(T)>(cells + c, src + s);
        else
          sp[c - on_chip] = src[s];
      }
    }
    mpp::cp_async_commit();
  };
  // the copy warp: the slots chunk j touched last, out of their cells
  auto write_back = [&](int j) {
    if (copier && j >= 0) {
      const int* wb = sched + chunks[j * kFields + 5];
      for (int i = lane; i < chunks[j * kFields + 6]; i += 32)
        dst[wb[2 * i + 1]] = *at(wb[2 * i]);
      __syncwarp();   // read before any lane's next gather reuses a cell
    }
  };
  if (copier) {
    const int* u = sched + pt[2];
    for (int i = lane; i < pt[3]; i += 32) dst[u[i]] = src[u[i]];
  }
  for (int j = 0; j < kRingStages - 1; ++j) fetch(j);
  for (int j = 0; j < nch; ++j) {
    mpp::cp_async_wait<kRingStages - 2>();   // chunk j has landed
    __syncthreads();                         // ... and chunk j - 1 is done
    write_back(j - 1);
    fetch(j + kRingStages - 1);
    if (!copier) {
      const int* cur = ring + (j % kRingStages) * kStageWords;
      const int nsteps = chunks[j * kFields + 2];
      int nr = cur[0], wd = cur[1];
      for (int s = 0; s < nsteps; ++s) {
        const int size = factor_words(nr, wd);
        const int nr2 = s + 1 < nsteps ? cur[size] : 0;
        const int wd2 = s + 1 < nsteps ? cur[size + 1] : 0;
        factor_step<T>(cur, nr, wd, at, true, lane, kWarp);
        cur += size;
        nr = nr2;
        wd = wd2;
      }
    }
  }
  __syncthreads();
  write_back(nch - 1);
}

// part: [rows, n_p, chunks, chunk table, forward levels]; chunk: [words
// offset, words, levels, gathers, their count]; a gather is a slot whose
// value lands at stage value 2 + its index (value 0: the pads' zero; 1: a
// one, the divisor of a wide back row's pieces but its last)
template <typename T, bool kSpill>
__global__ void __launch_bounds__(kStreamThreads)
ilu0_apply_streamed(const T* __restrict__ fac, const T* __restrict__ b,
                    T* __restrict__ x, const int* __restrict__ sched,
                    T* __restrict__ spill, int n, int nnz, int on_chip,
                    int spill_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ys = reinterpret_cast<T*>(smem_raw + apply_ring_bytes());
  const int nparts = sched[kParts];
  const int sys = blockIdx.x / nparts, part = blockIdx.x - sys * nparts;
  const int* pt = sched + sched[kTable] + part * kFields;
  const int* rows = sched + pt[0];
  const int n_p = pt[1], nch = pt[2], nf = pt[4];
  const int* chunks = sched + pt[3];
  const T* fs = fac + static_cast<size_t>(sys) * nnz;
  const T* bs = b + static_cast<size_t>(sys) * n;
  T* sp = kSpill ? spill + (static_cast<size_t>(sys) * nparts + part) *
                               spill_stride
                 : nullptr;
  auto ya = [=](int c) -> T* {
    if constexpr (kSpill) {
      return c < on_chip ? ys + c : sp + (c - on_chip);
    } else {
      return ys + c;
    }
  };
  auto words = [&](int j) {
    return reinterpret_cast<int*>(smem_raw +
                                  (j % kRingStages) * apply_stage_bytes());
  };
  auto values = [&](int j) {
    return reinterpret_cast<T*>(smem_raw +
                                (j % kRingStages) * apply_stage_bytes() +
                                sizeof(int) * kStageWords);
  };
  const bool copier = threadIdx.x >= 32;
  const int lane = threadIdx.x & 31;
  // the copy warp: chunk j's program words and the f values it reads
  auto fetch = [&](int j) {
    if (copier && j < nch) {
      const int* ch = chunks + j * kFields;
      copy_words(words(j), sched + ch[0], ch[1], lane, 32);
      T* v = values(j);
      const int* g = sched + ch[3];
      for (int i = lane; i < ch[4]; i += 32)
        mpp::cp_async<sizeof(T)>(v + 2 + i, fs + g[i]);
      if (lane == 0) {
        v[0] = T(0);
        v[1] = T(1);
      }
    }
    mpp::cp_async_commit();
  };
  // y = b on the part's rows, and the pad row's zero
  if (copier)
    for (int i = lane; i <= n_p; i += 32) {
      if (i == n_p)
        *ya(i) = T(0);
      else if (!kSpill || i < on_chip)
        mpp::cp_async<sizeof(T)>(ys + i, bs + rows[i]);
      else
        *ya(i) = bs[rows[i]];
    }
  for (int j = 0; j < kRingStages - 1; ++j) fetch(j);
  int level = 0;
  for (int j = 0; j < nch; ++j) {
    mpp::cp_async_wait<kRingStages - 2>();   // chunk j (and y) landed
    __syncthreads();                         // ... and chunk j - 1 is done
    fetch(j + kRingStages - 1);
    if (!copier) {
      const int* cur = words(j);
      const T* fv = values(j);
      const int nlev = chunks[j * kFields + 2];
      int nr = cur[0], wd = cur[1];
      for (int l = 0; l < nlev; ++l, ++level) {
        const int size = level_words(nr, wd, level >= nf);
        const int nr2 = l + 1 < nlev ? cur[size] : 0;
        const int wd2 = l + 1 < nlev ? cur[size + 1] : 0;
        apply_level<T>(cur, nr, wd, fv, ya, level >= nf, true, lane, kWarp);
        cur += size;
        nr = nr2;
        wd = wd2;
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_p; i += kStreamThreads)
    x[static_cast<size_t>(sys) * n + rows[i]] = *ya(i);
}

template <typename T>
int launch_factor(const void* data, void* f, const void* sched,
                  void* scratch, int B, int nnz, int nparts, int streamed,
                  int k, int G, int threads, int smem, int on_chip,
                  int spill, void* stream) {
  static std::atomic<bool> staged_set[mpp::kMaxDevices];
  static std::atomic<bool> streamed_set[mpp::kMaxDevices];
  cudaError_t e = mpp::allow_smem(staged_set, ilu0_factor_staged<T>,
                                  ilu0_factor_staged<T>);
  if (e == cudaSuccess)
    e = mpp::allow_smem(streamed_set, ilu0_factor_streamed<T, true>,
                        ilu0_factor_streamed<T, false>);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  auto d = static_cast<const T*>(data);
  auto o = static_cast<T*>(f);
  auto sc = static_cast<const int*>(sched);
  if (!streamed) {
    const int blocks = (B + k - 1) / k * nparts;
    ilu0_factor_staged<T><<<blocks, threads, smem, s>>>(d, o, sc, B, nnz, k,
                                                        G);
  } else if (spill > 0) {
    ilu0_factor_streamed<T, true><<<B * nparts, kStreamThreads, smem, s>>>(
        d, o, sc, static_cast<T*>(scratch), nnz, on_chip, spill);
  } else {
    ilu0_factor_streamed<T, false><<<B * nparts, kStreamThreads, smem, s>>>(
        d, o, sc, nullptr, nnz, on_chip, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_apply(const void* f, const void* b, void* x, const void* sched,
                 void* scratch, int B, int n, int nnz, int nparts,
                 int streamed, int k, int G, int threads, int smem,
                 int on_chip, int spill, void* stream) {
  static std::atomic<bool> staged_set[mpp::kMaxDevices];
  static std::atomic<bool> streamed_set[mpp::kMaxDevices];
  cudaError_t e = mpp::allow_smem(staged_set, ilu0_apply_staged<T>,
                                  ilu0_apply_staged<T>);
  if (e == cudaSuccess)
    e = mpp::allow_smem(streamed_set, ilu0_apply_streamed<T, true>,
                        ilu0_apply_streamed<T, false>);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto s = static_cast<cudaStream_t>(stream);
  auto fp = static_cast<const T*>(f);
  auto bp = static_cast<const T*>(b);
  auto xp = static_cast<T*>(x);
  auto sc = static_cast<const int*>(sched);
  if (!streamed) {
    const int blocks = (B + k - 1) / k * nparts;
    ilu0_apply_staged<T><<<blocks, threads, smem, s>>>(fp, bp, xp, sc, B, n,
                                                       nnz, k, G);
  } else if (spill > 0) {
    ilu0_apply_streamed<T, true><<<B * nparts, kStreamThreads, smem, s>>>(
        fp, bp, xp, sc, static_cast<T*>(scratch), n, nnz, on_chip, spill);
  } else {
    ilu0_apply_streamed<T, false><<<B * nparts, kStreamThreads, smem, s>>>(
        fp, bp, xp, sc, nullptr, n, nnz, on_chip, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The rule's limits (ops/ilu0_schedule.LIMITS, in this order) for
// elem_bytes-sized values (4 or 8): 0 the staged form's shared memory
// (bytes), 1 a ring stage's program words, 2 a ring stage's f values (the
// apply; values 0 and 1 are a zero and a one), 3 the ring's stages, 4 the
// streamed
// factor's cells on chip, 5 the streamed apply's rows of y on chip.
int mpp_ilu0_limit(int which, int elem_bytes) {
  const bool f64 = elem_bytes == 8;
  switch (which) {
    case 0: return mpp::kOnChipBytes;
    case 1: return kStageWords;
    case 2: return f64 ? stage_values<double>() : stage_values<float>();
    case 3: return kRingStages;
    case 4: return f64 ? factor_cells<double>() : factor_cells<float>();
    case 5: return f64 ? apply_rows<double>() : apply_rows<float>();
    default: return -1;
  }
}

int mpp_ilu0_factor_f32(const void* data, void* f, const void* sched,
                        void* scratch, int B, int n, int nnz, int nparts,
                        int streamed, int k, int G, int threads, int smem,
                        int on_chip, int spill, void* stream) {
  (void)n;
  return launch_factor<float>(data, f, sched, scratch, B, nnz, nparts,
                              streamed, k, G, threads, smem, on_chip, spill,
                              stream);
}

int mpp_ilu0_factor_f64(const void* data, void* f, const void* sched,
                        void* scratch, int B, int n, int nnz, int nparts,
                        int streamed, int k, int G, int threads, int smem,
                        int on_chip, int spill, void* stream) {
  (void)n;
  return launch_factor<double>(data, f, sched, scratch, B, nnz, nparts,
                               streamed, k, G, threads, smem, on_chip, spill,
                               stream);
}

int mpp_ilu0_apply_f32(const void* f, const void* b, void* x,
                       const void* sched, void* scratch, int B, int n,
                       int nnz, int nparts, int streamed, int k, int G,
                       int threads, int smem, int on_chip, int spill,
                       void* stream) {
  return launch_apply<float>(f, b, x, sched, scratch, B, n, nnz, nparts,
                             streamed, k, G, threads, smem, on_chip, spill,
                             stream);
}

int mpp_ilu0_apply_f64(const void* f, const void* b, void* x,
                       const void* sched, void* scratch, int B, int n,
                       int nnz, int nparts, int streamed, int k, int G,
                       int threads, int smem, int on_chip, int spill,
                       void* stream) {
  return launch_apply<double>(f, b, x, sched, scratch, B, n, nnz, nparts,
                              streamed, k, G, threads, smem, on_chip, spill,
                              stream);
}

}  // extern "C"

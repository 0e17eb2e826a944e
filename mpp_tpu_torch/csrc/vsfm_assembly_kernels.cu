// The column Newton's assembly: the residual F and the tridiagonal Jacobian
// bands (dl, d, du) of a batch of VSFM soil columns in one pass.
//
// Replaces no Pallas kernel.  The JAX package evaluates the residual and
// the Jacobian values of a column as XLA-fused code under `jit`
// (mpp_tpu/models/richards.py:674-837, RichardsGE.residual,
// residual_and_jac_values, jacobian_values, scattered into bands by
// mpp_tpu/batched/vsfm_compiled.py's tridiagonal plan).  The port ran the
// same arithmetic as some 600-700 eager PyTorch operations an evaluation
// (models/richards.py: RichardsGE._eval, batched/vsfm_compiled.py:
// _tri_assemble), each a launch over [ncol, nz] tensors: ~9 ms of host
// time and ~3-4 ms of device time an evaluation at 131072 x 15 in f64.
// Here one launch does the evaluation, in one of three modes, each its own
// instantiation so that a launch's name says what it computed: AsmResidual
// (F), AsmBands (dl, d, du) or AsmBoth (all four).
//
// What bounds it: bytes.  A cell reads about 16 values (the state, seven
// saturation parameters, porosity, permeability, volume, temperature, the
// previous accumulation, the source; its faces' two distances and area)
// and writes one to four; its constitutive chain (two pow, a handful of
// divides) is a few hundred floating-point operations, ~3x under the
// card's f64 rate at those bytes.  So the design reads every input once,
// coalesced, keeps every intermediate on chip, and keeps enough loads in
// flight to cover the chain's long dependent arithmetic:
//
// * A CTA of 256 threads owns a tile of `cols` = 256 / nz consecutive
//   columns.  A [ncol, m] row-major array's tile is one contiguous run, so
//   thread t loading element t of the run makes each warp's load one
//   coalesced request.  The tile's rows of the face, boundary and sink
//   inputs go to shared memory by cp.async at the start; the cell's own
//   inputs go straight to registers, all loads issued before the chain.
//   Four CTAs an SM (__launch_bounds__: 64 registers a thread, a few
//   bytes spilled in f64), so one CTA's loads overlap another's
//   arithmetic: at [131072, 15] f64 on an H100 80GB HBM3, four read
//   0.247 ms a "both" launch where three (80 registers) read 0.276 and
//   two (122) 0.343.
// * Phase 1, a thread a cell: saturation, relative permeability and their
//   derivatives (smoothed Brooks-Corey), the TGDPB01 (or constant) density
//   and d/dP, porosity (linear or constant) and d/dP; viscosity is the
//   constant 8.904156e-4 Pa s with zero derivative.  What a face needs of
//   its two cells (P, kr, dkr, den, dden, perm) goes to shared memory.
// * Phase 2, a thread a face: each internal face's two-point Darcy flux and
//   its two derivatives, once a face, from its cells' values in shared
//   memory; each boundary face (Dirichlet, seepage with its clamp, mass
//   flux) with its BC-side auxvars at the BC pressure, on the threads the
//   internal faces leave free.
// * Phase 3, the cell's thread again: the sum over its two faces in a fixed
//   order, then its boundary faces, then its sinks (plain or down-regulated
//   mass rates), in connection order; no atomics, no scatter.  Each output
//   is written once.
//
// The arithmetic is in the state's type and follows RichardsGE._eval's
// formulas term by term.  Inputs are (pointer, column stride, element
// stride) triples, so per-column arrays, one array shared by every column
// (column stride 0) and strided views (the z permeability of [ncol, nz, 3])
// are read in place.
#include <cuda_runtime.h>

#include "column_tiles.cuh"

namespace mpp {

// argument slots, in the order of models/richards_column.py's ARGS
enum ColumnSlot : int {
  kP, kDt,
  kSatRes, kAlpha, kLambda, kPu, kPs, kB2, kB3,
  kPorBase, kPorRef, kPorSlope, kPerm, kVol, kTemp,
  kInDistUp, kInDistDn, kInArea, kInUz,
  kBcValue, kBcDistUp, kBcDistDn, kBcArea, kBcUz,
  kBcSatRes, kBcAlpha, kBcLambda, kBcPu, kBcPs, kBcB2, kBcB3, kBcTemp,
  kSsValue, kSsPc, kSsNn,
  kAccumPrev, kSrc,
  kColumnSlots
};

// an input: element (c, j) is p[c * cs + j * es]; p null where absent
struct ColumnArray {
  const void* p;
  long long cs;
  long long es;
};

// a launch's arguments (hopper_kernels._ColumnArgs).  `table` (int32):
// bc_ptr[n + 1], bc_list[nbc], bc_kind[nbc], bc_cell[nbc], ss_ptr[n + 1],
// ss_list[nss], ss_kind[nss]: each cell's boundary connections and sinks
// in connection order (CSR), a boundary connection's kind bits (1 takes
// the condition value, 2 seepage clamp, 4 mass flux: no Darcy flux) and
// level, a sink's kind (0 mass rate, 1 Campbell, 2 FETCH2 down-regulation)
struct ColumnAssembleArgs {
  ColumnArray a[kColumnSlots];
  void* F;
  void* dl;
  void* d;
  void* du;
  const int* table;
  int ncol, n, nbc, nss;
  int density;    // 0 constant, 1 TGDPB01
  int porosity;   // 0 constant, 1 linear
};

// the three modes: each its own instantiation, named in the device trace
struct AsmResidual {
  static constexpr bool kF = true, kJ = false;
};
struct AsmBands {
  static constexpr bool kF = false, kJ = true;
};
struct AsmBoth {
  static constexpr bool kF = true, kJ = true;
};

namespace {

// constants.py, eos.py
constexpr double kPressureRef = 101325.0;
constexpr double kGravity = 9.80665;
constexpr double kFmwh2o = 18.01534;
constexpr double kDenh2o = 1.000e3;
constexpr double kVis = 8.904156e-4;

constexpr int kThreads = 256;          // a CTA's threads
constexpr int kMaxLevels = kThreads;   // the deepest column taken
constexpr int kSmemBytes = 48 * 1024;  // a launch's shared memory, at most

template <typename T>
__device__ __forceinline__ T ld(ColumnArray a, long long c, int j) {
  return __ldg(static_cast<const T*>(a.p) + (c * a.cs + j * a.es));
}

// a boundary connection's auxvar parameter: its own (`own`, connection b)
// where given, else the adjacent cell's (`cell`, level jb)
template <typename T>
__device__ __forceinline__ T side(ColumnArray own, ColumnArray cell,
                                  long long c, int b, int jb) {
  return own.p ? ld<T>(own, c, b) : ld<T>(cell, c, jb);
}

template <typename T>
struct Soil {
  T sr, alpha, lam, pu, ps, b2, b3;
};

// smoothed Brooks-Corey saturation and Mualem relative permeability with
// their pressure derivatives (ops/satfunc.py: _sbc_se, pc_to_sat_sbc,
// pc_to_relperm_sbc)
template <typename T, bool kDeriv>
__device__ __forceinline__ void sbc(T P, const Soil<T>& s, T& sat, T& dsat,
                                    T& kr, T& dkr) {
  const T pc = P - T(kPressureRef);
  const bool in_bc = pc <= s.pu;
  const bool in_cubic = !in_bc && pc < s.ps;
  const bool unsat = in_bc || in_cubic;
  const T pcs = in_bc ? pc : T(-2.0) / s.alpha;
  const T se_bc = pow(-s.alpha * pcs, -s.lam);
  const T d = pc - s.ps;
  const T se_cu = T(1) + d * d * (s.b2 + d * s.b3);
  const T se = in_bc ? se_bc : (in_cubic ? se_cu : T(1));
  sat = unsat ? s.sr + (T(1) - s.sr) * se : T(1);
  const T ses = unsat ? se : T(1);
  const T ex = T(2.5) + T(2) / s.lam;
  const T k = pow(ses, ex);
  kr = unsat ? k : T(1);
  if (kDeriv) {
    const T dse_bc = -s.lam * se_bc / pcs;
    const T dse_cu = d * (T(2) * s.b2 + T(3) * d * s.b3);
    const T dse = in_bc ? dse_bc : (in_cubic ? dse_cu : T(0));
    dsat = unsat ? (T(1) - s.sr) * dse : T(0);
    dkr = unsat ? ex * k / ses * dse : T(0);
  }
}

// water density [kmol m^-3] and d/dP (ops/eos.py: density_tgdpb01,
// density_constant)
template <typename T>
__device__ __forceinline__ void density(int model, T P, T temp, T& den,
                                        T& dden) {
  if (!model) {
    den = T(kDenh2o / kFmwh2o);
    dden = T(0);
    return;
  }
  const T a1 = T(-3.983035), a2 = T(301.797), a3 = T(522528.9),
          a4 = T(69.34881), a5 = T(999.974950);
  const T k0 = T(50.74e-11), k1 = T(-0.326e-11), k2 = T(0.00416e-11),
          p0 = T(101325.0);
  const T tc = temp - T(273.15);
  const T s1 = tc + a1;
  const T dent = a5 * (T(1) - s1 * s1 * (tc + a2) / a3 / (tc + a4));
  const bool above = P > p0;
  const T kc = k0 + k1 * tc + k2 * (tc * tc);
  const T kappa = above ? T(1) + kc * (P - p0) : T(1);
  den = dent * kappa / T(kFmwh2o);
  dden = dent * (above ? kc : T(0)) / T(kFmwh2o);
}

template <typename T>
struct Flux {
  T f, dup, ddn;
};

// two-point Darcy flux with upwinded mobility and its derivatives in
// P_up and P_dn (models/richards.py: darcy_flux); `upweight` and `dq`
// are the internal face's distance weight and harmonic conductance, or
// the boundary face's 0 and perm / dist
template <typename T, bool kJ>
__device__ __forceinline__ Flux<T> darcy(T p_up, T p_dn, T kr_up, T kr_dn,
                                         T dkr_up, T dkr_dn, T den_up,
                                         T den_dn, T dden_up, T dden_dn,
                                         T upweight, T dq, T dist, T area,
                                         T uz, bool seepage, bool no_flux) {
  const T vis = T(kVis), dvis = T(0);
  const T dist_gravity = dist * (uz * T(-kGravity));
  const T den_ave = upweight * den_up + (T(1) - upweight) * den_dn;
  const T gravityterm = den_ave * T(kFmwh2o) * dist_gravity;
  T dphi = p_up - p_dn + gravityterm;
  const bool clamp = seepage && dphi > T(0) && p_up <= T(kPressureRef);
  if (clamp) dphi = T(0);
  const bool up_wind = dphi >= T(0);
  const T ukvr = up_wind ? kr_up / vis : kr_dn / vis;
  const T v = no_flux ? T(0) : -dq * ukvr * dphi;
  const T q = v * area;
  Flux<T> out;
  out.f = q * den_ave;
  if (kJ) {
    const T dden_ave_up = upweight * dden_up;
    const T dden_ave_dn = (T(1) - upweight) * dden_dn;
    const T dphi_up = T(1) + upweight * dist_gravity * T(kFmwh2o) * dden_up;
    T dphi_dn =
        T(-1) + (T(1) - upweight) * dist_gravity * T(kFmwh2o) * dden_dn;
    if (clamp) dphi_dn = T(0);
    const T dukvr_up =
        up_wind ? dkr_up / vis - kr_up / (vis * vis) * dvis : T(0);
    const T dukvr_dn =
        up_wind ? T(0) : dkr_dn / vis - kr_dn / (vis * vis) * dvis;
    const T dq_up = -dq * (dukvr_up * dphi + ukvr * dphi_up) * area;
    const T dq_dn = -dq * (dukvr_dn * dphi + ukvr * dphi_dn) * area;
    out.dup = no_flux ? T(0) : dq_up * den_ave + q * dden_ave_up;
    out.ddn = no_flux ? T(0) : dq_dn * den_ave + q * dden_ave_dn;
  }
  return out;
}

}  // namespace

// the CTA's shared arrays, each `cols` columns of the tile wide: what a
// face needs of its cells (P, kr, den, perm; dkr, dden), the faces' fluxes
// and derivatives, the boundary connections' flux and d/dP_cell, and the
// tile's rows of the per-column boundary and sink inputs, staged by
// cp.async while the cells compute
template <typename T>
struct ColumnSmem {
  T *P, *kr, *den, *perm, *dkr, *dden;
  T *flux, *dfu, *dfd;
  T *fdup, *fddn, *farea;
  T *bflux, *bdfd;
  T *bc_value, *bc_dup, *bc_ddn, *bc_area, *ss_value;

  __device__ ColumnSmem(T* s, int cells, int faces, int cols, int nbc,
                        int nss) {
    P = s;
    kr = P + cells;
    den = kr + cells;
    perm = den + cells;
    dkr = perm + cells;
    dden = dkr + cells;
    flux = dden + cells;
    dfu = flux + faces;
    dfd = dfu + faces;
    fdup = dfd + faces;
    fddn = fdup + faces;
    farea = fddn + faces;
    bflux = farea + faces;
    bdfd = bflux + cols * nbc;
    bc_value = bdfd + cols * nbc;
    bc_dup = bc_value + cols * nbc;
    bc_ddn = bc_dup + cols * nbc;
    bc_area = bc_ddn + cols * nbc;
    ss_value = bc_area + cols * nbc;
  }
};

// values of the shared arrays at n levels (ColumnSmem, in T's)
__host__ __device__ inline long long column_smem_values(int n, int nbc,
                                                        int nss) {
  const int cols = kThreads / n;
  return 6LL * cols * n + 6LL * cols * (n - 1) + 6LL * cols * nbc +
         static_cast<long long>(cols) * nss;
}

namespace {

// issued by every thread of the CTA: cp.async of the tile's rows (m values
// of each of its columns) of a per-column input into shared rows of m
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, ColumnArray a,
                                           long long c0, int ncols, int m) {
  if (!a.p) return;
  for (int i = threadIdx.x; i < ncols * m; i += blockDim.x) {
    const int cl = i / m, k = i - cl * m;
    cp_async<sizeof(T)>(dst + i, static_cast<const T*>(a.p) +
                                     ((c0 + cl) * a.cs + k * a.es));
  }
}

}  // namespace

template <typename T, typename Mode>
__global__ void __launch_bounds__(kThreads, 4)
    column_assemble_kernel(const ColumnAssembleArgs args) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  const int n = args.n, nf = n - 1, nbc = args.nbc, nss = args.nss;
  const int cols = kThreads / n;
  const int cells = cols * n, faces = cols * nf;
  const ColumnSmem<T> sm(reinterpret_cast<T*>(smem_bytes), cells, faces,
                         cols, nbc, nss);
  const int* const bc_ptr = args.table;
  const int* const bc_list = bc_ptr + n + 1;
  const int* const bc_kind = bc_list + nbc;
  const int* const bc_cell = bc_kind + nbc;
  const int* const ss_ptr = bc_cell + nbc;
  const int* const ss_list = ss_ptr + n + 1;
  const int* const ss_kind = ss_list + nss;

  const int t = threadIdx.x;
  const long long c0 = static_cast<long long>(blockIdx.x) * cols;
  const int tile_cols = static_cast<int>(
      min(static_cast<long long>(cols), args.ncol - c0));
  const int cl = t / n, j = t - cl * n;
  const long long c = c0 + cl;
  const bool has_cell = cl < tile_cols;

  // ---- phase 1: every load, then the cell's constitutive chain ----------
  // the tile's face, boundary and sink rows go to shared memory
  // asynchronously
  if (nf) {
    stage_rows(sm.fdup, args.a[kInDistUp], c0, tile_cols, nf);
    stage_rows(sm.fddn, args.a[kInDistDn], c0, tile_cols, nf);
    stage_rows(sm.farea, args.a[kInArea], c0, tile_cols, nf);
  }
  if (nbc) {
    stage_rows(sm.bc_value, args.a[kBcValue], c0, tile_cols, nbc);
    stage_rows(sm.bc_dup, args.a[kBcDistUp], c0, tile_cols, nbc);
    stage_rows(sm.bc_ddn, args.a[kBcDistDn], c0, tile_cols, nbc);
    stage_rows(sm.bc_area, args.a[kBcArea], c0, tile_cols, nbc);
  }
  if (nss) stage_rows(sm.ss_value, args.a[kSsValue], c0, tile_cols, nss);
  cp_async_commit();

  T fa = T(0), ja = T(0), src = T(0);
  if (has_cell) {
    const T P = ld<T>(args.a[kP], c, j);
    Soil<T> soil;
    soil.sr = ld<T>(args.a[kSatRes], c, j);
    soil.alpha = ld<T>(args.a[kAlpha], c, j);
    soil.lam = ld<T>(args.a[kLambda], c, j);
    soil.pu = ld<T>(args.a[kPu], c, j);
    soil.ps = ld<T>(args.a[kPs], c, j);
    soil.b2 = ld<T>(args.a[kB2], c, j);
    soil.b3 = ld<T>(args.a[kB3], c, j);
    const T base = ld<T>(args.a[kPorBase], c, j);
    const T perm = ld<T>(args.a[kPerm], c, j);
    const T vol = ld<T>(args.a[kVol], c, j);
    const T dt = ld<T>(args.a[kDt], c, 0);
    T pref = T(0), slope = T(0), temp = T(0), ap = T(0);
    if (args.porosity) {
      pref = ld<T>(args.a[kPorRef], c, j);
      slope = ld<T>(args.a[kPorSlope], c, j);
    }
    if (args.density) temp = ld<T>(args.a[kTemp], c, j);
    if (Mode::kF) {
      ap = ld<T>(args.a[kAccumPrev], c, j);
      src = ld<T>(args.a[kSrc], c, j);
    }

    T sat, dsat = T(0), kr, dkr = T(0), den, dden;
    sbc<T, Mode::kJ>(P, soil, sat, dsat, kr, dkr);
    density(args.density, P, temp, den, dden);
    // porosity (ops/porosity.py): linear or constant
    const T por = args.porosity ? base + (P - pref) * slope
                                : base + T(0) * P;
    const T dpor = args.porosity ? T(0) + slope : T(0);
    if (Mode::kF) fa = por * den * sat * vol / dt - ap;
    if (Mode::kJ)
      ja = (dpor * den * sat + por * dden * sat + por * den * dsat) * vol / dt;
    sm.P[t] = P;
    sm.kr[t] = kr;
    sm.den[t] = den;
    sm.perm[t] = perm;
    if (Mode::kJ) {
      sm.dkr[t] = dkr;
      sm.dden[t] = dden;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // ---- phase 2: each internal face once, then each boundary face once ---
  const int tile_faces = tile_cols * nf;
  for (int i = t; i < tile_faces + tile_cols * nbc; i += kThreads) {
    if (i < tile_faces) {
      const int fl = i / nf, k = i - fl * nf;
      const T fdup = sm.fdup[i], fddn = sm.fddn[i], farea = sm.farea[i];
      const T fuz = ld<T>(args.a[kInUz], c0 + fl, k);
      const int up = fl * n + k, dn = up + 1;
      const T dist = fdup + fddn;
      const T upweight = fdup / dist;
      const T pu = sm.perm[up], pd = sm.perm[dn];
      const T dq = pu * pd / (fdup * pd + fddn * pu);
      const Flux<T> f = darcy<T, Mode::kJ>(
          sm.P[up], sm.P[dn], sm.kr[up], sm.kr[dn],
          Mode::kJ ? sm.dkr[up] : T(0), Mode::kJ ? sm.dkr[dn] : T(0),
          sm.den[up], sm.den[dn], Mode::kJ ? sm.dden[up] : T(0),
          Mode::kJ ? sm.dden[dn] : T(0), upweight, dq, dist, farea, fuz,
          false, false);
      sm.flux[i] = f.f;
      if (Mode::kJ) {
        sm.dfu[i] = f.dup;
        sm.dfd[i] = f.ddn;
      }
    } else {
      // a boundary face: the BC auxvars at the BC pressure, with their own
      // parameters where given, else the adjacent cell's
      const int q = i - tile_faces;
      const int bl = q / nbc, b = q - bl * nbc;
      const long long cb = c0 + bl;
      const int kind = __ldg(bc_kind + b), jb = __ldg(bc_cell + b);
      const int ic = bl * n + jb;
      const T Pc = sm.P[ic];
      const T pb = (kind & 1) ? sm.bc_value[q] : Pc;
      Soil<T> sb;
      sb.sr = side<T>(args.a[kBcSatRes], args.a[kSatRes], cb, b, jb);
      sb.alpha = side<T>(args.a[kBcAlpha], args.a[kAlpha], cb, b, jb);
      sb.lam = side<T>(args.a[kBcLambda], args.a[kLambda], cb, b, jb);
      sb.pu = side<T>(args.a[kBcPu], args.a[kPu], cb, b, jb);
      sb.ps = side<T>(args.a[kBcPs], args.a[kPs], cb, b, jb);
      sb.b2 = side<T>(args.a[kBcB2], args.a[kB2], cb, b, jb);
      sb.b3 = side<T>(args.a[kBcB3], args.a[kB3], cb, b, jb);
      const T tb = args.density
          ? side<T>(args.a[kBcTemp], args.a[kTemp], cb, b, jb) : T(0);
      T satb, dsatb, krb, dkrb, denb, ddenb;
      sbc<T, false>(pb, sb, satb, dsatb, krb, dkrb);
      density(args.density, pb, tb, denb, ddenb);
      const T dist = sm.bc_dup[q] + sm.bc_ddn[q];
      const Flux<T> f = darcy<T, Mode::kJ>(
          pb, Pc, krb, sm.kr[ic], T(0), Mode::kJ ? sm.dkr[ic] : T(0), denb,
          sm.den[ic], T(0), Mode::kJ ? sm.dden[ic] : T(0), T(0),
          sm.perm[ic] / dist, dist, sm.bc_area[q],
          ld<T>(args.a[kBcUz], cb, b), (kind & 2) != 0, (kind & 4) != 0);
      sm.bflux[q] = f.f;
      if (Mode::kJ) sm.bdfd[q] = f.ddn;
    }
  }
  __syncthreads();
  if (!has_cell) return;

  // ---- phase 3: the cell's sums, in _eval's order -----------------------
  // F: the accumulation, the face the cell is the upper side of (-flux),
  // the face below it (+flux), its boundary faces, its sinks, the source.
  // d: -dflux_up of the face above, dflux_dn of the face below, its
  // boundary faces, its sinks, the accumulation's derivative.
  const int fa_up = cl * nf + j, fa_dn = cl * nf + j - 1;
  T F = fa, d = T(0), dl = T(0), du = T(0);
  if (j < nf) {
    if (Mode::kF) F = F + -sm.flux[fa_up];
    if (Mode::kJ) {
      d = d + -sm.dfu[fa_up];
      du = T(0) + -sm.dfd[fa_up];
    }
  }
  if (j > 0) {
    if (Mode::kF) F = F + sm.flux[fa_dn];
    if (Mode::kJ) {
      d = d + sm.dfd[fa_dn];
      dl = T(0) + sm.dfu[fa_dn];
    }
  }
  for (int i = __ldg(bc_ptr + j), e = __ldg(bc_ptr + j + 1); i < e; ++i) {
    const int q = cl * nbc + __ldg(bc_list + i);
    if (Mode::kF) F = F + sm.bflux[q];
    if (Mode::kJ) d = d + sm.bdfd[q];
  }
  if (nss) {
    const T P = sm.P[t];
    for (int i = __ldg(ss_ptr + j), e = __ldg(ss_ptr + j + 1); i < e; ++i) {
      const int s = __ldg(ss_list + i), kind = __ldg(ss_kind + s);
      if (!Mode::kF && kind == 0) continue;   // a mass rate: d/dP = 0
      const T val = sm.ss_value[cl * nss + s] / T(kFmwh2o);
      T contrib = val, dv = T(0);
      if (kind) {
        // down-regulated mass rates (models/richards.py: _ss_factors)
        const T dP = P - T(kPressureRef);
        const bool neg = dP <= T(0);
        const T dps = neg ? dP : T(-1);
        const T nn = ld<T>(args.a[kSsNn], c, s);
        const T pw = pow(dps / ld<T>(args.a[kSsPc], c, s), nn);
        if (kind == 1) {
          contrib = val / (neg ? T(1) + pw : T(1));
          const T fc = T(1) + pw;
          dv = neg ? val * (nn * pw) / (dps * (fc * fc)) : T(0);
        } else {
          const T ff = exp(-pw);
          contrib = val * (neg ? ff : T(1));
          dv = neg ? val * (nn * pw) * ff / dps : T(0);
        }
      }
      if (Mode::kF) F = F + -contrib;
      if (Mode::kJ) d = d + dv;
    }
  }
  const long long o = c * n + j;
  if (Mode::kF) static_cast<T*>(args.F)[o] = F - src;
  if (Mode::kJ) {
    static_cast<T*>(args.dl)[o] = dl;
    static_cast<T*>(args.d)[o] = d + ja;
    static_cast<T*>(args.du)[o] = du;
  }
}

namespace {

template <typename T>
int launch_column_assemble(const ColumnAssembleArgs* args, int mode,
                           void* stream) {
  const int n = args->n;
  if (n < 1 || n > kMaxLevels || args->ncol < 1 || mode < 1 || mode > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes =
      column_smem_values(n, args->nbc, args->nss) * sizeof(T);
  if (bytes > kSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int cols = kThreads / n;
  const int blocks = (args->ncol + cols - 1) / cols;
  const size_t smem = static_cast<size_t>(bytes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1)
    column_assemble_kernel<T, AsmResidual>
        <<<blocks, kThreads, smem, s>>>(*args);
  else if (mode == 2)
    column_assemble_kernel<T, AsmBands><<<blocks, kThreads, smem, s>>>(*args);
  else
    column_assemble_kernel<T, AsmBoth><<<blocks, kThreads, smem, s>>>(*args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace mpp

extern "C" {

// the deepest column the kernel takes
int mpp_vsfm_column_max_levels() { return mpp::kMaxLevels; }

// the shared memory [bytes] a launch needs at n levels, nbc boundary
// connections and nss sinks for elem_bytes-sized values; at most
// mpp_vsfm_column_max_smem() is taken
long long mpp_vsfm_column_smem(int n, int nbc, int nss, int elem_bytes) {
  return mpp::column_smem_values(n, nbc, nss) * elem_bytes;
}

int mpp_vsfm_column_max_smem() { return mpp::kSmemBytes; }

// mode 1: F; 2: the bands; 3: both
int mpp_vsfm_column_assemble_f32(const void* args, int mode, void* stream) {
  return mpp::launch_column_assemble<float>(
      static_cast<const mpp::ColumnAssembleArgs*>(args), mode, stream);
}

int mpp_vsfm_column_assemble_f64(const void* args, int mode, void* stream) {
  return mpp::launch_column_assemble<double>(
      static_cast<const mpp::ColumnAssembleArgs*>(args), mode, stream);
}

}  // extern "C"

#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mpp_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each fatal on failure (the exit code is non-zero and no result
line is printed):

  (a) require CUDA; print the card's name and power limit (nvidia-smi);
  (b) build the hand-written kernels (nvcc -> mpp_tpu_torch/_build/);
  (c) hold each kernel against its plain PyTorch version on the card at
      [16384, 30] and [16384, 64] (Thomas f64/f32, SpMV f64/f32, mixed
      bf16/f32 SpMV) and time both with CUDA events, the SpMV also as one
      torch.sparse.mm of a block-diagonal CSR (the library yardstick); and
      Thomas at the edge shapes of its tiling (THOMAS_EDGE_LEVELS levels
      x EDGE_NCOLS columns, f64 and f32, both forms of the kernel in each,
      and inputs that are not 16-byte aligned);
  (d) the ALM f64 default step at ncol=16384, nz=30 with heterogeneous
      CLM soils, seepage BC, infiltration + ET forcing (numpy seed 0): one
      warm step and 4 timed steps; every column converges, max audit error
      < 1e-5 kg, outputs finite;
  (e) the same in the f32 throughput mode (no f64 escalation, audit
      threshold 1e-3 kg);
  (f) a 64-column f64 ALM step on the card and on the CPU: equal attempts,
      Newton iterations and per-column reasons, P within rtol 1e-9;
  (g) the 2x2 block-Thomas kernel against its plain version at [8192, 64]
      and [1024, 100] and at the edge shapes of (c), f64 (tolerance 1e-12)
      and f32 (2e-5), relative to the output's max |x|, on block
      diagonally dominant random systems;
  (h) the coupled TH step (Richards mass + enthalpy energy) in f64 at
      ncol=8192 and 64 cells per column, dt=3600 s, per-column top
      temperature 296.15-310.15 K: one warm step and 8 timed steps; every
      column converges, outputs finite, the forcing reaches the state
      (|T[0] - T[-1]| > 1e-3 K), per-column water-mass change per step
      < 1e-6 kg;
  (i) the same in f32 with rtol=2e-3, stol=1e-5: every column converges in
      at most 10 Newton iterations per step, and after the timed steps the
      state is within 0.05 K and 20 Pa of (h)'s;
  (j) a 64-column f64 TH step on the card and on the CPU: equal Newton
      iterations and reasons, X within rtol 1e-9;
  (k) the matrix-resident chain y = (scale T)^30 x (scale = 1/||T||_inf)
      and 30 weighted-Jacobi sweeps (omega = 2/3) through the public ops,
      f64 and f32 at [16384, 30] and [16384, 64] and f32 at [131072, 256],
      each held against its plain version on the same inputs bit for bit
      and timed; both kernels bitwise at
      RESIDENT_EDGE_LEVELS levels x EDGE_NCOLS columns in f64 and f32
      (every form: registers, shared memory, streamed) and misaligned at
      RESIDENT_SKEWED; the f32 smoother bitwise where every quotient is a
      tie of the subnormal grid (SUBNORMAL_TIE_SHAPES); and 200 sweeps at
      omega = 0.9 against the Thomas kernel's solution at [16384, 64] f64,
      to 1e-8;
  (l) the SpMV harness (python -m mpp_tpu_torch.tools.exp_spmv) at its
      full size, [131072, 256] f32 with 100 chained applications: every
      variant checked against its plain form and timed, one "exp_spmv"
      JSON line; and a block-diagonal CSR of the same T through
      torch.sparse.mm (cuSPARSE) as the library yardstick;
  (m) the ALM f32 step with the per-column f64 escalation (the default
      precision policy) at ncol=16384, nz=48, dz=0.05 m, uniform soils,
      P0=1e3 Pa, infiltration 8e-3 mm/s on the first half of the columns,
      dt=3600 s (tests/test_alm.py:221 at full width): one warm step and 2
      timed steps; the warm step escalates columns, every column lands
      under 1e-5 kg, the state stays f32, and the escalation's f64 re-solve
      launches thomas and tridiag_spmv (the counters read around it);
  (n) the ring lateral: (d)'s f64 soils with lateral_connectivity,
      conductance 1e-10 kmol/s/Pa, the first half of the columns wet
      (9e4 Pa), no forcing: 2 steps; |sum qflx_lateral| < 1e-10 *
      sum |qflx_lateral|, total water mass conserved to rel 1e-6, audit
      < 1e-5 kg;
  (o) (d)'s step with linesearch_jac="fused" against "separate", one step
      each from the same state at [16384, 30] f64: equal reasons, states
      within atol 1e-7 Pa, both ms/step;
  (p) the thermal KSP (thermal_batched): the 64-cell 1-D MMS column through
      compile_ksp(linear_solver="direct") at [16384, 64] f32, T0 = 280 +
      10 rand K, per-column liq = 5 rand (numpy seed 0), dt=1800 s: one
      warm step and 20 timed steps; every column ok and finite, Thomas
      launched once a step, the Thomas kernel held against its plain
      version at that step's bands; and a 64-column f64 step on the card
      equal to the CPU's within rtol 1e-9.

Every kernel timing is read twice: ``ms``, CUDA events around back-to-back
calls of the wrapper (host cost per call included), and ``device_ms``, the
summed duration of the device activities that torch.profiler (CUPTI)
records for one call (host cost excluded); the library yardstick gets the
same two readings.  The device readings are queued and taken after (p),
so that no profiler window comes before a host-clock timing (the step
times and every ``ms``); the "profiler_after" line then times the f64 ALM
steps and the (c) kernels' eager calls again, after the windows, beside
their readings from before them.  One more step of (m) and 10 of (p) are
read the same way: their device time over the step's host-clock time is
the cell's device-busy share (the "step_device" lines).

The launch counters are reset just before (d) and read just after (e),
reset just before (h) and read just after (i), reset just before (k)'s
calls of the ops and read just after them, reset just before (l)'s
harness run and read just after it, and reset just before each of
(m)-(p) and read just after it: every kernel of each path must have
launched on it.  The line before the last is the card's name and power
limit, the one before it a JSON object with one entry per kernel (its
launches on its path, error against its plain version, kernel (eager and
device) and plain times, the least time the card could take for the same
work and the time of one library call computing the same function, where
there is one);
the last line is {"ok": true, "device": {...}}.
"""
import json
import os
import re
import sys
import time
from functools import partial

import numpy as np

NCOL, NZ = 16384, 30
DT = 1800.0
F64_AUDIT_KG = 1e-5
F32_AUDIT_KG = 1e-3
TH_NCOL, TH_NH = 8192, 64
TH_DT = 3600.0
TH_STEPS = 8
TH_F32_TOLS = dict(rtol=2e-3, stol=1e-5)
TH_MASS_KG = 1e-6
# (m): tests/test_alm.py:221's column at full width
ESC_NZ, ESC_DZ, ESC_P0, ESC_QINFL, ESC_DT, ESC_STEPS = 48, 0.05, 1e3, 8e-3, \
    3600.0, 2
# (n): the ring's conductance [kmol/s/Pa] and the wet half's pressure [Pa]
LAT_G, LAT_WET_P = 1e-10, 9.0e4
# (p): the thermal_batched cell
THERM_NCOL, THERM_NX, THERM_DT, THERM_STEPS = 16384, 64, 1800.0, 20
CHAIN_K = 30
JACOBI_CHECK = dict(iters=200, omega=0.9, shape=(16384, 64), tol=1e-8)
HARNESS_SHAPE = (131072, 256)
# edge shapes of the solve kernels' tiling: level counts around the chunk
# sizes and past the carries' room in shared memory (500), and column
# counts that are no multiple of a tile
EDGE_LEVELS = (1, 2, 7, 31, 33, 100, 257, 500)
# Thomas keeps its carries on chip to 829 levels in f32
THOMAS_EDGE_LEVELS = EDGE_LEVELS + (900,)
EDGE_NCOLS = (1000, 8193)
# the chain's and the smoother's edge levels: every register width (R = 1,
# 2, 16; with and without pads), the shared form (513, 2000) and the
# streamed one (16000, past every on-chip depth); misaligned at one of each
RESIDENT_EDGE_LEVELS = (1, 2, 31, 32, 33, 255, 256, 512, 513, 2000, 16000)
RESIDENT_SKEWED = (31, 2000, 16000)
# the smoother's f32 register widths (R = 1, 2, 4 with pads, 8, 16) at which
# every quotient is a tie of the subnormal grid
SUBNORMAL_TIE_SHAPES = ((8192, 1), (4096, 32), (2048, 64), (1024, 100),
                        (512, 256), (512, 512))
# the solves' tolerance against their plain versions, of max |x|
TOLS = {"thomas": {"float64": 1e-12, "float32": 1e-5},
        "block_thomas2": {"float64": 1e-12, "float32": 2e-5}}
# the H100 SXM's published peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s,
# and operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float64": 34e12, "float32": 67e12}
_TRIDIAG = "mpp_tpu_torch/csrc/tridiag_kernels.cu"
_FAMILY = "mpp_tpu_torch/csrc/spmv_family_kernels.cu"
# name in the kernels line: (source, file:line of the TPU kernel's
# pl.pallas_call), in the order of PERF.md's table
KERNELS = {
    "thomas": (_TRIDIAG, "mpp_tpu/ops/pallas_kernels.py:204"),
    "tridiag_spmv_mixed": (_TRIDIAG, "mpp_tpu/ops/pallas_kernels.py:105"),
    "tridiag_spmv": (_TRIDIAG, "mpp_tpu/ops/pallas_kernels.py:67"),
    "block_thomas2": ("mpp_tpu_torch/csrc/block_thomas_kernels.cu",
                      "mpp_tpu/ops/pallas_kernels.py:399"),
    "tridiag_spmv_chain": (_FAMILY, "mpp_tpu/ops/pallas_kernels.py:241"),
    "tridiag_jacobi_smooth": (_FAMILY, "mpp_tpu/ops/pallas_kernels.py:280"),
    "spmv_variant": (_FAMILY, "tools/exp_spmv.py:92"),
    "spmv_bf16_variant": (_TRIDIAG, "tools/exp_spmv.py:118"),
    "spmv_variant_cp": (_FAMILY, "tools/exp_spmv.py:143"),
    "spmv_packed": (_FAMILY, "tools/exp_spmv.py:174"),
    "stream_ceiling": (_FAMILY, "tools/exp_spmv.py:205"),
}
# harness variants behind each harness row of the kernels line; the first
# is the row's representative (its times and error)
HARNESS_ROWS = {
    "spmv_variant": ("pallas_b1024", "pallas_b512", "pallas_b2048",
                     "pallas_b4096", "pallas_roll_b1024", "pallas_b128",
                     "pallas_b256"),
    "spmv_bf16_variant": ("pallas_bf16diag_b1024",),
    "spmv_variant_cp": ("pallas_b256_arb", "pallas_b512_par"),
    "spmv_packed": ("pallas_packed_b1024", "pallas_packed_b512"),
    "stream_ceiling": ("ceiling_elementwise",),
}
# bytes a level moves (inputs read once, outputs written once, in elements
# of the working type unless stated) and operations a level
STREAMS = {"thomas": 5, "tridiag_spmv": 5, "block_thomas2": 16,
           "tridiag_spmv_chain": 5, "tridiag_jacobi_smooth": 6}
OPS = {"thomas": 8, "tridiag_spmv": 5, "tridiag_spmv_mixed": 5,
       "block_thomas2": 59, "tridiag_spmv_chain": 6 * CHAIN_K,
       "tridiag_jacobi_smooth": 9 * CHAIN_K, "spmv_variant": 5,
       "spmv_bf16_variant": 5, "spmv_variant_cp": 5, "spmv_packed": 5,
       "stream_ceiling": 6}


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


# device-time readings queued by the phases, taken after (p) by settle()
PENDING = []
# the (c) kernels' main-shape calls, timed eagerly again after settle()
AGAIN = {}


def later(fn, reps, *rows, key="device_ms"):
    """Queue ``device_time(fn, reps)``; settle() writes its reading into
    ``row[key]`` of every row of ``rows``."""
    for row in rows:
        row[key] = None
    PENDING.append((fn, reps, rows, key))


def settle(torch):
    """Take the queued device-time readings."""
    for fn, reps, rows, key in PENDING:
        ms = device_time(torch, fn, reps)
        for row in rows:
            row[key] = ms
    PENDING.clear()


def alm_inputs(ncol, nz, seed=0):
    """Soils and forcing of the ALM production cell (per-column
    heterogeneous CLM soils, seepage BC, infiltration + ET)."""
    rng = np.random.default_rng(seed)
    shape = (ncol, nz)
    soils = dict(
        watsat=0.35 + 0.1 * rng.random(shape),
        hksat=0.004 * (0.5 + rng.random(shape)),
        bsw=2.0 + 2.0 * rng.random(shape),
        sucsat=20.0 + 20.0 * rng.random(shape),
        residual_sat=0.10 + 0.1 * rng.random(shape),
        dz=np.full(shape, 0.1), area=np.ones(ncol),
        P0=np.full(shape, 3.5355e3), include_seepage_bc=True)
    rootr = np.zeros(shape)
    rootr[:, -6:] = 1.0 / 6.0
    forcing = dict(qflx_infl=2e-4 * (0.2 + rng.random(ncol)),
                   qflx_tran_veg=1e-4 * rng.random(ncol), rootr=rootr)
    return soils, forcing


def uniform_soils(ncol, nz, dz):
    """The uniform CLM soils of tests/test_alm.py:22 (``_soil_kwargs``)."""
    shape = (ncol, nz)
    return dict(watsat=np.full(shape, 0.368),
                hksat=np.full(shape, 0.0070556), bsw=np.full(shape, 2.0),
                sucsat=np.full(shape, 29.772),
                residual_sat=np.full(shape, 0.2772), dz=np.full(shape, dz),
                area=np.ones(ncol))


def bound(nbytes, ops, dtype):
    """The least time [ms] the card could take: the larger of ``nbytes``
    over the HBM rate and ``ops`` over the peak rate of ``dtype``
    ("float64" or "float32"); returns (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_fields(name, shape, dtype, nbytes=None):
    """bound_ms and bound_by of kernel ``name`` at ``shape`` ([ncol, levels])
    in ``dtype``; ``nbytes`` overrides the STREAMS count."""
    cells = shape[0] * shape[1]
    if nbytes is None:
        nbytes = STREAMS[name] * cells * (8 if dtype == "float64" else 4)
    ms, by = bound(nbytes, OPS[name] * cells, dtype)
    return dict(bytes=nbytes, bound_ms=ms, bound_by=by)


def block_diag_csr(torch, dl, d, du):
    """The batched tridiagonal T as one block-diagonal CSR matrix
    [ncol*nz, ncol*nz] with int32 indices, built on the card (the library
    yardstick's operand; the port never uses it)."""
    ncol, nz = d.shape
    n = ncol * nz
    dev = d.device
    k = torch.arange(nz, device=dev).expand(ncol, nz)
    r = torch.arange(n, device=dev).view(ncol, nz)
    keep = torch.stack([k > 0, torch.ones_like(k, dtype=torch.bool),
                        k < nz - 1], -1)
    cols = torch.stack([r - 1, r, r + 1], -1)[keep].to(torch.int32)
    vals = torch.stack([dl, d, du], -1)[keep]
    crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(keep.reshape(n, 3).sum(-1), 0)
    return torch.sparse_csr_tensor(crow.to(torch.int32), cols, vals,
                                   (n, n))


def library_spmv(torch, dl, d, du, x, ref, rtol, *rows):
    """Time one torch.sparse.mm of the block-diagonal CSR with x (CUDA
    events, and device time queued; the CSR built outside the timed
    region), after checking it against ``ref`` to ``rtol`` of max |ref|;
    the readings go into ``library_ms`` and ``library_device_ms`` of every
    row of ``rows``."""
    csr = block_diag_csr(torch, dl, d, du)
    xv = x.reshape(-1, 1)
    y = torch.sparse.mm(csr, xv).reshape(x.shape)
    scale = float(ref.abs().max())
    err = float((y - ref).abs().max())
    check(err <= rtol * scale, f"library SpMV {tuple(x.shape)} off the "
          f"plain form: {err:.3e} > {rtol:g} * {scale:.3e}")
    call = partial(torch.sparse.mm, csr, xv)
    ms = time_cuda(torch, call, 20)
    for row in rows:
        row["library_ms"] = ms
    later(call, 20, *rows, key="library_device_ms")


def time_cuda(torch, fn, reps):
    """Mean milliseconds of ``fn()`` over ``reps`` runs (CUDA events,
    after two warm-up runs)."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time(torch, fn, reps, tries=5):
    """Mean device milliseconds of one ``fn()``: the summed durations of the
    device activities (kernels, copies, fills) that torch.profiler (CUPTI)
    records over ``reps`` runs, after two warm-up runs, divided by
    ``reps``.  The host's cost of a call (checks, allocation, the launch
    itself) is not in it.

    A window counts only when it is whole: every activity's record count a
    positive multiple of ``reps``.  The trace sometimes comes back a record
    or more short, most often in the first window after a long stretch of
    untraced work (tracing host activities too and opening and closing the
    window 1 ms away from the calls make it rarer), so a short window is
    taken again, up to ``tries`` times; the run fails if none is whole.
    A window of many kernels queued with no host synchronisation (the
    thermal step) lost its first three records in every try, so each
    window opens with spin kernels of a name of their own, waited for and
    left out of the sums."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def window():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(1e-3)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(1e-3)
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA \
                    and "spin_kernel" not in e.name:
                by_name.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        return by_name

    for _ in range(2):
        fn()
    counts = []
    for _ in range(tries):
        by_name = window()
        counts.append({k: len(t) for k, t in by_name.items()})
        if by_name and all(len(t) % reps == 0 for t in by_name.values()):
            return sum(sum(t) for t in by_name.values()) / reps / 1e3
    fail(f"torch.profiler: no whole window of {reps} calls in {tries} "
         f"tries; records per activity: {counts}")


def misaligned(torch, a):
    """A contiguous copy of ``a`` that starts one element into a larger
    buffer, so its data_ptr is not 16-byte aligned."""
    out = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)[1:]
    return out.view(a.shape).copy_(a)


def hold(torch, label, got, ref, tol):
    """Fail unless ``got`` is finite and within ``tol`` of max |ref| of
    ``ref`` (with ``tol`` 0: equal to it bit for bit); returns
    (max |got - ref|, max |ref|)."""
    torch.cuda.synchronize()
    scale = float(torch.max(torch.abs(ref)))
    err = float(torch.max(torch.abs(got - ref)))
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    check(err <= tol * scale, f"{label}: max |kernel - plain| {err:.3e} > "
          f"{tol:g} * {scale:.3e}")
    if tol == 0:
        ints = torch.int64 if got.dtype == torch.float64 else torch.int32
        check(torch.equal(got.view(ints), ref.view(ints)),
              f"{label}: not bitwise equal to the plain version")
    return err, scale


def edge_rows(torch, hk, name, plain, systems, tols, levels,
              memories=("shared",), skewed=(31,)):
    """Kernel ``name`` of ``hk`` against ``plain`` at the edge shapes:
    every level count of ``levels`` at every column count of EDGE_NCOLS,
    f64 and f32, and [1000, n] for n in ``skewed`` with every input not
    16-byte aligned; ``systems(shape, dtype)`` gives the arguments,
    ``tols[dtype name]`` the tolerance relative to max |x| (0: bitwise).
    Fails unless ``levels`` reach every form of the kernel in each dtype:
    one level at most each threshold of ``memories`` (``max_on_chip``), one
    between each two, one past the last.  Returns the kernel_check rows."""
    kern = getattr(hk, name)
    for dt_name in tols:
        tops = sorted(hk.max_on_chip(name, getattr(torch, dt_name), m)
                      for m in memories)
        edges = [0] + tops + [float("inf")]
        check(all(any(lo < n <= hi for n in levels)
                  for lo, hi in zip(edges, edges[1:])),
              f"{name} {dt_name}: edge levels {levels} miss a form "
              f"(thresholds {tops})")
    cases = [(ncol, n, dt_name, False) for n in levels
             for ncol in EDGE_NCOLS for dt_name in tols]
    cases += [(1000, n, dt_name, True) for n in skewed for dt_name in tols]
    rows = []
    for ncol, n, dt_name, skew in cases:
        args = systems((ncol, n), getattr(torch, dt_name))
        if skew:
            args = [misaligned(torch, a) if torch.is_tensor(a) else a
                    for a in args]
        err, scale = hold(torch, f"{name} {(ncol, n)} {dt_name}"
                          f"{' misaligned' if skew else ''}", kern(*args),
                          plain(*args), tols[dt_name])
        call = partial(kern, *args)
        rows.append(dict(
            kernel=name, shape=[ncol, n], dtype=dt_name, misaligned=skew,
            max_abs_err=err, max_abs_x=scale, rel_tol=tols[dt_name],
            ms=time_cuda(torch, call, 20),
            **bound_fields(name, (ncol, n), dt_name)))
        later(call, 10, rows[-1])
    return rows


def kernel_checks(torch, hk, tridiag):
    """Phase (c): every kernel against its plain version on the card, and
    Thomas at the edge shapes."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    rows, results = [], {}
    for nz in (NZ, 64):
        shape = (NCOL, nz)
        dl_np = rng.random(shape) - 0.5
        du_np = rng.random(shape) - 0.5
        d_np = 2.5 + rng.random(shape)          # diagonally dominant
        x_np = rng.standard_normal(shape)
        for dt_name, tol in TOLS["thomas"].items():
            dtype = getattr(torch, dt_name)
            t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
            dl, d, du, x = t(dl_np), t(d_np), t(du_np), t(x_np)
            cases = (
                ("thomas", partial(hk.thomas, dl, d, du, x),
                 partial(tridiag.thomas, dl, d, du, x)),
                ("tridiag_spmv", partial(hk.tridiag_spmv, dl, d, du, x),
                 partial(tridiag.tridiag_matvec, dl, d, du, x)))
            if dtype == torch.float32:
                b16 = [a.to(torch.bfloat16) for a in (dl, d, du)]
                cases += (("tridiag_spmv_mixed",
                           partial(hk.tridiag_spmv_mixed, *b16, x),
                           partial(hk.tridiag_spmv_mixed_plain, *b16, x)),)
            for name, kern, plain in cases:
                yp = plain()
                err, _ = hold(torch, f"{name} {shape} {dt_name}", kern(), yp,
                              tol)
                nbytes = 14 * NCOL * nz if name == "tridiag_spmv_mixed" \
                    else None
                row = dict(max_abs_err=err, ms=time_cuda(torch, kern, 50),
                           plain_ms=time_cuda(torch, plain, 5),
                           library_ms=None, library_device_ms=None,
                           **bound_fields(name, shape, dt_name, nbytes))
                rows.append(dict(kernel=name, shape=list(shape),
                                 dtype=dt_name, rel_tol=tol, **row))
                # the JSON line reports each kernel at the main path's
                # shape and precision (nz=30; f64, or f32 for the mixed)
                main = nz == NZ and (dtype == torch.float64
                                     or name == "tridiag_spmv_mixed")
                targets = [rows[-1]]
                if main:
                    results[name] = dict(shape=list(shape), dtype=dt_name,
                                         **row)
                    targets.append(results[name])
                    AGAIN[name] = (kern, row["ms"])
                later(kern, 20, *targets)
                if name == "tridiag_spmv":
                    library_spmv(torch, dl, d, du, x, yp, 10 * tol, *targets)

    def systems(shape, dtype):
        g = np.random.default_rng(5)
        return [torch.as_tensor(a, dtype=dtype, device=dev) for a in (
            g.random(shape) - 0.5, 2.5 + g.random(shape),
            g.random(shape) - 0.5, g.standard_normal(shape))]
    rows += edge_rows(torch, hk, "thomas", tridiag.thomas, systems,
                      TOLS["thomas"], THOMAS_EDGE_LEVELS)
    return results, rows


def block_systems(shape, seed):
    """Block diagonally dominant random 2x2 block-tridiagonal systems
    (numpy): L, D, U [ncol, n, 2, 2], b [ncol, n, 2]."""
    rng = np.random.default_rng(seed)
    ncol, n = shape
    L = 0.2 * rng.standard_normal((ncol, n, 2, 2))
    U = 0.2 * rng.standard_normal((ncol, n, 2, 2))
    D = 0.2 * rng.standard_normal((ncol, n, 2, 2))
    D[..., 0, 0] = 2.5 + rng.random((ncol, n))
    D[..., 1, 1] = 2.5 + rng.random((ncol, n))
    b = rng.standard_normal((ncol, n, 2))
    return L, D, U, b


def block_kernel_checks(torch, hk, block_thomas):
    """Phase (g): block_thomas2 against its plain version on the card, at
    the TH shapes and the edge shapes."""
    dev = torch.device("cuda")
    rows, result = [], None
    for shape in ((TH_NCOL, TH_NH), (1024, 100)):
        sys_np = block_systems(shape, 2)
        for dt_name, tol in TOLS["block_thomas2"].items():
            dtype = getattr(torch, dt_name)
            args = [torch.as_tensor(a, dtype=dtype, device=dev)
                    for a in sys_np]
            kern = partial(hk.block_thomas2, *args)
            err, scale = hold(torch, f"block_thomas2 {shape} {dt_name}",
                              kern(), block_thomas(*args), tol)
            ms = time_cuda(torch, kern, 50)
            plain_ms = time_cuda(torch, partial(block_thomas, *args), 5)
            # 14 values read (L, D, U, b) and 2 written (x) per level
            fields = bound_fields("block_thomas2", shape, dt_name)
            rows.append(dict(kernel="block_thomas2", shape=list(shape),
                             dtype=dt_name, max_abs_err=err, max_abs_x=scale,
                             rel_tol=tol, ms=ms, plain_ms=plain_ms, **fields))
            targets = [rows[-1]]
            if shape == (TH_NCOL, TH_NH) and dtype == torch.float64:
                result = dict(shape=list(shape), dtype=dt_name,
                              max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              library_ms=None, library_device_ms=None,
                              **fields)
                targets.append(result)
            later(kern, 20, *targets)
    rows += edge_rows(
        torch, hk, "block_thomas2", block_thomas,
        lambda shape, dtype: [torch.as_tensor(a, dtype=dtype, device=dev)
                              for a in block_systems(shape, 6)],
        TOLS["block_thomas2"], EDGE_LEVELS)
    return result, rows


def resident_systems(torch, shape, dtype, seed):
    """Diagonally dominant random bands, x and b on the card (numpy seed),
    and scale = 1/||T||_inf."""
    rng = np.random.default_rng(seed)
    dl = rng.random(shape) - 0.5
    du = rng.random(shape) - 0.5
    d = 2.5 + rng.random(shape)
    dl[:, 0] = 0.0
    du[:, -1] = 0.0
    scale = 1.0 / float(np.max(np.abs(dl) + np.abs(d) + np.abs(du)))
    x = rng.standard_normal(shape)
    b = rng.standard_normal(shape)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    return (t(dl), t(d), t(du), t(x), t(b)), scale


def resident_edge_systems(torch, name, shape, dtype):
    """The chain's or the smoother's arguments at an edge shape, drawn on
    the card (torch generator, seed 11): diagonally dominant bands,
    ||T||_inf <= 4.5, scale 0.25."""
    g = torch.Generator(device="cuda").manual_seed(11)
    u = lambda: torch.rand(shape, generator=g, device="cuda",
                           dtype=torch.float64)
    dl, du, d = u() - 0.5, u() - 0.5, 2.5 + u()
    x = torch.randn(shape, generator=g, device="cuda", dtype=torch.float64)
    b = torch.randn(shape, generator=g, device="cuda", dtype=torch.float64)
    dl, d, du, x, b = (a.to(dtype) for a in (dl, d, du, x, b))
    if name == "tridiag_spmv_chain":
        return [dl, d, du, x, CHAIN_K, 0.25]
    return [dl, d, du, b, x, CHAIN_K]


def subnormal_ties(torch, shape):
    """Smoother arguments at ``shape`` (f32) whose every quotient b/d is a
    midpoint of the f32 subnormal grid: b = M D 2^-145, d = 32 D (M, D odd,
    so b/d = M 2^-150); with x = 0 and omega = 1 one sweep gives y =
    RN(b/d), a tie, which a quotient through an f64 reciprocal can round
    the wrong way."""
    m, dd = np.meshgrid(np.arange(3, 64, 2), np.arange(3, 4096, 2),
                        indexing="ij")
    pick = np.resize(np.arange(m.size), shape)
    md, dd = (m * dd).ravel()[pick], dd.ravel()[pick]
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    zero = torch.zeros(shape, dtype=torch.float32, device="cuda")
    return [zero, t(np.ldexp(dd, 5)), zero, t(np.ldexp(md, -145)), zero, 1,
            1.0]


def resident_checks(torch, hk, tridiag):
    """Phase (k): the chain and the smoother through the public ops at
    every shape (the counted path), then each against its plain version,
    bit for bit, and timed; both at the edge levels of every form; the
    smoother at
    ties of the f32 subnormal grid; then its convergence to the Thomas
    solution."""
    cases = [(torch.float64, (NCOL, NZ)), (torch.float64, (NCOL, 64)),
             (torch.float32, (NCOL, NZ)), (torch.float32, (NCOL, 64)),
             (torch.float32, HARNESS_SHAPE)]
    systems = [resident_systems(torch, shape, dtype, 4)
               for dtype, shape in cases]
    hk.reset_launches()
    outs = []
    for (dl, d, du, x, b), scale in systems:
        outs.append((hk.tridiag_spmv_chain(dl, d, du, x, CHAIN_K, scale),
                     hk.tridiag_jacobi_smooth(dl, d, du, b, x, CHAIN_K)))
    torch.cuda.synchronize()
    launches = dict(hk.LAUNCHES)
    for name in ("tridiag_spmv_chain", "tridiag_jacobi_smooth"):
        check(launches[name] == len(cases),
              f"(k) ops path launched {name} {launches[name]} times, not "
              f"{len(cases)}")
    rows, results = [], {}
    for (dtype, shape), ((dl, d, du, x, b), scale), (yc, yj) in zip(
            cases, systems, outs):
        dt_name = str(dtype).replace("torch.", "")
        runs = [
            ("tridiag_spmv_chain", yc,
             partial(hk.tridiag_spmv_chain, dl, d, du, x, CHAIN_K, scale),
             partial(tridiag.tridiag_spmv_chain, dl, d, du, x, CHAIN_K,
                     scale)),
            ("tridiag_jacobi_smooth", yj,
             partial(hk.tridiag_jacobi_smooth, dl, d, du, b, x, CHAIN_K),
             partial(tridiag.tridiag_jacobi_smooth, dl, d, du, b, x,
                     CHAIN_K))]
        for name, got, kern, plain in runs:
            err, ymax = hold(torch, f"{name} {shape} {dt_name}", got,
                             plain(), 0)
            row = dict(max_abs_err=err, bitwise=True,
                       ms=time_cuda(torch, kern, 20),
                       plain_ms=time_cuda(torch, plain, 3), library_ms=None,
                       library_device_ms=None,
                       **bound_fields(name, shape, dt_name))
            rows.append(dict(kernel=name, shape=list(shape), dtype=dt_name,
                             iters=CHAIN_K, max_abs_y=ymax, rel_tol=0,
                             **row))
            targets = [rows[-1]]
            if shape == HARNESS_SHAPE:
                results[name] = dict(shape=list(shape), dtype=dt_name,
                                     launches=launches[name], **row)
                targets.append(results[name])
            later(kern, 10, *targets)
    print("resident_bitwise " + json.dumps(dict(
        shapes=[list(shape) for _, shape in cases],
        dtypes=[str(dtype).replace("torch.", "") for dtype, _ in cases],
        max_abs_err=max(r["max_abs_err"] for r in rows), bitwise=True)))
    for name in ("tridiag_spmv_chain", "tridiag_jacobi_smooth"):
        rows += edge_rows(
            torch, hk, name, getattr(tridiag, name),
            partial(resident_edge_systems, torch, name),
            {"float64": 0, "float32": 0}, RESIDENT_EDGE_LEVELS,
            memories=("registers", "shared"), skewed=RESIDENT_SKEWED)
    for shape in SUBNORMAL_TIE_SHAPES:
        args = subnormal_ties(torch, shape)
        hold(torch, f"tridiag_jacobi_smooth {shape} float32 subnormal ties",
             hk.tridiag_jacobi_smooth(*args),
             tridiag.tridiag_jacobi_smooth(*args), 0)
    print("subnormal_ties " + json.dumps(dict(
        shapes=[list(s) for s in SUBNORMAL_TIE_SHAPES], bitwise=True)))
    # 200 sweeps at omega = 0.9 reach the Thomas kernel's solution
    # (the system of tests/test_pallas_kernels.py:11-17 and :36-44)
    rng = np.random.default_rng(7)
    shape = JACOBI_CHECK["shape"]
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device="cuda")
    d, dl, du = (t(rng.uniform(lo, hi, shape))
                 for lo, hi in ((4.0, 5.0), (0.1, 0.9), (0.1, 0.9)))
    b = t(rng.uniform(-1.0, 1.0, shape))
    xj = hk.tridiag_jacobi_smooth(dl, d, du, b, torch.zeros_like(b),
                                  JACOBI_CHECK["iters"],
                                  JACOBI_CHECK["omega"])
    xt = hk.thomas(dl, d, du, b)
    rel = float((xj - xt).abs().max() / xt.abs().max())
    check(rel <= JACOBI_CHECK["tol"],
          f"Jacobi x{JACOBI_CHECK['iters']} vs Thomas: {rel:.3e} > "
          f"{JACOBI_CHECK['tol']:g}")
    print("jacobi_vs_thomas " + json.dumps(dict(
        shape=list(shape), iters=JACOBI_CHECK["iters"],
        omega=JACOBI_CHECK["omega"], max_rel_diff=rel)))
    print("launches_on_ops_path " + json.dumps(launches))
    return results, rows


def harness_run(torch, hk, card):
    """Phase (l): the SpMV harness at its full size, counted; its rows of
    the kernels line; the library yardstick on the same T."""
    from mpp_tpu_torch.tools import exp_spmv
    check(HARNESS_SHAPE == (exp_spmv.NCOL, exp_spmv.NZ), "harness shape")
    data = exp_spmv.inputs()
    hk.reset_launches()
    res = exp_spmv.run(data=data, fast=False)
    torch.cuda.synchronize()
    launches = dict(hk.LAUNCHES)
    check(res["card"] == card, f"harness card {res['card']} != {card}")
    print("exp_spmv " + json.dumps(res))
    print("launches_on_harness_path " + json.dumps(launches))
    for key in ("spmv_variant", "tridiag_spmv_mixed", "spmv_packed",
                "stream_ceiling"):
        check(launches[key] > 0, f"(l) harness did not launch {key}")
    variants = {"ceiling_elementwise": exp_spmv.CEILING,
                **exp_spmv.variants()}
    x = data[3]
    results = {}
    for row, names in HARNESS_ROWS.items():
        rep = res[names[0]]
        v = variants[names[0]]
        runs = [res[n]["launches"] for n in names]
        check(all(n > 0 for n in runs),
              f"(l) {row}: a variant launched no kernel: {runs}")
        nbytes = 14 * HARNESS_SHAPE[0] * HARNESS_SHAPE[1] \
            if row == "spmv_bf16_variant" else \
            5 * HARNESS_SHAPE[0] * HARNESS_SHAPE[1] * 4
        ms, by = bound(nbytes, OPS[row] * HARNESS_SHAPE[0]
                       * HARNESS_SHAPE[1], "float32")
        results[row] = dict(
            shape=list(HARNESS_SHAPE), dtype="float32", variant=names[0],
            launches=sum(runs), max_abs_err=rep["max_abs_err"],
            ms=rep["kernel_ms"], plain_ms=rep["plain_ms"], bytes=nbytes,
            bound_ms=ms, bound_by=by, library_ms=None,
            library_device_ms=None)
        later(partial(v.apply, *v.prep(*data), x), 10, results[row])
    library_spmv(torch, *data, exp_spmv.jnp_concat(*data), 1e-5,
                 *(results[row] for row in ("spmv_variant", "spmv_variant_cp",
                                            "spmv_packed")))
    return results


def ptxas_summary(log):
    """[kernel, registers, spill store bytes, spill load bytes] per entry
    function of ptxas's -v report."""
    out, name, spill = [], None, (None, None)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append([name, int(m.group(1)), *spill])
            name, spill = None, (None, None)
    return out


def th_inputs(torch, comp, X0_np, ncol, device, dtype):
    """The th_batched cell's inputs: the staged state broadcast to ncol
    columns, the staged BCs with the per-column top temperature
    296.15-310.15 K, and the staged cross-data."""
    X0 = torch.as_tensor(X0_np, dtype=dtype, device=device) \
        .expand(ncol, -1).contiguous()
    bc, ss = comp.gather_inputs(ncol, device, dtype)
    bc[1][:, 0] = torch.linspace(296.15, 310.15, ncol, dtype=dtype,
                                 device=device)
    return X0, bc, ss, comp._serial_dyn(ncol, device, dtype)


def th_step_once(torch, comp, X0_np, device, ncol):
    """One f64 step of the TH cell: (X, iters, ok, reason)."""
    X, bc, ss, dyn = th_inputs(torch, comp, X0_np, ncol, device,
                               torch.float64)
    return comp.step_batched(X, bc, ss, TH_DT, dyn=dyn)


def run_th(torch, comp, X0_np, dtype, nsteps, device, ncol, **tols):
    """One warm step and ``nsteps`` timed steps of the TH cell.  Returns
    (X, ms per step, per-step summaries, set-up seconds, per-step max
    per-column water-mass change [kg])."""
    from mpp_tpu_torch.batched.vsfm_compiled import FMWH2O
    t_setup = time.perf_counter()
    X, bc, ss, dyn = th_inputs(torch, comp, X0_np, ncol, device, dtype)
    states = [X]
    X, _, ok, _ = comp.step_batched(X, bc, ss, TH_DT, dyn=dyn, **tols)
    check(bool(ok.all()), f"TH warm step {dtype}: a column did not converge")
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup
    states.append(X)
    steps = []
    t0 = time.perf_counter()
    for _ in range(nsteps):
        syncs = comp.host_syncs
        X, iters, ok, _ = comp.step_batched(X, bc, ss, TH_DT, dyn=dyn,
                                            **tols)
        steps.append(dict(newton_iters=iters, ok=ok,
                          host_syncs=comp.host_syncs - syncs))
        states.append(X)
    if device != "cpu":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / max(nsteps, 1) * 1e3
    for s in steps:
        check(bool(s.pop("ok").all()), f"TH {dtype}: a column did not "
              "converge")
    check(bool(torch.isfinite(X).all()), f"TH {dtype}: non-finite state")
    check(tuple(X.shape) == (ncol, comp.n), f"TH {dtype}: state shape")
    store = [comp.column_storage(Xs.double(), tuple(
        {k: v.double() for k, v in d.items()} for d in dyn))
        for Xs in states]
    dm = [float(torch.max(torch.abs(b - a))) * FMWH2O
          for a, b in zip(store[:-1], store[1:])]
    return X, ms, steps, setup_s, dm


def run_alm(torch, alm, dtype, nsteps, device, ncol=NCOL):
    """Initialize the ALM problem, one warm step, ``nsteps`` timed steps.
    Returns (ms per step, outputs of the last step, per-step summaries,
    seconds of set-up: initialize + the warm step)."""
    soils, forcing = alm_inputs(ncol, NZ)
    t_setup = time.perf_counter()
    f32 = dtype == torch.float32
    prob = alm.alm_vsfm_initialize(dtype=dtype, device=device,
                                   escalate_f64=not f32, **soils)
    threshold = F32_AUDIT_KG if f32 else F64_AUDIT_KG
    prob.audit_threshold_kg = threshold
    dev_forcing = {k: torch.as_tensor(v, dtype=torch.float64, device=device)
                   for k, v in forcing.items()}
    alm.alm_vsfm_solve(prob, DT, **dev_forcing)           # warm step
    if device != "cpu":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup
    steps = []
    t0 = time.perf_counter()
    for _ in range(nsteps):
        out = alm.alm_vsfm_solve(prob, DT, **dev_forcing)
        steps.append(dict(attempts=out["attempts"],
                          newton_iters=out["newton_iters"],
                          host_syncs=out["host_round_trips_per_step"],
                          audit_err_kg=out["abs_mass_error_col"]))
    if device != "cpu":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / nsteps * 1e3
    for s in steps:
        check(s["audit_err_kg"] < threshold,
              f"audit error {s['audit_err_kg']:.3e} kg >= {threshold:g}")
    for k in ("h2osoi_liq", "h2osoi_ice", "smp_l", "zwt", "qflx_seepage",
              "soilp"):
        check(bool(torch.isfinite(out[k]).all()), f"non-finite {k}")
    check(tuple(out["soilp"].shape) == (ncol, NZ), "soilp shape")
    check(bool((out["reason"] > 0).all()), "a column did not converge")
    return ms, out, steps, setup_s


def sync(torch, device="cuda"):
    if device != "cpu":
        torch.cuda.synchronize()


def held_at_path(torch, hk, tridiag, captured, path):
    """Each kernel of ``captured`` ({(name, dtype name): its arguments as
    the path gave them}) against its plain version on those arguments,
    timed; returns the kernel_check rows."""
    plains = {"thomas": tridiag.thomas,
              "tridiag_spmv": tridiag.tridiag_matvec,
              "tridiag_spmv_mixed": hk.tridiag_spmv_mixed_plain}
    rows = []
    for (name, dt_name), args in sorted(captured.items()):
        kern = partial(getattr(hk, name), *args)
        plain = partial(plains[name], *args)
        tol = TOLS["thomas"][dt_name]
        shape = tuple(args[-1].shape)
        err, scale = hold(torch, f"{name} {path} {shape} {dt_name}", kern(),
                          plain(), tol)
        nbytes = 14 * shape[0] * shape[1] if name == "tridiag_spmv_mixed" \
            else None
        rows.append(dict(kernel=name, path=path, shape=list(shape),
                         dtype=dt_name, max_abs_err=err, max_abs_x=scale,
                         rel_tol=tol, ms=time_cuda(torch, kern, 20),
                         plain_ms=time_cuda(torch, plain, 5),
                         **bound_fields(name, shape, dt_name, nbytes)))
        later(kern, 10, rows[-1])
    return rows


def run_escalation(torch, hk, tridiag, alm):
    """Phase (m): the f32 ALM step with the per-column f64 escalation.
    Returns (the launches of the phase, the step's device-busy row, its
    device time queued, the kernel_check rows of thomas, tridiag_spmv and
    tridiag_spmv_mixed at the bands and right-hand sides the phase gave
    them: the f32 step's and the f64 escalation's)."""
    soils = uniform_soils(NCOL, ESC_NZ, ESC_DZ)
    qinfl = np.zeros(NCOL)
    qinfl[:NCOL // 2] = ESC_QINFL
    t_setup = time.perf_counter()
    prob = alm.alm_vsfm_initialize(P0=np.full((NCOL, ESC_NZ), ESC_P0),
                                   dtype=torch.float32, device="cuda",
                                   **soils)
    check(prob.escalate_f64, "(m): escalation is not the f32 default")
    q = torch.as_tensor(qinfl, dtype=torch.float64, device="cuda")
    counted = ("thomas", "tridiag_spmv", "tridiag_spmv_mixed")
    in_escalation = []
    real = alm._escalate_f64

    def escalate(*args, **kw):
        before = {k: hk.LAUNCHES[k] for k in counted}
        out = real(*args, **kw)
        in_escalation.append({k: hk.LAUNCHES[k] - before[k]
                              for k in counted})
        return out

    # the first arguments each kernel gets in each dtype, through the
    # stepper's solve and J*Y hooks (the escalation uses the same stepper)
    captured = {}
    comp = prob.comp

    def solve(bands, F):
        key = ("thomas", str(F.dtype).split(".")[-1])
        if key not in captured:
            captured[key] = [a.clone() for a in bands] + [F.contiguous()
                                                          .clone()]
        return real_solve(bands, F)

    def matvec(bands, x):
        f32 = x.dtype == torch.float32
        key = ("tridiag_spmv_mixed" if f32 else "tridiag_spmv",
               str(x.dtype).split(".")[-1])
        if key not in captured:
            b = [a.to(torch.bfloat16) if f32 else a.clone() for a in bands]
            captured[key] = b + [x.contiguous().clone()]
        return real_matvec(bands, x)

    real_solve, real_matvec = comp._solve, comp._matvec
    comp._solve, comp._matvec = solve, matvec
    alm._escalate_f64 = escalate
    try:
        hk.reset_launches()
        outs = [alm.alm_vsfm_solve(prob, ESC_DT, qflx_infl=q)]
        sync(torch)
        setup_s = time.perf_counter() - t_setup
        t0 = time.perf_counter()
        for _ in range(ESC_STEPS):
            outs.append(alm.alm_vsfm_solve(prob, ESC_DT, qflx_infl=q))
        sync(torch)
        ms = (time.perf_counter() - t0) / ESC_STEPS * 1e3
        launches = dict(hk.LAUNCHES)
    finally:
        alm._escalate_f64 = real
        del comp._solve, comp._matvec
    check(outs[0]["escalated_cols"] > 0, "(m): the first step escalated no "
          "column")
    for o in outs:
        check(o["abs_mass_error_col"] < F64_AUDIT_KG,
              f"(m): audit error {o['abs_mass_error_col']:.3e} kg >= "
              f"{F64_AUDIT_KG:g} after escalation")
    check(prob.P.dtype == torch.float32, "(m): the state is not f32")
    check(bool(torch.isfinite(prob.P).all()), "(m): non-finite state")
    for k in ("h2osoi_liq", "smp_l", "zwt"):
        check(bool(torch.isfinite(outs[-1][k]).all()), f"(m): non-finite {k}")
    check(in_escalation and all(e["thomas"] > 0 and e["tridiag_spmv"] > 0
                                and e["tridiag_spmv_mixed"] == 0
                                for e in in_escalation),
          f"(m): an escalation did not launch the f64 thomas and "
          f"tridiag_spmv: {in_escalation}")
    print("alm " + json.dumps(dict(
        mode="f32_escalated", ncol=NCOL, nz=ESC_NZ, dt=ESC_DT,
        setup_s=setup_s, ms_per_step=ms,
        escalated_cols=[o["escalated_cols"] for o in outs],
        attempts=[o["attempts"] for o in outs],
        max_audit_err_kg=max(o["abs_mass_error_col"] for o in outs),
        launches_in_escalation=in_escalation, launches=launches)))
    check(set(captured) == {("thomas", "float32"), ("thomas", "float64"),
                            ("tridiag_spmv_mixed", "float32"),
                            ("tridiag_spmv", "float64")},
          f"(m): the path's kernel calls {sorted(captured)}")
    rows = held_at_path(torch, hk, tridiag, captured, "alm_f32_escalated")
    busy = dict(cell="alm_f32_escalated", ms_per_step=ms)
    later(lambda: alm.alm_vsfm_solve(prob, ESC_DT, qflx_infl=q), 1, busy,
          key="step_device_ms")
    return launches, busy, rows


def run_lateral(torch, hk, alm):
    """Phase (n): the ring lateral on (d)'s soils, no forcing.  Returns
    the launches of the phase."""
    soils, _ = alm_inputs(NCOL, NZ)
    P0 = soils.pop("P0")
    P0[:NCOL // 2] = LAT_WET_P
    prob = alm.alm_vsfm_initialize(P0=P0, lateral_connectivity=True,
                                   lateral_conductance=LAT_G, device="cuda",
                                   **soils)
    m0 = float(alm.cell_mass_kg(prob, prob.P).sum())
    hk.reset_launches()
    outs = [alm.alm_vsfm_solve(prob, DT) for _ in range(2)]
    sync(torch)
    launches = dict(hk.LAUNCHES)
    m1 = float(alm.cell_mass_kg(prob, prob.P).sum())
    sums = []
    for o in outs:
        q = o["qflx_lateral"]
        net, gross = float(q.sum()), float(q.abs().sum())
        sums.append([net, gross])
        check(gross > 0 and abs(net) < 1e-10 * gross,
              f"(n): sum qflx_lateral {net:.3e} vs sum |.| {gross:.3e}")
        check(float(q[NCOL // 2 - 1]) > 0 and float(q[NCOL // 2]) < 0,
              "(n): the wet side does not drain toward the dry side")
        check(o["abs_mass_error_col"] < F64_AUDIT_KG,
              f"(n): audit error {o['abs_mass_error_col']:.3e} kg")
        check(bool((o["reason"] > 0).all()), "(n): a column did not converge")
    check(abs(m1 - m0) <= 1e-6 * m0,
          f"(n): total mass {m0:.9e} -> {m1:.9e} kg")
    check(launches["thomas"] > 0 and launches["tridiag_spmv"] > 0,
          f"(n): the lateral path did not launch its kernels: {launches}")
    print("lateral " + json.dumps(dict(
        ncol=NCOL, nz=NZ, conductance=LAT_G, steps=2, mass_kg=[m0, m1],
        qflx_lateral_net_gross=sums,
        max_audit_err_kg=max(o["abs_mass_error_col"] for o in outs),
        launches=launches)))
    return launches


def run_fused(torch, hk, alm):
    """Phase (o): (d)'s step with linesearch_jac="fused" against
    "separate", one step each from the same state.  Returns the launches
    of the fused step."""
    from mpp_tpu_torch.batched.vsfm_compiled import compile_vsfm
    soils, forcing = alm_inputs(NCOL, NZ)
    prob = alm.alm_vsfm_initialize(device="cuda", **soils)
    P0 = prob.P
    dev_forcing = {k: torch.as_tensor(v, dtype=torch.float64, device="cuda")
                   for k, v in forcing.items()}
    res = {}
    for mode in ("separate", "fused"):
        prob.comp = compile_vsfm(prob.mpp, linear_solver="direct",
                                 linesearch_jac=mode)
        prob.P = P0
        hk.reset_launches()
        sync(torch)
        t0 = time.perf_counter()
        out = alm.alm_vsfm_solve(prob, DT, **dev_forcing)
        sync(torch)
        res[mode] = (out, (time.perf_counter() - t0) * 1e3,
                     dict(hk.LAUNCHES))
    (o_s, ms_s, _), (o_f, ms_f, launches) = res["separate"], res["fused"]
    check(bool((o_s["reason"] > 0).all()) and bool((o_f["reason"] > 0).all()),
          "(o): a column did not converge")
    check(torch.equal(o_s["reason"], o_f["reason"]),
          "(o): fused and separate reasons differ")
    dP = float((o_f["soilp"] - o_s["soilp"]).abs().max())
    check(dP <= 1e-7, f"(o): fused vs separate max |dP| {dP:.3e} Pa > 1e-7")
    check(launches["thomas"] > 0 and launches["tridiag_spmv"] > 0,
          f"(o): the fused step did not launch its kernels: {launches}")
    print("fused_vs_separate " + json.dumps(dict(
        ncol=NCOL, nz=NZ, dtype="float64", separate_ms_per_step=ms_s,
        fused_ms_per_step=ms_f, max_abs_dP_Pa=dP,
        newton_iters=[o_s["newton_iters"], o_f["newton_iters"]],
        launches=launches)))
    return launches


def run_thermal(torch, hk, tridiag):
    """Phase (p): the thermal_batched cell.  Returns (the launches of the
    timed path, the Thomas kernel's row at the path's inputs, the step's
    device-busy row, its device time queued)."""
    from mpp_tpu_torch.batched.ksp_compiled import compile_ksp
    from mpp_tpu_torch.problems import thermal_mms
    t0 = time.perf_counter()
    mpp, _ = thermal_mms.run_thermal_mms_problem(1, nx=THERM_NX,
                                                 device="cpu")
    comp = compile_ksp(mpp, linear_solver="direct")
    problem_s = time.perf_counter() - t0
    check(comp.is_tridiag, "(p): the MMS column is not tridiagonal")
    n = comp.n
    rng = np.random.default_rng(0)
    T0_np = 280.0 + 10.0 * rng.random((THERM_NCOL, n))
    liq_np = 5.0 * rng.random((THERM_NCOL, n))

    def inputs(ncol, device, dtype):
        bc, ss = comp.gather_inputs(ncol, device, dtype)
        t = lambda a: torch.as_tensor(a[:ncol], dtype=dtype, device=device)
        return t(T0_np), bc, ss, ({"liq": t(liq_np)},)

    t_setup = time.perf_counter()
    T0, bc, ss, dyn = inputs(THERM_NCOL, "cuda", torch.float32)
    hk.reset_launches()
    T, ok, _ = comp.step_batched(T0, bc, ss, THERM_DT, dyn=dyn)
    oks = [ok]
    sync(torch)
    setup_s = time.perf_counter() - t_setup
    t0 = time.perf_counter()
    for _ in range(THERM_STEPS):
        T, ok, _ = comp.step_batched(T, bc, ss, THERM_DT, dyn=dyn)
        oks.append(ok)
    sync(torch)
    ms = (time.perf_counter() - t0) / THERM_STEPS * 1e3
    launches = dict(hk.LAUNCHES)
    check(all(bool(o.all()) for o in oks), "(p): a column failed its solve")
    check(bool(torch.isfinite(T).all()) and T.dtype == torch.float32
          and tuple(T.shape) == (THERM_NCOL, n), "(p): state")
    check(launches["thomas"] == THERM_STEPS + 1,
          f"(p): thomas launched {launches['thomas']} times in "
          f"{THERM_STEPS + 1} steps")
    # the Thomas kernel against its plain version at the path's bands
    vals, b = comp._assemble(T0, bc, ss, THERM_DT, dyn)
    dl, d, du = comp._tri_bands(vals)
    b = b.contiguous()
    kern = partial(hk.thomas, dl, d, du, b)
    plain = partial(tridiag.thomas, dl, d, du, b)
    err, _ = hold(torch, f"thomas thermal {(THERM_NCOL, n)} float32", kern(),
                  plain(), TOLS["thomas"]["float32"])
    row = dict(kernel="thomas", path="thermal", shape=[THERM_NCOL, n],
               dtype="float32", launches=launches["thomas"],
               max_abs_err=err, rel_tol=TOLS["thomas"]["float32"],
               ms=time_cuda(torch, kern, 50),
               plain_ms=time_cuda(torch, plain, 5), library_ms=None,
               library_device_ms=None,
               **bound_fields("thomas", (THERM_NCOL, n), "float32"))
    later(kern, 20, row)
    # card against CPU, f64, 64 columns
    out = {}
    for device in ("cuda", "cpu"):
        T64, bc64, ss64, dyn64 = inputs(64, device, torch.float64)
        Tn, ok64, _ = comp.step_batched(T64, bc64, ss64, THERM_DT,
                                        dyn=dyn64)
        check(bool(ok64.all()), f"(p): the 64-column f64 step on {device}")
        out[device] = Tn.cpu()
    rel = float(torch.max(torch.abs(out["cuda"] - out["cpu"])
                          / torch.abs(out["cpu"])))
    check(rel <= 1e-9, f"(p): card/CPU thermal step differ: max rel "
          f"{rel:.3e} > 1e-9")
    # the step's parts, each timed alone (CUDA events, host cost included)
    vals = comp._assemble(T, bc, ss, THERM_DT, dyn)[0]
    split = dict(
        assemble_ms=time_cuda(torch, partial(comp._assemble, T, bc, ss,
                                             THERM_DT, dyn), 10),
        bands_ms=time_cuda(torch, partial(comp._tri_bands, vals), 10),
        thomas_ms=row["ms"])
    print("thermal " + json.dumps(dict(
        cell="thermal_batched", ncol=THERM_NCOL, nz=n, dtype="float32",
        dt=THERM_DT, problem_build_s=problem_s, setup_s=setup_s,
        ms_per_step=ms, cell_steps_per_s=THERM_NCOL * n / (ms * 1e-3),
        card_vs_cpu_f64_max_rel=rel, launches=launches, **split)))
    busy = dict(cell="thermal_batched", ms_per_step=ms)
    later(lambda: comp.step_batched(T, bc, ss, THERM_DT, dyn=dyn), 10, busy,
          key="step_device_ms")
    return launches, row, busy


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    check(os.path.isdir(os.path.join(here, "mpp_tpu_torch")),
          "mpp_tpu_torch/ not found beside chip_smoke.py: run it from the "
          "root of a checkout")
    sys.path.insert(0, here)
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")

    # (a) the card
    from mpp_tpu_torch.tools.exp_spmv import card as card_of
    card = card_of()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # (b) build
    from mpp_tpu_torch.ops import _build, hopper_kernels as hk, tridiag
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc "
          f"{_build.build_seconds:.3f} s) -> {_build.library_path()}")
    print("ptxas " + json.dumps(ptxas_summary(_build.build_log)))

    # (c) kernels against their plain versions
    results, checks = kernel_checks(torch, hk, tridiag)
    from mpp_tpu_torch.driver import alm

    # (d) + (e): the main path, counted
    hk.reset_launches()
    ms64, out64, steps64, setup64 = run_alm(torch, alm, torch.float64, 4,
                                            "cuda")
    after64 = dict(hk.LAUNCHES)
    ms32, out32, steps32, setup32 = run_alm(torch, alm, torch.float32, 4,
                                            "cuda")
    launches = dict(hk.LAUNCHES)
    check(after64["thomas"] > 0 and after64["tridiag_spmv"] > 0,
          f"f64 ALM path did not launch thomas/tridiag_spmv: {after64}")
    check(launches["tridiag_spmv_mixed"] - after64["tridiag_spmv_mixed"] > 0,
          f"f32 ALM path did not launch tridiag_spmv_mixed: {launches}")
    check(launches["thomas"] > after64["thomas"],
          "f32 ALM path did not launch thomas")
    for tag, ms, steps, setup_s in (
            ("f64_default", ms64, steps64, setup64),
            ("f32_throughput", ms32, steps32, setup32)):
        iters = [s["newton_iters"] for s in steps]
        syncs = [s["host_syncs"] for s in steps]
        print("alm " + json.dumps(dict(
            mode=tag, ncol=NCOL, nz=NZ, setup_s=setup_s, ms_per_step=ms,
            newton_iters_per_step=iters, host_syncs_per_step=syncs,
            host_syncs_per_newton_iter=sum(syncs) / max(sum(iters), 1),
            max_audit_err_kg=max(s["audit_err_kg"] for s in steps),
            attempts=[s["attempts"] for s in steps])))
    print("launches_on_main_path " + json.dumps(
        dict(f64=after64, total=launches)))
    alm_f64_ms = ms64

    # (f) card against CPU on a small f64 problem
    gpu = run_alm(torch, alm, torch.float64, 1, "cuda", ncol=64)[1]
    cpu = run_alm(torch, alm, torch.float64, 1, "cpu", ncol=64)[1]
    check(gpu["attempts"] == cpu["attempts"]
          and gpu["newton_iters"] == cpu["newton_iters"],
          f"card/CPU iteration counts differ: {gpu['newton_iters']} vs "
          f"{cpu['newton_iters']}")
    check(bool((gpu["reason"].cpu() == cpu["reason"]).all()),
          "card/CPU reasons differ")
    Pg, Pc = gpu["soilp"].cpu(), cpu["soilp"]
    rel = float(torch.max(torch.abs(Pg - Pc) / torch.abs(Pc)))
    check(rel <= 1e-9, f"card/CPU P differ: max rel {rel:.3e} > 1e-9")
    print(f"card_vs_cpu ncol=64 f64: newton_iters {gpu['newton_iters']} "
          f"max rel P diff {rel:.3e}")

    # (g) the block-Thomas kernel against its plain version
    from mpp_tpu_torch.ops.block_thomas import block_thomas
    results["block_thomas2"], rows = block_kernel_checks(torch, hk,
                                                         block_thomas)
    checks += rows

    # (h) + (i): the TH path, counted
    from mpp_tpu_torch.problems import th
    from mpp_tpu_torch.batched.th_compiled import compile_th
    t0 = time.perf_counter()
    mpp, _ = th.run_mass_and_heat(nx=TH_NH, device="cpu")
    comp = compile_th(mpp, linear_solver="direct")
    X0_np = mpp.soe.soln
    problem_s = time.perf_counter() - t0
    th_launches = {}
    hk.reset_launches()
    X64, ms64, steps64, setup64, dm64 = run_th(
        torch, comp, X0_np, torch.float64, TH_STEPS, "cuda", TH_NCOL)
    th_launches["f64"] = dict(hk.LAUNCHES)
    X32, ms32, steps32, setup32, dm32 = run_th(
        torch, comp, X0_np, torch.float32, TH_STEPS, "cuda", TH_NCOL,
        **TH_F32_TOLS)
    th_launches["total"] = dict(hk.LAUNCHES)
    check(th_launches["f64"]["block_thomas2"] > 0,
          f"f64 TH path did not launch block_thomas2: {th_launches}")
    check(th_launches["total"]["block_thomas2"]
          > th_launches["f64"]["block_thomas2"],
          f"f32 TH path did not launch block_thomas2: {th_launches}")
    nh = comp.nh
    hetero = float(torch.max(torch.abs(X64[0, nh:] - X64[-1, nh:])))
    check(hetero > 1e-3, f"TH: per-column forcing not live ({hetero:.3e} K)")
    check(max(dm64) < TH_MASS_KG, f"TH f64: water-mass change "
          f"{max(dm64):.3e} kg per step >= {TH_MASS_KG:g}")
    iters32 = [s["newton_iters"] for s in steps32]
    check(max(iters32) <= 10, f"TH f32: Newton iterations {iters32} > 10")
    dX = (X32.double() - X64).abs()
    dP, dT = float(dX[:, :nh].max()), float(dX[:, nh:].max())
    check(dT < 0.05 and dP < 20.0,
          f"TH f32 vs f64: max |dT| {dT:.3e} K, max |dP| {dP:.3e} Pa")
    for tag, ms, steps, setup_s, dm in (
            ("f64_default", ms64, steps64, setup64, dm64),
            ("f32", ms32, steps32, setup32, dm32)):
        iters = [s["newton_iters"] for s in steps]
        syncs = [s["host_syncs"] for s in steps]
        print("th " + json.dumps(dict(
            mode=tag, ncol=TH_NCOL, cells_per_col=nh, dofs_per_col=comp.n,
            dt=TH_DT, problem_build_s=problem_s, setup_s=setup_s,
            ms_per_step=ms, newton_iters_per_step=iters,
            host_syncs_per_step=syncs, max_mass_change_kg_per_step=max(dm),
            **(TH_F32_TOLS if tag == "f32" else {}),
            **(dict(max_abs_dT_vs_f64_K=dT, max_abs_dP_vs_f64_Pa=dP)
               if tag == "f32" else {}))))
    print("launches_on_th_path " + json.dumps(th_launches))

    # (j) card against CPU on a small f64 TH problem
    Xg, it_g, ok_g, r_g = th_step_once(torch, comp, X0_np, "cuda", 64)
    Xc, it_c, ok_c, r_c = th_step_once(torch, comp, X0_np, "cpu", 64)
    check(bool(ok_g.all()) and bool(ok_c.all()),
          "TH 64-column step did not converge")
    check(it_g == it_c, f"TH card/CPU iteration counts differ: {it_g} vs "
          f"{it_c}")
    check(bool((r_g.cpu() == r_c).all()), "TH card/CPU reasons differ")
    rel = float(torch.max(torch.abs(Xg.cpu() - Xc) / torch.abs(Xc)))
    check(rel <= 1e-9, f"TH card/CPU X differ: max rel {rel:.3e} > 1e-9")
    print(f"th_card_vs_cpu ncol=64 f64: newton_iters {it_g} max rel X diff "
          f"{rel:.3e}")

    launches["block_thomas2"] = th_launches["total"]["block_thomas2"]
    for name in ("thomas", "tridiag_spmv", "tridiag_spmv_mixed",
                 "block_thomas2"):
        results[name]["launches"] = launches[name]

    # (k) the matrix-resident chain and smoother, counted on the ops path
    resident, rows = resident_checks(torch, hk, tridiag)
    results.update(resident)
    checks += rows

    # (l) the SpMV harness, counted
    results.update(harness_run(torch, hk, card))

    # (m)-(p): the f32 escalation, the ring lateral, the fused line search
    # and the thermal KSP, each counted
    by_path = {"alm": {k: launches[k] for k in ("thomas", "tridiag_spmv",
                                                "tridiag_spmv_mixed")}}
    by_path["alm_f32_escalated"], esc_busy, rows = run_escalation(
        torch, hk, tridiag, alm)
    checks += rows
    by_path["alm_lateral"] = run_lateral(torch, hk, alm)
    by_path["alm_fused"] = run_fused(torch, hk, alm)
    by_path["thermal"], thermal_row, thermal_busy = run_thermal(torch, hk,
                                                                tridiag)
    checks.append(thermal_row)
    for name in ("thomas", "tridiag_spmv", "tridiag_spmv_mixed"):
        results[name]["launches_by_path"] = {
            path: counts.get(name, 0) for path, counts in by_path.items()}
        results[name]["launches"] = sum(
            results[name]["launches_by_path"].values())
    results["thomas"]["thermal"] = thermal_row

    # the device times queued by (c)-(p), then the host-clock readings of
    # (d) and (c) again, after those profiler windows
    settle(torch)
    for r in checks:
        print("kernel_check " + json.dumps(r))
    for r in (esc_busy, thermal_busy):
        r["device_busy"] = r["step_device_ms"] / r["ms_per_step"]
        print("step_device " + json.dumps(r))
    print("profiler_after " + json.dumps(dict(
        alm_f64_ms_per_step=[alm_f64_ms, run_alm(torch, alm, torch.float64,
                                                 4, "cuda")[0]],
        eager_ms={name: [ms, time_cuda(torch, kern, 50)]
                  for name, (kern, ms) in AGAIN.items()})))

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = results[name]
        check(r["launches"] > 0, f"{name}: no launch on its path")
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, **r))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

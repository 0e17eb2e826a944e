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
      torch.sparse.mm of a block-diagonal CSR (the library yardstick);
  (d) the ALM f64 default step at ncol=16384, nz=30 with heterogeneous
      CLM soils, seepage BC, infiltration + ET forcing (numpy seed 0): one
      warm step and 4 timed steps; every column converges, max audit error
      < 1e-5 kg, outputs finite;
  (e) the same in the f32 throughput mode (no f64 escalation, audit
      threshold 1e-3 kg);
  (f) a 64-column f64 ALM step on the card and on the CPU: equal attempts,
      Newton iterations and per-column reasons, P within rtol 1e-9;
  (g) the 2x2 block-Thomas kernel against its plain version at [8192, 64]
      and [1024, 100], f64 (tolerance 1e-12) and f32 (2e-5), relative to
      the output's max |x|, on block diagonally dominant random systems;
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
      each held against its plain version on the same inputs (max |kernel
      - plain| <= 1e-12 (f64) / 1e-5 (f32) of max |plain|) and timed; and
      200 sweeps at omega = 0.9 against the Thomas kernel's solution at
      [16384, 64] f64, to 1e-8;
  (l) the SpMV harness (python -m mpp_tpu_torch.tools.exp_spmv) at its
      full size, [131072, 256] f32 with 100 chained applications: every
      variant checked against its plain form and timed, one "exp_spmv"
      JSON line; and a block-diagonal CSR of the same T through
      torch.sparse.mm (cuSPARSE) as the library yardstick.

The launch counters are reset just before (d) and read just after (e),
reset just before (h) and read just after (i), reset just before (k)'s
calls of the ops and read just after them, and reset just before (l)'s
harness run and read just after it: every kernel of each path must have
launched on it.  The line before the last is the card's name and power
limit, the one before it a JSON object with one entry per kernel (its
launches on its path, error against its plain version, kernel and plain
times, the least time the card could take for the same work and the time
of one library call computing the same function, where there is one);
the last line is {"ok": true, "device": {...}}.
"""
import json
import os
import re
import sys
import time

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
CHAIN_K = 30
JACOBI_CHECK = dict(iters=200, omega=0.9, shape=(16384, 64), tol=1e-8)
HARNESS_SHAPE = (131072, 256)
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


def library_spmv(torch, dl, d, du, x, ref, rtol):
    """Time one torch.sparse.mm of the block-diagonal CSR with x (CUDA
    events, the CSR built outside the timed region), after checking it
    against ``ref`` to ``rtol`` of max |ref|; returns ms."""
    csr = block_diag_csr(torch, dl, d, du)
    xv = x.reshape(-1, 1)
    y = torch.sparse.mm(csr, xv).reshape(x.shape)
    scale = float(ref.abs().max())
    err = float((y - ref).abs().max())
    check(err <= rtol * scale, f"library SpMV {tuple(x.shape)} off the "
          f"plain form: {err:.3e} > {rtol:g} * {scale:.3e}")
    ms = time_cuda(torch, lambda: torch.sparse.mm(csr, xv), 20)
    del csr
    return ms


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


def kernel_checks(torch, hk, tridiag):
    """Phase (c): every kernel against its plain version on the card."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    rows, results = [], {}
    for nz in (NZ, 64):
        shape = (NCOL, nz)
        dl_np = rng.random(shape) - 0.5
        du_np = rng.random(shape) - 0.5
        d_np = 2.5 + rng.random(shape)          # diagonally dominant
        x_np = rng.standard_normal(shape)
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
            dl, d, du, x = t(dl_np), t(d_np), t(du_np), t(x_np)
            cases = (
                ("thomas", lambda: hk.thomas(dl, d, du, x),
                 lambda: tridiag.thomas(dl, d, du, x)),
                ("tridiag_spmv", lambda: hk.tridiag_spmv(dl, d, du, x),
                 lambda: tridiag.tridiag_matvec(dl, d, du, x)))
            if dtype == torch.float32:
                b16 = [a.to(torch.bfloat16) for a in (dl, d, du)]
                cases += (("tridiag_spmv_mixed",
                           lambda: hk.tridiag_spmv_mixed(*b16, x),
                           lambda: hk.tridiag_spmv_mixed_plain(*b16, x)),)
            for name, kern, plain in cases:
                yk = kern()
                yp = plain()
                torch.cuda.synchronize()
                scale = float(torch.max(torch.abs(yp)))
                err = float(torch.max(torch.abs(yk - yp)))
                check(bool(torch.isfinite(yk).all()),
                      f"{name} {shape} {dtype}: non-finite output")
                check(err <= tol * scale,
                      f"{name} {shape} {dtype}: max |kernel - plain| "
                      f"{err:.3e} > {tol:g} * {scale:.3e}")
                ms = time_cuda(torch, kern, 50)
                plain_ms = time_cuda(torch, plain, 5)
                dt_name = str(dtype).replace("torch.", "")
                nbytes = 14 * NCOL * nz if name == "tridiag_spmv_mixed" \
                    else None
                library_ms = None
                if name == "tridiag_spmv":
                    library_ms = library_spmv(torch, dl, d, du, x, yp,
                                              10 * tol)
                row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                           library_ms=library_ms,
                           **bound_fields(name, shape, dt_name, nbytes))
                rows.append(dict(kernel=name, shape=list(shape),
                                 dtype=dt_name, rel_tol=tol, **row))
                # the JSON line reports each kernel at the main path's
                # shape and precision (nz=30; f64, or f32 for the mixed)
                main = nz == NZ and (dtype == torch.float64
                                     or name == "tridiag_spmv_mixed")
                if main:
                    results[name] = dict(shape=list(shape), dtype=dt_name,
                                         **row)
    for r in rows:
        print("kernel_check " + json.dumps(r))
    return results


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
    """Phase (g): block_thomas2 against its plain version on the card."""
    dev = torch.device("cuda")
    rows, result = [], None
    for shape in ((TH_NCOL, TH_NH), (1024, 100)):
        sys_np = block_systems(shape, 2)
        ncol, n = shape
        for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 2e-5)):
            L, D, U, b = (torch.as_tensor(a, dtype=dtype, device=dev)
                          for a in sys_np)
            xk = hk.block_thomas2(L, D, U, b)
            xp = block_thomas(L, D, U, b)
            torch.cuda.synchronize()
            scale = float(torch.max(torch.abs(xp)))
            err = float(torch.max(torch.abs(xk - xp)))
            name = f"block_thomas2 {shape} {dtype}"
            check(bool(torch.isfinite(xk).all()), f"{name}: non-finite")
            check(err <= tol * scale, f"{name}: max |kernel - plain| "
                  f"{err:.3e} > {tol:g} * {scale:.3e}")
            ms = time_cuda(torch, lambda: hk.block_thomas2(L, D, U, b), 50)
            plain_ms = time_cuda(torch, lambda: block_thomas(L, D, U, b), 5)
            # 14 values read (L, D, U, b) and 2 written (x) per level
            dt_name = str(dtype).replace("torch.", "")
            fields = bound_fields("block_thomas2", shape, dt_name)
            row = dict(kernel="block_thomas2", shape=list(shape),
                       dtype=dt_name, max_abs_err=err, max_abs_x=scale,
                       rel_tol=tol, ms=ms, plain_ms=plain_ms,
                       gb_per_s=fields["bytes"] / (ms * 1e-3) / 1e9, **fields)
            rows.append(row)
            if shape == (TH_NCOL, TH_NH) and dtype == torch.float64:
                result = dict(shape=list(shape), dtype=dt_name,
                              max_abs_err=err, ms=ms, plain_ms=plain_ms,
                              library_ms=None, **fields)
    for r in rows:
        print("kernel_check " + json.dumps(r))
    return result


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


def resident_checks(torch, hk, tridiag):
    """Phase (k): the chain and the smoother through the public ops at
    every shape (the counted path), then each against its plain version and
    timed; then the smoother's convergence to the Thomas solution."""
    cases = [(torch.float64, (NCOL, NZ)), (torch.float64, (NCOL, 64)),
             (torch.float32, (NCOL, NZ)), (torch.float32, (NCOL, 64)),
             (torch.float32, HARNESS_SHAPE)]
    tols = {torch.float64: 1e-12, torch.float32: 1e-5}
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
        for name, got, kern, plain in (
                ("tridiag_spmv_chain", yc,
                 lambda: hk.tridiag_spmv_chain(dl, d, du, x, CHAIN_K, scale),
                 lambda: tridiag.tridiag_spmv_chain(dl, d, du, x, CHAIN_K,
                                                    scale)),
                ("tridiag_jacobi_smooth", yj,
                 lambda: hk.tridiag_jacobi_smooth(dl, d, du, b, x, CHAIN_K),
                 lambda: tridiag.tridiag_jacobi_smooth(dl, d, du, b, x,
                                                       CHAIN_K))):
            ref = plain()
            torch.cuda.synchronize()
            ymax = float(ref.abs().max())
            err = float((got - ref).abs().max())
            check(bool(torch.isfinite(got).all()),
                  f"{name} {shape} {dt_name}: non-finite output")
            check(err <= tols[dtype] * ymax,
                  f"{name} {shape} {dt_name}: max |kernel - plain| "
                  f"{err:.3e} > {tols[dtype]:g} * {ymax:.3e}")
            ms = time_cuda(torch, kern, 20)
            plain_ms = time_cuda(torch, plain, 3)
            row = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=None,
                       **bound_fields(name, shape, dt_name))
            rows.append(dict(kernel=name, shape=list(shape), dtype=dt_name,
                             iters=CHAIN_K, max_abs_y=ymax,
                             rel_tol=tols[dtype], **row))
            if shape == HARNESS_SHAPE:
                results[name] = dict(shape=list(shape), dtype=dt_name,
                                     launches=launches[name], **row)
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
    for r in rows:
        print("kernel_check " + json.dumps(r))
    print("jacobi_vs_thomas " + json.dumps(dict(
        shape=list(shape), iters=JACOBI_CHECK["iters"],
        omega=JACOBI_CHECK["omega"], max_rel_diff=rel)))
    print("launches_on_ops_path " + json.dumps(launches))
    return results


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
    lib_ms = library_spmv(torch, *data, exp_spmv.jnp_concat(*data), 1e-5)
    results = {}
    for row, names in HARNESS_ROWS.items():
        rep = res[names[0]]
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
            bound_ms=ms, bound_by=by,
            library_ms=lib_ms if row in ("spmv_variant", "spmv_variant_cp",
                                         "spmv_packed") else None)
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
    results = kernel_checks(torch, hk, tridiag)
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
    results["block_thomas2"] = block_kernel_checks(torch, hk, block_thomas)

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
    results.update(resident_checks(torch, hk, tridiag))

    # (l) the SpMV harness, counted
    results.update(harness_run(torch, hk, card))

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

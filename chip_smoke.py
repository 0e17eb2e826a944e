#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mpp_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each fatal on failure (the exit code is non-zero and no result
line is printed):

  (a) require CUDA; print the card's name and power limit (nvidia-smi);
  (b) build the hand-written kernels (nvcc -> mpp_tpu_torch/_build/);
  (c) hold each kernel against its plain PyTorch version on the card at
      [16384, 30] and [16384, 64] (Thomas f64/f32, SpMV f64/f32, mixed
      bf16/f32 SpMV) and time both with CUDA events;
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
      iterations and reasons, X within rtol 1e-9.

The launch counters are reset just before (d) and read just after (e),
and reset just before (h) and read just after (i): every kernel of each
path must have launched on it.  The line before the last is the card's
name and power limit, the one before it a JSON object with one entry per
kernel; the last line is {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
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
SOURCES = {
    "thomas": "mpp_tpu_torch/csrc/tridiag_kernels.cu",
    "tridiag_spmv": "mpp_tpu_torch/csrc/tridiag_kernels.cu",
    "tridiag_spmv_mixed": "mpp_tpu_torch/csrc/tridiag_kernels.cu",
    "block_thomas2": "mpp_tpu_torch/csrc/block_thomas_kernels.cu",
}
REPLACES = {
    "thomas": "mpp_tpu/ops/pallas_kernels.py:204",
    "tridiag_spmv": "mpp_tpu/ops/pallas_kernels.py:67",
    "tridiag_spmv_mixed": "mpp_tpu/ops/pallas_kernels.py:105",
    "block_thomas2": "mpp_tpu/ops/pallas_kernels.py:399",
}


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
                rows.append(dict(kernel=name, shape=list(shape),
                                 dtype=dt_name, max_abs_err=err,
                                 rel_tol=tol, ms=ms, plain_ms=plain_ms))
                # the JSON line reports each kernel at the main path's
                # shape and precision (nz=30; f64, or f32 for the mixed)
                main = nz == NZ and (dtype == torch.float64
                                     or name == "tridiag_spmv_mixed")
                if main:
                    results[name] = dict(max_abs_err=err, ms=ms,
                                         plain_ms=plain_ms)
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
        # bytes of one solve: 14 values read (L, D, U, b), 2 written (x)
        # and 4 of Cp scratch per level
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
            nbytes = (14 + 2 + 4) * ncol * n * L.element_size()
            row = dict(kernel="block_thomas2", shape=list(shape),
                       dtype=str(dtype).replace("torch.", ""),
                       max_abs_err=err, max_abs_x=scale, rel_tol=tol, ms=ms,
                       plain_ms=plain_ms, bytes=nbytes,
                       gb_per_s=nbytes / (ms * 1e-3) / 1e9)
            rows.append(row)
            if shape == (TH_NCOL, TH_NH) and dtype == torch.float64:
                result = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    for r in rows:
        print("kernel_check " + json.dumps(r))
    return result


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
    for pkg in ("mpp_tpu_torch", "mpp_tpu"):
        check(os.path.isdir(os.path.join(here, pkg)),
              f"{pkg}/ not found beside chip_smoke.py: run it from the root "
              "of a checkout")
    sys.path.insert(0, here)
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")

    # (a) the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # (b) build
    from mpp_tpu_torch.ops import _build, hopper_kernels as hk, tridiag
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc "
          f"{_build.build_seconds:.3f} s) -> {_build.library_path()}")

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
    mpp, _ = th.run_mass_and_heat(nx=TH_NH)
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
    kernels = [dict(name=name, route="cuda", source=SOURCES[name],
                    replaces=REPLACES[name], launches=launches[name],
                    **results[name]) for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

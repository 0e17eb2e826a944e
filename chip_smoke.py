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
      Newton iterations and per-column reasons, P within rtol 1e-9.

The launch counters are reset just before (d) and read just after (e):
every kernel must have launched on that main path.  The line before the
last is a JSON object with one entry per kernel; the last line is
{"ok": true, "device": {...}}.
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
KERNEL_SOURCE = "mpp_tpu_torch/csrc/tridiag_kernels.cu"
REPLACES = {
    "thomas": "mpp_tpu/ops/pallas_kernels.py:204",
    "tridiag_spmv": "mpp_tpu/ops/pallas_kernels.py:67",
    "tridiag_spmv_mixed": "mpp_tpu/ops/pallas_kernels.py:105",
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

    kernels = [dict(name=name, route="cuda", source=KERNEL_SOURCE,
                    replaces=REPLACES[name], launches=launches[name],
                    **results[name]) for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

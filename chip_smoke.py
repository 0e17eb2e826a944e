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
  (c2) the column assembly (hk.vsfm_column_assemble) in each mode against
      its plain form on the card at [131072, 15] and [16384, 15] f64 (the
      ELM r05 cell's width and a rank's) and [131072, 15] f32, on an
      ALM problem with TN-503-like soils: device ms, the bytes bound and
      its share, the plain form's ms;
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
      equal to the CPU's within rtol 1e-9;
  (q) th_batched through the "petsc" plan (batched ILU(0) + GMRES(30)):
      (h)'s configuration through compile_th(mpp), one warm step and
      TH_PETSC_STEPS timed steps; (h)'s gates, every column's GMRES
      converged at every Newton iteration, block_thomas2 launched 0 times,
      the first step's state within TH_PLAN_BOUND of (h)'s direct one, and
      a 64-column f64 step on the card equal to the CPU's (Newton
      iterations, reasons, X within rtol 1e-9); every ILU(0)
      factorization and apply and every GMRES inner step and cycle one
      launch of its kernel (gmres_update as many as the stepper's GMRES
      cycles), and no other kernel launched;
  (r) vsfm_vchannel at the reference size (20 x 10 x 30 = 6000 cells,
      ncol=1, f64, 3 steps of 8640 s) through "petsc" and "direct"
      (block-Thomas, b = 200) on the card and on the CPU: both plans
      converge, card vs CPU within rtol 1e-9 under each (direct at equal
      Newton iterations), petsc vs direct within VCH_PLAN_PA; the card's
      ILU(0) one launch a factorization / apply, block_thomas_large one
      launch a direct Newton iteration; each plan's ms and host syncs a
      step;
  (s) the 2-D (20 x 20) and 3-D (20 x 20 x 20) thermal MMS through
      compile_ksp("petsc") on the card and the CPU: GMRES converges, the
      solutions within rtol 1e-9 and their errors against the
      manufactured solution equal within 1e-9 relative;
  (t) run_heat_transport_1d (nz = 100, 2 steps, CompiledThermalEnthalpy)
      and run_vsfm_spac_campbell_problem(multi_goveqns=True) under "petsc"
      and "direct" (the JAX package's rule picks block-Thomas there, b =
      40: block_thomas_large one launch a Newton iteration on the card),
      card against CPU within rtol 1e-9 at equal Newton iterations; ms and
      host syncs a step of its CAMP_STEPS steps;
  (u) the batched canopy pipeline (turbulence -> longwave -> LBL ->
      photosynthesis -> MLC, 93 levels; of the hand-written kernels
      block_thomas_small, one launch for the longwave solve and one for
      the MLC solve a substep (counted on (u1)-(u4), none on (u5), and the
      plain level loop run on no CUDA tensor over (u)), and the ILU(0)
      pair of the radiation solves, one launch a factorization / apply on
      the card):
      (u1) f32 at ncair = 4096 (bench.py:968's largest scaling point),
      default forcing, 1 warm and 4 timed staged substeps and one
      12-substep fused hour: ms a substep, column-substeps/s, each stage's
      CUDA-event ms, host syncs, psy Newton and Obukhov hybrid iterations,
      build s, shortwave re-solve ms, and (with the other device readings)
      the device activities and busy share of one substep (the fuller of
      two profiler windows); gates: finite,
      270 < T_air < 320 K, 0 <= q_air < 0.05, T_sun >= T_shd - 0.5 K on
      leaf levels, every state field f32
      (tests/test_canopy_pipeline.py:18-39);
      (u2) f64 at ncair = 4096, 1 warm and 2 timed substeps: the same
      gates and identical columns within 1e-12;
      (u3) f64 at ncair = 8, 3 substeps on the card and on the CPU: T and q
      within CANOPY_CARD_CPU, equal psy and hybrid iterations;
      (u4) the diurnal loop, f32 at ncair = 256: run_diurnal over
      CANOPY_DIURNAL_HOURS, 12 substeps an hour, the synthetic diurnal BCs
      and an hourly checkpoint (bench.py:956-1009's diurnal_24h): wall s,
      ms a substep with the hourly shortwave re-solve, the canopy-top T
      range; the hour-12 top warmer than hour 4's, the last checkpoint
      read back bit for bit;
      (u5) run_shortwave_problem / run_longwave_problem with
      use_compiled=True on the card and the CPU: equal GMRES cycles, the
      fluxes within rtol 1e-9, the absorbed fluxes within CANOPY_IABS_REL
      of the largest flux.
  (v) the serial canopy stack (Slice E2; of the hand-written kernels
      only the ILU(0) pair, one launch a factorization / apply on the
      card, counted over (v1) and over (v2)-(v3)):
      (v1) the coupled ml_model (run_ml_model_problem: an MLModel and its
      run) at the reference size, one canopy column of 92 air levels +
      soil, medlyn, hours ML_HOURS x 12 substeps of 300 s under the
      synthetic diurnal BCs with checkpoints, on the card and on the CPU:
      tests/test_ml_model.py:70-87's envelope at the middle hour, the
      phase timers' five phases counted once an hour / once a substep,
      equal psy Newton iterations, card vs CPU within ML_CARD_CPU at
      every hour's end, and the card's last-but-one hourly checkpoint
      restored and run through the last hour within ML_CARD_CPU of the
      straight run; ms a substep (by hour), each phase's ms a call and
      share, host syncs a substep;
      (v2) run_mlc_problem at the reference namelists (ncair, ntree) =
      (2, 1) and (2, 2), serial and use_compiled=True, card and CPU:
      equal GMRES iterations card vs CPU, the states within rtol 1e-9,
      compiled vs serial within 1e-10 (tests/test_batched_mlc.py:119),
      and output_regression's files card vs CPU: the same sections and
      cells, every printed number within rtol 1e-9;
      (v3) CompiledMLC at ncair = MLC_WIDE_NCAIR (the diurnal cell's
      width), f64: build s (problem, compile and the warm step), ms a
      step over MLC_WIDE_STEPS steps, GMRES cycles, ILU factors and
      applies and host syncs a step, one step split into the host
      PreSolve + staging and the device assemble + solve (CUDA events),
      and (with the other device readings) the busy share of one step;
      gates: finite, 270 < T_air < 320 K, 0 <= q < 0.05;
  (w) the serial SNES (ops/snes.snes_solve under VSFMSoE.step_dt):
      (w1) celia1990 at nz = 100, dt 3600 s, W1_CELIA's serial steps on
      the card and on the CPU: at every step equal convergence, reasons,
      Newton and linear iterations and the solution within SERIAL_RTOL;
      ms a step on each, host syncs a step; then use_compiled=True for
      24 steps on the card, its thomas and tridiag_spmv launches counted
      under the path "vsfm_celia_compiled" and both held to their plain
      forms at the [1, 100] f64 arguments the path gave them;
      (w2) the eight other serial VSFM problems (W2_PROBLEMS) at their
      reference sizes, card against CPU at the same gate (the CPU runs
      in a worker process while the card runs), with ms a step and the
      steps cut from the JAX defaults printed;
      (w3) python -m mpp_tpu_torch.cli on a vsfm_mms namelist in its own
      process on the card (started before (w2), read after it), its
      regression file within SERIAL_RTOL of the CPU CLI's; over the
      serial runs only the ILU(0) pair launched, once a factorization /
      apply on the card, and the phase takes less than SERIAL_BUDGET_S;
  (x) Slices F2 and G, within X_BUDGET_S:
      (x1) th_manoli2014 (the 6-GE TH-SPAC network, 500 unknowns, 12
      colors) for 3 steps of 8640 s on the card and, in a worker process
      meanwhile, on the CPU: at every step converged with equal reasons,
      Newton and GMRES iterations, the solution within SERIAL_RTOL; mass
      and energy conserved to 1e-12, 0 < max |T - 283.15| < 0.01 K; the
      colored Jacobian against torch.func.jacfwd on the card within 1e-12
      of max |J| and zero outside its pattern; at scale 10 (5000
      unknowns; its step is cut for the budget) one Newton iteration's
      linear solve (colored Jacobian, ILU(0), GMRES at rtol 1e-12) on the
      card and in the worker: converged, equal GMRES iterations, the
      direction within SERIAL_RTOL of its largest entry, true residual
      under 1e-9 of |F|; ms
      and host syncs a step, ms of the scale-10 solve;
      (x2) the UGDM lateral ALM step (X2_UGDM: 16384 columns, nz 30, f64,
      the wet half at 1.0e5 Pa, no forcing and no seepage, one warm and 2
      timed steps): every column
      converges, audit < 1e-5 kg, |sum qflx_lateral| < 1e-10 sum |.|,
      total water to 1e-6, the step's lateral source equal to
      lateral_darcy_source_global on the natural-order arrays within
      1e-12; thomas and tridiag_spmv counted under "alm_ugdm" and held to
      their plain forms at the arguments the step gave them;
      (x3) the same steps through a ColumnGroup of one rank under NCCL
      (a FileStore, a 120 s timeout; no fallback), counted under
      "alm_ugdm_nccl", equal to (x2) within rtol 1e-12; the group is
      destroyed at the end;
      (x4) inputs_from_mpp on the staged MLC problem at (2, 2) and at 256
      columns (its first step compiled): the block solve card vs CPU
      within 1e-9 of max |x| and a relative residual under 1e-9 in the
      serial MPP's own system (at (2, 2) also the dense solve, rtol 1e-9,
      and the serial GMRES step within its stopping tolerance); cg (SPD),
      bicgstab and gmres (SPD and nonsymmetric) at n = 256: equal
      iterations card vs CPU, solutions within 1e-10; no kernel but the
      ILU(0) pair, once a factorization / apply on the card, and
      block_thomas_small, once a bridge case's block solve, launched;
      (x1)'s card runs launch it the same way;
  (y) the ILU(0) factor and apply kernels against their plain forms
      (ilu0_factor bit for bit, ilu0_apply within 1e-12 (f64) / 1e-5
      (f32) of max |x|) in f64 and f32 at the paths' sparsities and
      batches (ILU_PATHS: (q)'s TH column at 8192 columns, L2-cold;
      celia1990's tridiagonal column; th_manoli2014 at scale 1 and 10;
      (v3)'s 256-column MLC in its 270 parts), each with the apply's
      library yardstick (two torch.triangular_solve calls, cuSPARSE, held
      to the plain form within the same tolerance), and at the edges of
      every form of the rule (ILU_FORMS: systems a warp, a warp a system
      (levels of 32 rows and of 33), streamed (a root row cut into
      pieces), streamed with cells / rows spilled; the largest
      tridiagonal system staged whole and the next one up; a batch no
      systems-a-block count divides; many parts; inputs not 16-byte
      aligned), failing unless each form is reached in each
      dtype; each timed with its plain form; their launches in the
      kernels line are those counted on the paths above;
  (z) the block-Thomas kernels against their plain form
      (ops/block_thomas.block_thomas) on the card.  block_thomas_small:
      at the canopy's path shapes (BTS_PATHS: [4096, 93, 3] f64, [4096,
      93, 4] f32 and f64, [8, 93, 3 / 4] f64; the rule's form, ms, device
      ms, plain ms, the bound and its share of the device ms), at the
      edges (every m = 1..8 at n in BTS_EDGE_N and B in BTS_EDGE_B, f64
      and f32, block diagonally dominant and row-swapping blocks (each D
      block's rows rotated, its
      leading diagonal zero); the plain forms run at the largest B, the
      kernel on the first B systems; failing unless the rule reached every
      form in each dtype), and a NaN in one system's D that reaches that
      system's x and no other's; tolerances: f64 1e-12 of max |x|, f32 no
      farther from the plain f64 solve of the same values than twice the
      plain f32 solve.  block_thomas_large: at the block plans' shapes
      (BTL_PATHS: (r)'s [1, 30, 200] f64, (t)'s [1, 2, 40] f64, the 2-D
      thermal MMS's [1, 20, 20] f64, the batched MLC at four tree types
      [4096, 93, 10] f32 and f64; timed as above, the bound's operations
      those of getrf + getrs (btl_ops) at PEAK_MATRIX_OPS_S), at the edges
      (BTL_EDGE_M and each form's last m kept in shared memory and the
      first past it, at BTL_EDGE_N levels and BTL_EDGE_B systems, cut as
      BTL_DEEP_CUT says, f64 and f32, dominant and row-swapping), each
      shape in both forms (hk.BTL_FORMS, forced through the rule's
      thresholds: "block", a thread block a system; "cluster", a cluster
      of CTAs a system), the rule's form timed, and the NaN check in each
      form; f64 within 1e-11 of max |x|, f32 by the same rule.
      Beside every path row, one torch.linalg.solve of the assembled
      dense matrix (the JAX package's dense plan; library_ms, on as many
      systems as LIBRARY_DENSE_BYTES holds).  Their launches in the
      kernels line are those counted on (u) and (x4), and on (r) and (t);
      the plain level loop on a CUDA tensor, counted from (b) to here,
      must read 0;
  (z2) the GMRES kernels against their plain forms
      (hopper_kernels.gmres_arnoldi_plain / gmres_update_plain) on the
      card, each in both forms (hk.GMRES_FORMS, forced through the rule's
      thresholds: "warp", a warp a column; "cluster", a thread-block
      cluster a column) and both dtypes, at steps 0, m // 2 and m - 1 and
      the update after each: at the Krylov paths' shapes (GMRES_PATHS:
      (q)'s [8192, 128], (r)'s [1, 6000], (w1)'s [1, 100], (x1)'s [1, 500]
      and [1, 5000], (v3)'s [1, 95232]; m = 30; the rule's form in f64
      timed at j = 0, 15 and 29 and the update, launched through a
      GmresLauncher bound once as the solver launches them: ms, device
      ms, plain ms, the plain step's two torch.bmm device ms, the
      bound) and at the
      edges (GMRES_EDGES: n = 1, 2, 31, 32, 33, 1000, each side of the
      rule's thresholds, m = 1, 4, 30, the serial engine's m = 30 past n
      = 8 and 20 with a column whose w is 0 (hlast == 0), inputs not
      16-byte aligned); the card's V past row j + 1 NaN (never read);
      columns converging at the step, converged before it and done in an
      earlier cycle; a NaN in one column's w that stays in its column;
      f64 within 1e-12 and f32 within 1e-5 of max |.| (V_{j+1} times its
      amplification ||w|| / hlast, cs and sn absolutely), mj, found, its,
      done and the flags equal; failing unless each form is reached in
      each dtype and the rule picks both at the edges; and one 30-step
      cycle at (q) through gmres_cycles (31 ILU(0) applies, 30 steps, one
      update): its ms, device ms and device activities.  Their launches
      in the kernels line are those counted on (q)-(x).

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
the cell's device-busy share (the "step_device" lines).  A device reading
that no whole profiler window gives is null, not measured, with a
"device_time_short" line (see device_time); no gate reads one.

On every Krylov path ((q)-(x)) the ILU(0) and GMRES launches are held to
ilu_gmres.CARD_CALLS, the solver's own counts of factorizations, applies,
inner steps and cycles on the card (ilu_since), and the steps and cycles
to no more than the applies.
The launch counters are reset just before (d) and read just after (e),
reset just before (u) and read just after it (all zero but
block_thomas_small, two a substep, and the ILU(0) pair, whose launches
must equal the card's factorizations and applies over every BatchedILU0,
ilu_gmres.CARD_CALLS), the same for (v) and for (w)'s
serial runs (its compiled celia1990 run is counted apart), and the ILU(0)
pair is counted the same way over (q), (r), (s), (t), (x1) and (x4),
block_thomas_large around the card's "direct" steps of (r) and (t) (one
launch a Newton iteration), reset just before (h) and read just after
(i), reset just before (k)'s
calls of the ops and read just after them, reset just before (l)'s
harness run and read just after it, and reset just before each of
(m)-(p) and read just after it, and reset just before (x2)'s and (x3)'s
timed steps and read just after them: every kernel of each path must
have launched on it.  The line before the last is the card's name and power
limit, the one before it a JSON object with one entry per kernel (its
launches on its path, error against its plain version, kernel (eager and
device) and plain times, the least time the card could take for the same
work and the time of one library call computing the same function, where
there is one);
the last line is {"ok": true, "device": {...}}.
"""
import contextlib
import json
import multiprocessing
import os
import re
import sys
import time
from concurrent.futures import ProcessPoolExecutor
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
# (q): th_batched through "petsc"; TH_PLAN_BOUND is ten times the JAX
# package's own petsc-vs-direct gap after one step of this cell at 64
# columns on the CPU (tests/test_torch_th_petsc.py:jax_plan_gap)
TH_PETSC_STEPS = 4
TH_PLAN_BOUND = dict(P_Pa=4.07e-4, T_K=2.0e-7)
# (r): vsfm_vchannel at the reference size; JAX's own test reads the two
# plans 2.5e-5 Pa apart (tests/test_vsfm_compiled.py:45-47)
VCH_NZ, VCH_DT, VCH_STEPS, VCH_PLAN_PA = 30, 8640.0, 3, 1e-3
# (t): spac_campbell's steps (the JAX defaults: 24 of 3600 s)
CAMP_STEPS, CAMP_DT = 24, 3600.0
# (u): the canopy cells; CANOPY_CARD_CPU bounds (u3)'s card-vs-CPU gap
# after 3 f64 substeps at 8 columns: the CPU tests hold the port against
# the JAX package at these (4e-11 K and 5e-13 measured there,
# tests/test_torch_canopy_pipeline.py; card vs CPU read 2.6e-11 K and
# 2.0e-13 on an H100 80GB HBM3), 1e4 times inside the JAX package's own
# batched-vs-serial bounds (1e-5 K, 1e-8)
CANOPY_NCAIR, CANOPY_DT = 4096, 300.0
CANOPY_F32_SUBSTEPS, CANOPY_F64_SUBSTEPS, CANOPY_HOUR = 4, 2, 12
CANOPY_CARD_CPU = dict(T_K=1e-9, q=1e-12)
CANOPY_DIURNAL_NCAIR, CANOPY_DIURNAL_HOURS = 256, (1, 24)
# (u5): the absorbed fluxes card vs CPU, of the largest flux: the CPU tests'
# bound against the JAX package (1e-9 measured there,
# tests/test_torch_canopy_radiation.py)
CANOPY_IABS_REL = 1e-8
# (v): the ml_model cell (hours x substeps of 300 s, the reference's
# 92 air levels + soil) and ML_CARD_CPU, the bound on its card-vs-CPU
# gap: ~30 times the CPU port-vs-JAX gap over the same 3 hours
# (3.2e-11 K, 3.8e-15 in q, 6.2e-12 relative in the accumulators; the
# photosynthesis FD Jacobian is bit-sensitive, KNOWN_GAPS #6); the restored
# run is held to it too.  MLC_WIDE_*: CompiledMLC at the diurnal cell's
# width
ML_HOURS, ML_NSUBSTEP, NZ_ML = (12, 14), 12, 93
ML_CARD_CPU = dict(T_K=1e-9, q=1e-13, rel=1e-9)
MLC_WIDE_NCAIR, MLC_WIDE_STEPS = 256, 5
# (w): the serial SNES problems at their reference sizes; each entry:
# module, runner, its arguments, the JAX default number of steps and the
# steps run here (fewer where the phase budget forces it, printed as a
# cut); card and CPU agree within SERIAL_RTOL at equal iterations and
# reasons at every step; the whole phase stays under SERIAL_BUDGET_S
SERIAL_RTOL = 1e-9
SERIAL_BUDGET_S = 120.0
# (w2)'s CPU halves: one worker process of 2 threads beside the card's
# runs (two workers of 3 slowed the card's steps by 18 %)
W2_CPU_WORKERS, W2_CPU_THREADS = 1, 2
W1_CELIA = dict(nz=100, dt=3600.0, ref_steps=24, serial_steps=3,
                compiled_steps=24)
W2_PROBLEMS = {
    "vsfm_sy1991": ("run_vsfm_sy1991_problem", {}, 24, 1),
    "vsfm_wt_dynamics": ("run_vsfm_wt_dynamics_problem", {}, 24, 2),
    "vsfm_mms": ("run_vsfm_mms_problem", {}, 1, None),
    "vsfm_vchannel_operator_split": (
        "run_vsfm_vchannel_operator_split_problem", {}, 3, 1),
    "vsfm_manoli2014": ("run_vsfm_manoli2014_problem", {}, 3, 1),
    "vsfm_spac_fetch2": ("run_vsfm_spac_fetch2_problem", {}, 1, None),
    "vsfm_spac_on_hillslope": ("run_vsfm_spac_on_hillslope_problem", {},
                               1, None),
    "vsfm_spac_mms": ("run_vsfm_spac_mms_problem", {}, 1, None),
}
# (x): Slices F2 and G. (x1) th_manoli2014 at its reference size (3 steps
# of 8640 s at scale 1, card and CPU) and at scale 10 the linear solve of
# one Newton iteration (the step is cut for X_BUDGET_S: the CPU worker's
# takes about a minute, 331 GMRES iterations); (x2) the
# UGDM lateral ALM step on a 128 x 128 grid of columns (edges of 10 m,
# tests/test_alm.py:280 at full width) with (d)'s soils, nz 30, the wet
# half at 1.0e5 Pa (at that test's 1.06e5 Pa, over the reference pressure,
# the batched dt ladder cuts the second step's substep to dt / 2^15 and
# never grows it back, in both packages: ~2^15 Newton solves, ROADMAP
# Queue 3, tests/test_torch_alm_dt_ladder.py); (x3) the same through an NCCL ColumnGroup of one
# rank; (x4) the MLC bridge at these (ncair, ntree, compiled first step)
# and the Krylov solvers at n = X4_KRYLOV_N; the phase within X_BUDGET_S
X1_TH_SPAC = dict(dt=8640.0, steps=3, big_scale=10)
X2_UGDM = dict(nx=128, ny=128, edge=10.0, wet=1.0e5, dt=1800.0, steps=2)
X4_MLC_CASES = ((2, 2, False), (256, 1, True))
X4_KRYLOV_N = 256
X_BUDGET_S = 120.0
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
        "block_thomas2": {"float64": 1e-12, "float32": 2e-5},
        "ilu0_apply": {"float64": 1e-12, "float32": 1e-5}}
# the H100 SXM's published peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s,
# operations/s outside the tensor cores, and operations/s of matrix-shaped
# work (block products, LU) in each type: f64 on the tensor cores (DMMA),
# f32 outside them (the tensor cores' TF32 is another type)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float64": 34e12, "float32": 67e12}
PEAK_MATRIX_OPS_S = {"float64": 67e12, "float32": 67e12}
_TRIDIAG = "mpp_tpu_torch/csrc/tridiag_kernels.cu"
_ILU0 = "mpp_tpu_torch/csrc/ilu0_kernels.cu"
_GMRES = "mpp_tpu_torch/csrc/gmres_kernels.cu"
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
    # no pl.pallas_call: the JAX package's lax.scan row sweeps
    "ilu0_factor": (_ILU0, "mpp_tpu/batched/ilu_gmres.py:140"),
    "ilu0_apply": (_ILU0, "mpp_tpu/batched/ilu_gmres.py:152,161"),
    "block_thomas_small": ("mpp_tpu_torch/csrc/block_thomas_small_kernels.cu",
                           "mpp_tpu/ops/block_thomas.py:113,120"),
    "block_thomas_large": ("mpp_tpu_torch/csrc/block_thomas_large_kernels.cu",
                           "mpp_tpu/ops/block_thomas.py:113,120"),
    # no pl.pallas_call: the JAX package's GMRES fori_loops (the Arnoldi
    # step with its Givens loop; the back substitution in the while_loop)
    "gmres_arnoldi": (_GMRES, "mpp_tpu/batched/ilu_gmres.py:244,258"),
    "gmres_update": (_GMRES, "mpp_tpu/batched/ilu_gmres.py:269,283"),
    # no pl.pallas_call: the JAX package's XLA-fused residual and
    # Jacobian values of RichardsGE under jit
    "vsfm_column_assemble": ("mpp_tpu_torch/csrc/vsfm_assembly_kernels.cu",
                             "mpp_tpu/models/richards.py:674,739,837"),
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


# (y): the ILU(0) kernels at the paths' sparsities ((path, B) as the path
# runs them; ILU_AT holds the BatchedILU0 that (q) and (v3) built) and at
# the edges of their forms (ops/ilu0_schedule.py's rule, ILU_FORMS): combs
# of 32 and 33 chains (a warp a system, one round a level and two), the
# largest tridiagonal system each kernel stages whole in each dtype and the
# next one up (streamed), an arrow chain streamed with nothing spilled and
# one whose side rows outnumber the streamed factor's on-chip cells and
# whose rows the apply's (spilled; both root rows wider than a ring
# stage), (q)'s column at a batch that no
# systems-a-block count divides, 600 dense 2x2 blocks (many parts), inputs
# not 16-byte aligned; L2-cold where the caller finds the factor cold
# (GMRES's Krylov basis at 8192 x 128 is ~260 MB)
ILU_AT = {}
ILU_PATHS = (("th_petsc", TH_NCOL, True), ("celia1990", 1, False),
             ("th_manoli2014", 1, False), ("th_manoli2014_x10", 1, False),
             ("mlc_compiled", 1, False))
ILU_COMB = dict(length=40, B=300)
# side rows past the f32 factor's 49,920 on-chip cells (f64: 24,960); and
# few enough that both kernels stream with nothing spilled
ILU_ARROW_SIDE, ILU_ARROW_SIDE_STREAMED = 51000, 3000
ILU_WIDE = dict(blocks=600, B=300)
ILU_SKEWED_B = 1000
ILU_EDGE_B = 2
#: the kernels' forms (ilu_form), every one reached by (y) in each dtype
ILU_FORMS = ("systems_a_warp", "warp", "streamed", "streamed_spilled")
# the ILU(0) factorizations and applies on the card of each counted path,
# each one launch of its kernel (ilu_since)
ILU_BY_PATH = {}
# (z): block_thomas_small at the canopy's path shapes ((path, B, n, m,
# dtype): (u1)/(u2)'s longwave and MLC solves, (u3)'s at 8 columns) and at
# the edges: every m = 1..8 at BTS_EDGE_N levels and BTS_EDGE_B systems
# (33: no warp's system count divides it); tolerances: f64 BTS_F64_REL of
# max |x|, f32 BTS_F32_FACTOR x the plain f32 solve's own distance from
# the plain f64 solve of the same values (the MLC solve is ill-conditioned
# in f32: tests/test_torch_canopy_pipeline.py:14-18)
CANOPY_NLEV = 93            # the pipeline's levels (92 air + soil)
BTS_PATHS = (("longwave", CANOPY_NCAIR, CANOPY_NLEV, 3, "float64"),
             ("mlc", CANOPY_NCAIR, CANOPY_NLEV, 4, "float32"),
             ("mlc", CANOPY_NCAIR, CANOPY_NLEV, 4, "float64"),
             ("longwave_u3", 8, CANOPY_NLEV, 3, "float64"),
             ("mlc_u3", 8, CANOPY_NLEV, 4, "float64"))
BTS_EDGE_N = (1, 2, 93, 1000)
BTS_EDGE_B = (1, 33, 4096)
BTS_F64_REL, BTS_F32_FACTOR = 1e-12, 2.0
# block_thomas_small's launches on each counted path (run_canopy, (x4))
BTS_BY_PATH = {}
# (z), block_thomas_large: its path shapes ((r)'s vchannel "direct",
# (t)'s spac_campbell "direct", the 2-D thermal MMS's "direct" plan at
# 20 x 20, the batched MLC at four tree types on the canopy's columns) and
# the edges, each in both forms (hk.BTL_FORMS): BTL_EDGE_M blocks (the
# cluster form's panel edges at 16 / 32 / 64, its second panel a CTA at
# 129, its 16 CTAs at 256) and each form's last block kept in shared
# memory and the first past it, at BTL_EDGE_N levels and BTL_EDGE_B
# systems, f64 and f32, dominant and row-swapping blocks (from
# BTL_DEEP_CUT up, the deepest n on one dominant f64 system only, and
# past BTL_DEEPEST_M not at all: 33 systems of 30 levels of 1024 x 1024
# blocks are 25 GB in f64, and the block form takes ~12 s on one SM at
# one of them, past the script's time budget); off-diagonal spread 0.5 /
# sqrt(m), so the blocks stay diagonally dominant at every m; f64 within
# BTL_F64_REL of max |x|, f32 by BTS_F32_FACTOR
BTL_PATHS = (("vchannel_direct", 1, VCH_NZ, 200, "float64"),
             ("spac_campbell_direct", 1, 2, 40, "float64"),
             ("thermal_mms_2d_direct", 1, 20, 20, "float64"),
             ("mlc_4_trees", CANOPY_NCAIR, CANOPY_NLEV, 10, "float32"),
             ("mlc_4_trees", CANOPY_NCAIR, CANOPY_NLEV, 10, "float64"))
BTL_EDGE_M = (9, 16, 32, 33, 64, 65, 129, 200, 256, 512, 1024)
BTL_EDGE_N = (1, 2, 30)
BTL_EDGE_B = (1, 33)
BTL_DEEP_CUT, BTL_DEEPEST_M = 512, 512
BTL_F64_REL = 1e-11
# block_thomas_large's launches on each counted path ((r), (t))
BTL_BY_PATH = {}
# the block solves' library yardstick: one torch.linalg.solve of the dense
# T, on as many systems as fit this many bytes (T and its LU copy)
LIBRARY_DENSE_BYTES = 6 << 30
# (z2): the GMRES kernels against their plain forms at the Krylov paths'
# shapes ((path, columns, rows): (q)'s TH columns, (r)'s vchannel, (w1)'s
# celia1990, (x1)'s th_manoli2014 at scale 1 and 10, (v3)'s CompiledMLC at
# 256 columns; m = min(30, n)) and at the edges (GMRES_EDGES: (label,
# columns, rows, m, skewed): rows about a warp, the form rule's thresholds,
# m = 1 / 4 / 30, the serial engine's Krylov dimension past n with a column
# whose w is 0 (hlast == 0), inputs not 16-byte aligned), each in both
# forms and both dtypes, at steps 0, m // 2 and m - 1 and the update; the
# card's V past row j + 1 NaN (never read); columns converged at the step,
# converged before it (found, mj = j) and done in an earlier cycle; a NaN
# in one column's w that stays in its column.  f64 V, H, cs, sn and g
# within 1e-12 of max |.|, f32 1e-5; mj, found, its, done and the flags
# equal
GMRES_PATHS = (("th_petsc", TH_NCOL, 2 * TH_NH), ("vchannel_petsc", 1, 6000),
               ("celia1990_serial", 1, W1_CELIA["nz"]),
               ("th_manoli2014", 1, 500), ("th_manoli2014_x10", 1, 5000),
               ("mlc_compiled", 1, 95232))
GMRES_EDGES = (("n1_m1", 33, 1, 1, False), ("n2_m2", 33, 2, 2, False),
               ("n31_m4", 33, 31, 4, False), ("n32", 9, 32, 30, False),
               ("n33", 9, 33, 30, False), ("n1000", 5, 1000, 30, False),
               ("cols1023_n128", 1023, 128, 30, False),
               ("cols1024_n128", 1024, 128, 30, False),
               ("cols1024_n129", 1024, 129, 30, False),
               ("restart_past_n8", 3, 8, 30, False),
               ("restart_past_n20", 3, 20, 30, False),
               ("misaligned", 9, 33, 30, True))
GMRES_TOL = {"float64": 1e-12, "float32": 1e-5}


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


def later(fn, reps, *rows, key="device_ms", count_key=None, windows=1,
          exclude=()):
    """Queue ``device_time(fn, reps, windows=windows, exclude=exclude)``;
    settle() writes its reading into ``row[key]`` of every row of
    ``rows``, and with ``count_key`` the device activities (kernels,
    copies, fills) of one call into ``row[count_key]``."""
    for row in rows:
        row[key] = None
    PENDING.append((fn, reps, rows, key, count_key, windows, exclude))


def settle(torch):
    """Take the queued device-time readings."""
    for fn, reps, rows, key, count_key, windows, exclude in PENDING:
        ms, count = device_time(torch, fn, reps, with_count=True,
                                windows=windows, exclude=exclude)
        for row in rows:
            row[key] = ms
            if count_key:
                row[count_key] = count
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


def bound(nbytes, ops, dtype, peaks=PEAK_OPS_S):
    """The least time [ms] the card could take: the larger of ``nbytes``
    over the HBM rate and ``ops`` over the peak rate of ``dtype``
    ("float64" or "float32") in ``peaks``; returns (ms, "bytes" or
    "operations")."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / peaks[dtype] * 1e3
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


def time_once(torch, fn):
    """(``fn()``, its milliseconds): CUDA events around one call."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    out = fn()
    ev[1].record()
    torch.cuda.synchronize()
    return out, ev[0].elapsed_time(ev[1])


_FLUSH = []


def l2_flusher(torch):
    """A call that evicts the card's 50 MB L2: one 128 MB device-to-device
    copy (a "Memcpy DtoD" activity, which the cold readings leave out);
    its buffers are made once."""
    if not _FLUSH:
        src = torch.zeros(16 << 20, dtype=torch.float64, device="cuda")
        _FLUSH.append(partial(torch.empty_like(src).copy_, src))
    return _FLUSH[0]


FLUSH_ACTIVITY = ("Memcpy DtoD",)


def time_cold(torch, fn, reps, flush):
    """Mean milliseconds of ``fn()`` with the L2 flushed before each call:
    CUDA events around each call alone (its launch is queued behind the
    flush, so the host's cost of the call is mostly hidden)."""
    fn()
    evs = []
    for _ in range(reps):
        flush()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        evs.append(ev)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / reps


def cold_call(flush, fn):
    """``fn`` behind an L2 flush, for device_time(..., exclude=
    FLUSH_ACTIVITY)."""
    def call():
        flush()
        return fn()
    return call


def device_time(torch, fn, reps, tries=6, with_count=False, windows=1,
                exclude=()):
    """Mean device milliseconds of one ``fn()``: the summed durations of the
    device activities (kernels, copies, fills) that torch.profiler (CUPTI)
    records over ``reps`` runs, after two warm-up runs, divided by
    ``reps``.  The host's cost of a call (checks, allocation, the launch
    itself) is not in it.

    A window counts only when it is whole: every activity's record count a
    positive multiple of ``reps``.  The trace sometimes comes back records
    short: a window of many kernels queued with no host synchronisation
    (the thermal step) lost its first three records in every try, and late
    in a long run a window of ten SpMV calls lost four in five tries in a
    row.  So the calls sit between two pads of spin kernels (a name of
    their own, left out of the sums), each pad waited for and kept a gap
    away from the calls on the host's clock, and a short window is taken
    again with pads four times longer and a gap twice as wide, up to
    ``tries`` times.  ``windows`` (a call of tens of thousands of
    activities, such as (q)'s TH step or a canopy substep, whose windows
    seldom agree twice in a row on their record counts): read that many
    whole windows and keep the one with the most records, since a lost
    record only shortens a window.
    Activities whose name holds a string of ``exclude`` (the L2 flush of
    a cold call, see l2_flusher) are left out like the spins.
    Returns None, and prints a "device_time_short" line with the record
    counts of every try, when no window is whole: the reading is then not
    measured, never taken from a short window.
    ``with_count``: return (ms, the device activities of one call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def pad(n, gap):
        for _ in range(n):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(gap)

    def window(n_pad, gap):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pad(n_pad, gap)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(gap)
            pad(n_pad, gap)
        by_name, spins = {}, 0
        for e in prof.events():
            if e.device_type != DeviceType.CUDA:
                continue
            if "spin_kernel" in e.name:
                spins += 1
            elif not any(x in e.name for x in exclude):
                by_name.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        return by_name, spins

    for _ in range(2):
        fn()
    tried = []
    kept = []
    for i in range(tries):
        n_pad = 4 ** (i + 1)
        by_name, spins = window(n_pad, 1e-3 * 2 ** i)
        tried.append(dict(pad=n_pad, spins=spins,
                          records={k: len(t) for k, t in by_name.items()}))
        if by_name and all(len(t) % reps == 0 for t in by_name.values()):
            kept.append((sum(map(len, by_name.values())), by_name))
            if len(kept) == windows:
                break
    if len(tried) > len(kept):
        print("device_time_short " + json.dumps(dict(
            reps=reps, whole=len(kept), tries=tried)))
    if not kept:
        return (None, None) if with_count else None
    n, by_name = max(kept, key=lambda k: k[0])
    ms = sum(sum(t) for t in by_name.values()) / reps / 1e3
    if with_count:
        return ms, n // reps
    return ms


def ilu_mark(hk):
    """The Krylov counters now: the kernels' launches, and the card's
    ILU(0) factorizations / applies over every BatchedILU0 and GMRES inner
    steps / cycles over every gmres_cycles."""
    from mpp_tpu_torch.batched.ilu_gmres import CARD_CALLS
    return dict(hk.LAUNCHES), dict(CARD_CALLS)


#: the kernel behind each count of ilu_gmres.CARD_CALLS
CARD_KERNELS = {"factor": "ilu0_factor", "apply": "ilu0_apply",
                "arnoldi": "gmres_arnoldi", "update": "gmres_update"}


def ilu_since(hk, path, mark, only_ilu=False, required=True, steps=None,
              instance=None, also=()):
    """Fail unless every ILU(0) factorization and apply and every GMRES
    inner step and cycle on the card since ``mark`` was one launch of its
    kernel (and, ``required``, there was one of each at least), and unless
    the GMRES steps and cycles took no more than the applies (one a step,
    one a later cycle's residual, one a solve's first); with ``only_ilu``
    unless no other kernel but those named in ``also`` launched; with
    ``instance`` = (a BatchedILU0, its factors and applies at the mark)
    unless its counters moved as far.  Records the launches under ``path``
    (per step with ``steps``) and returns them."""
    (l0, c0), (l1, c1) = mark, ilu_mark(hk)
    calls = {k: c1[k] - c0[k] for k in c1}
    launched = {k: l1[CARD_KERNELS[k]] - l0[CARD_KERNELS[k]] for k in c1}
    check(launched == calls, f"{path}: ILU(0) / GMRES launches {launched} "
          f"against the card's factorizations / applies / steps / cycles "
          f"{calls}")
    check(not required or min(calls.values()) > 0,
          f"{path}: no ILU(0) factorization, apply, GMRES step or cycle on "
          f"the card: {calls}")
    check(calls["arnoldi"] + calls["update"] <= calls["apply"],
          f"{path}: GMRES steps and cycles {calls} past the applies")
    if instance is not None:
        ilu, f0, a0 = instance
        moved = {"factor": ilu.factors - f0, "apply": ilu.applies - a0}
        check(moved == {k: launched[k] for k in moved},
              f"{path}: BatchedILU0 counted {moved}, the kernels launched "
              f"{launched}")
    if only_ilu:
        rest = {k: l1[k] - l0[k] for k in l1
                if k not in CARD_KERNELS.values() and k not in also
                and l1[k] != l0[k]}
        check(not rest, f"{path}: launched kernels off the ILU(0) / GMRES "
              f"kernels: {rest}")
    row = dict(path=path, launches=launched)
    if steps:
        row["per_step"] = {k: v / steps for k, v in launched.items()}
    ILU_BY_PATH[path] = row
    print("ilu_launches " + json.dumps(row))
    return launched


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
                    # the main rows also with the L2 flushed before each
                    # call: their inputs (< 50 MB) stay in it otherwise
                    flush = l2_flusher(torch)
                    row["ms_cold"] = time_cold(torch, kern, 20, flush)
                    rows[-1]["ms_cold"] = row["ms_cold"]
                    results[name] = dict(shape=list(shape), dtype=dt_name,
                                         **row)
                    targets.append(results[name])
                    AGAIN[name] = (kern, row["ms"])
                    later(cold_call(flush, kern), 20, *targets,
                          key="device_ms_cold", exclude=FLUSH_ACTIVITY)
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


# (c2): the column assembly at the ELM r05 cell's width and a rank's, and
# its tolerance against the plain form on the card, of max |output| (the
# cuda test's, tests/test_torch_vsfm_column_assembly.py: CARD_REL)
COLUMN_SHAPES = (((131072, 15), "float64"), ((16384, 15), "float64"),
                 ((131072, 15), "float32"))
COLUMN_REL = {"float64": 1e-11, "float32": 2e-4}
COLUMN_OUTPUTS = {"residual": 1, "bands": 3, "both": 4}


def column_case(torch, alm, ncol, nz, dtype, seed):
    """An ALM problem of ncol x nz columns (dz 0.025 e^(0.5 k) m as CLM's
    node depths, a few distinct bsw as a texture map gives, P about a
    water table) and one "both" evaluation's inputs at its state."""
    from mpp_tpu_torch.models import richards_column as rc
    rng = np.random.default_rng(seed)
    shape = (ncol, nz)
    dz = np.broadcast_to(0.025 * np.exp(0.5 * np.arange(nz))[::-1], shape)
    prob = alm.alm_vsfm_initialize(
        watsat=0.35 + 0.1 * rng.random(shape),
        hksat=0.004 * (0.5 + rng.random(shape)),
        bsw=2.9 + 0.5 * rng.integers(0, 10, shape),
        sucsat=20.0 + 20.0 * rng.random(shape),
        residual_sat=0.02 + 0.05 * rng.random(shape), dz=dz,
        area=np.ones(ncol), P0=101325.0 + 2e4 * rng.standard_normal(shape),
        include_seepage_bc=True, dtype=dtype, device="cuda")
    comp, g = prob.comp, prob.comp.goveqns[0]
    dyn = dict(prob.dyn[0])
    dyn["temperature"] = torch.full(shape, 298.15, dtype=dtype,
                                    device="cuda")
    dt = torch.full((ncol, 1), 1800.0, dtype=dtype, device="cuda")
    ap = comp._accum_prev(prob.P, dt, (dyn,))[0]
    nbc, nss = comp._column.nbc, comp._column.nss
    t = lambda a: torch.as_tensor(a, dtype=dtype, device="cuda")
    args = {mode: rc.column_inputs(
        g, comp._column, prob.P, dt, t(np.full((ncol, nbc), 101325.0)),
        t(1e-5 * rng.random((ncol, nss))), ap, torch.zeros_like(ap), dyn,
        mode) for mode in COLUMN_OUTPUTS}
    return comp._column, args


def column_work(args, mode, elem):
    """Bytes of one launch: each input read once (a [ncol, m] input its
    ncol * m values, a shared [m] one its m), each output written once."""
    ncol, nz = args[0].shape
    read = sum(a.numel() for a in args if a is not None)
    return (read + COLUMN_OUTPUTS[mode] * ncol * nz) * elem


def column_assembly_checks(torch, hk, alm):
    """Phase (c2): the column assembly in each mode against its plain form
    on the card, timed beside its bound; returns (the main row: [131072,
    15] f64 "both", the rows)."""
    from mpp_tpu_torch.models import richards_column as rc
    rows, main = [], None
    for shape, dt_name in COLUMN_SHAPES:
        spec, args = column_case(torch, alm, *shape, getattr(torch, dt_name),
                                 seed=shape[0])
        elem = 8 if dt_name == "float64" else 4
        for mode, a in args.items():
            kern = partial(hk.vsfm_column_assemble, *a, spec=spec, mode=mode)
            plain = partial(rc.column_assemble_plain, spec, mode, *a)
            got, ref = kern(), plain()
            if mode == "residual":
                got, ref = (got,), (ref,)
            elif mode == "both":
                got, ref = (got[0], *got[1]), (ref[0], *ref[1])
            errs = [hold(torch, f"vsfm_column_assemble {mode} {shape} "
                         f"{dt_name} [{k}]", x, y, COLUMN_REL[dt_name])
                    for k, (x, y) in enumerate(zip(got, ref))]
            nbytes = column_work(a, mode, elem)
            ms, by = bound(nbytes, 0, dt_name)
            row = dict(kernel="vsfm_column_assemble", mode=mode,
                       shape=list(shape), dtype=dt_name,
                       rel_tol=COLUMN_REL[dt_name],
                       max_rel_err=max(e / max(sc, 1e-300) for e, sc in errs),
                       ms=time_cuda(torch, kern, 50),
                       plain_ms=time_cuda(torch, plain, 5), bytes=nbytes,
                       bound_ms=ms, bound_by=by, library_ms=None,
                       library_device_ms=None)
            rows.append(row)
            targets = [row]
            if shape == (131072, 15) and dt_name == "float64" \
                    and mode == "both":
                main = dict(row)
                targets.append(main)
            later(kern, 20, *targets)
            later(plain, 3, *targets, key="plain_device_ms")
    return main, rows


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
    per-column water-mass change [kg], the state after the warm step)."""
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
        syncs, cycles = comp.host_syncs, comp.gmres_cycles
        X, iters, ok, _ = comp.step_batched(X, bc, ss, TH_DT, dyn=dyn,
                                            **tols)
        steps.append(dict(newton_iters=iters, ok=ok,
                          host_syncs=comp.host_syncs - syncs,
                          gmres_cycles=comp.gmres_cycles - cycles))
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
    return X, ms, steps, setup_s, dm, states[1]


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


@contextlib.contextmanager
def captured_args(torch, comp, captured):
    """Record in ``captured`` the first arguments the stepper ``comp``
    hands each kernel in each dtype, through its solve and J.Y hooks:
    {(name, dtype name): bands + [right-hand side]}, the mixed SpMV's
    bands as the bf16 it reads."""
    real_solve, real_matvec = comp._solve, comp._matvec

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

    comp._solve, comp._matvec = solve, matvec
    try:
        yield
    finally:
        del comp._solve, comp._matvec


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

    # the first arguments each kernel gets in each dtype (the escalation
    # uses the same stepper)
    captured = {}
    alm._escalate_f64 = escalate
    try:
        with captured_args(torch, prob.comp, captured):
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
                                                 use_compiled=True,
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


def card_vs_cpu(label, got, ref, rtol=1e-9):
    """Fail unless ``got`` (card) is within ``rtol`` of ``ref`` (CPU),
    elementwise relative; returns the largest relative difference."""
    got, ref = np.asarray(got), np.asarray(ref)
    check(got.shape == ref.shape and np.isfinite(got).all(),
          f"{label}: card result shape/finiteness")
    rel = float(np.max(np.abs(got - ref) / np.abs(ref)))
    check(rel <= rtol, f"{label}: card/CPU differ: max rel {rel:.3e} > "
          f"{rtol:g}")
    return rel


def run_th_petsc(torch, hk, mpp, comp_direct, X0_np, X1_direct):
    """Phase (q): (h)'s configuration through compile_th(mpp), the
    default "petsc" plan.  Returns the two step-device rows (the petsc
    step and (h)'s direct one, from the same state)."""
    from mpp_tpu_torch.batched.th_compiled import compile_th
    comp = compile_th(mpp)
    check(comp.plan == "petsc", f"(q): plan {comp.plan}")
    ilu = ILU_AT["th_petsc"] = comp._ilu
    hk.reset_launches()
    mark, inst = ilu_mark(hk), (ilu, ilu.factors, ilu.applies)
    X, ms, steps, setup_s, dm, X1 = run_th(
        torch, comp, X0_np, torch.float64, TH_PETSC_STEPS, "cuda", TH_NCOL)
    launches = dict(hk.LAUNCHES)
    per_step = TH_PETSC_STEPS + 1
    krylov = ilu_since(hk, "th_petsc", mark, only_ilu=True, steps=per_step,
                       instance=inst)
    counts = dict(factors_per_step=ilu.factors / per_step,
                  applies_per_step=ilu.applies / per_step)
    check(launches["block_thomas2"] == 0,
          f"(q): block_thomas2 launched {launches['block_thomas2']} times")
    check(comp.gmres_cycles > 0, "(q): no GMRES cycle ran")
    check(krylov["update"] == comp.gmres_cycles, f"(q): gmres_update "
          f"launched {krylov['update']} times in {comp.gmres_cycles} GMRES "
          "cycles")
    bad = comp.gmres_unconverged()
    check(bad == 0, f"(q): {bad} (column, solve) GMRES runs unconverged")
    nh = comp.nh
    hetero = float(torch.max(torch.abs(X[0, nh:] - X[-1, nh:])))
    check(hetero > 1e-3, f"(q): per-column forcing not live ({hetero:.3e})")
    check(max(dm) < TH_MASS_KG, f"(q): water-mass change {max(dm):.3e} kg "
          f"per step >= {TH_MASS_KG:g}")
    d = (X1 - X1_direct).abs()
    dP, dT = float(d[:, :nh].max()), float(d[:, nh:].max())
    check(dP <= TH_PLAN_BOUND["P_Pa"] and dT <= TH_PLAN_BOUND["T_K"],
          f"(q): petsc vs direct after one step: |dP| {dP:.3e} Pa, |dT| "
          f"{dT:.3e} K, bound {TH_PLAN_BOUND}")
    out = {dev: th_step_once(torch, comp, X0_np, dev, 64)
           for dev in ("cuda", "cpu")}
    (Xg, it_g, ok_g, r_g), (Xc, it_c, ok_c, r_c) = out["cuda"], out["cpu"]
    check(bool(ok_g.all()) and bool(ok_c.all()), "(q): 64-column step")
    check(it_g == it_c, f"(q): card/CPU Newton iterations {it_g} vs {it_c}")
    check(bool((r_g.cpu() == r_c).all()), "(q): card/CPU reasons differ")
    rel = card_vs_cpu("(q) X", Xg.cpu().numpy(), Xc.numpy())
    iters = [s["newton_iters"] for s in steps]
    cycles = [s["gmres_cycles"] for s in steps]
    print("th_petsc " + json.dumps(dict(
        cell="th_batched", plan="petsc", ncol=TH_NCOL, cells_per_col=nh,
        dofs_per_col=comp.n, dt=TH_DT, setup_s=setup_s, ms_per_step=ms,
        newton_iters_per_step=iters, gmres_cycles_per_step=cycles,
        gmres_cycles_per_newton_iter=sum(cycles) / max(sum(iters), 1),
        host_syncs_per_step=[s["host_syncs"] for s in steps],
        ilu_levels=[comp._ilu.levels_fwd, comp._ilu.levels_bwd],
        max_mass_change_kg_per_step=max(dm),
        petsc_vs_direct_first_step=dict(max_abs_dP_Pa=dP, max_abs_dT_K=dT),
        bound=TH_PLAN_BOUND, card_vs_cpu_f64_max_rel=rel,
        launches=launches, **counts)))
    # the step's parts at its first Newton iteration, each timed alone
    # (CUDA events, host cost included): the Jacobian, the ILU(0) factor,
    # one preconditioner apply (each one kernel launch), one ELL SpMV and
    # the whole GMRES solve
    Xs, bc, ss, dyn = th_inputs(torch, comp, X0_np, TH_NCOL, "cuda",
                                torch.float64)
    dt_col = torch.full((TH_NCOL, 1), TH_DT, dtype=torch.float64,
                        device="cuda")
    ap = comp._accum_prev(Xs, dt_col, dyn)
    F = comp._residual(Xs, bc, ss, ap, dt_col, torch.zeros_like(Xs), dyn)
    data = comp._jac(Xs, bc, ss, dt_col, dyn)
    prep = ilu.prepare(ilu.factor(data))
    split = dict(
        jacobian_ms=time_cuda(torch, partial(comp._jac, Xs, bc, ss, dt_col,
                                             dyn), 5),
        factor_ms=time_cuda(torch, partial(ilu.factor, data), 5),
        apply_ms=time_cuda(torch, partial(ilu.solve, prep, F), 5),
        ell_spmv_ms=time_cuda(torch, partial(comp._ell, data, F), 5),
        gmres_solve_ms=time_cuda(torch, partial(comp._csr_solve, data, F),
                                 3))
    print("th_petsc_split " + json.dumps(split))
    # one step of each plan from the same state, timed alike: its mean ms
    # over 3 calls (CUDA events), its device time and device activities
    rows = []
    for plan, c in (("petsc", comp), ("direct", comp_direct)):
        fn = partial(c.step_batched, Xs, bc, ss, TH_DT, dyn=dyn)
        row = dict(cell="th_batched", plan=plan, state="X0",
                   ms_per_step=time_cuda(torch, fn, 3))
        later(fn, 1, row, key="step_device_ms",
              count_key="device_activities_per_step", windows=3)
        rows.append(row)
    return rows


def run_vchannel(torch, hk):
    """Phase (r): vsfm_vchannel at the reference size under "petsc" (card
    and CPU, the card's ILU(0) counted) and "direct" (card: block_thomas_
    large launched once a Newton iteration, counted)."""
    from mpp_tpu_torch.constants import AuxVarKind, Var
    from mpp_tpu_torch.problems import vsfm_vchannel as vch
    P, info = {}, {}
    for plan, device in (("petsc", "cuda"), ("direct", "cuda"),
                         ("petsc", "cpu"), ("direct", "cpu")):
        t0 = time.perf_counter()
        mpp = vch.run_vsfm_vchannel_problem(nz=VCH_NZ, nstep=0,
                                            use_compiled=True,
                                            linear_solver=plan,
                                            device=device)
        comp = mpp.soe.step_dt.__self__
        build_s = time.perf_counter() - t0
        check(comp.plan == ("petsc" if plan == "petsc" else "block"),
              f"(r): {plan} took the {comp.plan} plan")
        sync(torch, device)
        counted = plan == "petsc" and device == "cuda"
        if counted:
            mark = ilu_mark(hk)
            inst = (comp._ilu, comp._ilu.factors, comp._ilu.applies)
        btl0, syncs0 = hk.LAUNCHES["block_thomas_large"], comp.host_syncs
        t0 = time.perf_counter()
        reasons = []
        for istep in range(1, VCH_STEPS + 1):
            ok, reason = mpp.soe.step_dt(VCH_DT, istep)
            check(ok, f"(r) {plan} {device}: step {istep} reason {reason}")
            reasons.append(reason)
        sync(torch, device)
        ms = (time.perf_counter() - t0) / VCH_STEPS * 1e3
        if counted:
            krylov = ilu_since(hk, "vchannel_petsc", mark, steps=VCH_STEPS,
                               instance=inst)
            check(krylov["update"] == comp.gmres_cycles, f"(r) petsc: "
                  f"gmres_update launched {krylov['update']} times in "
                  f"{comp.gmres_cycles} GMRES cycles")
        btl = hk.LAUNCHES["block_thomas_large"] - btl0
        its = mpp.soe.cumulative_newton_iterations
        if plan == "direct" and device == "cuda":
            check(btl == its, f"(r) direct: block_thomas_large launched "
                  f"{btl} times in {its} Newton iterations")
            BTL_BY_PATH["vchannel_direct"] = btl
        P[plan, device] = mpp.get_data(AuxVarKind.INTERNAL, Var.PRESSURE)
        info[f"{plan}_{device}"] = dict(
            plan=comp.plan, block_size=comp.block_size, build_s=build_s,
            ms_per_step=ms, newton_iters=its, reasons=reasons,
            host_syncs=comp.host_syncs,
            host_syncs_per_step=(comp.host_syncs - syncs0) / VCH_STEPS,
            block_thomas_large_launches=btl, gmres_cycles=comp.gmres_cycles,
            gmres_cycles_per_newton_iter=comp.gmres_cycles / max(its, 1),
            ilu_levels=(None if comp._ilu is None else
                        [comp._ilu.levels_fwd, comp._ilu.levels_bwd]))
        if plan == "petsc":
            bad = comp.gmres_unconverged()
            check(bad == 0, f"(r) {device}: {bad} GMRES runs unconverged")
    check(info["petsc_cuda"]["block_size"] is None
          and info["direct_cuda"]["block_size"] == 200,
          f"(r): block size {info['direct_cuda']['block_size']}")
    rel = card_vs_cpu("(r) petsc P", P["petsc", "cuda"], P["petsc", "cpu"])
    its = {d: info[f"direct_{d}"]["newton_iters"] for d in ("cuda", "cpu")}
    check(its["cuda"] == its["cpu"], f"(r) direct: Newton iterations {its}")
    rel_direct = card_vs_cpu("(r) direct P", P["direct", "cuda"],
                             P["direct", "cpu"])
    gap = float(np.max(np.abs(P["petsc", "cuda"] - P["direct", "cuda"])))
    check(gap <= VCH_PLAN_PA, f"(r): petsc vs direct {gap:.3e} Pa > "
          f"{VCH_PLAN_PA:g}")
    print("vchannel " + json.dumps(dict(
        cells=int(P["petsc", "cuda"].size), dt=VCH_DT, steps=VCH_STEPS,
        petsc_card_vs_cpu_max_rel=rel, direct_card_vs_cpu_max_rel=rel_direct,
        petsc_vs_direct_max_abs_Pa=gap,
        **info)))


def run_thermal_mms_petsc(torch):
    """Phase (s): the 2-D and 3-D thermal MMS through compile_ksp("petsc")
    on the card and the CPU."""
    from mpp_tpu_torch.problems import thermal_mms
    for ptype in (2, 3):
        out = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            mpp, soln = thermal_mms.run_thermal_mms_problem(
                ptype, use_compiled=True, device=device)
            comp = mpp.soe.step_dt.__self__
            check(comp._ilu is not None, f"(s) {ptype}-D: not the GMRES plan")
            out[device] = (np.asarray(soln), time.perf_counter() - t0,
                           mpp.soe.cumulative_linear_iterations,
                           comp.host_syncs)
        exact = thermal_mms.exact_solution(ptype)
        rel = card_vs_cpu(f"(s) {ptype}-D T", out["cuda"][0], out["cpu"][0])
        err = {d: float(np.max(np.abs(out[d][0] - exact))) for d in out}
        derr = abs(err["cuda"] - err["cpu"]) / err["cpu"]
        check(derr <= 1e-9, f"(s) {ptype}-D: error vs the manufactured "
              f"solution {err['cuda']:.6e} (card) vs {err['cpu']:.6e} (CPU)")
        print("thermal_mms_petsc " + json.dumps(dict(
            dim=ptype, cells=int(exact.size), card_vs_cpu_max_rel=rel,
            max_abs_err_vs_exact_K=err, err_card_vs_cpu_rel=derr,
            gmres_cycles={d: out[d][2] for d in out},
            host_syncs={d: out[d][3] for d in out},
            build_and_step_s={d: out[d][1] for d in out})))


def run_small_problems(torch, hk):
    """Phase (t): run_heat_transport_1d through CompiledThermalEnthalpy and
    the multi-GE spac_campbell under both plans (its 24 steps timed, the
    card's "direct" block solves counted: block_thomas_large at b = 40),
    card against CPU."""
    from mpp_tpu_torch.constants import AuxVarKind, Var
    from mpp_tpu_torch.problems import th, vsfm_spac_campbell as camp
    res = {}
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        mpp, T = th.run_heat_transport_1d(nz=100, nstep=2, compiled=True,
                                          device=device)
        out[device] = (np.asarray(T), time.perf_counter() - t0,
                       mpp.soe.cumulative_linear_iterations)
    res["heat_transport_1d"] = dict(
        card_vs_cpu_max_rel=card_vs_cpu("(t) heat_transport_1d T",
                                        out["cuda"][0], out["cpu"][0]),
        s={d: out[d][1] for d in out},
        gmres_cycles={d: out[d][2] for d in out})
    for plan in ("petsc", "direct"):
        out = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            mpp = camp.run_vsfm_spac_campbell_problem(
                multi_goveqns=True, nstep=0, use_compiled=True,
                linear_solver=plan, device=device)
            comp = mpp.soe.step_dt.__self__
            sync(torch, device)
            t1 = time.perf_counter()
            btl0, syncs0 = hk.LAUNCHES["block_thomas_large"], comp.host_syncs
            for istep in range(1, CAMP_STEPS + 1):
                ok, reason = mpp.soe.step_dt(CAMP_DT, istep)
                check(ok, f"(t) spac_campbell {plan} {device}: step {istep} "
                      f"reason {reason}")
            sync(torch, device)
            step_ms = (time.perf_counter() - t1) * 1e3 / CAMP_STEPS
            btl = hk.LAUNCHES["block_thomas_large"] - btl0
            if plan == "direct" and device == "cuda":
                its = mpp.soe.cumulative_newton_iterations
                check(btl == its, f"(t) spac_campbell direct: "
                      f"block_thomas_large launched {btl} times in {its} "
                      "Newton iterations")
                BTL_BY_PATH["spac_campbell_direct"] = btl
            # "direct" takes the JAX package's rule: block-Thomas where a
            # block size covers the pattern, else dense LU
            check((comp.plan == "petsc") == (plan == "petsc"),
                  f"(t) spac_campbell {plan}: the {comp.plan} plan")
            out[device] = (mpp.get_data(AuxVarKind.INTERNAL, Var.PRESSURE),
                           time.perf_counter() - t0,
                           mpp.soe.cumulative_newton_iterations, comp.plan,
                           comp.block_size, step_ms,
                           (comp.host_syncs - syncs0) / CAMP_STEPS, btl)
        check(out["cuda"][2] == out["cpu"][2], f"(t) spac_campbell {plan}: "
              f"Newton iterations {out['cuda'][2]} vs {out['cpu'][2]}")
        res[f"spac_campbell_multi_{plan}"] = dict(
            card_vs_cpu_max_rel=card_vs_cpu(
                f"(t) spac_campbell {plan} P", out["cuda"][0],
                out["cpu"][0]),
            s={d: out[d][1] for d in out}, newton_iters=out["cuda"][2],
            plan=out["cuda"][3], block_size=out["cuda"][4],
            ms_per_step={d: out[d][5] for d in out},
            host_syncs_per_step={d: out[d][6] for d in out},
            block_thomas_large_launches=out["cuda"][7])
    print("small_problems " + json.dumps(res))


def count_plain_block_loops(hk):
    """Count the plain block-Thomas level loops run on CUDA tensors: the
    name through which ``hopper_kernels.block_thomas_small`` /
    ``block_thomas_large`` / ``block_thomas2`` (CPU tensors) reach it, the
    only callers of ``ops/block_structure.block_solve``'s routes.  Returns
    (the list of their b shapes, a function that restores the name)."""
    calls, saved = [], hk.block_thomas

    def counted(L, D, U, b):
        if b.is_cuda:
            calls.append(list(b.shape))
        return saved(L, D, U, b)
    hk.block_thomas = counted

    def restore():
        hk.block_thomas = saved
    return calls, restore


def bts_count(hk, tag, mark, expected):
    """block_thomas_small's launches since ``mark``; fail unless they are
    ``expected`` (two a canopy substep: the longwave and MLC solves)."""
    got = hk.LAUNCHES["block_thomas_small"] - mark
    check(got == expected, f"{tag}: block_thomas_small launched {got} "
          f"times, not {expected}")
    return got


def canopy_gates(torch, pipe, state, tag, dtype):
    """(u)'s physical gates (tests/test_canopy_pipeline.py:18-39)."""
    for name, a in zip(state._fields, state):
        check(a.dtype == dtype, f"{tag}: {name} is {a.dtype}, not {dtype}")
        check(bool(torch.isfinite(a).all()), f"{tag}: {name} not finite")
    T, q = state.T_air, state.q_air
    check(bool(((T > 270.0) & (T < 320.0)).all()),
          f"{tag}: T_air outside (270, 320) K: {float(T.min())}, "
          f"{float(T.max())}")
    check(bool(((q >= 0.0) & (q < 0.05)).all()),
          f"{tag}: q_air outside [0, 0.05)")
    leaf = pipe.dpai_pos
    check(bool((state.T_sun[:, leaf] >= state.T_shd[:, leaf] - 0.5).all()),
          f"{tag}: a sunlit leaf colder than its shaded one by 0.5 K")


def canopy_counts(pipe):
    return (pipe.host_syncs, pipe.hybrid_iterations, pipe.psy_iterations)


def run_canopy_timed(torch, hk, cp, dtype, substeps, tag):
    """(u1) / (u2): build the pipeline at CANOPY_NCAIR, one warm and
    ``substeps`` timed staged substeps, block_thomas_small launched twice
    a substep; returns (pipe, state, the row)."""
    t0 = time.perf_counter()
    pipe = cp.CanopyPipeline(CANOPY_NCAIR, dtype=dtype, device="cuda")
    sync(torch)
    build_s = time.perf_counter() - t0
    check(pipe.nlev == CANOPY_NLEV, f"{tag}: {pipe.nlev} levels")
    fns = pipe.staged_substep_fns()
    mark = hk.LAUNCHES["block_thomas_small"]
    state = pipe.run_staged(fns, pipe.initial_state(), CANOPY_DT)
    sync(torch)
    c0 = canopy_counts(pipe)
    t0 = time.perf_counter()
    for _ in range(substeps):
        state = pipe.run_staged(fns, state, CANOPY_DT)
    sync(torch)
    ms = (time.perf_counter() - t0) * 1e3 / substeps
    c1 = canopy_counts(pipe)
    canopy_gates(torch, pipe, state, tag, dtype)
    bts = bts_count(hk, tag, mark, 2 * (substeps + 1))
    per = [(b - a) / substeps for a, b in zip(c0, c1)]
    return pipe, state, dict(
        cell=tag, ncair=CANOPY_NCAIR, nlev=pipe.nlev, dtype=str(dtype),
        build_s=build_s, substeps=substeps, ms_per_substep=ms,
        column_substeps_per_s=CANOPY_NCAIR * 1e3 / ms,
        host_syncs_per_substep=per[0],
        hybrid_iterations_per_substep=per[1],
        psy_newton_iterations_per_substep=per[2],
        block_thomas_small_launches_per_substep=bts / (substeps + 1))


def run_canopy(torch, hk):
    """Phase (u): the batched canopy pipeline.  Returns the rows of its
    device readings (queued, taken by settle())."""
    from mpp_tpu_torch.batched import canopy_pipeline as cp
    from mpp_tpu_torch.problems import canopy_radiation as cr
    from mpp_tpu_torch.problems.ml_model import synthetic_diurnal_bc
    hk.reset_launches()
    mark = ilu_mark(hk)
    plain_calls, restore = count_plain_block_loops(hk)
    t_u = time.perf_counter()

    # (u1) f32 at full width: substeps, stages, the fused hour
    pipe, state, row = run_canopy_timed(torch, hk, cp, torch.float32,
                                        CANOPY_F32_SUBSTEPS, "u1_f32")
    fns = pipe.staged_substep_fns()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    f = pipe.default_forcing
    bts0 = hk.LAUNCHES["block_thomas_small"]
    ev[0].record()
    pre = fns[0](state, f)
    ev[1].record()
    gs2 = fns[1](state, pre, f)
    ev[2].record()
    fns[2](state, pre, gs2, f, CANOPY_DT)
    ev[3].record()
    sync(torch)
    row["stage_ms"] = dict(pre=ev[0].elapsed_time(ev[1]),
                           psy=ev[1].elapsed_time(ev[2]),
                           mlc=ev[2].elapsed_time(ev[3]))
    bts_count(hk, "(u1) stages", bts0, 2)
    times = []
    for _ in range(3):
        sync(torch)
        t0 = time.perf_counter()
        pipe.make_forcing()
        sync(torch)
        times.append((time.perf_counter() - t0) * 1e3)
    row["shortwave_resolve_ms"] = times
    hour = pipe.fused_hour_fn(nsubstep=CANOPY_HOUR, dt=CANOPY_DT)
    sync(torch)
    bts0 = hk.LAUNCHES["block_thomas_small"]
    t0 = time.perf_counter()
    s_hour = hour(state, f)
    sync(torch)
    bts_count(hk, "(u1) fused hour", bts0, 2 * CANOPY_HOUR)
    row["fused_hour_s"] = time.perf_counter() - t0
    row["fused_hour_ms_per_substep"] = row["fused_hour_s"] * 1e3 / \
        CANOPY_HOUR
    canopy_gates(torch, pipe, s_hour, "u1_f32 hour", torch.float32)
    BTS_BY_PATH["canopy_u1"] = hk.LAUNCHES["block_thomas_small"]
    print("canopy " + json.dumps(row))
    busy = dict(cell="canopy_pipeline", ncair=CANOPY_NCAIR, dtype="float32",
                ms_per_step=row["ms_per_substep"])
    # windows of one substep: two in a row did not agree on their record
    # counts in five tries after the other phases' windows (~24,000
    # activities a substep), so the fuller of two is kept
    later(partial(pipe.run_staged, fns, state, CANOPY_DT), 1, busy,
          key="step_device_ms", count_key="device_activities_per_step",
          windows=2)

    # (u2) f64 at full width, with batch consistency
    bts0 = hk.LAUNCHES["block_thomas_small"]
    pipe64, s64, row64 = run_canopy_timed(torch, hk, cp, torch.float64,
                                          CANOPY_F64_SUBSTEPS, "u2_f64")
    BTS_BY_PATH["canopy_u2"] = hk.LAUNCHES["block_thomas_small"] - bts0
    spread = max(float((a - a[:1]).abs().max()) for a in s64)
    check(spread <= 1e-12, f"(u2): identical columns differ by {spread:.3e}")
    row64["column_spread"] = spread
    print("canopy " + json.dumps(row64))
    del pipe64, s64

    # (u3) card against CPU, f64, 8 columns, 3 substeps
    out = {}
    for device in ("cuda", "cpu"):
        bts0 = hk.LAUNCHES["block_thomas_small"]
        p = cp.CanopyPipeline(8, device=device)
        s = p.initial_state()
        for _ in range(3):
            s = p.substep(s, CANOPY_DT)
        out[device] = (s, canopy_counts(p)[1:])
        BTS_BY_PATH[f"canopy_u3_{device}"] = bts_count(
            hk, f"(u3) {device}", bts0, 6 if device == "cuda" else 0)
    dT = max(float((a.cpu() - b).abs().max()) for a, b, name in zip(
        out["cuda"][0], out["cpu"][0], cp.CanopyState._fields)
        if name != "q_air")
    dq = float((out["cuda"][0].q_air.cpu() - out["cpu"][0].q_air).abs().max())
    check(out["cuda"][1] == out["cpu"][1],
          f"(u3): hybrid / psy iterations {out['cuda'][1]} vs "
          f"{out['cpu'][1]}")
    check(dT <= CANOPY_CARD_CPU["T_K"] and dq <= CANOPY_CARD_CPU["q"],
          f"(u3): card/CPU differ by {dT:.3e} K, q {dq:.3e}")
    print("canopy_card_vs_cpu " + json.dumps(dict(
        ncair=8, substeps=3, max_abs_T_K=dT, max_abs_q=dq,
        hybrid_psy_iterations=out["cuda"][1], bounds=CANOPY_CARD_CPU)))

    # (u4) the diurnal loop, f32
    import tempfile
    beg, end = CANOPY_DIURNAL_HOURS
    dpipe = cp.CanopyPipeline(CANOPY_DIURNAL_NCAIR, dtype=torch.float32,
                              device="cuda")
    bts0 = hk.LAUNCHES["block_thomas_small"]
    with tempfile.TemporaryDirectory() as d:
        sync(torch)
        t0 = time.perf_counter()
        ds, traj = dpipe.run_diurnal(dpipe.initial_state(), beg, end,
                                     CANOPY_HOUR, synthetic_diurnal_bc,
                                     checkpoint_dir=d)
        sync(torch)
        wall = time.perf_counter() - t0
        back = dpipe.restore(f"{d}/canopy_checkpoint.{end}.{CANOPY_HOUR}.bin")
    canopy_gates(torch, dpipe, ds, "u4_diurnal", torch.float32)
    check(all(torch.equal(a, b) for a, b in zip(ds, back)),
          "(u4): the last checkpoint does not read back bit for bit")
    top = {h: float(traj[h][0].mean()) for h in traj}
    lo, hi = (4, 12) if beg <= 4 else (beg, 12)
    check(bool((traj[hi][0] > traj[lo][0]).all()),
          f"(u4): canopy top at hour {hi} ({top[hi]:.3f} K) not warmer "
          f"than at hour {lo} ({top[lo]:.3f} K)")
    nsub = (end - beg + 1) * CANOPY_HOUR
    BTS_BY_PATH["canopy_u4"] = bts_count(hk, "(u4)", bts0, 2 * nsub)
    print("canopy_diurnal " + json.dumps(dict(
        ncair=CANOPY_DIURNAL_NCAIR, hours=[beg, end], substeps=nsub,
        wall_s=wall, ms_per_substep_with_shortwave=wall * 1e3 / nsub,
        top_T_K_by_hour=top, top_T_range_K=[min(top.values()),
                                            max(top.values())])))
    del dpipe

    # (u5) compiled radiation, card against CPU: the fluxes elementwise
    # at rtol 1e-9; the absorbed fluxes (differences of fluxes) on the
    # fluxes' scale at CANOPY_IABS_REL
    res = {}
    bts0 = hk.LAUNCHES["block_thomas_small"]
    for name, absorbed in (("run_shortwave_problem",
                            ("Iabs_leaf", "Iabs_soil")),
                           ("run_longwave_problem", ("Iabs",))):
        runs = {dev: getattr(cr, name)(use_compiled=True, device=dev)
                for dev in ("cuda", "cpu")}
        cyc = {dev: m.cumulative_linear_iterations for dev, m in runs.items()}
        check(cyc["cuda"] == cyc["cpu"],
              f"(u5) {name}: GMRES cycles {cyc}")
        g, c = runs["cuda"].goveqns[0], runs["cpu"].goveqns[0]
        rel = max(card_vs_cpu(f"(u5) {name} {fld}",
                              getattr(g, fld).cpu().numpy(),
                              getattr(c, fld).numpy())
                  for fld in ("Iup", "Idn"))
        scale = max(float(c.Iup.abs().max()), float(c.Idn.abs().max()))
        rel_abs = max(float((getattr(g, fld).cpu() - getattr(c, fld))
                            .abs().max()) / scale for fld in absorbed)
        check(rel_abs <= CANOPY_IABS_REL,
              f"(u5) {name}: absorbed fluxes differ by {rel_abs:.3e} of "
              "the largest flux")
        res[name] = dict(gmres_cycles=cyc["cuda"], flux_max_rel=rel,
                         absorbed_of_flux_scale=rel_abs)
    BTS_BY_PATH["canopy_u5"] = bts_count(hk, "(u5)", bts0, 0)
    print("canopy_radiation " + json.dumps(res))

    restore()
    check(not plain_calls, f"(u): the plain block-Thomas level loop ran on "
          f"the card at {plain_calls}")
    launches = dict(hk.LAUNCHES)
    ilu_since(hk, "canopy", mark, only_ilu=True, required=False,
              also=("block_thomas_small",))
    print("launches_on_canopy_path " + json.dumps(dict(
        launches=launches, block_thomas_small_by_subphase=BTS_BY_PATH,
        plain_block_loops_on_card=len(plain_calls),
        phase_s=time.perf_counter() - t_u)))
    return [busy]


def rel_close(label, got, ref, rtol):
    """Fail unless |got - ref| <= rtol |ref| elementwise (a zero in ``ref``
    must be a zero in ``got``); returns the largest relative difference
    over the nonzero entries of ``ref``."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    check(got.shape == ref.shape and np.isfinite(got).all(),
          f"{label}: shape/finiteness")
    diff = np.abs(got - ref)
    check(bool((diff <= rtol * np.abs(ref)).all()),
          f"{label}: differ by more than rtol {rtol:g}: max |diff| "
          f"{float(diff.max()):.3e}")
    nz = ref != 0
    return float((diff[nz] / np.abs(ref[nz])).max()) if nz.any() else 0.0


def ml_model_state(m):
    """The fields (v1) compares: the int_cond profiles and the substep
    accumulators, host numpy copies."""
    out = {k: np.array(getattr(m, k)) for k in (
        "tleaf_sun", "tleaf_shd", "tair", "qair", "wind", "gs_sun",
        "gs_shd", "gbh", "gbv")}
    out.update({"accum_" + k: v.copy() for k, v in m.accum.items()})
    return out


def ml_model_gap(a, b):
    """(v1)'s distance between two ml_model states: the largest |dT| [K]
    over the leaf and air temperatures, |dq| over the air vapor, and the
    largest difference of every other field relative to its largest
    magnitude."""
    dT = max(float(np.abs(a[k] - b[k]).max())
             for k in ("tleaf_sun", "tleaf_shd", "tair"))
    dq = float(np.abs(a["qair"] - b["qair"]).max())
    rel = max(float(np.abs(a[k] - b[k]).max())
              / max(float(np.abs(b[k]).max()), 1e-300)
              for k in a if k not in ("tleaf_sun", "tleaf_shd", "tair",
                                      "qair"))
    return dict(T_K=dT, q=dq, rel=rel)


def ml_model_envelope(s, nbot, tag):
    """tests/test_ml_model.py:70-87's midday envelope."""
    tfrz = 273.15
    check(bool(np.all(s["gs_sun"] > 0.01)), f"{tag}: sunlit stomata shut")
    check(bool(np.all(s["accum_anet_leaf_sun"] > 0.0)),
          f"{tag}: sunlit net assimilation not positive")
    check(bool(np.all(s["accum_tr_leaf_sun"] > 0.0)),
          f"{tag}: sunlit transpiration not positive")
    check(bool(np.all((s["tleaf_sun"] > tfrz + 5.0)
                      & (s["tleaf_sun"] < tfrz + 45.0))),
          f"{tag}: sunlit leaf temperature outside (278, 318) K")
    check(bool(np.all((s["tair"] > tfrz) & (s["tair"] < tfrz + 45.0))),
          f"{tag}: air temperature outside (273, 318) K")
    check(bool(np.all((s["qair"] > 0.0) & (s["qair"] < 0.05))),
          f"{tag}: air vapor outside (0, 0.05)")
    check(s["accum_rn_leaf_sun"].mean() > s["accum_rn_leaf_shd"].mean()
          and s["accum_gs_leaf_sun"].mean() > s["accum_gs_leaf_shd"].mean(),
          f"{tag}: sunlit leaves absorb / conduct less than shaded ones")
    check(bool(np.all((s["gbh"] > 0) & (s["gbh"] < 100))),
          f"{tag}: boundary-layer conductance outside (0, 100)")
    check(s["wind"][-1] > s["wind"][nbot] > 0.0,
          f"{tag}: wind does not decay into the canopy")


def run_ml_model(torch, tml, device, ckpt_dir):
    """(v1)'s straight run: hours ML_HOURS x ML_NSUBSTEP substeps of
    run_ml_model_problem (an MLModel and its run) with checkpoints; the
    BC provider snapshots the state at each hour's end.  Returns (model,
    {hour: state at its end}, {hour: wall s of the hour})."""
    model = tml.MLModel(device=device)
    beg, end = ML_HOURS
    states, starts = {}, {}

    def provider(istep, prev):
        if istep - 1 in starts:
            sync(torch, device)
            states[istep - 1] = ml_model_state(model)
        starts[istep] = time.perf_counter()
        return tml.synthetic_diurnal_bc(istep, prev)

    model.run(beg, end, ML_NSUBSTEP, bc_provider=provider,
              checkpoint_data=True, checkpoint_dir=ckpt_dir)
    sync(torch, device)
    t_end = time.perf_counter()
    states[end] = ml_model_state(model)
    starts[end + 1] = t_end
    walls = {h: starts[h + 1] - starts[h] for h in range(beg, end + 1)}
    return model, states, walls


def run_mlc(torch, hk):
    """Phase (v): the serial MLC facade, CompiledMLC and the ml_model
    orchestrator (Slice E2; no hand-written kernel on its path).  Returns
    the rows of its device readings (queued, taken by settle())."""
    import tempfile
    from mpp_tpu_torch.io import regression as reg
    from mpp_tpu_torch.problems import ml_model as tml
    from mpp_tpu_torch.problems import mlc as tmlc
    hk.reset_launches()
    t_v = time.perf_counter()

    # (v1) the coupled canopy model at the reference size, card and CPU
    beg, end = ML_HOURS
    mid = (beg + end) // 2
    with tempfile.TemporaryDirectory() as d:
        runs = {}
        mark = ilu_mark(hk)
        for device in ("cuda", "cpu"):
            os.makedirs(f"{d}/{device}")
            runs[device] = run_ml_model(torch, tml, device, f"{d}/{device}")
        ilu_since(hk, "ml_model", mark, only_ilu=True,
                  steps=(end - beg + 1) * ML_NSUBSTEP)
        mark = ilu_mark(hk)
        model, states, walls = runs["cuda"]
        ml_model_envelope(states[mid], model.nbot, f"(v1) hour {mid}")
        rep = model.timers.report()
        counts = {k: v["count"] for k, v in rep.items()}
        nhours = end - beg + 1
        nsub = nhours * ML_NSUBSTEP
        check(counts == {"SWV": nhours, "LWV": nsub, "LBL": nsub,
                         "PHY": nsub, "MLC": nsub},
              f"(v1): phase counts {counts}")
        cpu_model, cpu_states, cpu_walls = runs["cpu"]
        newton = {dev: r[0].psy.soe.cumulative_newton_iterations
                  for dev, r in runs.items()}
        check(newton["cuda"] == newton["cpu"],
              f"(v1): psy Newton iterations {newton}")
        gaps = {h: ml_model_gap(states[h], cpu_states[h]) for h in states}
        for h, g in gaps.items():
            check(all(g[k] <= ML_CARD_CPU[k] for k in g),
                  f"(v1): card/CPU at hour {h}: {g} > {ML_CARD_CPU}")
        # restore the card's hour-(end - 1) checkpoint and go on
        bc = None
        for h in range(beg, end):
            bc = tml.synthetic_diurnal_bc(h, bc)
        restored = tml.MLModel(device="cuda")
        tag = f"{end - 1:03d}.{ML_NSUBSTEP}.bin"
        restored.initialize_from_checkpoint(
            f"{d}/cuda/mlc_checkpoint.{tag}",
            f"{d}/cuda/photosynthesis_checkpoint.{tag}",
            tml.synthetic_diurnal_bc(end, bc))
        restored.run(end, end, ML_NSUBSTEP)
        sync(torch)
        restore_gap = ml_model_gap(ml_model_state(restored), states[end])
        check(all(restore_gap[k] <= ML_CARD_CPU[k] for k in restore_gap),
              f"(v1): restored hour {end} vs the straight run: "
              f"{restore_gap} > {ML_CARD_CPU}")
    syncs = model.host_syncs / nsub
    steady = [h for h in walls if h > beg]
    print("ml_model " + json.dumps(dict(
        hours=[beg, end], nsubstep=ML_NSUBSTEP, dt=300.0, levels=NZ_ML,
        nveg=tml.NVEG, levels_with_plant_area=model.nzl, scm="medlyn",
        wall_s_by_hour=walls, ms_per_substep=sum(walls.values()) * 1e3
        / nsub,
        ms_per_substep_after_first_hour=sum(walls[h] for h in steady)
        * 1e3 / (len(steady) * ML_NSUBSTEP),
        phase_ms_per_call={k: v["mean_s"] * 1e3 for k, v in rep.items()},
        phase_share={k: v["total_s"] / sum(x["total_s"]
                                            for x in rep.values())
                     for k, v in rep.items()},
        phase_counts=counts, host_syncs_per_substep=syncs,
        timer_syncs=model.timers.host_syncs,
        psy_newton_iterations=newton["cuda"],
        mlc_gmres_iterations=model.mlc.cumulative_linear_iterations,
        cpu_ms_per_substep=sum(cpu_walls.values()) * 1e3 / nsub)))
    print("ml_model_card_vs_cpu " + json.dumps(dict(
        by_hour={h: gaps[h] for h in gaps}, bounds=ML_CARD_CPU,
        restored_vs_straight=restore_gap)))
    del runs, model, restored

    # (v2) run_mlc_problem at the reference namelists, serial and
    # compiled, card and CPU; the regression files card against CPU
    res = {}
    with tempfile.TemporaryDirectory() as d:
        for nc, nt in ((2, 1), (2, 2)):
            m = {(dev, comp): tmlc.run_mlc_problem(nc, nt, use_compiled=comp,
                                                  device=dev)
                 for dev in ("cuda", "cpu") for comp in (False, True)}
            tag = f"(v2) {nc}x{nt}"
            row = {}
            for comp in (False, True):
                its = [m[(dev, comp)].cumulative_linear_iterations
                       for dev in ("cuda", "cpu")]
                check(its[0] == its[1] > 0, f"{tag} compiled={comp}: GMRES "
                      f"iterations card {its[0]} CPU {its[1]}")
                row["compiled" if comp else "serial"] = dict(
                    gmres_iterations=its[0], card_vs_cpu_rel=rel_close(
                        f"{tag} compiled={comp}", m[("cuda", comp)].soln,
                        m[("cpu", comp)].soln, 1e-9))
            dcs = float(np.abs(m[("cuda", True)].soln
                               - m[("cuda", False)].soln).max())
            check(dcs <= 1e-10, f"{tag}: compiled vs serial {dcs:.3e} > "
                  "1e-10")
            row["compiled_vs_serial_abs"] = dcs
            files = [tmlc.output_regression(m[(dev, False)],
                                            f"{d}/mlc_{nc}x{nt}_{dev}", 6)
                     for dev in ("cuda", "cpu")]
            sec = [reg.parse_regression(open(f).read()) for f in files]
            check(list(sec[0]) == list(sec[1]) and all(
                list(sec[0][k]["values"]) == list(sec[1][k]["values"])
                for k in sec[0]), f"{tag}: regression sections differ")
            texts = [open(f).read() for f in files]
            worst = 0.0
            for k in sec[1]:
                a = np.array(list(sec[0][k]["values"].values()))
                b = np.array(list(sec[1][k]["values"].values()))
                worst = max(worst, rel_close(f"{tag} [{k}]", a, b, 1e-9))
            row["regression_identical_text"] = texts[0] == texts[1]
            row["regression_max_rel"] = worst
            res[f"{nc}x{nt}"] = row
    print("mlc_problem " + json.dumps(res))

    # (v3) CompiledMLC at the diurnal cell's width, f64
    dt = 300.0
    sync(torch)
    t0 = time.perf_counter()
    mpp = tmlc.run_mlc_problem(MLC_WIDE_NCAIR, 1, use_compiled=True,
                               device="cuda")
    sync(torch)
    build_s = time.perf_counter() - t0
    comp = mpp.soe.step_dt.__self__
    ILU_AT["mlc_compiled"] = comp._ilu
    c0 = (comp.gmres_cycles, comp._ilu.factors, comp._ilu.applies,
          comp.host_syncs)
    t0 = time.perf_counter()
    for istep in range(MLC_WIDE_STEPS):
        ok, _ = mpp.soe.step_dt(dt, istep + 2)
        check(ok, f"(v3): step {istep + 2} GMRES did not converge")
    sync(torch)
    ms = (time.perf_counter() - t0) * 1e3 / MLC_WIDE_STEPS
    c1 = (comp.gmres_cycles, comp._ilu.factors, comp._ilu.applies,
          comp.host_syncs)
    per = [(b - a) / MLC_WIDE_STEPS for a, b in zip(c0, c1)]
    # one more step, split: host PreSolve + staging, device assemble +
    # solve (CUDA events), download + host PostSolve
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    sync(torch)
    t0 = time.perf_counter()
    S, L = comp.stage(dt)
    sync(torch)
    t1 = time.perf_counter()
    ev[0].record()
    x, _, ok = comp.assemble_solve(S, L, dt)
    ev[1].record()
    sync(torch)
    t2 = time.perf_counter()
    mpp.soln_prev[:] = mpp.soln
    mpp.soln[:] = x.cpu().numpy()
    mpp.post_solve()
    t3 = time.perf_counter()
    T, q = mpp.at_T, mpp.av_q
    check(ok, "(v3): GMRES did not converge")
    check(np.isfinite(mpp.soln).all(), "(v3): state not finite")
    check(bool(((T > 270.0) & (T < 320.0)).all()),
          f"(v3): T_air outside (270, 320) K: {T.min()}, {T.max()}")
    check(bool(((q >= 0.0) & (q < 0.05)).all()),
          "(v3): q_air outside [0, 0.05)")
    row = dict(ncair=MLC_WIDE_NCAIR, ntree=1, unknowns=mpp.n,
               nnz=comp.template.nnz, ilu_levels=[comp._ilu.levels_fwd,
                                                  comp._ilu.levels_bwd],
               dtype="float64", build_s=build_s, steps=MLC_WIDE_STEPS,
               ms_per_step=ms, gmres_cycles_per_step=per[0],
               ilu_factors_per_step=per[1], ilu_applies_per_step=per[2],
               host_syncs_per_step=per[3],
               split_ms=dict(host_presolve_and_stage=(t1 - t0) * 1e3,
                             device_assemble_solve_events=ev[0]
                             .elapsed_time(ev[1]),
                             assemble_solve_host=(t2 - t1) * 1e3,
                             download_and_postsolve=(t3 - t2) * 1e3),
               T_air_K=[float(T.min()), float(T.max())])
    print("mlc_compiled " + json.dumps(row))
    busy = dict(cell="mlc_compiled", ncair=MLC_WIDE_NCAIR, dtype="float64",
                ms_per_step=ms)
    later(partial(mpp.soe.step_dt, dt), 1, busy, key="step_device_ms",
          count_key="device_activities_per_step", windows=2)

    launches = dict(hk.LAUNCHES)
    ilu_since(hk, "mlc", mark, only_ilu=True)
    print("launches_on_mlc_path " + json.dumps(dict(
        launches=launches, phase_s=time.perf_counter() - t_v)))
    return [busy]


def serial_steps(torch, run, device):
    """Run ``run(device)`` with every serial ``VSFMSoE.step_dt`` recorded:
    returns (its result, [(converged, reason, Newton iterations, linear
    iterations, host syncs, seconds, solution) per step])."""
    from mpp_tpu_torch.models.richards import VSFMSoE
    log = []
    real = VSFMSoE.step_dt

    def step_dt(self, dt, nstep=1):
        n0, l0 = (self.cumulative_newton_iterations,
                  self.cumulative_linear_iterations)
        s0, t0 = self.host_syncs, time.perf_counter()
        ok, reason = real(self, dt, nstep)
        sync(torch, str(self.device))
        log.append((bool(ok), int(reason),
                    self.cumulative_newton_iterations - n0,
                    self.cumulative_linear_iterations - l0,
                    self.host_syncs - s0, time.perf_counter() - t0,
                    np.array(self.soln, np.float64)))
        return ok, reason

    VSFMSoE.step_dt = step_dt
    try:
        out = run(device)
    finally:
        VSFMSoE.step_dt = real
    return out, log


def serial_cpu_log(name, runner, args, threads):
    """The step log of a (w2) problem's serial run on the CPU, in a worker
    process of its own (``threads`` intra-op threads)."""
    import importlib
    import torch
    torch.set_num_threads(threads)
    mod = importlib.import_module(f"mpp_tpu_torch.problems.{name}")
    return serial_steps(torch, lambda dev: getattr(mod, runner)(
        device=dev, **args), "cpu")[1]


def serial_card_vs_cpu(torch, label, run, card, cpu_log=None):
    """The serial SNES of ``run`` on the card and on the CPU (or the CPU's
    step log ``cpu_log``, taken elsewhere): equal convergence, reasons and
    iterations and the solution within SERIAL_RTOL at every step; returns
    (the card's result, the row)."""
    out, g = serial_steps(torch, run, "cuda")
    c = cpu_log if cpu_log is not None else serial_steps(torch, run,
                                                         "cpu")[1]
    check(len(g) == len(c) > 0, f"{label}: {len(g)} card steps, {len(c)} "
          f"CPU steps")
    rel = 0.0
    for k, (a, b) in enumerate(zip(g, c)):
        check(all(x[0] for x in (a, b)), f"{label}: step {k} diverged")
        check(a[:4] == b[:4], f"{label} step {k}: card (converged, reason,"
              f" newton, linear) {a[:4]} vs CPU {b[:4]}")
        rel = max(rel, card_vs_cpu(f"{label} step {k}", a[6], b[6],
                                   SERIAL_RTOL))
    nsteps = len(g)
    row = dict(problem=label, steps=nsteps,
               card_ms_per_step=sum(x[5] for x in g) * 1e3 / nsteps,
               cpu_ms_per_step=sum(x[5] for x in c) * 1e3 / nsteps,
               newton_per_step=[x[2] for x in g],
               linear_per_step=[x[3] for x in g],
               host_syncs_per_step=sum(x[4] for x in g) / nsteps,
               reasons=sorted({x[1] for x in g}),
               max_rel_card_vs_cpu=rel, card=card)
    return out, row


def run_serial(torch, hk, tridiag, card):
    """Phase (w): the serial SNES (Slice F) on the card against the CPU,
    the compiled option's kernels, the CLI.  Returns (the launches of
    the compiled celia1990 path, the kernel_check rows held at its
    shapes)."""
    import subprocess
    import tempfile
    from mpp_tpu_torch import cli
    from mpp_tpu_torch.io import regression as reg
    from mpp_tpu_torch.problems import vsfm_celia1990 as celia
    import importlib
    t_w = time.perf_counter()
    hk.reset_launches()
    mark = ilu_mark(hk)

    # (w1) celia1990 through the serial SNES, card and CPU
    w1 = W1_CELIA
    _, row = serial_card_vs_cpu(
        torch, "vsfm_celia1990", lambda dev: celia.run_vsfm_celia1990_problem(
            nz=w1["nz"], dtime=w1["dt"], nstep=w1["serial_steps"],
            device=dev), card)
    row.update(nz=w1["nz"], dt=w1["dt"], jax_default_steps=w1["ref_steps"],
               cut=f"{w1['serial_steps']} of {w1['ref_steps']} steps")
    print("serial_w1 " + json.dumps(row))
    ilu_since(hk, "celia1990_serial", mark, only_ilu=True,
              steps=w1["serial_steps"])

    # (w1) use_compiled=True: thomas and tridiag_spmv at [1, nz] f64,
    # counted, and held to their plain forms at the shapes they got
    captured = {}
    hk.reset_launches()
    t0 = time.perf_counter()
    mpp = celia.run_vsfm_celia1990_problem(nz=w1["nz"], dtime=w1["dt"],
                                           nstep=0, use_compiled=True,
                                           device="cuda")
    comp = mpp.soe.step_dt.__self__
    check(comp.is_tridiag, "(w1): celia1990 is not on the Thomas plan")
    from mpp_tpu_torch.constants import AuxVarKind, Var
    with captured_args(torch, comp, captured):
        for istep in range(1, w1["compiled_steps"] + 1):
            mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1,
                         np.full(1, 9.3991e4))
            mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 2,
                         np.full(1, 3.5355e3))
            ok, reason = mpp.soe.step_dt(w1["dt"], istep)
            check(ok, f"(w1) compiled step {istep}: reason {reason}")
        sync(torch)
    compiled_s = time.perf_counter() - t0
    compiled = dict(hk.LAUNCHES)
    check(compiled["thomas"] > 0 and compiled["tridiag_spmv"] > 0,
          f"(w1): the compiled path did not launch thomas / tridiag_spmv: "
          f"{compiled}")
    P = mpp.get_data(AuxVarKind.INTERNAL, Var.PRESSURE)
    check(np.isfinite(P).all() and 3.0e3 < P.min() and P.max() < 9.5e4,
          f"(w1) compiled: pressure outside its BCs [{P.min()}, {P.max()}]")
    rows = held_at_path(torch, hk, tridiag, captured, "vsfm_celia_compiled")
    print("serial_w1_compiled " + json.dumps(dict(
        steps=w1["compiled_steps"], nz=w1["nz"], wall_s=compiled_s,
        ms_per_step=compiled_s * 1e3 / w1["compiled_steps"],
        newton_iterations=mpp.soe.cumulative_newton_iterations,
        launches=compiled, card=card)))

    # (w3) starts first: the CLI on the card in its own process, on a
    # vsfm_mms namelist, while (w2) runs here
    here = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.TemporaryDirectory()
    d = tmp.name
    files = {}
    for device in ("cuda", "cpu"):
        os.makedirs(f"{d}/{device}")
        with open(f"{d}/{device}/vsfm_mms.namelist", "w") as f:
            f.write("&mpp_driver\n  problem_type = 'vsfm_mms'\n/\n"
                    "&regression_test\n  write_regression_output = .true.\n"
                    "  num_cells = 5\n/\n")
        files[device] = f"{d}/{device}/vsfm_mms.regression"
    t_cli = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "mpp_tpu_torch.cli", "-namelist",
         f"{d}/cuda/vsfm_mms.namelist"], cwd=d,
        env=dict(os.environ, PYTHONPATH=here), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        # (w2) the other eight VSFM problems, card and CPU: the CPU runs
        # in a worker process of its own while the card runs here, so its
        # ms per step are taken under that load
        hk.reset_launches()
        mark = ilu_mark(hk)
        t2 = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=W2_CPU_WORKERS,
                                 mp_context=ctx) as pool:
            jobs = {}
            for name, (runner, kw, ref_steps, steps) in W2_PROBLEMS.items():
                args = dict(kw, **({"nstep": steps} if steps else {}))
                jobs[name] = (args, pool.submit(serial_cpu_log, name, runner,
                                                args, W2_CPU_THREADS))
            for name, (runner, kw, ref_steps, steps) in W2_PROBLEMS.items():
                mod = importlib.import_module(
                    f"mpp_tpu_torch.problems.{name}")
                args, job = jobs[name]
                t0 = time.perf_counter()
                _, row = serial_card_vs_cpu(
                    torch, name, lambda dev: getattr(mod, runner)(
                        device=dev, **args), card, cpu_log=job.result())
                row["cpu_ms_per_step_under_card_load"] = \
                    row.pop("cpu_ms_per_step")
                row.update(jax_default_steps=ref_steps,
                           cut=(f"{steps} of {ref_steps} steps"
                                if steps and steps < ref_steps else None),
                           wall_s=time.perf_counter() - t0)
                print("serial_w2 " + json.dumps(row))
        t3 = time.perf_counter()
        # (w3) the card's file against the CPU CLI's, in this process
        out, err = proc.communicate(timeout=300)
        cli_s = time.perf_counter() - t_cli
        check(proc.returncode == 0, f"(w3): the CLI on the card exited "
              f"{proc.returncode}: {err[-2000:]}")
        check(cli.main(["-namelist", f"{d}/cpu/vsfm_mms.namelist",
                        "-device", "cpu"]) == 0, "(w3): the CPU CLI failed")
        sec = {dev: reg.parse_regression(open(f).read())
               for dev, f in files.items()}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        tmp.cleanup()
    check(list(sec["cuda"]) == list(sec["cpu"]) and sec["cpu"],
          "(w3): the regression files' sections differ")
    rel = 0.0
    for name, s_cpu in sec["cpu"].items():
        s_card = sec["cuda"][name]
        check(list(s_card["values"]) == list(s_cpu["values"]),
              f"(w3) {name}: the sampled cells differ")
        vc = np.array(list(s_card["values"].values()))
        vr = np.array(list(s_cpu["values"].values()))
        rel = max(rel, float(np.abs(vc - vr).max()
                             / max(np.abs(vr).max(), 1e-300)))
    check(rel <= SERIAL_RTOL, f"(w3): the card's regression file is "
          f"{rel:.3e} from the CPU's > {SERIAL_RTOL:g}")
    serial_launches = dict(hk.LAUNCHES)
    ilu_since(hk, "vsfm_serial_w2_w3", mark, only_ilu=True)
    phase_s = time.perf_counter() - t_w
    print("serial_w3 " + json.dumps(dict(
        problem="vsfm_mms", cli_process_s_beside_w2=cli_s,
        max_rel_card_vs_cpu=rel, card=card)))
    print("launches_on_serial_path " + json.dumps(dict(
        serial=serial_launches, compiled_celia=compiled,
        phase_s=dict(w1=t2 - t_w, w2=t3 - t2, w3=time.perf_counter() - t3,
                     total=phase_s), card=card)))
    check(phase_s < SERIAL_BUDGET_S, f"(w): {phase_s:.1f} s >= "
          f"{SERIAL_BUDGET_S:g} s")
    return compiled, rows


def th_spac_steps(torch, mpp, nsteps, dt):
    """``nsteps`` steps of a THSpacMPP: [(converged, reason, Newton
    iterations, GMRES iterations, host syncs, seconds, solution)]."""
    soe = mpp.soe
    log = []
    for istep in range(1, nsteps + 1):
        n0, l0, s0 = (soe.cumulative_newton_iterations,
                      soe.cumulative_linear_iterations, soe.host_syncs)
        t0 = time.perf_counter()
        ok, reason = soe.step_dt(dt, istep)
        sync(torch, str(soe.device))
        log.append((bool(ok), int(reason),
                    soe.cumulative_newton_iterations - n0,
                    soe.cumulative_linear_iterations - l0,
                    soe.host_syncs - s0, time.perf_counter() - t0,
                    np.array(soe.soln, np.float64)))
    return log


def th_spac_cpu_log(nsteps, dt, threads):
    """(x1)'s CPU half in a worker process of its own: the step log of
    th_manoli2014 at scale 1."""
    import torch
    from mpp_tpu_torch.problems import th_manoli2014 as tm
    torch.set_num_threads(threads)
    return th_spac_steps(torch, tm.build_th_manoli2014(device="cpu"),
                         nsteps, dt)


def th_spac_newton_solve(torch, soe, dt):
    """The linear solve of a THSpacSoE's first Newton iteration from its
    initial state at ``dt``, as ``_newton`` makes it (colored Jacobian,
    ILU(0), GMRES at rtol 1e-12): (GMRES iterations, converged, |J dx +
    F| / |F|, seconds, dx as numpy)."""
    from mpp_tpu_torch.ops.ilu import csr_matvec, petsc_gmres
    dev = torch.device(soe.device)
    X = torch.as_tensor(soe.soln, dtype=torch.float64, device=dev)
    am, ae = soe._accums(X, dt)
    res = partial(soe._residual_pure, accum_prev_m=am, accum_prev_e=ae,
                  dt=dt)
    tpl, ilu = soe._jac_plan["tpl"], soe._jac_plan["ilu"]
    sync(torch, str(dev))
    t0 = time.perf_counter()
    F = res(X)
    data = soe._sparse_jac_data(res, X)
    dx, its, ok = petsc_gmres(tpl.indptr, tpl.indices, data, -F, pc=ilu,
                              pc_data=ilu.factor(data), rtol=1e-12,
                              atol=1e-50)
    sync(torch, str(dev))
    secs = time.perf_counter() - t0
    r = csr_matvec(tpl.indptr, tpl.indices, data, dx) + F
    return (its, ok, float(r.norm() / F.norm()), secs,
            dx.cpu().numpy())


def th_spac_cpu_solve(scale, dt, threads):
    """(x1)'s scale-10 linear solve on the CPU, in the worker process."""
    import torch
    from mpp_tpu_torch.problems import th_manoli2014 as tm
    torch.set_num_threads(threads)
    return th_spac_newton_solve(
        torch, tm.build_th_manoli2014(scale=scale, device="cpu").soe, dt)


def run_th_spac(torch, hk, card, pool):
    """Phase (x1): th_manoli2014 at its reference size on the card against
    the CPU (run in ``pool``'s worker meanwhile), its conservation, its
    colored Jacobian against torch.func.jacfwd on the card, and at scale 10
    one Newton iteration's linear solve, card against CPU.  Returns the
    rows."""
    from mpp_tpu_torch.problems import th_manoli2014 as tm
    x1 = X1_TH_SPAC
    job = pool.submit(th_spac_cpu_log, x1["steps"], x1["dt"],
                      W2_CPU_THREADS)
    mpp = tm.build_th_manoli2014(device="cuda")
    soe = mpp.soe
    m0, e0 = soe.totals(soe.soln)
    mark = ilu_mark(hk)
    g = th_spac_steps(torch, mpp, x1["steps"], x1["dt"])
    ilu_since(hk, "th_manoli2014", mark, only_ilu=True, steps=x1["steps"],
              instance=(soe._jac_plan["ilu"].batched, 0, 0))
    c = job.result()
    rel = 0.0
    for k, (a, b) in enumerate(zip(g, c)):
        check(a[0] and b[0], f"(x1) step {k + 1}: did not converge")
        check(a[1:4] == b[1:4], f"(x1) step {k + 1}: card (reason, newton, "
              f"gmres) {a[1:4]} vs CPU {b[1:4]}")
        rel = max(rel, card_vs_cpu(f"(x1) step {k + 1}", a[6], b[6],
                                   SERIAL_RTOL))
    m1, e1 = soe.totals(soe.soln)
    check(abs(m1 - m0) <= 1e-12 * m0 and abs(e1 - e0) <= 1e-12 * abs(e0),
          f"(x1): mass {m0!r} -> {m1!r}, energy {e0!r} -> {e1!r}")
    dT = float(np.max(np.abs(soe.soln[soe.ntot:] - tm.TEMP_INITIAL)))
    check(0.0 < dT < 0.01, f"(x1): max |T - {tm.TEMP_INITIAL}| {dT:.3e} K")
    ncolors = soe._jac_plan["ncolors"]
    check(ncolors == 12, f"(x1): {ncolors} colors, not 12")

    # the colored Jacobian on the card against the dense forward-mode one
    fresh = tm.build_th_manoli2014(device="cuda").soe
    X = torch.as_tensor(fresh.soln, dtype=torch.float64, device="cuda")
    am, ae = fresh._accums(X, x1["dt"])
    res = partial(fresh._residual_pure, accum_prev_m=am, accum_prev_e=ae,
                  dt=x1["dt"])
    data = fresh._sparse_jac_data(res, X)
    tpl = fresh._jac_plan["tpl"]
    J = torch.func.jacfwd(res)(X)
    rows = torch.as_tensor(tpl.row_ids().astype(np.int64), device="cuda")
    cols = torch.as_tensor(tpl.indices.astype(np.int64), device="cuda")
    scale = float(J.abs().max())
    jac_err = float((J[rows, cols] - data).abs().max())
    outside = J.clone()
    outside[rows, cols] = 0.0
    check(jac_err <= 1e-12 * scale and float(outside.abs().max()) == 0.0,
          f"(x1): colored Jacobian vs jacfwd {jac_err:.3e} of {scale:.3e}")
    # scale 10: 5000 unknowns; one Newton iteration's linear solve on the
    # card against the worker's
    big = x1["big_scale"]
    job = pool.submit(th_spac_cpu_solve, big, x1["dt"], W2_CPU_THREADS)
    bs = tm.build_th_manoli2014(scale=big, device="cuda").soe
    mark = ilu_mark(hk)
    gs = th_spac_newton_solve(torch, bs, x1["dt"])
    ilu_since(hk, "th_manoli2014_x10_solve", mark, only_ilu=True)
    cs = job.result()
    check(gs[1] and cs[1], f"(x1) scale {big}: GMRES did not converge")
    check(gs[0] == cs[0], f"(x1) scale {big}: GMRES iterations card "
          f"{gs[0]} vs CPU {cs[0]}")
    check(gs[2] <= 1e-9, f"(x1) scale {big}: |J dx + F| / |F| {gs[2]:.3e}")
    # the two directions are converged GMRES solves: held against the
    # largest entry (near-zero entries carry the solve's absolute error)
    big_rel = float(np.abs(gs[4] - cs[4]).max() / np.abs(cs[4]).max())
    check(big_rel <= SERIAL_RTOL, f"(x1) scale {big}: direction card vs "
          f"CPU {big_rel:.3e} of max |dx|")
    n = len(g)
    levels = lambda s_: [s_._jac_plan["ilu"].batched.levels_fwd,
                         s_._jac_plan["ilu"].batched.levels_bwd]
    out = [dict(
        problem="th_manoli2014", scale=1, unknowns=2 * soe.ntot,
        ncolors=ncolors, steps=n, dt=x1["dt"],
        card_ms_per_step=sum(x[5] for x in g) * 1e3 / n,
        cpu_ms_per_step=sum(x[5] for x in c) * 1e3 / n,
        newton_per_step=[x[2] for x in g], gmres_per_step=[x[3] for x in g],
        host_syncs_per_step=sum(x[4] for x in g) / n,
        ilu_levels=levels(soe), max_rel_card_vs_cpu=rel,
        mass_rel=abs(m1 - m0) / m0, energy_rel=abs(e1 - e0) / abs(e0),
        max_abs_dT_K=dT, jacfwd_err_of_max=jac_err / scale, card=card),
        dict(problem="th_manoli2014", scale=big, unknowns=2 * bs.ntot,
             ncolors=bs._jac_plan["ncolors"], steps=0,
             newton_linear_solve=dict(
                 gmres_iterations=gs[0], card_ms=gs[3] * 1e3,
                 cpu_ms=cs[3] * 1e3, true_rel_residual=gs[2],
                 max_rel_card_vs_cpu=big_rel),
             ilu_levels=levels(bs), card=card)]
    for r in out:
        print("th_spac " + json.dumps(r))
    return out


def ugdm_problem(alm, device_mesh=None):
    """(x2)'s problem: the 128 x 128 grid of columns with (d)'s soils, the
    wet first half, no forcing and no seepage (a closed domain); on the
    card, or on ``device_mesh``'s rank device."""
    from mpp_tpu_torch.parallel.ugrid import UGrid
    x2 = X2_UGDM
    ug = UGrid.regular_2d(x2["nx"], x2["ny"])
    ug.edge_dist[:] = x2["edge"]
    ug.edge_area[:] = x2["edge"]
    ncol = ug.ncol
    soils, _ = alm_inputs(ncol, NZ)
    soils.pop("include_seepage_bc")
    P0 = soils.pop("P0")
    P0[:ncol // 2] = x2["wet"]
    return alm.alm_vsfm_initialize(P0=P0, lateral_connectivity=True,
                                   ugrid=ug, device="cuda",
                                   device_mesh=device_mesh, **soils)


def ugdm_steps(torch, hk, alm, prob, captured=None):
    """(x2)'s steps on ``prob``: one warm step, then the timed steps with
    the launch counters reset just before and read just after them (the
    stepper's solve / J.Y hooks record their first arguments in
    ``captured``).  Returns (the outputs, ms a step, the launches)."""
    x2 = X2_UGDM
    outs = [alm.alm_vsfm_solve(prob, x2["dt"])]
    with (captured_args(torch, prob.comp, captured)
          if captured is not None else contextlib.nullcontext()):
        sync(torch)
        hk.reset_launches()
        t0 = time.perf_counter()
        for _ in range(x2["steps"]):
            outs.append(alm.alm_vsfm_solve(prob, x2["dt"]))
        sync(torch)
        ms = (time.perf_counter() - t0) * 1e3 / x2["steps"]
        launches = dict(hk.LAUNCHES)
    return outs, ms, launches


def run_ugdm(torch, hk, tridiag, alm, card, alm_row):
    """Phases (x2) and (x3): the UGDM lateral ALM step at full width in one
    process, then through a ColumnGroup at world size 1 under NCCL.
    Returns (the launches of (x2) and of (x3), the kernel_check rows of
    (x2)'s thomas and tridiag_spmv)."""
    import tempfile
    import torch.distributed as dist
    from mpp_tpu_torch.parallel import distributed as pdist
    from mpp_tpu_torch.parallel.ugrid import lateral_darcy_source_global
    x2 = X2_UGDM
    t0 = time.perf_counter()
    prob = ugdm_problem(alm)
    setup_s = time.perf_counter() - t0
    ncol = prob.ncol
    P0 = prob.P
    m0 = float(alm.cell_mass_kg(prob, P0).sum())
    # the step's lateral source against the natural-order reference
    dm, ug = prob.ugdm, prob.ugrid
    src = dm.sharded_to_natural(alm._lateral_source(prob, P0))
    nat = lambda a: dm.sharded_to_natural(a)
    ref = lateral_darcy_source_global(
        ug, nat(P0), nat(alm._cell_kr(prob, P0)),
        nat(prob.dyn[0]["perm"][..., 0]),
        nat(torch.as_tensor(prob.dz, dtype=torch.float64, device="cuda")))
    src_err = float((src - ref).abs().max()) / float(ref.abs().max())
    check(src_err <= 1e-12, f"(x2): lateral source vs the natural-order "
          f"reference {src_err:.3e} > 1e-12")
    captured = {}
    outs, ms, launches = ugdm_steps(torch, hk, alm, prob, captured)
    m1 = float(alm.cell_mass_kg(prob, prob.P).sum())
    sums = []
    for o in outs:
        q = o["qflx_lateral"]
        net, gross = float(q.sum()), float(q.abs().sum())
        sums.append([net, gross])
        check(gross > 0 and abs(net) < 1e-10 * gross,
              f"(x2): sum qflx_lateral {net:.3e} vs sum |.| {gross:.3e}")
        check(bool((o["reason"] > 0).all()), "(x2): a column did not "
              "converge")
        check(o["abs_mass_error_col"] < F64_AUDIT_KG,
              f"(x2): audit error {o['abs_mass_error_col']:.3e} kg")
    check(abs(m1 - m0) <= 1e-6 * m0, f"(x2): total water {m0!r} -> {m1!r}")
    check(launches["thomas"] > 0 and launches["tridiag_spmv"] > 0,
          f"(x2): the UGDM step did not launch its kernels: {launches}")
    rows = held_at_path(torch, hk, tridiag, captured, "alm_ugdm")
    timed = outs[1:]
    print("ugdm " + json.dumps(dict(
        grid=[x2["nx"], x2["ny"]], ncol=ncol, nz=NZ, dt=x2["dt"],
        edges=int(ug.edges.shape[0]), setup_s=setup_s, ms_per_step=ms,
        host_syncs_per_step=[o["host_round_trips_per_step"] for o in timed],
        newton_iters_per_step=[o["newton_iters"] for o in timed],
        max_audit_err_kg=max(o["abs_mass_error_col"] for o in outs),
        mass_kg=[m0, m1], qflx_lateral_net_gross=sums,
        lateral_src_rel_err=src_err, launches=launches,
        alm_d_ms_per_step=alm_row["ms"],
        alm_d_host_syncs_per_step=alm_row["syncs"], card=card)))

    # (x3): the same steps through a ColumnGroup at world size 1 (NCCL)
    store = tempfile.TemporaryDirectory()
    t0 = time.perf_counter()
    pdist.initialize_distributed(init_method=f"file://{store.name}/store",
                                 world_size=1, rank=0, backend="nccl",
                                 timeout_s=120.0)
    try:
        group = pdist.global_column_mesh()
        check(dist.get_backend() == "nccl" and group.world_size == 1
              and group.device.type == "cuda",
              f"(x3): group {group} on {dist.get_backend()}")
        gprob = ugdm_problem(alm, device_mesh=group)
        check(gprob.group is group and gprob.P.device == group.device,
              "(x3): the problem is not on the group")
        gouts, gms, glaunches = ugdm_steps(torch, hk, alm, gprob)
        gap = float(((gprob.P - prob.P).abs() / prob.P.abs()).max())
        check(gap <= 1e-12, f"(x3): NCCL group vs one process: max rel "
              f"{gap:.3e} > 1e-12")
        check(glaunches["thomas"] > 0 and glaunches["tridiag_spmv"] > 0,
              f"(x3): the group step did not launch its kernels: "
              f"{glaunches}")
        print("ugdm_nccl " + json.dumps(dict(
            backend=dist.get_backend(), world_size=group.world_size,
            device=str(group.device), ms_per_step=gms,
            host_syncs_per_step=[o["host_round_trips_per_step"]
                                 for o in gouts[1:]],
            max_rel_vs_one_process=gap, launches=glaunches,
            phase_s=time.perf_counter() - t0, card=card)))
    finally:
        dist.destroy_process_group()
        store.cleanup()
    return launches, glaunches, rows


def run_small_modules(torch, card):
    """Phase (x4): the MLC bridge and the Krylov solvers on the card."""
    import copy
    from mpp_tpu_torch.batched import mlc as bmlc
    from mpp_tpu_torch.ops import krylov
    from mpp_tpu_torch.problems.mlc import run_mlc_problem
    dt = 300.0
    for ncair, ntree, compiled in X4_MLC_CASES:
        t0 = time.perf_counter()
        mpp = run_mlc_problem(ncair, ntree, use_compiled=compiled,
                              device="cuda")
        mpp.dtime = dt
        mpp._vol_air = mpp._compute_vol_air()
        mpp.pre_solve()
        inp = bmlc.inputs_from_mpp(mpp)
        check(inp.at_T.device.type == "cuda", "(x4): inputs not on the card")
        x_card = bmlc.step(inp, dt).cpu().numpy()
        x_cpu = bmlc.step(bmlc.inputs_from_mpp(mpp, device="cpu"),
                          dt).numpy()
        rel = float(np.abs(x_card - x_cpu).max() / np.abs(x_cpu).max())
        check(np.isfinite(x_card).all() and rel <= 1e-9,
              f"(x4) mlc {ncair}x{ntree}: card vs CPU {rel:.3e} of max |x|")
        # the block solution in the serial MPP's own system
        rows, cols, vals = mpp.compute_operators()
        b = mpp.compute_rhs()
        nc, nlev, nt = mpp.ncair, mpp.nlev, mpp.ntree
        o = mpp.off
        g = np.zeros((nc, nlev, 2 + 2 * nt), np.int64)
        base = np.arange(nc)[:, None] * nlev + np.arange(nlev)[None, :]
        g[:, :, 0] = o[0] + base
        g[:, :, 1] = o[1] + base
        for s in range(2 * nt):
            r, it = divmod(s, nt)
            g[:, :, 2 + s] = o[2 + r] + (np.arange(nc)[:, None] * nt + it) \
                * nlev + np.arange(nlev)[None, :]
        x = np.zeros(mpp.n)
        x[g.reshape(-1)] = x_card.reshape(-1)
        Ax = np.zeros(mpp.n)
        np.add.at(Ax, rows, vals * x[cols])
        resid = float(np.linalg.norm(Ax - b) / np.linalg.norm(b))
        check(resid <= 1e-9, f"(x4) mlc {ncair}x{ntree}: block solution's "
              f"relative residual {resid:.3e} in the serial system > 1e-9")
        row = dict(ncair=ncair, ntree=ntree, unknowns=mpp.n,
                   max_rel_card_vs_cpu=rel, serial_system_rel_residual=resid)
        if not compiled:
            A = np.zeros((mpp.n, mpp.n))
            np.add.at(A, (rows, cols), vals)
            x_exact = np.linalg.solve(A, b)
            err = float(np.max(np.abs(x - x_exact)
                               / (1e-9 * np.abs(x_exact) + 1e-11)))
            check(err <= 1.0, f"(x4) mlc {ncair}x{ntree}: block solution "
                  "vs the dense solve outside rtol 1e-9 / atol 1e-11")
            step = copy.deepcopy(mpp)
            step.step_dt(dt)
            gap = float(np.max(np.abs(x - step.soln)))
            check(np.allclose(x, step.soln, rtol=1e-5, atol=5e-3),
                  f"(x4) mlc {ncair}x{ntree}: block solution vs the serial "
                  f"GMRES step {gap:.3e} K")
            row.update(vs_serial_gmres_step_max_abs=gap)
        row.update(wall_s=time.perf_counter() - t0, card=card)
        print("mlc_bridge " + json.dumps(row))

    rng = np.random.default_rng(0)
    n = X4_KRYLOV_N
    a = rng.standard_normal((n, n)) * 0.1
    systems = {"spd": a @ a.T + n * 0.05 * np.eye(n),
               "nonsym": np.eye(n) * 4.0 + rng.standard_normal((n, n)) * 0.1}
    b = rng.standard_normal(n)
    for name, solver in (("spd", "cg"), ("spd", "bicgstab"),
                         ("spd", "gmres"), ("nonsym", "bicgstab"),
                         ("nonsym", "gmres")):
        res = {}
        for dev in ("cuda", "cpu"):
            A = torch.as_tensor(systems[name], device=dev)
            t0 = time.perf_counter()
            r = getattr(krylov, solver)(lambda v: A @ v,
                                        torch.as_tensor(b, device=dev))
            sync(torch, dev)
            res[dev] = (r, (time.perf_counter() - t0) * 1e3)
        (rg, ms_g), (rc, ms_c) = res["cuda"], res["cpu"]
        check(rg.converged and rc.converged, f"(x4) {solver} {name}: not "
              "converged")
        check(rg.iters == rc.iters, f"(x4) {solver} {name}: {rg.iters} "
              f"iterations on the card, {rc.iters} on the CPU")
        err = float((rg.x.cpu() - rc.x).abs().max())
        check(err <= 1e-10, f"(x4) {solver} {name}: card vs CPU {err:.3e}")
        print("krylov " + json.dumps(dict(
            solver=solver, system=name, n=n, iters=rg.iters,
            host_syncs=rg.host_syncs, max_abs_card_vs_cpu=err,
            card_ms=ms_g, cpu_ms=ms_c, card=card)))


def run_slices_f2_g(torch, hk, tridiag, alm, card, alm_row):
    """Phase (x): (x1)-(x4), under X_BUDGET_S.  Returns (the launches of
    (x2) and (x3), (x2)'s kernel_check rows)."""
    t_x = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=1, mp_context=ctx) as pool:
        run_th_spac(torch, hk, card, pool)
    t1 = time.perf_counter()
    hk.reset_launches()
    l2, l3, rows = run_ugdm(torch, hk, tridiag, alm, card, alm_row)
    t2 = time.perf_counter()
    hk.reset_launches()
    mark = ilu_mark(hk)
    run_small_modules(torch, card)
    ilu_since(hk, "mlc_bridge_krylov", mark, only_ilu=True, required=False,
              also=("block_thomas_small",))
    # one block solve on the card a bridge case
    BTS_BY_PATH["mlc_bridge_x4"] = bts_count(hk, "(x4)", 0,
                                             len(X4_MLC_CASES))
    phase_s = time.perf_counter() - t_x
    print("slices_f2_g_phase_s " + json.dumps(dict(
        x1=t1 - t_x, x2_x3=t2 - t1, x4=time.perf_counter() - t2,
        total=phase_s, card=card)))
    check(phase_s <= X_BUDGET_S, f"(x): {phase_s:.1f} s > {X_BUDGET_S:g} s")
    return l2, l3, rows


def ilu_systems(ilu, B, seed):
    """Random systems on ``ilu``'s sparsity (numpy seed): off-diagonals in
    [-1, -0.05), diagonals 1.05-2 times one plus the row's off-diagonal
    sum (M-matrices like the paths' Jacobians; a row with no off-diagonal,
    as the MLC has, gets a diagonal of 1.05-2); returns (data [B, nnz], b
    [B, n]) in f64."""
    rows = np.repeat(np.arange(ilu.n), np.diff(ilu.indptr))
    rng = np.random.default_rng(seed)
    data = -rng.uniform(0.05, 1.0, (B, ilu.nnz))
    diag = rows == ilu.indices
    dsum = np.add.reduceat(np.where(diag, 0.0, data), ilu.indptr[:-1],
                           axis=1)
    data[:, diag] = (1.0 - dsum) * rng.uniform(1.05, 2.0, (B, ilu.n))
    return data, rng.standard_normal((B, ilu.n))


def ilu_work(name, ilu, B, elem):
    """(bytes, operations) of one call: the values read once and written
    once, and the sparsity read once as an int32 CSR (indptr and indices),
    whatever program a kernel walks; a multiplier is a division, a pair a
    multiply and a subtract, an off-diagonal term of a sweep a multiply
    and an add, a row one subtract (and in the back sweep a divide)."""
    s = ilu.schedule
    csr = 4 * (ilu.n + 1 + ilu.nnz)
    if name == "ilu0_factor":
        return (2 * B * ilu.nnz * elem + csr,
                B * (s.ptrs["lp_ptr"][-1] + 2 * s.ptrs["pair_ptr"][-1]))
    return (B * (ilu.nnz + 2 * ilu.n) * elem + csr,
            B * (2 * (ilu.nnz - ilu.n) + s.ptrs["f_row_ptr"][-1]
                 + 2 * ilu.n))


def ilu_form(plan):
    """The form a kernel launch takes (ILU_FORMS)."""
    if plan["form"] == "streamed":
        return "streamed_spilled" if plan["spill"] else "streamed"
    return "warp" if plan["lanes"] == 32 else "systems_a_warp"


def ilu_pattern(rows, cols):
    """A BatchedILU0 on the pattern of (rows, cols) (diagonal included)."""
    from mpp_tpu_torch.batched.ilu_gmres import BatchedILU0
    from mpp_tpu_torch.ops.sparse import csr_template
    r, c = np.concatenate(rows), np.concatenate(cols)
    n = int(max(r.max(), c.max())) + 1
    t = csr_template(n, n, r, c)
    return BatchedILU0(t.indptr, t.indices)


def ilu_block_diagonal(nblocks):
    """``nblocks`` dense 2x2 diagonal blocks: ``nblocks`` components."""
    k = np.arange(4 * nblocks)
    return ilu_pattern([2 * (k // 4) + (k % 4) // 2], [2 * (k // 4) + k % 2])


def ilu_tridiagonal(n):
    k = np.arange(n)
    return ilu_pattern([k, k[1:], k[:-1]], [k, k[:-1], k[1:]])


def ilu_comb(width, length):
    """``width`` chains of ``length`` rows (position p of chain c at row
    p * width + c) and a hub row joined to every chain's end: every level
    of either sweep ``width`` rows wide."""
    ids = np.arange(width * length).reshape(length, width)
    hub = width * length
    d, last = np.arange(hub + 1), ids[-1]
    return ilu_pattern([d, ids[:-1].ravel(), ids[1:].ravel(), last,
                        np.full(width, hub)],
                       [d, ids[1:].ravel(), ids[:-1].ravel(),
                        np.full(width, hub), last])


def ilu_arrow_chain(side):
    """Row 0 a root, rows 1..side on it, rows side+1..2 side a chain whose
    j-th row is joined to side row j: every side row's diagonal is updated
    at the first step and read at chain level j, so ~side slots stay live
    throughout the factor."""
    a = np.arange(1, side + 1)
    c = a + side
    d, z = np.arange(2 * side + 1), np.zeros(side, np.int64)
    return ilu_pattern([d, z, a, a, c, c[:-1], c[1:]],
                       [d, a, z, c, a, c[1:], c[:-1]])


def ilu_staged_top(hk, kind, dtype, cache):
    """The largest n whose tridiagonal system ``kind`` ("factor" /
    "apply") stages whole in ``dtype`` at ILU_EDGE_B systems: the rule's
    edge (bisection on ILU0Schedule.plan; ``cache`` keeps the systems)."""
    lim, elem = hk.ilu0_limits(dtype), dtype.itemsize

    def staged(n):
        if n not in cache:
            cache[n] = ilu_tridiagonal(n)
        return cache[n].schedule.plan(kind, elem, ILU_EDGE_B,
                                      lim)["form"] == "staged"
    # start from the line through one system's shared memory at n = 512
    # and 1024
    smem = []
    for n in (512, 1024):
        plan = cache.setdefault(n, ilu_tridiagonal(n)).schedule.plan(
            kind, elem, ILU_EDGE_B, lim)
        smem.append(plan["smem"] - (plan["systems"] - 1)
                    * plan["program"]["stride"] * elem)
    slope = (smem[1] - smem[0]) / 512
    est = int(512 + (lim["staged_bytes"] - smem[0]) / slope)
    lo, hi = est - 4, est + 4
    while not staged(lo):
        lo, hi = lo // 2, lo
    while staged(hi):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if staged(mid) else (lo, mid)
    return lo


def ilu_triangular_csr(torch, f, ilu):
    """The B systems' L (its unit diagonal stored) and U as block-diagonal
    CSR matrices [B n, B n] on ``f``'s device, from the factor values ``f
    [B, nnz]`` (the library yardstick's operands; the port never uses
    them)."""
    B, n = f.shape[0], ilu.n
    rows = np.repeat(np.arange(n), np.diff(ilu.indptr))
    off = (np.arange(B) * n)[:, None]

    def csr(mask, unit):
        slots = np.nonzero(mask)[0]
        r, c = rows[slots], ilu.indices[slots]
        vals = f[:, torch.as_tensor(slots, device=f.device)]
        if unit:
            r, c = np.r_[r, np.arange(n)], np.r_[c, np.arange(n)]
            vals = torch.cat([vals, vals.new_ones(B, n)], 1)
        order = np.lexsort((c, r))
        vals = vals[:, torch.as_tensor(order, device=f.device)]
        crow = np.r_[0, np.cumsum(np.tile(np.bincount(r, minlength=n), B))]
        cols = (c[order][None, :] + off).ravel()
        return torch.sparse_csr_tensor(
            torch.as_tensor(crow, dtype=torch.int32, device=f.device),
            torch.as_tensor(cols, dtype=torch.int32, device=f.device),
            vals.reshape(-1), (B * n, B * n))
    return (csr(ilu.indices < rows, True), csr(ilu.indices >= rows, False))


def ilu_library_apply(torch, L, U, b):
    """(LU)^-1 b by two torch.triangular_solve calls on the block-diagonal
    CSR factors (cuSPARSE's sparse triangular solve on the card): the
    apply's library yardstick."""
    y = torch.triangular_solve(b.reshape(-1, 1), L, upper=False,
                               unitriangular=True).solution
    return torch.triangular_solve(y, U, upper=True).solution.reshape(b.shape)


def ilu_case(torch, hk, path, ilu, B, dt_name, cold=False, skew=False,
             library=False):
    """Phase (y) at one shape: ilu0_factor against its plain form bit for
    bit, ilu0_apply (on the kernel's factor) within TOLS; both timed
    (``ms``, CUDA events back to back; with ``cold`` also ``ms_cold`` and
    ``device_ms_cold``, the L2 flushed before each call), their plain
    forms timed, their device time queued; with ``library`` the apply's
    library yardstick (ilu_library_apply) held to the plain form within
    TOLS and timed the same way.  Returns the two rows (each with its
    launch's form, lanes, systems a block and parts)."""
    dtype = getattr(torch, dt_name)
    data_np, b_np = ilu_systems(ilu, B, seed=B + ilu.n)
    data, b = (torch.as_tensor(a, dtype=dtype, device="cuda")
               for a in (data_np, b_np))
    if skew:
        data, b = misaligned(torch, data), misaligned(torch, b)
    sched = ilu.schedule
    label = f"{path} {[B, ilu.n]} {dt_name}{' misaligned' if skew else ''}"
    f = hk.ilu0_factor(data, sched)
    fp, fp_ms = time_once(torch, partial(hk.ilu0_factor_plain, data, sched))
    err_f, scale_f = hold(torch, f"ilu0_factor {label}", f, fp, 0)
    if skew:
        f = misaligned(torch, f)
    tol = TOLS["ilu0_apply"][dt_name]
    xp, xp_ms = time_once(torch, partial(hk.ilu0_apply_plain, f, b, sched))
    err_x, scale_x = hold(torch, f"ilu0_apply {label}",
                          hk.ilu0_apply(f, b, sched), xp, tol)
    # a plain form of over 10^5 values or 1000 levels is timed once (the
    # call held above), as a kernel's comparison, not a yardstick
    big = ilu.n * B > 10 ** 5 or ilu.levels_fwd > 1000
    lim = hk.ilu0_limits(dtype)
    rows = []
    for name, args, err, scale, rtol, once_ms in (
            ("ilu0_factor", (data, sched), err_f, scale_f, 0, fp_ms),
            ("ilu0_apply", (f, b, sched), err_x, scale_x, tol, xp_ms)):
        kern = partial(getattr(hk, name), *args)
        plain = partial(getattr(hk, name + "_plain"), *args)
        plan = sched.plan(name[5:], data.element_size(), B, lim)
        nbytes, ops = ilu_work(name, ilu, B, data.element_size())
        bms, by = bound(nbytes, ops, dt_name)
        row = dict(kernel=name, path=path, shape=[B, ilu.n], nnz=ilu.nnz,
                   dtype=dt_name, misaligned=skew,
                   levels=[ilu.levels_fwd, ilu.levels_bwd],
                   factor_steps=int(sched.factor[0]),
                   form=ilu_form(plan), lanes=plan["lanes"],
                   systems_a_block=plan["systems"],
                   threads=plan["threads"], parts=len(sched.parts),
                   components=sched.ncomponents, smem=plan["smem"],
                   max_abs_err=err, max_abs_x=scale, rel_tol=rtol,
                   bitwise=rtol == 0, ms=time_cuda(torch, kern, 10),
                   plain_ms=once_ms if big else time_cuda(torch, plain, 3),
                   library_ms=None, library_device_ms=None, bytes=nbytes,
                   ops=ops, bound_ms=bms, bound_by=by)
        if cold:
            flush = l2_flusher(torch)
            row["ms_cold"] = time_cold(torch, kern, 10, flush)
            later(cold_call(flush, kern), 10, row, key="device_ms_cold",
                  exclude=FLUSH_ACTIVITY)
        later(kern, 10, row)
        rows.append(row)
    if library:
        L, U = ilu_triangular_csr(torch, f, ilu)
        call = partial(ilu_library_apply, torch, L, U, b)
        hold(torch, f"library apply {label}", call(), xp, tol)
        rows[1]["library_ms"] = time_cuda(torch, call, 10)
        later(call, 10, rows[1], key="library_device_ms")
    return rows


def ilu_kernel_checks(torch, hk):
    """Phase (y): both ILU(0) kernels against their plain forms on the
    card at the paths' sparsities (with the apply's library yardstick) and
    at the edges of every form, f64 and f32; fails unless the edges reach
    every form of ILU_FORMS in each dtype and a batch no systems-a-block
    count divides.  Returns (the kernel_check rows, the kernels line's
    entries: (q)'s shape in f64, L2-cold)."""
    from mpp_tpu_torch.problems import th_manoli2014 as tm

    def manoli(scale):
        soe = tm.build_th_manoli2014(scale=scale, device="cpu").soe
        soe._build_jac_plan()
        return soe._jac_plan["ilu"].batched
    ILU_AT.update(celia1990=ilu_tridiagonal(W1_CELIA["nz"]),
                  th_manoli2014=manoli(1),
                  th_manoli2014_x10=manoli(X1_TH_SPAC["big_scale"]))
    t0 = time.perf_counter()
    rows, results = [], {}
    for path, B, cold in ILU_PATHS:
        for dt_name in ("float64", "float32"):
            got = ilu_case(torch, hk, path, ILU_AT[path], B, dt_name, cold,
                           library=True)
            rows += got
            if path == "th_petsc" and dt_name == "float64":
                results = {r["kernel"]: r for r in got}
    t1 = time.perf_counter()
    arrow = ilu_arrow_chain(ILU_ARROW_SIDE)
    arrow_streamed = ilu_arrow_chain(ILU_ARROW_SIDE_STREAMED)
    combs = {w: ilu_comb(w, ILU_COMB["length"]) for w in (32, 33)}
    t2 = time.perf_counter()
    tri, q = {}, ILU_AT["th_petsc"]
    for dt_name in ("float64", "float32"):
        dtype = getattr(torch, dt_name)
        lim, elem = hk.ilu0_limits(dtype), dtype.itemsize
        # a batch of (q)'s column that neither kernel's block count divides
        ks = [q.schedule.plan(k, elem, TH_NCOL, lim)["systems"]
              for k in ("factor", "apply")]
        odd = 3 * ks[0] * ks[1] + 1
        edges = [("edge_comb_32", combs[32], ILU_COMB["B"], False),
                 ("edge_comb_33", combs[33], ILU_COMB["B"], False),
                 ("edge_batch_remainder", q, odd, False),
                 ("edge_many_parts", ilu_block_diagonal(ILU_WIDE["blocks"]),
                  ILU_WIDE["B"], False),
                 ("edge_streamed", arrow_streamed, ILU_EDGE_B, False),
                 ("edge_spilled", arrow, ILU_EDGE_B, False),
                 ("edge_misaligned", q, ILU_SKEWED_B, True)]
        for kind in ("factor", "apply"):
            top = ilu_staged_top(hk, kind, dtype, tri)
            edges += [(f"edge_{kind}_staged_top", tri[top], ILU_EDGE_B,
                       False),
                      (f"edge_{kind}_streamed_next", tri[top + 1],
                       ILU_EDGE_B, False)]
        got = []
        for path, ilu, B, skew in edges:
            got += ilu_case(torch, hk, path, ilu, B, dt_name, skew=skew)
        rows += got
        for kind in ("ilu0_factor", "ilu0_apply"):
            reached = {r["form"] for r in rows
                       if r["kernel"] == kind and r["dtype"] == dt_name}
            check(reached >= set(ILU_FORMS), f"(y) {kind} {dt_name}: the "
                  f"rows reach {sorted(reached)}, not every form {ILU_FORMS}")
            for path, form in (("edge_streamed", "streamed"),
                               ("edge_spilled", "streamed_spilled")):
                check([r["form"] for r in got if r["kernel"] == kind
                       and r["path"] == path] == [form],
                      f"(y) {kind} {dt_name}: {path} is not {form}")
            check(any(r["shape"][0] % r["systems_a_block"]
                      and r["form"] not in ("streamed", "streamed_spilled")
                      for r in got if r["kernel"] == kind),
                  f"(y) {kind} {dt_name}: no batch left a short block")
    print("ilu_kernels_phase_s " + json.dumps(dict(
        paths=t1 - t0, edge_builds=t2 - t1,
        edges=time.perf_counter() - t2)))
    return rows, results


def bts_systems(torch, B, n, m, seed, swap, spread=0.2):
    """(z)'s inputs, made on the card from ``seed``: block diagonally
    dominant random systems of ``B`` x ``n`` levels of m x m blocks, as
    f32 values; returned in f32 and in f64 (the same values).  Off-diagonal
    entries of ``spread`` (0.5 / sqrt(m) for block_thomas_large), diagonals
    2.5-3.5.  ``swap``: each D block's rows rotated up by one and its
    leading diagonal zeroed, so every level's small solve swaps rows (as
    tests/test_torch_block_thomas_small.py's ``_system``)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (B, n, m, m)

    def rand(*sh):
        return torch.randn(*sh, generator=g, device="cuda",
                           dtype=torch.float32)
    L, U = spread * rand(*shape), spread * rand(*shape)
    eye = torch.eye(m, device="cuda", dtype=torch.float32)
    D = spread * rand(*shape) + (2.5 + torch.rand(
        shape[:-1], generator=g, device="cuda"))[..., None] * eye
    if swap:
        D = torch.roll(D, -1, dims=-2).contiguous()
        D[..., 0, 0] = 0.0
    b = rand(B, n, m)
    f32 = [a.contiguous() for a in (L, D, U, b)]
    return f32, [a.double() for a in f32]


def bts_ops(m, n, B):
    """Operations of B solves of n levels (a division one operation, an
    FMA two): the level's products L Cp and L dp (2 m^3 + 2 m^2) and
    subtractions (m^2 + m); the small solve (m = 1: 2 divisions; m = 2:
    the det and adjugate products, 6 + 6 (m + 1), and m (m + 1)
    divisions; else Gauss-Jordan: (m - 1) divisions and (m - 1)(2 m - j)
    FMAs at column j, then m (m + 1) divisions); the back substitution
    2 m^2 a level."""
    if m == 1:
        solve = 2
    elif m == 2:
        solve = 6 + 6 * (m + 1) + m * (m + 1)
    else:
        solve = sum((m - 1) + 2 * (m - 1) * (2 * m - j) for j in range(m)) \
            + m * (m + 1)
    level = 2 * m ** 3 + 2 * m ** 2 + m ** 2 + m + solve + 2 * m ** 2
    return level * n * B


def bts_hold(torch, label, got, plain64, plain32=None, rel=BTS_F64_REL):
    """Hold a block-Thomas kernel's result: f64 (``plain32`` None) within
    ``rel`` of max |x| of the plain f64 solve; f32 no farther from the
    plain f64 solve of the same values than BTS_F32_FACTOR times the plain
    f32 solve is.  Both finite.  Returns (max |got - plain| in got's
    dtype, the tolerance in those units, max |x|)."""
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    scale = float(plain64.abs().max())
    if plain32 is None:
        err, tol = float((got - plain64).abs().max()), rel * scale
        check(err <= tol, f"{label}: max |kernel - plain| {err:.3e} > "
              f"{rel:g} * {scale:.3e}")
        return err, tol, scale
    own = float((plain32.double() - plain64).abs().max())
    far = float((got.double() - plain64).abs().max())
    check(far <= BTS_F32_FACTOR * own, f"{label}: the f32 kernel is "
          f"{far:.3e} from the plain f64 solve, more than {BTS_F32_FACTOR} "
          f"x the plain f32 solve's {own:.3e}")
    return float((got - plain32).abs().max()), BTS_F32_FACTOR * own, scale


def dense_block_tridiag(torch, L, D, U):
    """The block-tridiagonal T of ``[B, n, m, m]`` blocks as one dense
    ``[B, n m, n m]`` matrix (the JAX package's dense plan's operand,
    mpp_tpu/batched/vsfm_compiled.py:298; the port never builds it)."""
    B, n, m = D.shape[0], D.shape[1], D.shape[2]
    A = D.new_zeros(B, n, m, n, m)
    A.diagonal(dim1=1, dim2=3).copy_(D.permute(0, 2, 3, 1))
    if n > 1:
        A[:, 1:, :, :-1].diagonal(dim1=1, dim2=3).copy_(
            L[:, 1:].permute(0, 2, 3, 1))
        A[:, :-1, :, 1:].diagonal(dim1=1, dim2=3).copy_(
            U[:, :-1].permute(0, 2, 3, 1))
    return A.view(B, n * m, n * m)


def library_block_solve(torch, args, ref, *rows):
    """The block solves' library yardstick: one torch.linalg.solve of the
    dense T (dense_block_tridiag) with b, on the first systems whose T and
    its LU copy fit LIBRARY_DENSE_BYTES (``library_systems``), held finite
    and within 1e-9 (f64) / 1e-3 (f32) of max |x| of ``ref``; its ms (CUDA
    events; the assembly outside) and device ms (queued) go into every row
    of ``rows``."""
    L, D, U, b = args
    B, n, m = b.shape
    per = 2 * (n * m) ** 2 * b.element_size()
    nb = max(1, min(B, LIBRARY_DENSE_BYTES // per))
    A = dense_block_tridiag(torch, L[:nb], D[:nb], U[:nb])
    rhs = b[:nb].reshape(nb, n * m, 1)
    call = partial(torch.linalg.solve, A, rhs)
    y = call().view(nb, n, m)
    scale = float(ref[:nb].abs().max())
    err = float((y.double() - ref[:nb].double()).abs().max())
    tol = (1e-9 if b.dtype == torch.float64 else 1e-3) * scale
    check(bool(torch.isfinite(y).all()) and err <= tol,
          f"library dense solve {[B, n, m]} {b.dtype}: {err:.3e} off the "
          f"plain form (tolerance {tol:.3e})")
    ms = time_cuda(torch, call, 3)
    for row in rows:
        row.update(library_ms=ms, library_systems=nb)
    later(call, 3, *rows, key="library_device_ms")


def btl_ops(m, n, B):
    """Operations of B block_thomas_large solves of n levels, as LAPACK's
    getrf + getrs count them: at levels 1..n-1 the products L_k [Cp_{k-1} |
    dp_{k-1}] with their differences from [D_k | b_k] (2 m^2 (m + 1)); at
    every level the LU of denom_k ((4 m^3 - 3 m^2 - m) / 6) and its solve
    of m + 1 right-hand columns (1 at the last level; 2 m^2 - m a column);
    at levels 0..n-2 the back substitution's dp_k - Cp_k x_{k+1} (2 m^2)."""
    lu = (4 * m ** 3 - 3 * m ** 2 - m) // 6
    cols = (n - 1) * (m + 1) + 1
    return (n * lu + (n - 1) * (2 * m * m * (m + 1) + 2 * m * m)
            + cols * (2 * m * m - m)) * B


def block_row(kernel, path, args, err, tol, scale, ops, dt_name,
              peaks=PEAK_OPS_S):
    """A (z) path row: the error, the bytes (L, D, U and b read once, x
    written once) and the bound (``ops`` over ``peaks``)."""
    B, n, m = args[3].shape
    elem = 8 if dt_name == "float64" else 4
    nbytes = (3 * m * m + 2 * m) * n * B * elem
    ms_b, by = bound(nbytes, ops, dt_name, peaks)
    return dict(kernel=kernel, path=path, shape=[B, n, m], dtype=dt_name,
                max_abs_err=err, tol=tol, max_abs_x=scale, bytes=nbytes,
                bound_ms=ms_b, bound_by=by)


def bts_kernel_checks(torch, hk):
    """Phase (z): block_thomas_small against its plain form on the card at
    the canopy's path shapes (timed, with the library yardstick) and at
    the edges (every m at every n of BTS_EDGE_N and batch of BTS_EDGE_B,
    f64 and f32, dominant and row-swapping blocks, the rule's form,
    failing unless the rule reached every form in each dtype); a NaN kept
    in its system.  Returns (the kernel_check rows, the kernels line's
    entry: (u1)'s MLC shape)."""
    from mpp_tpu_torch.ops.block_thomas import block_thomas as plain
    t0 = time.perf_counter()
    rows, result = [], None
    for path, B, n, m, dt_name in BTS_PATHS:
        f32, f64 = bts_systems(torch, B, n, m, 7 + m, False)
        args = f64 if dt_name == "float64" else f32
        p64 = plain(*f64)
        p32 = None if dt_name == "float64" else plain(*f32)
        kern = partial(hk.block_thomas_small, *args)
        label = f"block_thomas_small {path} {[B, n, m]} {dt_name}"
        err, tol, scale = bts_hold(torch, label, kern(), p64, p32)
        row = block_row("block_thomas_small", path, args, err, tol, scale,
                        bts_ops(m, n, B), dt_name)
        row.update(form=hk.bts_form(m, args[3].dtype),
                   ms=time_cuda(torch, kern, 20),
                   plain_ms=time_cuda(torch, partial(plain, *args), 3))
        rows.append(row)
        targets = [row]
        if path == "mlc" and dt_name == "float32":
            result = dict(row)
            targets.append(result)
        later(kern, 20, *targets)
        library_block_solve(torch, args, p64 if p32 is None else p32,
                            *targets)
    # a NaN in one system's D reaches that system's x and no other's
    _, (L, D, U, b) = bts_systems(torch, 4096, 93, 4, 11, False)
    D[5, 40, 2, 1] = float("nan")
    got, ref = hk.block_thomas_small(L, D, U, b), plain(L, D, U, b)
    keep = torch.arange(4096, device="cuda") != 5
    check(not bool(torch.isfinite(got[5]).all()),
          "(z): the NaN of system 5 did not reach its x")
    err, _, _ = bts_hold(torch, "(z) NaN's neighbours", got[keep], ref[keep])
    nan_row = dict(nan_system_nonfinite=int((~torch.isfinite(got[5]))
                                            .sum()),
                   plain_nonfinite=int((~torch.isfinite(ref[5])).sum()),
                   others_max_abs_err=err)
    t1 = time.perf_counter()
    # the edges: the plain forms at the largest batch, the kernel at each
    # batch on the first B systems of the same values
    worst, reached = {}, {"float64": set(), "float32": set()}
    for m in range(1, 9):
        for n in BTS_EDGE_N:
            for swap in ((False, True) if m > 1 else (False,)):
                f32, f64 = bts_systems(torch, max(BTS_EDGE_B), n, m,
                                       100 * m + n, swap)
                p64, p32 = plain(*f64), plain(*f32)
                for B in BTS_EDGE_B:
                    for dt_name, args, ref32 in (("float64", f64, None),
                                                 ("float32", f32, p32)):
                        got = hk.block_thomas_small(*(a[:B] for a in args))
                        reached[dt_name].add(hk.bts_form(m, args[3].dtype))
                        label = (f"block_thomas_small {[B, n, m]} {dt_name}"
                                 f"{' swap' if swap else ''}")
                        err, tol, _ = bts_hold(
                            torch, label, got, p64[:B],
                            None if ref32 is None else ref32[:B])
                        key = f"m{m} {dt_name}"
                        share = err / tol if tol else 0.0
                        if share >= worst.get(key, dict(share=-1))["share"]:
                            worst[key] = dict(share=share, err=err, tol=tol,
                                              shape=[B, n, m], swap=swap)
                del got
                del f32, f64, p64, p32
    for dt_name, forms in reached.items():
        check(forms == set(hk.BTS_FORMS), f"(z) {dt_name}: the rule reached "
              f"the forms {sorted(forms)}, not {hk.BTS_FORMS}")
    print("block_thomas_small_edges " + json.dumps(dict(
        n=BTS_EDGE_N, B=BTS_EDGE_B, worst_err_over_tol=worst,
        forms_reached={k: sorted(v) for k, v in reached.items()},
        nan=nan_row, paths_s=t1 - t0, edges_s=time.perf_counter() - t1)))
    return rows, result


def btl_on_chip_edges(hk):
    """Each form's last block size kept in shared memory: the block form's
    working matrix, the cluster form's tiles and panel slots (its plan's
    ``on_chip``)."""
    m = hk.BLOCK_LARGE_MIN
    while hk.btl_cluster_plan(m + 1)["on_chip"]:
        m += 1
    return {"block": hk.btl_block_max_on_chip(), "cluster": m}


def btl_kernel_checks(torch, hk):
    """Phase (z), block_thomas_large: each form (hk.BTL_FORMS, forced
    through the rule's thresholds) against the plain form on the card at
    BTL_PATHS (the rule's form timed, with the library yardstick) and at
    the edges (BTL_EDGE_M and each form's shared-memory edge, at BTL_EDGE_N
    levels and BTL_EDGE_B systems, f64 and f32, dominant and row-swapping
    blocks); a NaN kept in its system in each form; the cluster plan's
    shared bytes and scratch those the launcher computes.  Returns (the
    kernel_check rows, the kernels line's entry: (r)'s vchannel shape)."""
    from mpp_tpu_torch.ops import _build
    from mpp_tpu_torch.ops.block_thomas import block_thomas as plain
    from mpp_tpu_torch.tools.resident_variants import (force_btl_form,
                                                       restore_btl_rule)
    t0 = time.perf_counter()
    lib = _build.library()
    check(hk.max_on_chip("block_thomas_large", torch.float64)
          == hk.btl_block_max_on_chip(), "(z): the block form's on-chip "
          "limit differs from the launcher's")
    for m in sorted(set(BTL_EDGE_M) | {20, 40, 300, 4096}):
        for ctas in (1, 2, 3, 8, 13, 16):
            lay = hk.btl_cluster_layout(m, ctas)
            check([lib.mpp_block_thomas_large_cluster_smem(m, ctas, 1),
                   lib.mpp_block_thomas_large_cluster_smem(m, ctas, 0),
                   lib.mpp_block_thomas_large_cluster_scratch(m, ctas)]
                  == [lay["smem_on_chip"], lay["smem_off_chip"],
                      lay["big"]], f"(z): the cluster layout at m {m}, "
                  f"{ctas} CTAs differs from the launcher's")

    def forced(form, args):
        rule = force_btl_form(hk, form)
        try:
            return hk.block_thomas_large(*args)
        finally:
            restore_btl_rule(hk, rule)

    rows, result = [], None
    for path, B, n, m, dt_name in BTL_PATHS:
        f32, f64 = bts_systems(torch, B, n, m, 17 + m, False,
                               spread=0.5 / m ** 0.5)
        args = f64 if dt_name == "float64" else f32
        p64 = plain(*f64)
        p32 = None if dt_name == "float64" else plain(*f32)
        held = {}
        for form in hk.BTL_FORMS:
            label = f"block_thomas_large {form} {path} {[B, n, m]} {dt_name}"
            err, tol, scale = bts_hold(torch, label, forced(form, args), p64,
                                       p32, rel=BTL_F64_REL)
            held[form] = dict(max_abs_err=err, tol=tol)
        plan = hk.btl_launch(B, n, m, args[3].dtype)
        kern = partial(hk.block_thomas_large, *args)
        reps = 20 if B > 1 or m < 100 else 5
        row = block_row("block_thomas_large", path, args,
                        held[plan["form"]]["max_abs_err"],
                        held[plan["form"]]["tol"], scale, btl_ops(m, n, B),
                        dt_name, PEAK_MATRIX_OPS_S)
        row.update(form=plan["form"], ctas=plan["ctas"], forms_held=held,
                   on_chip=(m <= hk.btl_block_max_on_chip()
                            if plan["form"] == "block"
                            else hk.btl_cluster_plan(m)["on_chip"]),
                   ms=time_cuda(torch, kern, reps),
                   plain_ms=time_cuda(torch, partial(plain, *args), 3))
        rows.append(row)
        targets = [row]
        if path == "vchannel_direct":
            result = dict(row)
            targets.append(result)
        later(kern, reps, *targets)
        library_block_solve(torch, args, p64 if p32 is None else p32,
                            *targets)
        del f32, f64, p64, p32
    # a NaN in one system's D reaches that system's x and no other's, in
    # each form
    nan_rows = {}
    for form, (B, n, m) in (("block", (64, 20, 12)), ("cluster", (5, 6, 70))):
        _, (L, D, U, b) = bts_systems(torch, B, n, m, 13, False,
                                      spread=0.5 / m ** 0.5)
        D[3, n // 2, m // 2, 1] = float("nan")
        got, ref = forced(form, (L, D, U, b)), plain(L, D, U, b)
        keep = torch.arange(B, device="cuda") != 3
        check(not bool(torch.isfinite(got[3]).all()),
              f"(z): the NaN of system 3 did not reach its x ({form})")
        err, _, _ = bts_hold(torch, f"(z) NaN's neighbours ({form})",
                             got[keep], ref[keep], rel=BTL_F64_REL)
        nan_rows[form] = dict(
            shape=[B, n, m],
            nan_system_nonfinite=int((~torch.isfinite(got[3])).sum()),
            plain_nonfinite=int((~torch.isfinite(ref[3])).sum()),
            others_max_abs_err=err)
    t1 = time.perf_counter()
    worst, cases = {}, 0
    edge = btl_on_chip_edges(hk)
    ms_all = sorted(set(BTL_EDGE_M) | {e + d for e in edge.values()
                                       for d in (0, 1)})
    for m in ms_all:
        for n in BTL_EDGE_N:
            # from BTL_DEEP_CUT up, the deepest n on one dominant f64 system,
            # past BTL_DEEPEST_M not at all
            deep = m >= BTL_DEEP_CUT and n == max(BTL_EDGE_N)
            if deep and m > BTL_DEEPEST_M:
                continue
            Bs = (1,) if deep else BTL_EDGE_B
            dts = ("float64",) if deep else ("float64", "float32")
            for swap in ((False,) if deep else (False, True)):
                f32, f64 = bts_systems(torch, max(Bs), n, m, 1000 * m + n,
                                       swap, spread=0.5 / m ** 0.5)
                p64 = plain(*f64)
                p32 = plain(*f32) if "float32" in dts else None
                for B in Bs:
                    for dt_name in dts:
                        args = f64 if dt_name == "float64" else f32
                        for form in hk.BTL_FORMS:
                            got = forced(form, [a[:B] for a in args])
                            label = (f"block_thomas_large {form} {[B, n, m]} "
                                     f"{dt_name}{' swap' if swap else ''}")
                            err, tol, _ = bts_hold(
                                torch, label, got, p64[:B],
                                None if dt_name == "float64" else p32[:B],
                                rel=BTL_F64_REL)
                            cases += 1
                            key = f"{form} m{m} {dt_name}"
                            share = err / tol if tol else 0.0
                            if share >= worst.get(key, dict(share=-1))[
                                    "share"]:
                                worst[key] = dict(share=share, err=err,
                                                  tol=tol, shape=[B, n, m],
                                                  swap=swap)
                            del got
                del f32, f64, p64, p32
    print("block_thomas_large_edges " + json.dumps(dict(
        m=ms_all, n=BTL_EDGE_N, B=BTL_EDGE_B, deep_cut=BTL_DEEP_CUT,
        max_on_chip=edge, cases=cases, worst_err_over_tol=worst,
        nan=nan_rows, paths_s=t1 - t0, edges_s=time.perf_counter() - t1)))
    return rows, result


ARNOLDI_ARGS = ("V", "H", "cs", "sn", "g", "w", "tol", "mj", "found",
                "done", "flags")
UPDATE_ARGS = ("V", "H", "g", "mj", "found", "done", "x", "its", "flags")
LAUNCHER_ARGS = ("V", "H", "cs", "sn", "g", "tol", "mj", "found", "done",
                 "flags", "x", "its")


def gmres_state(torch, hk, ncol, n, m, j, dt_name, seed, zero_w=False,
                nan_col=None, clean=False):
    """A cycle's state before inner step j on the card (the wrappers'
    arguments, with w, x and its), drawn with numpy: the steps before j
    run through the plain form on random vectors from a unit V_0, V zero
    past row j.  Columns 0 mod 4 (every column where j >= n - 1) converge
    at step j (tol 2 |g_j|), 1 mod 4
    converged before it (found, mj = j), 2 mod 4 are done (with ``clean``
    none: every column runs, none converges); with ``zero_w`` the last
    column's w is 0 (hlast == 0), with ``nan_col`` one entry of that
    column's w is NaN."""
    rng = np.random.default_rng(seed)
    dev = dict(dtype=getattr(torch, dt_name), device="cuda")

    def draw(*shape):
        return torch.as_tensor(rng.standard_normal(shape), **dev)
    b = draw(ncol, n)
    V = torch.zeros(ncol, m + 1, n, **dev)
    H = torch.zeros(ncol, m + 1, m, **dev)
    cs, sn = torch.zeros(ncol, m, **dev), torch.zeros(ncol, m, **dev)
    g = torch.zeros(ncol, m + 1, **dev)
    V[:, 0] = b / b.norm(dim=-1, keepdim=True)
    g[:, 0] = torch.as_tensor(rng.uniform(0.5, 2.0, ncol), **dev)
    tiny = torch.full((ncol,), 1e-30, **dev)
    mj = torch.full((ncol,), m, dtype=torch.int64, device="cuda")
    found = torch.zeros(ncol, dtype=torch.bool, device="cuda")
    done = torch.zeros_like(found)
    flags = torch.ones(3, dtype=torch.bool, device="cuda")
    for i in range(j):
        hk.gmres_arnoldi_plain(V, H, cs, sn, g, draw(ncol, n), tiny, mj,
                               found, done, flags, i)
    tol = tiny
    if not clean:
        idx = torch.arange(ncol, device="cuda")
        # past the breakdown (V's rows 0..j span the space) w' is rounding
        # noise, and whether it is exactly 0 (so g_{j+1} too) differs
        # between two sums: every column converges there
        tol = torch.where((idx % 4 == 0) | (j >= n - 1), 2 * g[:, j].abs(),
                          tiny)
        found |= idx % 4 == 1
        mj = torch.where(idx % 4 == 1, j, mj)
        done |= idx % 4 == 2
    w = draw(ncol, n)
    if zero_w:
        w[-1] = 0.0
    if nan_col is not None:
        w[nan_col, n // 2] = float("nan")
    return dict(V=V, H=H, cs=cs, sn=sn, g=g, w=w, tol=tol, mj=mj,
                found=found, done=done, flags=flags, x=draw(ncol, n),
                its=torch.as_tensor(rng.integers(0, 9, ncol),
                                    device="cuda"))


def gmres_err(torch, label, got, ref, tol, keep, scale=None, amp=None):
    """Fail unless ``got`` is finite and within ``tol`` of ``scale`` (max
    |ref|, or at least ``scale``) of ``ref`` over the columns ``keep`` (a
    bool mask of the leading axis), each column's bound times its ``amp``;
    returns (max |got - ref|, the scale, the largest error over its
    bound)."""
    got, ref = got[keep], ref[keep]
    if not ref.numel():
        return 0.0, 0.0, 0.0
    check(bool(torch.isfinite(got).all()), f"{label}: non-finite output")
    big = max(float(ref.abs().max()), scale or 0.0)
    err = (got - ref).abs().reshape(ref.shape[0], -1).amax(dim=1).double()
    lim = tol * big * (1.0 if amp is None else amp[keep])
    over = float((err / lim).max()) if big else float(err.max()) * 1e300
    check(over <= 1.0, f"{label}: max |kernel - plain| {float(err.max()):.3e}"
          f" past {tol:g} * {big:.3e} (amplified up to "
          f"{1.0 if amp is None else float(amp[keep].max()):.3e})")
    return float(err.max()), big, over


def gmres_hold(torch, hk, label, st, j, dt_name, skew=False, nan_col=None):
    """gmres_arnoldi at step j and then gmres_update (mj <= j + 1, as after
    a step that ends the cycle), on a copy of ``st`` whose V past row j + 1
    is NaN (misaligned with ``skew``), against the plain forms on ``st``.
    V_{j+1} = w' / hlast holds within the tolerance times ||w|| / hlast
    (at least 1, hlast at least (j + 2) unit roundoffs of ||w||: the
    division amplifies w''s rounding, which the two forms' sums make
    differently; where hlast is at w's rounding level the direction is
    rounding noise in both), cs and sn within it absolutely
    (they are a cosine and a sine), H, g and x of max |.|.  Returns (the
    largest error over its bound, the step's and the update's largest
    absolute errors)."""
    tol = GMRES_TOL[dt_name]
    ncol = st["V"].shape[0]
    keep = torch.ones(ncol, dtype=torch.bool, device="cuda")
    if nan_col is not None:
        keep[nan_col] = False
    Vd, wd = st["V"].double(), st["w"].double()
    wp = wd - torch.bmm(torch.bmm(Vd, wd[:, :, None]).transpose(1, 2),
                        Vd)[:, 0]
    hl, wn = wp.norm(dim=-1), wd.norm(dim=-1)
    # hlast is known to (j + 2) roundings of ||w|| at best
    unit = torch.finfo(st["V"].dtype).eps / 2
    amp = torch.where(wn > 0, wn / torch.maximum(hl, unit * (j + 2) * wn),
                      torch.ones_like(wn)).clamp(min=1.0)
    ref = {k: v.clone() for k, v in st.items()}
    card = {k: (misaligned(torch, v) if skew else v.clone())
            for k, v in st.items()}
    card["V"][:, j + 2:] = float("nan")
    hk.gmres_arnoldi_plain(*(ref[k] for k in ARNOLDI_ARGS), j)
    hk.gmres_arnoldi(*(card[k] for k in ARNOLDI_ARGS), j)
    torch.cuda.synchronize()
    over, err_step = 0.0, 0.0
    for name, part, scale, a in (
            ("V", lambda t: t[:, j + 1], None, amp),
            ("H", lambda t: t[:, :, j], None, None),
            ("cs", lambda t: t[:, j], 1.0, None),
            ("sn", lambda t: t[:, j], 1.0, None),
            ("g", lambda t: t[:, :j + 2], None, None)):
        e, _, o = gmres_err(torch, f"gmres_arnoldi {label} j={j} {name}",
                            part(card[name]), part(ref[name]), tol, keep,
                            scale, a)
        over, err_step = max(over, o), max(err_step, e)
    for name in ("mj", "found", "flags"):
        check(torch.equal(card[name], ref[name]), f"gmres_arnoldi {label} "
              f"j={j}: {name} {card[name].tolist()[:8]} against the plain "
              f"form's {ref[name].tolist()[:8]}")
    if nan_col is not None:
        check(bool(torch.isnan(card["V"][nan_col, j + 1]).all()),
              f"gmres_arnoldi {label}: the NaN left its column's V")
    for d in (card, ref):
        d["mj"].clamp_(max=j + 1)
        d["flags"][2] = False
    hk.gmres_update_plain(*(ref[k] for k in UPDATE_ARGS))
    hk.gmres_update(*(card[k] for k in UPDATE_ARGS))
    torch.cuda.synchronize()
    err_update, _, o = gmres_err(torch, f"gmres_update {label} j={j} x",
                                 card["x"], ref["x"], tol, keep)
    for name in ("its", "done", "flags"):
        check(torch.equal(card[name], ref[name]), f"gmres_update {label} "
              f"j={j}: {name} against the plain form's")
    return max(over, o), err_step, err_update


def gmres_force(hk, form):
    """Force the GMRES kernels' form by patching the rule's thresholds;
    returns the rule to restore."""
    rule = (hk.GMRES_WARP_MAX_N, hk.GMRES_WARP_MIN_COLS)
    hk.GMRES_WARP_MAX_N = 10 ** 9 if form == "warp" else 0
    hk.GMRES_WARP_MIN_COLS = 10 ** 9
    return rule


def gmres_work(kernel, st, j, m, elem):
    """(bytes, operations) of one launch at ``st``: a step moves V's rows
    0..j and w (read once), V_{j+1} and H's column (written once), and
    does ~(4 (j + 1) + 3) n flops a column; the update of the columns not
    done reads V's rows < mj, H's mj x mj block, g, and x (read and
    written), ~2 mj n + mj^2 flops."""
    ncol, _, n = st["V"].shape
    if kernel == "gmres_arnoldi":
        return (((j + 3) * n + m + 1) * ncol * elem,
                (4 * (j + 1) + 3) * n * ncol)
    mjs = st["mj"][~st["done"]].double()
    return (int(float((mjs * n + mjs * mjs + mjs + 2 * n).sum()) * elem),
            int(float((2 * mjs * n + mjs * mjs).sum())))


def gmres_kernel_checks(torch, hk):
    """Phase (z2): both GMRES kernels against their plain forms on the card
    at the Krylov paths' shapes (GMRES_PATHS; the rule's form in f64 timed
    at steps 0, 15 and 29 and the update, with the plain step and its two
    torch.bmm) and at the edges (GMRES_EDGES), in both forms and both
    dtypes; and one 30-step cycle at (q) through gmres_cycles (its device
    activities).  Returns (the kernel_check rows, the kernels line's
    entries: (q)'s step at j = 15 and its update, the cycle's row)."""
    from mpp_tpu_torch.batched import ilu_gmres as ig
    t0 = time.perf_counter()
    rows, reached = [], {}
    paths = {p for p, _, _ in GMRES_PATHS}
    cases = [(p, c, n, min(30, n), False, None, False)
             for p, c, n in GMRES_PATHS] + \
        [(lab, c, n, m, sk, 1 if c > 1 else None, lab.startswith("restart"))
         for lab, c, n, m, sk in GMRES_EDGES]
    for label, ncol, n, m, skew, nan_col, zero_w in cases:
        for dt_name in ("float64", "float32"):
            dtype = getattr(torch, dt_name)
            worst, errs = {}, {}
            for j in sorted({0, m // 2, m - 1}):
                st = gmres_state(torch, hk, ncol, n, m, j, dt_name,
                                 seed=ncol + n + m + j, zero_w=zero_w,
                                 nan_col=nan_col)
                for form in hk.GMRES_FORMS:
                    rule = gmres_force(hk, form)
                    try:
                        got = gmres_hold(torch, hk, f"{label} {form}", st, j,
                                         dt_name, skew, nan_col)
                    finally:
                        hk.GMRES_WARP_MAX_N, hk.GMRES_WARP_MIN_COLS = rule
                    worst[form] = max(worst.get(form, 0.0), got[0])
                    errs[j, form] = got[1:]
                    reached.setdefault(dt_name, set()).add(form)
                del st
                if label in paths and dt_name == "float64":
                    rows += gmres_path_rows(
                        torch, hk, label, ncol, n, m, j,
                        errs[j, hk.gmres_form(ncol, n, m, dtype)])
            print("gmres_check " + json.dumps(dict(
                case=label, shape=[ncol, n], m=m, dtype=dt_name,
                misaligned=skew, nan_col=nan_col, zero_w=zero_w,
                rule_form=hk.gmres_form(ncol, n, m, dtype),
                worst_err_over_bound=worst)))
            torch.cuda.empty_cache()
    for dt_name, forms in reached.items():
        check(forms == set(hk.GMRES_FORMS), f"(z2) {dt_name}: forms "
              f"{sorted(forms)}")
    edges = {hk.gmres_form(c, n, m, torch.float64)
             for _, c, n, m, _ in GMRES_EDGES}
    check(edges == set(hk.GMRES_FORMS), f"(z2): the rule picks only {edges} "
          "at the edges")
    results = {}
    for r in rows:
        if r["path"] == "th_petsc" and r.get("j") in (15, None):
            results.setdefault(r["kernel"], r)
    cycle = gmres_cycle_row(torch, hk, ig)
    cycle["phase_s"] = time.perf_counter() - t0
    return rows, results, cycle


def gmres_path_rows(torch, hk, path, ncol, n, m, j, errs):
    """The timed rows of the rule's form at a path shape in f64, on a state
    where every column runs and none converges: the step at j (and at j =
    m - 1 the update after it, on a copy of its own that one step left,
    so that no repeated step converges a column the update then skips),
    each launched through a GmresLauncher bound once, as gmres_cycles
    launches it, with its ms (CUDA events), queued device ms, bound, plain
    ms and (``errs``) the largest absolute error of its hold; the step's
    beside the device ms of its plain form's two torch.bmm (the reference
    in the library column)."""
    st = gmres_state(torch, hk, ncol, n, m, j, "float64", seed=n + j,
                     clean=True)
    plan = hk.gmres_plan(ncol, n, m, torch.float64)
    after = {k: v.clone() for k, v in st.items()}
    hk.gmres_arnoldi(*(after[k] for k in ARNOLDI_ARGS), j)
    plain = {k: v.clone() for k, v in st.items()}
    V, w = plain["V"], plain["w"]
    h = torch.bmm(V, w[:, :, None])[..., 0]

    def bmms():
        torch.bmm(V, w[:, :, None])
        torch.bmm(h[:, None, :], V)
    # timed as the solver launches them: through a launcher bound once
    launch = hk.GmresLauncher(*(st[k] for k in LAUNCHER_ARGS))
    calls = [("gmres_arnoldi", st, partial(launch.arnoldi, st["w"], j),
              partial(hk.gmres_arnoldi_plain,
                      *(plain[k] for k in ARNOLDI_ARGS), j), errs[0])]
    if j == m - 1:
        plain_after = {k: v.clone() for k, v in after.items()}
        calls.append(("gmres_update", after,
                      hk.GmresLauncher(*(after[k] for k in LAUNCHER_ARGS)
                                       ).update,
                      partial(hk.gmres_update_plain,
                              *(plain_after[k] for k in UPDATE_ARGS)),
                      errs[1]))
    out = []
    for kernel, state, call, plain_call, err in calls:
        nbytes, ops = gmres_work(kernel, state, j, m, 8)
        bms, by = bound(nbytes, ops, "float64")
        row = dict(kernel=kernel, path=path, shape=[ncol, n], m=m,
                   dtype="float64", form=plan["form"], ctas=plan["ctas"],
                   threads=plan["threads"], ms=time_cuda(torch, call, 10),
                   plain_ms=time_cuda(torch, plain_call, 2),
                   library_ms=None, bytes=nbytes, ops=ops, bound_ms=bms,
                   bound_by=by, max_abs_err=err)
        if kernel == "gmres_arnoldi":
            row["j"] = j
            later(bmms, 10, row, key="plain_bmm_device_ms")
        later(call, 10, row)
        out.append(row)
    check(not bool(after["done"].any()), f"(z2) {path}: a column of the "
          "update's timing state converged")
    return out


def gmres_cycle_row(torch, hk, ig):
    """One GMRES(30) cycle at (q)'s sparsity and columns through
    gmres_cycles (ILU(0), tolerances no column reaches): its ms (CUDA
    events) and, queued, its device time and device activities."""
    ilu = ILU_AT["th_petsc"]
    data, b = (torch.as_tensor(a, device="cuda")
               for a in ilu_systems(ilu, TH_NCOL, seed=17))
    mv = ig.make_ell_matvec(ilu.indptr, ilu.indices)
    f = ilu.factor(data)

    def cycle():
        return ig.gmres_cycles(mv, data, b, ilu, f, rtol=0.0, atol=0.0,
                               maxcycles=1)
    mark = dict(hk.LAUNCHES)
    x, k, done, its = cycle()
    launched = {n: hk.LAUNCHES[n] - mark[n] for n in mark
                if hk.LAUNCHES[n] != mark[n]}
    check(k == 1 and bool((its == 30).all()) and not bool(done.any()),
          f"(z2) cycle at (q): {k} cycles, inner iterations {its[:4]}")
    check(launched == {"ilu0_apply": 31, "gmres_arnoldi": 30,
                       "gmres_update": 1},
          f"(z2) cycle at (q): launched {launched}")
    row = dict(path="th_petsc", shape=[TH_NCOL, ilu.n], m=30,
               launches=launched, ms=time_cuda(torch, cycle, 3))
    later(cycle, 1, row, key="device_ms", count_key="device_activities",
          windows=2)
    return row


def main():
    t_main = time.perf_counter()
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
    # the plain block-Thomas level loop on a CUDA tensor, over the whole run
    plain_block_loops, restore_plain = count_plain_block_loops(hk)

    # (c) kernels against their plain versions
    results, checks = kernel_checks(torch, hk, tridiag)
    from mpp_tpu_torch.driver import alm
    # (c2) the column assembly against its plain form
    results["vsfm_column_assemble"], rows = column_assembly_checks(torch, hk,
                                                                   alm)
    checks += rows

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
    check(after64["vsfm_column_assemble"] > 0
          and launches["vsfm_column_assemble"]
          > after64["vsfm_column_assemble"],
          f"the ALM path did not launch vsfm_column_assemble: {launches}")
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
    alm_f64_ms, steps64_alm = ms64, steps64

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
    mpp, _ = th.run_mass_and_heat(nx=TH_NH, compiled=True,
                                  linear_solver="direct", device="cpu")
    comp = compile_th(mpp, linear_solver="direct")
    X0_np = mpp.soe.soln
    problem_s = time.perf_counter() - t0
    th_launches = {}
    hk.reset_launches()
    X64, ms64, steps64, setup64, dm64, X1_direct = run_th(
        torch, comp, X0_np, torch.float64, TH_STEPS, "cuda", TH_NCOL)
    th_launches["f64"] = dict(hk.LAUNCHES)
    X32, ms32, steps32, setup32, dm32, _ = run_th(
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
                 "block_thomas2", "vsfm_column_assemble"):
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

    # (q)-(t): the PETSc-replica inner solve (batched ILU(0) + GMRES(30))
    t0 = time.perf_counter()
    th_busy = run_th_petsc(torch, hk, mpp, comp, X0_np, X1_direct)
    t_q = time.perf_counter()
    run_vchannel(torch, hk)
    t_r = time.perf_counter()
    mark = ilu_mark(hk)
    run_thermal_mms_petsc(torch)
    ilu_since(hk, "thermal_mms_petsc", mark)
    t_s = time.perf_counter()
    mark = ilu_mark(hk)
    run_small_problems(torch, hk)
    ilu_since(hk, "small_problems", mark, required=False)
    t_t = time.perf_counter()
    print("petsc_phases_s " + json.dumps(dict(
        q=t_q - t0, r=t_r - t_q, s=t_s - t_r, t=t_t - t_s)))

    # (u): the batched canopy pipeline, counted (block_thomas_small twice a
    # substep, the ILU(0) pair of the radiation solves)
    canopy_busy = run_canopy(torch, hk)

    # (v): the serial MLC, CompiledMLC and the ml_model orchestrator,
    # counted (only the ILU(0) pair on their path)
    mlc_busy = run_mlc(torch, hk)

    # (w): the serial SNES card vs CPU (only the ILU(0) pair on its
    # path), the compiled celia1990's kernels counted, the CLI
    by_path["vsfm_celia_compiled"], rows = run_serial(torch, hk, tridiag,
                                                      card)
    checks += rows

    # (x): the TH-SPAC network, the UGDM lateral ALM step (one process and
    # an NCCL group of one rank, each counted), the MLC bridge, Krylov
    by_path["alm_ugdm"], by_path["alm_ugdm_nccl"], rows = run_slices_f2_g(
        torch, hk, tridiag, alm, card,
        dict(ms=alm_f64_ms, syncs=[s["host_syncs"] for s in steps64_alm]))
    checks += rows
    for name in ("thomas", "tridiag_spmv", "tridiag_spmv_mixed"):
        results[name]["launches_by_path"] = {
            path: counts.get(name, 0) for path, counts in by_path.items()}
        results[name]["launches"] = sum(
            results[name]["launches_by_path"].values())
    results["thomas"]["thermal"] = thermal_row

    # (y): the ILU(0) kernels against their plain forms at the paths'
    # sparsities and the edges; their launches are those counted on the
    # paths (q)-(x), one a factorization or an apply on the card
    rows, ilu_results = ilu_kernel_checks(torch, hk)
    checks += rows
    for name, r in ilu_results.items():
        key = name.replace("ilu0_", "")
        r["launches_by_path"] = {p: row["launches"][key]
                                 for p, row in ILU_BY_PATH.items()}
        r["launches_per_step"] = {p: row["per_step"][key]
                                  for p, row in ILU_BY_PATH.items()
                                  if "per_step" in row}
        r["launches"] = sum(r["launches_by_path"].values())
        results[name] = r

    # (z): block_thomas_small and block_thomas_large against their plain
    # forms at the paths' shapes and the edges; their launches are those
    # counted on (u) and (x4), and on (r) and (t)
    for name, run, by_path, npaths in (
            ("block_thomas_small", bts_kernel_checks, BTS_BY_PATH,
             len(BTS_PATHS)),
            ("block_thomas_large", btl_kernel_checks, BTL_BY_PATH,
             len(BTL_PATHS))):
        rows, results[name] = run(torch, hk)
        checks += rows
        results[name].update(launches_by_path=dict(by_path),
                             launches=sum(by_path.values()),
                             path_rows=rows[:npaths])
    # (z2): the GMRES kernels against their plain forms at the Krylov
    # paths' shapes and the edges; their launches are those counted on the
    # paths (q)-(x), one an inner step or a cycle on the card
    rows, gmres_results, gmres_cycle = gmres_kernel_checks(torch, hk)
    checks += rows
    for name, r in gmres_results.items():
        key = "arnoldi" if name == "gmres_arnoldi" else "update"
        r["launches_by_path"] = {p: row["launches"][key]
                                 for p, row in ILU_BY_PATH.items()}
        r["launches_per_step"] = {p: row["per_step"][key]
                                  for p, row in ILU_BY_PATH.items()
                                  if "per_step" in row}
        r["launches"] = sum(r["launches_by_path"].values())
        results[name] = r
    restore_plain()
    check(not plain_block_loops, f"the plain block-Thomas level loop ran "
          f"on the card at {plain_block_loops}")
    print("plain_block_loops_on_card " + json.dumps(dict(
        count=len(plain_block_loops), block_thomas_large_by_path=BTL_BY_PATH,
        block_thomas_small_by_path=BTS_BY_PATH)))

    # the device times queued by (c)-(p) and (y), then the host-clock
    # readings of (d) and (c) again, after those profiler windows
    settle(torch)
    for name in ("block_thomas_small", "block_thomas_large"):
        r0 = results[name]
        for r in (r0, *r0["path_rows"]):
            r["bound_share"] = None if r["device_ms"] is None else \
                r["bound_ms"] / r["device_ms"]
    for r in checks:
        print("kernel_check " + json.dumps(r))
    print("gmres_cycle " + json.dumps(gmres_cycle))
    for r in (esc_busy, thermal_busy, *th_busy, *canopy_busy,
              *mlc_busy):
        r["device_busy"] = None if r["step_device_ms"] is None \
            else r["step_device_ms"] / r["ms_per_step"]
        print("step_device " + json.dumps(r))
    print("profiler_after " + json.dumps(dict(
        alm_f64_ms_per_step=[alm_f64_ms, run_alm(torch, alm, torch.float64,
                                                 4, "cuda")[0]],
        eager_ms={name: [ms, time_cuda(torch, kern, 50)]
                  for name, (kern, ms) in AGAIN.items()})))

    print("chip_smoke_s " + json.dumps(dict(
        s=time.perf_counter() - t_main,
        gmres_phase_s=gmres_cycle["phase_s"])))
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

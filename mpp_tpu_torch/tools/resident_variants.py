"""The SpMV chain and the Jacobi smoother against variant builds of
themselves on one NVIDIA GPU, and their sweep loops counted in SASS; with
``--ilu``, the ILU(0) factor and apply of other checkouts against this
one's; with ``--bts`` / ``--btl``, their block_thomas_small /
block_thomas_large against this one's; with ``--paths``, three main paths
through their entry points against this one's; with ``--bts-forms`` /
``--btl-forms``, this checkout's block_thomas_small / block_thomas_large
in each of its forms.

A variant is this checkout's ``csrc/spmv_family_kernels.cu`` with the text
edits of ``VARIANTS[name]``, in a copy of the package under
``mpp_tpu_torch/_build/variants/<name>/``, so the kernels that ship carry
no switch for it.  ``--tree NAME=ROOT`` adds another checkout as it is (an
earlier commit, unpacked); "this" is the checkout itself.  Each tree is
timed in a process of its own through the public ops
(``hopper_kernels.tridiag_spmv_chain`` / ``tridiag_jacobi_smooth``) at
CASES, the shapes of chip_smoke's phase (k), K = 30, and each result is
first held bit for bit against its plain version.  The trees run in the
order given and then reversed, ROUNDS times (A B .. B A A B .. B A); a
device time is torch.profiler's summed kernel durations over REPS calls,
divided by REPS, from a window holding exactly REPS kernel records.

``--ilu`` times ``hopper_kernels.ilu0_factor`` / ``ilu0_apply`` instead, in
f64 at ILU_PATHS, ``chip_smoke.py`` (y)'s path shapes: the sparsities are
built once by this checkout and every tree builds its own
``BatchedILU0`` on them, draws the same systems (``chip_smoke.
ilu_systems``), holds its factor bit for bit and its apply within 1e-12 of
max |x| against its own plain forms, and is timed as above; where the
caller finds the factor L2-cold ((q): GMRES's Krylov basis evicts it)
also behind a 128 MB copy before each call (``cold``).

``--bts`` times ``hopper_kernels.block_thomas_small`` instead, at
BTS_CASES, the canopy's path shapes of ``chip_smoke.py`` (z) (the
longwave's [4096, 93, 3] f64 and the MLC's [4096, 93, 4] f32 and f64):
every tree draws the same systems (``chip_smoke.bts_systems``), holds its
kernel to its own plain form (f64 within 1e-12 of max |x|; f32 no farther
from the plain f64 solve than twice the plain f32 solve) and is timed as
above, in the form its own rule picks.  A BTS_VARIANTS name
(``loads_only``) adds a build of this checkout's block_thomas_small with
that part of its time alone, timed but not held.

``--bts-forms`` times this checkout's block_thomas_small in each form of
``hk.BTS_FORMS`` at every m where the form is built, at BTS_FORM_SHAPE
(the canopy's width and depth), f64 and f32, the form forced by patching
the rule's threshold (``hk.BTS_THREAD_MAX``), each held to its plain form
first as ``--bts`` holds it, in one process: the readings the rule's
thresholds come from.

``--btl`` times ``hopper_kernels.block_thomas_large`` instead, at
``chip_smoke.BTL_PATHS`` ((r)'s [1, 30, 200] f64, (t)'s [1, 2, 40], the 2-D
MMS's [1, 20, 20], the 4-tree MLC's [4096, 93, 10] f32 and f64): every tree
draws the same systems (``chip_smoke.bts_systems``, off-diagonal spread
0.5 / sqrt(m)), holds its kernel to its own plain form (f64 within 1e-11
of max |x|; f32 no farther from the plain f64 solve than twice the plain
f32 solve) and is timed as above, in the form its own rule picks.  A
BTL_VARIANTS name adds a build of this checkout's block_thomas_large with
one part of its work taken out, timed but not held: where the time goes.

``--btl-forms`` times this checkout's block_thomas_large in each form of
``hk.BTL_FORMS`` at BTL_FORM_CASES (one system at m = 16-256 and at the
block plans' shapes, 2-132 systems at m = 20, 64 and 200, the MLC's
[4096, 93, 10]), f64, the form forced
by patching the rule's thresholds, each held to its plain form first as
``--btl`` holds it, in one process: the readings the rule's thresholds
come from.

``--gmres`` times one GMRES(30) cycle (30 inner steps and the update,
ILU(0)-preconditioned, through ``batched/ilu_gmres.gmres_cycles``: this
checkout's kernels, an earlier tree's eager step) at GMRES_PATHS, the
Krylov paths' sparsities and columns, on ``chip_smoke.ilu_systems``:
host-clock ms a cycle ending in a synchronise, the mean of GMRES_REPS
after a warm cycle, the aten operations one cycle dispatches (a
TorchDispatchMode: each eager op one, a kernel called through ctypes
none) and its device time (one torch.profiler window), every tree on the
same systems, in the trees' turns.  At (r)'s sparsity it also splits
the host time of GMRES_HOST_STEPS inner steps as ``gmres_cycles`` runs
them (host clock, the card synchronised at the window's ends only): the
matvec, ``ilu.solve``, the Arnoldi launch (through the tree's launcher
where it has one, else ``hk.gmres_arnoldi``) and the host read of its
flag, in microseconds a step.

``--gmres-split`` times ``gmres_arnoldi`` at GMRES_SPLIT_CASES ((q)'s
[8192, 128] at steps 0 and 15, (r)'s [1, 6000] and (v3)'s [1, 95232] at
step 15; f64, m = 30)
in this checkout's build and in builds with one part of the step left out
(GMRES_VARIANTS["this"]: the dots, the correction, the normalise pass, the
serial tail, the H column's store), timed but not held: where the step's
time goes.  A ``--tree`` named in GMRES_VARIANTS (``pr17``, PR 17's first
port) is split the same way with its own edits.

``--gmres-forms`` times this checkout's two GMRES kernels in each form of
``hk.GMRES_FORMS`` at GMRES_FORM_CASES (f64, m = 30, the step at j = 15,
the update at mj = 30), the form forced by patching the rule's
thresholds, and the cluster form at single columns with the CTAs' rows
GMRES_FORM_CTA_ELEMS: the readings the rule's thresholds come from.

``--paths`` times the main paths through their entry points, in the
trees' turns as above (wall-clock ms, each ending in a synchronise):
vsfm_vchannel's "direct" plan at ``chip_smoke.py`` (r)'s size (a warm
problem of one step first, then a new one's VCH_STEPS steps; ms and host
syncs a step, Newton iterations), spac_campbell's multi-GE "direct" plan
as (t) runs it (a warm problem of one step, then CAMP_STEPS steps), and
the canopy pipeline's staged f32 substeps at (u1)'s width
(``chip_smoke.run_canopy_timed``: one warm substep, PATH_CANOPY_SUBSTEPS
timed, its gates held), and the Krylov paths: (q)'s TH "petsc" at [8192,
64 cells] f64 (a warm step, then TH_PETSC_STEPS), (r)'s vchannel "petsc"
(a warm problem of one step, then VCH_STEPS), (w1)'s serial celia1990 (a
warm step, then W1_CELIA's serial steps) and (x1)'s th_manoli2014 (a warm
problem of one step, then its 3 steps).  On those, every GMRES solve is
timed too (``gmres_cycles`` wrapped, the card synchronised before and
after it), so each reports ms a step, the share of it in GMRES (the rest
is the Newton machinery around it), host syncs, GMRES cycles, Arnoldi
steps (the ILU(0) applies less one a cycle, less one where no cycle ran),
summed inner iterations of the columns and ILU(0) applies, a step.

    python -m mpp_tpu_torch.tools.resident_variants [--tree NAME=ROOT ...]
        [TREE ...]                       # default: this and every variant
    python -m mpp_tpu_torch.tools.resident_variants --ilu --tree NAME=ROOT
    python -m mpp_tpu_torch.tools.resident_variants --bts --tree NAME=ROOT
        [this loads_only]
    python -m mpp_tpu_torch.tools.resident_variants --bts-forms
    python -m mpp_tpu_torch.tools.resident_variants --btl --tree NAME=ROOT
        [this no_search ...]
    python -m mpp_tpu_torch.tools.resident_variants --btl-forms
    python -m mpp_tpu_torch.tools.resident_variants --paths --tree NAME=ROOT
    python -m mpp_tpu_torch.tools.resident_variants --gmres --tree NAME=ROOT
    python -m mpp_tpu_torch.tools.resident_variants --gmres-forms
    python -m mpp_tpu_torch.tools.resident_variants --gmres-split
        [--tree pr17=ROOT]
    python -m mpp_tpu_torch.tools.resident_variants --sass [--root ROOT]
        [--dump FILE]

``--sass`` builds ROOT's library (default: this checkout), runs ``cuobjdump
-sass`` on it and prints, for every register-form kernel (``reg_kernel``,
and the earlier ``resident_kernel``), the instructions a level and sweep
on its sweep loop's hot path, all and by opcode; ``--dump`` writes those
kernels' SASS to FILE.  Without CUDA it raises.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

_HERE = os.path.abspath(__file__)
_PKG = os.path.dirname(os.path.dirname(_HERE))
THIS = os.path.dirname(_PKG)
SOURCE = os.path.join("csrc", "spmv_family_kernels.cu")
BTS_SOURCE = os.path.join("csrc", "block_thomas_small_kernels.cu")
BTL_SOURCE = os.path.join("csrc", "block_thomas_large_kernels.cu")
GMRES_SOURCE = os.path.join("csrc", "gmres_kernels.cu")

#: name: [(text, replacement), ...] applied to SOURCE (every occurrence;
#: each text must occur)
VARIANTS = {
    # eight columns (warps) a block in the register form, as PR 3's kernel
    "warps8": [("constexpr int kRegWarps = 4;",
                "constexpr int kRegWarps = 8;")],
    # at R = 1 too, a select on the sweep's path holds the pads at +0
    "pad_select": [("constexpr bool kHold = kPad && R > 1;",
                    "constexpr bool kHold = kPad;")],
    # IEEE `/` in the f32 smoother's register form
    "ieee_div": [("constexpr bool kHoist = kJacobi && sizeof(T) == 4;",
                  "constexpr bool kHoist = false;")],
}
#: --bts: name: edits of BTS_SOURCE, a part of block_thomas_small's time
#: (its results are not the solve and are not held): "loads_only", the
#: thread form's copies and shared loads with a sum in place of its solve.
#: (A solve on the first level's blocks repeated is no such part: the
#: repeated blocks drift to values whose divisions take `/`'s slow path.)
BTS_VARIANTS = {
    "loads_only": [
        ("    level_step<T, M>(lr, dr, ur, br, k == 0, k == n - 1, cpv, dpv);",
         "#pragma unroll\n    for (int i = 0; i < M; ++i)\n"
         "      dpv[i] = dpv[i] * T(0.5) + lr[i] + dr[i] + ur[i] + br[i];"),
    ],
}
#: --btl: name: edits of BTL_SOURCE, each taking one part of
#: block_thomas_large's work out (its results are not the solve and are not
#: held): "no_search", the pivot of step j is row j (no search of the
#: pivot keys; the diagonally dominant systems need no pivoting, so the
#: rest runs as it does); "no_update", the block form's column steps
#: eliminate nothing and the cluster form's panels update no trailing
#: column; "no_products", no level's L_k [Cp_{k-1} | dp_{k-1}] (denom_k =
#: D_k).
BTL_VARIANTS = {
    "no_search": [
        ("const int p = find_pivot(W, ld, j, pstep, m, j);",
         "const int p = j;"),
        ("        const int p =\n"
         "            pivot_of(lane < kClusterWarps ? slot_k[lane] : 0ull,\n"
         "                     lane < kClusterWarps\n"
         "                         ? static_cast<int>(slot_k[kClusterWarps + "
         "lane])\n                         : INT_MAX);",
         "        const int p = j;"),
    ],
    "no_update": [
        ("      for (int i0 = ty; i0 < m; i0 += 4 * TY) {",
         "      for (int i0 = m; i0 < m; i0 += 4 * TY) {"),
        ("      for (int rb = warp; rb < m8 / 8; rb += kClusterWarps) {\n"
         "        const int row = rb * 8 + g8;\n        C a[kPanel / 4];",
         "      for (int rb = m8; rb < m8 / 8; rb += kClusterWarps) {\n"
         "        const int row = rb * 8 + g8;\n        C a[kPanel / 4];"),
    ],
    "no_products": [
        ("            acc = fma(static_cast<C>(Li[q]), "
         "W[piv[q] * ld + m + c], acc);", "            acc += C(0);"),
        ("          for (int q0 = 0; q0 < m; q0 += 16) {",
         "          for (int q0 = m; q0 < m; q0 += 16) {"),
    ],
}
#: --gmres-split: tree: part: edits of GMRES_SOURCE, each leaving one part
#: of gmres_arnoldi's work out (its results are not the step and are not
#: held): "no_stage" (this checkout's), the copies of w and V's rows into
#: the slots; "no_dots", the dot products over V's rows; "no_correction",
#: w' = w - sum h_i V_i over them; "no_normalise", the pass that divides
#: V_{j+1} by hlast; "no_tail", the serial tail (the earlier rotations,
#: the new one, g, mj, found, the flag, and the loads they wait on);
#: "no_column", H's column store.  "this" edits this checkout's source,
#: "pr17" the source of PR 17's first port (a --tree of that name).
GMRES_VARIANTS = {
    "this": {
        "no_stage": [
            ("  for (int q = 0; q < nq; ++q) {\n"
             "    const int e = el.e(q);\n"
             "    if (with_w)",
             "  for (int q = nq; q < nq; ++q) {\n"
             "    const int e = el.e(q);\n"
             "    if (with_w)")],
        "no_dots": [
            ("    for (int q = 0; q < nq; ++q) {\n"
             "      const T we = el.ws[q * el.S];",
             "    for (int q = nq; q < nq; ++q) {\n"
             "      const T we = el.ws[q * el.S];"),
            ("    for (int q = 0; q < nq; ++q) {\n"
             "      const int e = el.e(q);\n"
             "      const T we = wc[e];",
             "    for (int q = nq; q < nq; ++q) {\n"
             "      const int e = el.e(q);\n"
             "      const T we = wc[e];")],
        "no_correction": [
            ("      for (int i = 0; i <= j; ++i)\n"
             "        s = fmadd(h[i], el.vs[",
             "      for (int i = 0; i < 0; ++i)\n"
             "        s = fmadd(h[i], el.vs["),
            ("      for (int i = 0; i <= j; ++i)\n"
             "        s = fmadd(h[i], Vc[",
             "      for (int i = 0; i < 0; ++i)\n"
             "        s = fmadd(h[i], Vc[")],
        "no_normalise": [
            ("  const T den = hlast == T(0) ? T(1) : hlast;\n"
             "  const int nq = el.count();\n"
             "  for (int q = 0; q < nq; ++q) {",
             "  const T den = hlast == T(0) ? T(1) : hlast;\n"
             "  const int nq = el.count();\n"
             "  for (int q = nq; q < nq; ++q) {")],
        "no_tail": [
            ("  T a = h[0];\n#pragma unroll 4\n  for (int i = 0; i < j; ++i) {",
             "  T a = h[0];\n#pragma unroll 4\n  for (int i = 0; i < 0; ++i) {"),
            ("  const T cj = a, cj1 = hlast;",
             "  if (j >= 0) return;\n  const T cj = a, cj1 = hlast;"),
            ("for (int i = lane; i < j; i += kWarp) {",
             "for (int i = lane; i < 0; i += kWarp) {"),
            ("if (lane == 0) tl = load_tail(",
             "if (lane < 0) tl = load_tail(")],
        "no_column": [
            ("  for (int i = first; i <= m; i += stride)\n    Hc[",
             "  for (int i = m + 1; i <= m; i += stride)\n    Hc[")],
    },
    "pr17": {
        "no_dots": [
            ("  for (int e = first; e < last; e += stride) {\n"
             "    const T we = wc[e];",
             "  for (int e = last; e < last; e += stride) {\n"
             "    const T we = wc[e];")],
        "no_correction": [
            ("    for (int i = 0; i <= j; ++i)\n"
             "      s = fmadd(h[i], Vc[",
             "    for (int i = 0; i < 0; ++i)\n"
             "      s = fmadd(h[i], Vc[")],
        "no_normalise": [
            ("for (int e = first; e < last; e += stride) Vn[e] = quo(",
             "for (int e = last; e < last; e += stride) Vn[e] = quo(")],
        "no_tail": [
            ("  T a = col[0];   // the running entry",
             "  if (j >= 0) return;\n  T a = col[0];   // the running entry"),
            ("  for (int i = lane; i < j; i += kWarp) {\n"
             "    cs_s[i] = cs[c * m + i];",
             "  for (int i = lane; i < 0; i += kWarp) {\n"
             "    cs_s[i] = cs[c * m + i];"),
            ("    for (int i = tid; i < j; i += blockDim.x) {\n"
             "      cs_s[i] = cs[c * m + i];",
             "    for (int i = tid; i < 0; i += blockDim.x) {\n"
             "      cs_s[i] = cs[c * m + i];")],
        "no_column": [
            ("  for (int i = first; i <= m; i += stride)\n    Hc[",
             "  for (int i = m + 1; i <= m; i += stride)\n    Hc[")],
    },
}
#: --gmres-split: (columns, rows, step j), f64, m = 30
GMRES_SPLIT_CASES = ((8192, 128, 0), (8192, 128, 15), (1, 6000, 15),
                     (1, 95232, 15))
#: --gmres: inner steps of (r)'s host split
GMRES_HOST_STEPS = 300
CASES = (("float64", 16384, 30), ("float32", 16384, 30),
         ("float64", 16384, 64), ("float32", 16384, 64),
         ("float32", 131072, 256))
ITERS = 30
REPS = 20
ROUNDS = 2
#: --gmres-split: its rounds (A .. F F .. A once: two runs a tree)
SPLIT_ROUNDS = 1
#: --ilu: (path, systems, L2-cold too)
ILU_PATHS = (("th_petsc", 8192, True), ("celia1990", 1, False),
             ("th_manoli2014", 1, False), ("th_manoli2014_x10", 1, False),
             ("mlc_compiled", 1, False))
#: --bts: (systems, levels, m, dtype)
BTS_CASES = ((4096, 93, 3, "float64"), (4096, 93, 4, "float32"),
             (4096, 93, 4, "float64"))
#: --bts-forms: (systems, levels)
BTS_FORM_SHAPE = (4096, 93)
#: --btl-forms: (systems, levels, m), f64
BTL_FORM_CASES = tuple((1, 10, m) for m in (16, 20, 24, 32, 40, 48, 64, 96,
                                            128, 200, 256)) + \
    ((1, 2, 40), (1, 20, 20), (1, 30, 200)) + \
    tuple((B, 10, m) for m in (20, 64, 200) for B in (2, 8, 33, 132)) + \
    ((4096, 93, 10),)
#: --btl-forms: the preferred CTAs a cluster tried besides the plan's own
#: (``hk.BTL_CLUSTER_CTAS``) at the single systems of m >= 128
BTL_FORM_CTAS = (4, 16)
#: --paths: the canopy substeps timed
PATH_CANOPY_SUBSTEPS = 4
#: --gmres: (sparsity, columns) of the Krylov paths ((q)'s TH column at 8192
#: columns, (r)'s vchannel, (w1)'s celia1990, (x1)'s th_manoli2014 at scale
#: 1 and 10, (v3)'s CompiledMLC at 256 columns), one GMRES(30) cycle each
GMRES_PATHS = (("th_petsc", 8192), ("vchannel", 1), ("celia1990", 1),
               ("th_manoli2014", 1), ("th_manoli2014_x10", 1),
               ("mlc_compiled", 1))
#: --gmres: timed cycles a case (after one warm cycle)
GMRES_REPS = 5
#: --gmres-forms: (columns, rows) of each form's grid, f64, m = 30, step 15;
#: and the rows a CTA of the cluster form tried at single columns
GMRES_FORM_CASES = tuple(
    (c, n) for c in (1, 4, 16, 64, 256, 1024, 8192)
    for n in (32, 128, 512, 2048, 8192) if c * n <= 8192 * 512) + \
    tuple((1, n) for n in (100, 500, 5000, 6000, 95232))
GMRES_FORM_CTA_ELEMS = (512, 1024, 2048)
# opcodes counted on the hot path
SASS_OPS = ("FADD", "FMUL", "FFMA", "DADD", "DMUL", "DFMA", "MUFU", "F2F",
            "FCHK", "FSEL", "SEL", "FSETP", "DSETP", "SHFL", "IMAD", "ISETP",
            "LOP3", "PLOP3", "LDL", "STL", "LDS", "STS", "LDG", "BRA")


def variant_source(name, source=SOURCE, variants=VARIANTS, tree=THIS):
    """``tree``'s ``source`` (default: this checkout's) with
    ``variants[name]`` applied."""
    with open(os.path.join(tree, "mpp_tpu_torch", source)) as f:
        text = f.read()
    for old, new in variants[name]:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} not in {source}")
        text = text.replace(old, new)
    return text


def make_variant(name, source=SOURCE, variants=VARIANTS, tree=THIS):
    """A copy of ``tree``'s package (default: this checkout's) with
    ``variants[name]`` applied to ``source``; returns the root that holds
    it."""
    root = os.path.join(_PKG, "_build", "variants", name.replace("/", "_"))
    pkg = os.path.join(root, "mpp_tpu_torch")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "mpp_tpu_torch"), pkg,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    with open(os.path.join(pkg, source), "w") as f:
        f.write(variant_source(name, source, variants, tree))
    return root


def _device_ms(torch, fn, tries=5, flush=None, name=""):
    """Device milliseconds of one ``fn()`` (one kernel launch): the summed
    durations of the device records whose name holds ``name`` over REPS
    calls (each behind ``flush()`` if given), over REPS, after two warm
    calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(1e-3)
            for _ in range(REPS):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
            time.sleep(1e-3)
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and name in e.name]
        if len(us) == REPS:
            return sum(us) / REPS / 1e3
    raise RuntimeError(f"torch.profiler: no window of {REPS} kernel records "
                       f"in {tries} tries")


def time_tree():
    """{case: device ms} of both ops at every case, in the tree whose
    package is on sys.path; fails unless each equals its plain version bit
    for bit."""
    from functools import partial

    import torch
    from mpp_tpu_torch.ops import hopper_kernels as hk
    from mpp_tpu_torch.ops import tridiag
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    g = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for dt_name, ncol, nz in CASES:
        def draw(rand):
            return rand((ncol, nz), generator=g, device="cuda",
                        dtype=torch.float64)
        dl, du, d = (draw(torch.rand) - 0.5, draw(torch.rand) - 0.5,
                     2.5 + draw(torch.rand))
        x, b = draw(torch.randn), draw(torch.randn)
        dtype = getattr(torch, dt_name)
        dl, d, du, x, b = (a.to(dtype) for a in (dl, d, du, x, b))
        ints = torch.int64 if dtype == torch.float64 else torch.int32
        for name, args in (
                ("tridiag_spmv_chain", (dl, d, du, x, ITERS, 0.25)),
                ("tridiag_jacobi_smooth", (dl, d, du, b, x, ITERS))):
            got = getattr(hk, name)(*args)
            ref = getattr(tridiag, name)(*args)
            if not torch.equal(got.view(ints), ref.view(ints)):
                raise RuntimeError(f"{name} [{ncol}, {nz}] {dt_name}: not "
                                   "bitwise equal to its plain version")
            out[f"{name} [{ncol},{nz}] {dt_name}"] = _device_ms(
                torch, partial(getattr(hk, name), *args))
    return out


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` as a module (its ILU(0)
    helpers)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(THIS, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ilu_sparsities(path):
    """Write the CSR patterns of ILU_PATHS to ``path`` (npz, NAME_indptr
    and NAME_indices), built by this checkout on the CPU: (q)'s TH column
    at nx 64 ("petsc"), (w1)'s celia1990 column, (x1)'s th_manoli2014 at
    scale 1 and 10, (v3)'s CompiledMLC at 256 columns."""
    import numpy as np
    from mpp_tpu_torch.batched.th_compiled import compile_th
    from mpp_tpu_torch.problems import mlc, th, th_manoli2014
    cs = _chip_smoke()
    mpp, _ = th.run_mass_and_heat(nx=cs.TH_NH, compiled=True,
                                  linear_solver="direct", device="cpu")
    out = {"th_petsc": compile_th(mpp)._ilu,
           "celia1990": cs.ilu_tridiagonal(cs.W1_CELIA["nz"])}
    for name, scale in (("th_manoli2014", 1),
                        ("th_manoli2014_x10", cs.X1_TH_SPAC["big_scale"])):
        soe = th_manoli2014.build_th_manoli2014(scale=scale,
                                                device="cpu").soe
        soe._build_jac_plan()
        out[name] = soe._jac_plan["ilu"].batched
    out["mlc_compiled"] = mlc.run_mlc_problem(
        cs.MLC_WIDE_NCAIR, 1, use_compiled=True,
        device="cpu").soe.step_dt.__self__._ilu
    np.savez(path, **{f"{k}_{a}": getattr(v, a) for k, v in out.items()
                      for a in ("indptr", "indices")})


def time_ilu(data_path):
    """{case: device ms} of both ILU(0) kernels at ILU_PATHS (f64), in the
    tree whose package is first on sys.path, on the sparsities at
    ``data_path``; fails unless each holds to its plain form."""
    from functools import partial

    import numpy as np
    import torch
    from mpp_tpu_torch.batched.ilu_gmres import BatchedILU0
    from mpp_tpu_torch.ops import hopper_kernels as hk
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    systems = _chip_smoke().ilu_systems
    pats = np.load(data_path)
    src = torch.zeros(16 << 20, dtype=torch.float64, device="cuda")
    flush = partial(torch.empty_like(src).copy_, src)
    out = {}
    for path, B, cold in ILU_PATHS:
        ilu = BatchedILU0(pats[f"{path}_indptr"], pats[f"{path}_indices"])
        data, b = (torch.as_tensor(a, device="cuda")
                   for a in systems(ilu, B, seed=B + ilu.n))
        s = ilu.schedule
        f = hk.ilu0_factor(data, s)
        if not torch.equal(f.view(torch.int64),
                           hk.ilu0_factor_plain(data, s).view(torch.int64)):
            raise RuntimeError(f"{path}: factor not bitwise its plain form")
        x, xp = hk.ilu0_apply(f, b, s), hk.ilu0_apply_plain(f, b, s)
        err = float((x - xp).abs().max()) / float(xp.abs().max())
        if not err <= 1e-12:
            raise RuntimeError(f"{path}: apply off its plain form by {err}")
        for kern, call in (("ilu0_factor", partial(hk.ilu0_factor, data, s)),
                           ("ilu0_apply", partial(hk.ilu0_apply, f, b, s))):
            case = f"{kern} {path} [{B},{ilu.n}] float64"
            out[case] = _device_ms(torch, call, name="ilu0")
            if cold:
                out[case + " cold"] = _device_ms(torch, call, flush=flush,
                                                 name="ilu0")
    return out


def gmres_sparsities(path):
    """ilu_sparsities' patterns plus (r)'s vchannel Jacobian ("petsc" plan,
    6000 unknowns), written to ``path``."""
    import numpy as np
    from mpp_tpu_torch.problems import vsfm_vchannel as vch
    ilu_sparsities(path)
    cs = _chip_smoke()
    ilu = vch.run_vsfm_vchannel_problem(
        nz=cs.VCH_NZ, nstep=0, use_compiled=True, linear_solver="petsc",
        device="cpu").soe.step_dt.__self__._ilu
    pats = dict(np.load(path))
    pats.update(vchannel_indptr=ilu.indptr, vchannel_indices=ilu.indices)
    np.savez(path, **pats)


def time_gmres(data_path):
    """{case: host ms} of one GMRES(30) cycle at GMRES_PATHS (f64), in the
    tree whose package is first on sys.path, on the sparsities at
    ``data_path``: ``gmres_cycles`` with ILU(0), tolerances no column
    reaches (every inner step runs) and one cycle, timed from a
    synchronise to a synchronise, GMRES_REPS times after a warm cycle."""
    import numpy as np
    import torch
    from mpp_tpu_torch.batched import ilu_gmres as ig
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    systems = _chip_smoke().ilu_systems
    pats = np.load(data_path)
    out = {}
    for path, B in GMRES_PATHS:
        ilu = ig.BatchedILU0(pats[f"{path}_indptr"], pats[f"{path}_indices"])
        mv = ig.make_ell_matvec(ilu.indptr, ilu.indices)
        data, b = (torch.as_tensor(a, device="cuda")
                   for a in systems(ilu, B, seed=B + ilu.n))
        f = ilu.factor(data)

        def cycle():
            return ig.gmres_cycles(mv, data, b, ilu, f, rtol=0.0, atol=0.0,
                                   maxcycles=1)
        x, k, done, its = cycle()
        if k != 1 or bool(done.any()) or not bool(torch.isfinite(x).all()):
            raise RuntimeError(f"{path}: {k} cycles, {int(done.sum())} "
                               "columns done, or a non-finite x")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GMRES_REPS):
            cycle()
        torch.cuda.synchronize()
        m = min(30, ilu.n)
        case = f"cycle {path} [{B},{ilu.n}] m={m}"
        out[f"{case} ms"] = (time.perf_counter() - t0) * 1e3 / GMRES_REPS
        with _Dispatches() as count:
            cycle()
        out[f"{case} aten_dispatches"] = count.n
        out[f"{case} device_ms"] = _window_device_ms(torch, cycle)
        if path == "vchannel":
            out.update({f"{case} host_us {k}": v for k, v in _host_split(
                torch, ig, ilu, mv, data, b, f).items()})
    return out


def _host_split(torch, ig, ilu, mv, data, b, f):
    """Host microseconds a step of GMRES_HOST_STEPS inner steps as
    ``gmres_cycles`` runs them, on ``b``'s columns (tolerance 0, steps
    0..m - 1 over and over on one basis): the matvec, ``ilu.solve``, the
    Arnoldi launch (the tree's launcher where it has one, else
    ``hk.gmres_arnoldi``) and the host read of the step's flag; the card
    synchronised at the window's ends only."""
    hk = ig.hk
    ncol, n = b.shape
    m = min(30, n)
    pc = ilu.prepare(f)
    V, H, cs, sn, g = hk.gmres_workspace(b, m)
    r = ilu.solve(pc, b)
    beta = r.norm(dim=-1)
    V[:, 0] = r / beta[:, None]
    g[:, 0] = beta
    tol = torch.zeros_like(beta)
    mj = torch.full((ncol,), m, dtype=torch.int64, device=b.device)
    found = torch.zeros(ncol, dtype=torch.bool, device=b.device)
    done = torch.zeros_like(found)
    flags = torch.ones(3, dtype=torch.bool, device=b.device)
    if hasattr(hk, "GmresLauncher"):
        step = hk.GmresLauncher(V, H, cs, sn, g, tol, mj, found, done, flags,
                                torch.zeros_like(b), torch.zeros_like(mj)
                                ).arnoldi
    else:
        def step(w, j):
            hk.gmres_arnoldi(V, H, cs, sn, g, w, tol, mj, found, done, flags,
                             j)
    spent = dict(matvec=0.0, ilu_solve=0.0, arnoldi=0.0, sync=0.0)
    clock = time.perf_counter
    torch.cuda.synchronize()
    for k in range(GMRES_HOST_STEPS):
        j = k % m
        t0 = clock()
        y = mv(data, V[:, j])
        t1 = clock()
        w = ilu.solve(pc, y).contiguous()
        t2 = clock()
        step(w, j)
        t3 = clock()
        bool(flags[j % 2].item())
        t4 = clock()
        for key, dt in zip(spent, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            spent[key] += dt
    torch.cuda.synchronize()
    return {k: v * 1e6 / GMRES_HOST_STEPS for k, v in spent.items()}


def _window_device_ms(torch, fn):
    """The summed durations of the device activities (kernels, copies,
    fills) torch.profiler records over one ``fn()``, in ms (one window: a
    record the trace loses reads low)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == DeviceType.CUDA) / 1e3


class _Dispatches:
    """Counts the aten operations dispatched inside it (a
    TorchDispatchMode): a call of a hand-written kernel through ctypes is
    none, an eager op one."""

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                outer.n += 1
                return func(*args, **(kwargs or {}))
        self.n, self.mode = 0, Mode()
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _gmres_state(torch, ncol, n, m, j, dtype, seed):
    """The arguments of both GMRES kernels at step j, drawn on the card:
    V's rows 0..j unit vectors, rotations from random angles, no column
    found or done, tolerances none reaches, mj = m."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = dict(device="cuda", dtype=dtype)

    def draw(*shape):
        return torch.randn(*shape, generator=g, **dev)
    V = torch.empty(ncol, m + 1, n, **dev)
    V[:, :j + 1] = draw(ncol, j + 1, n)
    V[:, :j + 1] /= V[:, :j + 1].norm(dim=-1, keepdim=True)
    th = 6.2831853 * torch.rand(ncol, m, generator=g, **dev)
    H = torch.triu(draw(ncol, m + 1, m)) + 4.0 * torch.eye(m + 1, m, **dev)
    gv = draw(ncol, m + 1)
    return dict(V=V, H=H, cs=torch.cos(th), sn=torch.sin(th), g=gv,
                w=draw(ncol, n), tol=torch.full((ncol,), 1e-300, **dev),
                mj=torch.full((ncol,), m, dtype=torch.int64, device="cuda"),
                found=torch.zeros(ncol, dtype=torch.bool, device="cuda"),
                done=torch.zeros(ncol, dtype=torch.bool, device="cuda"),
                flags=torch.ones(3, dtype=torch.bool, device="cuda"),
                x=draw(ncol, n),
                its=torch.zeros(ncol, dtype=torch.int64, device="cuda"))


def time_gmres_forms():
    """{case: device ms} of gmres_arnoldi (j = 15) and gmres_update (mj =
    30) in each form at GMRES_FORM_CASES, f64, m = 30, and of the cluster
    form with its CTAs' rows GMRES_FORM_CTA_ELEMS at single columns."""
    from functools import partial

    import torch
    from mpp_tpu_torch.ops import hopper_kernels as hk
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    m, j = 30, 15
    rule = (hk.GMRES_WARP_MIN_COLS, hk.GMRES_WARP_MAX_N, hk.GMRES_CTA_ELEMS)
    out = {}

    def run(tag, ncol, n):
        st = _gmres_state(torch, ncol, n, m, j, torch.float64, ncol + n)
        step = partial(hk.gmres_arnoldi, *(st[k] for k in (
            "V", "H", "cs", "sn", "g", "w", "tol", "mj", "found", "done",
            "flags")), j)
        update = partial(hk.gmres_update, *(st[k] for k in (
            "V", "H", "g", "mj", "found", "done", "x", "its", "flags")))
        form = hk.gmres_form(ncol, n, m, torch.float64)
        out[f"{tag} arnoldi j={j} [{ncol},{n}]"] = dict(
            form=form, ms=_device_ms(torch, step, name="arnoldi"))
        out[f"{tag} update [{ncol},{n}]"] = dict(
            form=form, ms=_device_ms(torch, update, name="update"))
        del st
        torch.cuda.empty_cache()
    try:
        for form in hk.GMRES_FORMS:
            hk.GMRES_WARP_MAX_N = 10 ** 9 if form == "warp" else 0
            hk.GMRES_WARP_MIN_COLS = 10 ** 9
            for ncol, n in GMRES_FORM_CASES:
                run(form, ncol, n)
        hk.GMRES_WARP_MAX_N = 0
        for elems in GMRES_FORM_CTA_ELEMS:
            hk.GMRES_CTA_ELEMS = elems
            for n in (500, 2048, 6000, 95232):
                run(f"cluster cta_elems={elems}", 1, n)
    finally:
        hk.GMRES_WARP_MIN_COLS, hk.GMRES_WARP_MAX_N, hk.GMRES_CTA_ELEMS = rule
    return out


def time_gmres_split():
    """{case: device ms} of gmres_arnoldi at GMRES_SPLIT_CASES (f64, m =
    30) in the tree whose package is first on sys.path, not held (a
    GMRES_VARIANTS build computes something else)."""
    from functools import partial

    import torch
    from mpp_tpu_torch.ops import hopper_kernels as hk
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    out = {}
    for ncol, n, j in GMRES_SPLIT_CASES:
        st = _gmres_state(torch, ncol, n, 30, j, torch.float64, ncol + n)
        step = partial(hk.gmres_arnoldi, *(st[k] for k in (
            "V", "H", "cs", "sn", "g", "w", "tol", "mj", "found", "done",
            "flags")), j)
        out[f"arnoldi j={j} [{ncol},{n}]"] = _device_ms(torch, step,
                                                         name="arnoldi")
        del st
        torch.cuda.empty_cache()
    return out


class _GmresLog:
    """``gmres_cycles`` (``batched/ilu_gmres`` and ``ops/ilu``'s name for
    it) wrapped in the tree on sys.path: every solve's seconds (the card
    synchronised before and after it), cycles, Arnoldi steps (its
    preconditioner's applies less one a cycle, less one where no cycle
    ran), the columns' summed inner iterations and the applies."""

    def __init__(self, torch):
        from mpp_tpu_torch.batched import ilu_gmres as ig
        from mpp_tpu_torch.ops import ilu as oi
        self.real, self.mods = ig.gmres_cycles, (ig, oi)
        self.reset()

        def wrapped(matvec, data, b, ilu=None, pc_data=None, *args, **kw):
            torch.cuda.synchronize()
            a0 = 0 if ilu is None else ilu.applies
            t0 = time.perf_counter()
            out = self.real(matvec, data, b, ilu, pc_data, *args, **kw)
            torch.cuda.synchronize()
            self.s += time.perf_counter() - t0
            k = out[1]
            self.cycles += k
            self.its += int(out[3].sum())
            if ilu is not None:
                self.applies += ilu.applies - a0
                self.steps += ilu.applies - a0 - k - (k == 0)
            return out
        for mod in self.mods:
            mod.gmres_cycles = wrapped

    def reset(self):
        self.s, self.cycles, self.steps, self.its, self.applies = \
            0.0, 0, 0, 0, 0

    def close(self):
        for mod in self.mods:
            mod.gmres_cycles = self.real

    def rows(self, tag, steps, seconds, syncs):
        return {f"{tag} ms_per_step": seconds * 1e3 / steps,
                f"{tag} gmres_share": self.s / seconds,
                f"{tag} host_syncs_per_step": syncs / steps,
                f"{tag} gmres_cycles_per_step": self.cycles / steps,
                f"{tag} arnoldi_steps_per_step": self.steps / steps,
                f"{tag} inner_iterations_per_step": self.its / steps,
                f"{tag} ilu_applies_per_step": self.applies / steps}


def time_krylov_paths(torch, cs):
    """time_paths' Krylov paths: (q) TH "petsc", (r) vchannel "petsc",
    (w1) serial celia1990 and (x1) th_manoli2014, each with its GMRES
    solves timed (_GmresLog)."""
    import numpy as np
    from mpp_tpu_torch.batched.th_compiled import compile_th
    from mpp_tpu_torch.constants import AuxVarKind, Var
    from mpp_tpu_torch.problems import th, th_manoli2014 as tm
    from mpp_tpu_torch.problems import vsfm_celia1990 as celia
    from mpp_tpu_torch.problems import vsfm_vchannel as vch
    log, out = _GmresLog(torch), {}

    def timed(tag, counter, nsteps, step):
        torch.cuda.synchronize()
        log.reset()
        s0, t0 = counter(), time.perf_counter()
        for istep in range(nsteps):
            step(istep)
        torch.cuda.synchronize()
        out.update(log.rows(tag, nsteps, time.perf_counter() - t0,
                            counter() - s0))
    try:
        mpp, _ = th.run_mass_and_heat(nx=cs.TH_NH, compiled=True,
                                      linear_solver="direct", device="cpu")
        comp = compile_th(mpp)
        X, bc, ss, dyn = cs.th_inputs(torch, comp, mpp.soe.soln, cs.TH_NCOL,
                                      "cuda", torch.float64)
        state = [comp.step_batched(X, bc, ss, cs.TH_DT, dyn=dyn)[0]]

        def th_step(_):
            X, _, ok, _ = comp.step_batched(state[0], bc, ss, cs.TH_DT,
                                            dyn=dyn)
            if not bool(ok.all()):
                raise RuntimeError("(q) petsc: a column did not converge")
            state[0] = X
        timed("th_petsc", lambda: comp.host_syncs, cs.TH_PETSC_STEPS,
              th_step)
        for steps in (1, cs.VCH_STEPS):    # a warm problem, then the timed
            mpp = vch.run_vsfm_vchannel_problem(
                nz=cs.VCH_NZ, nstep=0, use_compiled=True,
                linear_solver="petsc", device="cuda")
            comp = mpp.soe.step_dt.__self__

            def vch_step(i, mpp=mpp):
                ok, reason = mpp.soe.step_dt(cs.VCH_DT, i + 1)
                if not ok:
                    raise RuntimeError(f"vchannel petsc: reason {reason}")
            timed("vchannel_petsc", lambda c=comp: c.host_syncs, steps,
                  vch_step)
        out["vchannel_petsc newton_iters"] = \
            mpp.soe.cumulative_newton_iterations
        w1 = cs.W1_CELIA
        mpp = celia.run_vsfm_celia1990_problem(nz=w1["nz"], dtime=w1["dt"],
                                               nstep=0, device="cuda")

        def celia_step(i):
            mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1,
                         np.full(1, 9.3991e4))
            mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 2,
                         np.full(1, 3.5355e3))
            ok, reason = mpp.soe.step_dt(w1["dt"], i + 1)
            if not ok:
                raise RuntimeError(f"celia1990: reason {reason}")
        celia_step(0)                      # the warm step
        timed("celia1990_serial", lambda: mpp.soe.host_syncs,
              w1["serial_steps"], lambda i: celia_step(i + 1))
        x1 = cs.X1_TH_SPAC
        for steps in (1, x1["steps"]):     # a warm problem, then the timed
            mpp = tm.build_th_manoli2014(device="cuda")

            def tm_step(i, soe=mpp.soe):
                ok, reason = soe.step_dt(x1["dt"], i + 1)
                if not ok:
                    raise RuntimeError(f"th_manoli2014: reason {reason}")
            timed("th_manoli2014", lambda s=mpp.soe: s.host_syncs, steps,
                  tm_step)
        out["th_manoli2014 newton_iters"] = \
            mpp.soe.cumulative_newton_iterations
    finally:
        log.close()
    return out


def _block_hold(torch, name, rel, label, got, f32, f64):
    """Raise unless ``got`` (the solve of f64's or f32's values) is finite
    and holds to the plain form: f64 within ``rel`` of max |x|; f32 no
    farther from the plain f64 solve than twice the plain f32 solve."""
    from mpp_tpu_torch.ops.block_thomas import block_thomas as plain
    p64 = plain(*f64)
    far = float((got.double() - p64).abs().max())
    if got.dtype == torch.float64:
        ok = far <= rel * float(p64.abs().max())
    else:
        ok = far <= 2 * float((plain(*f32).double() - p64).abs().max())
    if not (ok and bool(torch.isfinite(got).all())):
        raise RuntimeError(f"{name} {label}: {far:.3e} off the plain form")


def _bts_hold(torch, label, got, f32, f64):
    """:func:`_block_hold` for block_thomas_small (f64 within 1e-12)."""
    _block_hold(torch, "block_thomas_small", 1e-12, label, got, f32, f64)


def time_bts(held=True):
    """{case: device ms} of block_thomas_small at BTS_CASES, in the tree
    whose package is first on sys.path; with ``held`` fails unless each
    holds to its plain form (a BTS_VARIANTS build is not held)."""
    from functools import partial

    import torch
    from mpp_tpu_torch.ops import hopper_kernels as hk
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    systems = _chip_smoke().bts_systems
    out = {}
    for B, n, m, dt_name in BTS_CASES:
        f32, f64 = systems(torch, B, n, m, 7 + m, False)
        args = f64 if dt_name == "float64" else f32
        case = f"[{B},{n},{m}] {dt_name}"
        if held:
            _bts_hold(torch, case, hk.block_thomas_small(*args), f32, f64)
        # the wrapper's allocations launch nothing: every device record of
        # a call is the kernel's
        out[f"block_thomas_small {case}"] = _device_ms(
            torch, partial(hk.block_thomas_small, *args))
    return out


def time_bts_forms():
    """{case: device ms} of this checkout's block_thomas_small in each form
    where it is built, at BTS_FORM_SHAPE and every m, f64 and f32, the
    form forced through the rule's threshold; each held first."""
    from functools import partial

    import torch
    from mpp_tpu_torch.ops import hopper_kernels as hk
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    systems = _chip_smoke().bts_systems
    B, n = BTS_FORM_SHAPE
    rule, out = hk.BTS_THREAD_MAX, {}
    try:
        for m in range(1, hk.BLOCK_SMALL_MAX + 1):
            f32, f64 = systems(torch, B, n, m, 50 + m, m > 2)
            for dt_name, args in (("float64", f64), ("float32", f32)):
                picked = hk.bts_form(m, args[3].dtype)
                for form in hk.BTS_FORMS:
                    if form == "thread" and m > hk.BTS_THREAD_BUILT:
                        continue
                    top = hk.BTS_THREAD_BUILT if form == "thread" else 0
                    hk.BTS_THREAD_MAX = {dt: top for dt in rule}
                    case = f"{form} [{B},{n},{m}] {dt_name}"
                    _bts_hold(torch, case, hk.block_thomas_small(*args),
                              f32, f64)
                    out[case + (" (rule)" if form == picked else "")] = \
                        _device_ms(torch, partial(hk.block_thomas_small,
                                                  *args))
                    hk.BTS_THREAD_MAX = rule    # the next pick is the rule's
    finally:
        hk.BTS_THREAD_MAX = rule
    return out


def _btl_hold(torch, label, got, f32, f64):
    """:func:`_block_hold` for block_thomas_large (f64 within 1e-11)."""
    _block_hold(torch, "block_thomas_large", 1e-11, label, got, f32, f64)


def _btl_systems(torch, B, n, m, seed):
    """(f32, f64) systems as chip_smoke (z) draws them for the large
    kernel."""
    return _chip_smoke().bts_systems(torch, B, n, m, seed, False,
                                     spread=0.5 / m ** 0.5)


def time_btl(held=True):
    """{case: device ms} of block_thomas_large at chip_smoke's BTL_PATHS,
    in the tree whose package is first on sys.path, in the form its rule
    picks; with ``held`` fails unless each holds to its plain form (a
    BTL_VARIANTS build is not held)."""
    from functools import partial

    import torch
    from mpp_tpu_torch.ops import hopper_kernels as hk
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    out = {}
    for path, B, n, m, dt_name in _chip_smoke().BTL_PATHS:
        f32, f64 = _btl_systems(torch, B, n, m, 17 + m)
        args = f64 if dt_name == "float64" else f32
        case = f"{path} [{B},{n},{m}] {dt_name}"
        if held:
            _btl_hold(torch, case, hk.block_thomas_large(*args), f32, f64)
        out[f"block_thomas_large {case}"] = _device_ms(
            torch, partial(hk.block_thomas_large, *args))
    return out


def force_btl_form(hk, form):
    """Patch the rule's thresholds so that :func:`hk.btl_form` picks
    ``form`` at every shape the cluster plan covers; returns the
    thresholds for :func:`restore_btl_rule`."""
    rule = (hk.BTL_CLUSTER_MIN_M, hk.BTL_CLUSTER_MAX_SYSTEMS,
            hk.BTL_CLUSTER_MAX_SYSTEMS_WIDE)
    big = 1 << 30
    (hk.BTL_CLUSTER_MIN_M, hk.BTL_CLUSTER_MAX_SYSTEMS,
     hk.BTL_CLUSTER_MAX_SYSTEMS_WIDE) = (0, big, big) if form == "cluster" \
        else (big, -1, -1)
    return rule


def restore_btl_rule(hk, rule):
    """Put back the thresholds :func:`force_btl_form` returned."""
    (hk.BTL_CLUSTER_MIN_M, hk.BTL_CLUSTER_MAX_SYSTEMS,
     hk.BTL_CLUSTER_MAX_SYSTEMS_WIDE) = rule


def time_btl_forms():
    """{case: device ms} of this checkout's block_thomas_large in each form
    at BTL_FORM_CASES (f64), the form forced through the rule's thresholds;
    each held first; the rule's own pick tagged."""
    from functools import partial

    import torch
    from mpp_tpu_torch.ops import hopper_kernels as hk
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    out = {}
    for B, n, m in BTL_FORM_CASES:
        f32, f64 = _btl_systems(torch, B, n, m, 60 + m + B)
        picked = hk.btl_form(B, m, torch.float64)
        for form in hk.BTL_FORMS:
            rule = force_btl_form(hk, form)
            try:
                ctas = hk.btl_launch(B, n, m, torch.float64)["ctas"]
                case = f"{form} [{B},{n},{m}] float64" + \
                    (f" ctas {ctas}" if ctas else "")
                _btl_hold(torch, case, hk.block_thomas_large(*f64), f32, f64)
                out[case + (" (rule)" if form == picked else "")] = \
                    _device_ms(torch, partial(hk.block_thomas_large, *f64),
                               name="btl_")
            finally:
                restore_btl_rule(hk, rule)
        if B == 1 and m >= 128:
            pref = hk.BTL_CLUSTER_CTAS
            rule = force_btl_form(hk, "cluster")
            try:
                for want in BTL_FORM_CTAS:
                    hk.BTL_CLUSTER_CTAS = want
                    ctas = hk.btl_launch(B, n, m, torch.float64)["ctas"]
                    case = f"cluster [{B},{n},{m}] float64 ctas {ctas} " \
                        f"(preferred {want})"
                    _btl_hold(torch, case, hk.block_thomas_large(*f64), f32,
                              f64)
                    out[case] = _device_ms(
                        torch, partial(hk.block_thomas_large, *f64),
                        name="btl_")
            finally:
                hk.BTL_CLUSTER_CTAS = pref
                restore_btl_rule(hk, rule)
        del f32, f64
    return out


def time_paths():
    """{case: value} of (r)'s vchannel "direct" steps, (t)'s spac_campbell
    "direct" steps and (u1)'s f32 canopy substeps on the card, in the tree
    whose package is first on sys.path, through its entry points (this
    checkout's ``chip_smoke`` sizes and helpers)."""
    import torch
    from mpp_tpu_torch.batched import canopy_pipeline as cp
    from mpp_tpu_torch.ops import _build
    from mpp_tpu_torch.ops import hopper_kernels as hk
    from mpp_tpu_torch.problems import vsfm_vchannel as vch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false")
    cs = _chip_smoke()
    _build.library()
    out = {}
    for steps in (1, cs.VCH_STEPS):        # a warm problem, then the timed
        mpp = vch.run_vsfm_vchannel_problem(
            nz=cs.VCH_NZ, nstep=0, use_compiled=True,
            linear_solver="direct", device="cuda")
        comp = mpp.soe.step_dt.__self__
        torch.cuda.synchronize()
        syncs0, t0 = comp.host_syncs, time.perf_counter()
        for istep in range(1, steps + 1):
            ok, reason = mpp.soe.step_dt(cs.VCH_DT, istep)
            if not ok:
                raise RuntimeError(f"vchannel direct: step {istep} reason "
                                   f"{reason}")
        torch.cuda.synchronize()
    out["vchannel_direct ms_per_step"] = \
        (time.perf_counter() - t0) * 1e3 / steps
    out["vchannel_direct host_syncs_per_step"] = \
        (comp.host_syncs - syncs0) / steps
    out["vchannel_direct newton_iters"] = \
        mpp.soe.cumulative_newton_iterations
    from mpp_tpu_torch.problems import vsfm_spac_campbell as camp
    for steps in (1, cs.CAMP_STEPS):       # a warm problem, then the timed
        mpp = camp.run_vsfm_spac_campbell_problem(
            multi_goveqns=True, nstep=0, use_compiled=True,
            linear_solver="direct", device="cuda")
        comp = mpp.soe.step_dt.__self__
        torch.cuda.synchronize()
        syncs0, t0 = comp.host_syncs, time.perf_counter()
        for istep in range(1, steps + 1):
            ok, reason = mpp.soe.step_dt(cs.CAMP_DT, istep)
            if not ok:
                raise RuntimeError(f"spac_campbell direct: step {istep} "
                                   f"reason {reason}")
        torch.cuda.synchronize()
    out["spac_campbell_direct ms_per_step"] = \
        (time.perf_counter() - t0) * 1e3 / steps
    out["spac_campbell_direct host_syncs_per_step"] = \
        (comp.host_syncs - syncs0) / steps
    out["spac_campbell_direct newton_iters"] = \
        mpp.soe.cumulative_newton_iterations
    _, _, row = cs.run_canopy_timed(torch, hk, cp, torch.float32,
                                    PATH_CANOPY_SUBSTEPS, "u1_f32")
    out["canopy_u1_f32 ms_per_substep"] = row["ms_per_substep"]
    out["canopy_u1_f32 host_syncs_per_substep"] = \
        row["host_syncs_per_substep"]
    out.update(time_krylov_paths(torch, cs))
    return out


def _branch_target(ins, labels):
    """The target address of a BRA instruction, or None."""
    m = re.search(r"\bBRA\b[^;]*?(0x[0-9a-f]+|\.L_x_\d+)", ins)
    if not m:
        return None
    t = m.group(1)
    return int(t, 16) if t.startswith("0x") else labels.get(t)


def _hot_path(body, labels, lo, hi):
    """The instructions of the shortest path from ``lo`` to the backward
    branch at ``hi`` (forward branches only): the path a trip takes when it
    enters no slow path or fallback."""
    addrs = [a for a, _ in body if lo <= a <= hi]
    text = dict(body)
    dist, prev = {lo: 0}, {}
    for i, a in enumerate(addrs[:-1]):
        if a not in dist:
            continue
        ins = text[a]
        tgt = _branch_target(ins, labels)
        uncond = tgt is not None and not ins.startswith("@") \
            and not re.search(r"\bBRA\b\S*\s+!?P\d", ins)
        succ = [] if uncond else [addrs[i + 1]]
        if tgt is not None and a < tgt <= hi:
            succ.append(tgt)
        for n in succ:
            if dist[a] + 1 < dist.get(n, float("inf")):
                dist[n], prev[n] = dist[a] + 1, a
    if hi not in dist:
        return [text[a] for a in addrs]
    path, a = [hi], hi
    while a != lo:
        a = prev[a]
        path.append(a)
    return [text[a] for a in reversed(path)]


def sass_sweeps(dump=None):
    """The register form's sweep loops in SASS, for the library of the tree
    whose package is on sys.path, keyed "kernel type R bools" (the
    template's bool parameters in order: kJacobi, then kPad for
    reg_kernel).  Of the innermost loops that hold a SHFL.UP, the one of
    most SHFL.UPs; on its hot path, the instructions over the sweeps the
    compiler unrolled into one trip (SHFL.UPs) and over R: instructions a
    level and sweep, all and by opcode (SASS_OPS)."""
    from mpp_tpu_torch.ops import _build
    exe = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                       "cuobjdump")
    proc = subprocess.run([exe, "-sass", _build.build()],
                          capture_output=True, text=True, check=True)
    funcs, name, body, labels, pending, texts = {}, None, [], {}, [], {}
    pat = re.compile(r"(reg_kernel|resident_kernel)I([fd])Li(\d+)E"
                     r"((?:Lb[01]E)+)")
    for line in proc.stdout.splitlines() + ["Function : end"]:
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name and pat.search(name):
                funcs[name] = (body, labels)
            name, body, labels, pending = m.group(1), [], {}, []
            continue
        if name:
            texts.setdefault(name, []).append(line)
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m and name:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            body.append((addr, m.group(2).strip()))
    if dump:
        with open(dump, "w") as f:
            for fname in funcs:
                f.write(f"Function : {fname}\n" + "\n".join(texts[fname])
                        + "\n")
    out = {}
    for fname, (body, labels) in funcs.items():
        m = pat.search(fname)
        t, r = ("f32" if m.group(2) == "f" else "f64"), int(m.group(3))
        ups = [a for a, ins in body if "SHFL.UP" in ins]
        loops = []
        for a, ins in body:
            tgt = _branch_target(ins, labels)
            if tgt is not None and tgt < a and any(tgt <= u < a for u in ups):
                loops.append((tgt, a))
        inner = [(lo, hi) for lo, hi in loops
                 if not any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
                            for l2, h2 in loops)]
        if not inner:
            continue
        lo, hi = max(inner, key=lambda lh: sum(lh[0] <= u <= lh[1]
                                               for u in ups))
        ins = _hot_path(body, labels, lo, hi)
        # a shuffle moves 32 bits: two a sweep for f64
        sweeps = sum("SHFL.UP" in i for i in ins) // (2 if t == "f64" else 1)
        ops = {}
        for i in ins:
            op = (i.split()[1] if i.startswith("@") else i.split()[0])
            op = op.split(".")[0]
            if op in SASS_OPS:
                ops[op] = ops.get(op, 0) + 1
        per = max(sweeps, 1) * r
        bools = ",".join(re.findall(r"Lb([01])E", m.group(4)))
        out[f"{m.group(1)} {t} R={r} {bools}"] = dict(
            instr_per_level_sweep=len(ins) / per, sweeps_per_trip=sweeps,
            by_opcode={k: v / per for k, v in sorted(ops.items())})
    return out


def _child(mode, root, dump):
    """Run ``mode`` ("time", "bts" or "sass"; "ilu" with the sparsities at
    ``dump``) on ``root``'s package in a process of its own; returns its
    JSON result."""
    cmd = [sys.executable, _HERE, "--child", mode, "--root", root]
    if dump:
        cmd += ["--dump", dump]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{mode} in {root} failed:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*", help="'this' and VARIANTS names")
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=ROOT: another checkout, as it is")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--ilu", action="store_true")
    ap.add_argument("--bts", action="store_true")
    ap.add_argument("--bts-forms", action="store_true")
    ap.add_argument("--btl", action="store_true")
    ap.add_argument("--btl-forms", action="store_true")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--gmres", action="store_true")
    ap.add_argument("--gmres-forms", action="store_true")
    ap.add_argument("--gmres-split", action="store_true")
    ap.add_argument("--root", default=THIS)
    ap.add_argument("--dump")
    ap.add_argument("--child", choices=("time", "sass", "ilu", "bts",
                                        "bts_variant", "bts_forms", "btl",
                                        "btl_variant", "btl_forms",
                                        "paths", "gmres", "gmres_forms",
                                        "gmres_split"))
    args = ap.parse_args(argv)
    if args.child:
        sys.path.insert(0, os.path.abspath(args.root))
        res = {"time": time_tree, "ilu": lambda: time_ilu(args.dump),
               "bts": time_bts,
               "bts_variant": lambda: time_bts(held=False),
               "bts_forms": time_bts_forms, "btl": time_btl,
               "btl_variant": lambda: time_btl(held=False),
               "btl_forms": time_btl_forms, "paths": time_paths,
               "gmres": lambda: time_gmres(args.dump),
               "gmres_forms": time_gmres_forms,
               "gmres_split": time_gmres_split,
               "sass": lambda: sass_sweeps(args.dump)}[args.child]()
        print(json.dumps(res))
        return
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("resident_variants measures the CUDA kernels: "
                           "torch.cuda.is_available() is false")
    from mpp_tpu_torch.tools.exp_spmv import card
    if args.sass:
        print(json.dumps(dict(card=card(), root=args.root, sass=_child(
            "sass", os.path.abspath(args.root), args.dump))))
        return
    if args.bts_forms:
        print(json.dumps(dict(card=card(), bts_forms_device_ms=_child(
            "bts_forms", THIS, None))))
        return
    if args.btl_forms:
        print(json.dumps(dict(card=card(), btl_forms_device_ms=_child(
            "btl_forms", THIS, None))))
        return
    if args.gmres_forms:
        print(json.dumps(dict(card=card(), gmres_forms_device_ms=_child(
            "gmres_forms", THIS, None))))
        return
    roots, mode, data = {}, "time", None
    for spec in args.tree:
        name, root = spec.split("=", 1)
        roots[name] = os.path.abspath(root)
    roots["this"] = THIS
    if args.gmres_split:
        for tree, parts in GMRES_VARIANTS.items():
            if tree not in roots:
                continue
            flat = {f"{tree}/{p}": edits for p, edits in parts.items()}
            for name in flat:
                roots[name] = make_variant(name, GMRES_SOURCE, flat,
                                           roots[tree])
    for name in args.trees or ([] if args.ilu or args.bts or args.btl
                               or args.paths or args.gmres
                               or args.gmres_split else list(VARIANTS)):
        if name != "this":
            roots[name] = make_variant(name, BTS_SOURCE, BTS_VARIANTS) \
                if args.bts else make_variant(name, BTL_SOURCE,
                                              BTL_VARIANTS) \
                if args.btl else make_variant(name)
    if args.ilu:
        mode = "ilu"
        data = os.path.join(_PKG, "_build", "ilu_sparsities.npz")
        os.makedirs(os.path.dirname(data), exist_ok=True)
        ilu_sparsities(data)
    elif args.bts:
        mode = "bts"
    elif args.btl:
        mode = "btl"
    elif args.paths:
        mode = "paths"
    elif args.gmres_split:
        mode = "gmres_split"
    elif args.gmres:
        mode = "gmres"
        data = os.path.join(_PKG, "_build", "gmres_sparsities.npz")
        os.makedirs(os.path.dirname(data), exist_ok=True)
        gmres_sparsities(data)
    order = list(roots)
    times = {name: [] for name in order}
    rounds = SPLIT_ROUNDS if args.gmres_split else ROUNDS
    for k in range(rounds):
        for name in (order + order[::-1]):
            variant = (args.bts and name in BTS_VARIANTS) or \
                (args.btl and name in BTL_VARIANTS)
            times[name].append(_child(mode + "_variant" if variant else mode,
                                      roots[name], data))
            print(f"{name} round {k}: {times[name][-1]}", flush=True)
    cases = list(times[order[0]][0])
    summary = {case: {name: sum(t[case] for t in times[name])
                      / len(times[name]) for name in order}
               for case in cases}
    print(json.dumps(dict(card=card(), order=order,
                          runs_per_tree=2 * rounds,
                          **{"mean" if args.paths else "mean_ms" if
                             args.gmres else "mean_device_ms": summary})))


if __name__ == "__main__":
    main()

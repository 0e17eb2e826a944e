"""The SpMV chain and the Jacobi smoother against variant builds of
themselves on one NVIDIA GPU, and their sweep loops counted in SASS.

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

    python -m mpp_tpu_torch.tools.resident_variants [--tree NAME=ROOT ...]
        [TREE ...]                       # default: this and every variant
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
CASES = (("float64", 16384, 30), ("float32", 16384, 30),
         ("float64", 16384, 64), ("float32", 16384, 64),
         ("float32", 131072, 256))
ITERS = 30
REPS = 20
ROUNDS = 2
# opcodes counted on the hot path
SASS_OPS = ("FADD", "FMUL", "FFMA", "DADD", "DMUL", "DFMA", "MUFU", "F2F",
            "FCHK", "FSEL", "SEL", "FSETP", "DSETP", "SHFL", "IMAD", "ISETP",
            "LOP3", "PLOP3", "LDL", "STL", "LDS", "STS", "LDG", "BRA")


def variant_source(name):
    """This checkout's SOURCE with VARIANTS[name] applied."""
    with open(os.path.join(_PKG, SOURCE)) as f:
        text = f.read()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} not in {SOURCE}")
        text = text.replace(old, new)
    return text


def make_variant(name):
    """A copy of this checkout's package with VARIANTS[name] applied;
    returns the root that holds it."""
    root = os.path.join(_PKG, "_build", "variants", name)
    pkg = os.path.join(root, "mpp_tpu_torch")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_PKG, pkg, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    with open(os.path.join(pkg, SOURCE), "w") as f:
        f.write(variant_source(name))
    return root


def _device_ms(torch, fn, tries=5):
    """Device milliseconds of one ``fn()`` (one kernel launch): the summed
    kernel durations over REPS calls, over REPS, after two warm calls."""
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
                fn()
            torch.cuda.synchronize()
            time.sleep(1e-3)
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA]
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
    """Run ``mode`` ("time" or "sass") on ``root``'s package in a process
    of its own; returns its JSON result."""
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
    ap.add_argument("--root", default=THIS)
    ap.add_argument("--dump")
    ap.add_argument("--child", choices=("time", "sass"))
    args = ap.parse_args(argv)
    if args.child:
        sys.path.insert(0, os.path.abspath(args.root))
        res = time_tree() if args.child == "time" else sass_sweeps(args.dump)
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
    roots = {"this": THIS}
    for name in args.trees or ["this", *VARIANTS]:
        if name != "this":
            roots[name] = make_variant(name)
    for spec in args.tree:
        name, root = spec.split("=", 1)
        roots[name] = os.path.abspath(root)
    order = list(roots)
    times = {name: [] for name in order}
    for k in range(ROUNDS):
        for name in (order + order[::-1]):
            times[name].append(_child("time", roots[name], None))
            print(f"{name} round {k}: {times[name][-1]}", flush=True)
    cases = list(times[order[0]][0])
    summary = {case: {name: sum(t[case] for t in times[name])
                      / len(times[name]) for name in order}
               for case in cases}
    print(json.dumps(dict(card=card(), runs_per_tree=2 * ROUNDS,
                          mean_device_ms=summary)))


if __name__ == "__main__":
    main()

"""The program's spans over a traced window: the arithmetic of the
``program_span`` metrics, and a check of the spans against the device
trace.

The port records spans (``mpp_tpu_torch/io/timers.py``) while
torch.profiler records, on ``time.time_ns()``, the clock of the
profiler's host events, so they lie over ``run.trace``'s intervals.  A
span's self time is its duration less the union of its children's
intervals; "per step" is over the traced steps (``len(run.records)``);
only spans inside ``run.trace.window`` count.  A program without the
recorder gives no spans, and every reader then returns None.

    python3 benchmark/spans.py --workload <cell> --seed <n> [--windows 2]

traces the cell's traced steps once to warm the profiler, then
``--windows`` times with the recorder on and as often with it forced off,
from the same state, in the order on, off, off, on, ..., and prints one
JSON line a window: the window a step, the device's operations and
idle share, the span metrics, the window's time outside root spans, its
device-idle time by the innermost span open over it and,
for the ``sync`` spans, the offset of each span's end from the end of the
last device activity and of the last host runtime call before it.
Then it steps the same steps untraced, with the recorder enabled and
off in the same order, a line a window.
"""
from __future__ import annotations

import bisect

import devtrace

NS = 1e-9


def window_spans(run):
    """The spans inside the traced window ([] where the program records
    none)."""
    try:
        from mpp_tpu_torch.io import timers
    except ImportError:
        return []
    get = getattr(timers, "spans", None)
    if get is None:
        return []
    lo, hi = run.trace.window
    return get(round(lo / NS), round(hi / NS))


def self_ns(spans):
    """{span index: self time [ns]}: each span's duration less the union
    of its children's intervals."""
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    return {s.index: (s.end_ns - s.start_ns) - sum(
        e - b for b, e in devtrace.union(kids.get(s.index, ()),
                                         s.start_ns, s.end_ns))
            for s in spans}


def self_ms_per_step(run, names):
    """The summed self time [ms] of the spans named ``names``, a traced
    step; None where there is none."""
    spans = window_spans(run)
    mine = [s for s in spans if s.name in names]
    if not mine or not run.records:
        return None
    own = self_ns(spans)
    return sum(own[s.index] for s in mine) * NS * 1e3 / len(run.records)


def outside_ms_per_step(run):
    """The window's time under no span [ms], a traced step."""
    spans = window_spans(run)
    lo, hi = run.trace.window
    covered = devtrace.union([(s.start_ns * NS, s.end_ns * NS)
                              for s in spans], lo, hi)
    return ((hi - lo) - sum(e - s for s, e in covered)) * 1e3 / \
        len(run.records)


def overlap_s(a, b, i=0):
    """Seconds that two sorted lists of disjoint intervals share (``a``
    from its ``i``-th)."""
    out, j = 0.0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_unspanned_pct(run):
    """The window's device-idle time under no span, as a share of all its
    device-idle time [%]."""
    spans = window_spans(run)
    if not spans:
        return None
    gaps = devtrace.gaps(run.trace)
    idle = sum(e - s for s, e in gaps)
    if idle <= 0:
        return None
    lo, hi = run.trace.window
    covered = devtrace.union([(s.start_ns * NS, s.end_ns * NS)
                              for s in spans], lo, hi)
    return 100.0 * (idle - overlap_s(gaps, covered)) / idle


def idle_by_span(run):
    """The window's device-idle time a step [ms] by the span innermost
    open over it, "(none)" under no span: which layer the host was in
    while the device waited."""
    spans = window_spans(run)
    gaps = devtrace.gaps(run.trace)
    starts = [a for a, _ in gaps]
    kids = {}
    for sp in spans:
        kids.setdefault(sp.parent, []).append((sp.start_ns * NS,
                                               sp.end_ns * NS))
    out = {}
    for sp in spans:
        a, b = sp.start_ns * NS, sp.end_ns * NS
        mine, t = [], a
        for ka, kb in devtrace.union(kids.get(sp.index, ()), a, b):
            mine.append((t, ka))
            t = kb
        mine.append((t, b))
        k = max(0, bisect.bisect_right(starts, a) - 1)
        out[sp.name] = out.get(sp.name, 0.0) + overlap_s(gaps, mine, k)
    idle = sum(e - s for s, e in gaps)
    out["(none)"] = idle - sum(out.values())
    n = len(run.records)
    return {k: v * 1e3 / n for k, v in
            sorted(out.items(), key=lambda kv: -kv[1])}


def useful_col_pct(run):
    """100 x the column-iterations of still unconverged columns over those
    evaluated, summed over the ``newton.snes`` spans."""
    snes = [s.attrs for s in window_spans(run)
            if s.name == "newton.snes" and s.attrs]
    evaluated = sum(a["cols_evaluated"] for a in snes)
    if not evaluated:
        return None
    return 100.0 * sum(a["cols_unconverged"] for a in snes) / evaluated


def _offsets_us(run, ends):
    """For each ``sync`` span: its end less the last of ``ends`` (sorted,
    s) at or before it [us]."""
    out = []
    for sp in window_spans(run):
        if sp.name != "sync":
            continue
        b = sp.end_ns * NS
        k = bisect.bisect_right(ends, b)
        if k:
            out.append((b - ends[k - 1]) * 1e6)
    return out


def sync_offsets_us(run):
    """The device timeline against the spans: for each ``sync`` span, its
    end less the end of the last device activity before it, the last the
    read waited for [us].  (The read's own device-to-host copy is not
    paired by name: on a long window CUPTI's copy records drift by up to
    milliseconds from its kernels'.)"""
    return _offsets_us(run, sorted(e for _, _, e in run.trace.device))


def host_offsets_us(run):
    """The profiler's host clock against the spans': for each ``sync``
    span, its end less the end of the last CUDA runtime call before it
    (the read's copy or stream wait) [us]."""
    return _offsets_us(run, sorted(e for n, _, e in run.trace.host
                                   if n.startswith("cuda")))


def _stats(v):
    import statistics
    return {"n": len(v), "median": statistics.median(v), "min": min(v),
            "max": max(v)} if v else None


def main(argv=None):
    import argparse
    import json
    import time
    import types

    import torch

    import run as bench_run
    from mpp_tpu_torch.io import timers

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--windows", type=int, default=2)
    ap.add_argument("--repeat", type=int, default=2,
                    help="passes over the traced steps an untraced window")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}",
                    help="JSON keys replacing the configuration's")
    a = ap.parse_args(argv)
    import importlib
    bench = bench_run.manifest()
    _, config, params = bench_run.cell_files(bench, a.workload)
    config = {**config, **json.loads(a.overrides)}
    system = importlib.import_module(f"systems.{config['system']}")
    cell = system.Cell(config, params, a.seed % (1 << 64), a.device)
    cuda = cell.device.type == "cuda"
    cell.warm()
    first, count = params["trace"]["first"], params["trace"]["steps"]
    for i in range(first):
        cell.step(i)
    prob = getattr(cell, "prob", None)
    P = prob.P.clone() if prob is not None else None
    # the cell's span metrics (the self times, which with the time outside
    # every span make up the window) and the two other readers of spans
    mets = bench_run.metrics_of(bench, "per_layer", a.workload)
    selfs = [m["name"] for m in mets if m["source"] == "program_span"]
    readers = {n: bench_run.metric_reader(n) for n in
               selfs + ["newton_useful_col_pct", "idle_unspanned_pct"]}
    for w in range(-1, 2 * a.windows):
        on = w % 4 in (0, 3)
        timers.enable(None if on else False)
        timers.clear()
        if P is not None:
            prob.P = P.clone()
        n0 = len(cell.records)
        t0 = time.perf_counter()
        tr = devtrace.profiled(
            lambda: [cell.step(i) for i in range(first, first + count)],
            cuda=cuda)
        wall = time.perf_counter() - t0
        run = types.SimpleNamespace(trace=tr, records=cell.records[n0:],
                                    cell=cell)
        if w < 0:
            continue
        row = {"recorder": "on" if on else "off",
               "window_ms_per_step": tr.window_s * 1e3 / count,
               "wall_ms_per_step": wall * 1e3 / count,
               "device_ops_per_step": len(tr.device) / count,
               "device_idle_pct": 100.0 * (1 - devtrace.busy_s(tr)
                                           / tr.window_s),
               "device": torch.cuda.get_device_name(0) if cuda else "cpu"}
        if on:
            for n, r in readers.items():
                row[n] = r.read(run)
            row["outside_ms_per_step"] = outside_ms_per_step(run)
            row["closure"] = (sum(row[n] or 0.0 for n in selfs)
                              + row["outside_ms_per_step"]) / \
                row["window_ms_per_step"]
            row["spans"] = len(window_spans(run))
            row["idle_ms_by_span"] = idle_by_span(run)
            row["sync_device_offset_us"] = _stats(sync_offsets_us(run))
            row["sync_host_offset_us"] = _stats(host_offsets_us(run))
        print(json.dumps(row), flush=True)
    # untraced: the recorder on (enabled) against off (the default), the
    # traced steps ``--repeat`` times a window
    for w in range(2 * a.windows):
        on = w % 4 in (0, 3)
        timers.enable(True if on else None)
        t0 = time.perf_counter()
        for _ in range(a.repeat):
            timers.clear()
            if P is not None:
                prob.P = P.clone()
            for i in range(first, first + count):
                cell.step(i)
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (a.repeat * count)
        print(json.dumps({"recorder": "on" if on else "off",
                          "untraced_ms_per_step": ms,
                          "spans_per_step": len(timers.spans()) / count}),
              flush=True)
    timers.enable(None)
    if cuda:
        torch.cuda.synchronize()
    return 0


if __name__ == "__main__":
    import os
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    for p in (here, os.path.dirname(here)):
        if p not in sys.path:
            sys.path.insert(0, p)
    sys.exit(main())

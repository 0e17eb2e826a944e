"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's entry in BENCHMARK.json names its configuration file
(``benchmark/configs/<config>.json``, whose ``system`` key names the driver
``benchmark/systems/<system>.py`` and its plain reference
``benchmark/reference/``); its parameters (traffic, the comparison's sample
and limits, the traced steps) are ``benchmark/workloads/<cell>.json``; each
per-layer metric is read by ``benchmark/metrics/<metric>.py``.

With ``--trace 0`` the window steps the cell for ``--seconds`` and on to
the end of the replayed schedule it is in, and the result holds the cell's
end-to-end metrics; with ``--trace 1`` the cell's
traced steps run under torch.profiler and the result holds its per-layer
metrics.  Either way the steps run are then compared with the reference,
and ``correct`` says whether every compared number kept its limit and
every step kept the configuration's guarantees.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# build and kernel caches at fixed places inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, ".bench_cache", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, ".bench_cache", "torch_extensions"))
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

#: top-level modules no run may hold (the JAX reference package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "mpp_tpu")


def forbidden_modules(names=None):
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), compared whole: ``mpp_tpu_torch`` is not ``mpp_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def load_json(path):
    with open(path) as f:
        return json.load(f)


def manifest():
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell_files(bench, name):
    """(the cell's BENCHMARK.json entry, its configuration, its
    parameters)."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = load_json(os.path.join(ROOT, conf["file"]))
    params = load_json(os.path.join(HERE, "workloads", f"{name}.json"))
    return entry, config, params


def metrics_of(bench, section, cell):
    """The metrics of a section that the cell reports."""
    return [m for m in bench[section]
            if cell in m.get("workloads", [cell])]


def p95(values):
    """The 95th percentile by nearest rank: the smallest value with at
    least 95 % of the values at or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]


def metric_reader(name):
    """The ``read(run)`` of ``metrics/<name>.py`` (module: its WRAP too)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Calls:
    """Records the arguments' shapes and dtype of every call of the
    program's kernel wrappers named (``ops/hopper_kernels``), while
    installed."""

    def __init__(self, names):
        self.names = sorted(set(names))
        self.calls = {n: [] for n in self.names}
        self._orig = {}

    def __enter__(self):
        from mpp_tpu_torch.ops import hopper_kernels as hk
        self.hk = hk
        for n in self.names:
            orig = self._orig[n] = getattr(hk, n)

            def wrapped(*args, _n=n, _orig=orig, **kw):
                ts = [a for a in args if hasattr(a, "shape")]
                self.calls[_n].append(
                    ([tuple(a.shape) for a in ts],
                     str(ts[0].dtype).replace("torch.", "") if ts else ""))
                return _orig(*args, **kw)
            setattr(hk, n, wrapped)
        return self

    def __exit__(self, *exc):
        for n, f in self._orig.items():
            setattr(self.hk, n, f)


def run_cell(name, seed, seconds, trace, device="cuda", control=False,
             overrides=None, t0=None):
    """Build, warm, time (or trace) and judge one cell; returns the
    result dict (without ``device``'s name).  ``overrides`` replaces keys
    of the configuration (the tests' small sizes); ``control`` runs the
    configuration's control in the program's place."""
    import numpy as np
    import torch
    t0 = T0 if t0 is None else t0
    bench = manifest()
    entry, config, params = cell_files(bench, name)
    config = {**config, **(overrides or {})}
    system = importlib.import_module(f"systems.{config['system']}")
    seed = int(seed) % (1 << 64)
    cell = system.Cell(config, params, seed, device, control=control)
    cell.warm()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t0
    result = {"metrics": {}, "device": {}}
    if not trace:
        # the window closes at the first end of a replayed schedule after
        # ``seconds``, so that every run averages over whole schedules
        times = []
        start = time.perf_counter()
        i = 0
        while True:
            s = time.perf_counter()
            cell.step(i)
            e = time.perf_counter()
            times.append(e - s)
            i += 1
            if e - start >= seconds and i % cell.day_steps == 0:
                break
        window = e - start
        by_kind = {}
        for r, t in zip(cell.records, times):
            by_kind.setdefault(r["kind"], []).append(t * 1e3)
        result["step_ms_by_kind"] = {
            k: [len(v), min(v), sorted(v)[len(v) // 2], max(v)]
            for k, v in by_kind.items()}
        # the p95 is ready for a cell whose runs spread little enough to
        # bound it (BENCHMARK.json names the metrics a cell reports)
        values = {"step_ms": window / len(times) * 1e3,
                  "step_ms_p95": p95(times) * 1e3, "setup_s": setup_s}
        for m in metrics_of(bench, "end_to_end", name):
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
        attempted = len(times)
    else:
        import devtrace
        first, count = params["trace"]["first"], params["trace"]["steps"]
        for i in range(first):
            cell.step(i)
        readers = {m["name"]: metric_reader(m["name"])
                   for m in metrics_of(bench, "per_layer", name)}
        wrap = [w for r in readers.values() for w in getattr(r, "WRAP", ())]
        with Calls(wrap) as calls:
            tr = devtrace.profiled(
                lambda: [cell.step(i) for i in range(first, first + count)],
                cuda=on_card)
        run = types.SimpleNamespace(
            trace=tr, records=cell.records[first:first + count],
            calls=calls.calls, cell=cell)
        for m in metrics_of(bench, "per_layer", name):
            v = readers[m["name"]].read(run)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        result["device"].update(busy_s=devtrace.busy_s(tr),
                                window_s=tr.window_s)
        result["breakdown"] = {"device_ops": devtrace.top_ops(tr),
                               "idle_gaps": devtrace.idle_by_host(tr)}
        attempted = count
    if on_card:
        torch.cuda.synchronize()
        result["device"]["memory_peak_bytes"] = \
            torch.cuda.max_memory_allocated()
    failed = cell.settle()
    cell.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = cell.judge(np.random.default_rng([seed, 1]))
    limits = params["limits"]
    checks = {"failed_steps": {"value": failed, "limit": 0}}
    if numbers is not None:
        for k, lim in limits.items():
            checks[k] = {"value": numbers[k], "limit": lim}
    correct = numbers is not None and all(
        c["value"] <= c["limit"] for c in checks.values())
    result.update(correct=bool(correct), attempted=attempted, failed=failed)
    result["checks"] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    bench = manifest()
    entry = cell_files(bench, a.workload)[0]
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        print(f"the cell needs {entry['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    res = run_cell(a.workload, a.seed, a.seconds, a.trace)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    res["device"] = {"platform": "gpu",
                     "kind": torch.cuda.get_device_name(0),
                     "count": int(entry["chips"]), **res["device"]}
    print(f"memory_peak_bytes {res['device'].get('memory_peak_bytes')}",
          file=sys.stderr)
    if "step_ms_by_kind" in res:
        print("step_ms_by_kind (steps, min, median, max) "
              + json.dumps(res["step_ms_by_kind"]), file=sys.stderr)
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    # the checks key comes last in the line
    out = {k: res[k] for k in ("correct", "attempted", "failed", "metrics",
                               "device")}
    if "breakdown" in res:
        out["breakdown"] = res["breakdown"]
    out["checks"] = res["checks"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

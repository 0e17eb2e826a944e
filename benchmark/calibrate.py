"""The readings that a cell's comparison limits are set from: the numbers
the comparison gives for sound runs of the program over many seeds, and
for the configuration's control (the nearest precision below the stated
one) over a few, at the cell's own size, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--out FILE]

Each seed is one run of the harness (``run.run_cell``) with a window of
one replayed schedule: it builds the cell, steps the schedule, judges the
steps as every run does and gives its checks and ``correct``.  One JSON
line per seed, printed (and appended to ``--out``) as it comes.  The
benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import run


def readings(name, seeds, control, device="cuda", overrides=None, out=None):
    """One harness result a seed (one schedule, ``control`` in the
    program's place or not); each also written to ``out`` as it comes."""
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        res = run.run_cell(name, seed, 0.0, 0, device=device,
                           control=control, overrides=overrides, t0=t0)
        row = dict(workload=name, seed=seed, control=control,
                   correct=res["correct"], failed=res["failed"],
                   seconds=time.perf_counter() - t0,
                   checks={k: c["value"] for k, c in res["checks"].items()})
        rows.append(row)
        print(json.dumps(row), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
        del res
        gc.collect()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
    readings(a.workload, ints(a.seeds), False, out=a.out)
    readings(a.workload, ints(a.control_seeds), True, out=a.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Structured per-step metrics stream (the port's copy of
``mpp_tpu/io/metrics.py``; host Python, no tensors).

The reference surfaces solver health as ad-hoc ``iulog`` writes and
cumulative iteration counters (SolverType.F90:40-41,140-169;
SystemOfEquationsBaseType.F90:513-519,637-640).  Production monitoring
needs a machine-readable stream instead: every ``StepDT`` emits one
record — step, dt actually used, convergence reason, Newton/linear
iteration counts, dt-cuts and line-search rotations — to an in-memory
list and optionally a JSONL file.

Attach with ``soe.metrics = MetricsStream(path)`` (any SoE whose
``step_dt`` supports it) or use ``record()`` directly from drivers.
Callers pass Python numbers: a device scalar is read on the host before
it is recorded.
"""
from __future__ import annotations

import json
import time
from typing import List, Optional


class MetricsStream:
    """Collects per-step solver metrics; optionally appends JSONL."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: List[dict] = []
        self._fh = open(path, "a") if path else None

    def record(self, **fields):
        rec = {"t_wall": time.time(), **fields}
        self.records.append(rec)
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        return rec

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # convenience views ---------------------------------------------------
    def last(self):
        return self.records[-1] if self.records else None

    def totals(self):
        out = {"steps": len(self.records),
               "newton_iterations": 0, "linear_iterations": 0,
               "dt_cuts": 0, "diverged_steps": 0}
        for r in self.records:
            out["newton_iterations"] += r.get("newton_iterations", 0)
            out["linear_iterations"] += r.get("linear_iterations", 0)
            out["dt_cuts"] += r.get("dt_cuts", 0)
            if not r.get("converged", True):
                out["diverged_steps"] += 1
        return out

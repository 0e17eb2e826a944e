"""Per-phase timers — the PetscLogEvent analog (the port's copy of
``mpp_tpu/io/timers.py``).

The reference wraps every sub-solver of the coupled ml_model in
``PetscLogEventRegister/Begin/End`` pairs
(``driver/standalone/ml_model/ml_model_problem.F90:323-336,377-409``)
so ``-log_view`` reports per-phase counts and times.  Here each phase
is a named accumulator, and each phase is a ``torch.profiler``
``record_function`` range, so it shows in a profiler trace.

The timers measure the host's clock.  On a CUDA device a phase ends with
``torch.cuda.synchronize()``, so its seconds include the device work it
queued; ``host_syncs`` counts those synchronisations.  On the CPU there
is nothing to wait for and no sync is made.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

import torch

from mpp_tpu_torch.device import device_of


class PhaseTimers:
    def __init__(self, device="cuda"):
        self.device = device_of(device)
        self._acc: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        #: device synchronisations made at the end of phases
        self.host_syncs = 0

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                self.host_syncs += 1
            dt = time.perf_counter() - t0
            self._acc[name] = self._acc.get(name, 0.0) + dt
            self._count[name] = self._count.get(name, 0) + 1

    def report(self) -> Dict[str, dict]:
        """{phase: {count, total_s, mean_s}} — the -log_view analog."""
        return {name: {"count": self._count[name],
                       "total_s": self._acc[name],
                       "mean_s": self._acc[name] / self._count[name]}
                for name in self._acc}

    def __str__(self):
        lines = ["Phase           Count   Total(s)    Mean(s)"]
        for name, s in sorted(self.report().items()):
            lines.append(f"{name:<15} {s['count']:>5} {s['total_s']:>10.4f} "
                         f"{s['mean_s']:>10.4f}")
        return "\n".join(lines)

"""Per-phase timers — the PetscLogEvent analog (the port's copy of
``mpp_tpu/io/timers.py``) — and the span recorder under them.

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

Spans.  The stepped path (the ALM driver, the batched Newton, assembly,
the linear solve and every host read of a device value) marks its layers
with spans: ``(name, start_ns, end_ns, parent, attrs)`` on
``time.time_ns()``, the clock of torch.profiler's host events, so spans
lie over a profiler trace's device intervals.  ``parent`` is the index of
the span that was innermost open when the span began (-1 for none); a span
with no parent starts a new step identifier (``step``), which its
descendants share; ``attrs`` is an optional small dict of counts.  The
recorder records while torch.profiler records, or after :func:`enable`;
otherwise a span site costs one check and records nothing: no
allocation, no device synchronisation and no ``record_function`` (spans
never become profiler events, which kineto would mirror onto the device
timeline).  Spans stay in memory: :func:`spans` reads them back and
:func:`clear` drops them.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict

import torch

from mpp_tpu_torch.device import device_of

_profiling = torch.autograd._profiler_enabled


class Span:
    """One recorded span; ``end_ns`` is None while it is open."""
    __slots__ = ("index", "name", "start_ns", "end_ns", "parent", "step",
                 "attrs")

    def __init__(self, index, name, start_ns, parent, step, attrs):
        self.index, self.name, self.start_ns = index, name, start_ns
        self.end_ns, self.parent, self.step = None, parent, step
        self.attrs = attrs

    def __repr__(self):
        return (f"Span({self.index}, {self.name!r}, {self.start_ns}, "
                f"{self.end_ns}, parent={self.parent}, step={self.step}, "
                f"attrs={self.attrs})")


class SpanRecorder:
    """The spans of one process, in the order they began.  ``mode``: None
    records while torch.profiler records (the default); True always;
    False never."""

    def __init__(self):
        self.mode = None
        self.records = []
        self.open = []           # indices of the open spans, innermost last
        self.steps = 0

    def enable(self, mode=True):
        """Record always (True), never (False), or while torch.profiler
        records (None, the default)."""
        self.mode = mode

    def begin(self, name, attrs=None):
        """Open a span inside the innermost open one; returns its index,
        -1 when not recording."""
        m = self.mode
        if not (m or (m is None and _profiling())):
            return -1
        recs, stack = self.records, self.open
        i = len(recs)
        if stack:
            parent = stack[-1]
            step = recs[parent].step
        else:
            parent, step = -1, self.steps
            self.steps += 1
        recs.append(Span(i, name, time.time_ns(), parent, step, attrs))
        stack.append(i)
        return i

    def end(self, i, attrs=None):
        """Close span ``i`` (and any span opened inside it and left open),
        merging ``attrs`` into its own.  -1 (not recorded) is a no-op."""
        if i < 0 or i not in self.open:
            return
        t = time.time_ns()
        while True:
            j = self.open.pop()
            self.records[j].end_ns = t
            if j == i:
                break
        if attrs:
            rec = self.records[i]
            rec.attrs = {**rec.attrs, **attrs} if rec.attrs else dict(attrs)

    def end_named(self, name):
        """Close the innermost open span named ``name``, if one is open."""
        for i in reversed(self.open):
            if self.records[i].name == name:
                self.end(i)
                return

    def spans(self, lo_ns=None, hi_ns=None):
        """The closed spans that lie inside [lo_ns, hi_ns]."""
        return [s for s in self.records if s.end_ns is not None
                and (lo_ns is None or s.start_ns >= lo_ns)
                and (hi_ns is None or s.end_ns <= hi_ns)]

    def clear(self):
        self.records, self.open = [], []


#: the process's recorder, behind every span site of the port
RECORDER = SpanRecorder()
enable = RECORDER.enable
begin = RECORDER.begin
end = RECORDER.end
spans = RECORDER.spans
clear = RECORDER.clear


class Site:
    """A span site: ``with SITE:`` records a span named ``name`` (with the
    fixed ``attrs``) around the block while the recorder records.  Built
    once, where the code is defined; the exit closes the innermost open
    span of the site's name."""
    __slots__ = ("name", "attrs")

    def __init__(self, name, attrs=None):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        RECORDER.begin(self.name, self.attrs)

    def __exit__(self, exc_type, exc, tb):
        if RECORDER.open:
            RECORDER.end_named(self.name)


class PhaseTimers:
    def __init__(self, device="cuda"):
        self.device = device_of(device)
        self._acc: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        #: device synchronisations made at the end of phases
        self.host_syncs = 0

    @contextmanager
    def phase(self, name: str):
        """A phase: its seconds accumulated under ``name``, a
        ``record_function`` range and, while the recorder records, a span
        that ends after the phase's synchronisation."""
        t0 = time.perf_counter()
        span = RECORDER.begin(name)
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                self.host_syncs += 1
            RECORDER.end(span)
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

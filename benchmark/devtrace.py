"""The traced window: torch.profiler (CUPTI) over a run of steps, reduced to
device activity intervals, the host spans around them, and the arithmetic
of busy time, idle gaps and top operations."""
from __future__ import annotations

import dataclasses

WINDOW = "bench_window"


@dataclasses.dataclass
class Trace:
    """``device``: (name, start_s, end_s) of every device activity
    (kernels, copies, fills), in start order; ``host``: (name, start_s,
    end_s) of the host's operator and runtime events; ``window``: (start_s,
    end_s) of the traced window on the same clock."""
    device: list
    host: list
    window: tuple

    @property
    def window_s(self):
        return self.window[1] - self.window[0]

    def kernels(self, *names):
        """(start, end) of the device activities whose name holds one of
        ``names``."""
        return [(s, e) for n, s, e in self.device
                if any(k in n for k in names)]


def profiled(fn, cuda=True):
    """Run ``fn()`` (which waits for the device at its end) under the
    profiler; return its Trace.  ``cuda=False`` traces the host alone (the
    CPU tests)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
            sync()
    return from_events(prof.profiler.kineto_results.events())


def from_events(events):
    """A Trace from kineto's events (``name()``, ``device_type()``,
    ``start_ns()``, ``duration_ns()``)."""
    from torch.autograd import DeviceType
    device, host, window = [], [], None
    for e in events:
        s = e.start_ns() * 1e-9
        t = s + e.duration_ns() * 1e-9
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            # the window's annotation is mirrored on the device's timeline
            if name != WINDOW:
                device.append((name, s, t))
        elif name == WINDOW:
            window = (s, t)
        else:
            host.append((name, s, t))
    device.sort(key=lambda x: x[1])
    if window is None:
        raise RuntimeError("the trace holds no window span")
    return Trace(device=device, host=host, window=window)


def union(intervals, lo=None, hi=None):
    """Merged (start, end) intervals, clipped to [lo, hi]."""
    out = []
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def busy_s(trace):
    """Seconds of the window in which some device activity ran."""
    lo, hi = trace.window
    return sum(e - s for s, e in union([(s, e) for _, s, e in trace.device],
                                       lo, hi))


def gaps(trace):
    """The window's idle stretches: (start, end) between busy ones."""
    lo, hi = trace.window
    busy = union([(s, e) for _, s, e in trace.device], lo, hi)
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = e
    if hi > t:
        out.append((t, hi))
    return out


def idle_by_host(trace, top=10):
    """Idle seconds of the window by what the host was doing at each gap's
    middle, largest first: [[name, seconds], ...].  The host's events nest,
    so a sweep in time order keeps the open ones on a stack; the innermost
    open event names the gap, "python" where none is open."""
    host = sorted(trace.host, key=lambda x: x[1])
    sums, stack, i = {}, [], 0
    for s, e in gaps(trace):
        mid = 0.5 * (s + e)
        while i < len(host) and host[i][1] <= mid:
            while stack and stack[-1][2] < host[i][1]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][2] < mid:
            stack.pop()
        label = stack[-1][0] if stack else "python"
        sums[label] = sums.get(label, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])
            [:top]]


def top_ops(trace, top=10):
    """Device seconds by activity name, largest first: [[name, s], ...]."""
    sums = {}
    for n, s, e in trace.device:
        sums[n] = sums.get(n, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(sums.items(), key=lambda kv: -kv[1])
            [:top]]

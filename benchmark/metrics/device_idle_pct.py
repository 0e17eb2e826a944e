"""The share of the traced window in which no operation ran on the card:
the window less the union of the device activities' intervals."""
import devtrace


def read(run):
    w = run.trace.window_s
    if w <= 0 or not run.trace.device:
        return None
    return 100.0 * (1.0 - devtrace.busy_s(run.trace) / w)

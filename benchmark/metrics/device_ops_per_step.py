"""Device operations (kernels, copies, fills) a step over the traced
steps: the eager dispatch of the batched Newton's tensor code."""


def read(run):
    if not run.trace.device or not run.records:
        return None
    return len(run.trace.device) / len(run.records)

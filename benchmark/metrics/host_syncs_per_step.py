"""Host reads of device values a step: the stepper's counted syncs (its
dt ladder, Newton and line-search predicates, GMRES flags) and the ALM
driver's diagnostic pulls."""


def read(run):
    vals = [r["host_syncs"] for r in run.records if "host_syncs" in r]
    return sum(vals) / len(vals) if vals else None

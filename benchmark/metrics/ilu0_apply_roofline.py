"""The ILU(0) apply kernel's share of its roofline over the traced steps:
every launch's bound (``roofline.ilu0_apply_work`` on the system's
sparsity as the reference builds it) over its device time."""
import roofline

WRAP = ("ilu0_apply",)


def read(run):
    calls = run.calls["ilu0_apply"]
    if not calls or not hasattr(run.cell, "sparsity"):
        return None
    n, nnz = run.cell.sparsity()
    works = []
    for shapes, dtype in calls:
        b = shapes[1]
        B = 1
        for d in b[:-1]:
            B *= d
        works.append((*roofline.ilu0_apply_work(B, n, nnz, dtype),
                      roofline.PEAK_OPS_S))
    return roofline.launch_share(run.trace, ("ilu0_apply_",), works,
                                 calls[0][1])

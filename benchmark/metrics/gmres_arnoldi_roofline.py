"""The GMRES Arnoldi-step kernel's share of its roofline over the traced
steps.  A step's work grows with its index j in the cycle
(``roofline.gmres_arnoldi_work``); j counts the Arnoldi launches since the
last cycle update (``update_warp`` / ``update_cluster``), which ends every
cycle, in the trace's order; the dtype is the cell's configuration's."""
import roofline


def read(run):
    if not hasattr(run.cell, "krylov_shape"):
        return None
    ncol, n, m = run.cell.krylov_shape()
    dtype = run.cell.dtype
    works, j = [], 0
    for name, _, _ in run.trace.device:
        if "arnoldi_warp" in name or "arnoldi_cluster" in name:
            works.append((*roofline.gmres_arnoldi_work(ncol, n, m, j, dtype),
                          roofline.PEAK_OPS_S))
            j += 1
        elif "update_warp" in name or "update_cluster" in name:
            j = 0
    if not works:
        return None
    return roofline.launch_share(run.trace, ("arnoldi_warp",
                                             "arnoldi_cluster"), works, dtype)

"""The batched Thomas kernel's share of its roofline over the traced
steps: every launch's bound (bytes at 3.35 TB/s or operations at the
dtype's peak, ``roofline.thomas_work``) over its device time."""
import roofline

WRAP = ("thomas",)


def read(run):
    works = []
    for shapes, dtype in run.calls["thomas"]:
        ncol, nz = shapes[1]
        works.append((*roofline.thomas_work(ncol, nz, dtype),
                      roofline.PEAK_OPS_S))
    if not works:
        return None
    return roofline.launch_share(run.trace, ("thomas_kernel",), works,
                                 run.calls["thomas"][0][1])

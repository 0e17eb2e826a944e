"""The block-Thomas kernel for blocks past 8 x 8 (block and cluster forms):
its share of its roofline over the traced steps, every launch's bound
(LAPACK's getrf + getrs operations at the matrix peak, ``roofline.btl_ops``,
or its bytes) over its device time."""
import roofline

WRAP = ("block_thomas_large",)


def read(run):
    calls = run.calls["block_thomas_large"]
    if not calls:
        return None
    works = []
    for shapes, dtype in calls:
        *lead, n, m = shapes[3]
        B = 1
        for d in lead:
            B *= d
        works.append((roofline.btl_bytes(m, n, B, dtype),
                      roofline.btl_ops(m, n, B), roofline.PEAK_MATRIX_OPS_S))
    return roofline.launch_share(
        run.trace, ("btl_block_kernel", "btl_cluster_kernel"), works,
        calls[0][1])

"""The yardstick of the kernels' roofline shares: the card's published peaks
and the bytes and operations each kernel's launches need.

Frozen copies, so that a later change to the program cannot move them:
``HBM_BYTES_S`` / ``PEAK_OPS_S`` / ``PEAK_MATRIX_OPS_S`` and ``bound`` from
chip_smoke.py:461-463 and :690; the Thomas counts from its ``STREAMS`` /
``OPS`` tables (:508-510); ``gmres_arnoldi_work`` from ``gmres_work``
(:3996); ``btl_ops`` and ``btl_bytes`` from ``btl_ops`` (:3591) and
``block_row`` (:3609); ``ilu0_apply_work`` from ``ilu_work`` (:3200), with
its operations counted from the sparsity alone (the original also reads a
count from the program's schedule).  Counting rule: each input read once,
each output written once, whatever a kernel reads again.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, 700 W: HBM3 bytes/s; operations/s outside
# the tensor cores; operations/s of matrix-shaped work (LU, block
# products): f64 on the tensor cores, f32 outside them
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float64": 34e12, "float32": 67e12}
PEAK_MATRIX_OPS_S = {"float64": 67e12, "float32": 67e12}
ELEM = {"float64": 8, "float32": 4}


def bound_s(nbytes, ops, dtype, peaks=PEAK_OPS_S):
    """The least time [s] the card could take: the larger of ``nbytes``
    over the HBM rate and ``ops`` over the peak rate of ``dtype``."""
    return max(nbytes / HBM_BYTES_S, ops / peaks[dtype])


def thomas_work(ncol, nz, dtype):
    """(bytes, operations) of one batched Thomas solve: dl, d, du, b read,
    x written (5 values a cell); 8 operations a cell."""
    cells = ncol * nz
    return 5 * cells * ELEM[dtype], 8 * cells


def ilu0_apply_work(B, n, nnz, dtype):
    """(bytes, operations) of one ILU(0) apply to B systems of n rows and
    nnz stored values: the factor's values, b read and x written once, the
    sparsity read once as an int32 CSR; a multiply and an add for each
    off-diagonal value of the two sweeps, a subtract and a divide a row."""
    csr = 4 * (n + 1 + nnz)
    return (B * (nnz + 2 * n) * ELEM[dtype] + csr,
            B * (2 * (nnz - n) + 2 * n))


def gmres_arnoldi_work(ncol, n, m, j, dtype):
    """(bytes, operations) of Arnoldi step ``j`` of GMRES(m) on ncol
    columns of n rows: V's rows 0..j and w read once, V_{j+1} and H's
    column written once; ~(4 (j + 1) + 3) n operations a column."""
    return (((j + 3) * n + m + 1) * ncol * ELEM[dtype],
            (4 * (j + 1) + 3) * n * ncol)


def btl_ops(m, n, B):
    """Operations of B block-Thomas solves of n levels of m x m blocks, as
    LAPACK's getrf + getrs count them: at levels 1..n-1 the products L_k
    [Cp_{k-1} | dp_{k-1}] with their differences from [D_k | b_k]; at every
    level the LU of the pivot block and its solve of m + 1 right-hand
    columns (1 at the last level); at levels 0..n-2 the back substitution's
    dp_k - Cp_k x_{k+1}."""
    lu = (4 * m ** 3 - 3 * m ** 2 - m) // 6
    cols = (n - 1) * (m + 1) + 1
    return (n * lu + (n - 1) * (2 * m * m * (m + 1) + 2 * m * m)
            + cols * (2 * m * m - m)) * B


def btl_bytes(m, n, B, dtype):
    """L, D, U and b read once, x written once."""
    return (3 * m * m + 2 * m) * n * B * ELEM[dtype]


def share_pct(bound_total_s, device_total_s):
    """A kernel's share of its roofline [%]: the summed bounds of its
    launches over their summed device time; None without device time."""
    if not device_total_s or device_total_s <= 0.0:
        return None
    return 100.0 * bound_total_s / device_total_s


def launch_share(trace, names, works, dtype):
    """The roofline share [%] of a kernel's launches in the traced window:
    ``names`` match its device activities, ``works`` holds (bytes,
    operations, peaks) of each launch in launch order.  None when the trace
    lost launches (its count differs) or holds none."""
    spans = trace.kernels(*names)
    if not spans or len(spans) != len(works):
        return None
    bound = sum(bound_s(b, o, dtype, peaks) for b, o, peaks in works)
    return share_pct(bound, sum(e - s for s, e in spans))

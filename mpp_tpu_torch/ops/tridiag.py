"""Batched tridiagonal solve and stencil SpMV — the plain PyTorch versions.

Counterpart of ``mpp_tpu/ops/tridiag.py``.  These are the references the
CUDA kernels of ``ops/hopper_kernels.py`` are held against, and the forms
the kernel wrappers run for CPU tensors.  Batch leading, levels last:
every argument is ``[..., n]``.
"""
from __future__ import annotations

import torch


def thomas(dl, d, du, b):
    """Solve batched tridiagonal systems T x = b (Thomas algorithm).

    ``dl`` sub-diagonal (``dl[..., 0]`` unused), ``d`` diagonal, ``du``
    super-diagonal (``du[..., n-1]`` unused), ``b`` right-hand side; all
    ``[..., n]``.  No pivoting: the systems must be diagonally dominant
    (the Richards Jacobian is).  The forward sweep keeps the reference's
    ``a / denom`` recurrence; the level loop is a Python loop (the JAX
    form's ``lax.scan``)."""
    n = d.shape[-1]
    cp = torch.empty_like(d)
    bp = torch.empty_like(b)
    cpm = torch.zeros_like(d[..., 0])
    bpm = torch.zeros_like(b[..., 0])
    for k in range(n):
        dlk = dl[..., k]
        denom = d[..., k] - dlk * cpm
        cpm = du[..., k] / denom
        bpm = (b[..., k] - dlk * bpm) / denom
        cp[..., k] = cpm
        bp[..., k] = bpm
    x = torch.empty_like(b)
    xn = torch.zeros_like(b[..., 0])
    for k in range(n - 1, -1, -1):
        xn = bp[..., k] - cp[..., k] * xn
        x[..., k] = xn
    return x


def tridiag_matvec(dl, d, du, x):
    """y = T x for batched tridiagonal T given as three diagonals
    ``[..., n]`` (``dl[..., 0]`` and ``du[..., n-1]`` unused)."""
    z = torch.zeros_like(x[..., :1])
    lo = torch.cat([z, dl[..., 1:] * x[..., :-1]], -1)
    hi = torch.cat([du[..., :-1] * x[..., 1:], z], -1)
    return d * x + lo + hi


def tridiag_spmv_chain(dl, d, du, x, iters, scale=1.0):
    """y = (scale * T)^iters x, one stencil application at a time: the
    plain form of ``mpp_tpu/ops/pallas_kernels.tridiag_spmv_chain``, in its
    order of operations (``tridiag_matvec(...) * scale``)."""
    for _ in range(iters):
        x = tridiag_matvec(dl, d, du, x) * scale
    return x


def tridiag_jacobi_smooth(dl, d, du, b, x, iters, omega=2.0 / 3.0):
    """``iters`` weighted-Jacobi sweeps x <- x + omega * (b - T x) / d: the
    plain form of ``pallas_kernels.tridiag_jacobi_smooth``, with its division
    by the diagonal (not a multiplication by its reciprocal)."""
    for _ in range(iters):
        x = x + omega * (b - tridiag_matvec(dl, d, du, x)) / d
    return x

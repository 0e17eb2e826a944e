"""Batched block-tridiagonal solve (block Thomas) and its matvec.

Counterpart of ``mpp_tpu/ops/block_thomas.py``.  Plain PyTorch: the level
loop is a Python loop (the JAX form's ``lax.scan``), every level a batched
``[..., m, m]`` small solve.  :func:`block_thomas` at m=2 is the plain
version of the ``block_thomas2`` CUDA kernel (``ops/hopper_kernels.py``),
the TH Newton direction.
"""
from __future__ import annotations

import torch


def small_solve(A, B):
    """Solve A X = B for batched tiny blocks: A ``[..., m, m]``, B
    ``[..., m, k]``.

    m <= 2 uses the closed form (the 2x2 adjugate, divided by det);
    3 <= m <= 8 an unrolled Gauss-Jordan with per-batch partial pivoting;
    larger m ``torch.linalg.solve``."""
    m = A.shape[-1]
    if m == 1:
        return B / A[..., 0:1, :]
    if m == 2:
        a, b_ = A[..., 0, 0], A[..., 0, 1]
        c, d = A[..., 1, 0], A[..., 1, 1]
        det = a * d - b_ * c
        x0 = d[..., None] * B[..., 0, :] - b_[..., None] * B[..., 1, :]
        x1 = -c[..., None] * B[..., 0, :] + a[..., None] * B[..., 1, :]
        return torch.stack([x0, x1], dim=-2) / det[..., None, None]
    if m > 8:
        return torch.linalg.solve(A, B)
    M = torch.cat([A, B], dim=-1)                       # [..., m, m+k]
    rows = torch.arange(m, device=A.device)
    for j in range(m):
        # partial pivot: the largest |entry| in column j at row >= j
        colj = torch.where(rows >= j, torch.abs(M[..., :, j]), -torch.inf)
        p = torch.argmax(colj, dim=-1)                  # [...]
        idx = torch.where(rows == j, p[..., None],
                          torch.where(rows == p[..., None], j, rows))
        M = torch.take_along_dim(M, idx[..., None], dim=-2)
        piv = M[..., j, :]                              # [..., m+k]
        fac = M[..., :, j] / piv[..., j][..., None]
        fac = torch.where(rows == j, 0.0, fac)          # keep row j
        M = M - fac[..., None] * piv[..., None, :]
    diag = torch.diagonal(M[..., :m], dim1=-2, dim2=-1)
    return M[..., m:] / diag[..., None]


def block_thomas(L, D, U, b):
    """Solve batched block-tridiagonal systems.

    ``L``/``D``/``U`` ``[..., n, m, m]`` sub-, main and super-diagonal
    blocks (``L[..., 0]`` and ``U[..., n-1]`` unused), ``b`` ``[..., n, m]``;
    returns x ``[..., n, m]``.  Forward elimination with an [m, m] small
    solve per level, then back substitution.  No pivoting across levels:
    the diagonal blocks of the eliminated system must stay invertible
    (block diagonal dominance)."""
    n, m = b.shape[-2], b.shape[-1]
    Cp = torch.empty_like(D)
    dp = torch.empty_like(b)
    Cpm = torch.zeros_like(D[..., 0, :, :])
    dpm = torch.zeros_like(b[..., 0, :])
    for k in range(n):
        Lk = L[..., k, :, :]
        denom = D[..., k, :, :] - Lk @ Cpm
        rhs = torch.cat([U[..., k, :, :],
                         (b[..., k, :] - (Lk @ dpm[..., None])[..., 0])
                         [..., None]], dim=-1)
        sol = small_solve(denom, rhs)                   # [..., m, m+1]
        Cpm = sol[..., :m]
        dpm = sol[..., m]
        Cp[..., k, :, :] = Cpm
        dp[..., k, :] = dpm
    x = torch.empty_like(b)
    xn = torch.zeros_like(b[..., 0, :])
    for k in range(n - 1, -1, -1):
        xn = dp[..., k, :] - (Cp[..., k, :, :] @ xn[..., None])[..., 0]
        x[..., k, :] = xn
    return x


def block_tridiag_matvec(L, D, U, x):
    """y = T x for batched block-tridiagonal T; shapes as in
    :func:`block_thomas`, x ``[..., n, m]``."""
    y = (D @ x[..., None])[..., 0]
    lo = (L[..., 1:, :, :] @ x[..., :-1, :, None])[..., 0]
    hi = (U[..., :-1, :, :] @ x[..., 1:, :, None])[..., 0]
    y[..., 1:, :] += lo
    y[..., :-1, :] += hi
    return y

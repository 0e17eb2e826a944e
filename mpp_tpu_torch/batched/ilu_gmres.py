"""Padded-row (ELL) CSR SpMV: the Jacobian action of non-banded plans.

Counterpart of ``make_ell_matvec`` (``mpp_tpu/batched/ilu_gmres.py:
165-186``).  The TH stepper's line search takes its initial slope F·(J Y)
through it on the assembled CSR data; the JAX package computes it outside
any Pallas kernel, so it stays plain PyTorch.  The batched ILU(0) and
GMRES of the JAX module are not ported yet (ROADMAP Slice D).
"""
from __future__ import annotations

import numpy as np
import torch


def make_ell_matvec(indptr, indices):
    """``matvec(data, x)``: y = A x for CSR data ``[..., nnz]`` and x
    ``[..., n]``, batched over the leading axes of both.  Each row is
    padded to the widest row; the padding contributes 0."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    n = len(indptr) - 1
    W = max(int(np.diff(indptr).max(initial=0)), 1)
    pos = np.zeros((n, W), np.int64)
    col = np.zeros((n, W), np.int64)
    val = np.zeros((n, W), bool)
    for i in range(n):
        for w, p in enumerate(range(indptr[i], indptr[i + 1])):
            pos[i, w] = p
            col[i, w] = indices[p]
            val[i, w] = True
    cache = {}

    def matvec(data, x):
        key = str(x.device)
        if key not in cache:
            cache[key] = tuple(torch.as_tensor(a, device=x.device)
                               for a in (pos, col, val))
        post, colt, valt = cache[key]
        prod = torch.where(valt, data[..., post] * x[..., colt], 0.0)
        return torch.sum(prod, dim=-1)

    return matvec

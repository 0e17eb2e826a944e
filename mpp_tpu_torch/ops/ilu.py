"""ILU(0) and PETSc-default GMRES for one system (the serial callers' API).

Counterpart of ``mpp_tpu/ops/ilu.py`` (the JAX package's numpy parity
engine): the same names (``CSRMatrix``, ``csr_matvec``, ``ILU0``,
``petsc_gmres``) and semantics, built as one-column wrappers over the
batched engine of ``batched/ilu_gmres.py``.  The data stays on the
caller's device: a serial step on the card solves on the card.

``petsc_gmres`` is GMRES(m) with left ILU(0) preconditioning, classical
Gram-Schmidt, Givens rotations and convergence on the recurrence-estimated
preconditioned residual, rnorm <= max(rtol * rnorm0, atol), from a zero
initial guess.  It returns the total inner iterations, as the JAX
function does, with the numpy engine's Krylov dimension (``restart``
itself, also on a system smaller than it) and its inner-iteration cap
``maxiter``, so that the counts of the serial solvers match JAX's.
"""
from __future__ import annotations

import numpy as np
import torch

from mpp_tpu_torch.batched.ilu_gmres import (BatchedILU0, gmres_cycles,
                                             make_ell_matvec)


def _tensor(a, device, dtype=None):
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           device=device, dtype=dtype)


def csr_matvec(indptr, indices, data, x):
    """y = A x for one CSR matrix (``data`` [nnz] and ``x`` [n] tensors on
    one device); each row accumulates left to right on the CPU, as
    PETSc's MatMult_SeqAIJ."""
    n = len(indptr) - 1
    rows = torch.as_tensor(np.repeat(np.arange(n), np.diff(indptr)),
                           device=x.device)
    cols = _tensor(np.asarray(indices, np.int64), x.device)
    return x.new_zeros(n).index_add_(0, rows, data * x[cols])


class CSRMatrix:
    """Minimal CSR container: the sparsity in numpy, the values a tensor
    (on the device of ``data``, or the CPU for numpy data)."""

    def __init__(self, n, indptr, indices, data):
        self.n = n
        self.indptr = np.asarray(indptr, np.int64)
        self.indices = np.asarray(indices, np.int64)
        self.data = torch.as_tensor(data, dtype=torch.float64) \
            if not torch.is_tensor(data) else data

    def matvec(self, x):
        return csr_matvec(self.indptr, self.indices, self.data, x)


class ILU0:
    """ILU(0) in natural ordering on a fixed CSR sparsity (PETSc PCILU
    defaults: levels=0, no shift): :class:`BatchedILU0` at one column."""

    def __init__(self, indptr, indices):
        self.indptr = np.asarray(indptr, np.int64)
        self.indices = np.asarray(indices, np.int64)
        self.n = len(self.indptr) - 1
        self.batched = BatchedILU0(self.indptr, self.indices)
        self.diag_pos = self.batched.diag_pos
        self.matvec = make_ell_matvec(self.indptr, self.indices)

    def factor(self, data):
        """Numeric IKJ factorization of ``data`` [nnz] (a tensor); returns
        the LU values on the sparsity."""
        return self.batched.factor(data[None, :])[0]

    def solve(self, f, b):
        """(LU)^-1 b: unit-lower forward solve, then the upper back solve."""
        return self.batched.solve(f[None, :], b[None, :])[0]


def petsc_gmres(indptr, indices, data, b, pc: ILU0 = None, pc_data=None,
                rtol=1e-5, atol=1e-50, restart=30, maxiter=10000,
                sync=None):
    """GMRES(m) replicating PETSc KSPGMRES defaults on one system:
    ``data`` [nnz] and ``b`` [n] tensors on one device (the solve's).
    ``sync(flag)`` reads a device bool on the host (default: ``.item()``).
    Returns (x [n], inner iterations, converged)."""
    matvec = pc.matvec if pc is not None else make_ell_matvec(indptr,
                                                              indices)
    x, _, done, its = gmres_cycles(
        matvec, data[None, :], b[None, :],
        ilu=None if pc is None else pc.batched,
        pc_data=None if pc_data is None else pc_data[None, :],
        rtol=rtol, atol=atol, restart=restart, maxcycles=maxiter,
        sync=sync, full_restart=True, maxiter=maxiter)
    return x[0], int(its[0]), bool(done[0])

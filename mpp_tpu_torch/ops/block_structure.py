"""COO -> batched block-tridiagonal structure.

Counterpart of ``mpp_tpu/ops/block_structure.py``.  KSP-path systems are
assembled per column: cells are ordered column-major (cell = col*nlev + k)
and every coupling stays within a level or reaches level k±1 of the same
column.  The same COO values scatter into [ncol, nlev, m, m] sub/diag/super
blocks, solved by the batched block-Thomas sweep (:func:`block_solve`).

The template is built once from the (rows, cols) pattern (numpy);
``assemble`` is one ``index_add_`` over the last dimension, batched over
any leading dimensions of the values.
"""
from __future__ import annotations

import numpy as np
import torch

from mpp_tpu_torch.ops import hopper_kernels as hk
from mpp_tpu_torch.ops.block_thomas import block_thomas


def block_solve(L, D, U, b):
    """Batched block-Thomas solve routed by block size: m <= 8 is the
    ``block_thomas_small`` kernel (its plain form on CPU tensors), larger
    blocks the plain level loop (``ops/block_thomas.block_thomas``), as the
    JAX package's small_solve sends m > 8 to a library solve.  The route
    is chosen by shape, never on a failure."""
    if b.shape[-1] <= hk.BLOCK_SMALL_MAX:
        return hk.block_thomas_small(L.contiguous(), D.contiguous(),
                                     U.contiguous(), b.contiguous())
    return block_thomas(L, D, U, b)


def chain_shape(ncells: int, rows: np.ndarray, cols: np.ndarray,
                dof: int = 1):
    """Infer (ncol, nlev) of equal-length contiguous cell chains from a
    COO pattern whose couplings only reach cell i±1.

    Cells i and i+1 belong to the same chain iff any entry couples them;
    chains must all have the same length for the batched layout."""
    cell_r = np.asarray(rows, np.int64) // dof
    cell_c = np.asarray(cols, np.int64) // dof
    linked = np.zeros(max(ncells - 1, 0), bool)
    d = cell_c - cell_r
    if np.abs(d).max(initial=0) > 1:
        raise ValueError("coupling reaches beyond cell i±1")
    linked[cell_r[d == 1]] = True
    linked[cell_c[d == -1]] = True
    breaks = np.nonzero(~linked)[0] + 1
    lengths = np.diff(np.concatenate([[0], breaks, [ncells]]))
    lengths = lengths[lengths > 0]
    if lengths.size == 0:
        return 1, ncells
    if np.unique(lengths).size != 1:
        raise ValueError(f"unequal chain lengths {sorted(set(lengths))}")
    nlev = int(lengths[0])
    return ncells // nlev, nlev


class BlockTridiagTemplate:
    """Maps COO entries of a per-column banded system onto L/D/U blocks.

    Global dof index convention: g = (col*nlev + k)*dof + j."""

    def __init__(self, ncol: int, nlev: int, dof: int,
                 rows: np.ndarray, cols: np.ndarray):
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        cell_r, j_r = np.divmod(rows, dof)
        cell_c, j_c = np.divmod(cols, dof)
        col_r, k_r = np.divmod(cell_r, nlev)
        col_c, k_c = np.divmod(cell_c, nlev)
        if not np.array_equal(col_r, col_c):
            raise ValueError("coupling crosses column boundaries")
        dk = k_c - k_r
        if np.abs(dk).max(initial=0) > 1:
            raise ValueError("coupling reaches beyond level k±1")
        band = dk + 1  # 0 = L, 1 = D, 2 = U
        self.ncol, self.nlev, self.dof = ncol, nlev, dof
        self.dest = (((band * ncol + col_r) * nlev + k_r) * dof * dof
                     + j_r * dof + j_c)
        self._flat_len = 3 * ncol * nlev * dof * dof
        self._dest_on = {}       # device -> dest as a long tensor there

    def assemble(self, vals):
        """Scatter COO values ``[..., ncoo]`` (the template's rows/cols
        order) into (L, D, U) blocks ``[..., ncol, nlev, dof, dof]``."""
        batch = vals.shape[:-1]
        dest = self._dest_on.get(vals.device)
        if dest is None:
            dest = torch.as_tensor(self.dest, device=vals.device)
            self._dest_on[vals.device] = dest
        flat = vals.new_zeros(batch + (self._flat_len,)) \
            .index_add_(-1, dest, vals)
        blocks = flat.view(batch + (3, self.ncol, self.nlev, self.dof,
                                    self.dof))
        return blocks.unbind(len(batch))

    def solve(self, vals, b):
        """Assemble and solve: b ``[..., ncol*nlev*dof]``; returns x
        ``[..., ncol, nlev, dof]``."""
        L, D, U = self.assemble(vals)
        bb = b.reshape(b.shape[:-1] + (self.ncol, self.nlev, self.dof))
        return block_solve(L, D, U, bb)

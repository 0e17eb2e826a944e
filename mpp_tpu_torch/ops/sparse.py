"""Static-sparsity CSR assembly from connection-set scatter contributions.

Counterpart of ``mpp_tpu/ops/sparse.py``: the (row, col) contribution
slots are known at set-up time from the connection sets, so the sparsity
and a COO->CSR slot map are built once in numpy, and assembly is one
``index_add_`` of the contribution values along the last dimension.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSRTemplate:
    """Static CSR sparsity + COO->CSR slot map (numpy)."""
    n_rows: int
    n_cols: int
    indptr: np.ndarray      # [n_rows+1] int32
    indices: np.ndarray     # [nnz] int32 column indices
    slots: np.ndarray       # [ncoo] int32: csr slot of each contribution

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def row_ids(self) -> np.ndarray:
        return np.repeat(np.arange(self.n_rows, dtype=np.int32),
                         np.diff(self.indptr))

    def assemble(self, values: torch.Tensor) -> torch.Tensor:
        """Scatter-add COO contribution values ``[..., ncoo]`` into CSR data
        ``[..., nnz]``."""
        slots = torch.as_tensor(self.slots, dtype=torch.long,
                                device=values.device)
        data = values.new_zeros(values.shape[:-1] + (self.nnz,))
        return data.index_add_(-1, slots, values)

    def to_dense(self, data: torch.Tensor) -> torch.Tensor:
        """CSR data ``[..., nnz]`` as dense matrices ``[..., n_rows,
        n_cols]`` (the dense-LU plan)."""
        flat = torch.as_tensor(self.row_ids().astype(np.int64) * self.n_cols
                               + self.indices, device=data.device)
        dense = data.new_zeros(data.shape[:-1] + (self.n_rows * self.n_cols,))
        return dense.index_add_(-1, flat, data).view(
            data.shape[:-1] + (self.n_rows, self.n_cols))


def csr_template(n_rows: int, n_cols: int, coo_rows, coo_cols) -> CSRTemplate:
    """Build the static CSR sparsity from COO contribution coordinates
    (sorted-unique keys, the contract of ``mpp_tpu.ops.sparse``); a
    coordinate outside the matrix raises ValueError."""
    coo_rows = np.asarray(coo_rows, np.int64)
    coo_cols = np.asarray(coo_cols, np.int64)
    if coo_rows.size and (coo_rows.min() < 0 or coo_rows.max() >= n_rows
                          or coo_cols.min() < 0
                          or coo_cols.max() >= n_cols):
        raise ValueError("csr_template: coordinate out of range")
    keys = coo_rows * n_cols + coo_cols
    uniq, inv = np.unique(keys, return_inverse=True)
    rows_u = (uniq // n_cols).astype(np.int32)
    cols_u = (uniq % n_cols).astype(np.int32)
    indptr = np.zeros(n_rows + 1, np.int32)
    np.add.at(indptr, rows_u + 1, 1)
    indptr = np.cumsum(indptr, dtype=np.int32)
    return CSRTemplate(n_rows=n_rows, n_cols=n_cols, indptr=indptr,
                       indices=cols_u, slots=inv.astype(np.int32).ravel())

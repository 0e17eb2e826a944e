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


def csr_template(n_rows: int, n_cols: int, coo_rows, coo_cols) -> CSRTemplate:
    """Build the static CSR sparsity from COO contribution coordinates
    (sorted-unique keys, the contract of ``mpp_tpu.ops.sparse``)."""
    coo_rows = np.asarray(coo_rows, np.int64)
    coo_cols = np.asarray(coo_cols, np.int64)
    keys = coo_rows * n_cols + coo_cols
    uniq, inv = np.unique(keys, return_inverse=True)
    rows_u = (uniq // n_cols).astype(np.int32)
    cols_u = (uniq % n_cols).astype(np.int32)
    indptr = np.zeros(n_rows + 1, np.int32)
    np.add.at(indptr, rows_u + 1, 1)
    indptr = np.cumsum(indptr, dtype=np.int32)
    return CSRTemplate(n_rows=n_rows, n_cols=n_cols, indptr=indptr,
                       indices=cols_u, slots=inv.astype(np.int32).ravel())

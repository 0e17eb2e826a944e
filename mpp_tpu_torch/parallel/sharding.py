"""Column blocks over a process group, and the lateral halo exchange.

Counterpart of ``mpp_tpu/parallel/sharding.py``.  The reference
distributes grid columns over MPI ranks with ghost-column exchange by the
host model (``dtypes/UnstructuredGridType.F90:22-66``,
``alm/MPPVSFMALM_Driver.F90:483-490``).  Here each rank of a
:class:`~mpp_tpu_torch.parallel.distributed.ColumnGroup` holds its own
block of columns; the implicit vertical solves stay independent per rank,
and the operator-split lateral coupling (SURVEY §2.8) exchanges boundary
columns with one ``all_gather`` a call.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from mpp_tpu_torch.parallel.distributed import (ColumnGroup,
                                                global_column_mesh,
                                                process_local_slice)

def all_gather_rows(x, group: ColumnGroup):
    """[world_size * x.shape[0], ...]: every rank's ``x`` in rank order."""
    out = x.new_empty((group.world_size * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group.group)
    return out


def column_mesh(group=None) -> ColumnGroup:
    """The column group of the initialized process group (or of
    ``group``): the port's counterpart of a 1-D device ``Mesh``."""
    return global_column_mesh(group)


def shard_columns(x, group: ColumnGroup):
    """This rank's block [start:stop] of a global [ncol, ...] array (a
    tensor or numpy), on the rank's device."""
    start, stop = process_local_slice(x.shape[0], group.world_size,
                                      group.rank)
    return torch.as_tensor(x[start:stop], device=group.device)


def halo_exchange_1d(x, group: ColumnGroup):
    """Exchange boundary columns with both neighbours along the ranks.

    ``x`` is this rank's [ncol_local, nz] block; returns (from_left,
    from_right) ghost columns [nz].  Non-periodic: the edge ranks receive
    their own boundary column (the reference's no-lateral-flow domain
    edge).  One all_gather of every rank's two boundary columns."""
    ends = all_gather_rows(torch.stack([x[0], x[-1]]), group)
    r, n = group.rank, group.world_size
    from_left = x[0] if r == 0 else ends[2 * (r - 1) + 1]
    from_right = x[-1] if r == n - 1 else ends[2 * (r + 1)]
    return from_left, from_right


def lateral_flux_op_split(P_cols, conductance, group: ColumnGroup):
    """Explicit lateral flux between neighbouring columns (the
    operator-split source term, ``ge/GoveqnRichardsODEPressureType.F90:
    2615-2747`` semantics): ghost pressures by halo exchange, flux = -K dP,
    returned as a per-column source for the next implicit vertical
    solve."""
    from_left, from_right = halo_exchange_1d(P_cols, group)
    left = torch.cat([from_left[None], P_cols[:-1]], dim=0)
    right = torch.cat([P_cols[1:], from_right[None]], dim=0)
    return -conductance * ((P_cols - left) + (P_cols - right))

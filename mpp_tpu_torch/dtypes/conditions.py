"""Boundary-condition / source-sink condition descriptors: the port's own
copy of ``mpp_tpu/dtypes/conditions.py``.

Equivalent of ``condition_type`` / ``condition_list_type``
(``src/mpp/dtypes/ConditionType.F90:16-66``): a named condition with a type
(Dirichlet, flux, rate, ...), a region, a connection set, per-connection
values, and coupling metadata for conditions that bridge governing
equations.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from mpp_tpu_torch.constants import Cond
from mpp_tpu_torch.dtypes.mesh import ConnectionSet


@dataclasses.dataclass
class Condition:
    name: str
    units: str
    itype: int                               # Cond
    region_itype: int = 0                    # Region
    conn_set: Optional[ConnectionSet] = None
    value: Optional[np.ndarray] = None       # per-connection condition value
    swap_order: bool = False
    # Coupling metadata (ConditionType.F90:36-45)
    rank_of_other_goveqs: List[int] = dataclasses.field(default_factory=list)
    itype_of_other_goveqs: List[int] = dataclasses.field(default_factory=list)
    is_the_other_GE_coupled_via_int_auxvars: bool = False
    # Cells of the partner GE on the far side of each coupled-BC connection
    # (wired by VSFMMPP.update_connections, the VSFMSOEUpdateConnections
    # analog)
    coupled_cells: Optional[np.ndarray] = None

    @property
    def num_connections(self) -> int:
        return 0 if self.conn_set is None else self.conn_set.num_connections

    def ensure_value(self) -> np.ndarray:
        if self.value is None:
            self.value = np.zeros(self.num_connections)
        return self.value

    @property
    def is_bc(self) -> bool:
        return self.itype != int(Cond.HEAT_RATE) and self.itype not in (
            int(Cond.MASS_RATE),)


def count_cells(conds: List[Condition], exclude_itype: int = -1) -> int:
    """Total connections over conditions, excluding one itype
    (GoverningEquationBaseType GetNCellsInCondsExcptCondItype analog)."""
    return sum(c.num_connections for c in conds
               if c.itype != exclude_itype)

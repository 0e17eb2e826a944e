"""Shared MPP facade base: the 8-step builder contract (the port's own
copy of ``mpp_tpu/dtypes/mpp_base.py``).

``multiphysicsprob_base_type`` analog (MultiPhysicsProbBaseType.F90:
32-74): Init/SetName/SetID/SetNumMeshes/AddMesh/AddGovEqn/
AddConditionInGovEqn/AllocateAuxVars/SetupProblem.  Every concrete MPP
(VSFM, Thermal, ThermalEnthalpy, TH, MLC, LBL, Photosynthesis,
Longwave, Shortwave) subclasses this; per-physics facades only declare
their GE registry and any extra staging helpers.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from mpp_tpu_torch.constants import Cond
from mpp_tpu_torch.dtypes.conditions import Condition


class MPPBase:
    """The builder surface every problem driver programs against."""

    #: GEType -> GE dataclass; subclasses populate
    GE_CLASSES: Dict[int, type] = {}
    #: condition itypes routed to source_sinks even when passed as BC
    SS_COND_TYPES = (Cond.MASS_RATE, Cond.HEAT_RATE)

    def __init__(self):
        self.name = ""
        self.id = 0
        self.meshes: List[object] = []

    # -- builder steps -------------------------------------------------
    def set_name(self, name):
        self.name = name

    def set_id(self, mpp_id):
        self.id = int(mpp_id)

    def set_num_meshes(self, n):
        pass  # the mesh list grows dynamically

    def add_mesh(self, mesh):
        self.meshes.append(mesh)

    # -- governing equations -------------------------------------------
    def _goveqns(self) -> list:
        """The GE registry list (usually the SoE's)."""
        return self.soe.goveqns

    def add_goveqn(self, ge_type, name, mesh_index=None):
        cls = self.GE_CLASSES.get(ge_type)
        if cls is None:
            raise NotImplementedError(f"GE {ge_type} not supported by "
                                      f"{type(self).__name__}")
        ges = self._goveqns()
        idx = mesh_index if mesh_index is not None else len(ges)
        ges.append(cls(name=name, mesh=self.meshes[idx]))
        return len(ges)

    def add_condition_in_goveqn(self, ieqn, ss_or_bc_type, name, unit,
                                cond_type, region=None, conn_set=None):
        ge = self._goveqns()[ieqn - 1]
        if conn_set is None and region is not None:
            from mpp_tpu_torch.dtypes.regions import region_connection_set
            conn_set = region_connection_set(ge.mesh, region)
        cond = Condition(name=name, units=unit, itype=int(cond_type),
                         conn_set=conn_set)
        cond.ensure_value()
        if ss_or_bc_type == Cond.SS or cond_type in self.SS_COND_TYPES:
            ge.source_sinks.append(cond)
        else:
            ge.boundary_conditions.append(cond)
        return cond

    def allocate_auxvars(self, *args, **kw):
        for g in self._goveqns():
            g.allocate_auxvars(*args, **kw)

    def setup_problem(self, *args, **kw):
        self.soe.setup(*args, **kw)

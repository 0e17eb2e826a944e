"""Leaf boundary-layer conductance GE (KSP path, diagonal system).

Counterpart of ``mpp_tpu/models/lbl.py``, a reimplementation of
``ge/GoveqnLeafBoundaryLayer.F90:148-250``: per-leaf Nusselt/Sherwood
correlations for forced (laminar/turbulent) + free convection giving
heat/H2O/CO2 boundary-layer conductances.  The linear system is the
identity (the "solve" copies the RHS), so the conductances are computed
directly, elementwise on the staged tensors' device and dtype.

Quirk preserved: the turbulent-branch exponents use the reference's
single-precision literal ``0.33`` (vs ``0.33d0`` in the laminar branch) —
GoveqnLeafBoundaryLayer.F90:210-212.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from mpp_tpu_torch.constants import (GEType, GRAVITY_CONSTANT, RGAS, TFRZ,
                                     VISC_0C, MOD_DIFF_HEAT_OC,
                                     MOD_DIFF_H2O_OC, MOD_DIFF_CO2_OC)
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.dtypes.mesh import Mesh
from mpp_tpu_torch.dtypes.mpp_base import MPPBase

# Fortran default-real literal 0.33 promoted to double
_EXP_TURB = float(np.float32(0.33))


@dataclasses.dataclass
class LeafBoundaryLayerGE:
    name: str
    mesh: Mesh
    itype: int = int(GEType.LEAF_BND_LAYER)
    dof: int = 3
    device: torch.device | str = "cuda"

    def __post_init__(self):
        self.device = device_of(self.device)

    def allocate_auxvars(self):
        n = self.mesh.ncells_all
        z = lambda: torch.zeros(n, dtype=torch.float64, device=self.device)
        self.pref = z()
        self.tref = z()
        self.rhomol = z()
        self.wind = z()
        self.tair = z()
        self.tleaf = z()
        self.dleaf = z()
        self.gbh = z()
        self.gbv = z()
        self.gbc = z()

    def compute(self):
        # PreSolve: rhomol = pref/(R*tref)  (GoveqnLeafBoundaryLayer.F90:107)
        self.rhomol = self.pref / (RGAS * self.tref)
        b1 = 1.5
        factor = 101325.0 / self.pref * (self.tref / TFRZ) ** 1.81
        visc = VISC_0C * factor
        Dh = MOD_DIFF_HEAT_OC * factor
        Dv = MOD_DIFF_H2O_OC * factor
        Dc = MOD_DIFF_CO2_OC * factor
        Re = self.wind * self.dleaf / visc
        Pr = visc / Dh
        Scv = visc / Dv
        Scc = visc / Dc
        dT = torch.clamp(self.tleaf - self.tair, min=0.0)
        Gr = (GRAVITY_CONSTANT * self.dleaf ** 3.0 * dT
              / (self.tair * visc ** 2.0))
        Nu_lam = b1 * 0.66 * Pr ** 0.33 * Re ** 0.5
        Shv_lam = b1 * 0.66 * Scv ** 0.33 * Re ** 0.5
        Shc_lam = b1 * 0.66 * Scc ** 0.33 * Re ** 0.5
        Nu_turb = b1 * 0.036 * Pr ** _EXP_TURB * Re ** 0.8
        Shv_turb = b1 * 0.036 * Scv ** _EXP_TURB * Re ** 0.8
        Shc_turb = b1 * 0.036 * Scc ** _EXP_TURB * Re ** 0.8
        Nu_forced = torch.maximum(Nu_lam, Nu_turb)
        Shv_forced = torch.maximum(Shv_lam, Shv_turb)
        Shc_forced = torch.maximum(Shc_lam, Shc_turb)
        Nu_free = 0.54 * Pr ** 0.25 * Gr ** 0.25
        Shv_free = 0.54 * Scv ** 0.25 * Gr ** 0.25
        Shc_free = 0.54 * Scc ** 0.25 * Gr ** 0.25
        Nu = Nu_forced + Nu_free
        Shv = Shv_forced + Shv_free
        Shc = Shc_forced + Shc_free
        self.gbh = Dh * Nu / self.dleaf * self.rhomol
        self.gbv = Dv * Shv / self.dleaf * self.rhomol
        self.gbc = Dc * Shc / self.dleaf * self.rhomol
        return self.gbh, self.gbv, self.gbc


class LBLMPP(MPPBase):
    """mpp_lbl_type facade; its GE's tensors live on ``device`` (the card
    unless ``device="cpu"``)."""

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device_of(device)
        self.goveqns: List[LeafBoundaryLayerGE] = []
        self.metrics = None

    @property
    def soe(self):
        return self

    def _goveqns(self):
        return self.goveqns

    def add_goveqn(self, name="leaf boundary layer", mesh_index=None):
        idx = mesh_index if mesh_index is not None else len(self.goveqns)
        ge = LeafBoundaryLayerGE(name=name, mesh=self.meshes[idx],
                                 device=self.device)
        self.goveqns.append(ge)
        return len(self.goveqns)

    def setup_problem(self):
        pass

    def step_dt(self, dt, istep=1):
        for g in self.goveqns:
            g.compute()
        if self.metrics is not None:
            self.metrics.record(step=istep, dt=dt, converged=True)
        return True, 0

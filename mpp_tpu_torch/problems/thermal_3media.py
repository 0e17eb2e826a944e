"""Three-media thermal problem: snow / standing surface water / soil.

Counterpart of ``ThreeMediaProblem`` in ``mpp_tpu/problems/
thermal_3media.py``, the MPPThermalTBasedALM analog (``driver/alm/MPPThermalTBasedALM_
Initialize.F90``): three column meshes (snow nlevsno layers, SSW one
thin film cell, soil nlevgrnd layers), one temperature GE per medium
(``GE_THERM_{SNOW,SSW,SOIL}_TBASED``), heat-flux BCs at each medium's
top, and implicit cross-mesh Dirichlet coupling snow-bottom<->soil-top
and ssw<->soil-top (:515-640).  The reference has no regression golden
for this configuration (it only runs inside E3SM), so the tests assert
physics: equilibrium invariance, energy conservation, inter-media flux
continuity, and partial-snow activation.

``step`` runs the compiled "direct" KSP (``batched/ksp_compiled.py``) on
the problem's ``device`` (the card unless ``device="cpu"``), compiled
again whenever the sparsity was re-discovered (``soe.rebuild_template``).
At one column the system is block-tridiagonal (the block-Thomas plan);
wider batches of the 3-media mesh, ordered medium by medium, take the
dense plan.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpp_tpu_torch import constants as C
from mpp_tpu_torch.constants import (Cond, GEType, MPPType, Region, Var,
                                     AuxVarKind, ConnKind,
                                     MeshType as MeshKind)
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.dtypes.mesh import Mesh, ConnectionSet
from mpp_tpu_torch.models.thermal import ThermalMPP

NLEVSNO = 5
NLEVGRND = 15


def _column_mesh(name, ncol, dz_lev):
    """Stacked column mesh, cells ordered top->bottom per column
    (MPPThermalTBasedALM_Initialize.F90:283-345)."""
    nlev = len(dz_lev)
    n = ncol * nlev
    dz = np.tile(np.asarray(dz_lev), ncol)
    zc = np.zeros(n)
    for c in range(ncol):
        z = 0.0
        for j in range(nlev):
            i = c * nlev + j
            zc[i] = -(z + 0.5 * dz[i])
            z += dz[i]
    mesh = Mesh(name=name, itype=0,
                orientation=int(MeshKind.ALONG_GRAVITY),
                ncells_local=n, nlev=nlev,
                xc=np.zeros(n), yc=np.zeros(n), zc=zc,
                dx=np.ones(n), dy=np.ones(n), dz=dz,
                area_xy=np.ones(n), is_active=np.ones(n, bool))
    mesh.compute_volume()
    if nlev > 1:
        iu, idn = [], []
        for c in range(ncol):
            base = c * nlev
            for j in range(nlev - 1):
                iu.append(base + j)
                idn.append(base + j + 1)
        iu = np.array(iu, np.int32)
        idn = np.array(idn, np.int32)
        mesh.intrn_conn_sets = [ConnectionSet(
            id_up=iu, id_dn=idn,
            dist_up=0.5 * dz[iu], dist_dn=0.5 * dz[idn],
            area=np.ones(iu.size),
            itype=np.full(iu.size, int(ConnKind.VERTICAL), np.int32))]
    return mesh


@dataclasses.dataclass
class ThreeMediaProblem:
    ncol: int = 1
    snow_dz: float = 0.05
    ssw_dz: float = 1.0e-3
    device: str = "cuda"

    def __post_init__(self):
        device_of(self.device)
        self._comp = None
        ncol = self.ncol
        soil_dz = 0.025 * 1.35 ** np.arange(NLEVGRND)

        mpp = ThermalMPP()
        mpp.set_name("3-media thermal")
        mpp.set_id(MPPType.THERMAL_TBASED_KSP_CLM)
        mpp.set_num_meshes(3)
        mpp.add_mesh(_column_mesh("snow", ncol, [self.snow_dz] * NLEVSNO))
        mpp.add_mesh(_column_mesh("ssw", ncol, [self.ssw_dz]))
        mpp.add_mesh(_column_mesh("soil", ncol, soil_dz))

        i_snow = mpp.add_goveqn(GEType.THERM_SNOW_TBASED, "snow thermal")
        i_ssw = mpp.add_goveqn(GEType.THERM_SSW_TBASED, "ssw thermal")
        i_soil = mpp.add_goveqn(GEType.THERM_SOIL_TBASED, "soil thermal")

        mpp.add_condition_in_goveqn(
            i_snow, Cond.BC, "Heat_flux_BC_at_top_of_snow", "W/m^2",
            Cond.HEAT_FLUX, region=Region.SNOW_TOP_CELLS)
        mpp.add_condition_in_goveqn(
            i_ssw, Cond.BC, "Heat_flux_BC_at_top_of_standing_surface_water",
            "W/m^2", Cond.HEAT_FLUX, region=Region.SSW_TOP_CELLS)
        mpp.add_condition_in_goveqn(
            i_soil, Cond.BC, "Heat_flux_BC_at_top_of_soil", "W/m^2",
            Cond.HEAT_FLUX, region=Region.SOIL_TOP_CELLS)
        mpp.add_coupling_condition(i_snow, i_soil, Region.SNOW_BOTTOM_CELLS,
                                   Region.SOIL_TOP_CELLS)
        mpp.add_coupling_condition(i_ssw, i_soil, Region.SSW_TOP_CELLS,
                                   Region.SOIL_TOP_CELLS)
        # absorbed-solar source sinks (MPPThermalTBasedALM staging ids
        # 1=snow, 2=soil; MPPThermalTBasedALM_Driver.F90:430-436)
        mpp.add_condition_in_goveqn(
            i_snow, Cond.SS, "Absorbed_solar_radiation_in_snow", "W/m^2",
            Cond.HEAT_RATE, region=Region.ALL_CELLS)
        mpp.add_condition_in_goveqn(
            i_soil, Cond.SS, "Absorbed_solar_radiation_in_soil", "W/m^2",
            Cond.HEAT_RATE, region=Region.ALL_CELLS)

        mpp.allocate_auxvars()
        mpp.setup_problem()

        self.mpp = mpp
        self.ge_snow = mpp.soe.goveqns[i_snow - 1]
        self.ge_ssw = mpp.soe.goveqns[i_ssw - 1]
        self.ge_soil = mpp.soe.goveqns[i_soil - 1]

        # soil properties (loam-like)
        mpp.set_soils(filter_thermal=np.ones(ncol, np.int64),
                      lun_type=np.full(ncol, C.IST_SOIL),
                      watsat=np.full((ncol, NLEVGRND), 0.4),
                      csol=np.full((ncol, NLEVGRND), 2.0e6),
                      tkmg=np.full((ncol, NLEVGRND), 2.0),
                      tkdry=np.full((ncol, NLEVGRND), 0.2),
                      nlevsoi=10)
        # soil moisture: half-saturated liquid
        dzc = np.asarray(self.ge_soil.mesh.dz)
        self.ge_soil.liq_areal_den = 0.2 * dzc * C.DENH2O
        self.ge_soil.ice_areal_den = np.zeros(ncol * NLEVGRND)

        # snow pack: all layers present, 150 kg/m3 bulk density
        dzs = np.asarray(self.ge_snow.mesh.dz)
        mpp.set_r_data(AuxVarKind.INTERNAL, Var.ICE_AREAL_DEN, i_snow,
                       130.0 * dzs)
        mpp.set_r_data(AuxVarKind.INTERNAL, Var.LIQ_AREAL_DEN, i_snow,
                       20.0 * dzs)
        mpp.set_r_data(AuxVarKind.INTERNAL, Var.FRAC, i_snow,
                       np.ones(ncol * NLEVSNO))
        mpp.set_r_data(AuxVarKind.INTERNAL, Var.NUM_SNOW_LYR, i_snow,
                       np.full(ncol * NLEVSNO, NLEVSNO))
        # standing water film present
        mpp.set_r_data(AuxVarKind.INTERNAL, Var.FRAC, i_ssw,
                       np.ones(ncol))

        self.i_snow, self.i_ssw, self.i_soil = i_snow, i_ssw, i_soil

    # ------------------------------------------------------------------
    def set_initial_temperature(self, T_snow, T_ssw, T_soil):
        soe = self.mpp.soe
        T = np.concatenate([
            np.broadcast_to(T_snow, (self.ncol * NLEVSNO,)),
            np.broadcast_to(T_ssw, (self.ncol,)),
            np.broadcast_to(T_soil, (self.ncol * NLEVGRND,))])
        soe.set_soln_prev_clm(T)
        soe.pre_step_dt()

    def set_top_fluxes(self, snow_flux, ssw_flux, soil_flux):
        """Heat fluxes [W/m^2] applied at each medium's top (positive =
        into the medium)."""
        nc = self.ncol
        # the coupling conds follow the flux cond in each GE's list; their
        # values are unused but sized
        for ge, flux in ((self.ge_snow, snow_flux), (self.ge_ssw, ssw_flux),
                         (self.ge_soil, soil_flux)):
            nbc = sum(c.num_connections for c in ge.boundary_conditions)
            ge.bc_value = np.concatenate([np.full(nc, float(flux)),
                                          np.zeros(nbc - nc)])

    def energy(self, T=None):
        """Total energy functional sum(cap*vol*T) over active cells [J]."""
        soe = self.mpp.soe
        T = torch.as_tensor(np.asarray(soe.soln if T is None else T,
                                       np.float64))
        total = 0.0
        for g, off in zip(soe.goveqns, soe.offsets[:-1]):
            Tg = T[off:off + g.mesh.ncells_local]
            _k, cap = g.aux(Tg)
            active = torch.as_tensor(np.asarray(g.mesh.is_active, bool))
            vol = torch.as_tensor(np.asarray(g.mesh.vol, np.float64))
            total += float(torch.where(active, cap * vol * Tg, 0.0).sum())
        return total

    def install(self):
        """Route ``soe.step_dt`` through the compiled "direct" KSP of the
        current sparsity, on ``device``; returns the stepper."""
        from mpp_tpu_torch.batched.ksp_compiled import compile_ksp
        soe = self.mpp.soe
        if self._comp is None or self._comp.template is not soe.template:
            self._comp = compile_ksp(self.mpp, linear_solver="direct") \
                .install(self.device)
        return self._comp

    def step(self, dt):
        self.install()
        ok = self.mpp.soe.step_dt(dt)
        if not ok:
            raise RuntimeError("3-media thermal KSP solve diverged")
        soe = self.mpp.soe
        offs = soe.offsets
        return (np.asarray(soe.soln[offs[0]:offs[1]]),
                np.asarray(soe.soln[offs[1]:offs[2]]),
                np.asarray(soe.soln[offs[2]:offs[3]]))

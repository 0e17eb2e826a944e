"""FETCH2 single-tree xylem problem (VSFM, SNES path).

Counterpart of ``mpp_tpu/problems/vsfm_spac_fetch2.py``, which reimplements
the single-tree configurations of
``src/driver/standalone/vsfm/vsfm_spac_fetch2_problem.F90`` (oak/pine/
es/maple, :165-230 parameters; xylem mesh :1359-1483,1632-1670; material
properties :2751-2822 via set_xylem_material_properties; IC :3912-3965;
FETCH2 evaporative-demand sink over all cells :2290-2311; Dirichlet soil
water potential at the trunk base :2221-2241; TGDPB01 density): a
vertical sapwood column whose water retention follows the FETCH2
saturation curve, Weibull vulnerability relperm, tapered porosity, and a
per-cell transpiration demand downregulated by the FETCH2 factor
exp(-((P-Pref)/phis50)^c3).

The reference ships no regression golden for this driver (it needs
unshipped binary ET/soil-BC inputs); the test asserts physics instead
(tension profile, downregulation, steady-state supply/demand balance).

The steps run through the serial SNES of ``VSFMSoE.step_dt`` on
``device`` (the card unless ``device="cpu"``) or, with
``use_compiled``, the compiled batched stepper at ncol=1.
"""
from __future__ import annotations

import numpy as np

from mpp_tpu_torch.constants import (Cond, ConnKind, GEType, MPPType, Region,
                                     Var, AuxVarKind, MeshType as MeshKind)
from mpp_tpu_torch.dtypes.mesh import Mesh, ConnectionSet
from mpp_tpu_torch.batched.vsfm_compiled import vsfm_stepper
from mpp_tpu_torch.models.richards import VSFMMPP
from mpp_tpu_torch.ops import satfunc as sf
from mpp_tpu_torch.ops.eos import DENSITY_TGDPB01

VIS = 8.904156e-4        # [Pa s]   (F90:16)
RHO = 1000.0             # [kg/m3]
GRAV = 9.81
DZ_XYLEM = 0.2           # [m]
DZ_SOIL = 0.1            # [m]

# oak parameters (F90:212-224)
OAK = dict(nz=59, Asapwood=14.0686, phis50=-0.80e6, phi50=-2.5e6,
           phi88=-0.5e6, c1=1.7e6, c2=3.0, c3=12.3, kmax=6.65e-6,
           taper=0.2, porosity=0.45)
# Engelmann spruce (F90:182-194)
ES = dict(nz=85, Asapwood=0.0198, phis50=-0.90e6, phi50=-2.2e6,
          phi88=-0.5e6, c1=1.4e6, c2=2.0, c3=20.0, kmax=0.5e-6,
          taper=0.2, porosity=0.45)
SPECIES = {"oak": OAK, "es": ES}

PHI_ROOT_MEAN = 5.831916333333334e3   # (F90:3940)


def _xylem_mesh(p):
    """add_xylem_mesh_for_single_tree + set_xylem_geometric_attributes:
    cell 1 at the crown top, cells ordered downward; uniform sapwood
    area; along-gravity column."""
    nz = p["nz"]
    A = p["Asapwood"]
    zc = np.empty(nz)
    zc[0] = nz * DZ_XYLEM
    for kk in range(1, nz):
        zc[kk] = -(DZ_XYLEM / 2.0 + DZ_XYLEM * kk) + nz * DZ_XYLEM
    mesh = Mesh(name="Xylem mesh", itype=0,
                orientation=int(MeshKind.ALONG_GRAVITY),
                ncells_local=nz, nlev=nz,
                xc=np.zeros(nz), yc=np.zeros(nz), zc=zc,
                dx=np.full(nz, np.sqrt(A)), dy=np.full(nz, np.sqrt(A)),
                dz=np.full(nz, DZ_XYLEM), area_xy=np.full(nz, A),
                is_active=np.ones(nz, bool))
    mesh.compute_volume()
    ids = np.arange(nz - 1, dtype=np.int32)
    mesh.intrn_conn_sets = [ConnectionSet(
        id_up=ids, id_dn=ids + 1,
        dist_up=np.full(nz - 1, 0.5 * DZ_XYLEM),
        dist_dn=np.full(nz - 1, 0.5 * DZ_XYLEM),
        area=np.full(nz - 1, A),
        itype=np.full(nz - 1, int(ConnKind.VERTICAL), np.int32))]
    return mesh


def run_vsfm_spac_fetch2_problem(species="es", et_total=None, dtime=1800.0,
                                 use_compiled=False,
                                 nstep=1, device="cuda"):
    p = SPECIES[species]
    nz = p["nz"]

    mpp = VSFMMPP()
    mpp.set_name("Variably-Saturated-Flow-Model")
    mpp.set_id(MPPType.VSFM_SNES_CLM)
    mpp.add_mesh(_xylem_mesh(p))
    ieqn = mpp.add_goveqn(GEType.RE, "Richards Equation ODE")

    mpp.add_condition_in_goveqn(ieqn, Cond.BC, "Bottom BC", "Pa",
                                Cond.DIRICHLET,
                                region=Region.SOIL_BOTTOM_CELLS)
    mpp.add_condition_in_goveqn(ieqn, Cond.SS, "Potential Mass_Flux", "kg/s",
                                Cond.DOWNREG_MASS_RATE_FETCH2,
                                region=Region.ALL_CELLS)
    mpp.allocate_auxvars()
    mpp.setup_problem()

    # material properties (set_xylem_material_properties :2751-2822)
    por = p["porosity"] * (1.0 - np.arange(nz) * (1.0 - p["taper"])
                           / (nz - 1))
    perm = np.full(nz, p["kmax"] * VIS / RHO)
    mpp.set_density_type(1, DENSITY_TGDPB01)
    mpp.set_soil_porosity(1, por)
    mpp.set_saturation_function(
        1, np.full(nz, sf.SAT_FUNC_FETCH2),
        np.full(nz, p["phi88"]), np.full(nz, p["phi50"]), np.zeros(nz))
    mpp.set_soil_permeability(1, perm, perm, perm)
    mpp.set_relative_permeability(
        1, np.full(nz, sf.RELPERM_FUNC_WEIBULL),
        np.full(nz, p["c1"]), np.full(nz, p["c2"]))
    mpp.set_ss_auxvar(1, Var.POT_MASS_SINK_EXPONENT, np.full(nz, p["c3"]))
    mpp.set_ss_auxvar(1, Var.POT_MASS_SINK_PRESSURE, np.full(nz, p["phis50"]))

    # IC (set_initial_conditions_for_single_tree :3953-3958)
    ii = np.arange(1, nz + 1)
    press_ic = (-PHI_ROOT_MEAN - RHO * GRAV * (0.17 + (nz - ii) * DZ_SOIL)
                + 101325.0)
    mpp.restart(press_ic)

    # soil water potential at the trunk base
    p_base = 101325.0 - PHI_ROOT_MEAN
    mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1, np.array([p_base]))

    # evaporative demand [kg/s] over the crown (top third of the column)
    if et_total is None:
        et_total = 4.0e-6 * p["Asapwood"] / ES["Asapwood"]
    et = np.zeros(nz)
    crown = max(nz // 3, 1)
    et[:crown] = et_total / crown
    mpp.set_data(AuxVarKind.SS, Var.BC_SS_CONDITION, 1, et)

    vsfm_stepper(mpp, use_compiled, device)
    for istep in range(1, nstep + 1):
        converged, reason = mpp.soe.step_dt(dtime, istep)
        assert converged, f"step {istep} diverged (reason {reason})"
    return mpp

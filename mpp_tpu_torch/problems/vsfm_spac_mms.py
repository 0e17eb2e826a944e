"""SPAC-network method-of-manufactured-solutions verification.

Counterpart of ``mpp_tpu/problems/vsfm_spac_mms.py``, which reimplements
``src/driver/standalone/vsfm/vsfm_spac_mms_problem.F90``: a
three-equation soil/root/xylem network laid out along x —

* soil on x in [-5,0] (num_soil cells, VG satfunc alpha=1/4000,
  lambda=0.5, sres=0, perm 2e-11, :1613-1628 via
  compute_soil_{permeability,alpha,lambda}_or_deriv),
* root on x in [-5,0] (FETCH2 satfunc (phi88=-0.5e6, phi50=-2.5e6) +
  Weibull relperm (d=1.7e6, c=3), perm root_kmax*vis/1000*1.125,
  :1662-1759),
* xylem on x in [0,10] (same constitutive family, FETCH2 PET sink
  max_pet=2e-4 downregulated by exp(-((P-Pref)/phis50)^c3), :1775-1912),

with manufactured pressures (:1571-1591, 1662-1688, 1775-1800)

  P_soil(x) =  1000 sin(pi (x+5)/5) - 20000 + Pref
  P_root(x) = -2000 sin(pi (x+5)/5) - 25000 + Pref
  P_xylm(x) =  2000 sin(2 pi x/10)  - 25000 + Pref

(continuous with equal flux at the root/xylem junction x=0), Dirichlet
BCs from the analytic P (soil both ends, root left, xylem right), MMS
mass sources (:2015-2092 SOIL_MASS_SOURCE etc.) including the
Manoli-conductance soil<->root exchange flux (cond_dn 1e-11 soil side /
2e-11 root side, :2047-2073) and a Darcy root->xylem junction coupling.
Zero porosity makes one dt=1 step the steady state; grid refinement via
``grid_factor`` must show ~2nd-order pressure convergence.

The reference ships no regression golden for this driver; the test
asserts MMS convergence order instead.

The steps run through the serial SNES of ``VSFMSoE.step_dt`` on
``device`` (the card unless ``device="cpu"``).
"""
from __future__ import annotations

import numpy as np
import torch

from mpp_tpu_torch.constants import (Cond, ConnKind, GEType, MPPType, Region,
                                     Var, AuxVarKind, MeshType as MeshKind,
                                     PRESSURE_REF, FMWH2O, FluxType)
from mpp_tpu_torch.dtypes.mesh import Mesh, ConnectionSet
from mpp_tpu_torch.batched.vsfm_compiled import vsfm_stepper
from mpp_tpu_torch.models.richards import VSFMMPP
from mpp_tpu_torch.ops import eos
from mpp_tpu_torch.ops import satfunc as sf

PI = 4.0 * np.arctan(1.0)
TEMP = 298.15
VIS = 8.904156e-4

X_SOIL = (-5.0, 0.0)
X_ROOT = (-5.0, 0.0)
X_XYLM = (0.0, 10.0)

SOIL_PERM = 2.0e-11
SOIL_ALPHA = 1.0 / 4000.0
SOIL_LAMBDA = 0.5
SOIL_COND = 1.0e-11
ROOT_COND = 2.0e-11

ROOT_KMAX = 1.6e-6
PHI50 = -2.5e6
PHI88 = -0.5e6
C1 = 1.7e6
C2 = 3.0
XYLM_C3 = 12.3
XYLM_PHIS50 = -0.91e6
MAX_PET = 2.0e-4

PLANT_PERM = ROOT_KMAX * VIS / 1000.0 * 1.125


def soil_pressure(x, deriv=None):
    a0, a1 = 1000.0, -20000.0
    den = X_SOIL[1] - X_SOIL[0]
    arg = (np.asarray(x) - X_SOIL[0]) / den * PI
    if deriv is None:
        return a0 * np.sin(arg) + a1 + PRESSURE_REF
    if deriv == "dx":
        return a0 * PI / den * np.cos(arg)
    return -a0 * (PI / den) ** 2 * np.sin(arg)


def root_pressure(x, deriv=None):
    a0, a1 = 2000.0, -25000.0
    den = X_ROOT[1] - X_ROOT[0]
    arg = (np.asarray(x) - X_ROOT[0]) / den * PI
    if deriv is None:
        return -a0 * np.sin(arg) + a1 + PRESSURE_REF
    if deriv == "dx":
        return -a0 * PI / den * np.cos(arg)
    return a0 * (PI / den) ** 2 * np.sin(arg)


def xylm_pressure(x, deriv=None):
    a0, a1 = 2000.0, -25000.0
    den = X_XYLM[1] - X_XYLM[0]
    arg = (np.asarray(x) - X_XYLM[0]) / den * 2.0 * PI
    if deriv is None:
        return a0 * np.sin(arg) + a1 + PRESSURE_REF
    if deriv == "dx":
        return a0 * 2.0 * PI / den * np.cos(arg)
    return -a0 * (2.0 * PI / den) ** 2 * np.sin(arg)


def _t(a):
    """Host numpy as a CPU f64 tensor (the constitutive ops' input)."""
    return torch.as_tensor(np.asarray(a, np.float64))


def _np(*ts):
    return tuple(t.numpy() for t in ts)


def _soil_params(n):
    sp = sf.SatParams.zeros(n)
    for i in range(n):
        sp.set_vg(i, 0.0, SOIL_ALPHA, SOIL_LAMBDA)
    return sp


def _plant_params(n):
    sp = sf.SatParams.zeros(n)
    for i in range(n):
        sp.set_fetch2(i, PHI88, PHI50)
        sp.set_weibull_relperm(i, C1, C2)
    return sp


def _soil_root_flux(x):
    """The manufactured Manoli-conductance exchange flux at soil cell
    centers (F90:2047-2073): krg combines kr(P_root)*cond_root with
    kr(P_soil)*cond_soil; density evaluated at the soil pressure."""
    x = np.asarray(x)
    P = soil_pressure(x)
    P_bc = root_pressure(x)
    sp_dn = _soil_params(x.size)
    sp_up = _plant_params(x.size)
    kr_dn, _ = _np(*sf.press_to_relperm(sp_dn, _t(P), _t(np.ones_like(P))))
    kr_up, _ = _np(*sf.press_to_relperm(sp_up, _t(P_bc),
                                        _t(np.ones_like(P_bc))))
    krg_up = kr_up * ROOT_COND
    krg_dn = kr_dn * SOIL_COND
    krg = krg_up * krg_dn / (krg_up + krg_dn)
    rho, _, _ = _np(*eos.density(_t(P), TEMP, eos.DENSITY_TGDPB01))
    rho = rho * FMWH2O
    return -rho * krg * (P_bc - P) * 1.0


def _mms_divergence_source(x, dx, pressure_fn, perm, sat_params):
    """-d/dx(rho k kr/mu dP/dx) * dx  (F90:2015-2045; k constant here)."""
    x = np.asarray(x)
    P = pressure_fn(x)
    dP_dx = pressure_fn(x, "dx")
    d2P_dx2 = pressure_fn(x, "dx2")
    mu, _, _ = _np(*eos.viscosity(_t(P), TEMP))
    rho, drho_dP, _ = _np(*eos.density(_t(P), TEMP, eos.DENSITY_TGDPB01))
    rho = rho * FMWH2O
    drho_dP = drho_dP * FMWH2O
    kr, dkr_dP = _np(*sf.press_to_relperm(sat_params, _t(P),
                                          _t(np.ones_like(P))))
    dkr_dx = dkr_dP * dP_dx
    drho_dx = drho_dP * dP_dx
    src = (-((perm * kr / mu) * drho_dx + (rho * perm / mu) * dkr_dx) * dP_dx
           - (rho * perm * kr / mu) * d2P_dx2)
    return src * dx


def _x_mesh(name, kind, n, x_min, x_max):
    """AddMesh (F90:322-429): 1-D string of cells along x, against
    gravity, area dy*dz = 1."""
    dx = (x_max - x_min) / n
    xc = x_min + dx / 2.0 + dx * np.arange(n)
    mesh = Mesh(name=name, itype=int(kind),
                orientation=int(MeshKind.AGAINST_GRAVITY),
                ncells_local=n, nlev=1,
                xc=xc, yc=np.full(n, 0.5), zc=np.full(n, 0.5),
                dx=np.full(n, dx), dy=np.ones(n), dz=np.ones(n),
                area_xy=np.ones(n), is_active=np.ones(n, bool))
    mesh.vol = np.full(n, dx)
    ids = np.arange(n - 1, dtype=np.int32)
    mesh.intrn_conn_sets = [ConnectionSet(
        id_up=ids, id_dn=ids + 1,
        dist_up=np.full(n - 1, dx / 2.0), dist_dn=np.full(n - 1, dx / 2.0),
        area=np.ones(n - 1),
        itype=np.full(n - 1, int(ConnKind.HORIZONTAL), np.int32))]
    return mesh


def _x_boundary_conn(mesh, side):
    """Compute{Left,Right}BoundaryDomainConnection (mpp_mesh_utils.F90:
    544-609): one face conn, dist_up=0, dist_dn=dx/2, unit_vec +-x."""
    n = mesh.ncells_local
    i = 0 if side == "left" else n - 1
    uv = np.zeros((1, 3))
    uv[0, 0] = 1.0 if side == "left" else -1.0
    return ConnectionSet(id_up=np.full(1, -1, np.int32),
                         id_dn=np.array([i], np.int32),
                         dist_up=np.zeros(1),
                         dist_dn=np.array([mesh.dx[i] / 2.0]),
                         area=np.ones(1),
                         itype=np.full(1, int(ConnKind.HORIZONTAL), np.int32),
                         unit_vec=uv)


def _coupling_conn(n, dist):
    """The num_root soil<->root coupling conns (F90:655-689): every cell,
    dist root_area/2 both sides, area 1, horizontal."""
    uv = np.zeros((n, 3))
    uv[:, 0] = 1.0
    return ConnectionSet(id_up=np.full(n, -1, np.int32),
                         id_dn=np.arange(n, dtype=np.int32),
                         dist_up=np.full(n, dist), dist_dn=np.full(n, dist),
                         area=np.ones(n),
                         itype=np.full(n, int(ConnKind.HORIZONTAL), np.int32),
                         unit_vec=uv)


def run_vsfm_spac_mms_problem(grid_factor=2, device="cuda"):
    num_xylm = 20 * grid_factor
    num_root = num_xylm // 2
    num_soil = num_root
    dx_soil = (X_SOIL[1] - X_SOIL[0]) / num_soil
    dx_root = (X_ROOT[1] - X_ROOT[0]) / num_root
    dx_xylm = (X_XYLM[1] - X_XYLM[0]) / num_xylm

    mpp = VSFMMPP()
    mpp.set_name("Variably-Saturated-Flow-Model")
    mpp.set_id(MPPType.VSFM_SNES_CLM)
    soil = _x_mesh("Soil mesh", MeshKind.CLM_SOIL_COL, num_soil, *X_SOIL)
    root = _x_mesh("Root mesh", MeshKind.SPAC_ROOT_COL, num_root, *X_ROOT)
    xylm = _x_mesh("Xylem Mesh", MeshKind.SPAC_XYLEM_COL, num_xylm, *X_XYLM)
    mpp.add_mesh(soil)
    mpp.add_mesh(root)
    mpp.add_mesh(xylm)
    mpp.add_goveqn(GEType.RE, "Richards Equation ODE for Soil", 0)
    mpp.add_goveqn(GEType.RE, "Richards Equation ODE for Root", 1)
    mpp.add_goveqn(GEType.RE, "Richards Equation ODE for Xylem", 2)

    # MMS conditions (F90:470-609): SS sources + Dirichlet BCs
    for ieqn in (1, 2, 3):
        mpp.add_condition_in_goveqn(ieqn, Cond.SS, "Source term for MMS",
                                    "kg/m^3", Cond.MASS_RATE,
                                    region=Region.ALL_CELLS)
    mpp.add_condition_in_goveqn(3, Cond.SS, "Potential mass flux", "kg/m^3",
                                Cond.DOWNREG_MASS_RATE_FETCH2,
                                region=Region.ALL_CELLS)
    cs_soil = _x_boundary_conn(soil, "left")
    cs_soil_r = _x_boundary_conn(soil, "right")
    both = ConnectionSet(
        id_up=np.concatenate([cs_soil.id_up, cs_soil_r.id_up]),
        id_dn=np.concatenate([cs_soil.id_dn, cs_soil_r.id_dn]),
        dist_up=np.concatenate([cs_soil.dist_up, cs_soil_r.dist_up]),
        dist_dn=np.concatenate([cs_soil.dist_dn, cs_soil_r.dist_dn]),
        area=np.concatenate([cs_soil.area, cs_soil_r.area]),
        itype=np.concatenate([cs_soil.itype, cs_soil_r.itype]),
        unit_vec=np.concatenate([cs_soil.unit_vec, cs_soil_r.unit_vec]))
    mpp.add_condition_in_goveqn(1, Cond.BC, "Pressure BC for MMS", "Pa",
                                Cond.DIRICHLET, conn_set=both)
    mpp.add_condition_in_goveqn(2, Cond.BC, "Pressure BC for MMS", "Pa",
                                Cond.DIRICHLET,
                                conn_set=_x_boundary_conn(root, "left"))
    mpp.add_condition_in_goveqn(3, Cond.BC, "Pressure BC for MMS", "Pa",
                                Cond.DIRICHLET,
                                conn_set=_x_boundary_conn(xylm, "right"))

    # coupling conditions (F90:612-796)
    mpp.add_coupling_bcs_in_goveqn(1, "Root BC in soil equation", "Pa",
                                   [2], _coupling_conn(num_root, 0.5))
    mpp.add_coupling_bcs_in_goveqn(2, "Soil BC in root equation", "Pa",
                                   [1], _coupling_conn(num_root, 0.5))
    mpp.add_coupling_bcs_in_goveqn(2, "Xylem BC in root equation", "Pa",
                                   [3], _x_boundary_conn(root, "right"))
    mpp.add_coupling_bcs_in_goveqn(3, "Root BC in xylem equation", "Pa",
                                   [2], _x_boundary_conn(xylm, "left"))

    mpp.allocate_auxvars()
    mpp.setup_problem()

    # material properties (F90:875-1434)
    for ieqn in (1, 2, 3):
        mpp.set_density_type(ieqn, eos.DENSITY_TGDPB01)
    mpp.set_soil_porosity(1, np.zeros(num_soil))
    mpp.set_soil_permeability(1, *[np.full(num_soil, SOIL_PERM)] * 3)
    mpp.set_saturation_function(1, np.full(num_soil,
                                           sf.SAT_FUNC_VAN_GENUCHTEN),
                                np.full(num_soil, SOIL_ALPHA),
                                np.full(num_soil, SOIL_LAMBDA),
                                np.zeros(num_soil))
    for ieqn, n in ((2, num_root), (3, num_xylm)):
        mpp.set_soil_porosity(ieqn, np.zeros(n))
        mpp.set_soil_permeability(ieqn, *[np.full(n, PLANT_PERM)] * 3)
        mpp.set_saturation_function(ieqn, np.full(n, sf.SAT_FUNC_FETCH2),
                                    np.full(n, PHI88), np.full(n, PHI50),
                                    np.zeros(n))
        mpp.set_relative_permeability(ieqn,
                                      np.full(n, sf.RELPERM_FUNC_WEIBULL),
                                      np.full(n, C1), np.full(n, C2))
    # xylem FETCH2 sink parameters over both SS conds (F90:751-757)
    mpp.set_ss_auxvar(3, Var.POT_MASS_SINK_EXPONENT,
                      np.concatenate([np.zeros(num_xylm),
                                      np.full(num_xylm, XYLM_C3)]))
    mpp.set_ss_auxvar(3, Var.POT_MASS_SINK_PRESSURE,
                      np.concatenate([np.zeros(num_xylm),
                                      np.full(num_xylm, XYLM_PHIS50)]))

    # BC conn auxvars (F90:963-1083 soil, 1166-1338 root): Manoli
    # conductance on the soil<->root legs, Darcy elsewhere
    n1 = num_soil + 2
    mpp.set_conn_int_value(1, AuxVarKind.CONN_BC, Var.FLUX_TYPE,
                           np.concatenate([
                               np.full(2, int(FluxType.DARCY)),
                               np.full(num_soil, int(FluxType.CONDUCTANCE))]))
    mpp.set_conn_int_value(1, AuxVarKind.CONN_BC, Var.CONDUCTANCE_TYPE,
                           np.concatenate([
                               np.zeros(2, np.int64),
                               np.full(num_soil,
                                       int(FluxType.CONDUCTANCE_MANOLI))]))
    mpp.set_conn_satfunc(1, AuxVarKind.CONN_BC,
                         set_upwind=np.zeros(n1, bool),
                         satfunc_itype=np.concatenate(
                             [np.zeros(2, np.int64),
                              np.full(num_soil, sf.SAT_FUNC_VAN_GENUCHTEN)]),
                         p1=np.full(n1, SOIL_ALPHA),
                         p2=np.full(n1, SOIL_LAMBDA),
                         p3=np.zeros(n1))
    mpp.set_conn_real_value(1, AuxVarKind.CONN_BC, Var.CONDUCTANCE_DN,
                            np.concatenate([np.zeros(2),
                                            np.full(num_soil, SOIL_COND)]))

    n2 = num_root + 2
    mpp.set_conn_int_value(
        2, AuxVarKind.CONN_BC, Var.FLUX_TYPE,
        np.concatenate([np.full(1, int(FluxType.DARCY)),
                        np.full(num_root, int(FluxType.CONDUCTANCE)),
                        np.full(1, int(FluxType.DARCY))]))
    mpp.set_conn_int_value(
        2, AuxVarKind.CONN_BC, Var.CONDUCTANCE_TYPE,
        np.concatenate([np.zeros(1, np.int64),
                        np.full(num_root,
                                int(FluxType.CONDUCTANCE_MANOLI)),
                        np.zeros(1, np.int64)]))
    # the reference sets the dn-side FETCH2/Weibull params on every root
    # BC conn (F90:1289-1297 overwrite)
    mpp.set_conn_satfunc(2, AuxVarKind.CONN_BC,
                         set_upwind=np.zeros(n2, bool),
                         satfunc_itype=np.full(n2, sf.SAT_FUNC_FETCH2),
                         p1=np.full(n2, PHI88), p2=np.full(n2, PHI50),
                         p3=np.zeros(n2))
    mpp.set_conn_relperm(2, AuxVarKind.CONN_BC,
                         set_upwind=np.zeros(n2, bool),
                         relperm_itype=np.full(n2, sf.RELPERM_FUNC_WEIBULL),
                         p1=np.full(n2, C1), p2=np.full(n2, C2))
    mpp.set_conn_real_value(2, AuxVarKind.CONN_BC, Var.CONDUCTANCE_DN,
                            np.full(n2, ROOT_COND))

    mpp.update_connections()

    # ICs (F90:1437-1475): domain-mean for soil/root, offset P for xylem
    P_soil_true = soil_pressure(soil.xc)
    P_root_true = root_pressure(root.xc)
    P_xylm_true = xylm_pressure(xylm.xc)
    mpp.restart(np.concatenate([
        np.full(num_soil, P_soil_true.mean()),
        np.full(num_root, P_root_true.mean()),
        P_xylm_true - 1000.0]))

    mpp.soe.pre_step_dt()

    # BCs (F90:1478-1523)
    mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1,
                 soil_pressure(np.array(X_SOIL)))
    mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 2,
                 root_pressure(np.array([X_ROOT[0]])))
    mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 3,
                 xylm_pressure(np.array([X_XYLM[1]])))

    # sources (F90:1526-1568)
    srf = _soil_root_flux(soil.xc)
    soil_src = _mms_divergence_source(soil.xc, dx_soil, soil_pressure,
                                      SOIL_PERM,
                                      _soil_params(num_soil)) + srf
    root_src = _mms_divergence_source(root.xc, dx_root, root_pressure,
                                      PLANT_PERM,
                                      _plant_params(num_root)) - srf
    P_x = xylm_pressure(xylm.xc)
    xylm_src = (_mms_divergence_source(xylm.xc, dx_xylm, xylm_pressure,
                                       PLANT_PERM, _plant_params(num_xylm))
                - MAX_PET * np.exp(-((P_x - PRESSURE_REF)
                                     / XYLM_PHIS50) ** XYLM_C3))
    mpp.set_data(AuxVarKind.SS, Var.BC_SS_CONDITION, 1, soil_src)
    mpp.set_data(AuxVarKind.SS, Var.BC_SS_CONDITION, 2, root_src)
    mpp.set_data(AuxVarKind.SS, Var.BC_SS_CONDITION, 3, xylm_src)
    mpp.set_data(AuxVarKind.SS, Var.BC_SS_CONDITION, 4,
                 np.full(num_xylm, MAX_PET))

    vsfm_stepper(mpp, False, device)
    converged, reason = mpp.soe.step_dt(1.0, 1)
    assert converged, f"SPAC MMS solve diverged (reason {reason})"
    return mpp, (P_soil_true, P_root_true, P_xylm_true)


def pressure_errors(mpp, truths):
    errs = []
    for g, Pt in zip(mpp.soe.goveqns, truths):
        errs.append(float(np.max(np.abs(np.asarray(g.pressure) - Pt))))
    return errs

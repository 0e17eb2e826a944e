"""SPAC problem with an explicit soil column (VSFM).

Counterpart of ``mpp_tpu/problems/vsfm_spac_campbell.py``
(``src/driver/standalone/vsfm/vsfm_spac_campbell_problem.F90``):
a 2-cell xylem (leaf + hub) + 28-cell root network + 50-cell soil column.
The hub connects to every root cell by a root-resistance conductance; each
root cell connects to its soil cell by a Campbell-relperm conductance; the
soil column is Darcy flow (van Genuchten).  A Campbell-downregulated
diurnal transpiration sink acts on the leaf cell.  24 hourly steps.

Two formulations produce the same physics:

* single governing equation over one 80-cell mesh
  (``run_vsfm_spac_campbell_problem``; F90:716-733, 275-712)
* three coupled Richards equations (xylem/root/soil) wired by coupling
  boundary conditions (``multi_goveqns=True``; F90:737-758, 761-925)

The steps run in f64 through the serial SNES of ``VSFMSoE.step_dt`` or,
with ``use_compiled``, the compiled batched stepper at ncol=1, on the
card unless the caller passes ``device="cpu"``: the compiled "petsc" plan
(the default) is the batched ILU(0) + GMRES(30), "direct" a dense LU.
The multi-GE form stages the partner GEs' pressures into the
COND_DIRICHLET_FRM_OTR_GOVEQ slots by a gather.
"""
from __future__ import annotations

import numpy as np

from mpp_tpu_torch.constants import (Cond, ConnKind, GEType, MPPType, Region, Var,
                               AuxVarKind, FluxType, MeshType as MeshKind)
from mpp_tpu_torch.dtypes.mesh import Mesh, ConnectionSet
from mpp_tpu_torch.batched.vsfm_compiled import vsfm_stepper
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.models.richards import VSFMMPP
from mpp_tpu_torch.ops import satfunc as sf
# the VSFM writer (pressure + saturation) is shared with vsfm_spac
from mpp_tpu_torch.problems.vsfm_spac import output_regression  # noqa: F401

NZ_XYLEM = 2
NZ_ROOT = 28
NZ_SOIL = 50
KS = 0.001                    # [kg s m^-3]
THETA_S = 0.46
CAMPBELL_B = 4.58
CAMPBELL_HE = -4.2            # [J/kg]
CAMPBELL_N = 2.0 + 3.0 / CAMPBELL_B
VG_N = 1.35
VG_ALPHA = 0.15
PI = 4.0 * np.arctan(1.0)


def _root_conductances():
    """Per-layer root resistance Rr and soil-to-root geometry factor bz
    (F90:1425-1466): linear root-length density profile between rootMin
    and rootDepth; returns 1-based dicts for Fortran layers kk=3..30."""
    nz_loc = 50
    dz_loc = 1.0 / nz_loc
    z_int = np.array([kk * dz_loc for kk in range(nz_loc + 1)])
    root_depth, root_min = 0.6, 0.02
    rw, r1 = 25000000000.0, 0.001
    cond_root = {}
    cond_soil = {}
    for kk in range(1, nz_loc + 1):     # Fortran layer index
        zi = z_int[kk - 1]              # z_int(kk)
        if root_min < zi < root_depth:
            L = 40000.0 * (root_depth - zi) / root_depth
            span = z_int[kk] - z_int[kk - 2]
            Rr = 2.0 * rw / (L * span)
            bz = ((1.0 - CAMPBELL_N) * np.log(PI * r1 * r1 * L)
                  / (2.0 * PI * L * span))
        else:
            Rr, bz = 0.0, 0.0
        if 3 <= kk <= 30:
            cond_root[kk] = 1.0e-6 / Rr
            cond_soil[kk] = 1.0e-6 / (bz / KS)
    return cond_root, cond_soil


def _transpiration(time: float) -> float:
    """Diurnal potential transpiration (F90:1259-1291)."""
    time_of_day = (time % (3600.0 * 24.0)) / 3600.0
    fi = 0.9
    etp = 5.55555555556e-05
    return fi * etp * 2.3 * (0.05 + np.sin(0.0175 * 7.5 * time_of_day)) ** 4.0


def _press_ic() -> float:
    theta = 0.20
    se = theta / THETA_S
    return CAMPBELL_HE * se ** (-CAMPBELL_B) * 1.0e3 + 101325.0


def _bc_relperm_params(n):
    he = np.full(n, -CAMPBELL_HE * 1.0e3)
    cn = np.full(n, CAMPBELL_N)
    itype = np.full(n, sf.RELPERM_FUNC_CAMPBELL)
    return itype, he, cn


def run_vsfm_spac_campbell_problem(dtime=3600.0, nstep=24,
                                   multi_goveqns=False, use_compiled=False,
                                   linear_solver="petsc", device="cuda"):
    """vsfm_spac_campbell_problem.F90, single-GE or ``multi_goveqns``;
    returns the mpp.  ``linear_solver`` is the compiled stepper's plan."""
    device = device_of(device)
    run = _run_multi_goveqns if multi_goveqns else _run_single_goveqn
    return run(dtime, nstep, use_compiled, linear_solver, device)


# ---------------------------------------------------------------------------
# Single governing equation over one combined mesh (F90:544-712, 1392-1467)
# ---------------------------------------------------------------------------
def _single_mesh():
    dz = 1.0 / NZ_SOIL
    n = NZ_XYLEM + NZ_ROOT + NZ_SOIL
    zc = np.zeros(n)
    # xylem cells at z=0 (F90:614-615)
    for kk in range(3, NZ_XYLEM + NZ_ROOT + 1):        # Fortran kk
        zc[kk - 1] = -(dz / 2.0 + dz * (kk - 1))
    for kk in range(NZ_XYLEM + NZ_ROOT + 1, n + 1):
        zc[kk - 1] = -(dz / 2.0 + dz * (kk - NZ_XYLEM - NZ_ROOT - 1))
    vol = np.full(n, 1.0 / 50.0)
    vol[30] = vol[0] / 2.0                              # F90:616
    mesh = Mesh(name="Soil mesh", itype=int(MeshKind.CLM_SOIL_COL),
                orientation=int(MeshKind.AGAINST_GRAVITY),
                ncells_local=n, nlev=n,
                xc=np.full(n, 0.5), yc=np.full(n, 0.5), zc=zc,
                dx=np.ones(n), dy=np.ones(n), dz=np.full(n, dz),
                area_xy=np.ones(n), is_active=np.ones(n, bool))
    mesh.vol = vol
    # connections (F90:643-699), 0-based
    id_up = [0]
    id_dn = [1]
    for kk in range(2, NZ_XYLEM + NZ_ROOT):            # Fortran kk=2..29
        id_up.append(1)
        id_dn.append(kk)
    for kk in range(2, NZ_XYLEM + NZ_ROOT):
        id_up.append(kk)
        id_dn.append(kk + NZ_XYLEM + NZ_ROOT)
    for kk in range(1, NZ_SOIL):                       # Fortran kk=1..49
        id_up.append(kk + NZ_XYLEM + NZ_ROOT - 1)
        id_dn.append(kk + NZ_XYLEM + NZ_ROOT)
    m = len(id_up)
    mesh.intrn_conn_sets = [ConnectionSet(
        id_up=np.array(id_up, np.int32), id_dn=np.array(id_dn, np.int32),
        dist_up=np.full(m, 0.5 * dz), dist_dn=np.full(m, 0.5 * dz),
        area=np.ones(m), itype=np.full(m, int(ConnKind.VERTICAL), np.int32))]
    return mesh


def _material_arrays(nz, is_soil):
    por = np.where(is_soil, THETA_S, 0.0)
    sat_res = np.where(is_soil, 0.01, 0.0)
    lam = np.where(is_soil, 1.0 - 1.0 / VG_N, 1.0 / CAMPBELL_B)
    alpha = np.where(is_soil, VG_ALPHA * 1.0e-3, 1.0e-3 / (-CAMPBELL_HE))
    satfunc_type = np.where(is_soil, sf.SAT_FUNC_VAN_GENUCHTEN,
                            sf.SAT_FUNC_BROOKS_COREY)
    perm = np.full(nz, KS / 1.0e6 * 8.904156e-4)
    return por, sat_res, lam, alpha, satfunc_type, perm


def _run_single_goveqn(dtime, nstep, use_compiled, linear_solver, device):
    mpp = VSFMMPP()
    mpp.set_name("Variably-Saturated-Flow-Model")
    mpp.set_id(MPPType.VSFM_SNES_CLM)
    mesh = _single_mesh()
    mpp.add_mesh(mesh)
    ieqn = mpp.add_goveqn(GEType.RE, "Richards Equation ODE")
    mpp.add_condition_in_goveqn(ieqn, Cond.SS, "Potential Mass_Flux", "kg/s",
                                Cond.DOWNREG_MASS_RATE_CAMPBELL,
                                region=Region.SOIL_BOTTOM_CELLS)
    mpp.allocate_auxvars()
    mpp.setup_problem()

    n = NZ_XYLEM + NZ_ROOT + NZ_SOIL
    is_soil = np.arange(n) >= NZ_XYLEM + NZ_ROOT
    por, sat_res, lam, alpha, satfunc_type, perm = _material_arrays(n, is_soil)
    mpp.set_soil_porosity(1, por)
    mpp.set_saturation_function(1, satfunc_type, alpha, lam, sat_res)
    mpp.soe.goveqns[0].set_soil_permeability(perm, perm, perm)
    mpp.set_ss_auxvar(1, Var.POT_MASS_SINK_EXPONENT, np.full(1, 10.0))
    mpp.set_ss_auxvar(1, Var.POT_MASS_SINK_PRESSURE, np.full(1, -1500000.0))

    # conn flux types + conductances (F90:1392-1467)
    nconn_in = NZ_XYLEM - 1 + NZ_ROOT * 2 + NZ_SOIL - 1
    ncond = NZ_XYLEM - 1 + NZ_ROOT * 2
    flux_type = np.full(nconn_in, int(FluxType.DARCY))
    flux_type[:ncond] = int(FluxType.CONDUCTANCE)
    mpp.set_conn_int_value(1, AuxVarKind.CONN_INTERNAL, Var.FLUX_TYPE,
                           flux_type)
    cond_root, cond_soil = _root_conductances()
    cond_in = np.zeros(nconn_in)
    he_in = np.zeros(nconn_in)
    cn_in = np.zeros(nconn_in)
    itype_in = np.zeros(nconn_in, np.int64)
    cond_in[0] = 1.0 / (3.0e6 * 1.0e6)                 # RL (F90:1434)
    for kk in range(3, 31):                            # Fortran kk=3..30
        cond_in[kk - 2] = cond_root[kk]                # conns 2..29 (1-based)
        j = kk - 3 + 29                                # conns 30..57 (1-based)
        cond_in[j] = cond_soil[kk]
        it, he, cn = _bc_relperm_params(1)
        itype_in[j] = it[0]
        he_in[j] = he[0]
        cn_in[j] = cn[0]
    mpp.set_conn_real_value(1, AuxVarKind.CONN_INTERNAL, Var.CONDUCTANCE,
                            cond_in)
    mpp.set_conn_relperm(1, AuxVarKind.CONN_INTERNAL,
                         set_upwind=np.zeros(nconn_in, bool),
                         relperm_itype=itype_in, p1=he_in, p2=cn_in)

    mpp.restart(np.full(n, _press_ic()))

    vsfm_stepper(mpp, use_compiled, device, linear_solver=linear_solver)
    time = 0.0
    for istep in range(1, nstep + 1):
        mpp.set_data(AuxVarKind.SS, Var.BC_SS_CONDITION, 1,
                     np.full(1, -_transpiration(time)))
        time += dtime
        converged, reason = mpp.soe.step_dt(dtime, istep)
        assert converged, f"step {istep} diverged (reason {reason})"
    return mpp


# ---------------------------------------------------------------------------
# Multi-goveqn formulation: xylem / root / soil GEs + coupling BCs
# (F90:204-470, 737-925, 1470-1596)
# ---------------------------------------------------------------------------
def _column_mesh(name, itype, n, zc, vol=None):
    dz = 1.0 / NZ_SOIL
    mesh = Mesh(name=name, itype=itype,
                orientation=int(MeshKind.AGAINST_GRAVITY),
                ncells_local=n, nlev=n,
                xc=np.full(n, 0.5), yc=np.full(n, 0.5), zc=np.asarray(zc),
                dx=np.ones(n), dy=np.ones(n), dz=np.full(n, dz),
                area_xy=np.ones(n), is_active=np.ones(n, bool))
    mesh.vol = np.full(n, 1.0 / 50.0) if vol is None else np.asarray(vol)
    mesh.intrn_conn_sets = []
    return mesh


def _coupling_conn_set(id_dn):
    dz = 1.0 / NZ_SOIL
    m = len(id_dn)
    uv = np.zeros((m, 3))
    uv[:, 0] = 1.0
    return ConnectionSet(id_up=np.full(m, -1, np.int32),
                         id_dn=np.array(id_dn, np.int32),
                         dist_up=np.full(m, dz / 2.0),
                         dist_dn=np.full(m, dz / 2.0),
                         area=np.ones(m),
                         itype=np.full(m, int(ConnKind.VERTICAL), np.int32),
                         unit_vec=uv)


def _run_multi_goveqns(dtime, nstep, use_compiled, linear_solver, device):
    dz = 1.0 / NZ_SOIL
    mpp = VSFMMPP()
    mpp.set_name("Variably-Saturated-Flow-Model")
    mpp.set_id(MPPType.VSFM_SNES_CLM)

    # meshes (F90:204-470)
    zc_x = np.zeros(NZ_XYLEM)
    xylem = _column_mesh("Xylem mesh", int(MeshKind.SPAC_XYLEM_COL),
                         NZ_XYLEM, zc_x)
    xylem.intrn_conn_sets = [ConnectionSet(
        id_up=np.array([0], np.int32), id_dn=np.array([1], np.int32),
        dist_up=np.array([dz / 2]), dist_dn=np.array([dz / 2]),
        area=np.ones(1), itype=np.full(1, int(ConnKind.VERTICAL), np.int32))]

    zc_r = np.array([-(dz / 2.0 + dz * (kk - 1 + 2))
                     for kk in range(1, NZ_ROOT + 1)])
    root = _column_mesh("Root mesh", int(MeshKind.SPAC_ROOT_COL),
                        NZ_ROOT, zc_r)

    zc_s = np.array([-(dz / 2.0 + dz * (kk - 1))
                     for kk in range(1, NZ_SOIL + 1)])
    vol_s = np.full(NZ_SOIL, 1.0 / 50.0)
    vol_s[0] = vol_s[0] / 2.0                          # F90:365
    soil = _column_mesh("Soil mesh", int(MeshKind.CLM_SOIL_COL),
                        NZ_SOIL, zc_s, vol=vol_s)
    id_up = np.arange(NZ_SOIL - 1, dtype=np.int32)
    soil.intrn_conn_sets = [ConnectionSet(
        id_up=id_up, id_dn=id_up + 1,
        dist_up=np.full(NZ_SOIL - 1, dz / 2),
        dist_dn=np.full(NZ_SOIL - 1, dz / 2),
        area=np.ones(NZ_SOIL - 1),
        itype=np.full(NZ_SOIL - 1, int(ConnKind.VERTICAL), np.int32))]

    mpp.add_mesh(xylem)
    mpp.add_mesh(root)
    mpp.add_mesh(soil)
    mpp.add_goveqn(GEType.RE, "Richards Equation ODE for Xylem", 0)
    mpp.add_goveqn(GEType.RE, "Richards Equation ODE for Root", 1)
    mpp.add_goveqn(GEType.RE, "Richards Equation ODE for Soil", 2)

    # conditions (F90:761-925): downreg sink on xylem bottom (= leaf cell),
    # then the four coupling BCs
    mpp.add_condition_in_goveqn(1, Cond.SS, "Potential Mass_Flux", "kg/s",
                                Cond.DOWNREG_MASS_RATE_CAMPBELL,
                                region=Region.SOIL_BOTTOM_CELLS)
    # Xylem <- Root: nz_root conns onto the hub cell (Fortran cell 2)
    mpp.add_coupling_bcs_in_goveqn(1, "Root BC in xylem equation", "Pa",
                                   [2], _coupling_conn_set([1] * NZ_ROOT))
    # Root <- Xylem, Root <- Soil: onto root cells 1..nz_root
    mpp.add_coupling_bcs_in_goveqn(2, "Xylem BC in root equation", "Pa",
                                   [1], _coupling_conn_set(list(range(NZ_ROOT))))
    mpp.add_coupling_bcs_in_goveqn(2, "Soil BC in root equation", "Pa",
                                   [3], _coupling_conn_set(list(range(NZ_ROOT))))
    # Soil <- Root: onto soil cells 3..30 (Fortran kk+2)
    mpp.add_coupling_bcs_in_goveqn(3, "Root BC in soil equation", "Pa",
                                   [2],
                                   _coupling_conn_set(list(range(2, 2 + NZ_ROOT))))

    mpp.allocate_auxvars()
    mpp.setup_problem()

    # materials (F90:1118-1218)
    for ieqn, n in ((1, NZ_XYLEM), (2, NZ_ROOT)):
        por, sat_res, lam, alpha, satfunc_type, perm = _material_arrays(
            n, np.zeros(n, bool))
        mpp.set_soil_porosity(ieqn, por)
        mpp.set_saturation_function(ieqn, satfunc_type, alpha, lam, sat_res)
        mpp.soe.goveqns[ieqn - 1].set_soil_permeability(perm, perm, perm)
    por, sat_res, lam, alpha, satfunc_type, perm = _material_arrays(
        NZ_SOIL, np.ones(NZ_SOIL, bool))
    mpp.set_soil_porosity(3, por)
    mpp.set_saturation_function(3, satfunc_type, alpha, lam, sat_res)
    mpp.soe.goveqns[2].set_soil_permeability(perm, perm, perm)
    mpp.set_ss_auxvar(1, Var.POT_MASS_SINK_EXPONENT, np.full(1, 10.0))
    mpp.set_ss_auxvar(1, Var.POT_MASS_SINK_PRESSURE, np.full(1, -1500000.0))

    # conn flux types + conductances (F90:1470-1596)
    cond_root, cond_soil = _root_conductances()
    cr = np.array([cond_root[kk] for kk in range(3, 31)])
    cs = np.array([cond_soil[kk] for kk in range(3, 31)])
    it_c, he_c, cn_c = _bc_relperm_params(NZ_ROOT)

    # xylem eq: 1 internal (RL), nz_root BC conns (1e-6/Rr)
    mpp.set_conn_int_value(1, AuxVarKind.CONN_INTERNAL, Var.FLUX_TYPE,
                           np.full(1, int(FluxType.CONDUCTANCE)))
    mpp.set_conn_real_value(1, AuxVarKind.CONN_INTERNAL, Var.CONDUCTANCE,
                            np.array([1.0 / (3.0e6 * 1.0e6)]))
    mpp.set_conn_int_value(1, AuxVarKind.CONN_BC, Var.FLUX_TYPE,
                           np.full(NZ_ROOT, int(FluxType.CONDUCTANCE)))
    mpp.set_conn_real_value(1, AuxVarKind.CONN_BC, Var.CONDUCTANCE, cr)

    # root eq BC conns: [xylem legs (1e-6/Rr), soil legs (Campbell, upwind)]
    nbc_r = 2 * NZ_ROOT
    mpp.set_conn_int_value(2, AuxVarKind.CONN_BC, Var.FLUX_TYPE,
                           np.full(nbc_r, int(FluxType.CONDUCTANCE)))
    mpp.set_conn_real_value(2, AuxVarKind.CONN_BC, Var.CONDUCTANCE,
                            np.concatenate([cr, cs]))
    mpp.set_conn_relperm(2, AuxVarKind.CONN_BC,
                         set_upwind=np.concatenate(
                             [np.zeros(NZ_ROOT, bool),
                              np.ones(NZ_ROOT, bool)]),
                         relperm_itype=np.concatenate(
                             [np.zeros(NZ_ROOT, np.int64), it_c]),
                         p1=np.concatenate([np.zeros(NZ_ROOT), he_c]),
                         p2=np.concatenate([np.zeros(NZ_ROOT), cn_c]))

    # soil eq BC conns: Campbell on the dn (soil) side (upwind=FALSE)
    mpp.set_conn_int_value(3, AuxVarKind.CONN_BC, Var.FLUX_TYPE,
                           np.full(NZ_ROOT, int(FluxType.CONDUCTANCE)))
    mpp.set_conn_real_value(3, AuxVarKind.CONN_BC, Var.CONDUCTANCE, cs)
    mpp.set_conn_relperm(3, AuxVarKind.CONN_BC,
                         set_upwind=np.zeros(NZ_ROOT, bool),
                         relperm_itype=it_c, p1=he_c, p2=cn_c)

    # initial conditions + coupling rewiring (F90:1223-1256, 370)
    n_all = NZ_XYLEM + NZ_ROOT + NZ_SOIL
    mpp.restart(np.full(n_all, _press_ic()))
    mpp.update_connections()

    vsfm_stepper(mpp, use_compiled, device, linear_solver=linear_solver)
    time = 0.0
    for istep in range(1, nstep + 1):
        mpp.set_data(AuxVarKind.SS, Var.BC_SS_CONDITION, 1,
                     np.full(1, -_transpiration(time)))
        time += dtime
        converged, reason = mpp.soe.step_dt(dtime, istep)
        assert converged, f"step {istep} diverged (reason {reason})"
    return mpp

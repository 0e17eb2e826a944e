"""Thermal-enthalpy and coupled thermal-hydrology (TH) standalone problems.

Counterpart of ``mpp_tpu/problems/th.py``
(``src/driver/standalone/thermal-e/``):

* ``heat_transport_1D_problem.F90`` — a 100-cell vertical soil column,
  pure heat conduction through the standalone thermal-enthalpy MPP
  (MPP_THERMAL_EBASED_SNES_CLM), 2 steps of dt=3600 s, Dirichlet T at top
  (303.15 K) and bottom (293.15 K), constant density and constant-cp
  enthalpy; and ``heat_transport_1D_with_advection.F90``, the same
  equation along x with IFC67 and a staged pressure field that makes the
  enthalpy flux carry a Darcy advective part;
* ``mass_and_heat_model_problem.F90`` — an nx-cell horizontal column
  solved by the coupled TH MPP (MPP_TH_SNES_CLM): Richards mass + enthalpy
  energy, temperature Dirichlet BCs on the energy equation only (BC
  auxvar pressure staged to 91325 Pa), IFC67 density and enthalpy, steps
  of dt=3600 s;
* ``th_mms_problem.F90`` — the steady 1-D manufactured-solution check of
  the coupled system on x in [0, 10] with spatially varying permeability,
  Dirichlet P and T on both GEs and mass/heat sources from the
  reference's finite-difference scheme (pert=1e-6,
  th_mms_problem.F90:1269-1438).

The heat-transport problems step through ``ThermalEnthalpySoE.step_dt``
(one linearised update, ILU(0) + GMRES(30) at one column) or,
with ``compiled=True``, ``CompiledThermalEnthalpy``.  The TH problems
step through the serial SNES of ``THSoE.step_dt`` by default, as in the
JAX package, or with ``compiled=True`` through the compiled stepper
``batched/th_compiled.compile_th(mpp, linear_solver=...)`` ("petsc", the
JAX package's plan, by default).  Every step runs at ncol=1 in f64, on
the card unless the caller passes ``device="cpu"``.
``output_regression_heat_transport_1d`` and ``output_regression_th``
write the reference's regression files.

The energy BCs (condition values and the BC auxvar pressure) must be
staged before any step: unstaged they are 0 K and 0 Pa and the first step
fails (SNES reason -4).  ``run_mass_and_heat`` stages them before every
step, and once more before the first, so a problem returned with
``nstep=0`` is ready to step.
"""
from __future__ import annotations

import numpy as np
import torch

from mpp_tpu_torch import constants as C
from mpp_tpu_torch.constants import (Cond, ConnKind, GEType, MPPType, MeshType,
                                     Var, AuxVarKind, Region, PRESSURE_REF,
                                     GRAVITY_CONSTANT, FMWH2O)
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.io.petsc_vec import read_vec
from mpp_tpu_torch.io.regression import RegressionWriter
from mpp_tpu_torch.dtypes.mesh import structured_mesh, ConnectionSet
from mpp_tpu_torch.models.thermal_enthalpy import THMPP, ThermalEnthalpyMPP
from mpp_tpu_torch.ops import eos, satfunc as sf

PI = 4.0 * np.arctan(1.0)


def _th_stepper(mpp, compiled, linear_solver, device):
    """The serial SNES of ``THSoE.step_dt`` on ``device``, or with
    ``compiled`` the compiled stepper at ncol=1."""
    device = device_of(device)
    mpp.soe.device = device
    if compiled:
        from mpp_tpu_torch.batched.th_compiled import compile_th
        compile_th(mpp, linear_solver=linear_solver).install(device)


# ---------------------------------------------------------------------------
# heat_transport_1D (standalone thermal-enthalpy MPP)
# ---------------------------------------------------------------------------
def _heat_transport_soils(mpp, n, nrow, nz, density_type, int_energy_type):
    """set_material_properties (heat_transport_1D_problem.F90:280-363)."""
    porosity, lam, alpha = 0.368, 0.5, 3.4257e-4
    perm = 8.3913e-12
    vish2o = 0.001002
    hksat = perm / vish2o * (C.DENH2O * C.GRAV_CLM) / 0.001
    shape = (nrow, nz)
    mpp.set_soils(filter_thermal=np.ones(n, np.int64),
                  watsat=np.full(shape, porosity),
                  csol=np.full(shape, 837.0),
                  tkdry=np.full(shape, 0.25),
                  hksat=np.full(shape, hksat),
                  bsw=np.full(shape, 1.0 / lam),
                  sucsat=np.full(shape, 1.0 / (alpha * GRAVITY_CONSTANT)),
                  residual_sat=np.full(shape, 0.2772),
                  satfunc_type="van_genuchten",
                  density_type=density_type,
                  int_energy_type=int_energy_type)


def _enthalpy_stepper(mpp, compiled, device):
    device = device_of(device)
    if compiled:
        from mpp_tpu_torch.batched.th_compiled import (
            compile_thermal_enthalpy)
        compile_thermal_enthalpy(mpp).install(device)
    else:
        mpp.soe.device = device


def run_heat_transport_1d(nz=100, dtime=3600.0, nstep=2, compiled=False,
                          device="cuda"):
    """heat_transport_1D_problem.F90:22-101; returns (mpp, T).
    ``compiled=True`` steps through ``CompiledThermalEnthalpy`` in place
    of ``ThermalEnthalpySoE.step_dt``; both run on ``device``."""
    nx = ny = 1
    mpp = ThermalEnthalpyMPP()
    mpp.set_name("1D heat conduction")
    mpp.set_id(MPPType.THERMAL_EBASED_SNES_CLM)
    mpp.set_num_meshes(1)
    mesh = structured_mesh("Soil mesh", 1.0, 1.0, 1.0, nx, ny, nz,
                           ConnKind.IN_Z_DIR)
    mesh.itype = int(MeshType.CLM_THERMAL_SOIL_COL)
    mpp.add_mesh(mesh)
    mpp.add_goveqn(GEType.THERM_SOIL_EBASED,
                   "Heat transport based on enthalpy ODE")
    mpp.add_condition_in_goveqn(
        1, Cond.BC, "Constant temperature condition at top", "K",
        Cond.DIRICHLET, region=Region.SOIL_TOP_CELLS)
    mpp.add_condition_in_goveqn(
        1, Cond.BC, "Constant temperature condition at bottom", "K",
        Cond.DIRICHLET, region=Region.SOIL_BOTTOM_CELLS)
    mpp.allocate_auxvars()
    mpp.setup_problem()

    n = nx * ny * nz
    _heat_transport_soils(mpp, n, 1, nz, eos.DENSITY_CONSTANT,
                          eos.INT_ENERGY_ENTHALPY_CONSTANT)
    # ICs (:366-424): T=283.15, internal pressure 91325
    mpp.set_initial_temperature(np.full(n, 283.15))
    mpp.set_data(AuxVarKind.INTERNAL, Var.PRESSURE, -1, np.full(n, 91325.0))
    _enthalpy_stepper(mpp, compiled, device)

    for istep in range(1, nstep + 1):
        # set_bondary_conditions (:427-466)
        mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1, [303.15])
        mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 2, [293.15])
        mpp.set_data(AuxVarKind.INTERNAL, Var.PRESSURE, -1,
                     np.full(n, 91325.0))
        converged, _reason = mpp.soe.step_dt(dtime, istep)
        assert converged
    return mpp, mpp.get_data(Var.TEMPERATURE)


def run_heat_transport_1d_with_advection(nx=100, dtime=3600.0, nstep=1,
                                         pressure_ic=None,
                                         pressure_ic_file=None,
                                         compiled=False, device="cuda"):
    """heat_transport_1D_with_advection.F90:15-636: nx cells along x
    (conn area dy*dz), IFC67 density and enthalpy, Dirichlet T at both x
    faces (303.15 / 293.15 K) and the pressure field ``pressure_ic``
    (default a uniform 91325 Pa, no advection) staged into the internal
    auxvars; ``pressure_ic_file`` reads it from a PETSc binary Vec, as the
    reference reads ``pressure_ic.bin`` (F90:576-582)."""
    if pressure_ic_file is not None:
        pressure_ic = read_vec(pressure_ic_file)
    ny = nz = 1
    mpp = ThermalEnthalpyMPP()
    mpp.set_name("1D heat conduction")
    mpp.set_id(MPPType.THERMAL_EBASED_SNES_CLM)
    mpp.set_num_meshes(1)
    dx, dy, dz = 1.0 / nx, 1.0 / ny, 1.0 / nz
    mesh = structured_mesh("Soil mesh", 1.0, 1.0, 1.0, nx, ny, nz,
                           ConnKind.IN_X_DIR)
    mesh.itype = int(MeshType.CLM_THERMAL_SOIL_COL)
    # internal connections are CONN_VERTICAL in the reference (F90:284)
    mesh.intrn_conn_sets[0].itype[:] = int(ConnKind.VERTICAL)
    mpp.add_mesh(mesh)
    mpp.add_goveqn(GEType.THERM_SOIL_EBASED,
                   "Heat transport based on enthalpy ODE")
    for cell, sign, name in ((0, 1.0, "top"), (nx - 1, -1.0, "bottom")):
        mpp.add_condition_in_goveqn(
            1, Cond.BC, f"Constant temperature condition at {name}", "K",
            Cond.DIRICHLET,
            conn_set=_x_face_bc_conn(nx, dx, dy, dz, cell, sign))
    mpp.allocate_auxvars()
    mpp.setup_problem()

    n = nx * ny * nz
    _heat_transport_soils(mpp, n, nx, nz, eos.DENSITY_IFC67,
                          eos.INT_ENERGY_ENTHALPY_IFC67)
    if pressure_ic is None:
        pressure_ic = np.full(n, 91325.0)
    pressure_ic = np.asarray(pressure_ic, np.float64)

    mpp.set_initial_temperature(np.full(n, 283.15))
    mpp.set_data(AuxVarKind.INTERNAL, Var.PRESSURE, -1, pressure_ic)
    # the boundary faces' auxvar pressure staged to the adjacent cell's,
    # so the faces carry no spurious Darcy outflow (as the JAX package)
    ge = mpp.soe.ge
    ge.bc_pressure = np.array([pressure_ic[0], pressure_ic[-1]])
    _enthalpy_stepper(mpp, compiled, device)

    for istep in range(1, nstep + 1):
        mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1, [303.15])
        mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 2, [293.15])
        mpp.set_data(AuxVarKind.INTERNAL, Var.PRESSURE, -1, pressure_ic)
        converged, _reason = mpp.soe.step_dt(dtime, istep)
        assert converged
    return mpp, mpp.get_data(Var.TEMPERATURE)


# ---------------------------------------------------------------------------
# mass_and_heat (coupled TH MPP)
# ---------------------------------------------------------------------------
def _x_face_bc_conn(nx, dx, dy, dz, cell, sign):
    """One x-face boundary connection (mass_and_heat_model_problem.F90:
    275-325): dist_up=0, dist_dn=dx/2, area=dy*dz, unit_vec=(sign,0,0)."""
    uv = np.zeros((1, 3))
    uv[0, 0] = sign
    return ConnectionSet(
        id_up=np.array([-1], np.int32), id_dn=np.array([cell], np.int32),
        dist_up=np.zeros(1), dist_dn=np.array([0.5 * dx]),
        area=np.array([dy * dz]),
        itype=np.array([int(ConnKind.VERTICAL)], np.int32), unit_vec=uv)


def _stage_mass_and_heat_bcs(mpp):
    """set_bondary_conditions (mass_and_heat_model_problem.F90:556-652):
    the T BCs and the energy-GE BC auxvar pressure."""
    mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1, [303.15])
    mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 2, [293.15])
    ge = mpp.soe.ge_energy
    ge.bc_pressure = np.full_like(ge.bc_pressure, 91325.0)


def run_mass_and_heat(nx=100, nz=1, dtime=3600.0, nstep=1, compiled=False,
                      linear_solver="petsc", device="cuda"):
    """mass_and_heat_model_problem.F90:22-135; returns (mpp, the
    [P; T] solution).  Steps on the card unless ``device="cpu"``;
    ``linear_solver`` is the compiled stepper's plan."""
    ny = 1
    dx, dy, dz = 1.0 / nx, 1.0 / ny, 1.0 / nz
    n = nx * ny * nz

    mpp = THMPP()
    mpp.set_name("1D heat conduction")
    mpp.set_id(MPPType.TH_SNES_CLM)
    mpp.set_num_meshes(1)
    mesh = structured_mesh("Soil mesh", 1.0, 1.0, 1.0, nx, ny, nz,
                           ConnKind.IN_X_DIR)
    mesh.itype = int(MeshType.CLM_THERMAL_SOIL_COL)
    mpp.add_mesh(mesh)
    mpp.add_goveqn(GEType.RE, "Mass equation")
    mpp.add_goveqn(GEType.THERM_SOIL_EBASED,
                   "Heat transport based on enthalpy")

    # BCs only on the energy equation (ieqn=2)
    mpp.add_condition_in_goveqn(
        2, Cond.BC, "Constant temperature condition at top", "K",
        Cond.DIRICHLET, conn_set=_x_face_bc_conn(nx, dx, dy, dz, 0, +1.0))
    mpp.add_condition_in_goveqn(
        2, Cond.BC, "Constant temperature condition at bottom", "K",
        Cond.DIRICHLET, conn_set=_x_face_bc_conn(nx, dx, dy, dz, nx - 1, -1.0))
    mpp.allocate_auxvars()
    mpp.setup_problem()

    # set_material_properties (:404-482): MPPTHSetSoils, IFC67 EOS
    porosity, lam, alpha = 0.368, 0.5, 3.4257e-4
    perm = 8.3913e-12
    vish2o = 0.001002
    hksat = perm / vish2o * (C.DENH2O * C.GRAV_CLM) / 0.001
    ncol2 = nx * ny * 2
    mpp.set_soils(filter_thermal=np.ones(n * 2, np.int64),
                  watsat=np.full((ncol2, nz), porosity),
                  csol=np.full((ncol2, nz), 837.0),
                  tkdry=np.full((ncol2, nz), 0.25),
                  hksat=np.full((ncol2, nz), hksat),
                  bsw=np.full((ncol2, nz), 1.0 / lam),
                  sucsat=np.full((ncol2, nz),
                                 1.0 / (alpha * GRAVITY_CONSTANT)),
                  residual_sat=np.full((ncol2, nz), 0.2772),
                  satfunc_type="van_genuchten",
                  density_type=eos.DENSITY_IFC67,
                  int_energy_type=eos.INT_ENERGY_ENTHALPY_IFC67)

    # ICs (:485-553): P=91325, T=283.15
    mpp.set_initial_solution(np.full(n, 91325.0), np.full(n, 283.15))
    _th_stepper(mpp, compiled, linear_solver, device)

    _stage_mass_and_heat_bcs(mpp)
    for istep in range(1, nstep + 1):
        _stage_mass_and_heat_bcs(mpp)
        converged, _reason = mpp.soe.step_dt(dtime, istep)
        assert converged
    return mpp, mpp.get_data(Var.PRESSURE)


# ---------------------------------------------------------------------------
# th_mms (coupled TH MPP, manufactured solutions)
# ---------------------------------------------------------------------------
class _MMS:
    """Manufactured fields (th_mms_problem.F90:1024-1154)."""

    def __init__(self, x_min=0.0, x_max=10.0):
        self.x_min = x_min
        self.xlim = x_max - x_min

    def pressure(self, x, d=0):
        a0, a1 = 15000.0, -20000.0
        s = (x - self.x_min) / self.xlim * PI
        if d == 0:
            return a0 * np.sin(s) + a1 + PRESSURE_REF
        if d == 1:
            return a0 * PI / self.xlim * np.cos(s)
        return -a0 * (PI / self.xlim) ** 2 * np.sin(s)

    def temperature(self, x, d=0):
        a0, a1 = 5.0, 290.0
        s = (x - self.x_min) / self.xlim * PI
        if d == 0:
            return a0 * np.sin(s) + a1
        if d == 1:
            return a0 * PI / self.xlim * np.cos(s)
        return -a0 * (PI / self.xlim) ** 2 * np.sin(s)

    def permeability(self, x, d=0):
        p0 = 1.0e-11
        s = (x - self.x_min) / self.xlim * PI
        if d == 0:
            return p0 * (2.0 - np.cos(s))
        return p0 * PI / self.xlim * np.sin(s)


def _np(*ts):
    return tuple(t.numpy() for t in ts)


def _t(a):
    return torch.as_tensor(np.atleast_1d(np.asarray(a, np.float64)))


def _mms_eos_at(x, mms, density_type):
    """(rho_mass, drho/dT, drho/dP) [kg/m^3] at the analytic P(x), T(x)."""
    den, dden_dP, dden_dT = _np(*eos.density(
        _t(mms.pressure(x)), _t(mms.temperature(x)), density_type))
    return den * FMWH2O, dden_dT * FMWH2O, dden_dP * FMWH2O


def _mms_sources(xc, mms, density_type, int_energy_type):
    """Mass [kg/s per cell] and heat [W per cell] MMS sources with the
    reference's FD perturbation scheme (th_mms_problem.F90:1269-1438),
    not yet scaled by dx (the caller multiplies)."""
    pert = 1.0e-6
    nx = xc.size
    p0_alpha, m_lam, sat_res = 1.0 / 4000.0, 0.5, 0.0
    kdry, kwet, t_alpha = 0.25, 1.3, 0.45

    sp = sf.SatParams.zeros(nx)
    for i in range(nx):
        sp.set_vg(i, sat_res, p0_alpha, m_lam)

    P = mms.pressure(xc)
    dP_dx = mms.pressure(xc, 1)
    d2P_dx2 = mms.pressure(xc, 2)
    T = mms.temperature(xc)
    dT_dx = mms.temperature(xc, 1)
    d2T_dx2 = mms.temperature(xc, 2)
    k = mms.permeability(xc)
    dk_dx = mms.permeability(xc, 1)

    mu, _, _ = _np(*eos.viscosity(_t(P), _t(T)))
    den, dden_dP, dden_dT = _np(*eos.density(_t(P), _t(T), density_type))
    rho = den * FMWH2O
    drho_dP = dden_dP * FMWH2O
    drho_dT = dden_dT * FMWH2O

    se, dse_dP = _np(*sf.press_to_sat(sp, _t(P)))
    kr, dkr_dP = _np(*sf.press_to_relperm(sp, _t(P), _t(np.ones(nx))))
    dkr_dx = dkr_dP * dP_dx

    xp, xn = xc + pert, xc - pert
    rho_p, drho_p_dT, drho_p_dP = _mms_eos_at(xp, mms, density_type)
    rho_n, drho_n_dT, drho_n_dP = _mms_eos_at(xn, mms, density_type)
    drho_dx = (rho_p - rho_n) / (2.0 * pert)

    mass_src = (-((k * kr / mu) * drho_dx + (rho * kr / mu) * dk_dx
                  + (rho * k / mu) * dkr_dx) * dP_dx
                - (rho * k * kr / mu) * d2P_dx2)

    # the central difference of H divides its rounding noise (~1e-5 on
    # ~2e7) by 2*pert: the IFC67 enthalpy goes through the numpy twin with
    # the reference's rounding sequence
    if int_energy_type == eos.INT_ENERGY_ENTHALPY_IFC67:
        def H_of(Px, Tx, *_unused):
            return eos.enthalpy_ifc67_np(Tx - 273.15, Px)
    else:
        def H_of(Px, Tx, rhox, drho_dTx, drho_dPx):
            return eos.internal_energy_and_enthalpy(
                _t(Px), _t(Tx), int_energy_type, _t(rhox), _t(drho_dTx),
                _t(drho_dPx))[1].numpy()
    H = H_of(P, T, rho, drho_dT, drho_dP)
    rhoq = -rho * (k * kr / mu * dP_dx)
    drhoq_dx = mass_src  # the same expression (th_mms_problem.F90:1398-1400)

    se_p, _ = _np(*sf.press_to_sat(sp, _t(mms.pressure(xp))))
    se_n, _ = _np(*sf.press_to_sat(sp, _t(mms.pressure(xn))))
    Ke = (se + 1.0e-6) ** t_alpha
    dKe_dx = ((se_p + 1.0e-6) ** t_alpha
              - (se_n + 1.0e-6) ** t_alpha) / (2.0 * pert)
    kappa = kwet * Ke + kdry * (1.0 - Ke)
    dkappa_dx = (kwet - kdry) * dKe_dx

    Hp = H_of(mms.pressure(xp), mms.temperature(xp),
              rho_p, drho_p_dT, drho_p_dP)
    Hn = H_of(mms.pressure(xn), mms.temperature(xn),
              rho_n, drho_n_dT, drho_n_dP)
    dH_dx = (Hp - Hn) / (2.0 * pert)

    heat_src = -(drhoq_dx * H / FMWH2O + rhoq * dH_dx / FMWH2O
                 - dkappa_dx * dT_dx - kappa * d2T_dx2)
    return mass_src, heat_src


def run_th_mms(nx=20, compiled=False, linear_solver="petsc", device="cuda"):
    """th_mms_problem.F90:89-141 (STEADY_STATE_SOIL_ONLY_1D): one
    dt=1 s step from the uniform initial state; returns (mpp, the [P; T]
    solution).  Steps on the card unless ``device="cpu"``;
    ``linear_solver`` is the compiled stepper's plan."""
    ny = nz = 1
    x_min, x_max = 0.0, 10.0
    dx = (x_max - x_min) / nx
    dy, dz = 1.0, 1.0
    n = nx * ny * nz
    mms = _MMS(x_min, x_max)
    xc = x_min + dx / 2.0 + np.arange(nx) * dx

    density_type = eos.DENSITY_CONSTANT
    int_energy_type = eos.INT_ENERGY_ENTHALPY_IFC67

    mpp = THMPP()
    mpp.set_name("Thermal-Hydrology For SPAC")
    mpp.set_id(MPPType.TH_SNES_CLM)
    mpp.set_num_meshes(1)
    mesh = structured_mesh("Soil mesh", x_max, 1.0, 1.0, nx, ny, nz,
                           ConnKind.IN_XYZ_DIR, x_min=x_min)
    mesh.itype = int(MeshType.CLM_SOIL_COL)
    mpp.add_mesh(mesh)
    mpp.add_goveqn(GEType.RE, "Mass Equation ODE for Soil")
    mpp.add_goveqn(GEType.THERM_SOIL_EBASED,
                   "Enthalpy-based ODE for heat transport")

    def bc_conns():
        # ComputeBoundaryDomainConnection for nx>1, ny=nz=1
        # (mpp_mesh_utils.F90:748-818): left face then right face
        uv = np.zeros((2, 3))
        uv[0, 0], uv[1, 0] = 1.0, -1.0
        return ConnectionSet(
            id_up=np.array([-1, -1], np.int32),
            id_dn=np.array([0, nx - 1], np.int32),
            dist_up=np.zeros(2), dist_dn=np.full(2, dx / 2.0),
            area=np.full(2, dy * dz),
            itype=np.full(2, int(ConnKind.HORIZONTAL), np.int32),
            unit_vec=uv)

    mpp.add_condition_in_goveqn(1, Cond.BC, "Pressure BC", "Pa",
                                Cond.DIRICHLET, conn_set=bc_conns())
    mpp.add_condition_in_goveqn(1, Cond.SS, "Source term for MMS", "kg/m^3",
                                Cond.MASS_RATE, region=Region.ALL_CELLS)
    mpp.add_condition_in_goveqn(2, Cond.BC, "Temperature BC", "K",
                                Cond.DIRICHLET, conn_set=bc_conns())
    mpp.add_condition_in_goveqn(2, Cond.SS, "Source term for MMS", "W/m^3",
                                Cond.HEAT_RATE, region=Region.ALL_CELLS)
    mpp.allocate_auxvars()
    mpp.setup_problem()

    # material properties (th_mms_problem.F90:603-757): porosity=0
    # (steady), heat_cap=0, spatially varying permeability, VG satfunc
    perm = mms.permeability(xc)
    sat_alpha = np.full(n, 1.0 / 4000.0)
    sat_lam = np.full(n, 0.5)
    res_sat = np.zeros(n)
    vg = np.full(n, sf.SAT_FUNC_VAN_GENUCHTEN)
    for ge in (mpp.soe.ge_mass, mpp.soe.ge_energy):
        ge.density_type = density_type
        ge.set_soil_permeability(perm, perm, perm)
        ge.set_soil_porosity(np.zeros(n))
        ge.set_saturation_function(vg, sat_alpha, sat_lam, res_sat)
    ge = mpp.soe.ge_energy
    ge.set_int_energy_type(int_energy_type)
    ge.set_heat_capacity(np.zeros(n))
    ge.set_thermal_cond_dry(np.full(n, 0.25))
    ge.set_thermal_cond_wet(np.full(n, 1.3))
    ge.set_thermal_alpha(np.full(n, 0.45))
    ge.set_soil_density(np.zeros(n))

    # ICs (:760-818): uniform cell-average of the analytic fields
    P0 = float(np.mean(mms.pressure(xc)))
    T0 = float(np.mean(mms.temperature(xc)))
    mpp.set_initial_solution(np.full(n, P0), np.full(n, T0))

    # sources + BCs
    mass_src, heat_src = _mms_sources(xc, mms, density_type, int_energy_type)
    mpp.set_data(AuxVarKind.SS, Var.BC_SS_CONDITION, 1, mass_src * dx)
    mpp.set_data(AuxVarKind.SS, Var.BC_SS_CONDITION, 2, heat_src * dx)

    xf = np.array([x_min, x_max])
    pres_bc = mms.pressure(xf)
    temp_bc = mms.temperature(xf)
    mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1, pres_bc)
    mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 2, temp_bc)
    # cross staging (:829-880): energy BC auxvar pressure + mass BC
    # auxvar temperature
    mpp.soe.ge_energy.bc_pressure = np.array(pres_bc, np.float64)
    mpp.soe.ge_mass.bc_temperature = np.array(temp_bc, np.float64)

    _th_stepper(mpp, compiled, linear_solver, device)
    converged, _reason = mpp.soe.step_dt(1.0, 1)
    assert converged
    return mpp, mpp.get_data(Var.PRESSURE)


def output_regression_heat_transport_1d(filename_base, num_cells, temp):
    w = RegressionWriter(filename_base, num_cells)
    w.write_data("temperature", "general", temp)
    w.close()
    return w.filename


def output_regression_th(filename_base, num_cells, soln):
    """liquid_pressure + temperature blocks (mass_and_heat/th_mms)."""
    n = len(soln) // 2
    w = RegressionWriter(filename_base, num_cells)
    w.write_data("liquid_pressure", "pressure", soln[:n])
    w.write_data("temperature", "temperature", soln[n:])
    w.close()
    return w.filename

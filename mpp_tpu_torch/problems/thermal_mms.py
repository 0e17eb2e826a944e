"""Thermal MMS steady-state verification problems (1D/2D/3D).

Counterpart of ``run_thermal_mms_problem`` in
``mpp_tpu/problems/thermal_mms.py`` (``src/driver/standalone/thermal/
thermal_mms_problem.F90`` and its per-dimension manufactured solutions
``thermal_mms_steady_state_problem_{1D,2D,3D}.F90``): steady heat
diffusion with spatially varying conductivity, Dirichlet boundary values
from the analytic solution, and a volumetric heat source chosen so the
analytic T is the exact PDE solution.

Domain [0,1]^d, cnfac=0 (steady), one KSP solve a step, through the
compiled batched KSP (``batched/ksp_compiled.compile_ksp(mpp,
linear_solver="petsc")``) at ncol=1 in f64, on the card unless the
caller passes ``device="cpu"``.  The 1-D problem is tridiagonal (Thomas);
the 2-D and 3-D problems need the GMRES(30)+ILU(0) plan, which is not
ported yet and raises (ROADMAP Slice D), as does the serial host GMRES.
``output_regression`` needs ``io/regression`` (ROADMAP Slice F).

Cell ordering quirk reproduced: soil properties are staged CLM-style
column-major (MultiPhysicsProbThermal.F90:154-185) while the structured
mesh is natural-ordered, which permutes the conductivity field in the 3-D
case — the reference's golden baselines bake this in.
"""
from __future__ import annotations

import numpy as np

from mpp_tpu_torch.constants import (Cond, ConnKind, GEType, MPPType,
                                     MeshType, Var, AuxVarKind, IST_SOIL)
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.dtypes.mesh import (structured_mesh, ConnectionSet,
                                       compute_cell_ids)
from mpp_tpu_torch.models.thermal import ThermalMPP

PI = 4.0 * np.arctan(1.0)

STEADY_STATE_1D = 1
STEADY_STATE_2D = 2
STEADY_STATE_3D = 3


def _temperature(dim, x, y, z, deriv=None):
    if dim == 1:
        if deriv is None:
            return 10 * np.sin(PI * x) + 270.0
        if deriv == "dx":
            return 10.0 * PI * np.cos(PI * x)
        if deriv == "dx2":
            return -10.0 * PI * PI * np.sin(PI * x)
    if dim == 2:
        base = np.sin(x * PI) * np.cos(2.0 * y * PI)
        if deriv is None:
            return 10.0 * base + 270.0
        if deriv == "dx":
            return 10.0 * PI * np.cos(x * PI) * np.cos(2.0 * PI * y)
        if deriv == "dy":
            return -20.0 * PI * np.sin(x * PI) * np.sin(2.0 * PI * y)
        if deriv == "dx2":
            return -10.0 * PI * PI * base
        if deriv == "dy2":
            return -40.0 * PI * PI * base
    if dim == 3:
        base = np.sin(x * PI) * np.cos(2.0 * PI * y) * np.sin(3.0 * PI * z)
        if deriv is None:
            return 10.0 * base + 270.0
        if deriv == "dx":
            return 10.0 * PI * np.cos(x * PI) * np.cos(2.0 * PI * y) * np.sin(3.0 * PI * z)
        if deriv == "dy":
            return -20.0 * PI * np.sin(x * PI) * np.sin(2.0 * PI * y) * np.sin(3.0 * PI * z)
        if deriv == "dz":
            return 30.0 * PI * np.sin(x * PI) * np.cos(2.0 * PI * y) * np.cos(3.0 * PI * z)
        if deriv == "dx2":
            return -10.0 * PI * PI * base
        if deriv == "dy2":
            return -40.0 * PI * PI * base
        if deriv == "dz2":
            return -90.0 * PI * PI * base
    raise ValueError((dim, deriv))


def _conductivity(dim, x, y, z, deriv=None):
    if dim == 1:
        return np.exp(x)          # l = dl/dx = exp(x)
    if dim == 2:
        a = np.exp(x + y - 1.0)
        if deriv is None:
            return (x + 0.5) * a
        if deriv == "dx":
            return ((x + 0.5) + 1.0) * a
        if deriv == "dy":
            return (x + 0.5) * a
    if dim == 3:
        return np.exp(x + y + z - 1.0)  # all derivs equal l
    raise ValueError((dim, deriv))


def _heat_source(dim, x, y, z, dx, dy, dz):
    src = (-_conductivity(dim, x, y, z, "dx" if dim > 1 else None)
           * _temperature(dim, x, y, z, "dx")
           - _conductivity(dim, x, y, z) * _temperature(dim, x, y, z, "dx2"))
    if dim >= 2:
        src += (-_conductivity(dim, x, y, z, "dy") * _temperature(dim, x, y, z, "dy")
                - _conductivity(dim, x, y, z) * _temperature(dim, x, y, z, "dy2"))
    if dim == 3:
        src += (-_conductivity(dim, x, y, z) * _temperature(dim, x, y, z, "dz")
                - _conductivity(dim, x, y, z) * _temperature(dim, x, y, z, "dz2"))
    return src * dx * dy * dz


def _boundary_conns_and_values(dim, nx, ny, nz, dx, dy, dz, xc3, yc3, zc3):
    """Boundary face connection set + Dirichlet values, in the reference's
    order (thermal_mms_problem.F90:376-478 for conns; per-dim
    DATA_TEMPERATURE_BC for values): x faces (kk,jj loops, begin/end
    interleaved), then y faces (kk,ii), then z faces (jj,ii)."""
    ids = compute_cell_ids(nx, ny, nz)
    id_dn, dup, ddn, area, vals = [], [], [], [], []

    def temp(x, y, z):
        return _temperature(dim, x, y, z)

    if nx > 1:
        for kk in range(nz):
            for jj in range(ny):
                for ii, sgn in ((0, -1), (nx - 1, +1)):
                    id_dn.append(ids[kk, jj, ii])
                    dup.append(0.0)
                    ddn.append(dx / 2.0)
                    area.append(dy * dz)
                    vals.append(temp(xc3[kk, jj, ii] + sgn * dx / 2.0,
                                     yc3[kk, jj, ii], zc3[kk, jj, ii]))
    if ny > 1:
        for kk in range(nz):
            for ii in range(nx):
                for jj, sgn in ((0, -1), (ny - 1, +1)):
                    id_dn.append(ids[kk, jj, ii])
                    dup.append(0.0)
                    ddn.append(dy / 2.0)
                    area.append(dx * dz)
                    vals.append(temp(xc3[kk, jj, ii],
                                     yc3[kk, jj, ii] + sgn * dy / 2.0,
                                     zc3[kk, jj, ii]))
    if nz > 1:
        for jj in range(ny):
            for ii in range(nx):
                for kk, sgn in ((0, -1), (nz - 1, +1)):
                    id_dn.append(ids[kk, jj, ii])
                    dup.append(0.0)
                    ddn.append(dz / 2.0)
                    area.append(dx * dy)
                    vals.append(temp(xc3[kk, jj, ii], yc3[kk, jj, ii],
                                     zc3[kk, jj, ii] + sgn * dz / 2.0))
    n = len(id_dn)
    cs = ConnectionSet(
        id_up=np.full(n, -1, np.int32), id_dn=np.array(id_dn, np.int32),
        dist_up=np.array(dup), dist_dn=np.array(ddn), area=np.array(area),
        itype=np.full(n, int(ConnKind.HORIZONTAL), np.int32))
    return cs, np.array(vals)


def run_thermal_mms_problem(problem_type=STEADY_STATE_1D, nstep=1,
                            nx=None, ny=None, nz=None, device="cuda"):
    """Build + solve; returns (mpp, solution array).  The steps run on
    ``device`` (the card unless ``device="cpu"``) through the compiled
    batched KSP."""
    device = device_of(device)
    dim = problem_type
    if dim == STEADY_STATE_1D:
        defaults = (20, 1, 1)
    elif dim == STEADY_STATE_2D:
        defaults = (20, 20, 1)
    else:
        defaults = (20, 20, 20)
    nx = defaults[0] if nx is None else nx
    ny = defaults[1] if ny is None else ny
    nz = defaults[2] if nz is None else nz
    dx, dy, dz = 1.0 / nx, 1.0 / ny, 1.0 / nz
    n = nx * ny * nz

    kk, jj, ii = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                             indexing="ij")
    xc3 = dx / 2 + ii * dx
    yc3 = dy / 2 + jj * dy
    zc3 = dz / 2 + kk * dz

    mpp = ThermalMPP()
    mpp.set_name("Thermal model for MMS")
    mpp.set_id(MPPType.THERMAL_TBASED_KSP_CLM)
    mpp.set_num_meshes(1)
    mesh = structured_mesh("Soil mesh", 1.0, 1.0, 1.0, nx, ny, nz,
                           ConnKind.IN_XYZ_DIR)
    mesh.itype = int(MeshType.CLM_THERMAL_SOIL_COL)
    mpp.add_mesh(mesh)
    ieqn = mpp.add_goveqn(GEType.THERM_SOIL_TBASED,
                          "Thermal equation (KSP) in soil")

    bc_conns, bc_vals = _boundary_conns_and_values(dim, nx, ny, nz, dx, dy, dz,
                                                   xc3, yc3, zc3)
    mpp.add_condition_in_goveqn(ieqn, Cond.BC, "Temp BC", "T", Cond.DIRICHLET,
                                conn_set=bc_conns)
    # ALL_CELLS source-sink
    all_cs = ConnectionSet(
        id_up=np.full(n, -1, np.int32),
        id_dn=np.arange(n, dtype=np.int32),
        dist_up=np.zeros(n), dist_dn=np.zeros(n), area=np.zeros(n),
        itype=np.full(n, int(ConnKind.VERTICAL), np.int32))
    mpp.add_condition_in_goveqn(ieqn, Cond.SS, "Source term for MMS", "W/m^2",
                                Cond.HEAT_RATE, conn_set=all_cs)
    mpp.allocate_auxvars()
    mpp.setup_problem()

    # material properties: CLM-shaped staging (column-major quirk preserved)
    ncol = nx * ny
    lam = _conductivity(dim, xc3, yc3, zc3)   # [nz,ny,nx] at centroids
    tkdry = np.zeros((ncol, nz))
    for k in range(nz):
        tkdry[:, k] = lam[k].ravel()          # count over (jj,ii) per kk
    mpp.set_soils(filter_thermal=np.ones(ncol, np.int64),
                  lun_type=np.full(ncol, IST_SOIL),
                  watsat=np.full((ncol, nz), 0.1),
                  csol=np.zeros((ncol, nz)),
                  tkmg=np.zeros((ncol, nz)),
                  tkdry=tkdry)

    # initial conditions
    mpp.soe.set_soln_prev_clm(np.full(n, 290.0))
    mpp.set_r_data(AuxVarKind.INTERNAL, Var.TUNING_FACTOR, 1, np.ones(n))
    mpp.set_r_data(AuxVarKind.INTERNAL, Var.LIQ_AREAL_DEN, 1, np.zeros(n))
    mpp.set_r_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1, bc_vals)

    # steady state: cnfac = 0 (thermal_mms_problem.F90:72)
    mpp.soe.cnfac = 0.0

    src = _heat_source(dim, xc3, yc3, zc3, dx, dy, dz).ravel()

    from mpp_tpu_torch.batched.ksp_compiled import compile_ksp
    # "petsc" replicates the reference's GMRES(30)+ILU(0) rtol-1e-5
    # iterate, which the golden baselines embed: Thomas on the 1-D
    # (tridiagonal) problem, Slice D on the others
    compile_ksp(mpp, linear_solver="petsc").install(device)
    mpp.soe.pre_step_dt()
    for _ in range(nstep):
        mpp.set_r_data(AuxVarKind.SS, Var.BC_SS_CONDITION, 1, src)
        mpp.set_r_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1, bc_vals)
        converged = mpp.soe.step_dt(1.0)
        assert converged, "thermal MMS KSP solve did not converge"
    return mpp, mpp.soe.get_soln()

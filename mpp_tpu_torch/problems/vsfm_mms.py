"""VSFM method-of-manufactured-solutions verification (steady 1-D soil).

Counterpart of ``mpp_tpu/problems/vsfm_mms.py``, which reimplements
``src/driver/standalone/vsfm/vsfm_mms_problem.F90`` with the
STEADY_STATE_SOIL_ONLY_1D manufactured solution of
``vsfm_mms_steady_state_soil_only_1D.F90``:

  P(x)    = 15000 sin(pi (x-x0)/L) - 20000 + Pref       (F90:55-64)
            (+20000 instead for ``fully_saturated``)
  k(x)    = 1e-11 (2 + cos(pi (x-x0)/L))                (F90:77-80)
  VG satfunc: alpha = 1/4000, lambda = 0.5, sr = 0.5    (F90:93,109,125)

on x in [0,10] with nx cells (ny=nz=1), zero porosity (steady), density
TGDPB01, Dirichlet BC from the analytic P at both x faces, and a
volumetric mass source S(x) = -d/dx(rho k kr/mu dP/dx) * dx staged through
the COND_MASS_RATE source-sink condition (F90:282-317).  One SNES step of
dt = 1 s recovers the manufactured steady state up to discretization
error; grid refinement must show ~2nd-order convergence of the cell-center
pressure error.

The steps run through the serial SNES of ``VSFMSoE.step_dt`` on
``device`` (the card unless ``device="cpu"``) or, with
``use_compiled``, the compiled batched stepper at ncol=1.
"""
from __future__ import annotations

import numpy as np
import torch

from mpp_tpu_torch.constants import (Cond, ConnKind, GEType, MPPType, Region,
                                     Var, AuxVarKind, MeshType as MeshKind,
                                     PRESSURE_REF, FMWH2O)
from mpp_tpu_torch.dtypes.mesh import structured_mesh, ConnectionSet
from mpp_tpu_torch.batched.vsfm_compiled import vsfm_stepper
from mpp_tpu_torch.models.richards import VSFMMPP
from mpp_tpu_torch.ops import eos
from mpp_tpu_torch.ops import satfunc as sf
from mpp_tpu_torch.io.regression import RegressionWriter

PI = 4.0 * np.arctan(1.0)
X_MIN, X_MAX = 0.0, 10.0
TEMP = 298.15


def manufactured_pressure(x, fully_saturated=False, deriv=None):
    xlim = X_MAX - X_MIN
    a0, a1 = 15000.0, -20000.0
    arg = (x - X_MIN) / xlim * PI
    if deriv is None:
        off = -a1 if fully_saturated else a1
        return a0 * np.sin(arg) + off + PRESSURE_REF
    if deriv == "dx":
        return a0 * PI / xlim * np.cos(arg)
    if deriv == "dx2":
        return -a0 * PI * PI / xlim / xlim * np.sin(arg)
    raise ValueError(deriv)


def manufactured_permeability(x, deriv=None):
    xlim = X_MAX - X_MIN
    p0 = 1.0e-11
    arg = (x - X_MIN) / xlim * PI
    if deriv is None:
        return p0 * (2.0 + np.cos(arg))
    return p0 * PI / xlim * (-np.sin(arg))


ALPHA = 1.0 / 4000.0
LAMBDA = 0.5
SAT_RES = 0.5


def _sat_params(n):
    sp = sf.SatParams.zeros(n)
    for i in range(n):
        sp.set_vg(i, SAT_RES, ALPHA, LAMBDA)
    return sp


def manufactured_source(x, dx, fully_saturated=False):
    """MMS source S = -d/dx(rho k kr/mu dP/dx) * dx  [kg/s per unit area]
    (vsfm_mms_steady_state_soil_only_1D.F90:282-317)."""
    x = np.asarray(x)
    P = manufactured_pressure(x, fully_saturated)
    dP_dx = manufactured_pressure(x, fully_saturated, "dx")
    d2P_dx2 = manufactured_pressure(x, fully_saturated, "dx2")
    k = manufactured_permeability(x)
    dk_dx = manufactured_permeability(x, "dx")

    Pt = torch.as_tensor(np.asarray(P, np.float64))
    mu = eos.viscosity(Pt, TEMP)[0].numpy()
    rho, drho_dP, _ = eos.density(Pt, TEMP, eos.DENSITY_TGDPB01)
    rho = rho.numpy() * FMWH2O
    drho_dP = drho_dP.numpy() * FMWH2O

    sp = _sat_params(x.size)
    kr, dkr_dP = sf.press_to_relperm(sp, Pt, torch.ones_like(Pt))
    kr, dkr_dP = kr.numpy(), dkr_dP.numpy()

    dkr_dx = dkr_dP * dP_dx
    drho_dx = drho_dP * dP_dx
    d2rho_dx2 = drho_dP * d2P_dx2  # d2rho_dP2 = 0 (F90:297)

    src = (-((k * kr / mu) * drho_dx + (rho * kr / mu) * dk_dx
             + (rho * k / mu) * dkr_dx) * dP_dx
           - (rho * k * kr / mu) * d2P_dx2)
    return src * dx


def run_vsfm_mms_problem(nx=20, fully_saturated=False,
                         use_compiled=False, device="cuda"):
    ny = nz = 1
    dx = (X_MAX - X_MIN) / nx
    mpp = VSFMMPP()
    mpp.set_name("VSFM for MMS")
    mpp.set_id(MPPType.VSFM_SNES_CLM)
    mesh = structured_mesh("Soil mesh", X_MAX, 1.0, 1.0, nx, ny, nz,
                           ConnKind.IN_XYZ_DIR, x_min=X_MIN)
    mesh.orientation = int(MeshKind.AGAINST_GRAVITY)
    mpp.add_mesh(mesh)
    ieqn = mpp.add_goveqn(GEType.RE, "Richards Equation ODE")

    # Boundary connections on the two x faces
    # (mpp_mesh_utils.F90 ComputeBoundaryDomainConnection, 1-D case)
    xc = mesh.xc
    ids = np.array([0, nx - 1], np.int32)
    uv = np.array([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]])
    cs = ConnectionSet(id_up=np.full(2, -1, np.int32), id_dn=ids,
                       dist_up=np.zeros(2), dist_dn=np.full(2, dx / 2.0),
                       area=np.ones(2),
                       itype=np.full(2, int(ConnKind.HORIZONTAL), np.int32),
                       unit_vec=uv)
    mpp.add_condition_in_goveqn(ieqn, Cond.BC, "Pressure BC", "Pa",
                                Cond.DIRICHLET, conn_set=cs)
    mpp.add_condition_in_goveqn(ieqn, Cond.SS, "Source term for MMS",
                                "kg/m^3", Cond.MASS_RATE,
                                region=Region.ALL_CELLS)
    mpp.allocate_auxvars()
    mpp.setup_problem()

    # material properties (F90:368-430)
    mpp.set_density_type(ieqn, eos.DENSITY_TGDPB01)
    mpp.set_soil_porosity(ieqn, np.zeros(nx))
    perm = manufactured_permeability(xc)
    mpp.set_soil_permeability(ieqn, perm, perm, perm)
    mpp.set_saturation_function(ieqn, np.full(nx, sf.SAT_FUNC_VAN_GENUCHTEN),
                                np.full(nx, ALPHA), np.full(nx, LAMBDA),
                                np.full(nx, SAT_RES))

    # IC: domain-mean manufactured pressure (F90:217-224)
    P_true = manufactured_pressure(xc, fully_saturated)
    mpp.restart(np.full(nx, P_true.mean()))

    vsfm_stepper(mpp, use_compiled, device)
    mpp.soe.pre_step_dt()
    mpp.set_data(AuxVarKind.SS, Var.BC_SS_CONDITION, 1,
                 manufactured_source(xc, dx, fully_saturated))
    P_bc = manufactured_pressure(
        np.array([X_MIN, X_MAX]), fully_saturated)
    mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1, P_bc)

    converged, reason = mpp.soe.step_dt(1.0, 1)
    assert converged, f"MMS solve diverged (reason {reason})"
    return mpp, P_true


def pressure_error(mpp, P_true):
    P = mpp.get_data(AuxVarKind.INTERNAL, Var.PRESSURE)
    return float(np.sqrt(np.mean((P - P_true) ** 2)))


def output_regression(mpp, filename_base, num_cells):
    w = RegressionWriter(filename_base, num_cells)
    w.write_data("liquid_pressure", "pressure",
                 mpp.get_data(AuxVarKind.INTERNAL, Var.PRESSURE))
    w.write_data("liquid_saturation", "general",
                 mpp.get_data(AuxVarKind.INTERNAL, Var.LIQ_SAT))
    w.close()
    return w.filename

"""Soil-plant-atmosphere continuum (SPAC) problem (VSFM).

Counterpart of ``mpp_tpu/problems/vsfm_spac.py``
(``src/driver/standalone/vsfm/vsfm_spac_problem.F90``): a
30-cell plant-hydraulics network — cell 1 (leaf/atmosphere side) connected
to cell 2 (xylem hub) by a leaf conductance, the hub connected to 28 root
cells, each root cell Dirichlet-coupled to soil water via a
Campbell-relperm conductance, with a Campbell-downregulated transpiration
sink on the bottom cell.  All fluxes use the conductance model
(CONDUCTANCE_FLUX_TYPE), Brooks-Corey saturation, constant density,
zero porosity (steady storage).

The steps run in f64 through the serial SNES of ``VSFMSoE.step_dt`` or,
with ``use_compiled``, the compiled batched stepper at ncol=1, on the
card unless the caller passes ``device="cpu"``.  The hub couples to every
root, so the Jacobian is not tridiagonal: the compiled stepper's "petsc"
plan (the default) runs the batched ILU(0) + GMRES(30), "direct" a dense
LU.
"""
from __future__ import annotations

import numpy as np

from mpp_tpu_torch import constants as C
from mpp_tpu_torch.constants import (Cond, ConnKind, GEType, MPPType, Region, Var,
                               AuxVarKind, FluxType, MeshType as MeshKind)
from mpp_tpu_torch.dtypes.mesh import Mesh, ConnectionSet
from mpp_tpu_torch.batched.vsfm_compiled import vsfm_stepper
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.io.regression import RegressionWriter
from mpp_tpu_torch.models.richards import VSFMMPP
from mpp_tpu_torch.ops import satfunc as sf

CAMPBELL_B = 4.58
CAMPBELL_HE = -4.2          # [J/kg]
CAMPBELL_N = 2.0 + 3.0 / CAMPBELL_B
THETA_S = 0.46
KS = 0.001


def _build_mesh(nz):
    dz_geom = 1.0 / nz              # used for centroids and conn distances
    dz_cell = 1.0 / 50.0            # hardcoded soil_dz (F90:220)
    n = nz
    zc = dz_geom / 2.0 + dz_geom * np.arange(nz)
    mesh = Mesh(name="Soil mesh", itype=int(MeshKind.CLM_SOIL_COL),
                orientation=int(MeshKind.AGAINST_GRAVITY),
                ncells_local=n, nlev=nz,
                xc=np.full(n, 0.5), yc=np.full(n, 0.5), zc=zc,
                dx=np.ones(n), dy=np.ones(n), dz=np.full(n, dz_cell),
                area_xy=np.ones(n), is_active=np.ones(n, bool))
    mesh.compute_volume()
    # connections: 1->2, then hub 2 -> k+1 for k=2..nz-1 (F90:253-276)
    id_up = [0] + [1] * (nz - 2)
    id_dn = [1] + list(range(2, nz))
    m = len(id_up)
    mesh.intrn_conn_sets = [ConnectionSet(
        id_up=np.array(id_up, np.int32), id_dn=np.array(id_dn, np.int32),
        dist_up=np.full(m, 0.5 * dz_geom), dist_dn=np.full(m, 0.5 * dz_geom),
        area=np.ones(m),
        itype=np.full(m, int(ConnKind.VERTICAL), np.int32))]
    return mesh


def run_vsfm_spac_problem(nz=30, dtime=3600.0, nstep=1, use_compiled=False,
                          linear_solver="petsc", device="cuda"):
    """vsfm_spac_problem.F90; returns the mpp.  ``linear_solver`` is the
    compiled stepper's plan."""
    device = device_of(device)
    mpp = VSFMMPP()
    mpp.set_name("Variably-Saturated-Flow-Model")
    mpp.set_id(MPPType.VSFM_SNES_CLM)
    mesh = _build_mesh(nz)
    mpp.add_mesh(mesh)
    ieqn = mpp.add_goveqn(GEType.RE, "Richards Equation ODE")

    # Root-soil BCs: 28 conns onto cells 3..30, unit vec (-1,0,0)
    nconn = 28
    ids = np.arange(2, 2 + nconn, dtype=np.int32)
    uv = np.zeros((nconn, 3))
    uv[:, 0] = -1.0
    cs = ConnectionSet(id_up=np.full(nconn, -1, np.int32), id_dn=ids,
                       dist_up=np.zeros(nconn), dist_dn=np.ones(nconn),
                       area=np.ones(nconn),
                       itype=np.full(nconn, int(ConnKind.VERTICAL), np.int32),
                       unit_vec=uv)
    mpp.add_condition_in_goveqn(ieqn, Cond.BC, "Root BC in soil equation",
                                "Pa", Cond.DIRICHLET, conn_set=cs)
    mpp.add_condition_in_goveqn(ieqn, Cond.SS, "Potential Mass_Flux", "kg/s",
                                Cond.DOWNREG_MASS_RATE_CAMPBELL,
                                region=Region.SOIL_BOTTOM_CELLS)
    mpp.allocate_auxvars()
    mpp.setup_problem()

    # material properties (F90:421-503): zero porosity, Brooks-Corey
    mpp.set_soil_porosity(1, np.zeros(nz))
    mpp.set_saturation_function(
        1, np.full(nz, sf.SAT_FUNC_BROOKS_COREY),
        np.full(nz, 1.0e-3 / (-CAMPBELL_HE)),
        np.full(nz, 1.0 / CAMPBELL_B), np.zeros(nz))
    mpp.set_ss_auxvar(1, Var.POT_MASS_SINK_EXPONENT, np.full(1, 10.0))
    mpp.set_ss_auxvar(1, Var.POT_MASS_SINK_PRESSURE, np.full(1, -1500000.0))

    # connection flux types + conductances (F90:575-700)
    nconn_in = nz - 1
    mpp.set_conn_int_value(1, AuxVarKind.CONN_INTERNAL, Var.FLUX_TYPE,
                           np.full(nconn_in, int(FluxType.CONDUCTANCE)))
    mpp.set_conn_int_value(1, AuxVarKind.CONN_BC, Var.FLUX_TYPE,
                           np.full(nconn, int(FluxType.CONDUCTANCE)))

    nz_loc = 50
    dz_loc = 1.0 / nz_loc
    z_int = np.array([kk * dz_loc for kk in range(nz_loc + 1)])
    root_depth, root_min = 0.6, 0.02
    rw, r1 = 25000000000.0, 0.001
    RL = 1.0 / (3.0e6 * 1.0)
    cond_in = np.zeros(nconn_in)
    cond_bc = np.zeros(nconn)
    he_bc = np.zeros(nconn)
    n_bc = np.zeros(nconn)
    cond_in[0] = RL
    PI = 4.0 * np.arctan(1.0)
    for kk in range(1, nz_loc + 1):     # kk is the 1-based Fortran index
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
            cond_in[kk - 2] = 1.0e-3 / Rr
            cond_bc[kk - 3] = 1.0e-3 / (bz / KS)
            he_bc[kk - 3] = -CAMPBELL_HE * 1.0e3
            n_bc[kk - 3] = CAMPBELL_N
    mpp.set_conn_real_value(1, AuxVarKind.CONN_INTERNAL, Var.CONDUCTANCE,
                            cond_in)
    mpp.set_conn_real_value(1, AuxVarKind.CONN_BC, Var.CONDUCTANCE, cond_bc)
    mpp.set_conn_relperm(1, AuxVarKind.CONN_BC,
                         set_upwind=np.zeros(nconn, bool),
                         relperm_itype=np.full(nconn,
                                               sf.RELPERM_FUNC_CAMPBELL),
                         p1=he_bc, p2=n_bc)

    # initial conditions (F90:506-530)
    Se = 0.30 / THETA_S
    press_ic = np.full(nz, CAMPBELL_HE * Se ** (-CAMPBELL_B) * 1.0e3
                       + 101325.0)
    mpp.restart(press_ic)

    # boundary conditions + sink (F90:533-575)
    mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1,
                 np.full(nconn, CAMPBELL_HE * Se ** (-CAMPBELL_B) * 1.0e3
                         + 101325.0))
    mpp.set_data(AuxVarKind.SS, Var.BC_SS_CONDITION, 1,
                 np.full(1, 7.1875e-10 * 1e3))

    vsfm_stepper(mpp, use_compiled, device, linear_solver=linear_solver)
    for istep in range(1, nstep + 1):
        converged, reason = mpp.soe.step_dt(dtime, istep)
        assert converged, f"step {istep} diverged (reason {reason})"
    return mpp


def output_regression(mpp, filename_base, num_cells):
    w = RegressionWriter(filename_base, num_cells)
    w.write_data("liquid_pressure", "pressure",
                 mpp.get_data(AuxVarKind.INTERNAL, Var.PRESSURE))
    w.write_data("liquid_saturation", "general",
                 mpp.get_data(AuxVarKind.INTERNAL, Var.LIQ_SAT))
    w.close()
    return w.filename

"""V-channel 3-D gravity-drainage problem (VSFM).

Counterpart of ``mpp_tpu/problems/vsfm_vchannel.py``
(``src/driver/standalone/vsfm/vsfm_vchannel_problem.F90``):
20x10x30 cells on a tilted V-shaped valley (slope_x=0.1 toward the center
line, slope_y=0.2 along the channel), uniform van Genuchten soil, no
boundary conditions by default (pure redistribution from a water-table
initial condition), 3 steps of dt=8640 s.  The optional seepage-BC
variant adds a COND_SEEPAGE_BC on the top face.

The steps run in f64 through the serial SNES of ``VSFMSoE.step_dt`` or,
with ``use_compiled``, the compiled batched stepper
(``batched/vsfm_compiled.compile_vsfm(mpp, linear_solver=...)``) at
ncol=1, on the card unless the caller passes ``device="cpu"``.  The mesh
is 3-D, so the compiled "petsc" plan (the default) runs the batched
ILU(0) + GMRES(30) and "direct" block-Thomas over the 200-cell levels.  ``output_regression`` writes
the reference's regression file.
"""
from __future__ import annotations

import numpy as np

from mpp_tpu_torch import constants as C
from mpp_tpu_torch.constants import (Cond, ConnKind, GEType, MPPType, Var,
                               AuxVarKind, MeshType as MeshKind)
from mpp_tpu_torch.dtypes.mesh import Mesh, ConnectionSet, compute_cell_ids
from mpp_tpu_torch.batched.vsfm_compiled import vsfm_stepper
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.models.richards import VSFMMPP
from mpp_tpu_torch.ops import eos
# the VSFM writer (pressure + saturation) is shared with vsfm_spac
from mpp_tpu_torch.problems.vsfm_spac import output_regression  # noqa: F401

NX, NY = 20, 10
DX, DY, DZ = 10.0, 10.0, 0.5
SLOPE_X, SLOPE_Y = 0.1, 0.2


def _build_mesh(nz):
    n = NX * NY * nz
    # vertex elevations: V-shape in x, linear in y (F90:290-309)
    zv_x = np.empty(NX + 1)
    for ii in range(1, NX // 2 + 2):
        zv_x[ii - 1] = SLOPE_X * DX * (NX // 2) - (ii - 1) * SLOPE_X * DX
    for ii in range(NX // 2 + 2, NX + 2):
        zv_x[ii - 1] = (ii - NX // 2 - 1) * SLOPE_X * DX
    zv_y = np.array([(jj - 1) * SLOPE_Y * DY for jj in range(1, NY + 2)])
    xv = np.empty((NX + 1, NY + 1))
    yv = np.empty((NX + 1, NY + 1))
    zv = np.empty((NX + 1, NY + 1))
    for jj in range(NY + 1):
        for ii in range(NX + 1):
            zv[ii, jj] = zv_x[ii] + zv_y[jj]
            xv[ii, jj] = ii * DX
            yv[ii, jj] = jj * DY
    xc = np.empty(n)
    yc = np.empty(n)
    zc = np.empty(n)
    ids = compute_cell_ids(NX, NY, nz)  # [kk,jj,ii]
    for kk in range(nz):
        for jj in range(NY):
            for ii in range(NX):
                i = ids[kk, jj, ii]
                xc[i] = (xv[ii, jj] + xv[ii + 1, jj] + xv[ii, jj + 1]
                         + xv[ii + 1, jj + 1]) / 4.0
                yc[i] = (yv[ii, jj] + yv[ii + 1, jj] + yv[ii, jj + 1]
                         + yv[ii + 1, jj + 1]) / 4.0
                zc[i] = (zv[ii, jj] + zv[ii + 1, jj] + zv[ii, jj + 1]
                         + zv[ii + 1, jj + 1]) / 4.0 \
                    - (DZ / 2.0 + (nz - kk - 1) * DZ)
    mesh = Mesh(name="Soil mesh", itype=int(MeshKind.CLM_SOIL_COL),
                orientation=int(MeshKind.AGAINST_GRAVITY),
                ncells_local=n, nlev=nz,
                xc=xc, yc=yc, zc=zc,
                dx=np.full(n, DX), dy=np.full(n, DY), dz=np.full(n, DZ),
                area_xy=np.full(n, DX * DY), is_active=np.ones(n, bool))
    mesh.compute_volume()

    # internal connections: vertical (kk outer loop ii, jj inner per F90
    # ordering: kk, ii, jj), then x-horizontal, then y-horizontal
    id_up, id_dn, dup, ddn, area, ctype = [], [], [], [], [], []
    for kk in range(nz - 1):
        for ii in range(NX):
            for jj in range(NY):
                id_up.append(ids[kk, jj, ii])
                id_dn.append(ids[kk + 1, jj, ii])
                dup.append(0.5 * DZ)
                ddn.append(0.5 * DZ)
                area.append(DX * DY)
                ctype.append(int(ConnKind.VERTICAL))
    for ii in range(NX - 1):
        for kk in range(nz):
            for jj in range(NY):
                u, d = ids[kk, jj, ii], ids[kk, jj, ii + 1]
                dist = np.sqrt((xc[u] - xc[d]) ** 2 + (yc[u] - yc[d]) ** 2
                               + (zc[u] - zc[d]) ** 2)
                id_up.append(u)
                id_dn.append(d)
                dup.append(0.5 * dist)
                ddn.append(0.5 * dist)
                area.append(DZ * DY)
                ctype.append(int(ConnKind.HORIZONTAL))
    for jj in range(NY - 1):
        for kk in range(nz):
            for ii in range(NX):
                u, d = ids[kk, jj, ii], ids[kk, jj + 1, ii]
                dist = np.sqrt((xc[u] - xc[d]) ** 2 + (yc[u] - yc[d]) ** 2
                               + (zc[u] - zc[d]) ** 2)
                id_up.append(u)
                id_dn.append(d)
                dup.append(0.5 * dist)
                ddn.append(0.5 * dist)
                area.append(DZ * DX)
                ctype.append(int(ConnKind.HORIZONTAL))
    mesh.intrn_conn_sets = [ConnectionSet(
        id_up=np.array(id_up, np.int32), id_dn=np.array(id_dn, np.int32),
        dist_up=np.array(dup), dist_dn=np.array(ddn), area=np.array(area),
        itype=np.array(ctype, np.int32))]
    return mesh


def run_vsfm_vchannel_problem(nz=30, dtime=8640.0, nstep=3,
                              with_seepage_bc=False, ic_offset=2.0,
                              use_compiled=False, linear_solver="petsc",
                              device="cuda"):
    """vsfm_vchannel_problem.F90: 20 x 10 x nz cells, ``nstep`` steps of
    ``dtime``; returns the mpp (its SoE holds the state).
    ``linear_solver`` is the compiled stepper's plan."""
    device = device_of(device)
    n = NX * NY * nz
    mpp = VSFMMPP()
    mpp.set_name("Variably-Saturated-Flow-Model")
    mpp.set_id(MPPType.VSFM_SNES_CLM)
    mesh = _build_mesh(nz)
    mpp.add_mesh(mesh)
    ieqn = mpp.add_goveqn(GEType.RE, "Richards Equation ODE")

    if with_seepage_bc:
        ids = np.arange(NX * NY * (nz - 1), NX * NY * nz, dtype=np.int32)
        m = ids.size
        uv = np.zeros((m, 3))
        uv[:, 2] = -1.0
        cs = ConnectionSet(id_up=np.full(m, -1, np.int32), id_dn=ids,
                           dist_up=np.zeros(m), dist_dn=np.full(m, 0.5 * DZ),
                           area=np.full(m, DX * DY),
                           itype=np.full(m, int(ConnKind.VERTICAL), np.int32),
                           unit_vec=uv)
        mpp.add_condition_in_goveqn(ieqn, Cond.BC,
                                    "Constant head condition at top", "Pa",
                                    Cond.SEEPAGE_BC, conn_set=cs)
    mpp.allocate_auxvars()
    mpp.setup_problem()

    porosity, lam, alpha, perm = 0.368, 0.5, 3.4257e-4, 8.3913e-12
    vish2o = 0.001002
    hksat = perm / vish2o * (C.DENH2O * C.GRAV_CLM) / 0.001
    ncol = NX * NY
    shape = (ncol, nz)
    mpp.set_soils(filter_vsfmc=np.ones(ncol, np.int64),
                  watsat=np.full(shape, porosity),
                  hksat=np.full(shape, hksat),
                  bsw=np.full(shape, 1.0 / lam),
                  sucsat=np.full(shape, 1.0 / (alpha * C.GRAV_CLM)),
                  residual_sat=np.full(shape, 0.2772),
                  satfunc_type="van_genuchten",
                  density_type=eos.DENSITY_TGDPB01)

    # IC: water table at 18.75 - 0.5*(jz) - 2 m head (F90:1003-1032)
    press_ic = np.empty(n)
    icell = 0
    for jz in range(1, nz + 1):
        for c in range(ncol):
            press_ic[icell] = ((18.75 - 0.5 * (jz - 1) - ic_offset)
                               * 997.18 * 9.8 + 101325.0)
            icell += 1
    mpp.restart(press_ic)

    vsfm_stepper(mpp, use_compiled, device, linear_solver=linear_solver)
    for istep in range(1, nstep + 1):
        if with_seepage_bc:
            mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1,
                         np.full(ncol, 101325.0))
        converged, reason = mpp.soe.step_dt(dtime, istep)
        assert converged, f"step {istep} diverged (reason {reason})"
    return mpp

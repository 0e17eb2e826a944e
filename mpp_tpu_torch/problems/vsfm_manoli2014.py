"""Manoli et al. (2014) SPAC problem: 3 coupled Richards GEs.

Counterpart of ``mpp_tpu/problems/vsfm_manoli2014.py``, which reimplements
``src/driver/standalone/vsfm/vsfm_manoli2014_problem.F90``:
a soil column (nz=50, dz=0.1 m, :15-20,443-455), a root column (nz=30,
sharing the soil's upper zc, :22-24,457-467) and a 17-m xylem column
(nz=170, :26-28,469-480), each carrying a Richards GE (:799-806), all
with identical van Genuchten soils (sat_res=0.06, alpha=5e-5 1/Pa,
m=0.33, por=0.5, perm=6.83e-11 m^2, :50-81) and Darcy coupling fluxes:

* soil<->root over all 30 root layers, exchange area dx*dy and
  root-radius/2 face distances (:883-900,905-944);
* root<->xylem at the root top cell / xylem bottom cell via
  region-based coupling BCs (:946-963).

IC: uniform absolute pressure 3535.5 Pa (:83,1292-1297); no external
BC/SS forcing, so the transient is pure gravity redistribution through
the coupled network and total water mass is conserved exactly.  The
reference ships no regression golden for this driver; the test asserts
mass conservation + approach to gravity equilibrium instead.

The steps run through the serial SNES of ``VSFMSoE.step_dt`` on
``device`` (the card unless ``device="cpu"``) or, with
``use_compiled``, the compiled batched stepper at ncol=1.
"""
from __future__ import annotations

import numpy as np

from mpp_tpu_torch.constants import (ConnKind, GEType, MPPType, Region,
                                     MeshType as MeshKind)
from mpp_tpu_torch.dtypes.mesh import Mesh, ConnectionSet
from mpp_tpu_torch.batched.vsfm_compiled import vsfm_stepper
from mpp_tpu_torch.models.richards import VSFMMPP
from mpp_tpu_torch.ops import satfunc as sf

NZ_SOIL = 50
NZ_ROOT = 30
NZ_XYLEM = 170
DX = 1.0
DY = 1.0
DZ = 0.1                      # [m] (F90:32)
ROOT_RADIUS = 2.0e-3          # [m] (F90:45)

SAT_RES = 0.06
ALPHA = 0.00005               # [1/Pa]
VG_M = 0.33
POR = 0.5
PERM = 6.83e-11               # [m^2]
PRESS_INITIAL = 3.5355e3      # [Pa] (F90:83)


def _column_mesh(name, kind, nz, zc, dx=DX, dy=DY):
    mesh = Mesh(name=name, itype=int(kind),
                orientation=int(MeshKind.ALONG_GRAVITY),
                ncells_local=nz, nlev=nz,
                xc=np.full(nz, dx / 2.0), yc=np.full(nz, dy / 2.0),
                zc=np.asarray(zc, np.float64),
                dx=np.full(nz, dx), dy=np.full(nz, dy),
                dz=np.full(nz, DZ),
                # F90:500-504 overrides every area/vol to dx*dy / dx*dy*dz
                area_xy=np.full(nz, DX * DY),
                is_active=np.ones(nz, bool))
    mesh.vol = np.full(nz, DX * DY * DZ)
    ids = np.arange(nz - 1, dtype=np.int32)
    mesh.intrn_conn_sets = [ConnectionSet(
        id_up=ids, id_dn=ids + 1,
        dist_up=np.full(nz - 1, DZ / 2.0), dist_dn=np.full(nz - 1, DZ / 2.0),
        area=np.full(nz - 1, DX * DY),
        itype=np.full(nz - 1, int(ConnKind.VERTICAL), np.int32))]
    return mesh


def _soil_root_conn_set(ux):
    """The 30-connection soil<->root exchange set (F90:883-900): boundary
    face at root_radius/2 from the cell, area dx*dy (root_surf_area is
    overridden at :880), horizontal unit vector."""
    m = NZ_ROOT
    uv = np.zeros((m, 3))
    uv[:, 0] = ux
    return ConnectionSet(
        id_up=np.full(m, -1, np.int32),
        id_dn=np.arange(m, dtype=np.int32),
        dist_up=np.zeros(m),
        dist_dn=np.full(m, ROOT_RADIUS / 2.0),
        area=np.full(m, DX * DY),
        itype=np.full(m, int(ConnKind.VERTICAL), np.int32),
        unit_vec=uv)


def build_vsfm_manoli2014():
    # meshes (F90:443-480): zc descends from -dz/2; roots share the soil
    # zc; the xylem top cell sits at nz_xylem*dz - dz/2
    zc_soil = -(DZ / 2.0) - DZ * np.arange(NZ_SOIL)
    zc_root = zc_soil[:NZ_ROOT]
    zc_xylem = (NZ_XYLEM * DZ - DZ / 2.0) - DZ * np.arange(NZ_XYLEM)

    mpp = VSFMMPP()
    mpp.set_name("Variably-Saturated-Flow-Model For SPAC")
    mpp.set_id(MPPType.VSFM_SNES_CLM)
    mpp.add_mesh(_column_mesh("Soil mesh", MeshKind.CLM_SOIL_COL,
                              NZ_SOIL, zc_soil))
    mpp.add_mesh(_column_mesh("Root mesh", MeshKind.SPAC_ROOT_COL,
                              NZ_ROOT, zc_root))
    mpp.add_mesh(_column_mesh("Xylem mesh", MeshKind.SPAC_XYLEM_COL,
                              NZ_XYLEM, zc_xylem, dx=0.25, dy=0.25))
    mpp.add_goveqn(GEType.RE, "Richards Equation ODE for Soil", 0)
    mpp.add_goveqn(GEType.RE, "Richards Equation ODE for Root", 1)
    mpp.add_goveqn(GEType.RE, "Richards Equation ODE for Xylem", 2)

    # coupling BCs (F90:912-963); ordering within each GE pair must match
    # so update_connections pairs them
    mpp.add_coupling_bcs_in_goveqn(1, "Root BC in soil equation", "Pa",
                                   [2], _soil_root_conn_set(-1.0))
    mpp.add_coupling_bcs_in_goveqn(2, "Soil BC in root equation", "Pa",
                                   [1], _soil_root_conn_set(1.0))
    from mpp_tpu_torch.dtypes.regions import region_connection_set
    mpp.add_coupling_bcs_in_goveqn(
        2, "Xylem BC in root equation", "Pa", [3],
        region_connection_set(mpp.meshes[1], Region.SOIL_TOP_CELLS))
    mpp.add_coupling_bcs_in_goveqn(
        3, "Root BC in xylem equation", "Pa", [2],
        region_connection_set(mpp.meshes[2], Region.SOIL_BOTTOM_CELLS))

    mpp.allocate_auxvars()
    mpp.setup_problem()

    # materials (F90:1098-1214): identical VG everywhere
    for ieqn, nz in ((1, NZ_SOIL), (2, NZ_ROOT), (3, NZ_XYLEM)):
        perm = np.full(nz, PERM)
        mpp.set_soil_porosity(ieqn, np.full(nz, POR))
        mpp.set_saturation_function(
            ieqn, np.full(nz, sf.SAT_FUNC_VAN_GENUCHTEN),
            np.full(nz, ALPHA), np.full(nz, VG_M), np.full(nz, SAT_RES))
        mpp.set_soil_permeability(ieqn, perm, perm, perm)

    mpp.update_connections()

    # IC (F90:1292-1297)
    ncells = NZ_SOIL + NZ_ROOT + NZ_XYLEM
    mpp.restart(np.full(ncells, PRESS_INITIAL))
    return mpp


def run_vsfm_manoli2014_problem(dtime=8640.0, nstep=3,
                               use_compiled=False, device="cuda"):
    """run_vsfm_manoli2014_problem (F90:90-169): default dt=8640 s,
    nstep=3, no BC updates inside the loop."""
    mpp = build_vsfm_manoli2014()
    vsfm_stepper(mpp, use_compiled, device)
    for istep in range(1, nstep + 1):
        converged, reason = mpp.soe.step_dt(dtime, istep)
        assert converged, f"step {istep} diverged (reason {reason})"
    return mpp

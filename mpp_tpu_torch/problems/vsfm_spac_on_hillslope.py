"""Hillslope VSFM problem: laterally-connected sloped soil columns.

Counterpart of ``mpp_tpu/problems/vsfm_spac_on_hillslope.py``, which
reimplements the soil component of
``src/driver/standalone/vsfm/vsfm_spac_on_hillslope.F90`` (soil
parameters :526-553; 3-D soil mesh with horizontal soil-to-soil
connections and per-column elevation; the reference couples overstory/
understory SPAC networks on top — the lateral soil machinery is the part
no other standalone exercises).  A single Richards GE owns an nx*nz
unstructured mesh whose internal connection set mixes vertical
(within-column) and horizontal (between-column) two-point fluxes; the
slope enters through the horizontal connections' unit-vector z-component
(gravity drives downslope drainage exactly as in
``RichardsMod.F90:118-340``).

No regression golden exists (the reference driver isn't in the
regression suites); tests assert conservation, downslope redistribution,
and the hydrostatic lateral equilibrium, plus 1-device vs 8-device
consistency of the equivalent column-sharded formulation (ugrid path).

The steps run through the serial SNES of ``VSFMSoE.step_dt`` on
``device`` (the card unless ``device="cpu"``).
"""
from __future__ import annotations

import numpy as np

from mpp_tpu_torch.constants import (ConnKind, GEType, MPPType,
                                     MeshType as MeshKind)
from mpp_tpu_torch.dtypes.mesh import Mesh, ConnectionSet
from mpp_tpu_torch.batched.vsfm_compiled import vsfm_stepper
from mpp_tpu_torch.models.richards import VSFMMPP
from mpp_tpu_torch.ops import satfunc as sf

# soil_parameters (F90:526-553)
NX, NZ = 2, 20
DX, DY, DZ = 10.0, 10.0, 0.25
PERM = 6.83e-11
SAT_RES = 0.06
ALPHA = 0.00005
VG_M = 0.33
POR = 0.5


def _hillslope_mesh(nx=NX, nz=NZ, slope=0.1):
    """nx sloped columns of nz cells (cell = col*nz + k, k=0 at the
    surface), with vertical conns within columns and horizontal conns
    between laterally-adjacent cells of neighboring columns."""
    n = nx * nz
    elev = slope * DX * (nx - 1 - np.arange(nx))    # downslope to the right
    zc = np.empty(n)
    for c in range(nx):
        for k in range(nz):
            zc[c * nz + k] = elev[c] - (k + 0.5) * DZ
    mesh = Mesh(name="Hillslope soil mesh", itype=0,
                orientation=int(MeshKind.ALONG_GRAVITY),
                ncells_local=n, nlev=nz,
                xc=np.repeat(np.arange(nx) * DX + DX / 2, nz),
                yc=np.full(n, DY / 2), zc=zc,
                dx=np.full(n, DX), dy=np.full(n, DY), dz=np.full(n, DZ),
                area_xy=np.full(n, DX * DY), is_active=np.ones(n, bool))
    mesh.compute_volume()

    iu, idn, dup, ddn, area = [], [], [], [], []
    # vertical connections (top cell is 'up')
    for c in range(nx):
        for k in range(nz - 1):
            iu.append(c * nz + k)
            idn.append(c * nz + k + 1)
            dup.append(DZ / 2)
            ddn.append(DZ / 2)
            area.append(DX * DY)
    # horizontal connections (same layer, adjacent columns); the slope
    # tilts the connection — the unit vector is derived from the cell
    # centroids (which carry the elevation), MeshType.F90:932-938
    for c in range(nx - 1):
        dz_elev = elev[c] - elev[c + 1]
        dist = np.hypot(DX, dz_elev)
        for k in range(nz):
            iu.append(c * nz + k)
            idn.append((c + 1) * nz + k)
            dup.append(dist / 2)
            ddn.append(dist / 2)
            area.append(DY * DZ)
    m = len(iu)
    mesh.intrn_conn_sets = [ConnectionSet(
        id_up=np.asarray(iu, np.int32), id_dn=np.asarray(idn, np.int32),
        dist_up=np.asarray(dup), dist_dn=np.asarray(ddn),
        area=np.asarray(area),
        itype=np.full(m, int(ConnKind.VERTICAL), np.int32))]
    return mesh, elev


def run_vsfm_spac_on_hillslope_problem(slope=0.1, nstep=1, dtime=3600.0,
                                       lateral=True, device="cuda"):
    mesh, elev = _hillslope_mesh(slope=slope)
    if not lateral:
        # is_soil_horizontally_disconnected mode: drop horizontal conns
        cs = mesh.intrn_conn_sets[0]
        nvert = NX * (NZ - 1)
        mesh.intrn_conn_sets = [ConnectionSet(
            id_up=cs.id_up[:nvert], id_dn=cs.id_dn[:nvert],
            dist_up=cs.dist_up[:nvert], dist_dn=cs.dist_dn[:nvert],
            area=cs.area[:nvert], itype=cs.itype[:nvert])]

    mpp = VSFMMPP()
    mpp.set_name("Variably-Saturated-Flow-Model")
    mpp.set_id(MPPType.VSFM_SNES_CLM)
    mpp.add_mesh(mesh)
    mpp.add_goveqn(GEType.RE, "Richards Equation ODE")
    mpp.allocate_auxvars()
    # the mixed vertical+lateral system needs the BT<->L2 line-search
    # rotation once the upslope top cells desaturate
    mpp.setup_problem(dyn_linesearch=True)

    n = NX * NZ
    perm = np.full(n, PERM)
    mpp.set_soil_porosity(1, np.full(n, POR))
    mpp.set_saturation_function(
        1, np.full(n, sf.SAT_FUNC_VAN_GENUCHTEN),
        np.full(n, ALPHA), np.full(n, VG_M), np.full(n, SAT_RES))
    mpp.set_soil_permeability(1, perm, perm, perm)

    # IC: water table 2 m below each column's surface -> hydrostatic in z
    # but DISEQUILIBRATED laterally on a slope (drives downslope flow)
    press_ic = np.empty(n)
    for c in range(NX):
        for k in range(NZ):
            depth = (k + 0.5) * DZ
            press_ic[c * NZ + k] = 101325.0 + 9810.0 * (depth - 2.0)
    mpp.restart(press_ic)

    vsfm_stepper(mpp, False, device)
    for istep in range(1, nstep + 1):
        converged, reason = mpp.soe.step_dt(dtime, istep)
        assert converged, f"step {istep} diverged (reason {reason})"
    return mpp, elev

"""Manoli et al. (2014) SPAC network with coupled thermal-hydrology.

Counterpart of ``mpp_tpu/problems/th_manoli2014.py``, which reimplements
``src/driver/standalone/thermal-e/th_manoli2014_problem.F90``: the
vsfm_manoli2014 soil/root/xylem geometry (:267-814, the mesh constants of
``problems/vsfm_manoli2014``) carrying SIX governing equations, a
Richards mass GE and an enthalpy energy GE per mesh (:818-861), with
soil<->root coupling over every root layer and a root-top/xylem-bottom
junction (:891-967, :970-1090).  Uniform van Genuchten "top" soil
parameters on every mesh (:1530-1650), thermal properties alpha 0.45 /
k_wet 1.3 / k_dry 0.25 / cp 837 / rho_s 2700 (:1766-1812), IC P = 3535.5
Pa, T = 283.15 K (:1898-1912); dt = 8640 s, nstep = 3 (:116-185).

The network is closed (no external BCs or sources), so mass and energy
are conserved exactly while the water redistributes under gravity and
enthalpy moves with it.  The steps run through ``THSpacSoE.step_dt`` on
``device`` (the card unless ``device="cpu"``).
"""
from __future__ import annotations

import numpy as np

from mpp_tpu_torch.constants import GEType, MPPType, MeshType as MeshKind
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.models.th_spac import THSpacMPP
from mpp_tpu_torch.ops import satfunc as sf
from mpp_tpu_torch.problems.vsfm_manoli2014 import (
    _column_mesh, DZ, NZ_ROOT, NZ_SOIL, NZ_XYLEM, ROOT_RADIUS, SAT_RES,
    ALPHA, VG_M, POR, PERM, PRESS_INITIAL)

TEMP_INITIAL = 283.15    # [K] (F90:1907)


def build_th_manoli2014(scale: int = 1, device="cuda"):
    """``scale`` multiplies every mesh's cell count (same geometry step),
    for scaling runs of the sparse-Jacobian TH network; scale=1 is the
    reference configuration.  The SoE steps on ``device``."""
    nz_soil, nz_root, nz_xylem = (NZ_SOIL * scale, NZ_ROOT * scale,
                                  NZ_XYLEM * scale)
    zc_soil = -(DZ / 2.0) - DZ * np.arange(nz_soil)
    zc_root = zc_soil[:nz_root]
    zc_xylem = (nz_xylem * DZ - DZ / 2.0) - DZ * np.arange(nz_xylem)

    mpp = THSpacMPP()
    mpp.soe.device = device_of(device)
    mpp.set_name("TH for SPAC")
    mpp.set_id(MPPType.TH_SNES_CLM)
    mpp.add_mesh(_column_mesh("Soil mesh", MeshKind.CLM_SOIL_COL,
                              nz_soil, zc_soil))
    mpp.add_mesh(_column_mesh("Root mesh", MeshKind.SPAC_ROOT_COL,
                              nz_root, zc_root))
    mpp.add_mesh(_column_mesh("Xylem mesh", MeshKind.SPAC_XYLEM_COL,
                              nz_xylem, zc_xylem, dx=0.25, dy=0.25))
    for i, nm in enumerate(("Soil", "Root", "Xylem")):
        mpp.add_goveqn(GEType.RE, f"Mass Equation ODE for {nm}", i)
    for i, nm in enumerate(("Soil", "Root", "Xylem")):
        mpp.add_goveqn(GEType.THERM_SOIL_EBASED,
                       f"Enthalpy-based ODE for heat transport for {nm}", i)

    # couplings (F90:970-1090): soil<->root over every root layer
    # (horizontal, root_radius/2 face distances, area dx*dy); root top
    # <-> xylem bottom junction (vertical, dz/2 each side)
    rr = np.arange(nz_root)
    mpp.add_coupling(0, 1, rr, rr,
                     np.full(nz_root, ROOT_RADIUS / 2.0),
                     np.full(nz_root, ROOT_RADIUS / 2.0),
                     np.ones(nz_root), np.zeros(nz_root))
    # up side (b) = xylem bottom cell sits ABOVE dn side (a) = root top
    # cell: the up->dn unit vector points down, unit_z = -1
    mpp.add_coupling(1, 2, np.array([0]), np.array([nz_xylem - 1]),
                     np.array([DZ / 2.0]), np.array([DZ / 2.0]),
                     np.ones(1), np.array([-1.0]))

    for g in mpp.soe.goveqns:
        g.allocate_auxvars()

    # materials (F90:1530-1650 mass, 1660-1840 energy): uniform VG 'top'
    # parameters; the energy GEs add the thermal constants
    for g in mpp.soe.goveqns:
        n = g.mesh.ncells_local
        g.set_soil_porosity(np.full(n, POR))
        g.set_saturation_function(np.full(n, sf.SAT_FUNC_VAN_GENUCHTEN),
                                  np.full(n, ALPHA), np.full(n, VG_M),
                                  np.full(n, SAT_RES))
        g.set_soil_permeability(np.full(n, PERM), np.full(n, PERM),
                                np.full(n, PERM))
    for ge in mpp.soe.energy_ges:
        ge.therm_alpha[:] = 0.45
        ge.therm_cond_wet[:] = 1.3
        ge.therm_cond_dry[:] = 0.25
        ge.heat_cap_soil[:] = 837.0
        ge.den_soil[:] = 2700.0
        ge.invalidate()

    mpp.soe.setup()

    ncells = nz_soil + nz_root + nz_xylem
    mpp.restart(np.full(ncells, PRESS_INITIAL),
                np.full(ncells, TEMP_INITIAL))
    return mpp


def run_th_manoli2014_problem(dtime=8640.0, nstep=3, device="cuda"):
    """run_th_manoli2014_problem (F90:116-185) on ``device``."""
    mpp = build_th_manoli2014(device=device)
    for istep in range(1, nstep + 1):
        converged, reason = mpp.soe.step_dt(dtime, istep)
        assert converged, f"step {istep} diverged (reason {reason})"
    return mpp

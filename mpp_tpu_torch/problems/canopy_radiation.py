"""Standalone canopy radiation / leaf-boundary-layer problems.

Counterpart of ``mpp_tpu/problems/canopy_radiation.py``, the reference
drivers:

* ``driver/standalone/shortwave/*`` — 61-layer canopy two-band shortwave
* ``driver/standalone/longwave/*`` — 93-layer canopy longwave
* ``driver/standalone/leafbndlyr/*`` — 93-leaf boundary-layer conductances

All use the same canopy column mesh (soil cell at z=0, layers above,
Dirichlet sky forcing at the top cell).  The problems run on ``device``
(the card unless ``device="cpu"``); ``use_compiled`` steps through
``batched/ksp_compiled.compile_radiation``.  The ``output_regression_*``
writers read the GE's tensors back to the host and write the reference's
regression files.
"""
from __future__ import annotations

import numpy as np
import torch

from mpp_tpu_torch.constants import (Cond, ConnKind, MPPType, TFRZ,
                                     MeshType as MeshKind)
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.io.regression import RegressionWriter
from mpp_tpu_torch.dtypes.mesh import Mesh, ConnectionSet
from mpp_tpu_torch.models.radiation import ShortwaveMPP, LongwaveMPP
from mpp_tpu_torch.models.lbl import LBLMPP

Z_CAIR = 46.0


def canopy_mesh(nz_cair, ncair=1, ntree=1):
    """Canopy column mesh (shortwave_meshes.F90:38-180): ncells =
    (nz_cair+1) per (cair, tree); cell 1 soil at z=0, cell 2 at dz/2, then
    +dz; vertical conns between consecutive cells."""
    ncol = ncair * ntree
    npc = nz_cair + 1
    n = npc * ncol
    dz_cair = Z_CAIR / nz_cair
    zc = np.zeros(n)
    icell = 0
    for c in range(ncol):
        for k in range(npc):
            if k == 0:
                zc[icell] = 0.0
            elif k == 1:
                zc[icell] = dz_cair / 2.0
            else:
                zc[icell] = zc[icell - 1] + dz_cair
            icell += 1
    mesh = Mesh(name="Canopy Air", itype=0,
                orientation=int(MeshKind.AGAINST_GRAVITY),
                ncells_local=n, nlev=npc,
                xc=np.zeros(n), yc=np.zeros(n), zc=zc,
                dx=np.ones(n), dy=np.ones(n), dz=np.full(n, dz_cair),
                area_xy=np.ones(n), is_active=np.ones(n, bool))
    mesh.compute_volume()
    id_up, id_dn = [], []
    for c in range(ncol):
        base = c * npc
        for k in range(nz_cair):
            id_up.append(base + k)
            id_dn.append(base + k + 1)
    m = len(id_up)
    mesh.intrn_conn_sets = [ConnectionSet(
        id_up=np.array(id_up, np.int32), id_dn=np.array(id_dn, np.int32),
        dist_up=np.full(m, dz_cair / 2), dist_dn=np.full(m, dz_cair / 2),
        area=np.ones(m), itype=np.full(m, int(ConnKind.VERTICAL), np.int32))]
    return mesh


def _top_bc_conns(nz_cair, ncair, dz_cair):
    ids = np.array([(nz_cair + 1) * (k + 1) - 1 for k in range(ncair)],
                   np.int32)
    m = ids.size
    uv = np.zeros((m, 3))
    uv[:, 0] = -1.0
    return ConnectionSet(id_up=np.full(m, -1, np.int32), id_dn=ids,
                         dist_up=np.zeros(m), dist_dn=np.full(m, dz_cair),
                         area=np.ones(m),
                         itype=np.full(m, int(ConnKind.VERTICAL), np.int32),
                         unit_vec=uv)


def _f64(a, device):
    return torch.as_tensor(np.asarray(a, np.float64), device=device)


def run_shortwave_problem(ncair=1, ntree=1, use_compiled=False,
                          device="cuda"):
    """shortwave_problem.F90 + shortwave_parameters.F90."""
    device = device_of(device)
    nz_cair = 60
    dz_cair = Z_CAIR / nz_cair
    mpp = ShortwaveMPP(device=device)
    mpp.set_name("Shortwave radiation model")
    mpp.set_id(MPPType.SHORTWAVE_KSP)
    mesh = canopy_mesh(nz_cair, ncair, ntree)
    mpp.add_mesh(mesh)
    ieqn = mpp.add_goveqn("shortwave")
    mpp.add_condition_in_goveqn(ieqn, Cond.BC, "Atmospheric forcing", "K",
                                Cond.DIRICHLET,
                                conn_set=_top_bc_conns(nz_cair, ncair,
                                                       dz_cair))
    mpp.allocate_auxvars()
    mpp.setup_problem()

    ge = mpp.goveqns[0]
    n = mesh.ncells_local
    lai_inc = 0.1
    Iskyb = np.array([0.8, 0.8])
    Iskyd = np.array([0.2, 0.2])
    Kb = 0.577350269189626
    td = 0.913235689378651
    clumpfac = 1.0

    is_soil = np.zeros(n, bool)
    leaf_rho = np.zeros((n, 2)); leaf_tau = np.zeros((n, 2))
    leaf_omega = np.zeros((n, 2)); leaf_td = np.zeros(n)
    leaf_tb = np.zeros(n); leaf_tbcum = np.zeros(n); leaf_dpai = np.zeros(n)
    leaf_fssh = np.zeros((n, 2))
    soil_ab = np.zeros((n, 2)); soil_ad = np.zeros((n, 2))
    iskyb = np.tile(Iskyb, (n, 1)); iskyd = np.tile(Iskyd, (n, 1))
    for k in range(1, nz_cair + 2):     # 1-based like the reference
        icell = k - 1
        if k == 1:
            is_soil[icell] = True
            soil_ab[icell] = [0.1, 0.2]
            soil_ad[icell] = [0.1, 0.2]
            cumlai = 6.0 - (k - 1) * lai_inc
            leaf_tb[icell] = np.exp(-Kb * lai_inc * clumpfac)
            leaf_tbcum[icell] = np.exp(-Kb * cumlai * clumpfac)
            leaf_td[icell] = td
        else:
            leaf_rho[icell] = [0.10, 0.45]
            leaf_tau[icell] = [0.05, 0.25]
            leaf_omega[icell] = [0.15, 0.70]
            sumlai = 6.0 - (k - 1) * lai_inc + lai_inc / 2.0
            cumlai = 6.0 - (k - 1) * lai_inc
            leaf_dpai[icell] = lai_inc
            leaf_fssh[icell, 0] = clumpfac * np.exp(-Kb * sumlai * clumpfac)
            leaf_fssh[icell, 1] = 1.0 - leaf_fssh[icell, 0]
            leaf_tb[icell] = np.exp(-Kb * lai_inc * clumpfac)
            leaf_tbcum[icell] = (1.0 if k == nz_cair + 1
                                 else np.exp(-Kb * cumlai * clumpfac))
            leaf_td[icell] = td
    f = lambda a: _f64(a, device)
    ge.is_soil = is_soil
    ge.leaf_rho = f(leaf_rho)
    ge.leaf_tau = f(leaf_tau)
    ge.leaf_omega = f(leaf_omega)
    ge.leaf_td = f(leaf_td)
    ge.leaf_tb = f(leaf_tb)
    ge.leaf_tbcum = f(leaf_tbcum)
    ge.leaf_dpai = f(leaf_dpai)
    ge.leaf_fssh = f(leaf_fssh)
    ge.soil_albedo_b = f(soil_ab)
    ge.soil_albedo_d = f(soil_ad)
    ge.Iskyb = f(iskyb)
    ge.Iskyd = f(iskyd)
    ge.bc_Iskyb = f(np.tile(Iskyb, (ncair, 1)))
    ge.bc_Iskyd = f(np.tile(Iskyd, (ncair, 1)))

    if use_compiled:
        from mpp_tpu_torch.batched.ksp_compiled import compile_radiation
        compile_radiation(mpp).install()
    ok, _ = mpp.step_dt(5.0 * 60.0)
    if not ok:
        raise RuntimeError("shortwave KSP solve did not converge")
    return mpp


def output_regression_shortwave(mpp, filename_base, num_cells):
    ge = mpp.goveqns[0]
    w = RegressionWriter(filename_base, num_cells)
    w.write_data("shortwave_up_beam_vis", "general", ge.Iup[:, 0])
    w.write_data("shortwave_up_beam_nir", "general", ge.Iup[:, 1])
    w.write_data("shortwave_dn_diffuse_vis", "general", ge.Idn[:, 0])
    w.write_data("shortwave_dn_diffuse_nir", "general", ge.Idn[:, 1])
    w.close()
    return w.filename


def run_longwave_problem(ncair=1, ntree=1, use_compiled=False,
                         device="cuda"):
    """longwave_problem.F90 + longwave_parameters.F90."""
    device = device_of(device)
    nz_cair = 92
    dz_cair = Z_CAIR / nz_cair
    mpp = LongwaveMPP(device=device)
    mpp.set_name("Longwave radiation model")
    mpp.set_id(MPPType.LONGWAVE_KSP)
    mesh = canopy_mesh(nz_cair, ncair, ntree)
    mpp.add_mesh(mesh)
    ieqn = mpp.add_goveqn("longwave")
    mpp.add_condition_in_goveqn(ieqn, Cond.BC, "Atmospheric forcing", "K",
                                Cond.DIRICHLET,
                                conn_set=_top_bc_conns(nz_cair, ncair,
                                                       dz_cair))
    mpp.allocate_auxvars()
    mpp.setup_problem()

    ge = mpp.goveqns[0]
    n = mesh.ncells_local
    emleaf, emgrnd, Irsky, td = 0.98, 1.00, 400.0, 0.915
    full = lambda shape, v: torch.full(shape, v, dtype=torch.float64,
                                       device=device)
    ge.trans = full((n,), td)
    ge.leaf_rho = full((n,), 1.0 - emleaf)
    ge.leaf_tau = full((n,), 0.0)
    ge.leaf_emiss = full((n,), emleaf)
    is_soil = np.zeros(n, bool)
    is_soil[0] = True
    ge.is_soil = is_soil
    gt = np.zeros(n)
    gt[0] = TFRZ + 20.0
    gem = np.zeros(n)
    gem[0] = emgrnd
    ge.ground_temperature = _f64(gt, device)
    ge.ground_emiss = _f64(gem, device)
    ge.leaf_temperature = full((n, ge.nleaf), TFRZ + 25.0)
    ge.leaf_fssh = full((n, ge.nleaf), 1.0)
    ge.leaf_dpai = full((n, ge.nleaf), 0.1)
    ge.bc_Idn = full((ncair,), Irsky)

    if use_compiled:
        from mpp_tpu_torch.batched.ksp_compiled import compile_radiation
        compile_radiation(mpp).install()
    ok, _ = mpp.step_dt(5.0 * 60.0)
    if not ok:
        raise RuntimeError("longwave KSP solve did not converge")
    return mpp


def output_regression_longwave(mpp, filename_base, num_cells):
    ge = mpp.goveqns[0]
    w = RegressionWriter(filename_base, num_cells)
    w.write_data("longwave_up", "general", ge.Iup)
    w.write_data("longwave_dn", "general", ge.Idn)
    w.write_data("longwave_abs", "general", ge.Iabs)
    w.close()
    return w.filename


def run_leafbndlyr_problem(ncair=1, ntree=1, device="cuda"):
    """leafbndlyr_problem.F90 + lbl_parameters.F90."""
    device = device_of(device)
    nz_cair = 92
    mpp = LBLMPP(device=device)
    mpp.set_name("Leaf boundary layer model")
    mpp.set_id(MPPType.LBL_KSP)
    mesh = canopy_mesh(nz_cair, ncair, ntree)
    mpp.add_mesh(mesh)
    mpp.add_goveqn("leaf boundary layer")
    mpp.allocate_auxvars()
    mpp.setup_problem()

    ge = mpp.goveqns[0]
    n = mesh.ncells_local
    npc = nz_cair + 1
    k_idx = np.tile(np.arange(npc), ncair)
    full = lambda v: torch.full((n,), v, dtype=torch.float64, device=device)
    ge.pref = full(101325.0)
    ge.wind = full(5.0)
    ge.tair = full(273.15 + 25.0)
    ge.tref = full(273.15 + 25.0)
    ge.tleaf = _f64(273.15 + 11.0 + k_idx * 0.25, device)
    ge.dleaf = full(0.05)

    ok, _ = mpp.step_dt(0.0)
    if not ok:
        raise RuntimeError("leaf boundary layer step failed")
    return mpp


def output_regression_leafbndlyr(mpp, filename_base, num_cells):
    ge = mpp.goveqns[0]
    w = RegressionWriter(filename_base, num_cells)
    w.write_data("gbh", "general", ge.gbh)
    w.write_data("gbv", "general", ge.gbv)
    w.write_data("gbc", "general", ge.gbc)
    w.close()
    return w.filename

"""Coupled multi-physics canopy model: the pieces of the 5-MPP
operator-split orchestrator that the batched canopy pipeline reads.

Counterpart of ``mpp_tpu/problems/ml_model.py``, which reimplements ``src/driver/standalone/ml_model/`` — the reference's "full
multi-physics" path (`ml_model_problem.F90:293-419`): shortwave radiation
(hourly), then ``nsubstep`` 300-s substeps of longwave radiation, leaf
boundary layer, photosynthesis, and the multi-layer canopy (MLC) solve,
with explicit data plumbing between the MPPs (absorbed radiation ->
leaf energy balance, boundary-layer + stomatal conductances -> canopy
fluxes, canopy states -> next substep's radiation/photosynthesis).

Also provides the reference's auxiliary subsystems for this path:

* per-phase timers (PetscLogEvent analog; `ml_model_problem.F90:323-336`)
* checkpoint / resume via PETSc-binary-Vec-compatible files
  (`mlc.F90:1006-1092`, `photosynthesis.F90:612-756`,
  `ml_model_problem.F90:233-292`)
* boundary-condition ingestion from the reference's 31-column binary
  dataset (`ml_model_boundary_conditions.F90:185-281`) or a synthetic
  diurnal generator (the reference's ``-bc_file`` dataset is not shipped
  in its tree).

Vertical vegetation structure from `ml_model_utils.F90:59-185`
(beta-distribution plant-area profile), sunlit fractions
`compute_fssh` (ibid:188-210), direct-beam extinction and layer
transmittances from `swv.F90:218-268`.

The port's ``MLModel`` composes the port's MPPs on ``device`` (the card
unless ``device="cpu"``): the shortwave and longwave KSPs and the leaf
boundary layer hold their GE fields as f64 tensors on the device; the
photosynthesis Newton and the MLC assembly run on the host in numpy, as
in the JAX package, with the MLC's KSP solve on the device.  Each stage's
inputs go up as tensors and its outputs come down in one copy;
``host_syncs`` counts those reads with the solvers' own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from mpp_tpu_torch.constants import (Cond, ConnKind, MPPType, TFRZ, MM_H2O,
                                     MM_DRY_AIR, RGAS,
                                     MeshType as MeshKind)
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.dtypes.mesh import Mesh, ConnectionSet
from mpp_tpu_torch.io.petsc_vec import read_vec, write_vec
from mpp_tpu_torch.io.timers import PhaseTimers
from mpp_tpu_torch.models import photosynthesis as ph
from mpp_tpu_torch.models.lbl import LBLMPP
from mpp_tpu_torch.models.mlc import MLCMPP
from mpp_tpu_torch.models.radiation import ShortwaveMPP, LongwaveMPP

# Mesh attributes (ml_model_global_vars.F90:119-127)
DZ_CAIR = 0.5
Z_CAIR = 46.0
NZ_CAIR = 92
HC = 21.0
NVEG = 42
NLEAF = 2

SCMS = {"ball-berry": ph.SCM_BBERRY, "medlyn": ph.SCM_MEDLYN,
        "wue": ph.SCM_WUE, "bonan14": ph.SCM_BONAN14,
        "modified_bonan14": ph.SCM_MODIFIED_BONAN14,
        "manzoni11": ph.SCM_MANZONI11, "osmwang": ph.SCM_OSMWANG}


# ---------------------------------------------------------------------------
# Vertical vegetation structure (ml_model_utils.F90:24-185)
# ---------------------------------------------------------------------------
def _cumulative_area_index(pbeta, qbeta, z_u, z_l, hc):
    """100-sublayer numerical integration of the beta PDF (ibid:24-56)."""
    num_int = 100
    dz_int = (z_u - z_l) / num_int
    acc = 0.0
    bnorm = math.exp(math.lgamma(pbeta) + math.lgamma(qbeta)
                     - math.lgamma(pbeta + qbeta))
    z_int = 0.0
    for i in range(1, num_int + 1):
        z_int = z_l + 0.5 * dz_int if i == 1 else z_int + dz_int
        zrel = min(z_int / hc, 1.0)
        acc += (zrel ** (pbeta - 1.0) * (1.0 - zrel) ** (qbeta - 1.0)) \
            / bnorm * dz_int
    return acc


@dataclasses.dataclass
class VegStructure:
    """1-based profiles (index 0 unused), Fortran-layer indexing k=1..93."""
    nbot: int
    ntop: int
    dlai: np.ndarray
    dsai: np.ndarray
    dpai: np.ndarray
    cumpai: np.ndarray
    sumpai: np.ndarray

    @property
    def nveg_lev(self):
        return self.ntop - self.nbot + 1


def compute_vertical_veg_structure(ntree: int = 1) -> VegStructure:
    """ml_model_utils.F90:59-185."""
    lai_pbeta, lai_qbeta = 3.5, 2.0
    sai_pbeta, sai_qbeta = 3.5, 2.0
    lai = 4.1516127586364746
    sai = 0.89999997615814209

    n = NZ_CAIR * ntree + 1
    dlai = np.zeros(n + 1)
    dsai = np.zeros(n + 1)
    dpai = np.zeros(n + 1)
    cumpai = np.zeros(n + 1)
    sumpai = np.zeros(n + 1)

    nbot = 2
    ntop = NVEG + 1
    for k in range(nbot, ntop + 1):
        zl = DZ_CAIR * (k - 2)
        zu = DZ_CAIR * (k - 1)
        dlai[k] = _cumulative_area_index(lai_pbeta, lai_qbeta, zu, zl, HC) \
            * (lai / HC)
        dsai[k] = _cumulative_area_index(sai_pbeta, sai_qbeta, zu, zl, HC) \
            * (sai / HC)

    lai_sum = dlai[nbot:ntop + 1].sum()
    sai_sum = dsai[nbot:ntop + 1].sum()
    lai_miss = sai_miss = 0.0
    for k in range(nbot, ntop + 1):
        if dlai[k] + dsai[k] < 0.01:
            lai_miss += dlai[k]
            sai_miss += dsai[k]
            dlai[k] = 0.0
            dsai[k] = 0.0
    if lai_miss > 0.0:
        lai_new = lai_sum - lai_miss
        for k in range(nbot, ntop + 1):
            dlai[k] += lai_miss * (dlai[k] / lai_new)
    if sai_miss > 0.0:
        sai_new = sai_sum - sai_miss
        for k in range(nbot, ntop + 1):
            dsai[k] += sai_miss * (dsai[k] / sai_new)

    ic_bot = 0
    for k in range(ntop, nbot - 1, -1):
        if dlai[k] + dsai[k] > 0.0:
            ic_bot = k
    if ic_bot == 0:
        raise RuntimeError("compute_vertical_veg_structure: nbot undefined")
    nbot = ic_bot

    for k in range(ntop, nbot - 1, -1):
        dpai[k] = dlai[k] + dsai[k]
        if k == ntop:
            sumpai[k] = 0.5 * dpai[k]
            cumpai[k] = dpai[k]
        else:
            sumpai[k] = sumpai[k + 1] + 0.5 * (dpai[k + 1] + dpai[k])
            cumpai[k] = cumpai[k + 1] + dpai[k]
    return VegStructure(nbot, ntop, dlai, dsai, dpai, cumpai, sumpai)


def compute_fssh(veg: VegStructure, kb: float) -> np.ndarray:
    """fssh(k)=exp(-Kb*sumpai(k)) for k=nbot..ntop (ibid:188-210)."""
    fssh = np.zeros(veg.sumpai.shape)
    for k in range(veg.ntop, veg.nbot - 1, -1):
        fssh[k] = math.exp(-kb * veg.sumpai[k])
    return fssh


def compute_kb(xl: float, sza: float):
    """Direct-beam extinction coefficient (swv.F90:218-243)."""
    chil = min(max(xl, -0.4), 0.6)
    if abs(chil) <= 0.01:
        chil = 0.01
    phi1 = 0.5 - 0.633 * chil - 0.330 * chil * chil
    phi2 = 0.877 * (1.0 - 2.0 * phi1)
    gdir = phi1 + phi2 * math.cos(sza)
    kb = min(gdir / math.cos(sza), 40.0)
    return phi1, phi2, kb


def compute_transmittance(xl: float, sza: float, dpai: float,
                          clump_fac: float):
    """Layer direct/diffuse transmittance (swv.F90:246-273)."""
    phi1, phi2, kb = compute_kb(xl, sza)
    tb = math.exp(-kb * dpai * clump_fac)
    td = 0.0
    for j in range(1, 10):
        angle = (5.0 + (j - 1) * 10.0) * math.pi / 180.0
        gdirj = phi1 + phi2 * math.cos(angle)
        td += math.exp(-gdirj / math.cos(angle) * dpai * clump_fac) \
            * math.sin(angle) * math.cos(angle)
    td *= 2.0 * (10.0 * math.pi / 180.0)
    return tb, td


# ---------------------------------------------------------------------------
# Boundary conditions (ml_model_boundary_conditions.F90; 31-column rows)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class MLBoundaryConditions:
    """One hourly forcing record (read_boundary_conditions, ibid:185-281)."""
    iskyb_vis: float = 0.8 * 400.0
    iskyb_nir: float = 0.8 * 400.0
    iskyd_vis: float = 0.2 * 100.0
    iskyd_nir: float = 0.2 * 100.0
    irsky: float = 400.0
    tref: float = TFRZ + 25.0
    qref: float = 0.01
    pref: float = 101325.0
    uref: float = 5.0
    co2ref: float = 380.0
    o2ref: float = 209.0
    albsoib_vis: float = 0.1
    albsoib_nir: float = 0.2
    albsoid_vis: float = 0.1
    albsoid_nir: float = 0.2
    tg: float = TFRZ + 20.0
    soil_t: float = TFRZ + 21.0
    sza: float = 0.5
    rhg: float = 0.9984057411945876
    soilres: float = 3361.509423807650
    soil_tk: float = 1.261326601469150
    h2osoi_vol: np.ndarray = dataclasses.field(
        default_factory=lambda: np.full(10, 0.2))
    pref_prev: float = 101325.0


def bc_from_vec_row(data: np.ndarray, istep: int,
                    prev: Optional[MLBoundaryConditions]) \
        -> MLBoundaryConditions:
    """Decode row ``istep`` (1-based) of the reference's 31-column BC Vec
    (ml_model_boundary_conditions.F90:204-281)."""
    ncol = 31
    off = (istep - 1) * ncol
    if istep * ncol > data.size:
        raise ValueError("Time step exceeds the boundary condition dataset")
    row = data[off:off + ncol]
    bc = MLBoundaryConditions(
        iskyb_vis=row[0], iskyb_nir=row[1], iskyd_vis=row[2],
        iskyd_nir=row[3], irsky=row[4], tref=row[5], qref=row[6],
        pref=row[7], uref=row[8], co2ref=row[9], o2ref=row[10],
        albsoib_vis=row[11], albsoib_nir=row[12], albsoid_vis=row[13],
        albsoid_nir=row[14], tg=row[15], soil_t=row[16], sza=row[17],
        rhg=row[18], soilres=row[19], soil_tk=row[20],
        h2osoi_vol=row[21:31].copy())
    if istep == 1:
        bc.pref_prev = bc.pref
    else:
        bc.pref_prev = data[(istep - 2) * ncol + 7]
    if prev is not None and istep > 1:
        bc.tg = prev.tg          # tg only read at istep 1 (ibid:236-238)
    return bc


def synthetic_diurnal_bc(istep: int,
                         prev: Optional[MLBoundaryConditions] = None) \
        -> MLBoundaryConditions:
    """Physically plausible diurnal forcing for running without the
    (unshipped) reference BC dataset: solar elevation follows a sine over
    a 24-h day, air temperature lags it."""
    hour = (istep - 1) % 24
    elev = math.sin(math.pi * max(0.0, min((hour - 6.0) / 12.0, 1.0)))
    sza = math.acos(max(elev, 0.05))
    sw = 800.0 * elev
    bc = MLBoundaryConditions(
        iskyb_vis=0.40 * sw, iskyb_nir=0.40 * sw,
        iskyd_vis=0.10 * sw, iskyd_nir=0.10 * sw,
        irsky=320.0 + 60.0 * elev,
        tref=TFRZ + 18.0 + 8.0 * math.sin(math.pi * (hour - 8.0) / 12.0),
        qref=0.009, pref=101325.0, uref=5.0, sza=sza,
        tg=prev.tg if prev is not None else TFRZ + 18.0,
        soil_t=TFRZ + 17.0)
    bc.pref_prev = prev.pref if prev is not None else bc.pref
    return bc


# ---------------------------------------------------------------------------
# Meshes (ml_model_meshes.F90:87-333)
# ---------------------------------------------------------------------------
def _column_mesh(name, nz, ncol, zc_fn):
    ncells = ncol * nz
    zc = np.zeros(ncells)
    icell = 0
    for _ in range(ncol):
        for k in range(1, nz + 1):
            zc[icell] = zc_fn(k, zc[icell - 1] if icell else 0.0)
            icell += 1
    mesh = Mesh(name=name, itype=0,
                orientation=int(MeshKind.AGAINST_GRAVITY),
                ncells_local=ncells, nlev=nz,
                xc=np.zeros(ncells), yc=np.zeros(ncells), zc=zc,
                dx=np.ones(ncells), dy=np.ones(ncells),
                dz=np.full(ncells, DZ_CAIR), area_xy=np.ones(ncells),
                is_active=np.ones(ncells, bool))
    iu, idn = [], []
    for icol in range(ncol):
        base = icol * nz
        for k in range(nz - 1):
            iu.append(base + k)
            idn.append(base + k + 1)
    m = len(iu)
    mesh.intrn_conn_sets = [ConnectionSet(
        id_up=np.array(iu, np.int32), id_dn=np.array(idn, np.int32),
        dist_up=np.full(m, DZ_CAIR / 2), dist_dn=np.full(m, DZ_CAIR / 2),
        area=np.ones(m), itype=np.full(m, int(ConnKind.VERTICAL), np.int32))]
    mesh.compute_volume()
    return mesh


def create_canopy_and_soil_mesh(veg: VegStructure, ncol: int) -> Mesh:
    nz = veg.nveg_lev + 1

    def zc(k, prev):
        return 0.0 if k == 1 else (veg.nbot + k - 2) * DZ_CAIR + DZ_CAIR / 2
    return _column_mesh("Canopy with soil layer", nz, ncol, zc)


def create_canopy_mesh_for_leaf(veg: VegStructure, ncol: int) -> Mesh:
    nz = veg.nveg_lev * NLEAF

    def zc(k, prev):
        kk = (k - 1) % veg.nveg_lev + 1
        return (veg.nbot + kk - 1) * DZ_CAIR + DZ_CAIR / 2
    return _column_mesh("Canopy for leaves", nz, ncol, zc)


def _top_bc_conns(nz, ncol):
    id_dn = np.array([(icol + 1) * nz - 1 for icol in range(ncol)], np.int32)
    m = ncol
    uv = np.zeros((m, 3))
    uv[:, 0] = -1.0
    return ConnectionSet(id_up=np.full(m, -1, np.int32), id_dn=id_dn,
                         dist_up=np.zeros(m), dist_dn=np.full(m, DZ_CAIR),
                         area=np.ones(m),
                         itype=np.full(m, int(ConnKind.VERTICAL), np.int32),
                         unit_vec=uv)


# ---------------------------------------------------------------------------
# The orchestrator
# ---------------------------------------------------------------------------
class MLModel:
    """5-MPP coupled canopy model (run_ml_model_problem semantics) on
    ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, ncair: int = 1, ntree: int = 1,
                 stomatal_conductance_model: str = "medlyn",
                 pathway: str = "c3", device="cuda"):
        self.device = device_of(device)
        if ncair != 1 or ntree != 1:
            raise NotImplementedError(
                "reference ml_model supports a single canopy column "
                "(ntree>1 paths carry 'Need to extend' warnings, "
                "mlc.F90:578-580)")
        self.ncair, self.ntree = ncair, ntree
        self.gstype = SCMS[stomatal_conductance_model]
        self.c3psn = (ph.PATHWAY_C3 if pathway == "c3" else ph.PATHWAY_C4)
        self.veg = compute_vertical_veg_structure(ntree)
        self.nbot, self.ntop = self.veg.nbot, self.veg.ntop
        self.nzl = self.veg.nveg_lev            # vegetated levels (42)
        self.fssh = np.zeros(self.veg.sumpai.shape)
        self.leaf_td = np.zeros(self.veg.sumpai.shape)
        self.timers = PhaseTimers(self.device)
        self._downloads = 0

        nzl = self.nzl
        # internal conditions (internal_condition_type)
        self.ileaf_sun_vis = np.zeros(nzl)
        self.ileaf_shd_vis = np.zeros(nzl)
        self.ileaf_sun_nir = np.zeros(nzl)
        self.ileaf_shd_nir = np.zeros(nzl)
        self.isoil_vis = 0.0
        self.isoil_nir = 0.0
        self.labs_leaf_sun = np.zeros(nzl)
        self.labs_leaf_shd = np.zeros(nzl)
        self.labs_soil = 0.0
        self.gbh = np.zeros(2 * nzl)     # [sun block, shd block]
        self.gbv = np.zeros(2 * nzl)
        self.gbc = np.zeros(2 * nzl)
        self.gs_sun = np.zeros(nzl)
        self.gs_shd = np.zeros(nzl)
        self.tleaf_sun = np.zeros(nzl)
        self.tleaf_shd = np.zeros(nzl)
        self.tair = np.zeros(NZ_CAIR)
        self.qair = np.zeros(NZ_CAIR)
        self.wind = np.zeros(NZ_CAIR)
        self.tg = 0.0
        # accumulators (canopy_level_accumulator / vertical_level_accumulator)
        self.accum: Dict[str, np.ndarray] = {
            name: np.zeros(nzl) for name in
            ("labs_leaf_sun", "labs_leaf_shd", "rn_leaf_sun", "rn_leaf_shd",
             "sh_leaf_sun", "sh_leaf_shd", "lh_leaf_sun", "lh_leaf_shd",
             "tr_leaf_sun", "tr_leaf_shd", "gs_leaf_sun", "gs_leaf_shd",
             "anet_leaf_sun", "anet_leaf_shd",
             "agross_leaf_sun", "agross_leaf_shd")}
        self.accum.update({name: np.zeros(1) for name in
                           ("labs_soi", "rnabs_soi", "gac0_soi")})

        self.bc: Optional[MLBoundaryConditions] = None
        self._init_mpps()

    # -- host <-> device staging
    def _t(self, a):
        """A numpy array (or number) as an f64 tensor on the device."""
        return torch.as_tensor(np.asarray(a, np.float64), device=self.device)

    def _full(self, n, value):
        return torch.full((n,), float(value), dtype=torch.float64,
                          device=self.device)

    def _host(self, *tensors):
        """The tensors as numpy f64 arrays, read in one device->host copy
        (one counted sync)."""
        flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
        flat = flat.cpu().numpy()
        self._downloads += 1
        out, off = [], 0
        for t in tensors:
            out.append(flat[off:off + t.numel()].reshape(tuple(t.shape)))
            off += t.numel()
        return out

    @property
    def host_syncs(self) -> int:
        """Host reads of device values so far: the stages' downloads, the
        radiation and MLC GMRES predicates and solution downloads, and
        the phase timers' end-of-phase synchronisations."""
        return (self._downloads + self.swv.host_syncs + self.lwv.host_syncs
                + self.mlc.host_syncs + self.timers.host_syncs)

    # -- accumulate_data (ml_model_utils.F90:262-285): running mean over
    #    the substep loop, finalized at isubstep == nsubstep
    def _accumulate(self, name, values, isubstep, nsubstep):
        arr = self.accum[name]
        v = np.asarray(values, np.float64).reshape(arr.shape)
        if isubstep == 1:
            arr[:] = v
        else:
            arr[:] = arr + v
            if isubstep == nsubstep:
                arr[:] = arr / nsubstep

    # ------------------------------------------------------------------
    def _init_mpps(self):
        veg, ncol = self.veg, self.ncair * self.ntree
        nzc = veg.nveg_lev + 1

        # shortwave (swv.F90:23-131, 370-408)
        swv = ShortwaveMPP(device=self.device)
        swv.set_name("Shortwave radiation model")
        swv.set_id(MPPType.SHORTWAVE_KSP)
        swv.add_mesh(create_canopy_and_soil_mesh(veg, ncol))
        ieqn = swv.add_goveqn("Shortwave radiation model")
        swv.add_condition_in_goveqn(ieqn, Cond.BC, "Atmospheric forcing",
                                    "K", Cond.DIRICHLET,
                                    conn_set=_top_bc_conns(nzc, ncol))
        swv.allocate_auxvars()
        swv.setup_problem()
        ge = swv.goveqns[0]
        # set_parameters (swv.F90:128-216): leaf-area-weighted rho/tau
        rho_l = np.array([0.10, 0.45])
        rho_s = np.array([0.16, 0.39])
        tau_l = np.array([0.05, 0.25])
        tau_s = np.array([1.0e-3, 1.0e-3])
        n = ge.mesh.ncells_local
        leaf_rho = np.zeros((n, 2))
        leaf_tau = np.zeros((n, 2))
        leaf_dpai = np.zeros(n)
        is_soil = np.zeros(n, bool)
        for k in range(1, nzc + 1):
            icell = k - 1
            if k == 1:
                is_soil[icell] = True
            else:
                idx = veg.nbot + k - 2
                wl = veg.dlai[idx] / veg.dpai[idx]
                ws = veg.dsai[idx] / veg.dpai[idx]
                leaf_rho[icell] = np.maximum(rho_l * wl + rho_s * ws, 1e-6)
                leaf_tau[icell] = np.maximum(tau_l * wl + tau_s * ws, 1e-6)
                leaf_dpai[icell] = veg.dpai[idx]
        ge.is_soil = is_soil
        ge.leaf_rho = self._t(leaf_rho)
        ge.leaf_tau = self._t(leaf_tau)
        ge.leaf_omega = self._t(leaf_rho + leaf_tau)
        ge.leaf_dpai = self._t(leaf_dpai)
        self.swv = swv

        # longwave (lwv.F90:22-187, 292-330)
        lwv = LongwaveMPP(device=self.device)
        lwv.set_name("Longwave radiation model")
        lwv.set_id(MPPType.LONGWAVE_KSP)
        lwv.add_mesh(create_canopy_and_soil_mesh(veg, ncol))
        ieqn = lwv.add_goveqn("Longwave radiation model")
        lwv.goveqns[0].nleaf = NLEAF
        lwv.add_condition_in_goveqn(ieqn, Cond.BC, "Atmospheric forcing",
                                    "K", Cond.DIRICHLET,
                                    conn_set=_top_bc_conns(nzc, ncol))
        lwv.allocate_auxvars()
        lwv.setup_problem()
        ge = lwv.goveqns[0]
        emleaf, emgrnd = 0.98, 0.96
        ge.trans = self._full(n, 0.915)
        ge.leaf_rho = self._full(n, 1.0 - emleaf)
        ge.leaf_tau = self._full(n, 0.0)
        ge.leaf_emiss = self._full(n, emleaf)
        ge.is_soil = is_soil.copy()
        gem = np.zeros(n)
        gem[0] = emgrnd
        ge.ground_emiss = self._t(gem)
        dpai2 = np.zeros((n, NLEAF))
        dpai2[:, 0] = leaf_dpai
        dpai2[:, 1] = leaf_dpai
        ge.leaf_dpai = self._t(dpai2)
        self._lw_dpai = dpai2[:, 0].copy()     # its host copy
        self.lwv = lwv

        # leaf boundary layer (lbl.F90:21-232)
        lbl = LBLMPP(device=self.device)
        lbl.set_name("Leaf boundary layer model")
        lbl.set_id(MPPType.LBL_KSP)
        lbl.add_mesh(create_canopy_mesh_for_leaf(veg, ncol))
        lbl.add_goveqn("LBL equation")
        lbl.allocate_auxvars()
        lbl.setup_problem()
        lbl.goveqns[0].dleaf = self._full(2 * self.nzl * ncol, 0.04)
        self.lbl = lbl

        # photosynthesis (photosynthesis.F90:36-231, 399-431)
        psy = ph.PhotosynthesisMPP()
        psy.set_name("Photosynthesis model")
        psy.set_id(MPPType.PHOTOSYNTHESIS_SNES)
        psy.set_num_meshes(1)
        psy.add_mesh(create_canopy_mesh_for_leaf(veg, ncol))
        psy.add_goveqn()
        if self.gstype in (ph.SCM_BONAN14, ph.SCM_MODIFIED_BONAN14):
            psy.set_dofs_for_goveqn(1, 2)
        psy.allocate_auxvars(self.c3psn, self.gstype)
        psy.setup_problem()
        self._psy_set_parameters(psy)
        self.psy = psy

        # MLC (mlc.F90:26-196; mlc_parameters.F90)
        mlc = MLCMPP(ncair=self.ncair, ntree=self.ntree, nz_cair=NZ_CAIR,
                     z_cair=Z_CAIR, device=self.device)
        nlev = mlc.nlev
        for icair in range(self.ncair):
            for k in range(1, nlev + 1):
                icell = icair * nlev + (k - 1)
                for pre_dpai, pre_fwet, pre_fdry in (
                        (mlc.at_leaf_dpai, mlc.at_leaf_fwet,
                         mlc.at_leaf_fdry),
                        (mlc.av_leaf_dpai, mlc.av_leaf_fwet,
                         mlc.av_leaf_fdry)):
                    pre_dpai[icell, :] = veg.dpai[k]
                    pre_fwet[icell, :] = 0.0
                    pre_fdry[icell, :] = 0.8218390792391702
            mlc.at_is_soil[icair * nlev] = True
            mlc.av_is_soil[icair * nlev] = True
        for ge_l in mlc.leaf:
            for icair in range(self.ncair):
                for k in range(1, nlev + 1):
                    icell = icair * nlev + (k - 1)
                    ge_l["cp"][icell] = 744.5333333333334
                    ge_l["fwet"][icell] = 0.0
                    ge_l["fdry"][icell] = 0.8218390792391702
                    ge_l["dpai"][icell] = veg.dpai[k]
        ct = mlc.cturb
        for p in range(self.ncair):
            ct.pai[p] = 5.051612734794617
            ct.hc[p] = HC
            ct.zref[p] = Z_CAIR
            ct.soil_tk[p] = 1.261326601469150
            ct.soil_dz[p] = 7.1006354171935350e-3
        self.mlc = mlc

    def _psy_set_parameters(self, psy):
        """photosynthesis.F90:105-231 (set_parameters + set_soil_parameters)."""
        av = psy.soe.ge.avars
        veg = self.veg
        nzl = self.nzl
        av.colim = 1
        av.cair[:] = 380.0
        av.o2ref[:] = 209.0
        av.apar[:] = 2000.0 * (1.0 - 0.1 - 0.1)
        av.btran[:] = 1.0
        av.dpai[:] = 1.0
        av.fwet[:] = 0.0
        av.fdry[:] = 0.8218390792391702
        av.root_biomass[:] = 500.0
        av.root_radius[:] = 0.29e-3
        av.root_density[:] = 0.31e6
        av.root_resist[:] = 25.0
        # soil (ibid:233-295): texture 1, 10 levels, beta 0.966
        theta_sat, psi_sat, b, k_sat = 0.395, -121.0, 4.05, 1.056
        av.set_soil(10)
        dz = np.array([1.7512817916255204e-2, 2.7578969259676251e-2,
                       4.5470033242413201e-2, 7.4967410986208557e-2,
                       0.12360036510228053, 0.20378255101043175,
                       0.33598062644843263, 0.55393840536868488,
                       0.91329003158906108, 1.5057607013992766])
        zi = np.array([0.0, 1.7512817916255204e-2, 4.5091787175931458e-2,
                       9.0561820418344652e-2, 0.16552923140455322,
                       0.28912959650683373, 0.49291214751726548,
                       0.82889277396569816, 1.3828311793343830,
                       2.2961212109234443, 3.8018819123227208])
        beta = 0.966
        av.soil_dz[:] = dz
        av.soil_rootfr[:] = beta ** (zi[:-1] * 100.0) - beta ** (zi[1:] * 100.0)
        av.soil_watsat[:] = theta_sat
        av.soil_hksat[:] = k_sat * 10.0 / 60.0
        av.soil_bsw[:] = b
        av.soil_h2osoi_vol[:] = 0.5 * theta_sat
        av.soil_psi_sat[:] = psi_sat
        av.soil_psi[:] = psi_sat * 0.5 ** (-b)
        # plant (ibid:176-186); leaf_height varies with the level index
        k_in_block = np.tile(np.arange(1, nzl + 1),
                             self.ncair * self.ntree * NLEAF)
        av.leaf_psi[:] = -2.4
        av.leaf_height[:] = (k_in_block - 1) * 0.5 + 2.75
        av.leaf_capc[:] = 2500.0
        av.leaf_minlwp[:] = -1.2
        av.leaf_lai[:] = 4.1516127586364746
        av.k_stem2leaf[:] = 4.0
        av.set_default_parameters()
        if self.gstype == ph.SCM_MEDLYN:
            av.g0opt[:], av.g1opt[:] = 1.0e-4, 4.0
        elif self.gstype == ph.SCM_BBERRY:
            av.g0opt[:], av.g1opt[:] = 0.027, 9.0
        elif self.gstype == ph.SCM_WUE:
            av.iota[:] = 820.0
            av.leaf_minlwp[:] = -2.5
        elif self.gstype in (ph.SCM_BONAN14, ph.SCM_MODIFIED_BONAN14):
            av.iota[:] = 820.0
            av.leaf_minlwp[:] = -2.5
        elif self.gstype == ph.SCM_MANZONI11:
            av.leaf_minlwp[:] = -2.5
            av.manzoni11_beta[:] = -0.001
            av.iota[:] = 820.0

    # ------------------------------------------------------------------
    # Initial conditions (ml_model_problem.F90:183-231; mlc.F90:199-308)
    # ------------------------------------------------------------------
    def set_initial_conditions(self, bc: MLBoundaryConditions):
        self.bc = bc
        factor = 1.0 / (MM_H2O / MM_DRY_AIR
                        + (1.0 - MM_H2O / MM_DRY_AIR) * bc.qref)
        self.tleaf_sun[:] = bc.tref
        self.tleaf_shd[:] = bc.tref
        self.tair[:] = bc.tref
        self.wind[:] = bc.uref
        self.qair[:] = bc.qref * factor
        self.tg = bc.tg

        mlc, ct = self.mlc, self.mlc.cturb
        for icair in range(self.ncair):
            ct.pref[icair] = bc.pref
            ct.uref[icair] = bc.uref
            ct.tref[icair] = bc.tref
            ct.rhref[icair] = 80.0
            ct.wind[icair, :] = bc.uref
            ct.qref[icair] = bc.qref
            ct.qcan[icair] = bc.qref
            ct.compute_derived_atm_inputs(icair)
            ct.tcan[icair] = ct.tref[icair]
        o = mlc.off
        mlc.soln[o[0]:o[0] + mlc.Na] = bc.tref
        mlc.soln[o[1]:o[1] + mlc.Na] = bc.qref * factor
        mlc.soln[o[2]:o[2] + mlc.Nl] = bc.tref
        mlc.soln[o[3]:o[3] + mlc.Nl] = bc.tref
        mlc.soln_prev[:] = mlc.soln
        mlc.pre_solve()

    def initialize_from_checkpoint(self, mlc_ic_file: str,
                                   psy_ic_file: str,
                                   bc: MLBoundaryConditions):
        """ml_model_problem.F90:233-292 + mlc.F90:311-445 +
        photosynthesis.F90:669-726."""
        self.bc = bc
        ic = read_vec(mlc_ic_file)
        nl = NZ_CAIR + 1
        wind_col = ic[0 * nl:1 * nl]
        tair_col = ic[1 * nl:2 * nl]
        qair_col = ic[2 * nl:3 * nl]
        tsun_col = ic[3 * nl:4 * nl]
        tshd_col = ic[4 * nl:5 * nl]
        # int_cond staging (ml_model_problem.F90:263-284): level k=2..nl
        for k in range(2, nl + 1):
            self.wind[k - 2] = wind_col[k - 1]
            self.tair[k - 2] = tair_col[k - 1]
            self.qair[k - 2] = qair_col[k - 1]
            if self.nbot <= k <= self.ntop:
                i = k - self.nbot
                self.tleaf_sun[i] = tsun_col[k - 1]
                self.tleaf_shd[i] = tshd_col[k - 1]

        mlc, ct = self.mlc, self.mlc.cturb
        for icair in range(self.ncair):
            ct.pref[icair] = bc.pref
            ct.uref[icair] = bc.uref
            ct.tref[icair] = bc.tref
            ct.rhref[icair] = 80.0
            ct.wind[icair, :] = wind_col
            ct.qref[icair] = bc.qref
            # qcan/tcan seeded from the canopy-top level of the checkpoint
            # (mlc.F90:373-381, literal int_cond indices ntop)
            ct.qcan[icair] = self.qair[self.ntop - 1]
            ct.compute_derived_atm_inputs(icair)
            ct.tcan[icair] = self.tair[self.ntop - 1]
        o = mlc.off
        mlc.soln[o[0]:o[0] + mlc.Na] = tair_col
        mlc.soln[o[1]:o[1] + mlc.Na] = qair_col
        mlc.soln[o[2]:o[2] + mlc.Nl] = tsun_col
        mlc.soln[o[3]:o[3] + mlc.Nl] = tshd_col
        mlc.soln_prev[:] = mlc.soln
        self.tg = tair_col[0]
        mlc.pre_solve()

        av = self.psy.soe.ge.avars
        pic = read_vec(psy_ic_file).reshape(-1, 3)
        av.leaf_psi[:] = pic[:, 0]
        av.tleaf_prev[:] = pic[:, 1]
        av.gleaf_w_soln[:] = pic[:, 2]
        self._use_ic = True

    # ------------------------------------------------------------------
    # Per-MPP solves (swv/lwv/lbl/photosynthesis/mlc .F90 solve_* +
    # set_boundary_conditions + extract_data_from_*)
    # ------------------------------------------------------------------
    def solve_swv(self, istep, dt):
        bc, veg, ge = self.bc, self.veg, self.swv.goveqns[0]
        nzc = veg.nveg_lev + 1
        n = ge.mesh.ncells_local
        xl, clump_fac = 0.25, 1.0
        _, _, kb = compute_kb(xl, bc.sza)
        self.fssh = compute_fssh(veg, kb)

        iskyb = np.tile([bc.iskyb_vis, bc.iskyb_nir], (n, 1))
        iskyd = np.tile([bc.iskyd_vis, bc.iskyd_nir], (n, 1))
        leaf_tb = np.zeros(n)
        leaf_td = np.zeros(n)
        leaf_tbcum = np.zeros(n)
        leaf_fssh = np.zeros((n, 2))
        soil_ab = np.zeros((n, 2))
        soil_ad = np.zeros((n, 2))
        for k in range(1, nzc + 1):
            icell = k - 1
            if k == 1:
                leaf_tbcum[icell] = math.exp(-kb * veg.cumpai[veg.nbot]
                                             * clump_fac)
                soil_ab[icell] = [bc.albsoib_vis, bc.albsoib_nir]
                soil_ad[icell] = [bc.albsoid_vis, bc.albsoid_nir]
            else:
                kk = veg.nbot + k - 2
                tb, td = compute_transmittance(xl, bc.sza, veg.dpai[kk],
                                               clump_fac)
                leaf_tb[icell] = tb
                leaf_td[icell] = td
                self.leaf_td[kk] = td
                # cumulative PAI above layer kk; zero above the top layer.
                # (The reference's `cumpai = 0.d0` at k==ntop zeroes the
                # whole profile array for later steps — swv.F90:345-349 —
                # a destructive quirk we do not reproduce.)
                cum = 0.0 if kk == veg.ntop else veg.cumpai[kk + 1]
                leaf_tbcum[icell] = math.exp(-kb * cum * clump_fac)
                leaf_fssh[icell, 0] = self.fssh[kk]
                leaf_fssh[icell, 1] = 1.0 - self.fssh[kk]
        ge.Iskyb = self._t(iskyb)
        ge.Iskyd = self._t(iskyd)
        ge.leaf_tb = self._t(leaf_tb)
        ge.leaf_td = self._t(leaf_td)
        ge.leaf_tbcum = self._t(leaf_tbcum)
        ge.leaf_fssh = self._t(leaf_fssh)
        ge.soil_albedo_b = self._t(soil_ab)
        ge.soil_albedo_d = self._t(soil_ad)
        ge.bc_Iskyb = self._t(np.tile([bc.iskyb_vis, bc.iskyb_nir],
                                      (self.ncair, 1)))
        ge.bc_Iskyd = self._t(np.tile([bc.iskyd_vis, bc.iskyd_nir],
                                      (self.ncair, 1)))

        ok, _ = self.swv.step_dt(dt, istep)
        if not ok:
            raise RuntimeError("Shortwave model did not converge")
        # extract (swv.F90:433-547): Iabs_leaf [sun_vis, shd_vis, sun_nir,
        # shd_nir] per cell
        iabs, isoil = self._host(ge.Iabs_leaf, ge.Iabs_soil)
        self.ileaf_sun_vis[:] = iabs[1:nzc, 0]
        self.ileaf_shd_vis[:] = iabs[1:nzc, 1]
        self.ileaf_sun_nir[:] = iabs[1:nzc, 2]
        self.ileaf_shd_nir[:] = iabs[1:nzc, 3]
        self.isoil_vis = float(isoil[0, 0])
        self.isoil_nir = float(isoil[0, 1])

    def solve_lwv(self, istep, isubstep, dt, nsubstep):
        bc, veg, ge = self.bc, self.veg, self.lwv.goveqns[0]
        nzc = veg.nveg_lev + 1
        n = ge.mesh.ncells_local
        gt = np.zeros(n)
        gt[0] = self.tg
        trans = np.full(n, 0.915)
        ltemp = np.zeros((n, 2))
        lfssh = np.zeros((n, 2))
        for k in range(2, nzc + 1):
            kk = veg.nbot + k - 2
            icell = k - 1
            trans[icell] = self.leaf_td[kk]
            ltemp[icell, 0] = self.tleaf_sun[k - 2]
            ltemp[icell, 1] = self.tleaf_shd[k - 2]
            lfssh[icell, 0] = self.fssh[kk]
            lfssh[icell, 1] = 1.0 - self.fssh[kk]
        ge.ground_temperature = self._t(gt)
        ge.trans = self._t(trans)
        ge.leaf_temperature = self._t(ltemp)
        ge.leaf_fssh = self._t(lfssh)
        ge.bc_Idn = self._full(self.ncair, bc.irsky)

        ok, _ = self.lwv.step_dt(dt, istep)
        if not ok:
            raise RuntimeError("Longwave model did not converge")
        # extract (lwv.F90:333-427): per-LAI leaf absorption, soil absorption
        iabs, = self._host(ge.Iabs)
        dpai_mesh = self._lw_dpai
        labs = np.where(dpai_mesh[1:nzc] > 0.0,
                        iabs[1:nzc] / np.where(dpai_mesh[1:nzc] == 0.0, 1.0,
                                               dpai_mesh[1:nzc]), 0.0)
        self.labs_leaf_sun[:] = labs
        self.labs_leaf_shd[:] = labs
        self.labs_soil = float(iabs[0])
        self._accumulate("labs_leaf_sun", labs, isubstep, nsubstep)
        self._accumulate("labs_leaf_shd", labs, isubstep, nsubstep)
        self._accumulate("labs_soi", self.labs_soil, isubstep, nsubstep)

    def solve_lbl(self, istep, isubstep, dt):
        bc, ge = self.bc, self.lbl.goveqns[0]
        nzl = self.nzl
        tleaf = np.concatenate([self.tleaf_sun, self.tleaf_shd])
        # air state at the vegetated levels (lbl.F90:181-205): Tair index
        # k-1 (0-based) for air-mesh level k = nbot..ntop
        sel = slice(self.nbot - 2, self.ntop - 1)
        tair = np.tile(self.tair[sel], 2)
        wind = np.tile(self.wind[sel], 2)
        ge.tleaf = self._t(tleaf)
        ge.tair = self._t(tair)
        ge.wind = self._t(wind)
        ge.pref = self._full(2 * nzl, bc.pref)
        ge.tref = self._full(2 * nzl, bc.tref)

        ok, _ = self.lbl.step_dt(dt, istep)
        if not ok:
            raise RuntimeError("LBL model did not converge")
        self.gbh[:], self.gbv[:], self.gbc[:] = self._host(ge.gbh, ge.gbv,
                                                           ge.gbc)

    def solve_photosynthesis(self, istep, isubstep, is_first_substep, dt,
                             nsubstep):
        bc, av = self.bc, self.psy.soe.ge.avars
        nzl = self.nzl
        # set_initial_conditions — re-seeded before EVERY substep
        # (photosynthesis.F90:740-742, 434-524)
        if self.gstype in (ph.SCM_WUE, ph.SCM_MANZONI11, ph.SCM_OSMWANG):
            self.psy.soe.soln[:] = 0.005
        elif self.gstype in (ph.SCM_BONAN14, ph.SCM_MODIFIED_BONAN14):
            self.psy.soe.soln[:] = 0.002
        else:
            self.psy.soe.soln[:] = 0.9 * bc.co2ref
        # boundary conditions (ibid:263-397)
        tleaf_local = np.concatenate([self.tleaf_sun, self.tleaf_shd])
        pref_value = bc.pref_prev if isubstep == 1 else bc.pref
        qair_lev = self.qair[self.nbot - 2:self.ntop - 1]
        if not is_first_substep:
            av.tleaf_prev[:] = av.tleaf
        av.tleaf[:] = tleaf_local
        av.apar[:nzl] = self.ileaf_sun_vis * 4.6
        av.apar[nzl:] = self.ileaf_shd_vis * 4.6
        av.gbv[:] = self.gbv
        av.gbc[:] = self.gbc
        av.cair[:] = bc.co2ref
        av.o2ref[:] = bc.o2ref
        av.pref[:] = pref_value
        av.eair[:] = np.tile(qair_lev, 2) * pref_value
        av.ci[:] = bc.co2ref
        use_ic = getattr(self, "_use_ic", False)
        if use_ic or not is_first_substep:
            av.pre_solve()
        av.soil_h2osoi_vol[:] = bc.h2osoi_vol
        av.determine_if_solution_is_bounded()

        converged, reason = self.psy.soe.step_dt(dt, (istep - 1) * 12
                                                 + isubstep)
        if not converged:
            raise RuntimeError(f"Photosynthesis model did not converge "
                               f"(reason {reason})")
        # extract (ibid:530-610)
        gs = av.gs[:, 0]
        ag = av.ag[:, 0]
        an = av.an[:, 0]
        self.gs_sun[:] = gs[:nzl]
        self.gs_shd[:] = gs[nzl:]
        self._accumulate("gs_leaf_sun", gs[:nzl], isubstep, nsubstep)
        self._accumulate("gs_leaf_shd", gs[nzl:], isubstep, nsubstep)
        self._accumulate("agross_leaf_sun", ag[:nzl], isubstep, nsubstep)
        self._accumulate("agross_leaf_shd", ag[nzl:], isubstep, nsubstep)
        self._accumulate("anet_leaf_sun", an[:nzl], isubstep, nsubstep)
        self._accumulate("anet_leaf_shd", an[nzl:], isubstep, nsubstep)

    def solve_mlc(self, istep, isubstep, dt, nsubstep):
        bc, mlc, ct = self.bc, self.mlc, self.mlc.cturb
        nlev = mlc.nlev
        # canopy-top state read back before staging (mlc.F90:447-506)
        tcan_value = float(mlc.at_T[self.ntop - 1])
        qcan_value = float(mlc.av_q[self.ntop - 1])
        for icair in range(self.ncair):
            ct.pref[icair] = bc.pref
            ct.uref[icair] = bc.uref
            ct.tref[icair] = bc.tref
            ct.qref[icair] = bc.qref
            ct.compute_derived_atm_inputs(icair)
            if istep == 1 and isubstep == 1 \
                    and not getattr(self, "_use_ic", False):
                ct.qcan[icair] = bc.qref
                ct.tcan[icair] = ct.tref[icair]
            else:
                eair = qcan_value * ct.pref[icair]
                factor = (MM_H2O / MM_DRY_AIR) / (
                    ct.pref[icair] - (1.0 - MM_H2O / MM_DRY_AIR) * eair)
                ct.qcan[icair] = eair * factor
                ct.tcan[icair] = tcan_value
            ct.soil_temperature[icair] = bc.soil_t
            ct.soil_rn[icair] = self.isoil_vis + self.isoil_nir \
                + self.labs_soil
            ct.soil_rhg[icair] = bc.rhg
            ct.soil_res[icair] = bc.soilres
            ct.soil_tk[icair] = bc.soil_tk
            self._accumulate("rnabs_soi", ct.soil_rn[icair], isubstep,
                             nsubstep)
            rhomol = ct.pref[icair] / (RGAS * ct.tref[icair])
            self._accumulate("gac0_soi", rhomol / ct.soil_res[icair],
                             isubstep, nsubstep)

        # air temp / vapor GE staging (mlc.F90:509-660)
        for icair in range(self.ncair):
            gb_count = 0
            for k in range(1, nlev + 1):
                if self.nbot <= k <= self.ntop:
                    icell = icair * nlev + (k - 1)
                    i = gb_count
                    gb_count += 1
                    mlc.at_gbh[icell, 0] = self.gbh[i]
                    mlc.at_gbh[icell, 1] = self.gbh[i + self.nzl]
                    mlc.av_gbv[icell, 0] = self.gbv[i]
                    mlc.av_gbv[icell, 1] = self.gbv[i + self.nzl]
                    for pre_gs, pre_fssh in ((mlc.at_leaf_gs,
                                              mlc.at_leaf_fssh),
                                             (mlc.av_leaf_gs,
                                              mlc.av_leaf_fssh)):
                        pre_gs[icell, 0] = self.gs_sun[i]
                        pre_gs[icell, 1] = self.gs_shd[i]
                        pre_fssh[icell, 0] = self.fssh[k]
                        pre_fssh[icell, 1] = 1.0 - self.fssh[k]
        # leaf GE staging (mlc.F90:663-755)
        for r, ge_l in enumerate(mlc.leaf):
            for icair in range(self.ncair):
                count = 0
                for k in range(1, nlev + 1):
                    if self.nbot <= k <= self.ntop:
                        icell = icair * nlev + (k - 1)
                        i = count
                        count += 1
                        if r == 0:
                            ge_l["gbh"][icell] = self.gbh[i]
                            ge_l["gbv"][icell] = self.gbv[i]
                            ge_l["gs"][icell] = self.gs_sun[i]
                            ge_l["fssh"][icell] = self.fssh[k]
                            ge_l["rn"][icell] = (self.ileaf_sun_vis[i]
                                                 + self.ileaf_sun_nir[i]
                                                 + self.labs_leaf_sun[i])
                        else:
                            ge_l["gbh"][icell] = self.gbh[i + self.nzl]
                            ge_l["gbv"][icell] = self.gbv[i + self.nzl]
                            ge_l["gs"][icell] = self.gs_shd[i]
                            ge_l["fssh"][icell] = 1.0 - self.fssh[k]
                            ge_l["rn"][icell] = (self.ileaf_shd_vis[i]
                                                 + self.ileaf_shd_nir[i]
                                                 + self.labs_leaf_shd[i])
        rn_sun = (self.ileaf_sun_vis + self.ileaf_sun_nir
                  + self.labs_leaf_sun)
        rn_shd = (self.ileaf_shd_vis + self.ileaf_shd_nir
                  + self.labs_leaf_shd)
        self._accumulate("rn_leaf_sun", rn_sun, isubstep, nsubstep)
        self._accumulate("rn_leaf_shd", rn_shd, isubstep, nsubstep)

        converged, _iters = mlc.step_dt(dt)
        if not converged:
            raise RuntimeError("MLC model did not converge")

        # extract (mlc.F90:798-1003)
        lsel = slice(self.nbot - 1, self.ntop)   # leaf cells of the 93-mesh
        self.tleaf_sun[:] = mlc.leaf[0]["T"][lsel]
        self.tleaf_shd[:] = mlc.leaf[1]["T"][lsel]
        self.tair[:] = mlc.at_T[1:nlev]
        self.qair[:] = mlc.av_q[1:nlev]
        self.wind[:] = ct.wind[0, 1:nlev]
        self.tg = float(mlc.at_T[0])
        self._accumulate("sh_leaf_sun", mlc.at_leaf_sh_flux[lsel, 0],
                         isubstep, nsubstep)
        self._accumulate("sh_leaf_shd", mlc.at_leaf_sh_flux[lsel, 1],
                         isubstep, nsubstep)
        self._accumulate("lh_leaf_sun", mlc.av_leaf_lh[lsel, 0],
                         isubstep, nsubstep)
        self._accumulate("lh_leaf_shd", mlc.av_leaf_lh[lsel, 1],
                         isubstep, nsubstep)
        self._accumulate("tr_leaf_sun", mlc.av_leaf_trans_flux[lsel, 0],
                         isubstep, nsubstep)
        self._accumulate("tr_leaf_shd", mlc.av_leaf_trans_flux[lsel, 1],
                         isubstep, nsubstep)

    # ------------------------------------------------------------------
    # Checkpointing (mlc.F90:1006-1092; photosynthesis.F90:612-666)
    # ------------------------------------------------------------------
    def checkpoint_mlc(self, istep, isubstep, directory="."):
        mlc, ct = self.mlc, self.mlc.cturb
        nl = NZ_CAIR + 1
        vec = np.zeros(nl * 5)
        vec[0:nl] = ct.wind[0, :]
        o = mlc.off
        vec[nl:2 * nl] = np.asarray(mlc.soln[o[0]:o[0] + mlc.Na])
        vec[2 * nl:3 * nl] = np.asarray(mlc.soln[o[1]:o[1] + mlc.Na])
        vec[3 * nl:4 * nl] = np.asarray(mlc.soln[o[2]:o[2] + mlc.Nl])
        vec[4 * nl:5 * nl] = np.asarray(mlc.soln[o[3]:o[3] + mlc.Nl])
        fname = f"{directory}/mlc_checkpoint.{istep:03d}.{isubstep}.bin"
        write_vec(fname, vec)
        return fname

    def checkpoint_photosynthesis(self, istep, isubstep, directory="."):
        av = self.psy.soe.ge.avars
        ncells = self.ncair * self.ntree * self.nzl * NLEAF
        vec = np.zeros((ncells, 3))
        vec[:, 0] = av.leaf_psi[:ncells]
        vec[:, 1] = av.tleaf[:ncells]
        vec[:, 2] = av.gleaf_w_soln[:ncells]
        fname = (f"{directory}/photosynthesis_checkpoint."
                 f"{istep:03d}.{isubstep}.bin")
        write_vec(fname, vec.ravel())
        return fname

    # ------------------------------------------------------------------
    def run(self, beg_step=1, end_step=1, nsubstep=12,
            bc_provider: Callable[..., MLBoundaryConditions] = None,
            checkpoint_data=False, checkpoint_dir="."):
        """The istep/isubstep loop (ml_model_problem.F90:372-417)."""
        if bc_provider is None:
            bc_provider = synthetic_diurnal_bc
        if self.bc is None:
            self.set_initial_conditions(bc_provider(beg_step, None))
        checkpoints = []
        for istep in range(beg_step, end_step + 1):
            self.bc = bc_provider(istep, self.bc)
            with self.timers.phase("SWV"):
                self.solve_swv(istep, 3600.0 / nsubstep)
            for isubstep in range(1, nsubstep + 1):
                dt = 300.0
                with self.timers.phase("LWV"):
                    self.solve_lwv(istep, isubstep, dt, nsubstep)
                with self.timers.phase("LBL"):
                    self.solve_lbl(istep, isubstep, dt)
                with self.timers.phase("PHY"):
                    is_first = (istep == beg_step and isubstep == 1)
                    self.solve_photosynthesis(istep, isubstep, is_first, dt,
                                              nsubstep)
                with self.timers.phase("MLC"):
                    self.solve_mlc(istep, isubstep, dt, nsubstep)
            if checkpoint_data:
                checkpoints.append(
                    (self.checkpoint_mlc(istep, nsubstep, checkpoint_dir),
                     self.checkpoint_photosynthesis(istep, nsubstep,
                                                    checkpoint_dir)))
        return checkpoints


def run_ml_model_problem(beg_step=1, end_step=1, nsubstep=12,
                         stomatal_conductance_model="medlyn",
                         bc_provider=None, checkpoint_data=False,
                         checkpoint_dir=".", device="cuda") -> MLModel:
    model = MLModel(stomatal_conductance_model=stomatal_conductance_model,
                    device=device)
    model.run(beg_step, end_step, nsubstep, bc_provider, checkpoint_data,
              checkpoint_dir)
    return model

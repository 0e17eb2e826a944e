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

The port carries those, the boundary-condition records and the mesh
constructors.  The serial orchestrator ``MLModel`` and
``run_ml_model_problem`` need the serial MLC facade (``models/mlc``) and
the phase timers (ROADMAP Slice E2) and raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from mpp_tpu_torch.constants import (ConnKind, TFRZ,
                                     MeshType as MeshKind)
from mpp_tpu_torch.dtypes.mesh import Mesh, ConnectionSet
from mpp_tpu_torch.models import photosynthesis as ph

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
# The orchestrator (ROADMAP Slice E2)
# ---------------------------------------------------------------------------
class MLModel:
    """5-MPP coupled canopy model (run_ml_model_problem semantics)."""

    def __init__(self, *args, **kw):
        raise NotImplementedError(
            "MLModel needs the serial MLC facade models/mlc.MLCMPP, not "
            "ported yet (ROADMAP Slice E2)")


def run_ml_model_problem(*args, **kw):
    raise NotImplementedError(
        "run_ml_model_problem needs MLModel, not ported yet (ROADMAP Slice "
        "E2)")

"""ELM/ALM host-model coupling layer on the batched VSFM stepper.

Counterpart of ``mpp_tpu/driver/alm.py`` (MPPVSFMALM_Driver.F90,
MPPVSFMALM_Initialize.F90): the land model hands over a batch of soil
columns with CLM-style state and fluxes each timestep; the driver stages
unit-converted source/sink terms, solves the full VSFM physics, audits
per-column mass balance in f64 and unpacks the results to CLM arrays.

* One Richards GE over a CLM column mesh, built through the ``VSFMMPP``
  facade in the reference's order: SS ``COND_MASS_RATE`` conditions
  Infiltration/Evapotranspiration/Dew/Drainage/Snow-disappearance/
  Sublimation and an optional ``COND_SEEPAGE_BC`` at the top
  (Initialize.F90:814-882); per-column heterogeneous CLM soils
  (smooth_brooks_corey_bz3 + DENSITY_TGDPB01 by default) ride the
  stepper's dynamic-parameter contract (``dyn``).
* Flux unit conversion mm/s -> kg/s via ``area * denh2o * 1e-3``
  (Driver.F90:298); ET ``-qflx_tran_veg * rootr(j)``; per-layer drainage
  below the water table with the ``watmin`` limiter (ibid:301-370).
* Retry ladder, at most 10 attempts (ibid:620-930): on divergence switch
  ``stol`` to 1e-10 and, after a second divergence, reset frac_liq = 1; on
  convergence audit |mass_beg - mass_end + total_flux*dt| < 1e-5 kg per
  column and, if violated, tighten rtol or stol by 10x according to the
  converged reason and re-solve.
* Unpacking: h2osoi_liq/ice, smp_l [mm], water-table depth zwt,
  qflx_seepage, qcharge = 0.

One attempt is one plain function call (``_attempt``): staging, the
batched Newton, the f64 audit and the unpack.  The host reads one small
diagnostics vector per attempt plus the stepper's per-iteration
predicates; the output's ``host_round_trips_per_step`` and
``dispatches_per_step`` both report those host synchronisations.

Level convention: arrays are [ncol, nz] with level 0 at the column BOTTOM
and level nz-1 at the surface; ``zi`` is top-first.

Not ported yet (raise ``NotImplementedError``, ROADMAP Queue 2): lateral
connectivity (ring and UGDM) and the per-column f64 escalation of f32
state (``escalate_f64=True`` with f32 state).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpp_tpu_torch.constants import (Cond, GEType, MPPType, Region,
                                     MeshType as MeshKind, DENH2O, FMWH2O,
                                     GRAVITY_CONSTANT, GRAV_CLM, PRESSURE_REF)
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.dtypes.mesh import column_mesh
from mpp_tpu_torch.models.richards import VSFMMPP
from mpp_tpu_torch.ops import eos, satfunc as sf
from mpp_tpu_torch.ops.snes import (CONVERGED_FNORM_RELATIVE,
                                    CONVERGED_SNORM_RELATIVE)
from mpp_tpu_torch.batched.vsfm_compiled import compile_vsfm

MAX_ITER_COUNT = 10              # MPPVSFMALM_Driver.F90:116 max_iter_count
STOL_ALTERNATE = 1e-10           # ibid:122 stol_alternate
MAX_ABS_MASS_ERROR_COL = 1e-5    # ibid:140 [kg]
WATMIN = 0.01                    # CLM clm_varcon watmin [kg/m^2]
VISH2O = 0.001002                # VSFMMPPSetSoilsCLM vish2o [N s/m^2]

F64 = torch.float64


@dataclasses.dataclass
class ALMVSFMProblem:
    """State of the coupled VSFM problem owned by the host model.

    Built once by :func:`alm_vsfm_initialize`; advanced every land-model
    step by :func:`alm_vsfm_solve`."""
    mpp: VSFMMPP                     # template single-column facade problem
    comp: object                     # CompiledVSFM stepper
    dyn: tuple                       # per-GE dynamic params, [ncol, ...]
    P: torch.Tensor                  # soil liquid pressure [Pa], [ncol, nz]
    area: np.ndarray                 # column area [m^2], [ncol]
    dz: np.ndarray                   # layer thickness [m], [ncol, nz]
    zi: np.ndarray                   # interface depth below surface [m],
                                     # [ncol, nz+1] (zi[:,0]=0, top-first)
    ss_slices: dict                  # condition name -> (offset, size)
    include_seepage_bc: bool = False
    # per-problem audit threshold [kg] (the reference's 1e-5; an f32
    # throughput mode relaxes it to its evaluation floor)
    audit_threshold_kg: float = MAX_ABS_MASS_ERROR_COL
    # f64 device copies of area / zi / dz and staged defaults
    consts: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def ncol(self) -> int:
        return int(self.P.shape[0])

    @property
    def nz(self) -> int:
        return int(self.P.shape[1])

    @property
    def device(self):
        return self.P.device

    def const(self, key, build):
        if key not in self.consts:
            self.consts[key] = build()
        return self.consts[key]


def _build_template_mpp(dz0, area0, satfunc_type, density_type,
                        watsat0, hksat0, bsw0, sucsat0, residual_sat0,
                        include_seepage_bc):
    """The 8-step builder sequence of MPPVSFMALM_Initialize.F90 for one
    template column; per-column heterogeneity rides the dyn contract."""
    nz = dz0.size
    mpp = VSFMMPP()
    mpp.set_name("VSFM-ALM")
    mpp.set_id(MPPType.VSFM_SNES_CLM)
    mpp.set_num_meshes(1)
    zc = np.cumsum(dz0) - 0.5 * dz0          # bottom-first
    mesh = column_mesh("ALM soil column", zc, dz0, np.full(nz, area0),
                       ncols=1, itype=int(MeshKind.CLM_SOIL_COL),
                       orientation=int(MeshKind.AGAINST_GRAVITY))
    mpp.add_mesh(mesh)
    ieqn = mpp.add_goveqn(GEType.RE, "Richards Equation ODE")
    # conditions in the reference's order (Initialize.F90:836-870)
    for name, region in (("Infiltration_Flux", Region.SOIL_TOP_CELLS),
                         ("Evapotranspiration_Flux", Region.SOIL_CELLS),
                         ("Dew_Flux", Region.SOIL_TOP_CELLS),
                         ("Drainage_Flux", Region.SOIL_CELLS),
                         ("Snow_Disappearance_Flux", Region.SOIL_TOP_CELLS),
                         ("Sublimation_Flux", Region.SOIL_TOP_CELLS)):
        mpp.add_condition_in_goveqn(ieqn, Cond.SS, name, "kg/s",
                                    Cond.MASS_RATE, region=region)
    if include_seepage_bc:
        mpp.add_condition_in_goveqn(ieqn, Cond.BC, "Seepage_Flux", "kg/s",
                                    Cond.SEEPAGE_BC,
                                    region=Region.SOIL_TOP_CELLS)
    mpp.allocate_auxvars()
    mpp.setup_problem()
    shape1 = (1, nz)
    mpp.set_soils(filter_vsfmc=np.ones(1, np.int64),
                  watsat=watsat0.reshape(shape1),
                  hksat=hksat0.reshape(shape1),
                  bsw=bsw0.reshape(shape1),
                  sucsat=sucsat0.reshape(shape1),
                  residual_sat=residual_sat0.reshape(shape1),
                  satfunc_type=satfunc_type, density_type=density_type)
    return mpp


def alm_vsfm_initialize(watsat, hksat, bsw, sucsat, residual_sat, dz, area,
                        P0=None, satfunc_type="smooth_brooks_corey_bz3",
                        density_type=eos.DENSITY_TGDPB01,
                        lateral_connectivity=False, dtype=torch.float64,
                        device="cuda", include_seepage_bc=False,
                        escalate_f64=True):
    """Build the batched VSFM problem from CLM column data (numpy
    [ncol, nz] soils, the same arrays the JAX package takes).

    CLM Clapp-Hornberger inputs are converted as ``VSFMMPPSetSoilsCLM``
    (MultiPhysicsProbVSFM.F90:367-419): perm = hksat_mm/s * 1e-3 * vish2o
    / (denh2o*g), lambda = 1/bsw, alpha = 1/(sucsat*g).  ``escalate_f64``
    matters only for f32 state, where the escalation is not ported yet:
    f32 runs pass ``escalate_f64=False`` (the throughput mode).  The state
    lives on the card unless ``device="cpu"``."""
    device = device_of(device)
    if lateral_connectivity:
        raise NotImplementedError(
            "ALM lateral connectivity (ring and UGDM) is not ported yet "
            "(ROADMAP Queue 2, deferred pieces of Slice A)")
    if dtype != F64 and escalate_f64:
        raise NotImplementedError(
            "per-column f64 escalation of f32 state is not ported yet "
            "(ROADMAP Queue 2); pass escalate_f64=False for f32 state")
    watsat = np.asarray(watsat, np.float64)
    ncol, nz = watsat.shape
    full = lambda v: np.broadcast_to(np.asarray(v, np.float64), (ncol, nz))
    hksat, bsw, sucsat, residual_sat = (full(hksat), full(bsw),
                                        full(sucsat), full(residual_sat))
    dz = full(dz).copy()
    area = np.broadcast_to(np.asarray(area, np.float64), (ncol,)).copy()

    mpp = _build_template_mpp(dz[0], area[0], satfunc_type, density_type,
                              watsat[0], hksat[0], bsw[0], sucsat[0],
                              residual_sat[0], include_seepage_bc)
    comp = compile_vsfm(mpp)

    # per-column dynamic parameters; conversion constants match
    # VSFMMPPSetSoilsCLM exactly (CLM's grav, not GRAVITY_CONSTANT)
    lam = 1.0 / bsw
    alpha = 1.0 / (sucsat * GRAV_CLM)
    perm = hksat * 1e-3 * VISH2O / (DENH2O * GRAV_CLM)
    sat = sf.satparams_dyn_clm(satfunc_type, residual_sat, alpha, lam)
    f = lambda v: torch.as_tensor(np.array(v, np.float64), dtype=dtype,
                                  device=device)
    dyn_g = {"sat": {k: f(v) for k, v in sat.items()},
             "por_base": f(watsat),
             "perm": f(np.repeat(perm[..., None], 3, axis=-1)),
             "frac_liq": torch.ones((ncol, nz), dtype=dtype, device=device),
             "vol": f(area[:, None] * dz),
             # internal connection geometry (nz-1 vertical faces/column)
             "in_dist_up": f(0.5 * dz[:, :-1]),
             "in_dist_dn": f(0.5 * dz[:, 1:]),
             "in_area": f(np.broadcast_to(area[:, None], (ncol, nz - 1)))}
    if include_seepage_bc:
        dyn_g["bc_dist_up"] = f(np.zeros((ncol, 1)))
        dyn_g["bc_dist_dn"] = f(0.5 * dz[:, -1:])
        dyn_g["bc_area"] = f(area[:, None])

    ss_slices = {}
    off = 0
    for cond in mpp.soe.goveqns[0].source_sinks:
        ss_slices[cond.name] = (off, cond.num_connections)
        off += cond.num_connections

    if P0 is None:
        P0 = np.full((ncol, nz), 3.5355e3)
    # interface depths below the surface, top-first; levels are
    # bottom-first, hence the reverse
    zi = np.zeros((ncol, nz + 1))
    zi[:, 1:] = np.cumsum(dz[:, ::-1], axis=1)
    return ALMVSFMProblem(mpp=mpp, comp=comp, dyn=(dyn_g,), P=f(P0),
                          area=area, dz=dz, zi=zi, ss_slices=ss_slices,
                          include_seepage_bc=include_seepage_bc)


def state_from_numpy(P, dyn, *, device, dtype):
    """The JAX problem's ``prob.P`` and ``prob.dyn`` (as numpy arrays, a
    tuple of per-GE dicts with nested dicts) as the port's tensors:
    returns (P, dyn)."""
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.as_tensor(np.array(v), dtype=dtype, device=device)
    return conv(P), tuple(conv(d) for d in dyn)


def _to64(tree):
    if isinstance(tree, dict):
        return {k: _to64(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to64(v) for v in tree)
    return tree.to(F64)


def cell_mass_kg(prob: ALMVSFMProblem, P, dyn=None):
    """Per-cell liquid water mass [kg] (VAR_MASS: por*den*sat*vol with the
    column's own parameters)."""
    g = prob.comp.goveqns[0]
    dyn = prob.dyn if dyn is None else dyn
    return g.accum(P, dyn=dyn[0]) * FMWH2O


def _stage_drainage(qflx_drain, zwt, zi, dz, h2osoi_liq, dtime, conv):
    """Per-layer drainage sinks [kg/s, bottom-first] with the water-table
    split and watmin limiter (MPPVSFMALM_Driver.F90:330-370).  Returns
    (sinks [ncol, nz], total drainage [mm/s, ncol])."""
    ncol, nz = dz.shape
    pos = qflx_drain > 0.0
    # jwt: CLM layer above the water table (1-based top-first), >= 1
    below = zwt[:, None] <= zi[:, 1:]
    jwt = torch.where(below.any(dim=1),
                      below.to(torch.uint8).argmax(dim=1),
                      torch.full_like(zwt, nz, dtype=torch.long))
    jwt = torch.clamp_min(jwt, 1)
    dz_top = torch.flip(dz, [1])
    liq_top = torch.flip(h2osoi_liq, [1])
    mask = torch.arange(nz, device=dz.device)[None, :] >= jwt[:, None]
    dzsum = torch.where(mask, dz_top, 0.0).sum(dim=1)
    dzsum = torch.where(dzsum > 0.0, dzsum, 1.0)
    ql = qflx_drain[:, None] * dz_top / dzsum[:, None]
    ql = torch.minimum(ql, torch.clamp_min(liq_top - WATMIN, 0.0) / dtime)
    ql = torch.where(mask & pos[:, None], ql, 0.0)
    out = -torch.flip(ql, [1]) * conv[:, None]
    return out, ql.sum(dim=1)


def _water_table_depth(smp_l, zi):
    """zwt from the first unsaturated layer (Driver:853-873).  Levels are
    bottom (0) to top (nz-1); ``zi`` is top-first [ncol, nz+1]."""
    smp_l = torch.as_tensor(smp_l)
    zi = torch.as_tensor(zi, dtype=F64, device=smp_l.device)
    ncol, nz = smp_l.shape
    depth_col = zi[:, -1]
    top_first = torch.flip(smp_l, [1])          # j = 0 at the surface
    unsat = top_first < 0.0
    has = unsat.any(dim=1)
    jwt = torch.where(has, unsat.to(torch.uint8).argmax(dim=1),
                      torch.full_like(has, -1, dtype=torch.long))
    sel = has & (jwt != nz - 1)
    j = torch.clamp(jwt, 0, nz - 2)
    r = torch.arange(ncol, device=smp_l.device)
    # midpoints of the interfaces around the first unsaturated layer
    z_dn = 0.5 * (zi[r, j] + zi[r, j + 1])
    z_up = 0.5 * (zi[r, j + 1] + zi[r, j + 2])
    s0 = top_first[r, j]
    s1 = top_first[r, j + 1]
    denom = s0 - s1
    flat = denom == 0.0
    zw = torch.where(flat, depth_col,
                     (0.0 - s0) / torch.where(flat, 1.0, denom)
                     * (z_dn - z_up) + z_dn)
    zw = torch.minimum(torch.clamp_min(zw, 0.0), depth_col)
    return torch.where(sel, zw, depth_col)


def _attempt(prob: ALMVSFMProblem, P_prev, dyn_base, temperature, frac_liq,
             frac_ice, forcing, reset_fl, rtol, stol, gate, dtime):
    """One solve attempt: previous-state unpack (zwt for the drainage
    split) -> flux unit conversion + SS staging -> the batched Newton ->
    f64 mass audit -> CLM unpack.  Returns a dict of tensors and ``diag``
    = [all converged, max audit error, Newton iterations, any
    FNORM_RELATIVE, any SNORM_RELATIVE] (f64, on the device)."""
    comp = prob.comp
    g = comp.goveqns[0]
    ncol, nz = prob.ncol, prob.nz
    dtype, dev = P_prev.dtype, P_prev.device
    area = prob.const("area", lambda: torch.as_tensor(prob.area, dtype=F64,
                                                      device=dev))
    zi = prob.const("zi", lambda: torch.as_tensor(prob.zi, dtype=F64,
                                                  device=dev))
    dz = prob.const("dz", lambda: torch.as_tensor(prob.dz, dtype=F64,
                                                  device=dev))
    conv = area * DENH2O * 1e-3                  # [mm/s] -> [kg/s]

    # ---- dynamic auxvar state (Driver:399-465) ----
    fl = torch.ones_like(frac_liq) if reset_fl else frac_liq
    dyn_g = dict(dyn_base)
    dyn_g["temperature"] = temperature
    dyn_g["frac_liq"] = fl
    dyn = (dyn_g,)
    dyn64 = _to64(dyn)

    # ---- previous-state unpack for the drainage split ----
    P64 = P_prev.to(F64)
    mass_prev = g.accum(P64, dyn=dyn64[0]) * FMWH2O
    smp_prev = (P64 - PRESSURE_REF) / (DENH2O * GRAVITY_CONSTANT) * 1e3
    h2o_prev = mass_prev / area[:, None]
    zwt_prev = _water_table_depth(smp_prev, zi)

    # ---- stage SS conditions [kg/s] (Driver:290-430) ----
    parts = {name: torch.zeros((ncol, m), dtype=F64, device=dev)
             for name, (_, m) in prob.ss_slices.items()}
    parts["Evapotranspiration_Flux"] = \
        (-forcing["qflx_tran_veg"] * conv)[:, None] * forcing["rootr"]
    parts["Infiltration_Flux"] = (forcing["qflx_infl"] * conv)[:, None]
    parts["Dew_Flux"] = (forcing["qflx_dew"] * conv)[:, None]
    parts["Sublimation_Flux"] = (-forcing["qflx_sub_snow"] * conv)[:, None]
    parts["Snow_Disappearance_Flux"] = forcing["mflx_snowlyr"][:, None]
    drain, qflx_drain_tot = _stage_drainage(
        forcing["qflx_drain"], zwt_prev, zi, dz, h2o_prev, dtime, conv)
    parts["Drainage_Flux"] = drain
    ss64 = torch.cat([parts[name] for name in prob.ss_slices], dim=1)
    total_flux_col = ss64.sum(dim=1)             # [kg/s]
    ss = ss64.to(dtype)
    # seepage BC pressure = PRESSURE_REF (Driver:538-545)
    if prob.include_seepage_bc:
        bc = torch.full((ncol, 1), 101325.0, dtype=dtype, device=dev)
    else:
        bc = torch.zeros((ncol, 0), dtype=dtype, device=dev)

    # the audit compares differences of ~1e2-1e3 kg of storage at 1e-5 kg,
    # below f32 summation noise, so it always evaluates in f64
    mass_beg = comp.column_storage(P64, dyn64) * FMWH2O

    # ---- the batched Newton (per-column dt ladders) ----
    X, iters, done, reason = comp._step_dt_batched(
        P_prev, (bc,), (ss,), dtime, torch.zeros_like(P_prev), dyn,
        (rtol, stol, gate))

    # ---- f64 audit at the converged state (Driver:861-863) ----
    X64 = X.to(F64)
    S_end = comp.column_storage(X64, dyn64)
    bflux = comp.column_bc_flux(X64, (bc.to(F64),), dyn64)
    err = torch.abs(mass_beg - S_end * FMWH2O
                    + (total_flux_col - bflux * FMWH2O) * dtime)

    # ---- unpack to CLM arrays (Driver:700-900) ----
    mass_cell = g.accum(X, dyn=dyn[0]) * FMWH2O
    smp_l = (X - PRESSURE_REF) / (DENH2O * GRAVITY_CONSTANT) * 1e3
    h2osoi_liq = (1.0 - frac_ice) * mass_cell / area[:, None]
    h2osoi_ice = frac_ice * mass_cell / area[:, None]
    zwt = _water_table_depth(smp_l, zi)
    qflx_seepage = bflux * FMWH2O / conv

    diag = torch.stack([
        torch.all(done).to(F64), err.max(),
        torch.tensor(float(iters), dtype=F64, device=dev),
        torch.any(done & (reason == CONVERGED_FNORM_RELATIVE)).to(F64),
        torch.any(done & (reason == CONVERGED_SNORM_RELATIVE)).to(F64)])
    return {"P": X, "done": done, "reason": reason, "err": err,
            "diag": diag, "mass_beg": mass_beg,
            "total_flux_col": total_flux_col, "ss": ss, "bc": bc,
            "S_end": S_end, "bflux": bflux,
            "mass_cell": mass_cell, "smp_l": smp_l,
            "h2osoi_liq": h2osoi_liq, "h2osoi_ice": h2osoi_ice,
            "zwt": zwt, "qflx_seepage": qflx_seepage,
            "qflx_lateral": torch.zeros(ncol, dtype=F64, device=dev),
            "qflx_drain_tot": qflx_drain_tot}


def alm_vsfm_solve(prob: ALMVSFMProblem, dtime,
                   qflx_infl=None, qflx_tran_veg=None, rootr=None,
                   qflx_dew=None, qflx_sub_snow=None, qflx_drain=None,
                   mflx_snowlyr=None, t_soil=None, frac_ice=None):
    """One host-model timestep (MPPVSFMALM_Solve analog).

    Fluxes in CLM units (all optional, numpy or tensors): ``qflx_infl``
    [mm/s, ncol] infiltration, ``qflx_tran_veg`` [mm/s, ncol]
    transpiration with per-layer root fractions ``rootr`` [ncol, nz,
    bottom-first], ``qflx_dew`` [mm/s], ``qflx_sub_snow`` [mm/s],
    ``qflx_drain`` [mm/s] drainage split below the water table,
    ``mflx_snowlyr`` [kg/s], ``t_soil`` [K, ncol, nz], ``frac_ice``
    [ncol, nz] (stages frac_liq = 1 - frac_ice).

    Returns a dict of CLM-facing outputs (h2osoi_liq/ice [kg/m^2], smp_l
    [mm], zwt [m], qflx_lateral/qflx_seepage [mm/s], soilp [Pa]) and
    solver diagnostics (attempts, diverged_count, mass_bal_err_count,
    abs_mass_error_col, escalated_cols, newton_iters, the per-column
    SNES reason of the last solve, and the host
    synchronisations of the step as dispatches_per_step and
    host_round_trips_per_step)."""
    ncol, nz = prob.ncol, prob.nz
    dtype, dev = prob.P.dtype, prob.device
    comp = prob.comp
    syncs0 = comp.host_syncs

    def dense(v, shape):
        if v is None:
            return torch.zeros(shape, dtype=F64, device=dev)
        if isinstance(v, torch.Tensor):
            return v.to(device=dev, dtype=F64).expand(shape)
        return torch.as_tensor(np.broadcast_to(np.asarray(v, np.float64),
                                               shape).copy(), device=dev)
    forcing = {
        "qflx_infl": dense(qflx_infl, (ncol,)),
        "qflx_tran_veg": dense(qflx_tran_veg, (ncol,)),
        "rootr": dense(rootr, (ncol, nz)),
        "qflx_dew": dense(qflx_dew, (ncol,)),
        "qflx_sub_snow": dense(qflx_sub_snow, (ncol,)),
        "qflx_drain": dense(qflx_drain, (ncol,)),
        "mflx_snowlyr": dense(mflx_snowlyr, (ncol,)),
    }
    dyn_base = dict(prob.dyn[0])
    base_fl = dyn_base.pop("frac_liq")
    if t_soil is not None:
        temperature = torch.as_tensor(np.asarray(t_soil) if not isinstance(
            t_soil, torch.Tensor) else t_soil, dtype=dtype, device=dev)
    else:
        temperature = prob.const(("temp_default", dtype), lambda: (
            torch.as_tensor(comp.goveqns[0].temperature[:nz], dtype=dtype,
                            device=dev).expand(ncol, nz).contiguous()))
    if frac_ice is not None:
        frac_ice = torch.as_tensor(np.asarray(frac_ice) if not isinstance(
            frac_ice, torch.Tensor) else frac_ice, dtype=dtype, device=dev)
        frac_liq = 1.0 - frac_ice
    else:
        frac_liq = base_fl
        frac_ice = torch.zeros((ncol, nz), dtype=dtype, device=dev)

    sp = comp.snes if dtype == F64 else comp.snes_f32
    rtol, stol = sp.rtol, sp.stol
    # the mass-closure gate (|sum F|*dt*FMWH2O, the audit integrand)
    # applies to f64 state only: the f32 residual-evaluation floor cannot
    # iterate toward the f64-audited threshold (KNOWN_GAPS #9)
    gate = 0.5 * MAX_ABS_MASS_ERROR_COL if dtype == F64 else 0.0

    P_prev = prob.P
    attempts = diverged_count = mass_bal_err_count = 0
    diag_pulls = 0
    abs_mass_error = np.inf
    reset_fl = False
    while True:
        attempts += 1
        out = _attempt(prob, P_prev, dyn_base, temperature, frac_liq,
                       frac_ice, forcing, reset_fl, rtol, stol, gate, dtime)
        diag = out["diag"].cpu().numpy()
        diag_pulls += 1
        converged = bool(diag[0])
        P = out["P"]
        if not converged:
            # Driver:650-667: alternate stol; after the 2nd divergence
            # reset frac_liq to 1
            stol = STOL_ALTERNATE
            diverged_count += 1
            if diverged_count > 1:
                reset_fl = True
        else:
            if _audit_err is not _AUDIT_ERR_DEFAULT:
                # failure-injection seam of the tests
                err_np = _audit_err(prob, P, out["bc"], None,
                                    out["mass_beg"].cpu().numpy(),
                                    out["total_flux_col"].cpu().numpy(),
                                    dtime, (out["S_end"], out["bflux"]))
                abs_mass_error = float(np.max(err_np))
            else:
                abs_mass_error = float(diag[1])
            if abs_mass_error >= prob.audit_threshold_kg:
                mass_bal_err_count += 1
                # Driver:886-905: tighten the criterion that fired
                if diag[3]:
                    rtol = rtol / 10.0
                if diag[4]:
                    stol = stol / 10.0
            else:
                break
        if attempts >= MAX_ITER_COUNT:
            raise RuntimeError(
                "ALM VSFM failed to converge after multiple attempts "
                f"(diverged {diverged_count}, mass-bal errors "
                f"{mass_bal_err_count}, last error {abs_mass_error:.3e} kg)")

    prob.P = P
    syncs = comp.host_syncs - syncs0 + diag_pulls
    return {
        "h2osoi_liq": out["h2osoi_liq"], "h2osoi_ice": out["h2osoi_ice"],
        "smp_l": out["smp_l"], "soilp": P, "zwt": out["zwt"],
        "qflx_lateral": out["qflx_lateral"],
        "qflx_seepage": out["qflx_seepage"],
        "qflx_drain_tot": out["qflx_drain_tot"],
        "qcharge": torch.zeros((ncol,), dtype=dtype, device=dev),
        "attempts": attempts, "diverged_count": diverged_count,
        "mass_bal_err_count": mass_bal_err_count,
        "abs_mass_error_col": abs_mass_error,
        "escalated_cols": 0,
        "newton_iters": int(diag[2]),
        "reason": out["reason"],
        "dispatches_per_step": syncs,
        "host_round_trips_per_step": syncs,
    }


def _audit_err(prob, P, bc, dyn, mass_beg_col, total_flux_col, dtime,
               precomputed=None):
    """Per-column |mass_beg - mass_end + total_flux*dt| [kg]
    (MPPVSFMALM_Driver.F90:861-863) in f64, numpy; BC (seepage) fluxes at
    the converged state enter with the residual's sign.  ``precomputed``
    = (S_end [kmol], bflux [kmol/s]) skips the re-evaluation."""
    if precomputed is not None:
        S, bflux = precomputed
    else:
        dyn64 = _to64(tuple(prob.dyn if dyn is None else dyn))
        P64 = P.to(F64)
        S = prob.comp.column_storage(P64, dyn64)
        bflux = prob.comp.column_bc_flux(P64, (bc.to(F64),), dyn64)
    mass_end_col = S.cpu().numpy() * FMWH2O
    bflux_kg = bflux.cpu().numpy() * FMWH2O
    return np.abs(np.asarray(mass_beg_col) - mass_end_col
                  + (np.asarray(total_flux_col) - bflux_kg) * dtime)


#: sentinel for the failure-injection test seam: the driver skips the
#: full-array audit pulls unless `_audit_err` was replaced
_AUDIT_ERR_DEFAULT = _audit_err

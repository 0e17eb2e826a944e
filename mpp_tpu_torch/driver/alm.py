"""ELM/ALM host-model coupling layer on the batched VSFM stepper.

Counterpart of ``mpp_tpu/driver/alm.py`` (MPPVSFMALM_Driver.F90,
MPPVSFMALM_Initialize.F90): the land model hands over a batch of soil
columns with CLM-style state and fluxes each timestep; the driver stages
unit-converted source/sink terms, solves the full VSFM physics, audits
per-column mass balance in f64 and unpacks the results to CLM arrays.

* One Richards GE over a CLM column mesh, built through the ``VSFMMPP``
  facade in the reference's order: SS ``COND_MASS_RATE`` conditions
  Infiltration/Evapotranspiration/Dew/Drainage/Snow-disappearance/
  Sublimation, Lateral_flux under lateral connectivity, and an optional
  ``COND_SEEPAGE_BC`` at the top (Initialize.F90:814-882); per-column
  heterogeneous CLM soils
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
* Lateral connectivity, the operator-split 'source_sink' model
  (ibid:465-532): the lateral flux of the pre-step pressures is staged as
  the Lateral_flux SS condition and returned as ``qflx_lateral`` [mm/s].
  By default the columns form a ring over the batch axis with
  edge-replicated ends, flux -g*((P-left)+(P-right)); with ``ugrid`` (a
  ``parallel.ugrid.UGrid``) the flux is the per-level lateral Darcy flux
  over the grid's edges, computed on the device from the UGDM's edge
  lists.
* Column parallelism (``device_mesh``, a ``parallel.distributed.
  ColumnGroup``): each rank holds its own block of columns (the
  reference's begc:endc, mpp_bounds.F90:9-27) on the group's device and
  exchanges boundary columns for the lateral flux; every decision of the
  retry ladder (convergence, the audit, the tightened criterion) is
  all-reduced first, so every rank runs the same attempts and the same
  collectives.
* Per-column f64 escalation of f32 state (beyond the reference, which is
  f64 throughout): columns whose audit error stays at or above the
  threshold (the f32 evaluation floor) are gathered, re-solved from the
  pre-step state in f64 on the same stepper and scattered back.
* Unpacking: h2osoi_liq/ice, smp_l [mm], water-table depth zwt,
  qflx_seepage, qcharge = 0.

One attempt is one plain function call (``_attempt``): staging, the
batched Newton, the f64 audit and the unpack.  The host reads one small
diagnostics vector per attempt plus the stepper's per-iteration
predicates, each through the stepper's counted, spanned sync; the
output's ``host_round_trips_per_step`` reports those host
synchronisations.  The step is an ``alm.step`` span (``io/timers.py``).

Level convention: arrays are [ncol, nz] with level 0 at the column BOTTOM
and level nz-1 at the surface; ``zi`` is top-first.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from mpp_tpu_torch.constants import (Cond, GEType, MPPType, Region,
                                     MeshType as MeshKind, DENH2O, FMWH2O,
                                     GRAVITY_CONSTANT, GRAV_CLM, PRESSURE_REF)
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.dtypes.mesh import column_mesh
from mpp_tpu_torch.io import timers
from mpp_tpu_torch.models.richards import VSFMMPP
from mpp_tpu_torch.ops import eos, satfunc as sf
from mpp_tpu_torch.ops.snes import (CONVERGED_FNORM_RELATIVE,
                                    CONVERGED_SNORM_RELATIVE)
from mpp_tpu_torch.batched.vsfm_compiled import compile_vsfm
from mpp_tpu_torch.parallel.sharding import lateral_flux_op_split

MAX_ITER_COUNT = 10              # MPPVSFMALM_Driver.F90:116 max_iter_count
STOL_ALTERNATE = 1e-10           # ibid:122 stol_alternate
MAX_ABS_MASS_ERROR_COL = 1e-5    # ibid:140 [kg]
WATMIN = 0.01                    # CLM clm_varcon watmin [kg/m^2]
VISH2O = 0.001002                # VSFMMPPSetSoilsCLM vish2o [N s/m^2]

F64 = torch.float64

_ALM_STEP = timers.Site("alm.step")


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
    lateral_connectivity: bool = False
    lateral_conductance: float = 0.0  # [kmol/s/Pa] per column pair (ring)
    # f32 state: re-solve audit-failing columns in f64
    escalate_f64: bool = True
    # per-problem audit threshold [kg] (the reference's 1e-5; an f32
    # throughput mode without escalation relaxes it to its evaluation floor)
    audit_threshold_kg: float = MAX_ABS_MASS_ERROR_COL
    # the general-graph lateral model: the global grid and its maps on
    # the problem's device (None: the ring)
    ugrid: object = None
    ugdm: object = None
    # the ranks sharing the column axis (None: one process)
    group: object = None
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
                        lateral_connectivity, include_seepage_bc):
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
    if lateral_connectivity:
        mpp.add_condition_in_goveqn(ieqn, Cond.SS, "Lateral_flux", "kg/s",
                                    Cond.MASS_RATE,
                                    region=Region.SOIL_CELLS)
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
                        lateral_connectivity=False, lateral_conductance=0.0,
                        device_mesh=None, ugrid=None, dtype=torch.float64,
                        device="cuda", include_seepage_bc=False,
                        escalate_f64=True):
    """Build the batched VSFM problem from CLM column data (numpy
    [ncol, nz] soils, the same arrays the JAX package takes).

    CLM Clapp-Hornberger inputs are converted as ``VSFMMPPSetSoilsCLM``
    (MultiPhysicsProbVSFM.F90:367-419): perm = hksat_mm/s * 1e-3 * vish2o
    / (denh2o*g), lambda = 1/bsw, alpha = 1/(sucsat*g).
    ``lateral_connectivity`` couples the columns as a ring with
    ``lateral_conductance`` [kmol/s/Pa] per pair, or with ``ugrid`` over
    the grid's edges (the arrays staged in the UGDM's padded petsc
    layout, ``ugdm.natural_to_sharded``).  ``device_mesh`` (a
    ``ColumnGroup``) makes this rank's problem one block of a column axis
    shared by the group's ranks: the arrays are this rank's columns (with
    ``ugrid``, its [n_own, nz] block) and the state lives on the group's
    device.  ``escalate_f64`` matters only for f32 state: audit-failing
    columns are re-solved in f64 (``escalate_f64=False`` is the
    throughput mode, with a relaxed ``audit_threshold_kg``).  The state
    lives on the card unless ``device="cpu"``."""
    device = device_of(device_mesh.device if device_mesh is not None
                       else device)
    watsat = np.asarray(watsat, np.float64)
    ncol, nz = watsat.shape
    ugdm = None
    if ugrid is not None:
        ugdm = ugrid.partition(device_mesh.world_size
                               if device_mesh is not None else 1)
        staged = ugdm.n_own if device_mesh is not None \
            else ugdm.ndev * ugdm.n_own
        if staged != ncol:
            raise ValueError(
                f"ugrid padding ({ugdm.ndev}x{ugdm.n_own}) must match the "
                f"staged column count {ncol}; stage CLM arrays through "
                "ugdm.natural_to_sharded")
        ugdm = ugdm.to(device)
    full = lambda v: np.broadcast_to(np.asarray(v, np.float64), (ncol, nz))
    hksat, bsw, sucsat, residual_sat = (full(hksat), full(bsw),
                                        full(sucsat), full(residual_sat))
    dz = full(dz).copy()
    area = np.broadcast_to(np.asarray(area, np.float64), (ncol,)).copy()

    mpp = _build_template_mpp(dz[0], area[0], satfunc_type, density_type,
                              watsat[0], hksat[0], bsw[0], sucsat[0],
                              residual_sat[0], lateral_connectivity,
                              include_seepage_bc)
    comp = compile_vsfm(mpp, linear_solver="direct")

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
                          include_seepage_bc=include_seepage_bc,
                          lateral_connectivity=lateral_connectivity,
                          lateral_conductance=lateral_conductance,
                          escalate_f64=escalate_f64, ugrid=ugrid,
                          ugdm=ugdm, group=device_mesh)


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


def _cell_kr(prob: ALMVSFMProblem, P):
    """Relative permeability [ncol, nz] of state P."""
    return prob.comp.goveqns[0]._cell_aux(P, prob.dyn[0])[2]


def _lateral_source(prob: ALMVSFMProblem, P):
    """Operator-split lateral flux [kmol/s] per cell (Driver:465-532,
    'source_sink'), in P's dtype: with a UGDM the per-level lateral Darcy
    flux over its edges (x-directional permeability), else the ring
    stencil over the column axis with edge-replicated neighbours; over
    the problem's group, with the neighbours' columns exchanged."""
    if prob.ugdm is not None:
        dz = prob.const(("dz", P.dtype), lambda: torch.as_tensor(
            prob.dz, dtype=P.dtype, device=P.device))
        return prob.ugdm.lateral_darcy_source(
            P, _cell_kr(prob, P), prob.dyn[0]["perm"][..., 0], dz,
            group=prob.group)
    if prob.group is not None:
        return lateral_flux_op_split(P, prob.lateral_conductance,
                                     prob.group)
    left = torch.cat([P[:1], P[:-1]], dim=0)
    right = torch.cat([P[1:], P[-1:]], dim=0)
    return -prob.lateral_conductance * ((P - left) + (P - right))


def _all_ranks(prob: ALMVSFMProblem, worst):
    """``worst`` (f64 numpy) reduced over the problem's group by MAX: one
    all_reduce, so that every rank acts on the same values (without a
    group, ``worst`` itself)."""
    if prob.group is None:
        return worst
    t = torch.as_tensor(worst, dtype=F64, device=prob.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=prob.group.group)
    return t.cpu().numpy()


def _ladder_diag(prob: ALMVSFMProblem, diag):
    """The attempt's diagnostics over all ranks: every column converged,
    the largest audit error and Newton iterations, any FNORM / SNORM
    relative."""
    if prob.group is None:
        return diag
    worst = diag.copy()
    worst[0] = 1.0 - worst[0]
    worst = _all_ranks(prob, worst)
    worst[0] = 1.0 - worst[0]
    return worst


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
    qflx_lateral = torch.zeros(ncol, dtype=F64, device=dev)
    if "Lateral_flux" in parts:
        lat_kg = _lateral_source(prob, P_prev).to(F64) * FMWH2O
        parts["Lateral_flux"] = lat_kg
        # qflx_lateral = -sum(mflx)/conv (Driver:522-523), mm/s
        qflx_lateral = -lat_kg.sum(dim=1) / conv
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

    diag = torch.stack([
        torch.all(done).to(F64), err.max(),
        torch.tensor(float(iters), dtype=F64, device=dev),
        torch.any(done & (reason == CONVERGED_FNORM_RELATIVE)).to(F64),
        torch.any(done & (reason == CONVERGED_SNORM_RELATIVE)).to(F64)])
    return {"P": X, "done": done, "reason": reason, "err": err,
            "diag": diag, "mass_beg": mass_beg,
            "total_flux_col": total_flux_col, "ss": ss, "bc": bc,
            "S_end": S_end, "bflux": bflux,
            **_unpack(prob, X, dyn, frac_ice, bflux),
            "qflx_lateral": qflx_lateral,
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
    [ncol, nz] (stages frac_liq = 1 - frac_ice).  f32 state with
    ``escalate_f64`` re-solves the columns that fail the audit twice (or
    that diverge twice) in f64; ``escalated_cols`` counts them.

    Returns a dict of CLM-facing outputs (h2osoi_liq/ice [kg/m^2], smp_l
    [mm], zwt [m], qflx_lateral/qflx_seepage [mm/s], soilp [Pa]) and
    solver diagnostics (attempts, diverged_count, mass_bal_err_count,
    abs_mass_error_col, escalated_cols, newton_iters, the per-column
    SNES reason of the last solve, and the host
    synchronisations of the step as host_round_trips_per_step)."""
    with _ALM_STEP:
        return _step(prob, dtime, qflx_infl, qflx_tran_veg, rootr,
                     qflx_dew, qflx_sub_snow, qflx_drain, mflx_snowlyr,
                     t_soil, frac_ice)


def _step(prob, dtime, qflx_infl, qflx_tran_veg, rootr, qflx_dew,
          qflx_sub_snow, qflx_drain, mflx_snowlyr, t_soil, frac_ice):
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
    # iterate toward the f64-audited threshold (KNOWN_GAPS #9); those
    # columns go through the f64 escalation instead
    gate = 0.5 * MAX_ABS_MASS_ERROR_COL if dtype == F64 else 0.0
    escalate = dtype != F64 and prob.escalate_f64

    def escalation_dyn():
        dyn_g = dict(dyn_base)
        dyn_g["temperature"] = temperature
        dyn_g["frac_liq"] = torch.ones((ncol, nz), dtype=dtype, device=dev) \
            if reset_fl else frac_liq
        return (dyn_g,)

    P_prev = prob.P
    attempts = diverged_count = mass_bal_err_count = 0
    escalated_cols = 0
    abs_mass_error = np.inf
    reset_fl = False
    while True:
        attempts += 1
        out = _attempt(prob, P_prev, dyn_base, temperature, frac_liq,
                       frac_ice, forcing, reset_fl, rtol, stol, gate, dtime)
        diag = _ladder_diag(prob, comp._sync(out["diag"]))
        converged = bool(diag[0])
        P = out["P"]
        if not converged:
            # Driver:650-667: alternate stol; after the 2nd divergence
            # reset frac_liq to 1
            stol = STOL_ALTERNATE
            diverged_count += 1
            if diverged_count > 1:
                reset_fl = True
                if escalate:
                    # the stiff f32 tail cannot converge at this dt:
                    # re-solve the unconverged columns in f64
                    err_stub = np.where(out["done"].cpu().numpy(), 0.0,
                                        np.inf)
                    P, err_np, nesc = _escalate_f64(
                        prob, P_prev, P, out["bc"], out["ss"],
                        escalation_dyn(), err_stub, dtime,
                        out["total_flux_col"].cpu().numpy())
                    escalated_cols += nesc
                    worst = float(_all_ranks(prob, np.array(
                        [np.max(err_np, initial=0.0)]))[0])
                    if np.isfinite(worst):
                        abs_mass_error = worst
                        if abs_mass_error < prob.audit_threshold_kg:
                            break
        else:
            err_np = None
            if _audit_err is not _AUDIT_ERR_DEFAULT:
                # failure-injection seam of the tests
                err_np = _audit_err(prob, P, out["bc"], None,
                                    out["mass_beg"].cpu().numpy(),
                                    out["total_flux_col"].cpu().numpy(),
                                    dtime, (out["S_end"], out["bflux"]))
                abs_mass_error = float(_all_ranks(prob, np.array(
                    [np.max(err_np)]))[0])
            else:
                abs_mass_error = float(diag[1])
            if abs_mass_error >= prob.audit_threshold_kg:
                mass_bal_err_count += 1
                if escalate and mass_bal_err_count >= 2:
                    # tightening below the f32 evaluation floor cannot
                    # help: escalate the failing columns to f64
                    if err_np is None:
                        err_np = out["err"].cpu().numpy()
                    P, err_np, nesc = _escalate_f64(
                        prob, P_prev, P, out["bc"], out["ss"],
                        escalation_dyn(), err_np, dtime,
                        out["total_flux_col"].cpu().numpy())
                    escalated_cols += nesc
                    abs_mass_error = float(_all_ranks(prob, np.array(
                        [err_np.max()]))[0])
                    if abs_mass_error < prob.audit_threshold_kg:
                        break
                else:
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
    syncs = comp.host_syncs - syncs0
    if escalated_cols:
        # escalation replaced column states: the CLM unpack again, at the
        # final state
        dyn = escalation_dyn()
        bflux = comp.column_bc_flux(P.to(F64), (out["bc"].to(F64),),
                                    _to64(dyn))
        out = dict(out, **_unpack(prob, P, dyn, frac_ice, bflux))
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
        "escalated_cols": escalated_cols,
        "newton_iters": int(diag[2]),
        "reason": out["reason"],
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


def _escalate_f64(prob, P_prev, P, bc, ss, dyn, err, dtime, total_flux_col):
    """Gather the columns whose audit error ``err`` (numpy [ncol]) is at or
    above the threshold, re-solve them from the pre-step state in f64 on
    the same stepper at rtol 1e-10 / stol 1e-12, re-audit them in f64 and
    scatter back the ones that converged.  Returns (P, err, number of
    failing columns); P keeps its dtype.

    The gather is padded to the next power of two by repeating its last
    column (the JAX package's bound on recompiles), so the solved batch
    is the one the JAX driver solves."""
    comp = prob.comp
    fail = np.nonzero(err >= prob.audit_threshold_kg)[0]
    if fail.size == 0:
        return P, err, 0
    cap = 1 << int(np.ceil(np.log2(fail.size)))
    idx = torch.as_tensor(np.pad(fail, (0, cap - fail.size), mode="edge"),
                          device=P.device)
    gather = lambda a: a[idx].to(F64)
    dyn64 = (_take_tree(dyn[0], gather),)
    P0 = gather(P_prev)
    bc64, ss64 = gather(bc), gather(ss)
    # tight f64 tolerances: the escalated columns land well under the
    # audit threshold (the default 1e-8 leaves ~1e-8 kg of Newton
    # truncation)
    X64, _, ok64, _ = comp.step_batched(P0, (bc64,), (ss64,), dtime,
                                        dyn=dyn64, rtol=1e-10, stol=1e-12)
    mass_beg64 = comp.column_storage(P0, dyn64).cpu().numpy() * FMWH2O
    err64 = _audit_err(prob, X64, bc64, dyn64, mass_beg64,
                       np.asarray(total_flux_col)[idx.cpu().numpy()], dtime)
    sel = ok64[:fail.size].cpu().numpy()
    err_new = err.copy()
    err_new[fail[sel]] = err64[:fail.size][sel]
    rows = torch.as_tensor(fail[sel], device=P.device)
    P_new = P.index_copy(0, rows, X64[:fail.size][torch.as_tensor(
        sel, device=P.device)].to(P.dtype))
    return P_new, err_new, int(fail.size)


def _take_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _take_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unpack(prob, P, dyn, frac_ice, bflux):
    """The CLM unpack (Driver:700-900) of state P whose boundary flux is
    ``bflux`` [kmol/s, f64]: h2osoi_liq/ice, smp_l, zwt, qflx_seepage."""
    area, zi = prob.consts["area"], prob.consts["zi"]
    mass_cell = prob.comp.goveqns[0].accum(P, dyn=dyn[0]) * FMWH2O
    smp_l = (P - PRESSURE_REF) / (DENH2O * GRAVITY_CONSTANT) * 1e3
    return {"mass_cell": mass_cell, "smp_l": smp_l,
            "h2osoi_liq": (1.0 - frac_ice) * mass_cell / area[:, None],
            "h2osoi_ice": frac_ice * mass_cell / area[:, None],
            "zwt": _water_table_depth(smp_l, zi),
            "qflx_seepage": bflux * FMWH2O / (area * DENH2O * 1e-3)}

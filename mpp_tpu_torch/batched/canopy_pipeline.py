"""Batched end-to-end canopy pipeline: the ml_model substep loop over
[ncair] columns — the production path of the coupled canopy system.

Counterpart of ``mpp_tpu/batched/canopy_pipeline.py``.  Reproduces the
operator-split orchestration of
``driver/standalone/ml_model/ml_model_problem.F90:377-409``:

  shortwave (hourly, re-solved per forcing record)
  -> per substep: longwave -> leaf boundary layer -> photosynthesis ->
     multi-layer canopy (turbulence presolve + coupled T/q/Tleaf solve)

with the inter-MPP data plumbing of ``ml_model/{swv,lwv,lbl,
photosynthesis,mlc}.F90`` (absorbed radiation -> leaf net radiation,
boundary-layer conductances -> photosynthesis & canopy exchange, stomatal
conductance -> transpiration, canopy-top state -> next Obukhov iterate).

Every stage is eager PyTorch on the pipeline's device (the card unless
``device="cpu"``): longwave and MLC solve through the batched
block-Thomas sweep (m = 3 and m = 4; ``ops/block_structure.block_solve``),
one launch each of the ``block_thomas_small`` kernel on the card (the JAX
package's ``lax.scan`` sweeps), photosynthesis through the batched masked
Newton, turbulence through the batched Obukhov solve.  The two
masked loops read one device scalar on the host an iteration; the
pipeline counts those reads (``host_syncs``) and the loops' iterations.

The longwave and LBL staging arrays are f64 and the photosynthesis
parameters f64, as in the JAX form, so an f32 pipeline computes those
stages in f64 by promotion; each stage's outputs are pinned to the
pipeline dtype, and the state stays in it end to end.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mpp_tpu_torch.constants import (Cond, MM_H2O, MM_DRY_AIR, MPPType)
from mpp_tpu_torch.batched import turbulence as bt
from mpp_tpu_torch.batched import mlc as bmlc
from mpp_tpu_torch.batched import photosynthesis as bp
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.dtypes.conditions import Condition
from mpp_tpu_torch.models import photosynthesis as ph
from mpp_tpu_torch.models.canopy_turbulence import CanopyTurbulenceAuxVar
from mpp_tpu_torch.models.lbl import LeafBoundaryLayerGE
from mpp_tpu_torch.models.radiation import LongwaveGE, ShortwaveMPP
from mpp_tpu_torch.ops.block_structure import BlockTridiagTemplate
from mpp_tpu_torch.problems import mlc as mlc_problem
from mpp_tpu_torch.problems.canopy_radiation import canopy_mesh, \
    _top_bc_conns
from mpp_tpu_torch.problems.ml_model import (compute_kb,
                                             compute_transmittance,
                                             synthetic_diurnal_bc)
from mpp_tpu_torch.problems.photosynthesis import _canopy_mesh, \
    _set_soil_parameters


class CanopyState(NamedTuple):
    """Per-column prognostic state ([ncair, nlev]; level 0 = ground)."""
    T_air: torch.Tensor
    q_air: torch.Tensor
    T_sun: torch.Tensor
    T_shd: torch.Tensor


class Forcing(NamedTuple):
    """Hourly forcing record, the stages' inputs on the device (the
    reference re-reads BCs and re-solves shortwave every hour,
    ml_model_problem.F90:375-382).  Scalars are 0-d tensors in the
    pipeline dtype.  Built by :meth:`CanopyPipeline.make_forcing`."""
    apar_sun: torch.Tensor        # [nc, nlev] absorbed PAR per leaf area
    apar_shd: torch.Tensor
    rn_sw_sun: torch.Tensor       # [nc, nlev] absorbed shortwave
    rn_sw_shd: torch.Tensor
    isoil_sw: torch.Tensor        # scalar
    fssh_lev: torch.Tensor        # [nlev] sunlit fraction
    lw_trans: torch.Tensor        # [nc*nlev] longwave layer transmittance
    irsky: torch.Tensor           # scalar sky longwave
    tref: torch.Tensor            # scalars: atmospheric forcing
    qref: torch.Tensor
    uref: torch.Tensor
    thref: torch.Tensor
    bc_q: torch.Tensor
    cpair: torch.Tensor
    rhomol: torch.Tensor
    soil_T: torch.Tensor


def _fields(record, names):
    """The arrays of ``record``, a sequence in ``names`` order (the JAX
    package's NamedTuple of the same name is one), as writable numpy."""
    if len(record) != len(names):
        raise ValueError(f"expected {len(names)} fields {names}, got "
                         f"{len(record)}")
    return [np.array(a) for a in record]


def canopy_state_from_numpy(state, device="cuda", dtype=torch.float64) \
        -> CanopyState:
    """A :class:`CanopyState` from numpy-convertible fields in its field
    order (the JAX package's ``CanopyState``, for one), on ``device`` (the
    card unless ``device="cpu"``) in ``dtype``."""
    device = device_of(device)
    return CanopyState(*(torch.as_tensor(a, dtype=dtype, device=device)
                         for a in _fields(state, CanopyState._fields)))


def forcing_from_numpy(forcing, device="cuda", dtype=torch.float64) \
        -> Forcing:
    """A :class:`Forcing` from numpy-convertible fields in its field order
    (the JAX package's ``Forcing``, for one), on ``device`` in ``dtype``."""
    device = device_of(device)
    return Forcing(*(torch.as_tensor(a, dtype=dtype, device=device)
                     for a in _fields(forcing, Forcing._fields)))


class CanopyPipeline:
    """Build once, then call ``substep`` (or the staged callables).

    Forcing/canopy structure come from the mlc + ml_model reference test
    problems (mlc_parameters.F90, ml_model BCs), broadcast over ncair.
    ``host_syncs``, ``hybrid_iterations`` and ``psy_iterations`` count,
    since construction, the host reads of device predicates and the two
    masked loops' iterations."""

    def __init__(self, ncair: int, nz_cair: int = 92, dtype=torch.float64,
                 device="cuda"):
        self.device = device_of(device)
        self.ncair = nc = int(ncair)
        self.nz_cair = nz_cair
        self.nlev = nlev = nz_cair + 1
        self.dtype = dt = dtype
        dev = self.device
        self.host_syncs = 0
        self.hybrid_iterations = 0
        self.psy_iterations = 0

        dpai, _ = mlc_problem.get_dpai_fssh()
        self.dpai_lev = np.asarray(dpai[1:nlev + 1])        # [nlev], lev 0 soil
        dpai_pos = self.dpai_lev > 0.0
        f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                        device=dev)

        # --- forcing (mlc_parameters.F90 + ml_model synthetic BCs)
        self.pref = 98620.0
        self.uref = 5.169
        self.tref = 295.9349938964844
        self.qref = 0.01
        self.irsky = 400.0
        self.soil_T_forcing = 294.8492736816406
        self.soil_res = 3361.509423807650
        self.soil_rhg = 0.9984057411945876
        self.soil_tk = 1.261326601469150
        self.soil_dz = 7.1006354171935350e-3
        self.co2ref, self.o2ref = 380.0, 0.209 * 1000.0

        # turbulence static pieces (zs grid + derived scalars)
        ct = self._turbulence_aux(self.uref, self.tref, self.qref)
        self.zs = np.asarray(ct.zs)
        self.zs_b = f64(self.zs[0]).expand(nc, nlev)
        self.ntop = int(ct.ntop[0])
        self.thref = float(ct.thref[0])
        self.eref = float(ct.eref[0])
        self.cpair0 = float(ct.cpair[0])
        self.rhomol0 = float(ct.rhomol[0])
        self.tables = bt.load_psihat_tables(dev, dt)

        # --- shortwave facade problem (re-solved per forcing record)
        self._build_shortwave()
        self.default_forcing = self.make_forcing()

        # --- longwave GE + block template at [ncair] columns
        dz_cair = 46.0 / self.nz_cair
        lw = LongwaveGE(name="lw", mesh=canopy_mesh(self.nz_cair, ncair=nc),
                        nleaf=2, device=dev)
        lw.boundary_conditions = []
        cond = Condition(name="sky", units="W/m2", itype=int(Cond.DIRICHLET),
                         conn_set=_top_bc_conns(self.nz_cair, nc, dz_cair))
        cond.ensure_value()
        lw.boundary_conditions.append(cond)
        lw.allocate_auxvars()
        n = nc * nlev
        emleaf, emgrnd = 0.98, 0.96
        is_soil_n = np.zeros(n, bool)
        is_soil_n[0::nlev] = True
        lw.is_soil = is_soil_n
        lw.trans = self.default_forcing.lw_trans
        full64 = lambda shape, v: torch.full(shape, v, dtype=torch.float64,
                                             device=dev)
        lw.leaf_rho = full64((n,), 1.0 - emleaf)
        lw.leaf_tau = full64((n,), 0.0)
        lw.leaf_emiss = full64((n,), emleaf)
        gem = np.zeros(n)
        gem[0::nlev] = emgrnd
        lw.ground_emiss = f64(gem)
        dpai_n = np.tile(self.dpai_lev, nc)
        lw.leaf_dpai = f64(np.stack([dpai_n] * 2, axis=1))
        lw.bc_Idn = full64((nc,), self.irsky)
        r, c = lw.coo_coords()
        self.lw = lw
        self.lw_tpl = BlockTridiagTemplate(nc, nlev, lw.dof, r, c)

        # --- leaf boundary layer GE (2*nlev leaf cells per column: sun+shd)
        lbl_mesh = canopy_mesh(self.nz_cair, ncair=2 * nc)
        self.lbl = LeafBoundaryLayerGE(name="lbl", mesh=lbl_mesh, device=dev)
        self.lbl.allocate_auxvars()
        self.lbl.dleaf = full64((2 * n,), 0.04)

        # --- photosynthesis: a real facade problem (the 8-step MPP setup) whose
        # compiled form is the psy stage — one physics stack for the
        # golden configs and the production pipeline.
        # 2*n cells: [sun | shd] leaf lanes per canopy level.
        psy_mpp = ph.PhotosynthesisMPP()
        psy_mpp.set_name("Photosynthesis model")
        psy_mpp.set_id(MPPType.PHOTOSYNTHESIS_SNES)
        psy_mpp.set_num_meshes(1)
        psy_mpp.add_mesh(_canopy_mesh(ncair=2 * nc, ntree=1,
                                      nz_cair=self.nz_cair))
        psy_mpp.add_goveqn()
        psy_mpp.allocate_auxvars(ph.PATHWAY_C3, ph.SCM_MEDLYN)
        psy_mpp.setup_problem()
        av = psy_mpp.soe.ge.avars
        av.pref[:] = self.pref
        av.cair[:] = self.co2ref
        av.o2ref[:] = self.o2ref
        av.btran[:] = 1.0
        av.dpai[:] = np.tile(dpai_n, 2)
        av.root_biomass[:] = 500.0
        av.root_radius[:] = 0.29e-3
        av.root_density[:] = 0.31e6
        av.root_resist[:] = 25.0
        _set_soil_parameters(av)
        av.leaf_psi[:] = -1.5
        av.leaf_height[:] = 15.0
        av.leaf_capc[:] = 2500.0
        av.leaf_minlwp[:] = -2.0
        av.leaf_lai[:] = 500.0
        av.k_stem2leaf[:] = 4.0
        self.psy_mpp = psy_mpp
        self.psy = bp.compile_photosynthesis(psy_mpp, dev)
        self.psy_cfg = self.psy.cfg
        _, self._psy_params0 = bp.params_from_auxvars(av, dev)

        # --- MLC static block-input pieces
        full = lambda shape, v: torch.full(shape, v, dtype=dt, device=dev)
        dpai_pos_t = torch.as_tensor(dpai_pos, device=dev)
        fssh_lev = self.default_forcing.fssh_lev
        self.mlc_static = dict(
            cpair=full((nc,), self.cpair0),
            rhomol=full((nc,), self.rhomol0),
            pref=full((nc,), self.pref),
            leaf_cpair=torch.tensor(self.cpair0, dtype=dt, device=dev),
            leaf_pref=torch.tensor(self.pref, dtype=dt, device=dev),
            soil_rhg=full((nc,), self.soil_rhg),
            soil_tk=full((nc,), self.soil_tk),
            soil_dz=full((nc,), self.soil_dz),
            soil_res=full((nc,), self.soil_res),
            soil_T=full((nc,), self.soil_T_forcing),
            leaf_fwet=full((nc, nlev, 2), 0.0),
            leaf_fdry=f64(np.where(dpai_pos, mlc_problem.FDRY, 0.0))
            .to(dt).expand(nc, nlev)[..., None].repeat(1, 1, 2),
            leaf_fssh=torch.stack([fssh_lev.expand(nc, nlev),
                                   (1.0 - fssh_lev).expand(nc, nlev)],
                                  dim=-1).to(dt),
            leaf_dpai=f64(self.dpai_lev).to(dt).expand(nc, nlev)[..., None]
            .repeat(1, 1, 2),
            leaf_cp=full((nc, nlev, 2), mlc_problem.CP_LEAF),
            bc_T=full((nc,), self.thref),
            bc_q=full((nc,), self.eref / self.pref),
            vol_air=torch.tensor(46.0 / self.nz_cair, dtype=dt, device=dev),
        )
        self.dpai_pos = dpai_pos_t
        self.dpai_b = f64(self.dpai_lev).expand(nc, nlev)

    # ------------------------------------------------------------------
    def _sync(self, value):
        """Read a 0-d device tensor on the host (counted)."""
        self.host_syncs += 1
        return value.item()

    def _turbulence_aux(self, uref, tref, qref) -> CanopyTurbulenceAuxVar:
        """The host turbulence aux var of one forcing record, with its
        derived atmospheric inputs."""
        ct = CanopyTurbulenceAuxVar(1, self.nlev)
        ct.pai[0] = mlc_problem.PAI
        ct.hc[0] = mlc_problem.HC
        ct.zref[0] = 46.0
        ct.pref[0] = self.pref
        ct.uref[0] = uref
        ct.tref[0] = tref
        ct.qref[0] = qref
        ct.compute_derived_atm_inputs(0)
        return ct

    def _build_shortwave(self):
        """The ncair=1 shortwave facade problem (swv.F90 parameters) on the
        pipeline's device; solved per forcing record by
        :meth:`solve_shortwave`."""
        nlev = self.nlev
        dev = self.device
        sw = ShortwaveMPP(device=dev)
        sw.add_mesh(canopy_mesh(self.nz_cair, ncair=1))
        ieqn = sw.add_goveqn("shortwave")
        dz_cair = 46.0 / self.nz_cair
        sw.add_condition_in_goveqn(ieqn, Cond.BC, "sky", "W/m2",
                                   Cond.DIRICHLET,
                                   conn_set=_top_bc_conns(self.nz_cair, 1,
                                                          dz_cair))
        sw.allocate_auxvars()
        ge = sw.goveqns[0]
        n1 = nlev
        dpai_pos = self.dpai_lev > 0.0
        is_soil = np.zeros(n1, bool)
        is_soil[0] = True
        ge.is_soil = is_soil
        f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                        device=dev)
        ge.leaf_rho = f64(np.where(dpai_pos[:, None], [[0.10, 0.45]], 1e-6))
        ge.leaf_tau = f64(np.where(dpai_pos[:, None], [[0.05, 0.25]], 1e-6))
        ge.leaf_omega = ge.leaf_rho + ge.leaf_tau
        ge.leaf_dpai = f64(self.dpai_lev)
        ge.soil_albedo_b = f64(np.tile([[0.1, 0.2]], (n1, 1)))
        ge.soil_albedo_d = f64(np.tile([[0.1, 0.2]], (n1, 1)))
        self.sw = sw

    def solve_shortwave(self, sza=0.5, iskyb=(320.0, 320.0),
                        iskyd=(20.0, 20.0)):
        """Re-solve the shortwave problem for a sun angle / sky forcing
        (solve_swv, ml_model_problem.F90:375-382 + swv.F90:188-273) on the
        pipeline's device.  Returns (apar_sun, apar_shd, rn_sun, rn_shd,
        isoil) as f64 tensors ([nlev] and 0-d), then (fssh, td) as [nlev]
        numpy; the caller broadcasts them over the columns."""
        nlev = self.nlev
        dev = self.device
        dpai_pos = self.dpai_lev > 0.0
        xl = 0.25
        _, _, kb = compute_kb(xl, sza)
        tb_lev = np.ones(nlev)
        td_lev = np.ones(nlev)
        for k in range(nlev):
            tb_lev[k], td_lev[k] = compute_transmittance(
                xl, sza, float(self.dpai_lev[k]), 1.0)
        cumpai_above = np.concatenate(
            [np.cumsum(self.dpai_lev[::-1])[::-1][1:], [0.0]])
        leaf_tbcum = np.exp(-kb * cumpai_above)
        sumpai_mid = cumpai_above + 0.5 * self.dpai_lev
        fssh_lev = np.where(dpai_pos, np.exp(-kb * sumpai_mid), 0.0)
        ge = self.sw.goveqns[0]
        n1 = nlev
        f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                        device=dev)
        ge.leaf_td = f64(td_lev)
        ge.leaf_tb = f64(tb_lev)
        ge.leaf_tbcum = f64(leaf_tbcum)
        ge.leaf_fssh = f64(np.stack([fssh_lev, 1.0 - fssh_lev], axis=1))
        iskyb = np.asarray(iskyb, np.float64)
        iskyd = np.asarray(iskyd, np.float64)
        ge.Iskyb = f64(np.tile(iskyb, (n1, 1)))
        ge.Iskyd = f64(np.tile(iskyd, (n1, 1)))
        ge.bc_Iskyb = f64(iskyb[None, :])
        ge.bc_Iskyd = f64(iskyd[None, :])
        ok, _ = self.sw.step_dt(0.0)
        if not ok:
            raise RuntimeError("shortwave solve diverged")
        ge.post_solve()
        iabs = ge.Iabs_leaf
        return (iabs[:, 0] * 4.6, iabs[:, 1] * 4.6,
                iabs[:, 0] + iabs[:, 2], iabs[:, 1] + iabs[:, 3],
                ge.Iabs_soil[0].sum(), fssh_lev, td_lev)

    def make_forcing(self, sza=0.5, iskyb=(320.0, 320.0),
                     iskyd=(20.0, 20.0), irsky=None, tref=None, qref=None,
                     uref=None, soil_T=None) -> Forcing:
        """One hourly :class:`Forcing` record: re-solves shortwave and
        derives the turbulence reference-state scalars."""
        nc, nlev, dt, dev = self.ncair, self.nlev, self.dtype, self.device
        irsky = self.irsky if irsky is None else irsky
        tref = self.tref if tref is None else tref
        qref = self.qref if qref is None else qref
        uref = self.uref if uref is None else uref
        soil_T = self.soil_T_forcing if soil_T is None else soil_T
        ap_s, ap_h, rn_s, rn_h, isoil, fssh, td = self.solve_shortwave(
            sza, iskyb, iskyd)
        ct = self._turbulence_aux(uref, tref, qref)
        sc = lambda v: torch.tensor(float(v), dtype=dt, device=dev)
        bcast = lambda v: v.to(dt).expand(nc, nlev)
        return Forcing(
            apar_sun=bcast(ap_s), apar_shd=bcast(ap_h),
            rn_sw_sun=bcast(rn_s), rn_sw_shd=bcast(rn_h),
            isoil_sw=isoil.to(dt),
            fssh_lev=torch.as_tensor(fssh, dtype=dt, device=dev),
            lw_trans=torch.as_tensor(np.tile(td, nc), dtype=dt, device=dev),
            irsky=sc(irsky), tref=sc(tref), qref=sc(qref), uref=sc(uref),
            thref=sc(ct.thref[0]),
            bc_q=sc(float(ct.eref[0]) / self.pref),
            cpair=sc(ct.cpair[0]), rhomol=sc(ct.rhomol[0]),
            soil_T=sc(soil_T))

    def forcing_from_bc(self, bc) -> Forcing:
        """Forcing from an ml_model hourly BC record
        (problems/ml_model.MLBoundaryConditions, e.g.
        synthetic_diurnal_bc)."""
        return self.make_forcing(
            sza=bc.sza, iskyb=(bc.iskyb_vis, bc.iskyb_nir),
            iskyd=(bc.iskyd_vis, bc.iskyd_nir), irsky=bc.irsky,
            tref=bc.tref, qref=bc.qref, uref=bc.uref, soil_T=bc.soil_t)

    def initial_state(self) -> CanopyState:
        nc, nlev = self.ncair, self.nlev
        T0 = torch.full((nc, nlev), self.tref, dtype=self.dtype,
                        device=self.device)
        q0 = torch.full((nc, nlev), self.qref, dtype=self.dtype,
                        device=self.device)
        return CanopyState(T_air=T0, q_air=q0, T_sun=T0, T_shd=T0)

    def substep(self, state: CanopyState, dt=300.0,
                forcing: Forcing = None) -> CanopyState:
        """One operator-split substep (lwv -> lbl -> psy -> mlc)
        (ml_model_problem.F90:388-409).  ``forcing`` defaults to the
        build-time (midday) record; the diurnal loop passes the hourly
        record."""
        if forcing is None:
            forcing = self.default_forcing
        pre = self._stage_pre(state, forcing)
        gs2 = self._stage_psy(state, pre, forcing)
        return self._stage_mlc(state, pre, gs2, forcing, dt)

    def staged_substep_fns(self):
        """The three stages as callables (pre = turbulence + longwave +
        LBL, psy = photosynthesis Newton, mlc = canopy block solve), for
        :meth:`run_staged`; every intermediate stays on the device."""
        return (self._stage_pre, self._stage_psy, self._stage_mlc)

    def fused_hour_fn(self, nsubstep=12, dt=300.0):
        """A callable advancing a whole hourly record's ``nsubstep``
        substeps (the reference's isubstep loop,
        ml_model_problem.F90:384-409): ``hour(state, forcing)``.  The
        same substep composition as :meth:`run_staged`."""
        def hour(state, forcing):
            for _ in range(nsubstep):
                state = self.substep(state, dt, forcing)
            return state
        return hour

    def run_staged(self, fns, state: CanopyState, dt=300.0,
                   forcing: Forcing = None) -> CanopyState:
        if forcing is None:
            forcing = self.default_forcing
        pre = fns[0](state, forcing)
        gs2 = fns[1](state, pre, forcing)
        return fns[2](state, pre, gs2, forcing, dt)

    def _stage_pre(self, state: CanopyState, forcing: Forcing):
        nc, nlev = self.ncair, self.nlev
        dtype = self.dtype

        # canopy-top state feeds the Obukhov iterate (mlc.F90:447-506)
        tcan = state.T_air[:, self.ntop - 1]
        q_top = state.q_air[:, self.ntop - 1]
        eair_top = q_top * self.pref
        factor = (MM_H2O / MM_DRY_AIR) / (
            self.pref - (1.0 - MM_H2O / MM_DRY_AIR) * eair_top)
        qcan = eair_top * factor

        ones = torch.ones(nc, dtype=dtype, device=self.device)
        tinp = bt.derive_inputs(
            hc=mlc_problem.HC * ones, zref=46.0 * ones,
            pref=self.pref * ones, uref=forcing.uref * ones,
            qref=forcing.qref * ones, tref=forcing.tref * ones,
            tcan=tcan, qcan=qcan, pai=mlc_problem.PAI * ones)
        taux, wind, ga, iters = bt.presolve(self.tables, tinp, self.zs_b,
                                            self.ntop, sync=self._sync)
        self.hybrid_iterations += iters

        # ---- longwave (block solve) -----------------------------------
        lw = self.lw
        gt = torch.zeros_like(state.T_air)
        gt[:, 0] = state.T_air[:, 0]
        lw.ground_temperature = gt.reshape(-1)
        lw.leaf_temperature = torch.stack(
            [state.T_sun.reshape(-1), state.T_shd.reshape(-1)], dim=1)
        fssh_b = forcing.fssh_lev.expand(nc, nlev)
        lw.leaf_fssh = torch.stack(
            [fssh_b.reshape(-1), (1.0 - fssh_b).reshape(-1)], dim=1)
        lw.trans = forcing.lw_trans
        lw.bc_Idn = forcing.irsky.expand(nc)
        x_lw = self.lw_tpl.solve(lw.matrix_values(), lw.rhs())
        iabs_lw = x_lw[..., 2]                       # [nc, nlev]
        dpai_b = self.dpai_b
        labs = torch.where(self.dpai_pos,
                           iabs_lw / torch.where(dpai_b == 0, 1.0, dpai_b),
                           0.0)
        labs_soil = iabs_lw[:, 0]

        # ---- leaf boundary layer --------------------------------------
        lbl = self.lbl
        tleaf2 = torch.cat([state.T_sun.reshape(-1),
                            state.T_shd.reshape(-1)])
        tair2 = state.T_air.reshape(-1).repeat(2)
        wind2 = wind.reshape(-1).repeat(2)
        lbl.tleaf, lbl.tair, lbl.wind = tleaf2, tair2, wind2
        lbl.pref = torch.full((2 * nc * nlev,), self.pref, dtype=dtype,
                              device=self.device)
        lbl.tref = torch.ones(2 * nc * nlev, dtype=dtype,
                              device=self.device) * forcing.tref
        lbl.compute()
        gbh2, gbv2, gbc2 = lbl.gbh, lbl.gbv, lbl.gbc
        # the longwave/LBL staging arrays are f64: pin the stage boundary
        # to the pipeline dtype so f32 runs stay f32 end to end
        return tuple(a.to(dtype) for a in
                     (ga, labs, labs_soil, gbh2, gbv2, gbc2, tleaf2))

    def _stage_psy(self, state: CanopyState, pre, forcing: Forcing):
        nc, nlev = self.ncair, self.nlev
        dtype = self.dtype
        ga, labs, labs_soil, gbh2, gbv2, gbc2, tleaf2 = pre

        # ---- photosynthesis (batched masked Newton) --------------------
        eair_lev = (state.q_air * self.pref).reshape(-1).repeat(2)
        # absorbed PAR per leaf area from the shortwave stage, stacked
        # [sun | shd] like tleaf2 (ml_model photosynthesis.F90 staging:
        # av.apar = ileaf_vis * 4.6, solve_photosynthesis)
        apar2 = torch.cat([forcing.apar_sun.reshape(-1),
                           forcing.apar_shd.reshape(-1)]).to(dtype)
        p = self._psy_params0._replace(
            tleaf=tleaf2, gbv=gbv2, gbc=gbc2, eair=eair_lev, apar=apar2)
        x0 = torch.full((2 * nc * nlev, 1), 0.9 * self.co2ref, dtype=dtype,
                        device=self.device)
        res, bounded = bp.solve(self.psy_cfg, p, x0, sync=self._sync)
        self.psy_iterations += res.iters
        out = bp.post_solve(self.psy_cfg, p, res.x, bounded)
        return torch.where(bounded[:, 0], out.gs, ph.GS_MIN).to(dtype)

    def _stage_mlc(self, state: CanopyState, pre, gs2, forcing: Forcing,
                   dt=300.0):
        nc, nlev = self.ncair, self.nlev
        dtype = self.dtype
        ga, labs, labs_soil, gbh2, gbv2, gbc2, tleaf2 = pre
        n = nc * nlev
        gs_sun = gs2[:n].reshape(nc, nlev)
        gs_shd = gs2[n:].reshape(nc, nlev)

        # ---- MLC (block solve) -----------------------------------------
        gbh_sun = gbh2[:n].reshape(nc, nlev)
        gbh_shd = gbh2[n:].reshape(nc, nlev)
        gbv_sun = gbv2[:n].reshape(nc, nlev)
        gbv_shd = gbv2[n:].reshape(nc, nlev)
        rn_sun = forcing.rn_sw_sun + labs
        rn_shd = forcing.rn_sw_shd + labs
        soil_rn = forcing.isoil_sw + labs_soil

        ones_c = torch.ones(nc, dtype=dtype, device=self.device)
        fssh_b = forcing.fssh_lev.expand(nc, nlev)
        mlc_static = dict(self.mlc_static)
        mlc_static.update(
            cpair=forcing.cpair * ones_c,
            rhomol=forcing.rhomol * ones_c,
            leaf_cpair=forcing.cpair,
            soil_T=forcing.soil_T * ones_c,
            bc_T=forcing.thref * ones_c,
            bc_q=forcing.bc_q * ones_c,
            leaf_fssh=torch.stack([fssh_b, 1.0 - fssh_b],
                                  dim=-1).to(dtype))

        inp = bmlc.MLCBlockInputs(
            at_T=state.T_air, av_q=state.q_air,
            leaf_T=torch.stack([state.T_sun, state.T_shd], dim=-1),
            soil_rn=soil_rn,
            gbh_air=torch.stack([gbh_sun, gbh_shd], dim=-1),
            gbv_air=torch.stack([gbv_sun, gbv_shd], dim=-1),
            leaf_gs=torch.stack([gs_sun, gs_shd], dim=-1),
            leaf_gbh=torch.stack([gbh_sun, gbh_shd], dim=-1),
            leaf_gbv=torch.stack([gbv_sun, gbv_shd], dim=-1),
            leaf_rn=torch.stack([rn_sun, rn_shd], dim=-1),
            conn_ga=ga[:, :nlev - 1],
            bc_ga=ga[:, nlev - 1],
            **mlc_static)
        x = bmlc.step(inp, dt)

        return CanopyState(
            T_air=x[:, :, 0],      # level 0 = eliminated ground temperature
            q_air=x[:, :, 1],
            T_sun=torch.where(self.dpai_pos, x[:, :, 2], state.T_sun),
            T_shd=torch.where(self.dpai_pos, x[:, :, 3], state.T_shd))

    # ---- diurnal production loop (ml_model_problem.F90:372-417) --------
    def run_diurnal(self, state: CanopyState, beg_step=1, end_step=24,
                    nsubstep=12, bc_provider=None, checkpoint_dir=None):
        """The hourly istep / 300-s isubstep production loop: re-solve
        shortwave for each hourly BC record (solve_swv, ibid:375-382),
        advance ``nsubstep`` substeps with the hourly :class:`Forcing`
        through :meth:`fused_hour_fn`, checkpoint at each hour when
        ``checkpoint_dir`` is set (checkpoint_mlc,
        ml_model/mlc.F90:1006-1092).

        Returns (state, trajectory) where trajectory[istep] is the
        hour-end canopy-top (T_air, q_air) numpy snapshot."""
        if bc_provider is None:
            bc_provider = synthetic_diurnal_bc
        hour = self.fused_hour_fn(nsubstep=nsubstep)
        bc = None
        traj = {}
        for istep in range(beg_step, end_step + 1):
            bc = bc_provider(istep, bc)
            forcing = self.forcing_from_bc(bc)
            state = hour(state, forcing)
            traj[istep] = (state.T_air[:, self.ntop - 1].cpu().numpy(),
                           state.q_air[:, self.ntop - 1].cpu().numpy())
            if checkpoint_dir is not None:
                self.checkpoint(state, istep, nsubstep, checkpoint_dir)
        return state, traj

    def checkpoint(self, state: CanopyState, istep, isubstep,
                   directory=".") -> str:
        """Write the batched canopy state as a PetscViewer binary Vec
        (mlc_checkpoint.<step>.<substep>.bin layout: the four state
        fields concatenated, column-major like the reference's
        per-column records)."""
        from mpp_tpu_torch.io.petsc_vec import write_vec
        fname = f"{directory}/canopy_checkpoint.{istep}.{isubstep}.bin"
        flat = np.concatenate([a.cpu().numpy().astype(np.float64)
                               .reshape(-1) for a in state])
        write_vec(fname, flat)
        return fname

    def restore(self, fname: str) -> CanopyState:
        """Read a :meth:`checkpoint` file back into a CanopyState."""
        from mpp_tpu_torch.io.petsc_vec import read_vec
        flat = read_vec(fname)
        n = self.ncair * self.nlev
        if flat.size != 4 * n:
            raise ValueError(f"{fname}: checkpoint size {flat.size}, "
                             f"expected {4 * n}")
        return CanopyState(*(
            torch.as_tensor(flat[i * n:(i + 1) * n].reshape(
                self.ncair, self.nlev), dtype=self.dtype, device=self.device)
            for i in range(4)))

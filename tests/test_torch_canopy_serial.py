"""The port's batched canopy pipeline against the port's own serial
composition, on the CPU in f64: the counterpart of the JAX package's
parity harness (tests/test_canopy_pipeline.py:53-318).

Both advance the same initial state under the same hourly forcing record.
The serial substep is composed of the port's serial components: the host
turbulence (``models/canopy_turbulence``), the longwave KSP
(GMRES(30) + ILU(0), ``models/radiation._solve_ksp``), the leaf boundary
layer, the photosynthesis Newton (``models/photosynthesis``) and the MLC
facade (``models/mlc.MLCMPP``: its PreSolve, CSR assembly and PostSolve)
with an exact dense solve of the assembled system, since the pipeline's
block-Thomas solve is exact (GMRES's rtol-1e-5 stop would only measure
the Krylov band, ~5 mK).  Tolerances are JAX's
(tests/test_canopy_pipeline.py:294-298): 1e-5 K for the temperatures and
1e-8 for the air vapor after every substep (measured on the default and
morning records: 3.7e-9 K and 9e-13).
"""
import numpy as np
import pytest
import torch

from mpp_tpu_torch.batched.canopy_pipeline import CanopyPipeline
from mpp_tpu_torch.constants import MM_DRY_AIR, MM_H2O, MPPType
from mpp_tpu_torch.models import photosynthesis as ph
from mpp_tpu_torch.models.canopy_turbulence import (
    CanopyTurbulenceAuxVar, aerodynamic_conductances, obukhov_length,
    wind_profile)
from mpp_tpu_torch.models.mlc import MLCMPP
from mpp_tpu_torch.models.radiation import _solve_ksp
from mpp_tpu_torch.ops.sparse import csr_template
from mpp_tpu_torch.problems import mlc as mlc_problem
from mpp_tpu_torch.problems.photosynthesis import (_canopy_mesh,
                                                   _set_soil_parameters)

T_TOL, Q_TOL = 1e-5, 1e-8


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _serial_substep_fn(pipe, f, dt):
    """The serial composition with the pipeline's staging, under the
    forcing record ``f``."""
    nlev = pipe.nlev
    apar_sun, apar_shd = _np(f.apar_sun[0]), _np(f.apar_shd[0])
    rn_sw_sun, rn_sw_shd = _np(f.rn_sw_sun[0]), _np(f.rn_sw_shd[0])
    isoil_sw = float(f.isoil_sw)
    fssh = _np(f.fssh_lev)
    tref, qref, uref = float(f.tref), float(f.qref), float(f.uref)
    soil_T = float(f.soil_T)
    dpai = np.asarray(pipe.dpai_lev)
    dpai_pos = dpai > 0.0

    # serial photosynthesis MPP, staged like the pipeline's
    psy = ph.PhotosynthesisMPP()
    psy.set_id(MPPType.PHOTOSYNTHESIS_SNES)
    psy.add_mesh(_canopy_mesh(2, 1, pipe.nz_cair))   # 2*nlev leaf cells
    psy.add_goveqn()
    psy.allocate_auxvars(ph.PATHWAY_C3, ph.SCM_MEDLYN)
    psy.setup_problem()
    av = psy.soe.ge.avars
    av.pref[:] = pipe.pref
    av.cair[:] = pipe.co2ref
    av.o2ref[:] = pipe.o2ref
    av.btran[:] = 1.0
    av.dpai[:] = np.tile(dpai, 2)
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

    # the serial longwave CSR template over the pipeline GE's topology
    lw = pipe.lw
    r, c = lw.coo_coords()
    n_lw = lw.mesh.ncells_local * lw.dof
    lw_tpl = csr_template(n_lw, n_lw, r, c)
    lw_cache = {}
    lbl = pipe.lbl
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))

    def turbulence(ct, tcan, qcan):
        ct.pai[0] = mlc_problem.PAI
        ct.hc[0] = mlc_problem.HC
        ct.zref[0] = 46.0
        ct.pref[0] = pipe.pref
        ct.uref[0] = uref
        ct.tref[0] = tref
        ct.qref[0] = qref
        ct.compute_derived_atm_inputs(0)
        ct.tcan[0] = tcan
        ct.qcan[0] = qcan

    def substep(T_air, q_air, T_sun, T_shd):
        # turbulence (host Brent path) for the LBL wind profile
        tcan = T_air[pipe.ntop - 1]
        eair_top = q_air[pipe.ntop - 1] * pipe.pref
        factor = (MM_H2O / MM_DRY_AIR) / (
            pipe.pref - (1.0 - MM_H2O / MM_DRY_AIR) * eair_top)
        ct = CanopyTurbulenceAuxVar(1, nlev)
        turbulence(ct, tcan, eair_top * factor)
        obukhov_length(ct)
        wind_profile(ct)
        aerodynamic_conductances(ct)
        wind = np.asarray(ct.wind[0])

        # longwave through the serial KSP (GMRES + ILU(0))
        gt = np.zeros(nlev)
        gt[0] = T_air[0]
        lw.trans = f64(_np(f.lw_trans))
        lw.bc_Idn = f64([float(f.irsky)])
        lw.ground_temperature = f64(gt)
        lw.leaf_temperature = f64(np.stack([T_sun, T_shd], axis=1))
        lw.leaf_fssh = f64(np.stack([fssh, 1.0 - fssh], axis=1))
        x_lw, _, conv = _solve_ksp(lw_tpl, lw.matrix_values(), lw.rhs(),
                                   lw_cache)
        assert conv
        iabs = _np(x_lw).reshape(nlev, lw.dof)[:, 2]
        labs = np.where(dpai_pos, iabs / np.where(dpai == 0, 1.0, dpai),
                        0.0)

        # leaf boundary layer
        tleaf2 = np.concatenate([T_sun, T_shd])
        lbl.tleaf = f64(tleaf2)
        lbl.tair = f64(np.tile(T_air, 2))
        lbl.wind = f64(np.tile(wind, 2))
        lbl.pref = f64(np.full(2 * nlev, pipe.pref))
        lbl.tref = f64(np.full(2 * nlev, tref))
        lbl.compute()
        gbh2, gbv2, gbc2 = _np(lbl.gbh), _np(lbl.gbv), _np(lbl.gbc)

        # photosynthesis through the serial Newton
        av.tleaf[:] = tleaf2
        av.gbv[:] = gbv2
        av.gbc[:] = gbc2
        av.eair[:] = np.tile(q_air * pipe.pref, 2)
        av.apar[:nlev] = apar_sun
        av.apar[nlev:] = apar_shd
        av.determine_if_solution_is_bounded()
        psy.soe.soln[:] = 0.9 * pipe.co2ref
        ok, reason = psy.soe.step_dt(dt, 1)
        assert ok, reason
        gs2 = np.where(av.soln_is_bounded[:, 0], av.gs[:, 0], ph.GS_MIN)

        # MLC: the facade's PreSolve (Obukhov chain from the staged cturb),
        # CSR assembly and PostSolve around an exact dense solve
        m = MLCMPP(ncair=1, ntree=1, nz_cair=pipe.nz_cair, device="cpu")
        mc = m.cturb
        turbulence(mc, tcan, eair_top * factor)
        mc.soil_tk[0] = pipe.soil_tk
        mc.soil_dz[0] = pipe.soil_dz
        mc.soil_temperature[0] = soil_T
        mc.soil_res[0] = pipe.soil_res
        mc.soil_rhg[0] = pipe.soil_rhg
        mc.soil_rn[0] = isoil_sw + iabs[0]
        gs_sun, gs_shd = gs2[:nlev], gs2[nlev:]
        gbh_sun, gbh_shd = gbh2[:nlev], gbh2[nlev:]
        gbv_sun, gbv_shd = gbv2[:nlev], gbv2[nlev:]
        fdry = np.where(dpai_pos, mlc_problem.FDRY, 0.0)
        for a_dpai, a_fwet, a_fdry, a_gs, a_fssh in (
                (m.at_leaf_dpai, m.at_leaf_fwet, m.at_leaf_fdry,
                 m.at_leaf_gs, m.at_leaf_fssh),
                (m.av_leaf_dpai, m.av_leaf_fwet, m.av_leaf_fdry,
                 m.av_leaf_gs, m.av_leaf_fssh)):
            a_dpai[:, 0] = a_dpai[:, 1] = dpai
            a_fwet[:] = 0.0
            a_fdry[:, 0] = a_fdry[:, 1] = fdry
            a_gs[:, 0] = gs_sun
            a_gs[:, 1] = gs_shd
            a_fssh[:, 0] = fssh
            a_fssh[:, 1] = 1.0 - fssh
        m.at_gbh[:, 0] = gbh_sun
        m.at_gbh[:, 1] = gbh_shd
        m.av_gbv[:, 0] = gbv_sun
        m.av_gbv[:, 1] = gbv_shd
        m.at_is_soil[0] = True
        m.av_is_soil[0] = True
        rn = (rn_sw_sun + labs, rn_sw_shd + labs)
        for rk, ge in enumerate(m.leaf):
            ge["gbh"][:] = (gbh_sun, gbh_shd)[rk]
            ge["gbv"][:] = (gbv_sun, gbv_shd)[rk]
            ge["cp"][:] = mlc_problem.CP_LEAF
            ge["fwet"][:] = 0.0
            ge["fdry"][:] = fdry
            ge["dpai"][:] = dpai
            ge["fssh"][:] = fssh if rk == 0 else 1.0 - fssh
            ge["gs"][:] = (gs_sun, gs_shd)[rk]
            ge["rn"][:] = rn[rk]
        o = m.off
        m.soln[o[0]:o[0] + m.Na] = T_air
        m.soln[o[1]:o[1] + m.Na] = q_air
        m.soln[o[2]:o[2] + m.Nl] = T_sun
        m.soln[o[3]:o[3] + m.Nl] = T_shd
        m.soln_prev[:] = m.soln
        m.dtime = dt
        m._vol_air = m._compute_vol_air()
        m.pre_solve()
        b = m.compute_rhs()
        rows, cols, vals = m.compute_operators()
        A = np.zeros((m.n, m.n))
        np.add.at(A, (rows, cols), vals)
        m.soln_prev[:] = m.soln
        m.soln[:] = np.linalg.solve(A, b)
        m.post_solve()
        return (m.at_T.copy(), m.av_q.copy(),
                np.where(dpai_pos, m.leaf[0]["T"], T_sun),
                np.where(dpai_pos, m.leaf[1]["T"], T_shd))

    return substep


def _run_parity(forcing_kwargs=None, nsub=3):
    pipe = CanopyPipeline(ncair=1, device="cpu")
    dt = 300.0
    f = (pipe.make_forcing(**forcing_kwargs) if forcing_kwargs
         else pipe.default_forcing)
    serial_substep = _serial_substep_fn(pipe, f, dt)
    state = pipe.initial_state()
    s = [_np(x[0]) for x in state]
    for sub in range(nsub):
        s = list(serial_substep(*s))
        state = pipe.substep(state, dt, f)
        for got, want, name, tol in (
                (state.T_air[0], s[0], "T_air", T_TOL),
                (state.q_air[0], s[1], "q_air", Q_TOL),
                (state.T_sun[0], s[2], "T_sun", T_TOL),
                (state.T_shd[0], s[3], "T_shd", T_TOL)):
            err = float(np.abs(_np(got) - want).max())
            assert err < tol, (sub, name, err)


def test_pipeline_matches_serial_composition():
    """Default (midday build-time) forcing."""
    _run_parity(None)


@pytest.mark.parametrize("record", [
    dict(sza=1.2, iskyb=(120.0, 120.0), iskyd=(40.0, 10.0), irsky=350.0,
         tref=288.0, qref=0.007),
    dict(sza=1.45, iskyb=(5.0, 5.0), iskyd=(2.0, 0.5), irsky=320.0,
         tref=283.0, qref=0.006, uref=3.0, soil_T=290.0)],
    ids=["morning", "evening"])
def test_diurnal_forcing_parity(record):
    """Time-varying forcing records through the same harness: the hourly
    shortwave re-solve and the sky / atmosphere staging reach the batched
    stages as they reach the serial composition."""
    _run_parity(record, nsub=2)

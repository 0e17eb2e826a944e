"""MPPThermalTBasedALM analog: CLM-facing 3-media thermal driver.

Counterpart of ``mpp_tpu/driver/thermal_alm.py``.  Reimplements ``driver/alm/MPPThermalTBasedALM_Driver.F90:28-521``
(staging order :165-436, solve :445-455, unpack :458-505) on top of the
batched 3-media thermal problem: CLM column state (variable snow layers
via ``snl``, standing-water film from ``h2osfc``, soil profile) is
staged into the snow/SSW/soil meshes, the coupled KSP system solves one
step, and the temperatures return in the CLM ``tvector(c, -nlevsno+1:
nlevgrnd)`` layout (index 0 = standing surface water).

Geometry staging: the reference overwrites the mesh dz/dists from CLM
every step (VAR_DZ / VAR_DIST_UP / VAR_DIST_DN, :359-372); here we
rewrite the numpy mesh arrays in place — the GEs re-read them each
solve, so the update is picked up without rebuilding the problem.  The
solve is the problem's compiled "direct" KSP (``ThreeMediaProblem.
install``), on its ``device``.
"""
from __future__ import annotations

import numpy as np

from mpp_tpu_torch import constants as C
from mpp_tpu_torch.constants import AuxVarKind, Var
from mpp_tpu_torch.problems.thermal_3media import (NLEVGRND, NLEVSNO,
                                                   ThreeMediaProblem)

CAPR = 0.34     # tuning factor numerator constant (mpp_varcon capr)


def thermal_alm_solve(prob: ThreeMediaProblem, dtime, t_soisno, t_h2osfc,
                      snl, dz_snow, dz_soil, h2osoi_liq, h2osoi_ice,
                      h2osno, h2osfc, frac_sno_eff, frac_h2osfc,
                      sabg_lyr, dhsdT, hs_soil, hs_top_snow, hs_h2osfc):
    """One CLM coupling step.

    Shapes (ncol = prob.ncol):
      t_soisno     [ncol, NLEVSNO+NLEVGRND]  (snow layers first, j=0 is
                                              the TOP snow slot)
      t_h2osfc     [ncol]
      snl          [ncol]  (negative number of active snow layers)
      dz_snow      [ncol, NLEVSNO], dz_soil [ncol, NLEVGRND]
      h2osoi_liq/ice [ncol, NLEVSNO+NLEVGRND]
      sabg_lyr     [ncol, NLEVSNO+1]  (per snow layer + ground)
      scalars per column: h2osno, h2osfc, frac_*, dhsdT, hs_*
    Returns tvector [ncol, NLEVSNO+1+NLEVGRND].
    """
    ncol = prob.ncol
    mpp = prob.mpp
    snl = np.asarray(snl, np.int64)
    nsnow_act = -snl                                    # active layers

    # ---- snow staging (F90:196-241) ----------------------------------
    lev = np.tile(np.arange(NLEVSNO), ncol)             # j index, 0=top
    colv = np.repeat(np.arange(ncol), NLEVSNO)
    snow_active = lev >= (NLEVSNO - nsnow_act[colv])
    dz_sn = np.asarray(dz_snow, np.float64).reshape(-1)
    T_sn = np.asarray(t_soisno, np.float64)[:, :NLEVSNO].reshape(-1)
    liq_sn = np.asarray(h2osoi_liq, np.float64)[:, :NLEVSNO].reshape(-1)
    ice_sn = np.asarray(h2osoi_ice, np.float64)[:, :NLEVSNO].reshape(-1)

    g_snow = prob.ge_snow
    dz_eff = np.where(snow_active, dz_sn, prob.snow_dz)
    g_snow.mesh.dz[:] = dz_eff
    g_snow.mesh.vol[:] = dz_eff
    cs = g_snow.mesh.intrn_conn_sets[0]
    iu, idn = cs.id_up, cs.id_dn
    cs.dist_up[:] = 0.5 * dz_eff[iu]
    cs.dist_dn[:] = 0.5 * dz_eff[idn]
    mpp.set_r_data(AuxVarKind.INTERNAL, Var.LIQ_AREAL_DEN, prob.i_snow,
                   np.where(snow_active, liq_sn, 0.0))
    mpp.set_r_data(AuxVarKind.INTERNAL, Var.ICE_AREAL_DEN, prob.i_snow,
                   np.where(snow_active, ice_sn, 0.0))
    mpp.set_r_data(AuxVarKind.INTERNAL, Var.NUM_SNOW_LYR, prob.i_snow,
                   nsnow_act[colv])
    mpp.set_r_data(AuxVarKind.INTERNAL, Var.FRAC, prob.i_snow,
                   np.asarray(frac_sno_eff, np.float64)[colv])
    mpp.set_r_data(AuxVarKind.INTERNAL, Var.ACTIVE, prob.i_snow,
                   snow_active.astype(np.int64))
    # tuning factor on the top active layer (F90:224-227):
    # dz_j / (0.5*(dz_j/2 + capr*(dz_j + dz_{j+1}/2)))
    top_snow = snow_active & (lev == NLEVSNO - nsnow_act[colv])
    idx = np.arange(ncol * NLEVSNO)
    nxt = np.where(lev < NLEVSNO - 1, idx + 1, idx)
    tf_top = dz_eff / (0.5 * (0.5 * dz_eff
                              + CAPR * (dz_eff + 0.5 * dz_eff[nxt])))
    tf_sn = np.where(top_snow, tf_top, 1.0)
    mpp.set_r_data(AuxVarKind.INTERNAL, Var.TUNING_FACTOR, prob.i_snow,
                   tf_sn)
    g_snow.update_top_flux_conn()
    # absorbed solar in non-top active snow layers (F90:217-219)
    sabg = np.asarray(sabg_lyr, np.float64)
    sabg_snow = np.where(snow_active & ~top_snow,
                         sabg[:, :NLEVSNO].reshape(-1), 0.0)

    # ---- standing water staging (F90:244-277) -------------------------
    g_ssw = prob.ge_ssw
    h2osfc = np.asarray(h2osfc, np.float64)
    frac_h2osfc = np.asarray(frac_h2osfc, np.float64)
    ssw_active = frac_h2osfc > 0.0
    dz_ssw = np.where(ssw_active, 1.0e-3 * h2osfc, prob.ssw_dz)
    g_ssw.mesh.dz[:] = dz_ssw
    g_ssw.mesh.vol[:] = dz_ssw
    mpp.set_r_data(AuxVarKind.INTERNAL, Var.FRAC, prob.i_ssw, frac_h2osfc)
    mpp.set_r_data(AuxVarKind.INTERNAL, Var.ACTIVE, prob.i_ssw,
                   ssw_active.astype(np.int64))

    # ---- soil staging (F90:280-330) -----------------------------------
    g_soil = prob.ge_soil
    dz_so = np.asarray(dz_soil, np.float64).reshape(-1)
    g_soil.mesh.dz[:] = dz_so
    g_soil.mesh.vol[:] = dz_so
    cs = g_soil.mesh.intrn_conn_sets[0]
    cs.dist_up[:] = 0.5 * dz_so[cs.id_up]
    cs.dist_dn[:] = 0.5 * dz_so[cs.id_dn]
    lev_s = np.tile(np.arange(NLEVGRND), ncol)
    colv_s = np.repeat(np.arange(ncol), NLEVGRND)
    g_soil.liq_areal_den = \
        np.asarray(h2osoi_liq, np.float64)[:, NLEVSNO:].reshape(-1).copy()
    g_soil.ice_areal_den = \
        np.asarray(h2osoi_ice, np.float64)[:, NLEVSNO:].reshape(-1).copy()
    snow_present = nsnow_act > 0
    snow_water = np.where((lev_s == 0) & snow_present[colv_s],
                          np.asarray(h2osno, np.float64)[colv_s], 0.0)
    mpp.set_r_data(AuxVarKind.INTERNAL, Var.SNOW_WATER, prob.i_soil,
                   snow_water)
    mpp.set_r_data(AuxVarKind.INTERNAL, Var.NUM_SNOW_LYR, prob.i_soil,
                   np.where(lev_s == 0, nsnow_act[colv_s], 0))
    tf_soil = np.where((lev_s == 0) & ~snow_present[colv_s],
                       dz_so / (0.5 * (0.5 * dz_so
                                       + CAPR * 1.5 * dz_so)), 1.0)
    mpp.set_r_data(AuxVarKind.INTERNAL, Var.TUNING_FACTOR, prob.i_soil,
                   tf_soil)
    sabg_soil = np.where(lev_s == 0,
                         np.asarray(frac_sno_eff, np.float64)[colv_s]
                         * np.where(snow_present[colv_s],
                                    sabg[:, NLEVSNO][colv_s], 0.0), 0.0)

    # refresh BC/coupling face distances from the restaged dz, and
    # re-discover the sparsity (the snow-top flux conn may have moved)
    mpp.update_condition_conn_distances()
    mpp.soe.rebuild_template()

    # ---- BCs (F90:388-436) --------------------------------------------
    dhsdT = np.asarray(dhsdT, np.float64)
    frac_soil = 1.0 - np.where(nsnow_act > 0,
                               np.asarray(frac_sno_eff, np.float64), 0.0) \
        - np.where(ssw_active, frac_h2osfc, 0.0)
    prob.set_top_fluxes(0.0, 0.0, 0.0)       # size bc_value incl. coupling
    hs_sn = np.where(nsnow_act > 0, np.asarray(hs_top_snow, np.float64),
                     0.0)
    def staged(arr, head):
        out = np.array(arr, np.float64)
        out[:ncol] = head
        return out
    g_snow.bc_value = staged(g_snow.bc_value, hs_sn)
    g_snow.bc_dhsdT = staged(g_snow.bc_dhsdT,
                             np.where(nsnow_act > 0, dhsdT, 0.0))
    hs_sw = np.where(ssw_active, np.asarray(hs_h2osfc, np.float64), 0.0)
    g_ssw.bc_value = staged(g_ssw.bc_value, hs_sw)
    g_ssw.bc_dhsdT = staged(g_ssw.bc_dhsdT,
                            np.where(ssw_active, dhsdT, 0.0))
    g_soil.bc_value = staged(g_soil.bc_value,
                             np.asarray(hs_soil, np.float64))
    g_soil.bc_dhsdT = staged(g_soil.bc_dhsdT, dhsdT)
    g_soil.bc_frac = staged(g_soil.bc_frac, frac_soil)

    # absorbed-solar source sinks
    g_snow.ss_values = sabg_snow
    g_soil.ss_values = sabg_soil

    # ---- initial temperatures + solve (F90:333-455) -------------------
    T_pack = np.concatenate([
        np.where(snow_active, T_sn, C.TFRZ),
        np.where(ssw_active, np.asarray(t_h2osfc, np.float64), C.TFRZ),
        np.asarray(t_soisno, np.float64)[:, NLEVSNO:].reshape(-1)])
    soe = mpp.soe
    soe.set_soln_prev_clm(T_pack)
    soe.pre_step_dt()
    prob.install()
    ok = soe.step_dt(dtime)
    if not ok:
        raise RuntimeError("thermal model failed to converge")

    # ---- unpack tvector (F90:458-505) ---------------------------------
    soln = np.asarray(soe.soln)
    offs = soe.offsets
    T_snow = soln[offs[0]:offs[1]]
    T_ssw = soln[offs[1]:offs[2]]
    T_soil = soln[offs[2]:offs[3]]
    tvector = np.full((ncol, NLEVSNO + 1 + NLEVGRND), np.nan)
    tvector[:, :NLEVSNO] = np.where(
        snow_active.reshape(ncol, NLEVSNO),
        T_snow.reshape(ncol, NLEVSNO), np.nan)
    tvector[:, NLEVSNO] = np.where(ssw_active, T_ssw, np.nan)
    tvector[:, NLEVSNO + 1:] = T_soil.reshape(ncol, NLEVGRND)
    return tvector

"""Enthalpy-based soil heat transport GE and the coupled TH SoE / facade.

Counterpart of ``mpp_tpu/models/thermal_enthalpy.py``:

* auxvar chain with the max(P, P_ref) clamp on the EOS (density,
  viscosity, internal energy; sat/kr/por take the raw P), derivatives
  taken at the clamped P (ThermalEnthalpySoilAuxType.F90:219-278);
* energy two-point flux eflux = mflux*h - kbar*(T_up-T_dn)*area with
  upwinded enthalpy and analytic d/dT, d/dP (ThermalEnthalpyMod.F90:
  27-332); the h-upwind takes ``mflux <= 0`` for the value and
  ``mflux < 0`` for the derivative, as the reference does;
* mass-flux temperature derivative (RichardsMod.F90:431-648, the true
  derivative);
* energy residual, dF/dT and the off-diagonal block dF_energy/dP, inactive
  rows getting 1.0 on the off-diagonal too
  (GoveqnThermalEnthalpySoilType.F90:1060-1716, 2083-2375), and the mass
  equation's dF_mass/dT (GoveqnRichardsODEPressureType.F90:2333-2612);
* the TH SoE's sparsity in template order [J11, J12, J21, J22] and the
  ``THMPP`` facade, with the enthalpy GE's default permeability 8.3913e-12
  that MPPTHSetSoils never overrides (MultiPhysicsProbTH.F90:75-607);
* the standalone enthalpy SoE (``ThermalEnthalpySoE``, one linearised
  update a step, ``linearised_update``: ILU(0) + GMRES(30) of
  ``batched/ilu_gmres.py`` at one column, shared with
  ``CompiledThermalEnthalpy``) and its
  ``ThermalEnthalpyMPP`` facade.

Set-up is numpy, as in the JAX package; the numeric methods are batched
over ``[ncol, n]`` state like ``models/richards.py`` (device and dtype are
the state's).

``THSoE.step_dt`` is the serial SNES (``ops/snes.py``) over the same GE
code; ``batched/th_compiled.compile_th(mpp).install()`` replaces it with
the batched stepper.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from mpp_tpu_torch import constants as C
from mpp_tpu_torch.constants import (Cond, GEType, SOEType, AuxVarKind, Var,
                                     PRESSURE_REF, GRAVITY_CONSTANT, FMWH2O)
from mpp_tpu_torch.config import check_finite
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.dtypes.mpp_base import MPPBase
from mpp_tpu_torch.batched.ilu_gmres import (BatchedILU0, gmres_cycles,
                                             make_ell_matvec)
from mpp_tpu_torch.models.richards import RichardsGE, darcy_flux, _swhere
from mpp_tpu_torch.ops import eos, satfunc as sf
from mpp_tpu_torch.ops.porosity import porosity
from mpp_tpu_torch.ops.snes import HostSyncs, LS_BT, LS_L2, snes_step_dt
from mpp_tpu_torch.ops.sparse import csr_template, CSRTemplate


def enthalpy_aux(P, T, sat_params, por_params, density_type,
                 int_energy_type, tc_wet, tc_dry, t_alpha):
    """ThermEnthalpyAuxVarCompute (ThermalEnthalpySoilAuxType.F90:219-278):
    a dict of the secondary quantities and their analytic derivatives.
    The EOS is evaluated at max(P, PRESSURE_REF) and its derivatives are
    the ones at the clamped pressure, as the reference does."""
    sat, dsat_dP = sf.press_to_sat(sat_params, P)
    kr, dkr_dP = sf.press_to_relperm(sat_params, P, torch.ones_like(P))
    por, dpor_dP = porosity(por_params, P)
    Pc = torch.clamp_min(P, PRESSURE_REF)
    den, dden_dP, dden_dT = eos.density(Pc, T, density_type)
    vis, dvis_dP, dvis_dT = eos.viscosity(Pc, T)
    ul, hl, dul_dT, dhl_dT, dul_dP, dhl_dP = eos.internal_energy_and_enthalpy(
        Pc, T, int_energy_type, den * FMWH2O, dden_dT * FMWH2O,
        dden_dP * FMWH2O)
    kel = (sat + 1.0e-6) ** t_alpha
    dkel_dP = t_alpha * (sat + 1.0e-6) ** (t_alpha - 1.0) * dsat_dP
    tc = tc_wet * kel + tc_dry * (1.0 - kel)
    dtc_dP = (tc_wet - tc_dry) * dkel_dP
    return dict(sat=sat, dsat_dP=dsat_dP, kr=kr, dkr_dP=dkr_dP,
                por=por, dpor_dP=dpor_dP, den=den, dden_dP=dden_dP,
                dden_dT=dden_dT, vis=vis, dvis_dP=dvis_dP,
                dvis_dT=dvis_dT, ul=ul, hl=hl, dul_dT=dul_dT,
                dhl_dT=dhl_dT, dul_dP=dul_dP, dhl_dP=dhl_dP,
                tc=tc, dtc_dP=dtc_dP, T=T, P=P)


def _dir_perm(unit_vec, perm):
    """|unit vector| . permeability per connection (numpy), in the sum
    order of ``models/richards.py``, whose cache keys it shares."""
    return (np.abs(unit_vec[:, 0]) * perm[:, 0]
            + np.abs(unit_vec[:, 1]) * perm[:, 1]
            + np.abs(unit_vec[:, 2]) * perm[:, 2])


def _is_otr(cond_kind):
    return np.asarray(cond_kind) == int(Cond.DIRICHLET_FRM_OTR_GOVEQ)


def _flux_geometry(internal, cond_kind, perm_up, perm_dn, dist_up, dist_dn):
    """(upweight, Dq) of RichardsFlux (RichardsMod.F90:196-236)."""
    dist = dist_up + dist_dn
    Dq_int = (perm_up * perm_dn) / (dist_up * perm_dn + dist_dn * perm_up)
    if internal:
        return dist_up / dist, Dq_int
    is_otr = _is_otr(cond_kind)
    return (_swhere(is_otr, dist_up / dist, 0.0),
            _swhere(is_otr, Dq_int, perm_dn / dist))


def darcy_flux_dT(P_up, P_dn, kr_up, kr_dn, den_up, den_dn, dden_dT_up,
                  dden_dT_dn, vis_up, vis_dn, dvis_dT_up, dvis_dT_dn,
                  perm_up, perm_dn, dist_up, dist_dn, area, unit_z,
                  internal: bool, cond_kind=None):
    """RichardsFluxDerivativeWrtTemperature (RichardsMod.F90:431-648):
    (flux, dflux/dT_up, dflux/dT_dn), the true derivatives."""
    upweight, Dq = _flux_geometry(internal, cond_kind, perm_up, perm_dn,
                                  dist_up, dist_dn)
    dist = dist_up + dist_dn
    dist_gravity = dist * (unit_z * (-GRAVITY_CONSTANT))
    den_ave = upweight * den_up + (1.0 - upweight) * den_dn
    dphi = P_up - P_dn + den_ave * FMWH2O * dist_gravity
    up_wind = dphi >= 0.0
    ukvr = torch.where(up_wind, kr_up / vis_up, kr_dn / vis_dn)
    v_darcy = -Dq * ukvr * dphi
    mass_flux = None
    if not internal and cond_kind is not None:
        mass_flux = np.asarray(cond_kind) == int(Cond.MASS_FLUX)
        v_darcy = _swhere(mass_flux, torch.zeros_like(v_darcy), v_darcy)
    q = v_darcy * area
    flux = q * den_ave

    dden_ave_up = upweight * dden_dT_up
    dden_ave_dn = (1.0 - upweight) * dden_dT_dn
    dphi_up = upweight * dist_gravity * FMWH2O * dden_dT_up
    dphi_dn = (1.0 - upweight) * dist_gravity * FMWH2O * dden_dT_dn
    dukvr_up = torch.where(up_wind,
                           -kr_up / (vis_up * vis_up) * dvis_dT_up, 0.0)
    dukvr_dn = torch.where(up_wind, 0.0,
                           -kr_dn / (vis_dn * vis_dn) * dvis_dT_dn)
    dq_up = -Dq * (dukvr_up * dphi + ukvr * dphi_up) * area
    dq_dn = -Dq * (dukvr_dn * dphi + ukvr * dphi_dn) * area
    dflux_up = dq_up * den_ave + q * dden_ave_up
    dflux_dn = dq_dn * den_ave + q * dden_ave_dn
    if mass_flux is not None:
        dflux_up = _swhere(mass_flux, torch.zeros_like(dflux_up), dflux_up)
        dflux_dn = _swhere(mass_flux, torch.zeros_like(dflux_dn), dflux_dn)
    return flux, dflux_up, dflux_dn


def _tc_ave_over_dist(internal, cond_kind, tc_up, tc_dn, dist_up, dist_dn):
    """Thermal-conductivity face weighting (ThermalEnthalpyMod.F90:109-129):
    (upweight, D)."""
    D_int = (tc_up * tc_dn) / (dist_up * tc_dn + dist_dn * tc_up)
    w_int = dist_up / (dist_up + dist_dn)
    if internal:
        return w_int, D_int
    is_otr = _is_otr(cond_kind)
    return (_swhere(is_otr, w_int, 0.0),
            _swhere(is_otr, D_int, tc_dn / (dist_up + dist_dn)))


def enthalpy_flux(T_up, T_dn, h_up, h_dn, tc_up, tc_dn, dist_up, dist_dn,
                  area, mflux, internal: bool, cond_kind=None):
    """ThermalEnthalpyFlux value (ThermalEnthalpyMod.F90:131-140):
    (eflux, D, h)."""
    _, D = _tc_ave_over_dist(internal, cond_kind, tc_up, tc_dn,
                             dist_up, dist_dn)
    h = torch.where(mflux <= 0.0, h_up, h_dn)
    eflux = mflux * h - D * (T_up - T_dn) * area
    return eflux, D, h


def enthalpy_flux_dT(T_up, T_dn, h_up, h_dn, dh_dT_up, dh_dT_dn,
                     tc_up, tc_dn, dist_up, dist_dn, area, mflux,
                     dmflux_dT_up, dmflux_dT_dn, internal, cond_kind=None):
    """eflux and d(eflux)/dT_up, dT_dn (ThermalEnthalpyMod.F90:142-163)."""
    eflux, D, h = enthalpy_flux(T_up, T_dn, h_up, h_dn, tc_up, tc_dn,
                                dist_up, dist_dn, area, mflux, internal,
                                cond_kind)
    deriv_up_wind = mflux < 0.0
    dh_up = torch.where(deriv_up_wind, dh_dT_up, 0.0)
    dh_dn = torch.where(deriv_up_wind, 0.0, dh_dT_dn)
    de_up = dmflux_dT_up * h + mflux * dh_up - D * area
    de_dn = dmflux_dT_dn * h + mflux * dh_dn + D * area
    return eflux, de_up, de_dn


def enthalpy_flux_dP(T_up, T_dn, h_up, h_dn, dh_dP_up, dh_dP_dn,
                     tc_up, tc_dn, dtc_dP_up, dtc_dP_dn, dist_up, dist_dn,
                     area, mflux, dmflux_dP_up, dmflux_dP_dn, internal,
                     cond_kind=None):
    """eflux and d(eflux)/dP_up, dP_dn, with the Kersten-number
    conductivity dependence (ThermalEnthalpyMod.F90:288-330)."""
    eflux, D, h = enthalpy_flux(T_up, T_dn, h_up, h_dn, tc_up, tc_dn,
                                dist_up, dist_dn, area, mflux, internal,
                                cond_kind)
    deriv_up_wind = mflux < 0.0
    dh_up = torch.where(deriv_up_wind, dh_dP_up, 0.0)
    dh_dn = torch.where(deriv_up_wind, 0.0, dh_dP_dn)
    dD_up = D ** 2.0 / tc_up ** 2.0 * dist_up * dtc_dP_up
    dD_dn = D ** 2.0 / tc_dn ** 2.0 * dist_dn * dtc_dP_dn
    if not internal:
        is_otr = _is_otr(cond_kind)
        dD_up = _swhere(is_otr, dD_up, torch.zeros_like(dD_up))
        dD_dn = _swhere(is_otr, dD_dn, dtc_dP_dn / (dist_up + dist_dn))
    de_up = dmflux_dP_up * h + mflux * dh_up - dD_up * (T_up - T_dn) * area
    de_dn = dmflux_dP_dn * h + mflux * dh_dn - dD_dn * (T_up - T_dn) * area
    return eflux, de_up, de_dn


@dataclasses.dataclass
class ThermalEnthalpyGE(RichardsGE):
    """GE_THERM_SOIL_EBASED: enthalpy-based soil heat transport.

    Extends the Richards GE state (the reference auxvar type extends the
    Richards one) with thermal properties.  The unknown is temperature;
    pressure is a staged parameter or the coupled Richards GE's unknown."""
    itype: int = int(GEType.THERM_SOIL_EBASED)
    # per-cell thermal parameters
    therm_cond_wet: np.ndarray = None
    therm_cond_dry: np.ndarray = None
    therm_alpha: np.ndarray = None
    heat_cap_soil: np.ndarray = None
    den_soil: np.ndarray = None
    int_energy_type: int = eos.INT_ENERGY_ENTHALPY_CONSTANT
    # BC auxvar copies
    bc_therm_cond_wet: np.ndarray = None
    bc_therm_cond_dry: np.ndarray = None
    bc_therm_alpha: np.ndarray = None
    # BC auxvar pressure (RichODEPressureAuxVarInit:91 sets 0 Pa; the TH
    # drivers stage it before any step)
    bc_pressure: np.ndarray = None

    def allocate_auxvars(self):
        super().allocate_auxvars()
        n = self.mesh.ncells_all
        # ThermEnthalpyAuxVarInit defaults, perm 8.3913e-12 (:93)
        self.perm[:] = 8.3913e-12
        self.therm_cond_wet = np.zeros(n)
        self.therm_cond_dry = np.zeros(n)
        self.therm_alpha = np.zeros(n)
        self.heat_cap_soil = np.zeros(n)
        self.den_soil = np.zeros(n)
        nbc = sum(c.num_connections for c in self.boundary_conditions)
        self.bc_perm[:] = 8.3913e-12
        self.bc_therm_cond_wet = np.zeros(nbc)
        self.bc_therm_cond_dry = np.zeros(nbc)
        self.bc_therm_alpha = np.zeros(nbc)
        self.bc_pressure = np.zeros(nbc)
        self.invalidate()

    # ---- property staging (value set on the internal auxvars, then copied
    # to the BC auxvars of the adjacent cells) --------------------------------
    def _bc_copy(self, cell_arr):
        return np.asarray(cell_arr)[self._bc_concat()[0]]

    def set_heat_capacity(self, data):
        self.heat_cap_soil[:len(np.asarray(data))] = data
        self.invalidate()

    def set_thermal_cond_wet(self, data):
        self.therm_cond_wet[:len(np.asarray(data))] = data
        self.bc_therm_cond_wet = self._bc_copy(self.therm_cond_wet)
        self.invalidate()

    def set_thermal_cond_dry(self, data):
        self.therm_cond_dry[:len(np.asarray(data))] = data
        self.bc_therm_cond_dry = self._bc_copy(self.therm_cond_dry)
        self.invalidate()

    def set_thermal_alpha(self, data):
        self.therm_alpha[:len(np.asarray(data))] = data
        self.bc_therm_alpha = self._bc_copy(self.therm_alpha)
        self.invalidate()

    def set_soil_density(self, data):
        self.den_soil[:len(np.asarray(data))] = data
        self.invalidate()

    def set_int_energy_type(self, itype):
        self.int_energy_type = int(itype)

    # set_soil_permeability: RichardsGE's (incl. BC copies), the same as
    # ThermEnthalpySetSoilPermeability

    # ---- aux + assembly (T, P: [ncol, n]) ----------------------------------
    def _params(self, ref, bc=False):
        """(sat params, porosity params, tc_wet, tc_dry, t_alpha) of the
        cells, or of the BC auxvars, as tensors."""
        p = "bc_" if bc else ""
        sp = getattr(self, p + "sat_params")
        pp = getattr(self, p + "por_params")
        return (self._const_obj(p + "sat", ref,
                                lambda: sp.to(ref.device, ref.dtype)),
                self._const_obj(p + "por", ref,
                                lambda: pp.to(ref.device, ref.dtype)),
                self._const(p + "tc_wet", ref,
                            lambda: getattr(self, p + "therm_cond_wet")),
                self._const(p + "tc_dry", ref,
                            lambda: getattr(self, p + "therm_cond_dry")),
                self._const(p + "t_alpha", ref,
                            lambda: getattr(self, p + "therm_alpha")))

    def _cell_aux_e(self, T, P):
        sp, pp, tw, td, ta = self._params(P)
        return enthalpy_aux(P, T, sp, pp, self.density_type,
                            self.int_energy_type, tw, td, ta)

    def _bc_aux_e(self, T, P, bc_value=None, bc_pressure=None):
        """BC auxvars: temperature = the condition value for Dirichlet
        (ThermEnthalpySoilUpdateAuxVarsBC:997-1009), else the cell's;
        pressure = the staged ``bc_pressure``.  Both default to the staged
        attributes."""
        bc_ids, _, _, _, _, code = self._bc_concat()
        if not bc_ids.size:
            return None
        bc_value, bc_pressure = self._bc_defaults(P, bc_value, bc_pressure)
        bids = self._const("bc_ids", P, lambda: bc_ids, "i")
        T_bc = _swhere(code == int(Cond.DIRICHLET), bc_value, T[:, bids])
        sp, pp, tw, td, ta = self._params(P, bc=True)
        return enthalpy_aux(bc_pressure, T_bc, sp, pp, self.density_type,
                            self.int_energy_type, tw, td, ta)

    def _bc_defaults(self, P, bc_value, bc_pressure):
        ncol = P.shape[0]
        stage = lambda a: torch.as_tensor(a, dtype=P.dtype,
                                          device=P.device).expand(ncol, -1)
        if bc_value is None:
            bc_value = stage(self.bc_value)
        if bc_pressure is None:
            bc_pressure = stage(self.bc_pressure)
        return bc_value, bc_pressure

    def _accum_e_aux(self, a, T, P):
        return (a["por"] * a["den"] * a["sat"] * a["ul"]
                + (1.0 - a["por"]) * self._const("den_soil", P,
                                                 lambda: self.den_soil)
                * self._const("heat_cap", P, lambda: self.heat_cap_soil)
                * (T - 273.15)) * self._const("vol", P,
                                              lambda: self.mesh.vol)

    def accum_e(self, T, P):
        """phi*den*sat*ul + (1-phi)*rho_s*cp_s*(T-273.15), times vol
        (ThermalEnthalpySoilAccum:1204-1215); the caller divides by dt."""
        return self._accum_e_aux(self._cell_aux_e(T, P), T, P)

    def _internal_efluxes(self, T, P, a, wrt):
        """(eflux, de_up, de_dn) over internal connections; ``wrt`` is "T"
        or "P"."""
        ic = self._internal()
        iu = self._const("in_up", P, lambda: ic.id_up, "i")
        idn = self._const("in_dn", P, lambda: ic.id_dn, "i")
        du = self._const("in_dist_up", P, lambda: ic.dist_up)
        dn_ = self._const("in_dist_dn", P, lambda: ic.dist_dn)
        ar = self._const("in_area", P, lambda: ic.area)
        uz = self._const("in_uz", P, lambda: ic.unit_vec[:, 2])
        pu = self._const("in_perm_up", P,
                         lambda: _dir_perm(ic.unit_vec, self.perm[ic.id_up]))
        pd = self._const("in_perm_dn", P,
                         lambda: _dir_perm(ic.unit_vec, self.perm[ic.id_dn]))
        g = lambda k: (a[k][:, iu], a[k][:, idn])
        if wrt == "T":
            mflux, dm_up, dm_dn = darcy_flux_dT(
                P[:, iu], P[:, idn], *g("kr"), *g("den"), *g("dden_dT"),
                *g("vis"), *g("dvis_dT"), pu, pd, du, dn_, ar, uz,
                internal=True)
            return enthalpy_flux_dT(
                T[:, iu], T[:, idn], *g("hl"), *g("dhl_dT"), *g("tc"),
                du, dn_, ar, mflux, dm_up, dm_dn, internal=True)
        mflux, dm_up, dm_dn = darcy_flux(
            P[:, iu], P[:, idn], *g("kr"), *g("dkr_dP"), *g("den"),
            *g("dden_dP"), *g("vis"), *g("dvis_dP"), pu, pd, du, dn_, ar, uz,
            internal=True)
        return enthalpy_flux_dP(
            T[:, iu], T[:, idn], *g("hl"), *g("dhl_dP"), *g("tc"),
            *g("dtc_dP"), du, dn_, ar, mflux, dm_up, dm_dn, internal=True)

    def _bc_efluxes(self, T, P, a, ab, wrt):
        """(bc cell ids, codes, eflux, de_dn) over BC connections."""
        bc_ids, bdup, bddn, barea, buvz, bcode = self._bc_concat()
        if not bc_ids.size:
            z = P.new_zeros((P.shape[0], 0))
            return bc_ids, bcode, z, z
        bids = self._const("bc_ids", P, lambda: bc_ids, "i")
        pu = self._const("bc_perm_b", P, lambda: self._bc_perms()[0])
        pd = self._const("bc_perm_cell", P, lambda: self._bc_perms()[1])
        du = self._const("bc_dist_up", P, lambda: bdup)
        dn_ = self._const("bc_dist_dn", P, lambda: bddn)
        ar = self._const("bc_area", P, lambda: barea)
        uz = self._const("bc_uz", P, lambda: buvz)
        g = lambda k: (ab[k], a[k][:, bids])
        if wrt == "T":
            mflux, dm_up, dm_dn = darcy_flux_dT(
                ab["P"], P[:, bids], *g("kr"), *g("den"), *g("dden_dT"),
                *g("vis"), *g("dvis_dT"), pu, pd, du, dn_, ar, uz,
                internal=False, cond_kind=bcode)
            eflux, _, de_dn = enthalpy_flux_dT(
                ab["T"], T[:, bids], *g("hl"), *g("dhl_dT"), *g("tc"),
                du, dn_, ar, mflux, dm_up, dm_dn, internal=False,
                cond_kind=bcode)
        else:
            mflux, dm_up, dm_dn = darcy_flux(
                ab["P"], P[:, bids], *g("kr"), *g("dkr_dP"), *g("den"),
                *g("dden_dP"), *g("vis"), *g("dvis_dP"), pu, pd, du, dn_,
                ar, uz, internal=False, cond_kind=bcode)
            eflux, _, de_dn = enthalpy_flux_dP(
                ab["T"], T[:, bids], *g("hl"), *g("dhl_dP"), *g("tc"),
                *g("dtc_dP"), du, dn_, ar, mflux, dm_up, dm_dn,
                internal=False, cond_kind=bcode)
        return bc_ids, bcode, eflux, de_dn

    def _both_active(self):
        ic = self._internal()
        active = self._active()
        return active[ic.id_up] & active[ic.id_dn]

    def residual_e(self, T, P, dt, bc_value=None, ss_value=None,
                   accum_prev=None, bc_pressure=None):
        """Energy residual [ncol, ncells_local].  The optional dynamic
        inputs default to the staged attributes."""
        ncol = P.shape[0]
        if ss_value is None:
            ss_value = torch.as_tensor(self.ss_value, dtype=P.dtype,
                                       device=P.device).expand(ncol, -1)
        if accum_prev is None:
            accum_prev = torch.as_tensor(self.accum_prev, dtype=P.dtype,
                                         device=P.device).expand(ncol, -1)
        bc_value, bc_pressure = self._bc_defaults(P, bc_value, bc_pressure)
        active = self._active()
        a = self._cell_aux_e(T, P)
        zero = torch.zeros_like(P)
        F = _swhere(active, self._accum_e_aux(a, T, P) / dt, zero) \
            - accum_prev

        eflux, _, _ = self._internal_efluxes(T, P, a, "T")
        ic = self._internal()
        iu = self._const("in_up", P, lambda: ic.id_up, "i")
        idn = self._const("in_dn", P, lambda: ic.id_dn, "i")
        eflux = _swhere(self._both_active(), eflux, torch.zeros_like(eflux))
        F = F.index_add(1, iu, -eflux).index_add(1, idn, eflux)

        bc_ids, bcode, eflux_b, _ = self._bc_efluxes(
            T, P, a, self._bc_aux_e(T, P, bc_value, bc_pressure), "T")
        if bc_ids.size:
            bids = self._const("bc_ids", P, lambda: bc_ids, "i")
            is_dir = np.isin(bcode, (int(Cond.DIRICHLET),
                                     int(Cond.DIRICHLET_FRM_OTR_GOVEQ)))
            is_hf = bcode == int(Cond.HEAT_FLUX)
            barea = self._const("bc_area", P, lambda: self._bc_concat()[3])
            zb = torch.zeros_like(eflux_b)
            contrib = _swhere(is_dir, eflux_b,
                              _swhere(is_hf, bc_value * barea, zb))
            contrib = _swhere(active[bc_ids], contrib, zb)
            F = F.index_add(1, bids, contrib)

        ss_ids, ss_code = self._ss_concat()
        if ss_ids.size:
            if not (ss_code == int(Cond.HEAT_RATE)).all():
                raise ValueError("Unknown SS condition in enthalpy GE")
            sids = self._const("ss_ids", P, lambda: ss_ids, "i")
            F = F.index_add(1, sids, _swhere(active[ss_ids], ss_value,
                                             torch.zeros_like(ss_value)))
        return F

    def jacobian_e_values(self, T, P, dt, bc_value=None, bc_pressure=None):
        """dF/dT values [ncol, ncoo] in coo_coords order (internal 4 per
        connection, BC diagonal, SS diagonal, accumulation diagonal)."""
        n = self.mesh.ncells_local
        active = self._active()
        a = self._cell_aux_e(T, P)

        _, de_up, de_dn = self._internal_efluxes(T, P, a, "T")
        both = self._both_active()
        de_up = _swhere(both, de_up, torch.zeros_like(de_up))
        de_dn = _swhere(both, de_dn, torch.zeros_like(de_dn))
        parts = [-de_up, -de_dn, de_up, de_dn]

        bc_ids, bcode, _, de_dn_b = self._bc_efluxes(
            T, P, a, self._bc_aux_e(T, P, bc_value, bc_pressure), "T")
        if bc_ids.size:
            is_dir = np.isin(bcode, (int(Cond.DIRICHLET),
                                     int(Cond.DIRICHLET_FRM_OTR_GOVEQ)))
            parts.append(_swhere(is_dir & active[bc_ids], de_dn_b,
                                 torch.zeros_like(de_dn_b)))

        parts.append(P.new_zeros((P.shape[0], self._ss_concat()[0].size)))

        # d/dT accumulation (ThermalEnthalpySoilAccumDeriv:1278-1284);
        # dsat_dT = dkr_dT = 0 in the reference auxvar chain
        vol = self._const("vol", P, lambda: self.mesh.vol)
        dacc = (a["por"] * a["dden_dT"] * a["sat"] * a["ul"]
                + a["por"] * a["den"] * a["sat"] * a["dul_dT"]
                + (1.0 - a["por"]) * self._const("den_soil", P,
                                                 lambda: self.den_soil)
                * self._const("heat_cap", P, lambda: self.heat_cap_soil)
                ) * vol / dt
        dacc = dacc[:, :n]
        parts.append(_swhere(active[:n], dacc, torch.ones_like(dacc)))
        return torch.cat(parts, dim=1)

    # ---- off-diagonal block wrt pressure -----------------------------------
    def offdiag_p_coords(self, row_off=0, col_off=0):
        """Sparsity of dF_energy/dP: accumulation diagonal, internal 4 per
        connection, BC diagonal (GoveqnThermalEnthalpySoilType.F90:
        2157-2373)."""
        n = self.mesh.ncells_local
        ic = self._internal()
        bc_ids = self._bc_concat()[0]
        rows = [np.arange(n), ic.id_up, ic.id_up, ic.id_dn, ic.id_dn, bc_ids]
        cols = [np.arange(n), ic.id_up, ic.id_dn, ic.id_up, ic.id_dn, bc_ids]
        return (np.concatenate(rows) + row_off, np.concatenate(cols) + col_off)

    def offdiag_p_values(self, T, P, dt, bc_value=None, bc_pressure=None):
        n = self.mesh.ncells_local
        active = self._active()
        a = self._cell_aux_e(T, P)

        vol = self._const("vol", P, lambda: self.mesh.vol)
        den_soil = self._const("den_soil", P, lambda: self.den_soil)
        heat_cap = self._const("heat_cap", P, lambda: self.heat_cap_soil)
        dacc = (a["dpor_dP"] * a["den"] * a["sat"] * a["ul"]
                + a["por"] * a["dden_dP"] * a["sat"] * a["ul"]
                + a["por"] * a["den"] * a["dsat_dP"] * a["ul"]
                + a["por"] * a["den"] * a["sat"] * a["dul_dP"]
                - a["dpor_dP"] * den_soil * heat_cap * (T - 273.15)
                ) * vol / dt
        dacc = dacc[:, :n]
        parts = [_swhere(active[:n], dacc, torch.ones_like(dacc))]

        _, de_up, de_dn = self._internal_efluxes(T, P, a, "P")
        both = self._both_active()
        de_up = _swhere(both, de_up, torch.zeros_like(de_up))
        de_dn = _swhere(both, de_dn, torch.zeros_like(de_dn))
        parts += [-de_up, -de_dn, de_up, de_dn]

        bc_ids, bcode, _, de_dn_b = self._bc_efluxes(
            T, P, a, self._bc_aux_e(T, P, bc_value, bc_pressure), "P")
        if bc_ids.size:
            not_otr = ~_is_otr(bcode)
            parts.append(_swhere(not_otr & active[bc_ids], de_dn_b,
                                 torch.zeros_like(de_dn_b)))
        return torch.cat(parts, dim=1)


def richards_offdiag_t_coords(ge: RichardsGE, row_off=0, col_off=0):
    """Sparsity of dF_mass/dT: accumulation diagonal and internal 4 per
    connection; regular Dirichlet BCs contribute nothing
    (GoveqnRichardsODEPressureType.F90:2361-2612)."""
    n = ge.mesh.ncells_local
    ic = ge._internal()
    rows = [np.arange(n), ic.id_up, ic.id_up, ic.id_dn, ic.id_dn]
    cols = [np.arange(n), ic.id_up, ic.id_dn, ic.id_up, ic.id_dn]
    return (np.concatenate(rows) + row_off, np.concatenate(cols) + col_off)


def richards_offdiag_t_values(ge: RichardsGE, P, T, dt):
    """dF_mass/dT values [ncol, ncoo] in :func:`richards_offdiag_t_coords`
    order, at the GE's staged parameters."""
    n = ge.mesh.ncells_local
    active = ge._active()
    sp = ge._const_obj("sat", P, lambda: ge.sat_params.to(P.device, P.dtype))
    pp = ge._const_obj("por", P, lambda: ge.por_params.to(P.device, P.dtype))
    sat, _ = sf.press_to_sat(sp, P)
    kr, _ = sf.press_to_relperm(sp, P, ge._staged("frac_liq_sat", P))
    den, _, dden_dT = eos.density(P, T, ge.density_type)
    vis, _, dvis_dT = eos.viscosity(P, T)
    por, _ = porosity(pp, P)
    vol = ge._const("vol", P, lambda: ge.mesh.vol)
    dacc = ((por * dden_dT * sat) * vol / dt)[:, :n]
    parts = [_swhere(active[:n], dacc, torch.ones_like(dacc))]

    ic = ge._internal()
    iu = ge._const("in_up", P, lambda: ic.id_up, "i")
    idn = ge._const("in_dn", P, lambda: ic.id_dn, "i")
    pu = ge._const("in_perm_up", P,
                   lambda: _dir_perm(ic.unit_vec, ge.perm[ic.id_up]))
    pd = ge._const("in_perm_dn", P,
                   lambda: _dir_perm(ic.unit_vec, ge.perm[ic.id_dn]))
    _, df_up, df_dn = darcy_flux_dT(
        P[:, iu], P[:, idn], kr[:, iu], kr[:, idn], den[:, iu], den[:, idn],
        dden_dT[:, iu], dden_dT[:, idn], vis[:, iu], vis[:, idn],
        dvis_dT[:, iu], dvis_dT[:, idn], pu, pd,
        ge._const("in_dist_up", P, lambda: ic.dist_up),
        ge._const("in_dist_dn", P, lambda: ic.dist_dn),
        ge._const("in_area", P, lambda: ic.area),
        ge._const("in_uz", P, lambda: ic.unit_vec[:, 2]), internal=True)
    both = active[ic.id_up] & active[ic.id_dn]
    df_up = _swhere(both, df_up, torch.zeros_like(df_up))
    df_dn = _swhere(both, df_dn, torch.zeros_like(df_dn))
    return torch.cat(parts + [-df_up, -df_dn, df_up, df_dn], dim=1)


class THSoE:
    """SOE_TH: coupled Richards + thermal enthalpy, Newton on X = [P; T]
    (SystemOfEquationsTHType.F90:736-1003).  Holds the GEs, the CSR
    template and the solution (host numpy, one column).  ``step_dt`` is
    the serial SOEBaseStepDT_SNES over ``ops/snes.snes_solve``, with the
    residual and the Jacobian on ``device`` (the card unless ``"cpu"``);
    ``batched/th_compiled.CompiledTH`` is the batched stepper (its
    ``install()`` replaces ``step_dt``)."""

    #: device of the serial ``step_dt``
    device = "cuda"

    def __init__(self):
        self.ge_mass: Optional[RichardsGE] = None
        self.ge_energy: Optional[ThermalEnthalpyGE] = None
        self.itype = int(SOEType.TH)
        self.soln = None
        self.soln_prev = None
        self.template: Optional[CSRTemplate] = None
        self.use_dynamic_linesearch = False
        self.snes_stol = 1e-10
        self.cumulative_newton_iterations = 0
        self.cumulative_linear_iterations = 0
        self.metrics = None
        self.syncs = HostSyncs()
        self._stage = None

    @property
    def goveqns(self):
        return [g for g in (self.ge_mass, self.ge_energy) if g is not None]

    @property
    def host_syncs(self):
        return self.syncs.n

    def setup(self):
        """The 2x2 block sparsity in template order [J11, J12, J21, J22]."""
        n = self.ge_mass.mesh.ncells_local
        self.n = n
        r1, c1 = self.ge_mass.coo_coords(0, 0)
        r12, c12 = richards_offdiag_t_coords(self.ge_mass, 0, n)
        r21, c21 = self.ge_energy.offdiag_p_coords(n, 0)
        r2, c2 = self.ge_energy.coo_coords(n, n)
        self.template = csr_template(2 * n, 2 * n,
                                     np.concatenate([r1, r12, r21, r2]),
                                     np.concatenate([c1, c12, c21, c2]))
        self.soln = np.zeros(2 * n)
        self.soln_prev = np.zeros(2 * n)

    def _split(self, X):
        """(P, T) blocks of X [..., 2n]."""
        return X[..., :self.n], X[..., self.n:]

    # SNES callbacks: the exchange (SOETHGovEqnExchangeAuxVars: the mass GE
    # receives T, the energy GE P) is argument passing ----------------------
    def _mass_dyn(self, T):
        return {"temperature": T, "bc_temperature": self._stage["bc_temp"]}

    def _x(self, X):
        return torch.as_tensor(X, dtype=torch.float64,
                               device=self._stage["device"])[None, :]

    def _residual(self, X, dt):
        st = self._stage
        P, T = self._split(self._x(X))
        F1 = self.ge_mass.residual(P, dt, bc_value=st["bc"][0],
                                   ss_value=st["ss"][0],
                                   accum_prev=st["accum_prev"][0],
                                   dyn=self._mass_dyn(T))
        F2 = self.ge_energy.residual_e(T, P, dt, bc_value=st["bc"][1],
                                       ss_value=st["ss"][1],
                                       accum_prev=st["accum_prev"][1],
                                       bc_pressure=st["bc_pres"])
        F = self.syncs.download(torch.cat([F1, F2], dim=1)[0])
        check_finite("THSoE residual", F)
        return F

    def _jacobian(self, X, dt):
        st = self._stage
        P, T = self._split(self._x(X))
        ge = self.ge_energy
        v1 = self.ge_mass.jacobian_values(P, dt, bc_value=st["bc"][0],
                                          ss_value=st["ss"][0],
                                          dyn=self._mass_dyn(T))
        v12 = richards_offdiag_t_values(self.ge_mass, P, T, dt)
        v21 = ge.offdiag_p_values(T, P, dt, bc_value=st["bc"][1],
                                  bc_pressure=st["bc_pres"])
        v2 = ge.jacobian_e_values(T, P, dt, bc_value=st["bc"][1],
                                  bc_pressure=st["bc_pres"])
        vals = torch.cat([v1, v12, v21, v2], dim=1)[0]
        data = vals.new_zeros(self.template.nnz).index_add_(
            0, st["csr_slots"], vals)
        return self.template.indptr, self.template.indices, data

    def pre_solve(self, dt):
        """SOETHPreSolve: auxvars from soln_prev; per-GE accum_prev.  Also
        stages the BC / SS values and the cross-staged BC auxvars on the
        device for the SNES callbacks."""
        dev = device_of(self.device)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                      device=dev)[None, :]
        gm, ge = self.ge_mass, self.ge_energy
        self._stage = st = {
            "device": dev,
            "bc": [t(gm.bc_value), t(ge.bc_value)],
            "ss": [t(gm.ss_value), t(ge.ss_value)],
            "bc_temp": t(gm.bc_temperature),
            "bc_pres": t(ge.bc_pressure),
            "csr_slots": torch.as_tensor(self.template.slots,
                                         dtype=torch.long, device=dev)}
        P, T = self._split(t(self.soln_prev))
        am = gm.accum(P, dyn=self._mass_dyn(T))
        ae = ge.accum_e(T, P)
        st["accum_prev"] = [
            _swhere(gm._active(), am / dt, torch.zeros_like(am)),
            _swhere(ge._active(), ae / dt, torch.zeros_like(ae))]

    def post_solve(self, x):
        """PostSolve: the converged iterate becomes soln and soln_prev."""
        self.soln = np.array(x, np.float64)
        self.soln_prev = self.soln
        self.ge_mass.pressure = self.soln[:self.n]
        self.ge_energy.temperature = self.soln[self.n:]

    def step_dt(self, dt, nstep=1):
        """SOEBaseStepDT_SNES semantics (line-search rotation + dt cuts)
        on ``device``; returns (converged, reason)."""
        return snes_step_dt(self, dt, nstep, self._residual, self._jacobian,
                            [LS_BT, LS_L2])


class ThermalEnthalpySoE:
    """SOE_THERMAL_EBASED: the standalone enthalpy SoE.

    The reference's residual and Jacobian callbacks re-stage the auxvars
    from soln_prev on every SNES evaluation
    (SystemOfEquationsThermalEnthalpyType.F90:352,285), so the Newton
    solve is a single linearised implicit-Euler update
    T <- T_prev - J(T_prev)^-1 F(T_prev) a StepDT, solved by the PETSc
    default GMRES(30) + ILU(0) at rtol 1e-5.  The golden answers embed
    this single inexact update; a direct solve lands ~2e-4 K away.
    ``step_dt`` runs on ``device`` (the card unless ``"cpu"``)."""

    #: device of ``step_dt``
    device = "cuda"

    def __init__(self):
        self.ge: Optional[ThermalEnthalpyGE] = None
        self.itype = int(SOEType.THERMAL_EBASED)
        self.soln = None
        self.soln_prev = None
        self.template: Optional[CSRTemplate] = None
        self._ilu = None
        self.cumulative_newton_iterations = 0
        self.cumulative_linear_iterations = 0
        self.metrics = None

    @property
    def goveqns(self):
        return [self.ge] if self.ge is not None else []

    def setup(self):
        n = self.ge.mesh.ncells_local
        self.n = n
        r, c = self.ge.coo_coords(0, 0)
        self.template = csr_template(n, n, r, c)
        self.soln = np.zeros(n)
        self.soln_prev = np.zeros(n)

    def step_dt(self, dt, nstep=1):
        """One linearised update in f64 on ``self.device``; returns
        (converged, reason)."""
        ge = self.ge
        dev = device_of(self.device)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                      device=dev)[None, :]
        tpl = self.template
        if self._ilu is None:
            self._ilu = BatchedILU0(tpl.indptr, tpl.indices)
            self._ell = make_ell_matvec(tpl.indptr, tpl.indices)
        # the numpy engine's inner-iteration budget (maxiter 10000), in
        # whole cycles of min(30, n)
        T, _, _, its = linearised_update(
            ge, tpl, self._ilu, self._ell, t(self.soln_prev),
            t(np.asarray(ge.pressure)[:self.n]), dt,
            maxcycles=-(-10000 // min(30, self.n)))
        iters = int(its[0])
        self.cumulative_linear_iterations += iters
        self.soln = T[0].cpu().numpy()
        self.soln_prev = self.soln
        self.cumulative_newton_iterations += 1
        if self.metrics is not None:
            self.metrics.record(step=nstep, dt=dt, converged=True, reason=2,
                                newton_iterations=1, linear_iterations=iters)
        return True, 2


def linearised_update(ge, template, ilu, matvec, T_prev, P, dt,
                      bc_value=None, **gmres_kw):
    """The standalone enthalpy SoE's StepDT over the rows of ``T_prev`` /
    ``P`` [ncol, n]: accum_prev, the residual F and the Jacobian J at
    T_prev, the ILU(0) factor of J and GMRES(30) on J dx = -F.  Returns
    (T_prev + dx, GMRES cycles, converged[ncol], inner iterations[ncol]);
    ``gmres_kw`` goes to :func:`gmres_cycles` (``sync``, ``maxcycles``)."""
    acc = ge.accum_e(T_prev, P) / dt
    accum_prev = _swhere(ge._active(), acc, torch.zeros_like(acc))
    F = ge.residual_e(T_prev, P, dt, bc_value=bc_value,
                      accum_prev=accum_prev)
    data = template.assemble(
        ge.jacobian_e_values(T_prev, P, dt, bc_value=bc_value))
    check_finite("enthalpy residual", F)
    dx, cycles, conv, its = gmres_cycles(matvec, data, -F, ilu=ilu,
                                         pc_data=ilu.factor(data), **gmres_kw)
    check_finite("enthalpy update", dx)
    return T_prev + dx, cycles, conv, its


class THMPP(MPPBase):
    """mpp_th_type facade (MPP_TH_SNES_CLM) with the 8-step builder."""

    def __init__(self):
        super().__init__()
        self.soe = THSoE()

    def add_goveqn(self, ge_type, name, mesh_index=0):
        mesh = self.meshes[mesh_index]
        if ge_type == GEType.RE:
            self.soe.ge_mass = RichardsGE(name=name, mesh=mesh)
        elif ge_type == GEType.THERM_SOIL_EBASED:
            self.soe.ge_energy = ThermalEnthalpyGE(name=name, mesh=mesh)
        else:
            raise NotImplementedError(ge_type)

    def set_soils(self, filter_thermal, watsat, csol, tkdry, hksat, bsw,
                  sucsat, residual_sat, satfunc_type, density_type,
                  int_energy_type, grav=C.GRAV_CLM, denh2o=C.DENH2O):
        """MPPTHSetSoils (MultiPhysicsProbTH.F90:75-607): the Richards GE
        gets perm from hksat; the enthalpy GE keeps the 8.3913e-12 default
        perm and gets the thermal properties.  Column blocks are stacked
        per GE."""
        vish2o = 0.001002
        watsat = np.asarray(watsat)
        _, nlev = watsat.shape
        gm, ge = self.soe.ge_mass, self.soe.ge_energy
        col0 = 0
        for g in (gm, ge):
            n = g.mesh.ncells_all
            ncols = n // nlev
            g.density_type = int(density_type)
            for cc in range(ncols):
                col = col0 + cc
                for j in range(nlev):
                    icell = cc * nlev + j
                    perm = hksat[col, j] * vish2o / (denh2o * grav) * 0.001
                    alpha = 1.0 / (sucsat[col, j] * grav)
                    lam = 1.0 / bsw[col, j]
                    if g is gm:
                        g.perm[icell, :] = perm
                    g.por_params.porosity_base[icell] = watsat[col, j]
                    if satfunc_type == "van_genuchten":
                        g.sat_params.set_vg(icell, residual_sat[col, j],
                                            alpha, lam)
                    elif satfunc_type == "brooks_corey":
                        g.sat_params.set_bc(icell, residual_sat[col, j],
                                            alpha, lam)
                    else:
                        raise ValueError(satfunc_type)
                    if g is ge:
                        g.therm_alpha[icell] = 0.45
                        g.therm_cond_wet[icell] = 1.3
                        g.therm_cond_dry[icell] = tkdry[col, j]
                        g.heat_cap_soil[icell] = csol[col, j]
                        g.den_soil[icell] = 2700.0
            g._copy_params_to_bc_ss()
            if g is ge:
                g.set_int_energy_type(int_energy_type)
                bc_ids = g._bc_concat()[0]
                g.bc_therm_cond_wet = g.therm_cond_wet[bc_ids]
                g.bc_therm_cond_dry = g.therm_cond_dry[bc_ids]
                g.bc_therm_alpha = g.therm_alpha[bc_ids]
            g.invalidate()
            col0 += ncols

    def set_data(self, auxvar_kind, var_type, soe_auxvar_id, data):
        """SetDataFromCLM: ``soe_auxvar_id`` is the 1-based condition index
        over the GEs in order (BCs and SS counted apart)."""
        data = np.asarray(data, np.float64)
        if auxvar_kind not in (AuxVarKind.BC, AuxVarKind.SS):
            raise NotImplementedError(auxvar_kind)
        attr = "bc_value" if auxvar_kind == AuxVarKind.BC else "ss_value"
        conds = []
        for g in self.soe.goveqns:
            src = (g.boundary_conditions if auxvar_kind == AuxVarKind.BC
                   else g.source_sinks)
            for ci in range(len(src)):
                conds.append((g, src, ci))
        g, src, ci = conds[soe_auxvar_id - 1]
        off = sum(c.num_connections for c in src[:ci])
        vals = getattr(g, attr).copy()
        vals[off:off + src[ci].num_connections] = data
        setattr(g, attr, vals)

    def get_data(self, var_type):
        """GetDataForCLM: the [P-block; T-block] solution (numpy)."""
        return np.asarray(self.soe.soln)

    def set_initial_solution(self, P0, T0):
        X = np.concatenate([np.asarray(P0, np.float64),
                            np.asarray(T0, np.float64)])
        self.soe.soln = X
        self.soe.soln_prev = X.copy()


class ThermalEnthalpyMPP(MPPBase):
    """mpp_thermal_type facade (MPP_THERMAL_EBASED_SNES_CLM)."""

    def __init__(self):
        super().__init__()
        self.soe = ThermalEnthalpySoE()

    def _goveqns(self):
        return self.soe.goveqns

    def add_goveqn(self, ge_type, name, mesh_index=0):
        assert ge_type == GEType.THERM_SOIL_EBASED
        self.soe.ge = ThermalEnthalpyGE(name=name,
                                        mesh=self.meshes[mesh_index])

    def set_soils(self, filter_thermal, watsat, csol, tkdry, hksat, bsw,
                  sucsat, residual_sat, satfunc_type, density_type,
                  int_energy_type, grav=C.GRAV_CLM, denh2o=C.DENH2O):
        """MPPThermalSetSoils (MultiPhysicsProbThermalEnthalpy.F90:75-328):
        perm is NOT set (it stays at the 8.3913e-12 auxvar-init
        default)."""
        g = self.soe.ge
        watsat = np.asarray(watsat)
        ncol, nlev = watsat.shape
        g.density_type = int(density_type)
        g.set_int_energy_type(int_energy_type)
        for c in range(ncol):
            for j in range(nlev):
                icell = c * nlev + j
                alpha = 1.0 / (sucsat[c, j] * grav)
                lam = 1.0 / bsw[c, j]
                g.por_params.porosity_base[icell] = watsat[c, j]
                if satfunc_type == "van_genuchten":
                    g.sat_params.set_vg(icell, residual_sat[c, j], alpha, lam)
                elif satfunc_type == "brooks_corey":
                    g.sat_params.set_bc(icell, residual_sat[c, j], alpha, lam)
                else:
                    raise ValueError(satfunc_type)
                g.therm_alpha[icell] = 0.45
                g.therm_cond_wet[icell] = 1.3
                g.therm_cond_dry[icell] = tkdry[c, j]
                g.heat_cap_soil[icell] = csol[c, j]
                g.den_soil[icell] = 2700.0
        g._copy_params_to_bc_ss()
        bc_ids = g._bc_concat()[0]
        g.bc_therm_cond_wet = g.therm_cond_wet[bc_ids]
        g.bc_therm_cond_dry = g.therm_cond_dry[bc_ids]
        g.bc_therm_alpha = g.therm_alpha[bc_ids]
        g.invalidate()

    def set_data(self, auxvar_kind, var_type, soe_auxvar_id, data):
        g = self.soe.ge
        data = np.asarray(data, np.float64)
        if auxvar_kind == AuxVarKind.INTERNAL and var_type == Var.PRESSURE:
            P = np.array(g.pressure, np.float64)
            P[:data.size] = data
            g.pressure = P
            return
        if auxvar_kind == AuxVarKind.BC:
            off = sum(c.num_connections
                      for c in g.boundary_conditions[:soe_auxvar_id - 1])
            m = g.boundary_conditions[soe_auxvar_id - 1].num_connections
            vals = np.array(g.bc_value, np.float64)
            vals[off:off + m] = data
            g.bc_value = vals
            return
        raise NotImplementedError((auxvar_kind, var_type))

    def get_data(self, var_type):
        if var_type == Var.TEMPERATURE:
            return np.asarray(self.soe.soln)
        raise NotImplementedError(var_type)

    def set_initial_temperature(self, T0):
        X = np.array(T0, np.float64)
        self.soe.soln = X
        self.soe.soln_prev = X.copy()

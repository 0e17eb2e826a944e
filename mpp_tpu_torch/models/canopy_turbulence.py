"""Canopy turbulence: Harman & Finnigan roughness-sublayer (RSL) theory.
The port's own copy of ``mpp_tpu/models/canopy_turbulence.py`` (numpy):
the constants and derived inputs of the batched path and the serial
Brent path.

Reimplements:

* ``auxvar/CanopyTurbulenceAuxType.F90`` — per-column turbulence state
  (struct-of-arrays here), derived atmospheric inputs (:171-198)
* ``ge/CanopyTurbulence.F90`` — Obukhov-length fixed point via the
  secant/Brent ``hybrid`` solver (:42-64, 233-327), RSL wind profile
  (:67-106), aerodynamic conductance profile (:109-231), Monin-Obukhov
  phi/psi stability functions (:540-630), RSL-corrected psi
  (``ComputePsiRSL``, :330-404).

These run host-side in float64 (a handful of scalar root-solve iterations
per canopy column per step — setup cost, not the hot path) so the iterate
trajectory, and therefore the converged side-effect state, matches the
reference bit-for-bit.
"""
from __future__ import annotations

import math

import numpy as np

from mpp_tpu_torch.constants import (VKC, GRAVITY_CONSTANT, MM_H2O, MM_DRY_AIR,
                               CPD, CPW, RGAS)
from mpp_tpu_torch.ops.mathtools import hybrid
from mpp_tpu_torch.ops.rsl_psihat import load_psihat, lookup_psihat

# RSL parameters (CanopyTurbulence.F90:21-37)
CD = 0.25                # leaf drag coefficient
BETA_NEUTRAL_MAX = 0.35  # max neutral beta
CR = 0.3                 # beta_neutral parameter
C2 = 0.5                 # depth scale multiplier
PR0 = 0.5                # neutral Pr (Sc)
PR1 = 0.3                # Pr variation magnitude
PR2 = 2.0                # Pr variation scale
Z0MG = 0.01              # ground roughness length [m]
ZETA_MIN = -2.0
ZETA_MAX = 1.0
BETA_MIN = 0.2
BETA_MAX = 0.5
WIND_MIN = 0.1
RA_MAX = 500.0


class CanopyTurbulenceAuxVar:
    """Per-column turbulence state (CanopyTurbulenceAuxType.F90:15-73).

    All fields are float64 numpy arrays of shape [ncair] (scalars per
    canopy-air column) or [ncair, ncan_lev] for the profiles.
    """

    def __init__(self, ncair: int, ncan_lev: int = 93, ntop: int = 43):
        self.ncair = ncair
        self.ncan_lev = ncan_lev
        z = np.zeros
        self.ntop = np.full(ncair, ntop, np.int64)
        for name in ("hc", "zref", "pref", "uref", "qref", "tref", "rhref",
                     "eref", "ucan", "qcan", "tcan", "rhomol", "rhoair",
                     "cpair", "mmair", "thref", "thvref", "Lc", "c1m", "c1c",
                     "c2", "disp", "beta", "PrSc", "ustar", "tstar", "qstar",
                     "gac", "obu_ustar", "obu", "pai", "soil_tk", "soil_dz",
                     "soil_temperature", "soil_res", "soil_rhg", "soil_rn"):
            setattr(self, name, z(ncair))
        # zs profile (CanopyTurbulenceAuxType.F90:158-164)
        self.zs = np.zeros((ncair, ncan_lev))
        for k in range(1, ncan_lev):
            self.zs[:, k] = 0.25 + (k - 1) * 0.5
        self.wind = np.zeros((ncair, ncan_lev))
        self.ga_prof = np.zeros((ncair, ncan_lev))

    def compute_derived_atm_inputs(self, icair: int) -> None:
        """Derived molar/thermodynamic state from (pref, qref, tref, zref)
        (CanopyTurbulenceAuxType.F90:171-198)."""
        qref = self.qref[icair]
        pref = self.pref[icair]
        eref = qref * pref / (MM_H2O / MM_DRY_AIR
                              + (1.0 - MM_H2O / MM_DRY_AIR) * qref)
        self.eref[icair] = eref
        self.rhomol[icair] = pref / (RGAS * self.tref[icair])
        self.rhoair[icair] = (self.rhomol[icair] * MM_DRY_AIR
                              * (1.0 - (1.0 - MM_H2O / MM_DRY_AIR)
                                 * eref / pref))
        self.mmair[icair] = self.rhoair[icair] / self.rhomol[icair]
        self.thref[icair] = self.tref[icair] + 0.0098 * self.zref[icair]
        self.cpair[icair] = (CPD * (1.0 + (CPW / CPD - 1.0) * qref)
                             * self.mmair[icair])
        self.thvref[icair] = self.thref[icair] * (1.0 + 0.61 * qref)


def phim_monin_obukhov(zeta: float) -> float:
    """MO phi for momentum (CanopyTurbulence.F90:540-558)."""
    if zeta < 0.0:
        return 1.0 / math.sqrt(math.sqrt(1.0 - 16.0 * zeta))
    return 1.0 + 5.0 * zeta


def phic_monin_obukhov(zeta: float) -> float:
    """MO phi for scalars (CanopyTurbulence.F90:561-578)."""
    if zeta < 0.0:
        return 1.0 / math.sqrt(1.0 - 16.0 * zeta)
    return 1.0 + 5.0 * zeta


def psim_monin_obukhov(zeta: float) -> float:
    """MO psi for momentum (CanopyTurbulence.F90:581-605)."""
    if zeta < 0.0:
        x = math.sqrt(math.sqrt(1.0 - 16.0 * zeta))
        return (2.0 * math.log((1.0 + x) / 2.0)
                + math.log((1.0 + x * x) / 2.0)
                - 2.0 * math.atan(x) + math.pi * 0.5)
    return -5.0 * zeta


def psic_monin_obukhov(zeta: float) -> float:
    """MO psi for scalars (CanopyTurbulence.F90:608-630)."""
    if zeta < 0.0:
        x = math.sqrt(math.sqrt(1.0 - 16.0 * zeta))
        return 2.0 * math.log((1.0 + x * x) / 2.0)
    return -5.0 * zeta


def compute_psi_rsl(za: float, hc: float, disp: float, obu: float,
                    beta: float, prsc: float):
    """RSL-corrected psi for momentum and scalars at height ``za``
    (CanopyTurbulence.F90:330-404). Returns (psim, psic)."""
    tab = load_psihat()
    z_minus_d = za - disp
    h_minus_d = hc - disp

    # momentum
    phim = phim_monin_obukhov(h_minus_d / obu)
    c1 = (1.0 - VKC / (2.0 * beta * phim)) * math.exp(0.5 * C2)
    psi_m_zref = psim_monin_obukhov(z_minus_d / obu)
    psi_m_hc = psim_monin_obukhov(h_minus_d / obu)
    psihat1 = lookup_psihat((za - hc) / h_minus_d, h_minus_d / obu,
                            tab.zdt_m, tab.dtl_m, tab.psi_m)
    psihat2 = lookup_psihat(0.0, h_minus_d / obu,
                            tab.zdt_m, tab.dtl_m, tab.psi_m)
    psim = (-psi_m_zref + psi_m_hc + psihat1 * c1 - psihat2 * c1
            + VKC / beta)

    # scalar
    phic = phic_monin_obukhov(h_minus_d / obu)
    c1 = (1.0 - prsc * VKC / (2.0 * beta * phic)) * math.exp(0.5 * C2)
    psi_c_zref = psic_monin_obukhov(z_minus_d / obu)
    psi_c_hc = psic_monin_obukhov(h_minus_d / obu)
    psihat1 = lookup_psihat((za - hc) / h_minus_d, h_minus_d / obu,
                            tab.zdt_h, tab.dtl_h, tab.psi_h)
    psihat2 = lookup_psihat(0.0, h_minus_d / obu,
                            tab.zdt_h, tab.dtl_h, tab.psi_h)
    psic = -psi_c_zref + psi_c_hc + psihat1 * c1 - psihat2 * c1

    return psim, psic


def _obukhov(icair: int, cturb: CanopyTurbulenceAuxVar,
             obu_val: float) -> float:
    """Fixed-point residual for the Obukhov length; mutates ``cturb``
    exactly as the reference does on every call
    (CanopyTurbulence.F90:233-327)."""
    obu_cur = obu_val
    if abs(obu_cur) < 0.1:
        obu_cur = 0.1

    hc = cturb.hc[icair]
    pai = cturb.pai[icair]
    Lc = cturb.Lc[icair]
    zref = cturb.zref[icair]

    c1 = (VKC / math.log((hc + Z0MG) / Z0MG)) ** 2.0
    beta_neutral = min(math.sqrt(c1 + CR * pai), BETA_NEUTRAL_MAX)

    LcL = Lc / obu_cur
    if LcL <= 0.0:
        b = 16.0 * LcL * beta_neutral ** 4.0
        beta = math.sqrt(0.5 * (-b + math.sqrt(b ** 2.0
                                               + 4.0 * beta_neutral ** 4.0)))
    else:
        a = 5.0 * LcL
        b = 0.0
        c = 1.0
        d = -beta_neutral
        q = ((2.0 * b ** 3.0 - 9.0 * a * b * c + 27.0 * a ** 2 * d) ** 2.0
             - 4.0 * (b ** 2.0 - 3.0 * a * c) ** 3.0)
        q = math.sqrt(q)
        r = 0.5 * (q + 2.0 * b ** 3.0 - 9.0 * a * b * c + 27.0 * a ** 2 * d)
        r = r ** (1.0 / 3.0)
        beta = -(b + r) / (3.0 * a) - (b ** 2.0 - 3.0 * a * c) / (3.0 * a * r)

    beta = min(BETA_MAX, max(beta, BETA_MIN))
    cturb.beta[icair] = beta

    dp = beta ** 2.0 * Lc
    dp = dp * (1.0 - math.exp(-0.25 * pai / beta ** 2.0))
    dp = min(hc, dp)
    cturb.disp[icair] = max(hc - dp, 0.0)
    disp = cturb.disp[icair]

    z_minus_d = zref - disp
    h_minus_d = hc - disp

    prsc = PR0 + PR1 * math.tanh(PR2 * Lc / obu_cur)
    prsc = ((1.0 - beta_neutral / BETA_NEUTRAL_MAX) * 1.0
            + (beta_neutral / BETA_NEUTRAL_MAX) * prsc)
    cturb.PrSc[icair] = prsc

    zeta = (zref - disp) / obu_cur
    if zeta >= 0.0:
        zeta = min(ZETA_MAX, max(zeta, 0.01))
    else:
        zeta = max(ZETA_MIN, min(zeta, -0.01))
    obu_cur = (zref - disp) / zeta

    phi_m_hc = phim_monin_obukhov(h_minus_d / obu_cur)

    cturb.c2[icair] = C2
    cturb.c1m[icair] = ((1.0 - VKC / (2.0 * beta * phi_m_hc))
                        * math.exp(0.5 * cturb.c2[icair]))

    psim, psic = compute_psi_rsl(zref, hc, disp, obu_cur, beta, prsc)

    zlog = math.log(z_minus_d / h_minus_d)
    cturb.ustar[icair] = cturb.uref[icair] * VKC / (zlog + psim)
    cturb.tstar[icair] = ((cturb.thref[icair] - cturb.tcan[icair])
                          * VKC / (zlog + psic))
    cturb.qstar[icair] = ((cturb.qref[icair] - cturb.qcan[icair])
                          * VKC / (zlog + psic))
    cturb.obu_ustar[icair] = obu_cur

    cturb.gac[icair] = (cturb.rhomol[icair] * VKC * cturb.ustar[icair]
                        / (zlog + psic))

    tvstar = (cturb.tstar[icair]
              + 0.61 * cturb.thref[icair] * cturb.qstar[icair])
    cturb.obu[icair] = (cturb.ustar[icair] ** 2.0 * cturb.thvref[icair]
                        / (VKC * GRAVITY_CONSTANT * tvstar))

    return cturb.obu[icair] - obu_val


def obukhov_length(cturb: CanopyTurbulenceAuxVar) -> None:
    """Solve the Obukhov-length fixed point per column
    (CanopyTurbulence.F90:42-64)."""
    for icair in range(cturb.ncair):
        cturb.Lc[icair] = cturb.hc[icair] / (CD * cturb.pai[icair])
        hybrid(lambda x: _obukhov(icair, cturb, x), 100.0, -100.0, 0.01)
        cturb.obu[icair] = cturb.obu_ustar[icair]


def wind_profile(cturb: CanopyTurbulenceAuxVar) -> None:
    """RSL wind profile (CanopyTurbulence.F90:67-106)."""
    for icair in range(cturb.ncair):
        hc = cturb.hc[icair]
        disp = cturb.disp[icair]
        ntop = int(cturb.ntop[icair])
        h_minus_d = hc - disp
        for k in range(ntop, cturb.ncan_lev):   # 0-based: Fortran ntop+1..ncan_lev
            z = cturb.zs[icair, k]
            psim, _ = compute_psi_rsl(z, hc, disp, cturb.obu[icair],
                                      cturb.beta[icair], cturb.PrSc[icair])
            cturb.wind[icair, k] = (cturb.ustar[icair] / VKC
                                    * (math.log((z - disp) / h_minus_d) + psim))
        cturb.ucan[icair] = cturb.ustar[icair] / cturb.beta[icair]
        lm = 2.0 * cturb.beta[icair] ** 3.0 * cturb.Lc[icair]
        lm_over_beta = lm / cturb.beta[icair]
        for k in range(1, ntop):                # Fortran 2..ntop
            w = cturb.ucan[icair] * math.exp(
                (cturb.zs[icair, k] - hc) / lm_over_beta)
            cturb.wind[icair, k] = max(w, WIND_MIN)
        cturb.wind[icair, 0] = 0.0


def aerodynamic_conductances(cturb: CanopyTurbulenceAuxVar) -> None:
    """Layer-to-layer aerodynamic conductance profile
    (CanopyTurbulence.F90:109-231)."""
    for icair in range(cturb.ncair):
        hc = cturb.hc[icair]
        disp = cturb.disp[icair]
        obu = cturb.obu[icair]
        beta = cturb.beta[icair]
        prsc = cturb.PrSc[icair]
        rhomol = cturb.rhomol[icair]
        ustar = cturb.ustar[icair]
        zref = cturb.zref[icair]
        ntop = int(cturb.ntop[icair])
        zs = cturb.zs[icair]
        ga = cturb.ga_prof[icair]
        nlev = cturb.ncan_lev

        # Above canopy (Fortran k=ntop+1..ncan_lev-1 → 0-based ntop..nlev-2)
        for k in range(ntop, nlev - 1):
            _, psic1 = compute_psi_rsl(zs[k], hc, disp, obu, beta, prsc)
            _, psic2 = compute_psi_rsl(zs[k + 1], hc, disp, obu, beta, prsc)
            psic = psic2 - psic1
            zlog = math.log((zs[k + 1] - disp) / (zs[k] - disp))
            ga[k] = rhomol * VKC * ustar / (zlog + psic)

        # Top layer to reference height (Fortran k=ncan_lev)
        _, psic1 = compute_psi_rsl(zs[nlev - 1], hc, disp, obu, beta, prsc)
        _, psic2 = compute_psi_rsl(zref, hc, disp, obu, beta, prsc)
        psic = psic2 - psic1
        zlog = math.log((zref - disp) / (zs[nlev - 1] - disp))
        ga[nlev - 1] = rhomol * VKC * ustar / (zlog + psic)

        # Within canopy (Fortran k=2..ntop-1 → 0-based 1..ntop-2)
        lm = 2.0 * beta ** 3.0 * cturb.Lc[icair]
        lm_over_beta = lm / beta
        for k in range(1, ntop - 1):
            zl = zs[k] - hc
            zu = zs[k + 1] - hc
            res = (prsc / (beta * ustar)
                   * (math.exp(-zl / lm_over_beta)
                      - math.exp(-zu / lm_over_beta)))
            ga[k] = rhomol / res

        # Top-of-canopy layer (Fortran k=ntop → 0-based ntop-1)
        k = ntop - 1
        zl = zs[k] - hc
        res = (prsc / (beta * ustar)
               * (math.exp(-zl / lm_over_beta) - math.exp(0.0)))
        ga_below_hc = rhomol / res
        _, psic1 = compute_psi_rsl(hc, hc, disp, obu, beta, prsc)
        _, psic2 = compute_psi_rsl(zs[k + 1], hc, disp, obu, beta, prsc)
        psic = psic2 - psic1
        zlog = math.log((zs[k + 1] - disp) / (hc - disp))
        ga_above_hc = rhomol * VKC * ustar / (zlog + psic)
        ga[k] = 1.0 / (1.0 / ga_below_hc + 1.0 / ga_above_hc)

        # Consistency check vs 1/gac (CanopyTurbulence.F90:195-203)
        sumres = 1.0 / ga_above_hc
        for k2 in range(ntop, nlev):
            sumres = sumres + 1.0 / ga[k2]
        if abs(1.0 / sumres - cturb.gac[icair]) > 1e-06:
            raise RuntimeError(
                "Above canopy conductances do not sum to 1/gac")

        # At ground (Fortran k=1)
        zoc_g = 0.1 * Z0MG
        zlog_m = math.log(zs[1] / Z0MG)
        zlog_c = math.log(zs[1] / zoc_g)
        ustar_g = cturb.wind[icair, 1] * VKC / zlog_m
        ustar_g = max(ustar_g, 0.01)
        res = zlog_c / (VKC * ustar_g)
        ga[0] = rhomol / res
        res = min(rhomol / ga[0], RA_MAX)
        ga[0] = rhomol / res

        # Limit resistance to < 500 s/m (Fortran k=2..ncan_lev)
        for k2 in range(1, nlev):
            res = min(rhomol / ga[k2], 500.0)
            ga[k2] = rhomol / res

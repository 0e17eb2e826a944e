"""Water equation of state: density and viscosity with derivatives.

Counterpart of ``mpp_tpu/ops/eos.py:34-260`` (EOSWaterMod.F90:38-344,
568-586).  Elementwise functions over tensors; each returns the value and
its analytic derivatives.  Units: density [kmol m^-3], pressure [Pa],
temperature [K] unless noted.  Internal energy and enthalpy come with the
TH slice.
"""
from __future__ import annotations

import torch

from mpp_tpu.constants import FMWH2O, DENH2O

# Density model ids (EOSWaterMod.F90:19-21)
DENSITY_CONSTANT = 1
DENSITY_TGDPB01 = 2
DENSITY_IFC67 = 3

H2O_CRITICAL_TEMPERATURE = 647.3   # [K]   (EOSWaterMod.F90:27)
H2O_CRITICAL_PRESSURE = 22.064e6   # [Pa]  (EOSWaterMod.F90:28)


def density_constant(p, t_K):
    """Constant density [kmol/m^3] (EOSWaterMod.F90:80-99)."""
    den = torch.full_like(p, DENH2O / FMWH2O)
    zero = torch.zeros_like(p)
    return den, zero, zero


def density_tgdpb01(p, t_K):
    """Tanaka et al. (2001) density and d/dP, d/dT (EOSWaterMod.F90:102-178)."""
    a1 = -3.983035
    a2 = 301.797
    a3 = 522528.9
    a4 = 69.34881
    a5 = 999.974950
    k0 = 50.74e-11
    k1 = -0.326e-11
    k2 = 0.00416e-11
    p0 = 101325.0

    t_c = t_K - 273.15
    dent = a5 * (1.0 - ((t_c + a1) ** 2.0) * (t_c + a2) / a3 / (t_c + a4))

    above = p > p0
    kappa = torch.where(above,
                        1.0 + (k0 + k1 * t_c + k2 * t_c ** 2.0) * (p - p0),
                        1.0)
    den = dent * kappa / FMWH2O

    ddent_dt_1 = -((t_c + a1) ** 2.0) / a3 / (t_c + a4)
    ddent_dt_2 = -2.0 * (t_c + a1) * (t_c + a2) / a3 / (t_c + a4)
    ddent_dt_3 = ((t_c + a1) ** 2.0) * (t_c + a2) / a3 / ((t_c + a4) ** 2.0)
    ddent_dt = a5 * (ddent_dt_1 + ddent_dt_2 + ddent_dt_3)

    dkappa_dp = torch.where(above, k0 + k1 * t_c + k2 * t_c ** 2.0, 0.0)
    dkappa_dt = torch.where(above, (k1 + 2.0 * k2 * t_c) * (p - p0), 0.0)

    dden_dT = (ddent_dt * kappa + dent * dkappa_dt) / FMWH2O
    dden_dp = (dent * dkappa_dp) / FMWH2O
    return den, dden_dp, dden_dT


# IFC-67 steam-table coefficients (EOSWaterMod.F90:236-255)
_AA = (
    6.824687741e03, -5.422063673e02, -2.096666205e04, 3.941286787e04,
    -6.733277739e04, 9.902381028e04, -1.093911774e05, 8.590841667e04,
    -4.511168742e04, 1.418138926e04, -2.017271113e03, 7.982692717e00,
    -2.616571843e-2, 1.522411790e-3, 2.284279054e-2, 2.421647003e02,
    1.269716088e-10, 2.074838328e-7, 2.174020350e-8, 1.105710498e-9,
    1.293441934e01, 1.308119072e-5, 6.047626338e-14,
)
_A1, _A2, _A3, _A4 = 8.438375405e-1, 5.362162162e-4, 1.720000000e00, 7.342278489e-2
_A5, _A6, _A7, _A8 = 4.975858870e-2, 6.537154300e-1, 1.150000000e-6, 1.510800000e-5
_A9, _A10, _A11, _A12 = 1.418800000e-1, 7.002753165e00, 2.995284926e-4, 2.040000000e-1
_VC1 = 0.00317  # [m^3/kg]


def density_ifc67(t_C, p):
    """IFC-67 liquid water density and derivatives (EOSWaterMod.F90:181-344).

    ``t_C`` in Celsius, ``p`` in Pa.  Returns (dw [kg/m^3], dwmol
    [kmol/m^3], dwp [kmol/m^3/Pa], dwt [kmol/m^3/C]).  Valid for
    0 < p < 165.4e5 Pa, 0 < t < 350 C.
    """
    aa = _AA
    vc1mol = _VC1 * FMWH2O
    utc1 = 1.0 / H2O_CRITICAL_TEMPERATURE
    upc1 = 1.0 / H2O_CRITICAL_PRESSURE
    theta = (t_C + 273.15) * utc1
    beta = p * upc1
    theta2x = theta * theta
    theta18 = theta ** 18.0
    theta20 = theta18 * theta2x
    beta2x = beta * beta

    yy = 1.0 - _A1 * theta2x - _A2 * theta ** (-6.0)
    xx_raw = _A3 * yy * yy - 2.0 * (_A4 * theta - _A5 * beta)
    # negative near the critical point, where the reference aborts; clamp
    # so the function stays total (the JAX form does the same)
    xx = torch.where(xx_raw > 0.0, torch.sqrt(torch.clamp_min(xx_raw, 0.0)),
                     1.0e-6)
    zz = yy + xx
    u0 = -5.0 / 17.0
    u1 = aa[11] * _A5 * zz ** u0
    u2 = 1.0 / (_A8 + theta ** 11.0)
    u3 = aa[17] + (2.0 * aa[18] + 3.0 * aa[19] * beta) * beta
    u4 = 1.0 / (_A7 + theta18 * theta)
    u5 = (_A10 + beta) ** (-4.0)
    u6 = _A11 - 3.0 * u5
    u7 = aa[20] * theta18 * (_A9 + theta2x)
    u8 = aa[15] * (_A6 - theta) ** 9.0

    vr = (u1 + aa[12] + theta * (aa[13] + aa[14] * theta) + u8 * (_A6 - theta)
          + aa[16] * u4 - u2 * u3 - u6 * u7
          + (3.0 * aa[21] * (_A12 - theta) + 4.0 * aa[22] * beta / theta20)
          * beta2x)

    dwmol = 1.0 / (vr * vc1mol)
    dw = 1.0 / (vr * _VC1)

    ypt = 6.0 * _A2 * theta ** (-7.0) - 2.0 * _A1 * theta
    zpt = ypt + (_A3 * yy * ypt - _A4) / xx
    zpp = _A5 / xx
    u9 = u0 * u1 / zz
    vrpt = (u9 * zpt + aa[13] + 2.0 * aa[14] * theta - 10.0 * u8
            - 19.0 * aa[16] * u4 * u4 * theta18
            + 11.0 * u2 * u2 * u3 * theta ** 10.0
            - aa[20] * u6 * (18.0 * _A9 * theta18 + 20.0 * theta20) / theta
            - (3.0 * aa[21] + 80.0 * aa[22] * beta / (theta20 * theta))
            * beta2x)
    vrpp = (u9 * zpp - u2 * (2.0 * aa[18] + 6.0 * aa[19] * beta)
            - 12.0 * u7 * u5 / (_A10 + beta)
            + (6.0 * aa[21] * (_A12 - theta) + 12.0 * aa[22] * beta / theta20)
            * beta)

    cnv = -1.0 / (vc1mol * vr * vr)
    dwt = cnv * vrpt * utc1
    dwp = cnv * vrpp * upc1
    return dw, dwmol, dwp, dwt


def density(p, t_K, density_itype):
    """Dispatch over density models (EOSWaterMod.F90:38-77); the model id
    is a Python int.  Returns (den [kmol/m^3], dden_dp, dden_dT)."""
    if density_itype == DENSITY_CONSTANT:
        return density_constant(p, t_K)
    if density_itype == DENSITY_TGDPB01:
        return density_tgdpb01(p, t_K)
    if density_itype == DENSITY_IFC67:
        _, dwmol, dwp, dwt = density_ifc67(t_K - 273.15, p)
        return dwmol, dwp, dwt
    raise ValueError(f"Unknown density_itype {density_itype}")


def viscosity(p, t_K):
    """Constant water viscosity [Pa s] (EOSWaterMod.F90:568-586)."""
    vis = torch.full_like(p, 8.904156e-4)
    zero = torch.zeros_like(p)
    return vis, zero, zero

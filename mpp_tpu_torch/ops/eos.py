"""Water equation of state: density and viscosity with derivatives.

Counterpart of ``mpp_tpu/ops/eos.py`` (EOSWaterMod.F90:38-707).
Elementwise functions over tensors; each returns the value and its
analytic derivatives.  Units: density [kmol m^-3], pressure [Pa],
temperature [K] unless noted.  ``enthalpy_ifc67_np`` is a numpy twin with
gfortran/glibc rounding for the finite-difference MMS sources.
"""
from __future__ import annotations

import numpy as np
import torch

from mpp_tpu_torch.constants import FMWH2O, DENH2O

# Density model ids (EOSWaterMod.F90:19-21)
DENSITY_CONSTANT = 1
DENSITY_TGDPB01 = 2
DENSITY_IFC67 = 3

# Internal energy / enthalpy model ids (EOSWaterMod.F90:23-24)
INT_ENERGY_ENTHALPY_CONSTANT = 1
INT_ENERGY_ENTHALPY_IFC67 = 2

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


def _ifc67_theta_beta(t_C, p):
    utc1 = 1.0 / H2O_CRITICAL_TEMPERATURE
    upc1 = 1.0 / H2O_CRITICAL_PRESSURE
    theta = (t_C + 273.15) * utc1
    beta = p * upc1
    return theta, beta, utc1, upc1


def _ifc67_xx(yy, theta, beta):
    """sqrt of the IFC-67 discriminant; negative near the critical point,
    where the reference aborts: clamped so the function stays total (the
    JAX form does the same)."""
    xx_raw = _A3 * yy * yy - 2.0 * (_A4 * theta - _A5 * beta)
    return torch.where(xx_raw > 0.0, torch.sqrt(torch.clamp_min(xx_raw, 0.0)),
                       1.0e-6)


def density_ifc67(t_C, p):
    """IFC-67 liquid water density and derivatives (EOSWaterMod.F90:181-344).

    ``t_C`` in Celsius, ``p`` in Pa.  Returns (dw [kg/m^3], dwmol
    [kmol/m^3], dwp [kmol/m^3/Pa], dwt [kmol/m^3/C]).  Valid for
    0 < p < 165.4e5 Pa, 0 < t < 350 C.
    """
    aa = _AA
    vc1mol = _VC1 * FMWH2O
    theta, beta, utc1, upc1 = _ifc67_theta_beta(t_C, p)
    theta2x = theta * theta
    theta18 = theta ** 18.0
    theta20 = theta18 * theta2x
    beta2x = beta * beta

    yy = 1.0 - _A1 * theta2x - _A2 * theta ** (-6.0)
    xx = _ifc67_xx(yy, theta, beta)
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


def enthalpy_ifc67(t_C, p):
    """IFC-67 liquid water enthalpy [J/kmol] and d/dP, d/dT
    (EOSWaterMod.F90:347-565).  Near 2e7 J/kmol: in f32 the sum of terms
    loses digits to cancellation."""
    aa = _AA
    vc1mol = _VC1 * FMWH2O
    pc1 = H2O_CRITICAL_PRESSURE
    theta, beta, utc1, upc1 = _ifc67_theta_beta(t_C, p)
    theta2x = theta * theta
    theta18 = theta ** 18.0
    theta20 = theta18 * theta2x
    beta2x = beta * beta
    beta4 = beta2x * beta2x

    yy = 1.0 - _A1 * theta2x - _A2 * theta ** (-6.0)
    xx = _ifc67_xx(yy, theta, beta)
    zz = yy + xx
    u0 = -5.0 / 17.0
    u1 = aa[11] * _A5 * zz ** u0
    ypt = 6.0 * _A2 * theta ** (-7.0) - 2.0 * _A1 * theta

    utheta = 1.0 / theta
    term1 = aa[0] * theta
    term2 = -aa[1]
    term2t = 0.0
    for i in range(3, 11):
        tempreal = float(i - 2) * aa[i] * _powi(theta, i - 1)
        term2t = term2t + tempreal * utheta * float(i - 1)
        term2 = term2 + tempreal

    v0_1 = u1 / _A5
    v2_1 = 17.0 * (zz / 29.0 - yy / 12.0) + 5.0 * theta * ypt / 12.0
    v3_1 = _A4 * theta - (_A3 - 1.0) * theta * yy * ypt
    v1_1 = zz * v2_1 + v3_1
    term3 = v0_1 * v1_1

    v1_2 = 9.0 * theta + _A6
    v20_2 = _A6 - theta
    v2_2 = v20_2 ** 9.0
    v3_2 = _A7 + 20.0 * theta ** 19.0
    v40_2 = _A7 + theta ** 19.0
    v4_2 = 1.0 / (v40_2 * v40_2)
    term4p = (aa[12] - aa[14] * theta2x + aa[15] * v1_2 * v2_2
              + aa[16] * v3_2 * v4_2)
    term4 = term4p * beta

    v1_3 = beta * (aa[17] + aa[18] * beta + aa[19] * beta2x)
    v2_3 = 12.0 * theta ** 11.0 + _A8
    v4_3 = 1.0 / (_A8 + theta ** 11.0)
    v3_3 = v4_3 * v4_3
    term5 = v1_3 * v2_3 * v3_3

    v1_4 = (_A10 + beta) ** (-3.0) + _A11 * beta
    v3_4 = 17.0 * _A9 + 19.0 * theta2x
    v2_4 = aa[20] * theta18 * v3_4
    term6 = v1_4 * v2_4

    v1_5 = 21.0 * aa[22] / theta20 * beta4
    v2_5 = aa[21] * _A12 * beta2x * beta
    term7 = v1_5 + v2_5

    v1_6 = pc1 * vc1mol
    hw = (term1 - term2 + term3 + term4 - term5 + term6 + term7) * v1_6

    zpt = ypt + (_A3 * yy * ypt - _A4) / xx
    zpp = _A5 / xx

    yptt = -2.0 * _A1 - 42.0 * _A2 / theta ** 8.0
    dv2t = 17.0 * (zpt / 29.0 - ypt / 12.0) + 5.0 / 12.0 * (ypt + theta * yptt)
    dv3t = _A4 - (_A3 - 1.0) * (theta * yy * yptt + yy * ypt
                                + theta * ypt * ypt)
    dv2p = 17.0 * zpp / 29.0
    v4_1 = 5.0 * v1_1 / (17.0 * zz)
    term3t = v0_1 * (zz * dv2t + (v2_1 - v4_1) * zpt + dv3t)
    term3p = v0_1 * (zz * dv2p + (v2_1 - v4_1) * zpp)

    term4t = (-2.0 * aa[14] * theta
              + 9.0 * aa[15] * (v2_2 - v1_2 * v2_2 / v20_2)
              + 38.0 * theta18 * aa[16] * (10.0 * v4_2 - v3_2 * v4_2 / v40_2)
              ) * beta

    term5p = v3_3 * v2_3 * (aa[17] + 2.0 * aa[18] * beta
                            + 3.0 * aa[19] * beta2x)
    term5t = v1_3 * (132.0 * v3_3 * theta ** 10.0
                     - 22.0 * v2_3 * v3_3 * v4_3 * theta ** 10.0)

    term6p = v2_4 * (_A11 - 3.0 * (_A10 + beta) ** (-4.0))
    term6t = v1_4 * aa[20] * theta18 * (18.0 * v3_4 * utheta + 38.0 * theta)

    term7p = beta2x * (3.0 * aa[21] * _A12 + 84.0 * aa[22] * beta / theta20)
    term7t = -420.0 * aa[22] * beta4 / (theta20 * theta)

    hwp = (term3p + term4p - term5p + term6p + term7p) * vc1mol
    hwt = (aa[0] - term2t + term3t + term4t - term5t + term6t + term7t) \
        * v1_6 * utc1
    return hw, hwp, hwt


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


def internal_energy_and_enthalpy(p, t_K, itype, den, dden_dT, dden_dP):
    """Internal energy U and enthalpy H [J/kmol] with d/dT and d/dP
    (EOSWaterMod.F90:589-707): (U, H, dU_dT, dH_dT, dU_dP, dH_dP).
    ``den`` and its derivatives in [kg/m^3], as in the reference
    signature; the model id is a Python int."""
    if itype == INT_ENERGY_ENTHALPY_CONSTANT:
        u0 = 4.217e3  # [J/kg/K]
        U = u0 * (t_K - 273.15)
        dU_dT = torch.full_like(U, u0)
        dU_dP = torch.zeros_like(U)
        H = U + p / den
        dH_dT = dU_dT - p / (den ** 2.0) * dden_dT
        dH_dP = dU_dP + 1.0 / den - p / (den ** 2.0) * dden_dP
        return (U * FMWH2O, H * FMWH2O, dU_dT * FMWH2O, dH_dT * FMWH2O,
                dU_dP * FMWH2O, dH_dP * FMWH2O)
    if itype == INT_ENERGY_ENTHALPY_IFC67:
        H, dH_dP, dH_dT = enthalpy_ifc67(t_K - 273.15, p)
        den_mol = den / FMWH2O
        U = H - p / den_mol
        dU_dT = dH_dT + p / (den_mol ** 2.0) * (dden_dT / FMWH2O)
        dU_dP = (dH_dP - 1.0 / den_mol
                 + p / (den_mol ** 2.0) * (dden_dP / FMWH2O))
        return U, H, dU_dT, dH_dT, dU_dP, dH_dP
    raise ValueError(f"Unknown internal-energy itype {itype}")


def _powi(x, n: int):
    """x ** n for a non-zero Python int n (a tensor or a numpy array) by
    right-to-left binary powering: the multiplication sequence of JAX's
    ``integer_pow`` and of gfortran's ``_gfortran_pow_r8_i4`` / libgcc
    ``__powidf2``.  ``pow`` rounds differently, and the IFC-67 enthalpy's
    cancellation near 0 C turns an ulp there into 1e-9 relative."""
    u = abs(int(n))
    if u == 0:
        raise ValueError("_powi: n must be non-zero")
    acc = None
    while u:
        if u & 1:
            acc = x if acc is None else acc * x
        u >>= 1
        if u:
            x = x * x
    return 1.0 / acc if n < 0 else acc


def enthalpy_ifc67_np(t_C, p):
    """Value-only numpy twin of :func:`enthalpy_ifc67` with gfortran/glibc
    rounding (EOSWaterMod.F90:347-565): real exponents through libm
    ``pow``, the term2 loop's integer exponents through :func:`_powi`.
    The MMS drivers central-difference the enthalpy with pert=1e-6
    (th_mms_problem.F90:1404-1418), which amplifies its rounding noise
    (~1e-5 on ~2e7) by 5e5, so the sources need this exact sequence."""
    aa = np.array(_AA)
    t_C = np.asarray(t_C, np.float64)
    p = np.asarray(p, np.float64)
    utc1 = 1.0 / H2O_CRITICAL_TEMPERATURE
    upc1 = 1.0 / H2O_CRITICAL_PRESSURE
    vc1mol = _VC1 * FMWH2O

    theta = (t_C + 273.15) * utc1
    theta2x = theta * theta
    theta18 = theta ** 18.0
    theta20 = theta18 * theta2x
    beta = p * upc1
    beta2x = beta * beta
    beta4 = beta2x * beta2x

    yy = 1.0 - _A1 * theta2x - _A2 * theta ** (-6.0)
    xx = np.sqrt(_A3 * yy * yy - 2.0 * (_A4 * theta - _A5 * beta))
    zz = yy + xx
    u0 = -5.0 / 17.0
    u1 = aa[11] * _A5 * zz ** u0
    ypt = 6.0 * _A2 * theta ** (-7.0) - 2.0 * _A1 * theta

    term1 = aa[0] * theta
    term2 = np.full_like(theta, -aa[1])
    for i in range(3, 11):
        term2 = term2 + float(i - 2) * aa[i] * _powi(theta, i - 1)

    v0_1 = u1 / _A5
    v2_1 = 17.0 * (zz / 29.0 - yy / 12.0) + 5.0 * theta * ypt / 12.0
    v3_1 = _A4 * theta - (_A3 - 1.0) * theta * yy * ypt
    v1_1 = zz * v2_1 + v3_1
    term3 = v0_1 * v1_1

    v1_2 = 9.0 * theta + _A6
    v20_2 = _A6 - theta
    v2_2 = v20_2 ** 9.0
    v3_2 = _A7 + 20.0 * theta ** 19.0
    v40_2 = _A7 + theta ** 19.0
    v4_2 = 1.0 / (v40_2 * v40_2)
    term4p = (aa[12] - aa[14] * theta2x + aa[15] * v1_2 * v2_2
              + aa[16] * v3_2 * v4_2)
    term4 = term4p * beta

    v1_3 = beta * (aa[17] + aa[18] * beta + aa[19] * beta2x)
    v2_3 = 12.0 * theta ** 11.0 + _A8
    v4_3 = 1.0 / (_A8 + theta ** 11.0)
    v3_3 = v4_3 * v4_3
    term5 = v1_3 * v2_3 * v3_3

    v1_4 = (_A10 + beta) ** (-3.0) + _A11 * beta
    v3_4 = 17.0 * _A9 + 19.0 * theta2x
    v2_4 = aa[20] * theta18 * v3_4
    term6 = v1_4 * v2_4

    v1_5 = 21.0 * aa[22] / theta20 * beta4
    v2_5 = aa[21] * _A12 * beta2x * beta
    term7 = v1_5 + v2_5

    v1_6 = H2O_CRITICAL_PRESSURE * vc1mol
    return (term1 - term2 + term3 + term4 - term5 + term6 + term7) * v1_6

"""Plain PyTorch reference of one VSFM (Richards) implicit timestep.

The equations of MPP's VSFM: the mass residual of one backward-Euler step
of ``dt`` over a set of cells joined by Darcy connections,

    F_i = (M_i(P) - M_i(P_prev)) / dt + sum of the Darcy fluxes out of i
          + the seepage flux out of i - the mass sources of i        [kmol/s]

with M = porosity * density * saturation * volume.  Written from the
published descriptions: the smoothed Brooks-Corey (bz3) and van Genuchten
saturation functions with Mualem relative permeability
(SaturationFunction.F90), the Tanaka et al. (2001) density (TGDPB01) and
constant viscosity of EOSWaterMod.F90, and the two-point Darcy flux of
RichardsMod.F90 (harmonic permeability, density weighted by distance,
upwinded mobility, a seepage face that takes no inflow).  Derivatives come
from autograd, so nothing here shares the program's hand-written Jacobian.

Every function takes tensors ``[B, n]``: B independent systems of n cells
that share one connection topology.  It imports neither the program nor
JAX.
"""
from __future__ import annotations

import numpy as np
import torch

PRESSURE_REF = 101325.0          # [Pa]
GRAVITY = 9.80665                # [m s^-2]
FMWH2O = 18.01534                # [kg kmol^-1]
GRAV_CLM = 9.80616               # CLM's gravity [m s^-2]
DENH2O = 1000.0                  # [kg m^-3]
VISH2O_CLM = 0.001002            # VSFMMPPSetSoilsCLM's viscosity [Pa s]
VISCOSITY = 8.904156e-4          # EOSWaterMod's constant viscosity [Pa s]
T_DEFAULT = 298.15               # the auxvars' default temperature [K]


def density_tgdpb01(P, t_K=T_DEFAULT):
    """Tanaka et al. (2001) liquid density [kmol m^-3]."""
    t_c = t_K - 273.15
    a1, a2, a3, a4, a5 = -3.983035, 301.797, 522528.9, 69.34881, 999.974950
    k0, k1, k2 = 50.74e-11, -0.326e-11, 0.00416e-11
    dent = a5 * (1.0 - (t_c + a1) ** 2 * (t_c + a2) / a3 / (t_c + a4))
    kappa = 1.0 + (k0 + k1 * t_c + k2 * t_c ** 2) * (P - PRESSURE_REF)
    kappa = torch.where(P > PRESSURE_REF, kappa, torch.ones_like(P))
    return dent * kappa / FMWH2O


def sbc_bz3_params(alpha, lam):
    """The smoothed Brooks-Corey (bz3) parameters of numpy ``alpha`` [1/Pa]
    and ``lam``: ps = -0.9 / alpha, pu where the cubic's b3 vanishes (a
    bracketed Newton on gu = -alpha pu, vectorised), and b2."""
    alpha = np.asarray(alpha, np.float64)
    lam = np.asarray(lam, np.float64)
    AA, gs = 2.0, 0.9
    gu = (AA / (AA + lam)) ** (-1.0 / lam)
    lo, hi = np.ones_like(gu), gu.copy()
    todo = np.ones(gu.shape, bool)
    for _ in range(200):
        if not todo.any():
            break
        out = (gu <= lo) | (gu >= hi)
        gu = np.where(todo & out, lo + 0.5 * (hi - lo), gu)
        g_lam = gu ** (-lam)
        gs_gu = gs / gu
        resid = AA - g_lam * (AA + lam - lam * gs_gu)
        lo = np.where(todo & (resid < 0.0), gu, lo)
        hi = np.where(todo & (resid >= 0.0), gu, hi)
        dr = lam * g_lam / gu * ((1.0 + lam) * (1.0 - gs_gu) + (AA - 1.0))
        delta = resid / dr
        gu = np.where(todo, gu - delta, gu)
        todo &= ~(np.abs(delta) < 1e-12 * np.abs(gu))
    ps = -0.9 / alpha
    pu = gu / (-alpha)
    se_pu = (-alpha * pu) ** (-lam)
    lam_dpu = lam * (1.0 - ps / pu)
    inv = 1.0 / (pu - ps)
    b2 = -(3.0 - se_pu * (3.0 + lam_dpu)) * inv * inv
    return {"alpha": alpha, "lam": lam, "ps": ps, "pu": pu, "b2": b2}


def _guard(mask, x, safe):
    """``x`` where ``mask``, ``safe`` elsewhere: keeps the branch that
    ``torch.where`` discards finite, so its gradient is too."""
    return torch.where(mask, x, torch.full_like(x, safe))


def sat_kr_sbc(P, p):
    """Smoothed Brooks-Corey saturation and Mualem relative permeability
    (kr = Se^(2.5 + 2/lambda)); ``p`` holds tensors sat_res, alpha, lam,
    ps, pu, b2 broadcastable to P."""
    pc = P - PRESSURE_REF
    in_bc = pc <= p["pu"]
    in_cubic = ~in_bc & (pc < p["ps"])
    x = _guard(in_bc, -p["alpha"] * pc, 2.0)
    se_bc = x ** (-p["lam"])
    d = pc - p["ps"]
    se_cubic = 1.0 + d * d * p["b2"]
    se = torch.where(in_bc, se_bc,
                     torch.where(in_cubic, se_cubic, torch.ones_like(pc)))
    sat = p["sat_res"] + (1.0 - p["sat_res"]) * se
    se_pos = _guard(se > 0.0, se, 1.0)
    kr = se_pos ** (2.5 + 2.0 / p["lam"])
    return sat, kr


def sat_kr_vg(P, p):
    """Van Genuchten saturation and Mualem relative permeability, m = 1 -
    1/n; ``p`` holds sat_res, alpha, m."""
    pc = P - PRESSURE_REF
    unsat = pc < 0.0
    m = p["m"]
    n = 1.0 / (1.0 - m)
    x = _guard(unsat, -p["alpha"] * pc, 1.0)
    xn = x ** n
    se = (1.0 + xn) ** (-m)
    sat = torch.where(unsat, p["sat_res"] + (1.0 - p["sat_res"]) * se,
                      torch.ones_like(pc))
    aa = xn / (1.0 + xn)
    kr = torch.sqrt(se) * (1.0 - aa ** m) ** 2
    kr = torch.where(unsat, kr, torch.ones_like(pc))
    return sat, kr


SATFUNCS = {"sbc_bz3": sat_kr_sbc, "van_genuchten": sat_kr_vg}


class System:
    """B systems of n cells on one topology.

    ``up``, ``dn``: long [nc] cells of each internal connection;
    ``dist_up``, ``dist_dn``, ``area``: [B, nc] or [nc]; ``unit_z``: [nc];
    ``perm``: [B, n] permeability [m^2], the same along x, y and z, so a
    connection of unit vector u sees perm * (|u_x| + |u_y| + |u_z|)
    (``perm_fac`` [nc], RichardsFlux's directional sum); ``porosity``,
    ``vol``: [B, n]; ``satfunc``: a key of SATFUNCS with its parameters
    ``sat`` ([B, n] tensors); ``seep``: None or a dict of the seepage
    face: ``cell`` (long [ns]), ``dist`` ([B, ns], face to the cell
    centre), ``area`` ([B, ns]), ``unit_z`` (float, -1 for a top face)."""

    def __init__(self, up, dn, dist_up, dist_dn, area, unit_z, perm,
                 porosity, vol, satfunc, sat, seep=None, perm_fac=1.0):
        self.up, self.dn = up, dn
        self.perm_fac = perm_fac
        self.dist_up, self.dist_dn, self.area = dist_up, dist_dn, area
        self.unit_z = unit_z
        self.perm, self.porosity, self.vol = perm, porosity, vol
        self.satfunc, self.sat = SATFUNCS[satfunc], sat
        self.seep = seep

    def to(self, dtype):
        """The same systems with every float tensor in ``dtype``."""
        def cast(v):
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                return v.to(dtype)
            if isinstance(v, dict):
                return {k: cast(x) for k, x in v.items()}
            return v
        out = System.__new__(System)
        out.__dict__ = {k: cast(v) for k, v in self.__dict__.items()}
        return out

    def mass(self, P):
        """Liquid water in each cell [kmol]."""
        sat, _ = self.satfunc(P, self.sat)
        return self.porosity * density_tgdpb01(P) * sat * self.vol

    def _aux(self, P):
        sat, kr = self.satfunc(P, self.sat)
        return sat, kr, density_tgdpb01(P)

    def internal_flux(self, P, aux):
        """Darcy molar flux [kmol/s] of each connection, positive from dn
        to up (the sign MPP's residual adds to dn and subtracts from up)."""
        _, kr, den = aux
        up, dn = self.up, self.dn
        dist = self.dist_up + self.dist_dn
        w_up = self.dist_up / dist
        k_up = self.perm[:, up] * self.perm_fac
        k_dn = self.perm[:, dn] * self.perm_fac
        dq = k_up * k_dn / (self.dist_up * k_dn + self.dist_dn * k_up)
        den_ave = w_up * den[:, up] + (1.0 - w_up) * den[:, dn]
        dphi = (P[:, up] - P[:, dn]
                + den_ave * FMWH2O * dist * self.unit_z * (-GRAVITY))
        mob = torch.where(dphi >= 0.0, kr[:, up], kr[:, dn]) / VISCOSITY
        return -dq * mob * dphi * self.area * den_ave

    def seepage_flux(self, P, aux):
        """Molar flux [kmol/s] out of each seepage-face cell (no inflow
        through a face at atmospheric pressure)."""
        s = self.seep
        _, kr, den = aux
        c = s["cell"]
        Pc = P[:, c]
        den_c = den[:, c]
        dphi = (PRESSURE_REF - Pc
                + den_c * FMWH2O * s["dist"] * s["unit_z"] * (-GRAVITY))
        dphi = torch.where(dphi > 0.0, torch.zeros_like(dphi), dphi)
        dq = self.perm[:, c] / s["dist"]
        return -dq * kr[:, c] / VISCOSITY * dphi * s["area"] * den_c

    def residual(self, P, mass_prev, dt, source):
        """F [B, n] of the step from the state of mass ``mass_prev``
        [kmol] over ``dt`` [s] ([B, 1] or a float), with the mass
        ``source`` [kmol/s, B x n]."""
        aux = self._aux(P)
        sat, _, den = aux
        F = (self.porosity * den * sat * self.vol - mass_prev) / dt - source
        q = self.internal_flux(P, aux)
        F = F.index_add(1, self.up, -q).index_add(1, self.dn, q)
        if self.seep is not None:
            F = F.index_add(1, self.seep["cell"], self.seepage_flux(P, aux))
        return F

    def column_outflow(self, P):
        """Seepage outflow of each system [kmol/s]."""
        if self.seep is None:
            return torch.zeros(P.shape[0], dtype=P.dtype, device=P.device)
        return self.seepage_flux(P, self._aux(P)).sum(dim=1)


def jacobian(fn, P, chunk):
    """d fn(P)_i / d P_j of each of the B independent systems [B, n, n],
    by reverse-mode autograd: the systems do not couple, so the gradient
    of fn's sum over systems holds each system's own row."""
    J = torch.func.jacrev(lambda X: fn(X).sum(dim=0), chunk_size=chunk)(P)
    return J.permute(1, 0, 2)


def newton(system, P_prev, dt, source, max_it=60, tol_pa=1e-7, chunk=None,
           min_lambda=2.0 ** -30):
    """Solve the step from ``P_prev`` [B, n] by Newton's method with a
    backtracking line search on the residual norm, each system on its own.
    Stops a system when its Newton step is below ``tol_pa`` everywhere,
    or when its residual stops falling (the floor of the working
    precision).  Returns (P, converged [B] bool, iterations): converged,
    a system stopped by its step, or at a residual 1e-8 of its first."""
    mass_prev = system.mass(P_prev)
    fn = lambda X: system.residual(X, mass_prev, dt, source)
    P = P_prev.clone()
    F = fn(P)
    fnorm = fnorm0 = torch.linalg.vector_norm(F, dim=1)
    done = torch.zeros(P.shape[0], dtype=torch.bool, device=P.device)
    by_step = torch.zeros_like(done)
    it = 0
    for it in range(1, max_it + 1):
        was = done.clone()
        J = jacobian(fn, P, chunk)
        dx = torch.linalg.solve(J, F.unsqueeze(-1)).squeeze(-1)
        dx = torch.where(done[:, None], torch.zeros_like(dx), dx)
        lam = torch.ones_like(fnorm)
        accepted = done.clone()
        P_try, F_try, fn_try = P, F, fnorm
        while True:
            cand = P - lam[:, None] * dx
            Fc = fn(cand)
            nc = torch.linalg.vector_norm(Fc, dim=1)
            ok = torch.isfinite(nc) & (nc <= (1.0 - 1e-4 * lam) * fnorm)
            take = ok & ~accepted
            P_try = torch.where(take[:, None], cand, P_try)
            F_try = torch.where(take[:, None], Fc, F_try)
            fn_try = torch.where(take, nc, fn_try)
            accepted |= ok
            if bool(accepted.all()) or float(lam.min()) < min_lambda:
                break
            lam = torch.where(accepted, lam, 0.5 * lam)
        step = (lam[:, None] * dx).abs().amax(dim=1)
        P, F, fnorm = P_try, F_try, fn_try
        # a system whose residual cannot fall further has reached its
        # precision's floor: it keeps its iterate and stops
        by_step |= ~was & accepted & (step <= tol_pa)
        done |= ~accepted | (step <= tol_pa)
        if bool(done.all()):
            break
    converged = done & torch.isfinite(fnorm) & (by_step
                                                | (fnorm <= 1e-8 * fnorm0))
    return P, converged, it

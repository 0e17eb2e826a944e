"""Plain reference of the ELM VSFM step (MPPVSFMALM_Solve) on soil columns.

From the CLM arrays the benchmark made (soils, layer thicknesses, areas,
forcing) it rebuilds each column's VSFM system, stages the fluxes as
MPPVSFMALM_Driver.F90 does (mm/s -> kg/s through area * denh2o * 1e-3;
infiltration into the top cell, transpiration split over the levels by
the root fractions; a seepage face at the top), solves the implicit step
to convergence (``vsfm.newton``), and gives the driver's f64 mass audit
and the CLM unpack (h2osoi_liq, smp_l, zwt, qflx_seepage).  Levels are
bottom (0) to top (nz - 1), as the program stages them.
"""
from __future__ import annotations

import numpy as np
import torch

from reference import vsfm
from reference.vsfm import DENH2O, FMWH2O, GRAVITY, PRESSURE_REF


def column_system(soils, dz, area, device, seepage=True,
                  dtype=torch.float64):
    """The VSFM systems of B columns: ``soils`` holds numpy [B, nz]
    watsat, hksat [mm/s], bsw, sucsat [mm], residual_sat; ``dz`` [nz]
    (bottom first) and ``area`` [B] numpy.  CLM's Clapp-Hornberger
    parameters convert as VSFMMPPSetSoilsCLM does (``seepage``: a seepage
    face on the top cell): perm = hksat * 1e-3 *
    vish2o / (denh2o g), lambda = 1 / bsw, alpha = 1 / (sucsat g)."""
    f = lambda v: torch.as_tensor(np.array(v, np.float64), dtype=dtype,
                                  device=device)
    B, nz = soils["watsat"].shape
    lam = 1.0 / soils["bsw"]
    alpha = 1.0 / (soils["sucsat"] * vsfm.GRAV_CLM)
    perm = soils["hksat"] * 1e-3 * vsfm.VISH2O_CLM / (DENH2O * vsfm.GRAV_CLM)
    # the set-up solve per distinct lambda, scattered back
    lam_u, inv = np.unique(lam, return_inverse=True)
    sbc_u = vsfm.sbc_bz3_params(np.ones_like(lam_u), lam_u)
    gu = (-sbc_u["pu"])[inv].reshape(lam.shape)     # pu * (-alpha), alpha 1
    b2_unit = sbc_u["b2"][inv].reshape(lam.shape)   # b2 / alpha^2
    sat = {"sat_res": f(soils["residual_sat"]), "alpha": f(alpha),
           "lam": f(lam), "ps": f(-0.9 / alpha), "pu": f(gu / (-alpha)),
           "b2": f(b2_unit * alpha * alpha)}
    dz = np.asarray(dz, np.float64)
    area = np.asarray(area, np.float64)
    up = torch.arange(nz - 1, device=device)
    seep = {"cell": torch.tensor([nz - 1], device=device),
            "dist": f(np.full((B, 1), 0.5 * dz[-1])),
            "area": f(area[:, None]), "unit_z": -1.0} if seepage else None
    return vsfm.System(
        up=up, dn=up + 1, dist_up=f(np.broadcast_to(0.5 * dz[:-1],
                                                      (B, nz - 1))),
        dist_dn=f(np.broadcast_to(0.5 * dz[1:], (B, nz - 1))),
        area=f(np.broadcast_to(area[:, None], (B, nz - 1))),
        unit_z=f(np.ones(nz - 1)), perm=f(perm),
        porosity=f(soils["watsat"]), vol=f(area[:, None] * dz[None, :]),
        satfunc="sbc_bz3", sat=sat, seep=seep)


def sources_kg(qflx_infl, qflx_tran_veg, rootr, area):
    """Mass sources [kg/s, B x nz] of the driver's staging: infiltration
    into the top cell, transpiration out of each level by its root
    fraction (tensors: [B], [B], [B, nz], [B])."""
    conv = area * DENH2O * 1e-3
    src = -(qflx_tran_veg * conv)[:, None] * rootr
    src = src.clone()
    src[:, -1] += qflx_infl * conv
    return src


def solve(system, P_prev, src_kg, dt, **kw):
    """The step's pressures [B, nz] from ``P_prev`` under the sources
    ``src_kg`` [kg/s]; returns (P, converged, iterations)."""
    return vsfm.newton(system, P_prev, dt, src_kg / FMWH2O, **kw)


def audit_kg(system, P_prev, P, src_kg, dt):
    """|mass_beg - mass_end + (sources - seepage outflow) dt| of each
    column [kg] (MPPVSFMALM_Driver.F90:861-863)."""
    m0 = system.mass(P_prev).sum(dim=1) * FMWH2O
    m1 = system.mass(P).sum(dim=1) * FMWH2O
    q_out = system.column_outflow(P) * FMWH2O
    return (m0 - m1 + (src_kg.sum(dim=1) - q_out) * dt).abs()


def water_table_depth(smp_l, zi):
    """zwt [m] from the first unsaturated layer below the surface, the
    zero of smp interpolated between that layer's and the next one's
    interface midpoints (MPPVSFMALM_Driver.F90:853-873); the column's
    depth where no layer (or only the deepest) is unsaturated.
    ``smp_l`` [B, nz] bottom first; ``zi`` [B, nz + 1] top first."""
    B, nz = smp_l.shape
    depth = zi[:, -1]
    top = torch.flip(smp_l, [1])
    unsat = top < 0.0
    has = unsat.any(dim=1)
    first = torch.where(has, unsat.to(torch.int8).argmax(dim=1),
                        torch.full_like(has, -1, dtype=torch.long))
    use = has & (first != nz - 1)
    j = first.clamp(0, nz - 2)
    r = torch.arange(B, device=smp_l.device)
    z_a = 0.5 * (zi[r, j] + zi[r, j + 1])
    z_b = 0.5 * (zi[r, j + 1] + zi[r, j + 2])
    s_a, s_b = top[r, j], top[r, j + 1]
    flat = s_a == s_b
    cross = -s_a / torch.where(flat, torch.ones_like(s_a), s_a - s_b) \
        * (z_a - z_b) + z_a
    cross = torch.where(flat, depth, cross)
    cross = torch.minimum(cross.clamp_min(0.0), depth)
    return torch.where(use, cross, depth)


def unpack(system, P, area, zi):
    """The CLM outputs of state P: h2osoi_liq [kg/m^2], smp_l [mm], zwt
    [m], qflx_seepage [mm/s]."""
    smp = (P - PRESSURE_REF) / (DENH2O * GRAVITY) * 1e3
    return {"h2osoi_liq": system.mass(P) * FMWH2O / area[:, None],
            "smp_l": smp,
            "zwt": water_table_depth(smp, zi),
            "qflx_seepage": system.column_outflow(P) * FMWH2O
            / (area * DENH2O * 1e-3)}

"""Batched photosynthesis / stomatal conductance: the production path.

Counterpart of ``mpp_tpu/batched/photosynthesis.py`` (itself a functional
re-expression of ``models/photosynthesis.py``, after
``auxvar/PhotosynthesisAuxVarType.F90`` and
``ge/GoveqnPhotosynthesis.F90``): every leaf cell advances together as a
[n] lane of a masked Newton iteration.  The biochemistry chain (Farquhar
C3 / Collatz C4, temperature responses, electron transport, co-limitation
quadratics, the stomatal models and the plant-hydraulics coupling) is
elementwise PyTorch on the parameters' device, a pure function of a
parameter NamedTuple; the finite-difference Jacobian of
``GoveqnPhotosynthesis.F90:261-431`` (the whole-gs-array perturbation of
the Bonan14 hydraulic dof, the fixed perturbation sizes) is reproduced, so
the batched path takes the serial path's iteration map.

The JAX form's ``lax.while_loop``s are Python loops with the same exit
rules; each iteration reads one device scalar on the host through
``sync``.
The iterates are bit-sensitive through the FD Jacobian (KNOWN_GAPS #6):
PyTorch's and XLA's transcendentals differ in the last bit, so the two
packages agree to the solve's determinacy band, not bitwise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from mpp_tpu_torch.constants import TFRZ, RGAS
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.ops.satvap import sat_vap
from mpp_tpu_torch.models.photosynthesis import (
    SCM_MEDLYN, SCM_BBERRY, SCM_WUE, SCM_BONAN14, SCM_MANZONI11,
    SCM_MODIFIED_BONAN14, SCM_OSMWANG, PATHWAY_C3, PATHWAY_C4,
    GS_MIN, GS_MIN_WUE, GS_MAX_WUE, GS_DELTA_WUE, GS_MIN_BONAN14,
    GS_DELTA_BONAN14)

_G = 9.80665
_DENH2O = 1000.0


@dataclasses.dataclass(frozen=True)
class PsyConfig:
    """Static problem configuration."""
    c3psn: int = PATHWAY_C3
    gstype: int = SCM_MEDLYN
    colim: int = 1
    ndof: int = 1


class PsyParams(NamedTuple):
    """Per-cell [n] photosynthesis parameters + forcing (the x-independent
    slice of ``photosynthesis_auxvar_type``)."""
    tleaf: torch.Tensor
    gbv: torch.Tensor
    gbc: torch.Tensor
    eair: torch.Tensor
    pref: torch.Tensor
    cair: torch.Tensor
    o2ref: torch.Tensor
    apar: torch.Tensor
    btran: torch.Tensor
    vcmax25: torch.Tensor
    jmax25: torch.Tensor
    rd25: torch.Tensor
    kp25: torch.Tensor
    g0opt: torch.Tensor
    g1opt: torch.Tensor
    iota: torch.Tensor
    manzoni11_beta: torch.Tensor
    fdry: torch.Tensor
    fwet: torch.Tensor
    # plant hydraulics
    leaf_psi: torch.Tensor
    leaf_height: torch.Tensor
    leaf_capc: torch.Tensor
    leaf_minlwp: torch.Tensor
    leaf_lai: torch.Tensor
    k_stem2leaf: torch.Tensor
    weibull_b: torch.Tensor
    weibull_c: torch.Tensor
    leaf_psi_crt: torch.Tensor
    plant_dtime: torch.Tensor
    root_biomass: torch.Tensor
    root_radius: torch.Tensor
    root_density: torch.Tensor
    root_resist: torch.Tensor
    # soil column [n, nlevsoi]
    soil_h2osoi_vol: torch.Tensor
    soil_watsat: torch.Tensor
    soil_psi_sat: torch.Tensor
    soil_hksat: torch.Tensor
    soil_bsw: torch.Tensor
    soil_rootfr: torch.Tensor
    soil_dz: torch.Tensor


class SoilDerived(NamedTuple):
    """x-independent plant/soil hydraulic state (ComputeSoilResistance,
    PhotosynthesisAuxVarType.F90:626-728)."""
    resist_soil: torch.Tensor
    psi_soil: torch.Tensor
    leaf_lsc: torch.Tensor


def params_from_auxvars(av, device="cuda") -> Tuple[PsyConfig, PsyParams]:
    """Build (config, params) from a serial ``PhotosynthesisAuxVars``: the
    parameters as f64 tensors on ``device`` (the card unless
    ``device="cpu"``)."""
    device = device_of(device)
    av.set_default_parameters()
    cfg = PsyConfig(c3psn=av.c3psn, gstype=av.gstype, colim=av.colim,
                    ndof=av.ndof)
    p = PsyParams(**{
        name: torch.as_tensor(np.asarray(getattr(av, name), np.float64),
                              device=device)
        for name in PsyParams._fields})
    return cfg, p


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def quadratic(a, b, c):
    """MathUtilsMod::quadratic (MathUtils.F90:24-58), both roots."""
    disc = torch.sqrt(b * b - 4.0 * a * c)
    q = torch.where(b >= 0.0, -0.5 * (b + disc), -0.5 * (b - disc))
    r1 = q / a
    r2 = torch.where(q != 0.0, c / torch.where(q != 0.0, q, 1.0), 1.0e36)
    return r1, r2


def ft(tl, ha):
    return torch.exp(ha / (RGAS * (TFRZ + 25.0)) * (1.0 - (TFRZ + 25.0) / tl))


def fth(tl, hd, se, c):
    return c / (1.0 + torch.exp((-hd + se * tl) / (RGAS * tl)))


def fth25(hd, se):
    return 1.0 + np.exp((-hd + se * (TFRZ + 25.0)) / (RGAS * (TFRZ + 25.0)))


# kinetic constants (PhotosynthesisAuxVarType.F90:388-440)
KC25, KO25, CP25 = 404.9, 278.4, 42.75
KCHA, KOHA, CPHA = 79430.0, 36380.0, 37830.0
RDHA, VCMAXHA, JMAXHA = 46390.0, 65330.0, 43540.0
RDHD = VCMAXHD = JMAXHD = 150000.0
RDSE = VCMAXSE = JMAXSE = 490.0
VCMAXC = fth25(VCMAXHD, VCMAXSE)
JMAXC = fth25(JMAXHD, JMAXSE)
RDC = fth25(RDHD, RDSE)
PHI_PSII, THETA_J = 0.85, 0.90
COLIM_C3 = 0.98
COLIM_C4A, COLIM_C4B = 0.80, 0.95
QE_C4 = 0.05


class Biochem(NamedTuple):
    """x-independent biochemistry rates (temperature responses +
    electron transport; PhotosynthesisAuxVarType.F90:1156-1232)."""
    vcmax: torch.Tensor
    jmax: torch.Tensor
    je: torch.Tensor
    kc: torch.Tensor
    ko: torch.Tensor
    cp: torch.Tensor
    rd: torch.Tensor
    kp: torch.Tensor
    esat: torch.Tensor
    ceair: torch.Tensor


def biochem_rates(cfg: PsyConfig, p: PsyParams) -> Biochem:
    tl = p.tleaf
    if cfg.c3psn == PATHWAY_C4:
        t1 = torch.pow(2.0, (tl - (TFRZ + 25.0)) / 10.0)
        t2 = 1.0 + torch.exp(0.2 * ((TFRZ + 15.0) - tl))
        t3 = 1.0 + torch.exp(0.3 * (tl - (TFRZ + 40.0)))
        vcmax = p.vcmax25 * t1 / (t2 * t3) * p.btran
        t3r = 1.0 + torch.exp(1.3 * (tl - (TFRZ + 55.0)))
        rd = p.rd25 * t1 / t3r
        kp = p.kp25 * t1
        kc = ko = cp = jmax = je = torch.zeros_like(tl)
    else:
        kc = KC25 * ft(tl, KCHA)
        ko = KO25 * ft(tl, KOHA)
        cp = CP25 * ft(tl, CPHA)
        vcmax = p.vcmax25 * ft(tl, VCMAXHA) * fth(tl, VCMAXHD, VCMAXSE,
                                                  VCMAXC) * p.btran
        jmax = p.jmax25 * ft(tl, JMAXHA) * fth(tl, JMAXHD, JMAXSE, JMAXC)
        rd = p.rd25 * ft(tl, RDHA) * fth(tl, RDHD, RDSE, RDC)
        kp = torch.zeros_like(tl)
        qabs = 0.5 * PHI_PSII * p.apar
        r1, r2 = quadratic(torch.full_like(tl, THETA_J), -(qabs + jmax),
                           qabs * jmax)
        je = torch.minimum(r1, r2)
    esat, _ = sat_vap(tl)
    # ceair: the reference's max-clamp is overwritten (quirk preserved,
    # models/photosynthesis.py:550-552)
    ceair = torch.minimum(p.eair, esat)
    return Biochem(vcmax=vcmax, jmax=jmax, je=je, kc=kc, ko=ko, cp=cp,
                   rd=rd, kp=kp, esat=esat, ceair=ceair)


def soil_resistance(p: PsyParams) -> SoilDerived:
    """ComputeSoilResistance (:626-728), x-independent."""
    head = _G * _DENH2O * 1.0e-6
    area = math.pi * p.root_radius ** 2
    vwc = torch.clamp(p.soil_h2osoi_vol, min=1.0e-6) / (p.soil_dz * _DENH2O)
    s = torch.clamp(vwc / p.soil_watsat, 0.01, 1.0)
    hk = p.soil_hksat * torch.pow(s, 2.0 * p.soil_bsw + 3.0)
    hk = hk * 1.0e-3 / head
    hk = hk * _DENH2O / 18.02e-3 * 1000.0
    soil_psi = p.soil_psi_sat * torch.pow(s, -p.soil_bsw)
    psi_mpa = soil_psi * 1.0e-3 * head
    rbd = torch.clamp(p.root_biomass[:, None] * p.soil_rootfr / p.soil_dz,
                      min=1.0e-10)
    rld = rbd / (p.root_density * area)[:, None]
    root_dist = torch.sqrt(1.0 / (rld * math.pi))
    soilr1 = torch.log(root_dist / p.root_radius[:, None]) \
        / (2.0 * math.pi * rld * p.soil_dz * hk)
    soilr = soilr1 + p.root_resist[:, None] / (rbd * p.soil_dz)
    blw = (1.0 / soilr).sum(dim=1)
    evap = torch.clamp((psi_mpa - p.leaf_minlwp[:, None]) / soilr, min=0.0)
    resist_soil = p.leaf_lai / blw
    totevap = evap.sum(dim=1)
    psi_soil = (psi_mpa * evap).sum(dim=1)
    psi_soil = torch.where(totevap > 0.0,
                           psi_soil / torch.where(totevap > 0.0, totevap,
                                                  1.0),
                           p.leaf_minlwp)
    leaf_lsc = 1.0 / (1.0 / p.k_stem2leaf + resist_soil)
    return SoilDerived(resist_soil=resist_soil, psi_soil=psi_soil,
                       leaf_lsc=leaf_lsc)


# ---------------------------------------------------------------------------
# semi-empirical chain: an(ci) -> gs (BB / Medlyn)
# ---------------------------------------------------------------------------

class SemiOut(NamedTuple):
    an: torch.Tensor
    ag: torch.Tensor
    ac: torch.Tensor
    aj: torch.Tensor
    ap: torch.Tensor
    gs: torch.Tensor
    gleaf_c: torch.Tensor
    gleaf_w: torch.Tensor
    cs: torch.Tensor


def semi_empirical(cfg: PsyConfig, p: PsyParams, bc: Biochem,
                   ci: torch.Tensor) -> SemiOut:
    """PhotosynthesisAuxVarCompute_SemiEmpirical (:975-1070), ndof=1."""
    if cfg.c3psn == PATHWAY_C4:
        ac = bc.vcmax
        aj = QE_C4 * p.apar
        ap = torch.where(ci > 0.0, bc.kp * ci, 0.0)
        if cfg.colim == 1:
            r1, r2 = quadratic(torch.full_like(ci, COLIM_C4A), -(ac + aj),
                               ac * aj)
            ai = torch.minimum(r1, r2)
            r1, r2 = quadratic(torch.full_like(ci, COLIM_C4B), -(ai + ap),
                               ai * ap)
            ag = torch.minimum(r1, r2)
        else:
            ag = torch.minimum(torch.minimum(ac, aj), ap)
    else:
        ok = ci - bc.cp > 0.0
        b1 = bc.kc * (1.0 + p.o2ref / bc.ko)
        ac = torch.where(ok, bc.vcmax * (ci - bc.cp) / (ci + b1), 0.0)
        aj = torch.where(ok, bc.je / 4.0 * (ci - bc.cp) / (ci + 2.0 * bc.cp),
                         0.0)
        ap = torch.zeros_like(ci)
        if cfg.colim == 1:
            r1, r2 = quadratic(torch.full_like(ci, COLIM_C3), -(ac + aj),
                               ac * aj)
            ag = torch.minimum(r1, r2)
        else:
            ag = torch.minimum(ac, aj)
    ac = torch.clamp(ac, min=0.0)
    aj = torch.clamp(aj, min=0.0)
    ap = torch.clamp(ap, min=0.0)
    ag = torch.clamp(ag, min=0.0)
    an = ag - bc.rd

    cs = torch.clamp(p.cair - an / p.gbc, min=1.0)
    if cfg.gstype == SCM_BBERRY:
        g0 = torch.clamp(p.g0opt * p.btran, min=GS_MIN)
        g1 = p.g1opt
        aq = cs
        bq = cs * (p.gbv - g0) - g1 * an
        cq = -p.gbv * (cs * g0 + g1 * an * bc.ceair / bc.esat)
        r1, r2 = quadratic(aq, bq, cq)
        gs = torch.where(an > 0.0, torch.maximum(r1, r2), g0)
    else:  # Medlyn
        g0 = p.g0opt
        g1 = p.g1opt
        vpd_term = torch.clamp(bc.esat - bc.ceair, min=100.0) * 0.001
        term = 1.6 * an / cs
        aq = torch.ones_like(an)
        bq = -(2.0 * (g0 + term) + (g1 * term) ** 2
               / (p.gbv * vpd_term))
        cq = g0 * g0 + (2.0 * g0 + term
                        * (1.0 - g1 * g1 / vpd_term)) * term
        r1, r2 = quadratic(aq, bq, cq)
        gs = torch.where(an > 0.0, torch.maximum(r1, r2), g0)
    pos = gs > 0.0
    gsafe = torch.where(pos, gs, 1.0)
    gleaf_c = torch.where(pos, 1.0 / (1.0 / p.gbc + 1.6 / gsafe), 0.0)
    gleaf_w = torch.where(pos, 1.0 / (1.0 / p.gbv + 1.0 / gsafe), 0.0)
    return SemiOut(an=an, ag=ag, ac=ac, aj=aj, ap=ap, gs=gs,
                   gleaf_c=gleaf_c, gleaf_w=gleaf_w, cs=cs)


# ---------------------------------------------------------------------------
# WUE-family chain: gs -> an (C3 only, like the reference)
# ---------------------------------------------------------------------------

class FromGsOut(NamedTuple):
    an: torch.Tensor
    ag: torch.Tensor
    ci: torch.Tensor
    gleaf_c: torch.Tensor
    gleaf_w: torch.Tensor
    hs: torch.Tensor
    vpd: torch.Tensor


def an_from_gs(cfg: PsyConfig, p: PsyParams, bc: Biochem,
               gs: torch.Tensor) -> FromGsOut:
    """C3_Net_Assimilation_From_Gs (:1468-1551) + the hs/vpd staging of
    PhotosynthesisAuxVarCompute_WUE (:1072-1151); gs is a single dof."""
    gleaf_c = 1.0 / (1.0 / p.gbc + 1.6 / gs)
    gleaf_w = 1.0 / (1.0 / p.gbv + 1.0 / gs)
    aq = 1.0 / gleaf_c
    b1 = bc.kc * (1.0 + p.o2ref / bc.ko)
    bq = -(p.cair + b1) - (bc.vcmax - bc.rd) / gleaf_c
    cq = bc.vcmax * (p.cair - bc.cp) - bc.rd * (p.cair + b1)
    r1, r2 = quadratic(aq, bq, cq)
    ac = torch.minimum(r1, r2) + bc.rd
    a2 = bc.je / 4.0
    b2 = 2.0 * bc.cp
    bq = -(p.cair + b2) - (a2 - bc.rd) / gleaf_c
    cq = a2 * (p.cair - bc.cp) - bc.rd * (p.cair + b2)
    r1, r2 = quadratic(aq, bq, cq)
    aj = torch.minimum(r1, r2) + bc.rd
    if cfg.colim == 1:
        r1, r2 = quadratic(torch.full_like(gs, COLIM_C3), -(ac + aj),
                           ac * aj)
        ag = torch.minimum(r1, r2)
    else:
        ag = torch.minimum(ac, aj)
    ag = torch.clamp(ag, min=0.0)
    an = ag - bc.rd
    ci = torch.clamp(p.cair - an / gleaf_c, min=1.0)
    hs = (p.gbv * p.eair + gs * bc.esat) / ((p.gbv + gs) * bc.esat)
    vpd = torch.clamp(bc.esat - hs * bc.esat, min=0.1) / p.pref
    return FromGsOut(an=an, ag=ag, ci=ci, gleaf_c=gleaf_c, gleaf_w=gleaf_w,
                     hs=hs, vpd=vpd)


def critical_flow(p: PsyParams, sd: SoilDerived) -> torch.Tensor:
    """ComputeCriticalFlow (:858-886)."""
    head = _G * _DENH2O * 1.0e-6
    kl = sd.leaf_lsc * torch.exp(-torch.pow(-sd.psi_soil / p.weibull_b,
                                            p.weibull_c))
    return torch.clamp(kl * (sd.psi_soil - p.leaf_psi_crt
                             - head * p.leaf_height) / 1.0e3, min=1.0e-7)


def change_in_psi(p: PsyParams, sd: SoilDerived, etflx) -> torch.Tensor:
    """ComputeChangeInPsi (:889-906): dpsi_leaf."""
    head = _G * _DENH2O * 1.0e-6
    a = sd.psi_soil - head * p.leaf_height - 1.0e3 * etflx / sd.leaf_lsc
    b = p.leaf_capc / sd.leaf_lsc
    return (a - p.leaf_psi) * (1.0 - torch.exp(-p.plant_dtime / b))


def psi_modified_bonan14(p: PsyParams, sd: SoilDerived, etflx):
    """ComputePsi_ModifiedBonan14 (:909-946)."""
    head = _G * _DENH2O * 1.0e-6
    w_b, w_c = 2.0, 5.0
    factor = torch.exp(-torch.pow(-p.leaf_psi / w_b, w_c))
    Kl = 1.0 / (1.0 / (p.k_stem2leaf * factor) + sd.resist_soil)
    E = 1.0e3 * etflx
    return ((p.leaf_capc / p.plant_dtime) * p.leaf_psi
            + Kl * (sd.psi_soil - head * p.leaf_height) - E) \
        / (p.leaf_capc / p.plant_dtime + Kl)


# ---------------------------------------------------------------------------
# residual  F(x) per dof (GoveqnPhotosynthesis.F90:130-257)
# ---------------------------------------------------------------------------

def residual(cfg: PsyConfig, p: PsyParams, bc: Biochem, sd: SoilDerived,
             x: torch.Tensor, bounded: torch.Tensor) -> torch.Tensor:
    """F(x): x is [n, ndof] (ci for BB/Medlyn, gs otherwise)."""
    gst = cfg.gstype
    if gst in (SCM_BBERRY, SCM_MEDLYN):
        ci = x[:, 0]
        out = semi_empirical(cfg, p, bc, ci)
        F = torch.where(out.an > 0.0,
                        out.an - out.gleaf_c * (p.cair - ci), 0.0)
        F = torch.where(bounded[:, 0], F, 0.0)
        return F[:, None]
    if gst in (SCM_WUE, SCM_MANZONI11):
        gs = x[:, 0]
        lo = an_from_gs(cfg, p, bc, gs - GS_DELTA_WUE)
        hi = an_from_gs(cfg, p, bc, gs)
        factor = torch.ones_like(gs)
        if gst == SCM_MANZONI11:
            factor = torch.exp(p.manzoni11_beta * p.leaf_psi)
        F = (hi.an - lo.an) - p.iota * factor * GS_DELTA_WUE * hi.vpd
        return torch.where(bounded[:, 0], F, 0.0)[:, None]
    if gst == SCM_OSMWANG:
        gs = x[:, 0]
        lo = an_from_gs(cfg, p, bc, gs - GS_DELTA_WUE)
        hi = an_from_gs(cfg, p, bc, gs)
        et_lo = (bc.esat - p.eair) / p.pref * lo.gleaf_w * p.fdry
        et_hi = (bc.esat - p.eair) / p.pref * hi.gleaf_w * p.fdry
        etc = critical_flow(p, sd)
        cost_lo = lo.an * et_lo / etc
        cost_hi = hi.an * et_hi / etc
        den = et_hi - et_lo
        F = (hi.an - lo.an) / den - (cost_hi - cost_lo) / den
        return torch.where(bounded[:, 0], F, 0.0)[:, None]
    # BONAN14 / MODIFIED_BONAN14: dof0 = wue residual, dof1 = hydraulics
    gs_w, gs_h = x[:, 0], x[:, 1]
    lo = an_from_gs(cfg, p, bc, gs_w - GS_DELTA_BONAN14)
    hi = an_from_gs(cfg, p, bc, gs_w)
    F_wue = (hi.an - lo.an) - p.iota * GS_DELTA_BONAN14 * hi.vpd
    gl_h = 1.0 / (1.0 / p.gbv + 1.0 / gs_h)
    etflx = (bc.esat - p.eair) / p.pref * gl_h * p.fdry
    if gst == SCM_BONAN14:
        dpsi = change_in_psi(p, sd, etflx)
        F_hyd = p.leaf_psi + dpsi - p.leaf_minlwp
    else:
        psi_new = psi_modified_bonan14(p, sd, etflx)
        F_hyd = psi_new - p.leaf_minlwp
    F = torch.stack([F_wue, F_hyd], dim=1)
    return torch.where(bounded, F, 0.0)


def jacobian_diag(cfg: PsyConfig, p: PsyParams, bc: Biochem,
                  sd: SoilDerived, x: torch.Tensor,
                  bounded: torch.Tensor) -> torch.Tensor:
    """FD diagonal (GoveqnPhotosynthesis.F90:261-431): same perturbation
    sizes and whole-gs-array semantics as the reference."""
    gst = cfg.gstype
    if gst in (SCM_BBERRY, SCM_MEDLYN):
        ci_pert = -1.0e-7
        ci = x[:, 0]
        o1 = semi_empirical(cfg, p, bc, ci)
        o2 = semi_empirical(cfg, p, bc, ci - ci_pert)
        val = torch.where(
            o1.an > 0.0,
            (o1.an - o2.an) / ci_pert
            - (o1.gleaf_c - o2.gleaf_c) / ci_pert * (p.cair - ci)
            + o1.gleaf_c, 1.0)
        return torch.where(bounded[:, 0], val, 1.0)[:, None]
    if gst in (SCM_WUE, SCM_MANZONI11, SCM_OSMWANG):
        gs_pert = -1.0e-5
        F1 = residual(cfg, p, bc, sd, x, bounded)
        F2 = residual(cfg, p, bc, sd, x - gs_pert, bounded)
        val = (F1 - F2) / gs_pert
        return torch.where(bounded, val, 1.0)
    # BONAN14 family: dof0 FD with the whole-gs-array perturbation
    # (both dofs shifted to gs0-pert), dof1 diag = 1.0 (:410-431)
    gs_pert = -1.0e-8
    F1 = residual(cfg, p, bc, sd, x, bounded)
    x2 = torch.stack([x[:, 0] - gs_pert, x[:, 0] - gs_pert], dim=1)
    F2 = residual(cfg, p, bc, sd, x2, bounded)
    d0 = (F1[:, 0] - F2[:, 0]) / gs_pert
    d0 = torch.where(bounded[:, 0], d0, 1.0)
    d1 = torch.ones_like(d0)
    return torch.stack([d0, d1], dim=1)


# ---------------------------------------------------------------------------
# boundedness pre-check (PhotosynthesisDetermineIfSolutionIsBounded
# :1632-1715) — pure, returns (bounded, x_mutated)
# ---------------------------------------------------------------------------

def determine_bounded(cfg: PsyConfig, p: PsyParams, bc: Biochem,
                      sd: SoilDerived, x0: torch.Tensor):
    gst = cfg.gstype
    ones = torch.ones_like(x0, dtype=torch.bool)
    if gst in (SCM_WUE, SCM_MANZONI11, SCM_OSMWANG):
        hi = torch.full_like(x0, GS_MAX_WUE)
        lo = torch.full_like(x0, GS_MIN_WUE)
        r2 = residual(cfg, p, bc, sd, hi, ones)
        r1 = residual(cfg, p, bc, sd, lo, ones)
        return r1 * r2 <= 0.0, x0
    if gst in (SCM_BONAN14, SCM_MODIFIED_BONAN14):
        hi = torch.full_like(x0, GS_MAX_WUE)
        lo = torch.full_like(x0, GS_MIN_BONAN14)
        r2 = residual(cfg, p, bc, sd, hi, ones)
        r1 = residual(cfg, p, bc, sd, lo, ones)
        any_cross = (torch.minimum(r1[:, 0], r1[:, 1])
                     * torch.minimum(r2[:, 0], r2[:, 1])) < 0.0
        b0 = any_cross & (r1[:, 0] * r2[:, 0] < 0.0)
        b1 = any_cross & (r1[:, 1] * r2[:, 1] < 0.0)
        return torch.stack([b0, b1], dim=1), x0
    # BB / Medlyn: mutates ci (the leftover value feeds unbounded outputs)
    frac = 0.7 if cfg.c3psn == PATHWAY_C3 else 0.4
    ci1 = frac * p.cair
    o1 = semi_empirical(cfg, p, bc, ci1)
    neg1 = o1.an < 0.0
    ci2 = torch.where(neg1, ci1, 0.99 * p.cair)
    o2 = semi_empirical(cfg, p, bc, ci2)
    neg2 = o2.an < 0.0
    bounded = ~(neg1 | neg2)
    return bounded[:, None], ci2[:, None]


# ---------------------------------------------------------------------------
# batched Newton (SNES emulation with per-cell stopping)
# ---------------------------------------------------------------------------

class SolveResult(NamedTuple):
    x: torch.Tensor            # [n, ndof] converged primary unknowns
    converged: torch.Tensor    # [n] bool
    iters: int                 # Newton iterations of the batch
    fnorm: torch.Tensor        # [n] final residual norm


def _norm(a, dim=None):
    return torch.sqrt((a * a).sum() if dim is None else (a * a).sum(dim=dim))


def solve(cfg: PsyConfig, p: PsyParams, x0: torch.Tensor,
          rtol: float = 1e-8, stol: float = 1e-10, atol: float = 1e-50,
          max_it: int = 50, sync=None) -> Tuple[SolveResult, torch.Tensor]:
    """Masked batched Newton over all cells.

    The serial path stops on the *global* SNES norms (the golden files
    record that iterate); the batched production path applies the same
    tests per cell so one stiff lane cannot stall the batch.  The loop
    runs while a lane is not done and fewer than ``max_it`` iterations
    have run; a done lane's step is zero, so it stays frozen bit for bit.
    ``sync`` (default: ``.item()``) reads the loop test on the host once an
    iteration.  Returns (result, bounded mask)."""
    sync = sync or torch.Tensor.item
    bc = biochem_rates(cfg, p)
    sd = soil_resistance(p)
    bounded, x = determine_bounded(cfg, p, bc, sd, x0)

    F = residual(cfg, p, bc, sd, x, bounded)
    fnorm = _norm(F, dim=1)
    ttol = fnorm * rtol
    done = fnorm < atol
    it = 0
    while it < max_it and sync((~done).any()):
        diag = jacobian_diag(cfg, p, bc, sd, x, bounded)
        dx = -F / diag
        dx = torch.where(done[:, None], 0.0, dx)
        xn = x + dx
        Fn = residual(cfg, p, bc, sd, xn, bounded)
        fn = _norm(Fn, dim=1)
        newly = (fn <= ttol) | (_norm(dx, dim=1) < stol * _norm(xn, dim=1))
        x, F, fnorm, done, it = xn, Fn, fn, done | newly, it + 1
    return SolveResult(x=x, converged=done, iters=it, fnorm=fnorm), bounded


class PostSolve(NamedTuple):
    an: torch.Tensor
    ag: torch.Tensor
    gs: torch.Tensor
    ci: torch.Tensor
    gleaf_c: torch.Tensor
    gleaf_w: torch.Tensor


def post_solve(cfg: PsyConfig, p: PsyParams, x: torch.Tensor,
               bounded: torch.Tensor) -> PostSolve:
    """PhotosynthesisPostSolve (:1745-1826): pick the solution dof and
    recompute the output chain at the converged unknowns."""
    bc = biochem_rates(cfg, p)
    gst = cfg.gstype
    if gst in (SCM_BBERRY, SCM_MEDLYN):
        ci = x[:, 0]
        out = semi_empirical(cfg, p, bc, ci)
        return PostSolve(an=out.an, ag=out.ag, gs=out.gs, ci=ci,
                         gleaf_c=out.gleaf_c, gleaf_w=out.gleaf_w)
    if gst in (SCM_WUE, SCM_MANZONI11, SCM_OSMWANG):
        gs = x[:, 0]
        out = an_from_gs(cfg, p, bc, gs)
        gl_c = 1.0 / (1.0 / p.gbc + 1.6 / gs)
        gl_w = 1.0 / (1.0 / p.gbv + 1.0 / gs)
        return PostSolve(an=out.an, ag=out.ag, gs=gs, ci=out.ci,
                         gleaf_c=gl_c, gleaf_w=gl_w)
    both = bounded[:, 0] & bounded[:, 1]
    pick_hyd = both & (x[:, 1] <= x[:, 0])
    gs = torch.where(pick_hyd, x[:, 1], x[:, 0])
    out = an_from_gs(cfg, p, bc, gs)
    gl_c = 1.0 / (1.0 / p.gbc + 1.6 / gs)
    gl_w = 1.0 / (1.0 / p.gbv + 1.0 / gs)
    return PostSolve(an=out.an, ag=out.ag, gs=gs, ci=out.ci,
                     gleaf_c=gl_c, gleaf_w=gl_w)


def solve_global(cfg: PsyConfig, p: PsyParams, x0: torch.Tensor,
                 rtol: float = 1e-8, stol: float = 1e-10, atol: float = 1e-50,
                 max_it: int = 50, sync=None):
    """Global-norm Newton replicating the serial facade solve's iteration
    map (PhotosynthesisSoE.step_dt: one SNES solve over ALL cells with
    SNESConvergedDefault on the global ||F||, matching the reference's
    single PETSc SNESSolve per ml_model substep,
    ``soe/SystemOfEquationsPhotosynthesisType.F90:154-249``).

    Returns (SolveResult, bounded, reason, x_prev): ``reason`` uses the
    PETSc codes (2=FNORM_ABS, 3=FNORM_RELATIVE, 4=SNORM_RELATIVE, 0=not
    converged), read on the host through ``sync`` once an iteration.
    ``x_prev`` is the second-to-last iterate: the reference's BONAN14 FD
    Jacobian clobbers the whole gs array with dof-0's value at each
    Jacobian evaluation (GoveqnPhotosynthesis.F90:261-431's whole-array
    assignment), so UNBOUNDED dofs end the solve holding the previous
    iterate's dof-0 gs — needed for regression-exact auxvar writeback."""
    sync = sync or torch.Tensor.item
    bc = biochem_rates(cfg, p)
    sd = soil_resistance(p)
    bounded, x = determine_bounded(cfg, p, bc, sd, x0)

    F = residual(cfg, p, bc, sd, x, bounded)
    fnorm = _norm(F)
    ttol = fnorm * rtol
    reason = 2 if sync(fnorm < atol) else 0
    x_prev = x
    it = 0
    while reason == 0 and it < max_it:
        diag = jacobian_diag(cfg, p, bc, sd, x, bounded)
        dx = -F / diag
        xn = x + dx
        F = residual(cfg, p, bc, sd, xn, bounded)
        fnorm = _norm(F)
        reason = int(sync(torch.where(
            fnorm <= ttol, 3, torch.where(_norm(dx) < stol * _norm(xn), 4,
                                          0))))
        x_prev, x, it = x, xn, it + 1
    n = x.shape[0]
    res = SolveResult(x=x, converged=torch.full((n,), reason > 0,
                                                device=x.device),
                      iters=it, fnorm=fnorm.expand(n))
    return res, bounded, reason, x_prev


class CompiledPhotosynthesis:
    """A facade-built ``PhotosynthesisMPP`` frozen into the batched Newton
    on a device — the compiled driver of the one batched physics
    implementation (this module), which the canopy pipeline consumes for
    its psy stage.

    Drop-in serial use (the standalone golden problems)::

        comp = compile_photosynthesis(mpp).install()
        converged, reason = mpp.soe.step_dt(0.0, 1)

    The Newton runs on ``device`` (the card unless ``device="cpu"``); the
    output chain (PostSolve writeback into the auxvars for
    ``get_data``/regression output) reuses the serial auxvar evaluation
    at the converged unknowns, so outputs flow through the same code both
    paths."""

    def __init__(self, mpp, device="cuda"):
        self.mpp = mpp
        self.ge = mpp.soe.ge
        self.device = device_of(device)
        self.cfg, _ = params_from_auxvars(self.ge.avars, self.device)
        #: host reads of device predicates since construction
        self.host_syncs = 0

    def _sync(self, value):
        self.host_syncs += 1
        return value.item()

    def install(self):
        self.mpp.soe.step_dt = self.step_dt
        return self

    def step_dt(self, dt, nstep=1):
        soe = self.mpp.soe
        av = self.ge.avars
        cfg, p = params_from_auxvars(av, self.device)
        if cfg != self.cfg:
            raise ValueError("static config changed after compile")
        x0 = torch.as_tensor(np.asarray(soe.soln, np.float64)
                             .reshape(av.n, av.ndof), device=self.device)
        res, bounded, reason, x_prev = solve_global(cfg, p, x0,
                                                    sync=self._sync)
        converged = reason > 0
        soe.soln = res.x.cpu().numpy().reshape(-1)
        soe.soln_prev = soe.soln.copy()
        soe.cumulative_newton_iterations += res.iters
        # PostSolve through the serial auxvar chain (identical output
        # plumbing for both drivers).  BONAN14 family: the reference's FD
        # Jacobian overwrites the WHOLE gs array with dof-0's value each
        # evaluation (whole-array assignment, GoveqnPhotosynthesis.F90:
        # 261-431), so unbounded dofs end the serial solve holding the
        # previous iterate's dof-0 gs — replicate before writeback.
        if av.gstype in (SCM_BONAN14, SCM_MODIFIED_BONAN14) \
                and res.iters > 0:
            nb = ~bounded.cpu().numpy()
            xp0 = x_prev[:, 0].cpu().numpy()
            for d in range(av.ndof):
                av.gs[nb[:, d], d] = xp0[nb[:, d]]
        self.ge.save_primary(soe.soln)
        av.aux_var_compute()
        av.post_solve()
        if soe.metrics is not None:
            soe.metrics.record(step=nstep, dt=dt, converged=converged,
                               reason=reason, newton_iterations=res.iters,
                               fnorm=float(res.fnorm[0]))
        return converged, reason


def compile_photosynthesis(mpp, device="cuda") -> CompiledPhotosynthesis:
    """Freeze a fully staged ``PhotosynthesisMPP`` into a compiled batched
    stepper on ``device`` (call after staging +
    determine_if_solution_is_bounded + initial condition)."""
    return CompiledPhotosynthesis(mpp, device)

"""Batched canopy turbulence: the production path's presolve.

Counterpart of ``mpp_tpu/batched/turbulence.py`` (itself a functional
re-expression of ``models/canopy_turbulence.py``, after
``ge/CanopyTurbulence.F90``): all canopy-air columns advance together as
[ncair] lanes, the Obukhov-length fixed point runs as a batched
hybrid/Brent root solve (``MathTools.F90:38-235`` semantics, one function
evaluation per iteration for every lane, per-lane modes), and the RSL
psi-hat lookup is a vectorized bilinear gather.  Plain PyTorch on the
inputs' device and dtype.

The JAX form's ``lax.while_loop`` is a Python loop here with the same exit
test (every lane done); the test reads one device bool on the host per
iteration through ``sync``, and :func:`batched_hybrid` returns the
iteration count beside the root.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from mpp_tpu_torch.constants import VKC, GRAVITY_CONSTANT, RGAS
from mpp_tpu_torch.ops.rsl_psihat import load_psihat
from mpp_tpu_torch.models.canopy_turbulence import (
    CD, BETA_NEUTRAL_MAX, CR, C2, PR0, PR1, PR2, Z0MG, ZETA_MIN, ZETA_MAX,
    BETA_MIN, BETA_MAX, WIND_MIN, RA_MAX)


# ---------------------------------------------------------------------------
# psi-hat bilinear lookup, vectorized (CanopyTurbulence.F90:445-538)
# ---------------------------------------------------------------------------

class PsiHatTables(NamedTuple):
    zdt_m: torch.Tensor
    dtl_m: torch.Tensor
    psi_m: torch.Tensor
    zdt_h: torch.Tensor
    dtl_h: torch.Tensor
    psi_h: torch.Tensor


def load_psihat_tables(device, dtype=torch.float64, path=None) \
        -> PsiHatTables:
    """The psihat tables (``share/rsl_psihat.bin``, or ``path``, or
    ``$MPP_RSL_PSIHAT``) as tensors on ``device`` in ``dtype``."""
    t = load_psihat(path)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return PsiHatTables(f(t.zdt_m), f(t.dtl_m), f(t.psi_m),
                        f(t.zdt_h), f(t.dtl_h), f(t.psi_h))


def _search(grid, v, right):
    """``searchsorted`` of ``v`` into the ascending 1-D ``grid``, both in
    their promoted dtype (as ``jnp.searchsorted`` compares them)."""
    dt = torch.promote_types(grid.dtype, v.dtype)
    return torch.searchsorted(grid.to(dt).contiguous(), v.to(dt).contiguous(),
                              right=right)


def lookup_psihat(zdt, dtl, zdtgrid, dtlgrid, psigrid):
    """Vectorized bilinear psihat lookup; off-grid queries collapse to the
    0.5/0.5-weighted edge row/column exactly as the reference does."""
    zdt, dtl = torch.broadcast_tensors(zdt, dtl)
    nl = dtlgrid.shape[0]
    nz = zdtgrid.shape[0]

    # dt/L axis (ascending grid)
    jj = _search(dtlgrid, dtl, right=False) - 1
    l1 = torch.clamp(jj, 0, nl - 2)
    l2 = l1 + 1
    wl1_in = (dtlgrid[l2] - dtl) / (dtlgrid[l2] - dtlgrid[l1])
    lo_l = dtl <= dtlgrid[0]
    hi_l = dtl > dtlgrid[nl - 1]
    edge_l = torch.where(lo_l, 0, nl - 1)
    l1 = torch.where(lo_l | hi_l, edge_l, l1)
    l2 = torch.where(lo_l | hi_l, edge_l, l2)
    wl1 = torch.where(lo_l | hi_l, 0.5, wl1_in)
    wl2 = torch.where(lo_l | hi_l, 0.5, 1.0 - wl1_in)

    # z/dt axis (descending grid): search on the reversed (ascending) view
    ii = nz - 1 - _search(torch.flip(zdtgrid, [0]), zdt, right=True)
    ii = torch.clamp(ii, min=0)
    z1 = torch.clamp(ii, 0, nz - 2)
    z2 = torch.clamp(z1 + 1, max=nz - 1)
    wz1_in = (zdt - zdtgrid[z2]) / (zdtgrid[z1] - zdtgrid[z2])
    lo_z = zdt > zdtgrid[0]
    hi_z = zdt < zdtgrid[nz - 1]
    edge_z = torch.where(lo_z, 0, nz - 1)
    z1 = torch.where(lo_z | hi_z, edge_z, z1)
    z2 = torch.where(lo_z | hi_z, edge_z, z2)
    wz1 = torch.where(lo_z | hi_z, 0.5, wz1_in)
    wz2 = torch.where(lo_z | hi_z, 0.5, 1.0 - wz1_in)

    return (wz1 * wl1 * psigrid[z1, l1] + wz2 * wl1 * psigrid[z2, l1]
            + wz1 * wl2 * psigrid[z1, l2] + wz2 * wl2 * psigrid[z2, l2])


# ---------------------------------------------------------------------------
# Monin-Obukhov stability functions (CanopyTurbulence.F90:540-630)
# ---------------------------------------------------------------------------

def phim_mo(zeta):
    unstable = zeta < 0.0
    zs = torch.where(unstable, zeta, -1.0)
    return torch.where(unstable, 1.0 / torch.sqrt(torch.sqrt(1.0 - 16.0 * zs)),
                       1.0 + 5.0 * zeta)


def phic_mo(zeta):
    unstable = zeta < 0.0
    zs = torch.where(unstable, zeta, -1.0)
    return torch.where(unstable, 1.0 / torch.sqrt(1.0 - 16.0 * zs),
                       1.0 + 5.0 * zeta)


def psim_mo(zeta):
    unstable = zeta < 0.0
    zs = torch.where(unstable, zeta, -1.0)
    x = torch.sqrt(torch.sqrt(1.0 - 16.0 * zs))
    val = (2.0 * torch.log((1.0 + x) / 2.0) + torch.log((1.0 + x * x) / 2.0)
           - 2.0 * torch.arctan(x) + math.pi * 0.5)
    return torch.where(unstable, val, -5.0 * zeta)


def psic_mo(zeta):
    unstable = zeta < 0.0
    zs = torch.where(unstable, zeta, -1.0)
    x = torch.sqrt(torch.sqrt(1.0 - 16.0 * zs))
    return torch.where(unstable, 2.0 * torch.log((1.0 + x * x) / 2.0),
                       -5.0 * zeta)


def compute_psi_rsl(tab: PsiHatTables, za, hc, disp, obu, beta, prsc):
    """RSL-corrected (psim, psic) at height ``za``
    (CanopyTurbulence.F90:330-404), all args broadcastable tensors."""
    z_minus_d = za - disp
    h_minus_d = hc - disp

    phim = phim_mo(h_minus_d / obu)
    c1 = (1.0 - VKC / (2.0 * beta * phim)) * math.exp(0.5 * C2)
    psihat1 = lookup_psihat((za - hc) / h_minus_d, h_minus_d / obu,
                            tab.zdt_m, tab.dtl_m, tab.psi_m)
    psihat2 = lookup_psihat(za * 0.0, h_minus_d / obu,
                            tab.zdt_m, tab.dtl_m, tab.psi_m)
    psim = (-psim_mo(z_minus_d / obu) + psim_mo(h_minus_d / obu)
            + (psihat1 - psihat2) * c1 + VKC / beta)

    phic = phic_mo(h_minus_d / obu)
    c1 = (1.0 - prsc * VKC / (2.0 * beta * phic)) * math.exp(0.5 * C2)
    psihat1 = lookup_psihat((za - hc) / h_minus_d, h_minus_d / obu,
                            tab.zdt_h, tab.dtl_h, tab.psi_h)
    psihat2 = lookup_psihat(za * 0.0, h_minus_d / obu,
                            tab.zdt_h, tab.dtl_h, tab.psi_h)
    psic = (-psic_mo(z_minus_d / obu) + psic_mo(h_minus_d / obu)
            + (psihat1 - psihat2) * c1)
    return psim, psic


# ---------------------------------------------------------------------------
# turbulence state + derived inputs (CanopyTurbulenceAuxType.F90:171-198)
# ---------------------------------------------------------------------------

class TurbInputs(NamedTuple):
    """Per-column [ncair] forcing/static inputs."""
    hc: torch.Tensor
    zref: torch.Tensor
    pref: torch.Tensor
    uref: torch.Tensor
    qref: torch.Tensor
    tref: torch.Tensor
    tcan: torch.Tensor
    qcan: torch.Tensor
    pai: torch.Tensor
    # derived (derived_atm)
    rhomol: torch.Tensor
    thref: torch.Tensor
    thvref: torch.Tensor
    Lc: torch.Tensor


def derive_inputs(hc, zref, pref, uref, qref, tref, tcan, qcan,
                  pai) -> TurbInputs:
    rhomol = pref / (RGAS * tref)
    thref = tref + 0.0098 * zref
    thvref = thref * (1.0 + 0.61 * qref)
    Lc = hc / (CD * pai)
    return TurbInputs(hc, zref, pref, uref, qref, tref, tcan, qcan, pai,
                      rhomol, thref, thvref, Lc)


class TurbAux(NamedTuple):
    """Side-effect state of one Obukhov residual evaluation [ncair]."""
    beta: torch.Tensor
    disp: torch.Tensor
    PrSc: torch.Tensor
    c1m: torch.Tensor
    ustar: torch.Tensor
    tstar: torch.Tensor
    qstar: torch.Tensor
    obu_ustar: torch.Tensor
    gac: torch.Tensor
    obu: torch.Tensor


def obukhov_residual(tab: PsiHatTables, inp: TurbInputs, obu_val):
    """Batched fixed-point residual (CanopyTurbulence.F90:233-327).

    Returns (g = obu_new - obu_val, TurbAux of this evaluation)."""
    obu_cur = torch.where(torch.abs(obu_val) < 0.1, 0.1, obu_val)

    c1 = (VKC / torch.log((inp.hc + Z0MG) / Z0MG)) ** 2.0
    beta_neutral = torch.clamp(torch.sqrt(c1 + CR * inp.pai),
                               max=BETA_NEUTRAL_MAX)

    LcL = inp.Lc / obu_cur
    # unstable branch
    bu = 16.0 * LcL * beta_neutral ** 4.0
    beta_unstable = torch.sqrt(
        0.5 * (-bu + torch.sqrt(bu ** 2.0 + 4.0 * beta_neutral ** 4.0)))
    # stable branch: depressed-cubic closed form
    a = 5.0 * torch.where(LcL > 0.0, LcL, 1.0)
    dd = -beta_neutral
    q = (27.0 * a ** 2 * dd) ** 2.0 - 4.0 * (-3.0 * a) ** 3.0
    q = torch.sqrt(q)
    r = 0.5 * (q + 27.0 * a ** 2 * dd)
    r = torch.copysign(torch.abs(r) ** (1.0 / 3.0), r)      # cbrt
    beta_stable = -r / (3.0 * a) - (-3.0 * a) / (3.0 * a * r)
    beta = torch.where(LcL <= 0.0, beta_unstable, beta_stable)
    beta = torch.clamp(beta, BETA_MIN, BETA_MAX)

    dp = beta ** 2.0 * inp.Lc * (1.0 - torch.exp(-0.25 * inp.pai
                                                 / beta ** 2.0))
    dp = torch.minimum(inp.hc, dp)
    disp = torch.clamp(inp.hc - dp, min=0.0)

    z_minus_d = inp.zref - disp
    h_minus_d = inp.hc - disp

    prsc = PR0 + PR1 * torch.tanh(PR2 * inp.Lc / obu_cur)
    prsc = ((1.0 - beta_neutral / BETA_NEUTRAL_MAX)
            + (beta_neutral / BETA_NEUTRAL_MAX) * prsc)

    zeta = z_minus_d / obu_cur
    zeta = torch.where(zeta >= 0.0, torch.clamp(zeta, 0.01, ZETA_MAX),
                       torch.clamp(zeta, ZETA_MIN, -0.01))
    obu_cur = z_minus_d / zeta

    phi_m_hc = phim_mo(h_minus_d / obu_cur)
    c1m = (1.0 - VKC / (2.0 * beta * phi_m_hc)) * math.exp(0.5 * C2)

    psim, psic = compute_psi_rsl(tab, inp.zref, inp.hc, disp, obu_cur,
                                 beta, prsc)
    zlog = torch.log(z_minus_d / h_minus_d)
    ustar = inp.uref * VKC / (zlog + psim)
    tstar = (inp.thref - inp.tcan) * VKC / (zlog + psic)
    qstar = (inp.qref - inp.qcan) * VKC / (zlog + psic)
    gac = inp.rhomol * VKC * ustar / (zlog + psic)
    tvstar = tstar + 0.61 * inp.thref * qstar
    obu_new = ustar ** 2.0 * inp.thvref / (VKC * GRAVITY_CONSTANT * tvstar)
    aux = TurbAux(beta, disp, prsc, c1m, ustar, tstar, qstar, obu_cur, gac,
                  obu_new)
    return obu_new - obu_val, aux


# ---------------------------------------------------------------------------
# batched hybrid/Brent root solve (MathTools.F90:38-235 semantics)
# ---------------------------------------------------------------------------

MODE_SECANT = 0
MODE_BRENT = 1
MODE_FINAL = 2   # itmax hit: one last eval at minx, then done
MODE_DONE = 3


def batched_hybrid(fn, x0_init, x1_init, tol, itmax=40, brent_itmax=50,
                   eps=1.0e-8, sync=None):
    """Batched root solve with the reference ``hybrid`` semantics:
    secant iteration per lane, switching to Brent once a sign change
    brackets the root; after ``itmax`` secant steps, re-evaluate at the
    minimum-f iterate and stop.  ``fn(x) -> (g, aux)`` evaluates ALL lanes
    (one call per iteration); each lane's ``aux`` freezes at its last
    evaluation, matching the side-effect contract of the scalar solver.
    The loop runs while any lane is not done, the test read on the host
    through ``sync`` (default: ``.item()``) once an iteration.

    Returns (x_root, aux_last, iterations)."""
    sync = sync or torch.Tensor.item
    g0, aux = fn(x0_init)
    g1, aux1 = fn(x1_init)
    aux = aux1
    w = torch.where

    # NOTE: reference compares raw f, not |f| (MathTools.F90:85-91)
    minx = w(g1 < g0, x1_init, x0_init)
    minf = w(g1 < g0, g1, g0)

    mode = torch.full(x0_init.shape, MODE_SECANT, dtype=torch.int32,
                      device=x0_init.device)
    mode = w(g0 == 0.0, MODE_DONE, mode)
    mode = w((g1 == 0.0) & (mode != MODE_DONE), MODE_DONE, mode)
    root = w(g0 == 0.0, x0_init, x1_init)

    zf = torch.zeros_like(x0_init)
    x0, f0, x1, f1 = x0_init, g0, x1_init, g1
    a = fa = b = fb = c = fc = d = e = zf
    it = torch.zeros_like(mode)
    bit = torch.zeros_like(mode)

    iters = 0
    while sync((mode != MODE_DONE).any()):
        iters += 1
        in_sec = mode == MODE_SECANT
        in_brent = mode == MODE_BRENT
        in_final = mode == MODE_FINAL

        # ---- secant proposal (MathTools.F90:94-131)
        denom = w(f1 == f0, 1.0, f1 - f0)
        dx = -f1 * (x1 - x0) / denom
        x_prop = x1 + dx
        sec_conv = torch.abs(dx) < tol
        it = w(in_sec, it + 1, it)
        sec_itmax = it > itmax

        # ---- Brent step (MathTools.F90:135-235)
        st_a, st_fa, st_b, st_fb = a, fa, b, fb
        st_c, st_fc, st_d, st_e = c, fc, d, e
        same_sign = ((fb > 0.0) & (fc > 0.0)) | ((fb < 0.0) & (fc < 0.0))
        c = w(same_sign, a, c)
        fc = w(same_sign, fa, fc)
        d = w(same_sign, b - a, d)
        e = w(same_sign, b - a, e)
        swap = torch.abs(fc) < torch.abs(fb)
        a, b, c = w(swap, b, a), w(swap, c, b), w(swap, a, c)
        fa, fb, fc = w(swap, fb, fa), w(swap, fc, fb), w(swap, fa, fc)
        tol1 = 2.0 * eps * torch.abs(b) + 0.5 * tol
        xm = 0.5 * (c - b)
        brent_done = (torch.abs(xm) <= tol1) | (fb == 0.0)
        # interpolation step
        use_interp = (torch.abs(e) >= tol1) & (torch.abs(fa) > torch.abs(fb))
        s = fb / w(fa == 0.0, 1.0, fa)
        a_eq_c = a == c
        p_lin = 2.0 * xm * s
        q_lin = 1.0 - s
        qq = fa / w(fc == 0.0, 1.0, fc)
        rr = fb / w(fc == 0.0, 1.0, fc)
        p_quad = s * (2.0 * xm * qq * (qq - rr) - (b - a) * (rr - 1.0))
        q_quad = (qq - 1.0) * (rr - 1.0) * (s - 1.0)
        p = w(a_eq_c, p_lin, p_quad)
        q = w(a_eq_c, q_lin, q_quad)
        q = w(p > 0.0, -q, q)
        p = torch.abs(p)
        accept = (2.0 * p < torch.minimum(3.0 * xm * q - torch.abs(tol1 * q),
                                          torch.abs(e * q)))
        e_new = w(accept, d, xm)
        d_new = w(accept, p / w(q == 0.0, 1.0, q), xm)
        e_new = w(use_interp, e_new, xm)
        d_new = w(use_interp, d_new, xm)
        a_next = b
        fa_next = fb
        b_step = w(torch.abs(d_new) > tol1, b + d_new,
                   b + w(xm >= 0.0, tol1, -tol1))
        bit = w(in_brent, bit + 1, bit)
        brent_fail = bit >= brent_itmax

        # ---- evaluation point for every lane
        x_eval = w(in_sec, x_prop,
                   w(in_brent, b_step, w(in_final, minx, root)))
        # lanes finishing this step without needing the eval:
        sec_now_done = in_sec & sec_conv
        brent_now_done = in_brent & (brent_done | brent_fail)
        need_eval = ((in_sec & ~sec_conv) | (in_brent & ~brent_now_done)
                     | in_final)

        g, aux_new = fn(x_eval)
        aux = TurbAux(*(w(need_eval, an, ao) for an, ao in zip(aux_new, aux)))

        # ---- secant post-eval updates
        lower = in_sec & need_eval & (g < minf)
        minf_new = w(lower, g, minf)
        minx_new = w(lower, x_eval, minx)
        bracket = in_sec & need_eval & (g * f1 < 0.0)
        # shift: x0,f0 = x1,f1 ; x1,f1 = x_prop,g
        shift = in_sec & ~sec_conv
        x0n = w(shift, x1, x0)
        f0n = w(shift, f1, f0)
        x1n = w(shift, x_prop, x1)
        f1n = w(shift, g, f1)

        # mode transitions
        # secant converged: root = x_prop (no eval of it)
        mode_n = w(sec_now_done, MODE_DONE, mode)
        root = w(sec_now_done, x_prop, root)
        # bracket found -> enter Brent with (a,fa)=(x0,f0)shifted,(b,fb)=new
        enter_brent = bracket & ~sec_now_done
        mode_n = w(enter_brent, MODE_BRENT, mode_n)
        an = w(enter_brent, x0n, a_next)
        fan = w(enter_brent, f0n, fa_next)
        bn = w(enter_brent, x1n, b_step)
        fbn = w(enter_brent, f1n, g)
        cn = w(enter_brent, x1n, c)
        fcn = w(enter_brent, f1n, fc)
        dn = w(enter_brent, 0.0, d_new)
        en = w(enter_brent, 0.0, e_new)
        # secant itmax -> final eval at minx next iteration
        hit_itmax = in_sec & ~sec_now_done & ~enter_brent & sec_itmax
        mode_n = w(hit_itmax, MODE_FINAL, mode_n)
        # brent done: root = b (pre-step b)
        mode_n = w(brent_now_done, MODE_DONE, mode_n)
        root = w(brent_now_done, b, root)
        # brent post-eval: fb = g at b_step; immediate zero -> done
        brent_zero = in_brent & ~brent_now_done & (g == 0.0)
        mode_n = w(brent_zero, MODE_DONE, mode_n)
        root = w(brent_zero, b_step, root)
        # final-eval lanes: done, root = minx
        mode_n = w(in_final, MODE_DONE, mode_n)
        root = w(in_final, minx, root)

        # the Brent registers: the lanes that stay in Brent take the step,
        # the lanes entering Brent their start; every other lane keeps them
        # as they were before this iteration (st.a ... st.e of the JAX form)
        keep = (in_brent & ~brent_now_done) | enter_brent
        a, fa = w(keep, an, st_a), w(keep, fan, st_fa)
        b, fb = w(keep, bn, st_b), w(keep, fbn, st_fb)
        c, fc = w(keep, cn, st_c), w(keep, fcn, st_fc)
        d, e = w(keep, dn, st_d), w(keep, en, st_e)
        x0 = w(in_sec, x0n, x0)
        f0 = w(in_sec, f0n, f0)
        x1 = w(in_sec, x1n, x1)
        f1 = w(in_sec, f1n, f1)
        minx, minf, mode = minx_new, minf_new, mode_n
    return root, aux, iters


def obukhov_length(tab: PsiHatTables, inp: TurbInputs, sync=None):
    """Batched Obukhov fixed point (CanopyTurbulence.F90:42-64).

    Returns (the TurbAux from the last residual evaluation, with
    ``obu = obu_ustar`` applied (the reference keeps the side-effect
    state, not the returned root), the hybrid's iterations)."""
    x0 = torch.full_like(inp.hc, 100.0)
    x1 = torch.full_like(inp.hc, -100.0)
    _, aux, iters = batched_hybrid(lambda x: obukhov_residual(tab, inp, x),
                                   x0, x1, 0.01, sync=sync)
    return aux._replace(obu=aux.obu_ustar), iters


# ---------------------------------------------------------------------------
# wind + conductance profiles (CanopyTurbulence.F90:67-231), vectorized
# ---------------------------------------------------------------------------

def wind_profile(tab: PsiHatTables, inp: TurbInputs, aux: TurbAux, zs,
                 ntop: int):
    """RSL wind profile over [ncair, nlev]; ``zs`` is [ncair, nlev] and
    ``ntop`` the canopy-top level index."""
    nlev = zs.shape[-1]
    k = torch.arange(nlev, device=zs.device)
    hc = inp.hc[:, None]
    disp = aux.disp[:, None]
    h_minus_d = hc - disp
    psim, _ = compute_psi_rsl(tab, zs, hc, disp, aux.obu[:, None],
                              aux.beta[:, None], aux.PrSc[:, None])
    above = (aux.ustar[:, None] / VKC
             * (torch.log((zs - disp) / h_minus_d) + psim))
    ucan = aux.ustar / aux.beta
    lm_over_beta = 2.0 * aux.beta ** 2.0 * inp.Lc
    within = torch.clamp(
        ucan[:, None] * torch.exp((zs - hc) / lm_over_beta[:, None]),
        min=WIND_MIN)
    wind = torch.where(k[None, :] >= ntop, above, within)
    wind = torch.where(k[None, :] == 0, 0.0, wind)
    return wind, ucan


def aerodynamic_conductances(tab: PsiHatTables, inp: TurbInputs,
                             aux: TurbAux, zs, wind, ntop: int):
    """Layer-to-layer conductance profile ga [ncair, nlev]
    (CanopyTurbulence.F90:109-231)."""
    nlev = zs.shape[-1]
    k = torch.arange(nlev, device=zs.device)
    hc = inp.hc[:, None]
    disp = aux.disp[:, None]
    obu = aux.obu[:, None]
    beta = aux.beta[:, None]
    prsc = aux.PrSc[:, None]
    rhomol = inp.rhomol[:, None]
    ustar = aux.ustar[:, None]

    # psic at every level + at zref
    _, psic_z = compute_psi_rsl(tab, zs, hc, disp, obu, beta, prsc)
    _, psic_ref = compute_psi_rsl(tab, inp.zref[:, None], hc, disp, obu,
                                  beta, prsc)
    _, psic_hc = compute_psi_rsl(tab, hc, hc, disp, obu, beta, prsc)

    # above-canopy neighbors k -> k+1 (valid for k in [ntop, nlev-2])
    zs_up = _cat(zs[:, 1:], inp.zref[:, None])
    psic_up = _cat(psic_z[:, 1:], psic_ref)
    ga_above = (rhomol * VKC * ustar
                / (torch.log((zs_up - disp) / (zs - disp))
                   + (psic_up - psic_z)))

    # within canopy (k in [1, ntop-2]): exponential resistance
    lm_over_beta = (2.0 * aux.beta ** 2.0 * inp.Lc)[:, None]
    zl = zs - hc
    zu = zs_up - hc
    res_within = (prsc / (beta * ustar)
                  * (torch.exp(-zl / lm_over_beta)
                     - torch.exp(-zu / lm_over_beta)))
    ga_within = rhomol / res_within

    # top-of-canopy layer (k = ntop-1): series of below-hc and above-hc legs
    res_below_hc = (prsc / (beta * ustar)
                    * (torch.exp(-zl / lm_over_beta) - 1.0))
    ga_below_hc = rhomol / res_below_hc
    ga_above_hc = (rhomol * VKC * ustar
                   / (torch.log((zs_up - disp) / (hc - disp))
                      + (psic_up - psic_hc)))
    ga_top = 1.0 / (1.0 / ga_below_hc + 1.0 / ga_above_hc)

    ga = torch.where(k[None, :] >= ntop, ga_above,
                     torch.where(k[None, :] == ntop - 1, ga_top, ga_within))

    # ground (k = 0)
    zoc_g = 0.1 * Z0MG
    zlog_m = torch.log(zs[:, 1] / Z0MG)
    zlog_c = torch.log(zs[:, 1] / zoc_g)
    ustar_g = torch.clamp(wind[:, 1] * VKC / zlog_m, min=0.01)
    res_g = zlog_c / (VKC * ustar_g)
    ga0 = rhomol[:, 0] / res_g
    res_g = torch.clamp(rhomol[:, 0] / ga0, max=RA_MAX)
    ga0 = rhomol[:, 0] / res_g
    ga = torch.cat([ga0[:, None].to(ga.dtype), ga[:, 1:]], dim=1)

    # clamp resistance to < 500 s/m for k >= 1
    res = torch.clamp(rhomol / ga, max=500.0)
    ga_clamped = rhomol / res
    return torch.where(k[None, :] >= 1, ga_clamped, ga)


def _cat(a, b):
    """Concatenate along the levels in the promoted dtype (as
    ``jnp.concatenate``)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.cat([a.to(dt), b.to(dt)], dim=1)


def presolve(tab: PsiHatTables, inp: TurbInputs, zs, ntop: int, sync=None):
    """Full turbulence presolve: Obukhov solve + wind + conductances.

    Returns (TurbAux, wind [ncair, nlev], ga [ncair, nlev], the Obukhov
    hybrid's iterations)."""
    aux, iters = obukhov_length(tab, inp, sync=sync)
    wind, _ = wind_profile(tab, inp, aux, zs, ntop)
    ga = aerodynamic_conductances(tab, inp, aux, zs, wind, ntop)
    return aux, wind, ga, iters

"""Batched multi-layer canopy (MLC): the production path's canopy solve.

Counterpart of ``mpp_tpu/batched/mlc.py`` (itself a functional
re-expression of ``models/mlc.py``, after
``soe/SystemOfEquationsMLCType.F90`` and the three canopy GEs): the
coupled [T_air | q_air | T_sun... | T_shd...] system is block-tridiagonal
when unknowns are grouped per canopy level — every coupling in the 4-block
DMComposite fill (:333-455) stays within a level or reaches level k±1 —
so the PETSc GMRES+ILU(0) solve becomes an exact batched block-Thomas
sweep (``ops/block_structure.block_solve``: the ``block_thomas_small``
kernel on the card; m = 4 at one tree), with canopy-air columns as the
batch axis.

Block layout per level: m = 2 + 2*ntree rows
  row 0        = canopy-air temperature (Bonan eliminated-soil row at k=0)
  row 1        = canopy-air water vapor
  row 2+s      = leaf temperature, slot s (sun trees first, then shade)

The reference's assembly quirks are reproduced as the JAX form has them:
the air-row leaf off-diagonals index the boundary conductances by GE rank
(sun/shade) rather than tree slot (``models/mlc.py:447-455, 511-525``),
and the leaf GEs read the last column's cpair (:244-246).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from mpp_tpu_torch.constants import HVAP, MM_H2O
from mpp_tpu_torch.ops.satvap import sat_vap
from mpp_tpu_torch.ops.block_structure import block_solve

LAMBDA = HVAP * MM_H2O


class MLCBlockInputs(NamedTuple):
    """Staged (post-presolve) MLC state, batched over [ncair] columns.

    Shapes: [ncair] scalars-per-column, [ncair, nlev] air-cell fields,
    [ncair, nlev, nslots] leaf fields (nslots = 2*ntree, sun slots
    first), [ncair, nlev-1] internal-connection conductances.
    Level 0 is the soil cell of every column (mlc_meshes.F90)."""
    # primaries (staged from the previous solution)
    at_T: torch.Tensor            # [ncair, nlev]
    av_q: torch.Tensor            # [ncair, nlev]
    leaf_T: torch.Tensor          # [ncair, nlev, nslots]
    # per-column scalars from the turbulence presolve
    cpair: torch.Tensor           # [ncair]
    rhomol: torch.Tensor          # [ncair]
    pref: torch.Tensor            # [ncair]
    leaf_cpair: torch.Tensor      # [] or [ncair] (reference: last column's)
    leaf_pref: torch.Tensor
    # soil-surface properties (level 0)
    soil_rhg: torch.Tensor        # [ncair]
    soil_rn: torch.Tensor
    soil_tk: torch.Tensor
    soil_dz: torch.Tensor
    soil_res: torch.Tensor
    soil_T: torch.Tensor
    # leaf-slot fields on air cells
    gbh_air: torch.Tensor         # [ncair, nlev, nslots]
    gbv_air: torch.Tensor
    leaf_gs: torch.Tensor
    leaf_fwet: torch.Tensor
    leaf_fdry: torch.Tensor
    leaf_fssh: torch.Tensor
    leaf_dpai: torch.Tensor
    # leaf-GE own fields
    leaf_gbh: torch.Tensor        # [ncair, nlev, nslots]
    leaf_gbv: torch.Tensor
    leaf_rn: torch.Tensor
    leaf_cp: torch.Tensor
    # aerodynamic conductances + top BC
    conn_ga: torch.Tensor         # [ncair, nlev-1]
    bc_ga: torch.Tensor           # [ncair]
    bc_T: torch.Tensor
    bc_q: torch.Tensor
    vol_air: torch.Tensor         # [] cell volume (dz_cair)


def inputs_from_mpp(mpp, device=None) -> MLCBlockInputs:
    """Convert a staged serial ``MLCMPP`` (after ``pre_solve`` +
    ``get_from_soe_auxvars_cturb``) into batched block inputs: f64 tensors
    on ``device``, the MPP's own device unless given one."""
    device = mpp.device if device is None else device
    nc, nlev, nt = mpp.ncair, mpp.nlev, mpp.ntree
    ns = 2 * nt

    def f(a, shape=None):
        a = np.asarray(a, np.float64)
        return torch.as_tensor(a if shape is None else a.reshape(shape),
                               device=device)

    if not bool(np.all(mpp.at_is_soil.reshape(nc, nlev)[:, 0])):
        raise ValueError("level 0 must be the soil cell")

    # leaf GE cell (icair, itree, k) -> [ncair, nlev, slot]
    leaf_T = np.zeros((nc, nlev, ns))
    leaf_own = {k: np.zeros((nc, nlev, ns))
                for k in ("gbh", "gbv", "rn", "cp")}
    for r in (0, 1):
        ge = mpp.leaf[r]
        vals = ge["T"].reshape(nc, nt, nlev)
        for it in range(nt):
            leaf_T[:, :, r * nt + it] = vals[:, it, :]
            for k in leaf_own:
                leaf_own[k][:, :, r * nt + it] = \
                    ge[k].reshape(nc, nt, nlev)[:, it, :]
    col0 = lambda a: f(np.asarray(a).reshape(nc, nlev)[:, 0])

    return MLCBlockInputs(
        at_T=f(mpp.at_T, (nc, nlev)),
        av_q=f(mpp.av_q, (nc, nlev)),
        leaf_T=f(leaf_T),
        cpair=col0(mpp.at_cpair),
        rhomol=col0(mpp.at_rhomol),
        pref=col0(mpp.at_pref),
        leaf_cpair=f(float(mpp.leaf[0]["cpair"][0])),
        leaf_pref=f(float(mpp.leaf[0]["pref"][0])),
        soil_rhg=col0(mpp.at_soil_rhg),
        soil_rn=col0(mpp.at_soil_rn),
        soil_tk=col0(mpp.at_soil_tk),
        soil_dz=col0(mpp.at_soil_dz),
        soil_res=col0(mpp.at_soil_resis),
        soil_T=col0(mpp.at_soil_T),
        gbh_air=f(mpp.at_gbh, (nc, nlev, ns)),
        gbv_air=f(mpp.av_gbv, (nc, nlev, ns)),
        leaf_gs=f(mpp.at_leaf_gs, (nc, nlev, ns)),
        leaf_fwet=f(mpp.at_leaf_fwet, (nc, nlev, ns)),
        leaf_fdry=f(mpp.at_leaf_fdry, (nc, nlev, ns)),
        leaf_fssh=f(mpp.at_leaf_fssh, (nc, nlev, ns)),
        leaf_dpai=f(mpp.at_leaf_dpai, (nc, nlev, ns)),
        leaf_gbh=f(leaf_own["gbh"]),
        leaf_gbv=f(leaf_own["gbv"]),
        leaf_rn=f(leaf_own["rn"]),
        leaf_cp=f(leaf_own["cp"]),
        conn_ga=f(mpp.at_conn_ga, (nc, nlev - 1)),
        bc_ga=f(mpp.at_bc_ga, (nc,)),
        bc_T=f(mpp.at_bc_T, (nc,)),
        bc_q=f(mpp.av_bc_q, (nc,)),
        vol_air=f(float(mpp._compute_vol_air()[0])),
    )


def _soil_coeffs(inp: MLCBlockInputs):
    """Eliminated ground-surface row coefficients (Bonan 2019 eqns
    16.86-16.88; GoveqnCanopyAirTemperatureType.F90:594-730)."""
    ga0 = inp.conn_ga[:, 0]
    gsw = 1.0 / inp.soil_res * inp.rhomol
    gs0 = gsw * ga0 / (gsw + ga0)
    esat0, desat0 = sat_vap(inp.at_T[:, 0])
    qsat0 = esat0 / inp.pref
    dqsat0 = desat0 / inp.pref
    rhg = inp.soil_rhg
    gamma0 = (inp.cpair * ga0 + LAMBDA * rhg * gs0 * dqsat0
              + inp.soil_tk / inp.soil_dz)
    alpha0 = inp.cpair * ga0 / gamma0
    beta0 = LAMBDA * gs0 / gamma0
    delta0 = (inp.soil_rn
              - LAMBDA * rhg * gs0 * (qsat0 - dqsat0 * inp.at_T[:, 0])
              + inp.soil_tk / inp.soil_dz * inp.soil_T) / gamma0
    return ga0, gs0, qsat0, dqsat0, alpha0, beta0, delta0


def assemble(inp: MLCBlockInputs, dt):
    """Block-tridiagonal (L, D, U, b) for one KSP step.

    Returns blocks [ncair, nlev, m, m] and RHS [ncair, nlev, m] in the
    dtype of ``at_T``."""
    nc, nlev, ns = inp.leaf_dpai.shape
    nt = ns // 2
    m = 2 + ns
    dtype, device = inp.at_T.dtype, inp.at_T.device
    L = torch.zeros((nc, nlev, m, m), dtype=dtype, device=device)
    D = torch.zeros((nc, nlev, m, m), dtype=dtype, device=device)
    U = torch.zeros((nc, nlev, m, m), dtype=dtype, device=device)
    b = torch.zeros((nc, nlev, m), dtype=dtype, device=device)

    ga0, gs0, qsat0, dqsat0, alpha0, beta0, delta0 = _soil_coeffs(inp)
    # rank index of each slot (sun GE=0, shade GE=1) for the air-row
    # off-diagonal conductance quirk
    rank_of_slot = torch.arange(ns, device=device) // nt

    dpai_pos = inp.leaf_dpai > 0.0
    rho_col = inp.rhomol[:, None]        # [nc, 1]
    pref_col = inp.pref[:, None]

    # ===== air temperature rows (row 0) =====================================
    # soil row (level 0): identity + eliminated-surface couplings
    D[:, 0, 0, 0] = 1.0
    U[:, 0, 0, 0] = -alpha0
    U[:, 0, 0, 1] = -beta0
    b[:, 0, 0] = delta0
    D[:, 1, 0, 0] += -alpha0 * ga0
    D[:, 1, 0, 1] += -beta0 * ga0
    b[:, 1, 0] += delta0 * ga0

    # non-soil accumulation + leaf sensible-heat diagonal
    acc_T = rho_col / dt * inp.vol_air
    leaf_diag = torch.where(
        dpai_pos, 2.0 * inp.gbh_air * inp.leaf_fssh * inp.leaf_dpai,
        0.0).sum(-1)
    D[:, 1:, 0, 0] += acc_T + leaf_diag[:, 1:]
    b[:, 1:, 0] += acc_T * inp.at_T[:, 1:]

    # internal connections (k <-> k+1), conductance ga
    ga = inp.conn_ga
    # upper cell (k>0) of connection k: +ga diag, -ga to k+1
    D[:, 1:-1, 0, 0] += ga[:, 1:]
    U[:, 1:-1, 0, 0] += -ga[:, 1:]
    # lower cell (k+1) of every connection: +ga diag; -ga to k if k>0
    D[:, 1:, 0, 0] += ga
    L[:, 2:, 0, 0] += -ga[:, 1:]

    # top boundary
    D[:, -1, 0, 0] += inp.bc_ga
    b[:, -1, 0] += inp.bc_ga * inp.bc_T

    # off-diagonal to leaf temperatures (conductance indexed by GE rank,
    # not slot — models/mlc.py:447-455)
    gbh_rank = inp.gbh_air[:, :, rank_of_slot]
    offT = torch.where(dpai_pos,
                       -2.0 * gbh_rank * inp.leaf_fssh * inp.leaf_dpai, 0.0)
    D[:, 1:, 0, 2:] += offT[:, 1:]

    # ===== air vapor rows (row 1) ===========================================
    D[:, 0, 1, 1] = 1.0
    b[:, 0, 1] = inp.av_q[:, 0]
    # (vapor GE reads the same staged state, so its gs0/alpha0/beta0/delta0
    # coincide with the temperature GE's)
    rhg = inp.soil_rhg
    D[:, 1, 1, 1] += -gs0 * dqsat0 * rhg * beta0
    D[:, 1, 1, 0] += -rhg * dqsat0 * gs0 * alpha0
    b[:, 1, 1] += gs0 * rhg * (qsat0 + dqsat0 * (delta0 - inp.at_T[:, 0]))

    esat_l, desat_l = sat_vap(inp.leaf_T)
    qsat_l = esat_l / pref_col[..., None]
    dqsat_l = desat_l / pref_col[..., None]
    gleaf = inp.leaf_gs * inp.gbv_air / (inp.leaf_gs + inp.gbv_air)
    gleaf_et = (gleaf * inp.leaf_fdry + inp.gbv_air * inp.leaf_fwet) \
        * inp.leaf_fssh * inp.leaf_dpai
    gleaf_et = torch.where(dpai_pos, gleaf_et, 0.0)

    acc_q = rho_col / dt * inp.vol_air
    D[:, 1:, 1, 1] += acc_q + gleaf_et.sum(-1)[:, 1:]
    b[:, 1:, 1] += (acc_q * inp.av_q[:, 1:]
                    + torch.where(dpai_pos, gleaf_et
                                  * (qsat_l - dqsat_l * inp.leaf_T),
                                  0.0).sum(-1)[:, 1:])

    # connections: soil-end connections use the series surface conductance
    gsw = 1.0 / inp.soil_res * inp.rhomol
    ga_v0 = gsw * ga[:, 0] / (gsw + ga[:, 0])
    D[:, 1:-1, 1, 1] += ga[:, 1:]
    U[:, 1:-1, 1, 1] += -ga[:, 1:]
    D[:, 1, 1, 1] += ga_v0
    D[:, 2:, 1, 1] += ga[:, 1:]
    L[:, 2:, 1, 1] += -ga[:, 1:]

    D[:, -1, 1, 1] += inp.bc_ga
    b[:, -1, 1] += inp.bc_ga * inp.bc_q

    # off-diagonal to leaf temperatures (rank-indexed gbv quirk,
    # models/mlc.py:511-525)
    gbv_rank = inp.gbv_air[:, :, rank_of_slot]
    gleaf_r = inp.leaf_gs * gbv_rank / (inp.leaf_gs + gbv_rank)
    gleaf_et_r = (gleaf_r * inp.leaf_fdry + gbv_rank * inp.leaf_fwet) \
        * inp.leaf_fssh * inp.leaf_dpai
    offq = torch.where(dpai_pos, -dqsat_l * gleaf_et_r, 0.0)
    D[:, 1:, 1, 2:] += offq[:, 1:]

    # ===== leaf temperature rows (rows 2+s) =================================
    lf_dpai_pos = inp.leaf_dpai > 0.0     # leaf GE dpai == air-staged dpai
    esat_o, desat_o = sat_vap(inp.leaf_T)
    dqsat_o = desat_o / inp.leaf_pref
    qsat_o = esat_o / inp.leaf_pref
    gleaf_own = inp.leaf_gs * inp.leaf_gbv / (inp.leaf_gs + inp.leaf_gbv)
    gleaf_et_own = gleaf_own * inp.leaf_fdry + inp.leaf_gbv * inp.leaf_fwet

    diag_leaf = (inp.leaf_cp / dt + 2.0 * inp.leaf_cpair * inp.leaf_gbh
                 + LAMBDA * dqsat_o * gleaf_et_own)
    rhs_leaf = (inp.leaf_rn + inp.leaf_cp / dt * inp.leaf_T
                - LAMBDA * (qsat_o - dqsat_o * inp.leaf_T) * gleaf_et_own)
    slots = torch.arange(ns, device=device)
    D[:, :, 2 + slots, 2 + slots] = torch.where(lf_dpai_pos, diag_leaf,
                                                1.0).to(dtype)
    D[:, :, 2:, 0] = torch.where(
        lf_dpai_pos, -2.0 * inp.leaf_cpair * inp.leaf_gbh, 0.0).to(dtype)
    D[:, :, 2:, 1] = torch.where(
        lf_dpai_pos, -LAMBDA * gleaf_et_own, 0.0).to(dtype)
    b[:, :, 2:] = torch.where(lf_dpai_pos, rhs_leaf, 0.0).to(dtype)

    return L, D, U, b


def step(inp: MLCBlockInputs, dt):
    """One KSP step: assemble + exact block-Thomas solve.

    Returns the new state x [ncair, nlev, m] (rows: T_air, q_air,
    leaf slots)."""
    L, D, U, b = assemble(inp, dt)
    return block_solve(L, D, U, b)

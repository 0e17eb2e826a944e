"""Saturation, capillary-pressure and relative-permeability functions.

Counterpart of ``mpp_tpu/ops/satfunc.py`` (SaturationFunction.F90):
van Genuchten, Brooks-Corey, smoothed Brooks-Corey, FETCH2 and Chuang
saturation; Mualem (per saturation model), Weibull and Campbell relative
permeability; the SBC bz2/bz3 set-up solves.

Per-cell model selection is static numpy configuration (``SatParams``
holds numpy int model codes).  The dispatchers evaluate each model present
and blend with ``torch.where``; masked-out lanes see benign stand-in
parameters (``_sanitized``) so they cannot produce inf/NaN intermediates,
and each model guards its own operands (the NaN-safe ``where`` pattern of
``_safe``).  Capillary pressure is ``pc = press - PRESSURE_REF``, negative
when unsaturated.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mpp_tpu_torch.constants import PRESSURE_REF

# Model ids (SaturationFunction.F90:19-28)
SAT_FUNC_VAN_GENUCHTEN = 1301
SAT_FUNC_BROOKS_COREY = 1302
SAT_FUNC_SMOOTHED_BROOKS_COREY = 1303
SAT_FUNC_SMOOTHED_BROOKS_COREY_BZ2 = 1304
SAT_FUNC_SMOOTHED_BROOKS_COREY_BZ3 = 1305
SAT_FUNC_FETCH2 = 1306
SAT_FUNC_CHUANG = 1307
RELPERM_FUNC_MUALEM = 1308
RELPERM_FUNC_WEIBULL = 1309
RELPERM_FUNC_CAMPBELL = 1310

_REAL_FIELDS = ("sat_res", "alpha", "vg_m", "vg_n", "bc_lambda", "sbc_pu",
                "sbc_ps", "sbc_b2", "sbc_b3", "w_c", "w_d", "campbell_he",
                "campbell_n", "fetch2_phi88", "fetch2_phi50", "chuang_phi0",
                "chuang_p")


@dataclasses.dataclass
class SatParams:
    """SoA of ``saturation_params_type`` (SaturationFunction.F90:31-48).

    ``sat_func_type`` / ``relperm_func_type`` are numpy (static config);
    the real fields are numpy at set-up and tensors broadcastable against
    the state when evaluated (see :meth:`to`)."""
    sat_func_type: np.ndarray
    relperm_func_type: np.ndarray
    sat_res: object
    alpha: object
    vg_m: object
    vg_n: object
    bc_lambda: object
    sbc_pu: object
    sbc_ps: object
    sbc_b2: object
    sbc_b3: object
    w_c: object
    w_d: object
    campbell_he: object
    campbell_n: object
    fetch2_phi88: object
    fetch2_phi50: object
    chuang_phi0: object
    chuang_p: object

    @staticmethod
    def zeros(n: int) -> "SatParams":
        z = np.zeros(n)
        return SatParams(sat_func_type=np.zeros(n, np.int32),
                         relperm_func_type=np.zeros(n, np.int32),
                         **{k: z.copy() for k in _REAL_FIELDS})

    def to(self, device, dtype) -> "SatParams":
        """The real fields as tensors on ``device``/``dtype`` (a field that
        already is such a tensor is kept as it is)."""
        kw = {k: torch.as_tensor(getattr(self, k), dtype=dtype, device=device)
              for k in _REAL_FIELDS}
        return SatParams(sat_func_type=self.sat_func_type,
                         relperm_func_type=self.relperm_func_type, **kw)

    def set_vg(self, idx, sat_res, alpha, vg_m):
        """Van Genuchten setup; applies Mualem (SaturationFunction.F90:127-159)."""
        self.sat_func_type[idx] = SAT_FUNC_VAN_GENUCHTEN
        self.relperm_func_type[idx] = RELPERM_FUNC_MUALEM
        self.sat_res[idx] = sat_res
        self.alpha[idx] = alpha
        self.vg_m[idx] = vg_m
        self.vg_n[idx] = 1.0 / (1.0 - vg_m)

    def set_bc(self, idx, sat_res, alpha, lam):
        """Brooks-Corey setup (SaturationFunction.F90:163-192)."""
        self.sat_func_type[idx] = SAT_FUNC_BROOKS_COREY
        self.relperm_func_type[idx] = RELPERM_FUNC_MUALEM
        self.sat_res[idx] = sat_res
        self.alpha[idx] = alpha
        self.bc_lambda[idx] = lam

    def _set_sbc_common(self, idx, sat_res, alpha, lam, ps, pu):
        self.sat_func_type[idx] = SAT_FUNC_SMOOTHED_BROOKS_COREY
        self.relperm_func_type[idx] = RELPERM_FUNC_MUALEM
        self.sat_res[idx] = sat_res
        self.alpha[idx] = alpha
        self.bc_lambda[idx] = lam
        self.sbc_ps[idx] = ps
        self.sbc_pu[idx] = pu

    def set_sbc(self, idx, sat_res, alpha, lam, ps, pu):
        """Smoothed Brooks-Corey, explicit pu (SaturationFunction.F90:196-257)."""
        self._set_sbc_common(idx, sat_res, alpha, lam, ps, pu)
        bc_at_pu = (-alpha * pu) ** (-lam)
        lam_dpu = lam * (1.0 - ps / pu)
        inv_dpu = 1.0 / (pu - ps)
        self.sbc_b2[idx] = -(3.0 - bc_at_pu * (3.0 + lam_dpu)) * inv_dpu * inv_dpu
        self.sbc_b3[idx] = (2.0 - bc_at_pu * (2.0 + lam_dpu)) * inv_dpu ** 3

    def set_sbc_bz2(self, idx, sat_res, alpha, lam, ps):
        """SBC with pu chosen so b2=0 (SaturationFunction.F90:260-315)."""
        pu = _find_gu_sbc_zero_coeff(lam, 3, -alpha * ps) / (-alpha)
        self._set_sbc_common(idx, sat_res, alpha, lam, ps, pu)
        bc_at_pu = (-alpha * pu) ** (-lam)
        lam_dpu = lam * (1.0 - ps / pu)
        inv_dpu = 1.0 / (pu - ps)
        self.sbc_b2[idx] = 0.0
        b3 = (2.0 - bc_at_pu * (2.0 + lam_dpu)) * inv_dpu ** 3
        if b3 <= 0.0:
            raise ValueError("SatFunc_Set_SBC_bz2: b3 <= 0")
        self.sbc_b3[idx] = b3

    def set_sbc_bz3(self, idx, sat_res, alpha, lam, ps):
        """SBC with pu chosen so b3=0 (SaturationFunction.F90:319-372)."""
        pu = _find_gu_sbc_zero_coeff(lam, 2, -alpha * ps) / (-alpha)
        self._set_sbc_common(idx, sat_res, alpha, lam, ps, pu)
        bc_at_pu = (-alpha * pu) ** (-lam)
        lam_dpu = lam * (1.0 - ps / pu)
        inv_dpu = 1.0 / (pu - ps)
        b2 = -(3.0 - bc_at_pu * (3.0 + lam_dpu)) * inv_dpu * inv_dpu
        if b2 >= 0.0:
            raise ValueError("SatFunc_Set_SBC_bz3: b2 >= 0")
        self.sbc_b2[idx] = b2
        self.sbc_b3[idx] = 0.0

    def set_fetch2(self, idx, phi88, phi50):
        """FETCH2 xylem saturation (SaturationFunction.F90:375-391)."""
        self.sat_func_type[idx] = SAT_FUNC_FETCH2
        self.fetch2_phi88[idx] = phi88
        self.fetch2_phi50[idx] = phi50

    def set_chuang(self, idx, phi0, p):
        """Chuang xylem water content (SaturationFunction.F90:394-410)."""
        self.sat_func_type[idx] = SAT_FUNC_CHUANG
        self.chuang_phi0[idx] = phi0
        self.chuang_p[idx] = p

    def set_weibull_relperm(self, idx, d, c):
        """Weibull relperm (SaturationFunction.F90:522-540)."""
        self.relperm_func_type[idx] = RELPERM_FUNC_WEIBULL
        self.w_d[idx] = d
        self.w_c[idx] = c

    def set_campbell_relperm(self, idx, he, n):
        """Campbell relperm (SaturationFunction.F90:543-561)."""
        self.relperm_func_type[idx] = RELPERM_FUNC_CAMPBELL
        self.campbell_he[idx] = he
        self.campbell_n[idx] = n


def _find_gu_sbc_zero_coeff(lam: float, AA: int, gs: float) -> float:
    """Bracketed Newton for the SBC pu multiplier
    (SaturationFunction.F90:425-518); a set-up solve on Python floats."""
    if lam <= 0.0 or lam >= 2.0 or AA not in (2, 3) or gs >= 1.0 or gs < 0.0:
        raise ValueError("findGu_SBC_zeroCoeff: bad param")
    gu = (AA / (AA + lam)) ** (-1.0 / lam)
    if gs > 0.0:
        gu_left, gu_right = 1.0, gu
        rel_tol = 1.0e-12
        while True:
            if gu <= gu_left or gu >= gu_right:
                gu = gu_left + 0.5 * (gu_right - gu_left)
            gu_inv = 1.0 / gu
            gu_to_minus_lam = gu ** (-lam)
            gs_on_gu = gs * gu_inv
            resid = AA - gu_to_minus_lam * (AA + lam - lam * gs_on_gu)
            if resid < 0.0:
                gu_left = gu
            else:
                gu_right = gu
            dr = lam * gu_to_minus_lam * gu_inv * (
                (1.0 + lam) * (1.0 - gs_on_gu) + (AA - 1))
            delta = resid / dr
            gu = gu - delta
            if abs(delta) < rel_tol * abs(gu):
                break
    return gu


CLM_SATFUNC_TYPES = ("brooks_corey", "smooth_brooks_corey_bz2",
                     "smooth_brooks_corey_bz3", "van_genuchten")


def satparams_dyn_clm(satfunc_type: str, sat_res, alpha, lam):
    """Vectorized VSFMMPPSetSoilsCLM satfunc staging
    (MultiPhysicsProbVSFM.F90:392-419): CLM-derived (sat_res, alpha,
    lambda) numpy arrays -> dict of SatParams real-field overrides (numpy)
    for the compiled path's dynamic-parameter contract.  For the smoothed
    Brooks-Corey variants ps = -0.9/alpha, so the pu multiplier depends on
    lambda alone and is solved once per unique lambda (scattered back by
    the inverse index: a mask per unique value is quadratic in the cell
    count)."""
    sat_res = np.asarray(sat_res, np.float64)
    alpha = np.asarray(alpha, np.float64)
    lam = np.asarray(lam, np.float64)
    if satfunc_type == "van_genuchten":
        return {"sat_res": sat_res, "alpha": alpha, "vg_m": lam,
                "vg_n": 1.0 / (1.0 - lam)}
    if satfunc_type == "brooks_corey":
        return {"sat_res": sat_res, "alpha": alpha, "bc_lambda": lam}
    if satfunc_type in ("smooth_brooks_corey_bz2",
                        "smooth_brooks_corey_bz3"):
        AA = 3 if satfunc_type.endswith("bz2") else 2
        gs = 0.9          # = -alpha * ps with ps = -0.9/alpha
        lam_u, inv = np.unique(lam, return_inverse=True)
        gu_u = np.array([_find_gu_sbc_zero_coeff(float(lv), AA, gs)
                         for lv in lam_u])
        gu = gu_u[inv].reshape(lam.shape)
        ps = -0.9 / alpha
        pu = gu / (-alpha)
        bc_at_pu = gu ** (-lam)
        lam_dpu = lam * (1.0 - ps / pu)
        inv_dpu = 1.0 / (pu - ps)
        if AA == 3:       # bz2: b2 = 0 by construction
            b2 = np.zeros_like(lam)
            b3 = (2.0 - bc_at_pu * (2.0 + lam_dpu)) * inv_dpu ** 3
            if (b3 <= 0.0).any():
                raise ValueError("satparams_dyn_clm: SBC bz2 b3 <= 0")
        else:             # bz3: b3 = 0 by construction
            b2 = -(3.0 - bc_at_pu * (3.0 + lam_dpu)) * inv_dpu * inv_dpu
            b3 = np.zeros_like(lam)
            if (b2 >= 0.0).any():
                raise ValueError("satparams_dyn_clm: SBC bz3 b2 >= 0")
        return {"sat_res": sat_res, "alpha": alpha, "bc_lambda": lam,
                "sbc_ps": ps, "sbc_pu": pu, "sbc_b2": b2, "sbc_b3": b3}
    raise ValueError(f"Unknown vsfm_satfunc_type {satfunc_type}")


# --- per-model pc -> sat (value + d/dP) -------------------------------------

def _safe(pred, val):
    """Guard an operand so the inactive branch of a where cannot make NaN."""
    return torch.where(pred, val, -1.0)


def pc_to_sat_vg(params: SatParams, pc):
    """Van Genuchten (SaturationFunction.F90:747-795)."""
    unsat = pc < 0.0
    pcs = _safe(unsat, pc)
    pc_alpha_n = (-params.alpha * pcs) ** params.vg_n
    one_p = 1.0 + pc_alpha_n
    Se = one_p ** (-params.vg_m)
    sat = params.sat_res + (1.0 - params.sat_res) * Se
    AA = pc_alpha_n / one_p
    dSe_dpc = -params.vg_m * params.vg_n * Se * AA / pcs
    dsat = (1.0 - params.sat_res) * dSe_dpc
    return torch.where(unsat, sat, 1.0), torch.where(unsat, dsat, 0.0)


def pc_to_relperm_vg(params: SatParams, pc):
    """VG-Mualem relperm (SaturationFunction.F90:799-857)."""
    unsat = pc < 0.0
    pcs = _safe(unsat, pc)
    mm = params.vg_m
    pc_alpha_n = (-params.alpha * pcs) ** params.vg_n
    one_p = 1.0 + pc_alpha_n
    Se = one_p ** (-mm)
    AA = pc_alpha_n / one_p
    dSe_dpc = -mm * params.vg_n * Se * AA / pcs
    BB = 1.0 - AA ** mm
    kr = torch.sqrt(Se) * BB * BB
    dkr_dSe = (0.5 * kr / Se
               + 2.0 * Se ** (1.0 / mm - 0.5) * AA ** (mm - 1.0) * BB)
    dkr = dkr_dSe * dSe_dpc
    return torch.where(unsat, kr, 1.0), torch.where(unsat, dkr, 0.0)


def sat_to_pc_vg(params: SatParams, sat):
    """VG inverse (SaturationFunction.F90:861-896)."""
    unsat = sat < 1.0
    Se = torch.clamp_min((sat - params.sat_res) / (1.0 - params.sat_res), 0.0)
    Ses = torch.where(unsat, Se, 0.5)
    pc = (-(Ses ** (-1.0 / params.vg_m) - 1.0) ** (1.0 / params.vg_n)
          / params.alpha)
    return torch.where(unsat, pc, 0.0)


def pc_to_sat_bc(params: SatParams, pc):
    """Brooks-Corey (SaturationFunction.F90:900-938)."""
    pc_alpha = -params.alpha * pc
    unsat = pc_alpha > 1.0
    pcs = torch.where(unsat, pc, -1.0 / params.alpha * 2.0)
    Se = (-params.alpha * pcs) ** (-params.bc_lambda)
    sat = params.sat_res + (1.0 - params.sat_res) * Se
    dSe_dpc = -params.bc_lambda * Se / pcs
    dsat = (1.0 - params.sat_res) * dSe_dpc
    return torch.where(unsat, sat, 1.0), torch.where(unsat, dsat, 0.0)


def pc_to_relperm_bc(params: SatParams, pc, frac_liq):
    """BC-Mualem relperm times frac_liq (SaturationFunction.F90:942-990)."""
    lam = params.bc_lambda
    pc_alpha = -params.alpha * pc
    unsat = pc_alpha > 1.0
    pcs = torch.where(unsat, pc, -2.0 / params.alpha)
    Se = (-params.alpha * pcs) ** (-lam)
    dSe_dpc = -lam * Se / pcs
    kr = Se ** (2.5 + 2.0 / lam)
    dkr_dSe = (2.5 + 2.0 / lam) * kr / Se
    dkr = dkr_dSe * dSe_dpc
    kr = torch.where(unsat, kr, 1.0)
    dkr = torch.where(unsat, dkr, 0.0)
    return frac_liq * kr, frac_liq * dkr


def sat_to_pc_bc(params: SatParams, sat):
    """BC inverse (SaturationFunction.F90:994-1023)."""
    unsat = sat < 1.0
    Se = (sat - params.sat_res) / (1.0 - params.sat_res)
    Ses = torch.where(unsat, Se, 0.5)
    pc = -Ses ** (-1.0 / params.bc_lambda) / params.alpha
    return torch.where(unsat, pc, 0.0)


def _sbc_se(params: SatParams, pc):
    """Smoothed-BC effective saturation and its regime masks (shared by
    the saturation and relperm forms)."""
    lam = params.bc_lambda
    in_bc = pc <= params.sbc_pu
    in_cubic = torch.logical_and(~in_bc, pc < params.sbc_ps)
    pcs = torch.where(in_bc, pc, -2.0 / params.alpha)
    Se_bc = (-params.alpha * pcs) ** (-lam)
    dSe_bc = -lam * Se_bc / pcs
    d = pc - params.sbc_ps
    Se_cu = 1.0 + d * d * (params.sbc_b2 + d * params.sbc_b3)
    dSe_cu = d * (2.0 * params.sbc_b2 + 3.0 * d * params.sbc_b3)
    Se = torch.where(in_bc, Se_bc, torch.where(in_cubic, Se_cu, 1.0))
    dSe = torch.where(in_bc, dSe_bc, torch.where(in_cubic, dSe_cu, 0.0))
    return Se, dSe, in_bc | in_cubic


def pc_to_sat_sbc(params: SatParams, pc):
    """Smoothed Brooks-Corey (SaturationFunction.F90:1027-1076)."""
    Se, dSe, unsat = _sbc_se(params, pc)
    sat = torch.where(unsat, params.sat_res + (1.0 - params.sat_res) * Se,
                      1.0)
    dsat = (1.0 - params.sat_res) * dSe
    return sat, torch.where(unsat, dsat, 0.0)


def pc_to_relperm_sbc(params: SatParams, pc):
    """SBC relperm: the BC-Mualem expression in both regimes
    (SaturationFunction.F90:1080-1140)."""
    lam = params.bc_lambda
    Se, dSe, unsat = _sbc_se(params, pc)
    Ses = torch.where(unsat, Se, 1.0)
    kr = Ses ** (2.5 + 2.0 / lam)
    dkr_dSe = (2.5 + 2.0 / lam) * kr / Ses
    dkr = dkr_dSe * dSe
    return torch.where(unsat, kr, 1.0), torch.where(unsat, dkr, 0.0)


def pc_to_sat_fetch2(params: SatParams, pc):
    """FETCH2 (SaturationFunction.F90:1262-1296)."""
    unsat = pc < 0.0
    phi88, phi50 = params.fetch2_phi88, params.fetch2_phi50
    b = (phi88 - 0.24 * phi50) / (0.12 * (phi50 - phi88))
    a = phi50 * (2.0 + b)
    sat = 1.0 + pc / (b * pc - a)
    dsat = -a / (b * pc - a) ** 2.0
    return torch.where(unsat, sat, 1.0), torch.where(unsat, dsat, 0.0)


def sat_to_pc_fetch2(params: SatParams, sat):
    """FETCH2 inverse (SaturationFunction.F90:1299-1329)."""
    unsat = sat < 1.0
    phi88, phi50 = params.fetch2_phi88, params.fetch2_phi50
    b = (phi88 - 0.24 * phi50) / (0.12 * (phi50 - phi88))
    a = phi50 * (2.0 + b)
    pc = a * (sat - 1.0) / ((sat - 1.0) * b - 1.0)
    return torch.where(unsat, pc, 0.0)


def pc_to_sat_chuang(params: SatParams, pc):
    """Chuang (SaturationFunction.F90:1332-1361)."""
    unsat = pc < 0.0
    phi0, p = params.chuang_phi0, params.chuang_p
    sat = (-phi0 / (-phi0 - pc)) ** p
    dsat = p / (-phi0) * (-phi0 / (-phi0 - pc)) ** (p + 1.0)
    return torch.where(unsat, sat, 1.0), torch.where(unsat, dsat, 0.0)


def sat_to_pc_chuang(params: SatParams, sat):
    """Chuang inverse (SaturationFunction.F90:1364-1389)."""
    unsat = sat < 1.0
    sats = torch.where(unsat, sat, 0.5)
    pc = (1.0 / sats ** (1.0 / params.chuang_p) - 1.0) * (-params.chuang_phi0)
    return torch.where(unsat, pc, 0.0)


def pc_to_relperm_weibull(params: SatParams, pc):
    """Weibull relperm (SaturationFunction.F90:654-680)."""
    unsat = pc < 0.0
    pcs = _safe(unsat, pc)
    AA = (-pcs / params.w_d) ** params.w_c
    kr = torch.exp(-AA)
    dkr = -params.w_c / pcs * AA * kr
    return torch.where(unsat, kr, 1.0), torch.where(unsat, dkr, 0.0)


def pc_to_relperm_campbell(params: SatParams, pc):
    """Campbell relperm (SaturationFunction.F90:683-705)."""
    unsat = pc < params.campbell_he
    pcs = torch.where(unsat, pc, params.campbell_he - 1.0)
    kr = (-params.campbell_he / pcs) ** params.campbell_n
    dkr = -params.campbell_n * kr / pcs
    return torch.where(unsat, kr, 1.0), torch.where(unsat, dkr, 0.0)


# --- gateway dispatchers (SaturationFunction.F90:564-650,708-743) -----------

def _unit(p_, pc_):
    return torch.ones_like(pc_), torch.zeros_like(pc_)


_SAT_DISPATCH = {
    0: _unit,
    SAT_FUNC_VAN_GENUCHTEN: pc_to_sat_vg,
    SAT_FUNC_BROOKS_COREY: pc_to_sat_bc,
    SAT_FUNC_SMOOTHED_BROOKS_COREY: pc_to_sat_sbc,
    SAT_FUNC_FETCH2: pc_to_sat_fetch2,
    SAT_FUNC_CHUANG: pc_to_sat_chuang,
}

_SAT_INV_DISPATCH = {
    SAT_FUNC_VAN_GENUCHTEN: sat_to_pc_vg,
    SAT_FUNC_BROOKS_COREY: sat_to_pc_bc,
    SAT_FUNC_FETCH2: sat_to_pc_fetch2,
    SAT_FUNC_CHUANG: sat_to_pc_chuang,
}

# Benign stand-in values for lanes NOT selected by a model in the _blend
# where-chain: torch.where evaluates both branches, and zero placeholder
# parameters (m=0, d=0, ...) would make inf*0 NaNs in the masked lanes.
_SAFE_PARAMS = dict(
    sat_res=0.2, alpha=1e-4, vg_m=0.5, vg_n=2.0, bc_lambda=0.5,
    sbc_pu=-10.0, sbc_ps=-1.0, sbc_b2=0.0, sbc_b3=0.0,
    w_c=1.0, w_d=1.0, campbell_he=-1.0, campbell_n=1.0,
    fetch2_phi88=-1.0, fetch2_phi50=-2.0, chuang_phi0=-1.0, chuang_p=1.0)


def _sanitized(params: SatParams, mask) -> SatParams:
    """Params with the lanes outside ``mask`` replaced by benign values."""
    kw = {k: torch.where(mask, getattr(params, k), _SAFE_PARAMS[k])
          for k in _REAL_FIELDS}
    return SatParams(sat_func_type=params.sat_func_type,
                     relperm_func_type=params.relperm_func_type, **kw)


def _blend(types: np.ndarray, table, params: SatParams, compute, ref):
    """Evaluate each model present in the static ``types`` and blend with
    ``torch.where``.  A single-model configuration returns that model's
    values as they are (a where over an all-true mask is the identity)."""
    present = np.unique(types)
    if len(present) == 1:
        return tuple(compute(table[int(present[0])], params))
    out = None
    for code in present:
        mask = torch.as_tensor(types == code, device=ref.device)
        vals = compute(table[int(code)], _sanitized(params, mask))
        if out is None:
            out = tuple(torch.where(mask, v, 0.0) for v in vals)
        else:
            out = tuple(torch.where(mask, v, o) for v, o in zip(vals, out))
    return out


def press_to_sat(params: SatParams, press):
    """Pressure -> (saturation, dsat/dP) (SaturationFunction.F90:564-600)."""
    params = params.to(press.device, press.dtype)
    pc = press - PRESSURE_REF
    return _blend(params.sat_func_type, _SAT_DISPATCH, params,
                  lambda fn, p_: fn(p_, pc), press)


def sat_to_press(params: SatParams, sat):
    """Saturation -> pressure (SaturationFunction.F90:708-743).  The SBC
    inverse is not implemented (the JAX package has none either)."""
    params = params.to(sat.device, sat.dtype)
    (pc,) = _blend(params.sat_func_type, _SAT_INV_DISPATCH, params,
                   lambda fn, p_: (fn(p_, sat),), sat)
    return pc + PRESSURE_REF


def press_to_relperm(params: SatParams, press, frac_liq):
    """Pressure -> (kr, dkr/dP) (SaturationFunction.F90:604-650)."""
    params = params.to(press.device, press.dtype)
    frac_liq = torch.as_tensor(frac_liq, dtype=press.dtype,
                               device=press.device)
    pc = press - PRESSURE_REF
    rp_types = params.relperm_func_type
    sf_types = params.sat_func_type
    # Mualem dispatches on the saturation function
    keys = np.where(rp_types == RELPERM_FUNC_MUALEM, sf_types, rp_types)
    table = {
        0: _unit,
        SAT_FUNC_VAN_GENUCHTEN: pc_to_relperm_vg,
        SAT_FUNC_BROOKS_COREY:
            lambda p_, pc_: pc_to_relperm_bc(p_, pc_, frac_liq),
        SAT_FUNC_SMOOTHED_BROOKS_COREY: pc_to_relperm_sbc,
        RELPERM_FUNC_WEIBULL: pc_to_relperm_weibull,
        RELPERM_FUNC_CAMPBELL: pc_to_relperm_campbell,
    }
    return _blend(keys, table, params, lambda fn, p_: fn(p_, pc), press)

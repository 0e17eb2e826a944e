"""Richards equation (VSFM): GE assembly, SoE data and the MPP facade.

Counterpart of ``mpp_tpu/models/richards.py``:

* auxvar constitutive chain sat/kr/den/vis/por
  (RichardsODEPressureAuxType.F90:237-294);
* two-point Darcy flux with upwinded mobility, harmonic permeability,
  gravity term and seepage clamp, with TRUE analytic derivatives
  (RichardsMod.F90:118-340), and the conductance flux models
  (RichardsMod.F90:746-856);
* residual F = Accum(P) - Accum(P_prev) + Divergence(P) and the Jacobian
  contribution values (GoveqnRichardsODEPressureType.F90:388-421,
  1603-2200).

Host-side set-up (topology, per-cell parameters, staging setters) is numpy,
as in the JAX package.  The numeric methods are batched: the state ``P``
is ``[ncol, n]`` (one row per column), per-column dynamic inputs carry a
leading ``[ncol]`` axis, and scatters are ``index_add`` along dim 1.  The
device and dtype of every evaluation are the state's; static constants
are converted once per (device, dtype) and cached on the GE (setters clear
the cache).

Not ported: the TPU matmul-scatter lowering (``_use_matmul_scatter``,
``_scatter_mats``; a TPU backend workaround) and the serial SNES stepper of
``VSFMSoE`` (the port's stepper is ``batched/vsfm_compiled.py``).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from mpp_tpu import constants as C
from mpp_tpu.constants import (Cond, GEType, SOEType, Var, AuxVarKind,
                               FluxType, PRESSURE_REF, GRAVITY_CONSTANT,
                               FMWH2O)
from mpp_tpu.dtypes.mesh import Mesh, ConnectionSet, concat_connection_sets
from mpp_tpu.dtypes.conditions import Condition
from mpp_tpu.dtypes.mpp_base import MPPBase
from mpp_tpu_torch.ops import eos, satfunc as sf
from mpp_tpu_torch.ops.porosity import PorosityParams, porosity
from mpp_tpu_torch.ops.sparse import csr_template, CSRTemplate


def _swhere(mask, a, b):
    """``where`` over a static numpy mask: the all-true and all-false cases
    return an operand as it is (what a where over such a mask gives)."""
    mask = np.asarray(mask, bool)
    if mask.all():
        return a
    if not mask.any():
        return b
    ref = a if isinstance(a, torch.Tensor) else b
    return torch.where(torch.as_tensor(mask, device=ref.device), a, b)


def richards_aux(P, params: sf.SatParams, por_params: PorosityParams,
                 temperature, frac_liq, density_type: int):
    """RichODEPressureAuxVarCompute: (sat, dsat, kr, dkr, den, dden_dP,
    vis, dvis_dP, por, dpor_dP)."""
    sat, dsat = sf.press_to_sat(params, P)
    kr, dkr = sf.press_to_relperm(params, P, frac_liq)
    den, dden_dP, _dden_dT = eos.density(P, temperature, density_type)
    vis, dvis_dP, _ = eos.viscosity(P, temperature)
    por, dpor_dP = porosity(por_params, P)
    return sat, dsat, kr, dkr, den, dden_dP, vis, dvis_dP, por, dpor_dP


def darcy_flux(P_up, P_dn, kr_up, kr_dn, dkr_up, dkr_dn, den_up, den_dn,
               dden_up, dden_dn, vis_up, vis_dn, dvis_up, dvis_dn,
               perm_up, perm_dn, dist_up, dist_dn, area, unit_z,
               internal: bool, cond_kind=None, seepage_mask=None):
    """Vectorized RichardsFlux_Internal (RichardsMod.F90:118-340).

    Returns (flux, dflux_dP_up, dflux_dP_dn) with TRUE derivatives.
    ``cond_kind`` (static numpy codes per connection) selects the BC
    weighting; ``seepage_mask`` (static numpy) marks seepage BCs."""
    dist = dist_up + dist_dn
    mass_flux = None
    if internal:
        upweight = dist_up / dist
        Dq = (perm_up * perm_dn) / (dist_up * perm_dn + dist_dn * perm_up)
    else:
        is_dirichlet_like = np.isin(cond_kind, (int(Cond.DIRICHLET),
                                                int(Cond.MASS_FLUX),
                                                int(Cond.SEEPAGE_BC)))
        is_otr = cond_kind == int(Cond.DIRICHLET_FRM_OTR_GOVEQ)
        if not (is_dirichlet_like | is_otr).all():
            raise ValueError("RichardsFlux: unknown cond_type")
        w_int = dist_up / dist
        Dq_int = (perm_up * perm_dn) / (dist_up * perm_dn + dist_dn * perm_up)
        upweight = _swhere(is_otr, w_int, 0.0)
        Dq = _swhere(is_otr, Dq_int, perm_dn / dist)
        mass_flux = np.asarray(cond_kind == int(Cond.MASS_FLUX))

    udist_dot_ugrav = unit_z * (-GRAVITY_CONSTANT)
    dist_gravity = dist * udist_dot_ugrav
    den_ave = upweight * den_up + (1.0 - upweight) * den_dn
    gravityterm = den_ave * FMWH2O * dist_gravity
    dphi = P_up - P_dn + gravityterm

    clamp = None
    if not internal and seepage_mask is not None and seepage_mask.any():
        clamp = _swhere(seepage_mask, (dphi > 0.0) & (P_up <= PRESSURE_REF),
                        torch.zeros_like(dphi, dtype=torch.bool))
        dphi = torch.where(clamp, 0.0, dphi)

    up_wind = dphi >= 0.0
    ukvr = torch.where(up_wind, kr_up / vis_up, kr_dn / vis_dn)
    v_darcy = -Dq * ukvr * dphi
    if mass_flux is not None:
        v_darcy = _swhere(mass_flux, torch.zeros_like(v_darcy), v_darcy)
    q = v_darcy * area
    flux = q * den_ave

    # true derivatives
    dden_ave_up = upweight * dden_up
    dden_ave_dn = (1.0 - upweight) * dden_dn
    dphi_dP_up = 1.0 + upweight * dist_gravity * FMWH2O * dden_up
    dphi_dP_dn = -1.0 + (1.0 - upweight) * dist_gravity * FMWH2O * dden_dn
    if clamp is not None:
        dphi_dP_dn = torch.where(clamp, 0.0, dphi_dP_dn)
    dukvr_up = torch.where(
        up_wind, dkr_up / vis_up - kr_up / (vis_up * vis_up) * dvis_up, 0.0)
    dukvr_dn = torch.where(
        up_wind, 0.0, dkr_dn / vis_dn - kr_dn / (vis_dn * vis_dn) * dvis_dn)
    dq_up = -Dq * (dukvr_up * dphi + ukvr * dphi_dP_up) * area
    dq_dn = -Dq * (dukvr_dn * dphi + ukvr * dphi_dP_dn) * area
    dflux_up = dq_up * den_ave + q * dden_ave_up
    dflux_dn = dq_dn * den_ave + q * dden_ave_dn
    if mass_flux is not None:
        dflux_up = _swhere(mass_flux, torch.zeros_like(dflux_up), dflux_up)
        dflux_dn = _swhere(mass_flux, torch.zeros_like(dflux_dn), dflux_dn)
    return flux, dflux_up, dflux_dn


def conductance_krg(P_up, P_dn, sp_up: sf.SatParams, sp_dn: sf.SatParams,
                    cond_type, conductance, cond_up, cond_dn, upwind_weight):
    """Vectorized ``RichODEPressureConnAuxVarCompute``
    (RichardsODEPressureConnAuxType.F90:185-299): per-connection effective
    conductance krg and d(krg)/dP_up, dP_dn for the Campbell and Manoli
    models.  ``cond_type``, ``upwind_weight`` and the relperm-set masks
    are static numpy."""
    ones = torch.ones_like(P_up)
    kr_up_raw, dkr_up_raw = sf.press_to_relperm(sp_up, P_up, ones)
    kr_dn_raw, dkr_dn_raw = sf.press_to_relperm(sp_dn, P_dn, ones)
    up_set = sp_up.relperm_func_type != 0
    dn_set = sp_dn.relperm_func_type != 0
    # Campbell: upwind-weighted kr times a scalar conductance; a side with
    # no relperm function contributes kr=1 via weight collapse
    w_eff = torch.as_tensor(
        np.where(up_set & dn_set, np.asarray(upwind_weight),
                 np.where(up_set, 1.0, 0.0)),
        dtype=P_up.dtype, device=P_up.device)
    kr = w_eff * kr_up_raw + (1.0 - w_eff) * kr_dn_raw
    dkr_up = w_eff * dkr_up_raw
    dkr_dn = (1.0 - w_eff) * dkr_dn_raw
    krg_c = kr * conductance
    dkrg_c_up = dkr_up * conductance
    dkrg_c_dn = dkr_dn * conductance
    # Manoli: series combination of the two sides
    krg_up = kr_up_raw * cond_up
    krg_dn = kr_dn_raw * cond_dn
    denom = krg_up + krg_dn
    denom = torch.where(denom == 0, 1.0, denom)
    krg_m = krg_up * krg_dn / denom
    dkrg_m_up = (krg_dn / denom) ** 2.0 * dkr_up_raw * cond_up
    dkrg_m_dn = (krg_up / denom) ** 2.0 * dkr_dn_raw * cond_dn
    is_manoli = np.asarray(cond_type) == int(FluxType.CONDUCTANCE_MANOLI)
    return (_swhere(is_manoli, krg_m, krg_c),
            _swhere(is_manoli, dkrg_m_up, dkrg_c_up),
            _swhere(is_manoli, dkrg_m_dn, dkrg_c_dn))


def conductance_flux(P_up, P_dn, den_up, den_dn, dden_up, dden_dn,
                     krg, dkrg_up, dkrg_dn, area):
    """Vectorized ``RichardsFluxConductanceModel_Internal``
    (RichardsMod.F90:746-856) with TRUE derivatives:
    flux = -den_ave * krg * (P_up - P_dn) * area, upweight 0.5."""
    den_ave = 0.5 * den_up + 0.5 * den_dn
    dphi = P_up - P_dn
    flux = -den_ave * krg * dphi * area
    dflux_up = -(0.5 * dden_up * krg * dphi + den_ave * dkrg_up * dphi
                 + den_ave * krg) * area
    dflux_dn = -(0.5 * dden_dn * krg * dphi + den_ave * dkrg_dn * dphi
                 - den_ave * krg) * area
    return flux, dflux_up, dflux_dn


@dataclasses.dataclass
class ConnAuxVars:
    """SoA of ``rich_ode_pres_conn_auxvar_type`` static configuration."""
    flux_type: np.ndarray        # DARCY / CONDUCTANCE
    cond_type: np.ndarray        # CAMPBELL / MANOLI
    conductance: np.ndarray
    conductance_up: np.ndarray
    conductance_dn: np.ndarray
    upwind_weight: np.ndarray
    sp_up: sf.SatParams
    sp_dn: sf.SatParams

    @staticmethod
    def create(n: int) -> "ConnAuxVars":
        return ConnAuxVars(
            flux_type=np.full(n, int(FluxType.DARCY), np.int32),
            cond_type=np.full(n, int(FluxType.CONDUCTANCE_CAMPBELL), np.int32),
            conductance=np.zeros(n), conductance_up=np.zeros(n),
            conductance_dn=np.zeros(n), upwind_weight=np.zeros(n),
            sp_up=sf.SatParams.zeros(n), sp_dn=sf.SatParams.zeros(n))

    @property
    def any_conductance(self) -> bool:
        return bool((self.flux_type == int(FluxType.CONDUCTANCE)).any())


def _ss_factors(P_ss, ss_value, Pc, nn, ss_code):
    """Downregulated mass-rate sinks (Campbell / FETCH2 down-regulation of
    COND_MASS_RATE): (contribution to F with the sink sign, d/dP)."""
    is_camp = np.asarray(ss_code == int(Cond.DOWNREG_MASS_RATE_CAMPBELL))
    is_fetch = np.asarray(ss_code == int(Cond.DOWNREG_MASS_RATE_FETCH2))
    val = ss_value / FMWH2O
    if not (is_camp | is_fetch).any():
        # plain mass rates: no pressure dependence
        return val, torch.zeros_like(val)
    dP = P_ss - PRESSURE_REF
    dP_neg = dP <= 0.0
    dP_safe = torch.where(dP_neg, dP, -1.0)
    ratio = _swhere(is_camp | is_fetch, dP_safe / Pc, torch.ones_like(dP))
    pw = ratio ** nn
    f_camp_r = torch.where(dP_neg, 1.0 + pw, 1.0)
    f_fetch_r = torch.where(dP_neg, torch.exp(-pw), 1.0)
    contrib = _swhere(is_camp, val / f_camp_r,
                      _swhere(is_fetch, val * f_fetch_r, val))
    f_camp = 1.0 + pw
    f_fetch = torch.exp(-pw)
    v_camp = val * (nn * pw) / (dP_safe * f_camp ** 2.0)
    v_fetch = val * (nn * pw) * f_fetch / dP_safe
    zero = torch.zeros_like(val)
    ss_vals = _swhere(is_camp, torch.where(dP_neg, v_camp, zero),
                      _swhere(is_fetch, torch.where(dP_neg, v_fetch, zero),
                              zero))
    return contrib, ss_vals


@dataclasses.dataclass
class RichardsGE:
    """GE_RE: Richards equation over one mesh."""
    name: str
    mesh: Mesh
    itype: int = int(GEType.RE)
    dof: int = 1
    boundary_conditions: List[Condition] = dataclasses.field(default_factory=list)
    source_sinks: List[Condition] = dataclasses.field(default_factory=list)

    # static per-cell parameters
    sat_params: sf.SatParams = None
    por_params: PorosityParams = None
    perm: np.ndarray = None               # [n,3]
    # auxvar-init default is DENSITY_CONSTANT (RichODEPressureAuxVarInit:120)
    density_type: int = eos.DENSITY_CONSTANT
    # BC/SS auxvar parameter copies (VSFMMPPSetSoilsCLM:422-471)
    bc_sat_params: sf.SatParams = None
    bc_por_params: PorosityParams = None
    bc_perm: np.ndarray = None
    ss_sat_params: sf.SatParams = None
    ss_pot_sink_pressure: np.ndarray = None
    ss_pot_sink_exponent: np.ndarray = None
    # connection auxvars (flux-model selection per connection)
    conn_in: ConnAuxVars = None
    conn_bc: ConnAuxVars = None

    # staged state (numpy, one column)
    temperature: np.ndarray = None
    frac_liq_sat: np.ndarray = None
    pressure: np.ndarray = None
    pressure_prev: np.ndarray = None
    bc_value: np.ndarray = None           # condition values per bc conn
    bc_temperature: np.ndarray = None
    ss_value: np.ndarray = None           # mass rates per ss conn
    accum_prev: np.ndarray = None

    # constants converted per (key, device, dtype); setters clear it
    _tc: dict = dataclasses.field(default_factory=dict, repr=False,
                                  compare=False)

    def allocate_auxvars(self):
        n = self.mesh.ncells_all
        self.sat_params = sf.SatParams.zeros(n)
        self.por_params = PorosityParams.constant(np.zeros(n))
        self.perm = np.zeros((n, 3))
        self.temperature = np.full(n, 273.15 + 25.0)
        self.frac_liq_sat = np.ones(n)
        self.pressure = np.zeros(n)
        self.pressure_prev = np.full(n, 3.5355e3)
        nbc = sum(c.num_connections for c in self.boundary_conditions)
        self.bc_sat_params = sf.SatParams.zeros(nbc)
        self.bc_por_params = PorosityParams.constant(np.zeros(nbc))
        self.bc_perm = np.zeros((nbc, 3))
        self.bc_value = np.zeros(nbc)
        self.bc_temperature = np.full(nbc, 273.15 + 25.0)
        nss = sum(c.num_connections for c in self.source_sinks)
        self.ss_sat_params = sf.SatParams.zeros(nss)
        self.ss_pot_sink_pressure = np.zeros(nss)
        self.ss_pot_sink_exponent = np.zeros(nss)
        self.ss_value = np.zeros(nss)
        self.accum_prev = np.zeros(self.mesh.ncells_local)
        self.conn_in = ConnAuxVars.create(self._internal().num_connections)
        self.conn_bc = ConnAuxVars.create(nbc)
        self.invalidate()

    # ---- constant cache ----------------------------------------------------
    def invalidate(self):
        """Drop the converted constants (after changing set-up arrays in
        place outside the setters)."""
        self._tc.clear()

    def _const(self, key, ref, build, kind="f"):
        """``build()`` (numpy) as a tensor on ``ref``'s device: floats in
        ``ref``'s dtype, ``kind`` "i" as int64 indices, "b" as bool."""
        dt = {"f": ref.dtype, "i": torch.long, "b": torch.bool}[kind]
        k = (key, str(ref.device), dt)
        v = self._tc.get(k)
        if v is None:
            v = torch.as_tensor(np.asarray(build()), dtype=dt,
                                device=ref.device)
            self._tc[k] = v
        return v

    def _const_obj(self, key, ref, build):
        k = (key, str(ref.device), ref.dtype)
        v = self._tc.get(k)
        if v is None:
            v = build()
            self._tc[k] = v
        return v

    def _staged(self, name, ref):
        """A staged numpy attribute (temperature, ...) as a tensor; keyed
        by the array's identity, so reassigning the attribute is seen."""
        arr = getattr(self, name)
        return self._const((name, id(arr)), ref, lambda: arr)

    # ---- static topology ---------------------------------------------------
    def _internal(self) -> ConnectionSet:
        cs = concat_connection_sets(self.mesh.intrn_conn_sets)
        if cs.unit_vec is None:
            # unit vector from centroid difference (MeshType.F90:932-938)
            dx = self.mesh.xc[cs.id_dn] - self.mesh.xc[cs.id_up]
            dy = self.mesh.yc[cs.id_dn] - self.mesh.yc[cs.id_up]
            dz = self.mesh.zc[cs.id_dn] - self.mesh.zc[cs.id_up]
            dist = np.sqrt(dx ** 2 + dy ** 2 + dz ** 2)
            # coincident centroids (conductance-type connections in SPAC
            # networks) get a zero unit vector: no gravity contribution
            safe = np.where(dist > 0.0, dist, 1.0)
            cs.unit_vec = np.where(
                dist[:, None] > 0.0,
                np.stack([dx / safe, dy / safe, dz / safe], axis=1), 0.0)
        return cs

    def _bc_concat(self):
        ids, dup, ddn, ar, uvz, code = [], [], [], [], [], []
        for cond in self.boundary_conditions:
            cset = cond.conn_set
            ids.append(cset.id_dn)
            dup.append(cset.dist_up)
            ddn.append(cset.dist_dn)
            ar.append(cset.area)
            uvz.append(cset.unit_vec[:, 2] if cset.unit_vec is not None
                       else np.zeros(cset.num_connections))
            code.append(np.full(cset.num_connections, cond.itype, np.int32))
        if not ids:
            z = np.zeros(0)
            return (z.astype(np.int32), z, z, z, z, z.astype(np.int32))
        return (np.concatenate(ids).astype(np.int32), np.concatenate(dup),
                np.concatenate(ddn), np.concatenate(ar), np.concatenate(uvz),
                np.concatenate(code))

    def _ss_concat(self):
        ids, code = [], []
        for cond in self.source_sinks:
            ids.append(cond.conn_set.id_dn)
            code.append(np.full(cond.conn_set.num_connections, cond.itype,
                                np.int32))
        if not ids:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        return np.concatenate(ids).astype(np.int32), np.concatenate(code)

    def _bc_unit_vecs(self):
        """Concatenated [nbc, 3] BC-connection unit vectors."""
        out = []
        for cond in self.boundary_conditions:
            cs = cond.conn_set
            out.append(cs.unit_vec if cs.unit_vec is not None
                       else np.zeros((cs.num_connections, 3)))
        return np.concatenate(out) if out else np.zeros((0, 3))

    def _bc_perms(self):
        """Directional permeabilities on BC connections: BC auxvar side and
        adjacent-cell side (|unit| . perm)."""
        bc_ids = self._bc_concat()[0]
        perm_b = np.zeros(bc_ids.size)
        perm_cell = np.zeros(bc_ids.size)
        off = 0
        for cond in self.boundary_conditions:
            cs = cond.conn_set
            m = cs.num_connections
            uv = (cs.unit_vec if cs.unit_vec is not None
                  else np.zeros((m, 3)))
            cid = cs.id_dn
            perm_b[off:off + m] = (
                np.abs(uv[:, 0]) * self.bc_perm[off:off + m, 0]
                + np.abs(uv[:, 1]) * self.bc_perm[off:off + m, 1]
                + np.abs(uv[:, 2]) * self.bc_perm[off:off + m, 2])
            perm_cell[off:off + m] = (
                np.abs(uv[:, 0]) * self.perm[cid, 0]
                + np.abs(uv[:, 1]) * self.perm[cid, 1]
                + np.abs(uv[:, 2]) * self.perm[cid, 2])
            off += m
        return perm_b, perm_cell

    def coo_coords(self, row_off=0, col_off=0):
        """A-contribution coordinates: internal 4/conn, bc diag, ss diag,
        accum diag."""
        n = self.mesh.ncells_local
        ic = self._internal()
        bc_ids = self._bc_concat()[0]
        ss_ids = self._ss_concat()[0]
        rows = [ic.id_up, ic.id_up, ic.id_dn, ic.id_dn, bc_ids, ss_ids,
                np.arange(n)]
        cols = [ic.id_up, ic.id_dn, ic.id_up, ic.id_dn, bc_ids, ss_ids,
                np.arange(n)]
        return (np.concatenate(rows) + row_off, np.concatenate(cols) + col_off)

    def _bc_swap_mask(self):
        """Per-BC-connection swap_order flags (set by the coupling rewiring,
        SystemOfEquationsVSFMType.F90:1349-1354)."""
        out = []
        for cond in self.boundary_conditions:
            out.append(np.full(cond.num_connections, bool(cond.swap_order)))
        return np.concatenate(out) if out else np.zeros(0, bool)

    def coupled_bc_slices(self):
        """[(cond, bc_offset, other_geq_index_0based, coupled_cells)] for
        COND_DIRICHLET_FRM_OTR_GOVEQ conditions."""
        out = []
        off = 0
        for cond in self.boundary_conditions:
            if cond.itype == int(Cond.DIRICHLET_FRM_OTR_GOVEQ):
                out.append((cond, off, cond.rank_of_other_goveqs[0] - 1,
                            np.asarray(cond.coupled_cells, np.int64)))
            off += cond.num_connections
        return out

    def coupling_coords(self, row_off, col_offs):
        """Off-diagonal Jacobian coordinates for coupled BCs
        (GoveqnRichardsODEPressureType.F90:2203-2330): row = own cell,
        col = coupled GE's cell."""
        rows, cols = [], []
        for cond, off, other, cells in self.coupled_bc_slices():
            rows.append(cond.conn_set.id_dn.astype(np.int64) + row_off)
            cols.append(cells + col_offs[other])
        if not rows:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(rows), np.concatenate(cols)

    # ---- batched aux + assembly -------------------------------------------
    # P is [ncol, n].  ``dyn`` (optional dict) promotes constitutive
    # parameters to per-column inputs with a leading [ncol] axis — the
    # heterogeneous-soil contract of the ALM path
    # (MPPVSFMALM_Initialize.F90:986-992).  Keys (all optional):
    #   "sat"          dict of SatParams real-field overrides [ncol, n]
    #   "por_base"     porosity base [ncol, n]
    #   "perm"         permeability [ncol, n, 3]
    #   "temperature"  [ncol, n]      "frac_liq" [ncol, n]
    #   "vol"          cell volume [ncol, n]
    #   "in_dist_up"/"in_dist_dn"/"in_area"   internal-conn geometry
    #   "bc_dist_up"/"bc_dist_dn"/"bc_area"   BC-conn geometry
    #   "bc_temperature"                      BC auxvar temperature
    # BC-side parameters are gathered from the adjacent cell's dynamic
    # values (VSFMMPPSetSoilsCLM:422-471); coupled-GE parameter swaps are
    # not supported with dyn (the compiled stepper rejects that).
    def _dyn_cell_params(self, dyn, ref):
        sp = self._const_obj("sat", ref, lambda: self.sat_params.to(
            ref.device, ref.dtype))
        pp = self._const_obj("por", ref, lambda: self.por_params.to(
            ref.device, ref.dtype))
        if dyn and "sat" in dyn:
            sp = dataclasses.replace(sp, **dyn["sat"])
        if dyn and "por_base" in dyn:
            pp = dataclasses.replace(pp, porosity_base=dyn["por_base"])
        temp = (dyn["temperature"] if dyn and "temperature" in dyn
                else self._staged("temperature", ref))
        fl = (dyn["frac_liq"] if dyn and "frac_liq" in dyn
              else self._staged("frac_liq_sat", ref))
        return sp, pp, temp, fl

    def _dyn_bc_params(self, dyn, ref):
        """BC-side constitutive params: adjacent-cell dynamic values."""
        bids = self._const("bc_ids", ref, lambda: self._bc_concat()[0], "i")
        sp = self._const_obj("bc_sat", ref, lambda: self.bc_sat_params.to(
            ref.device, ref.dtype))
        pp = self._const_obj("bc_por", ref, lambda: self.bc_por_params.to(
            ref.device, ref.dtype))
        if dyn and "sat" in dyn:
            sp = dataclasses.replace(
                sp, **{k: v[:, bids] for k, v in dyn["sat"].items()})
        if dyn and "por_base" in dyn:
            pp = dataclasses.replace(pp,
                                     porosity_base=dyn["por_base"][:, bids])
        if dyn and "bc_temperature" in dyn:
            # TH exchange contract: internal auxvars take the energy GE's
            # dynamic T while BC auxvars keep the driver-set value
            temp = dyn["bc_temperature"]
        elif dyn and "temperature" in dyn:
            temp = dyn["temperature"][:, bids]
        else:
            temp = self._staged("bc_temperature", ref)
        return sp, pp, temp

    def _cell_aux(self, P, dyn=None):
        sp, pp, temp, fl = self._dyn_cell_params(dyn, P)
        return richards_aux(P, sp, pp, temp, fl, self.density_type)

    def _vol(self, P, dyn):
        if dyn and "vol" in dyn:
            return dyn["vol"]
        return self._const("vol", P, lambda: self.mesh.vol)

    def _active(self):
        return np.asarray(self.mesh.is_active, bool)

    def _bc_aux_pressure(self, P, bc_value=None):
        """UpdateAuxVarsBC: Dirichlet/seepage take the condition value;
        mass rate/flux mirror the internal cell; coupled BCs take the
        other GE's pressure, staged into ``bc_value``
        (GoveqnRichardsODEPressureType.F90:1508-1550)."""
        if bc_value is None:
            bc_value = torch.as_tensor(self.bc_value, dtype=P.dtype,
                                       device=P.device).expand(
                                           P.shape[0], -1)
        bc_ids, _, _, _, _, code = self._bc_concat()
        takes_value = np.isin(code, (int(Cond.DIRICHLET),
                                     int(Cond.SEEPAGE_BC),
                                     int(Cond.DIRICHLET_FRM_OTR_GOVEQ)))
        bids = self._const("bc_ids", P, lambda: bc_ids, "i")
        return _swhere(takes_value, bc_value, P[:, bids])

    def accum(self, P, dyn=None):
        """por*den*sat*vol — without dt: the caller divides."""
        sat, _, _, _, den, _, _, _, por, _ = self._cell_aux(P, dyn)
        return por * den * sat * self._vol(P, dyn)

    def _internal_fluxes(self, P, aux, dyn=None):
        """(ic, flux, dflux_up, dflux_dn) over internal connections,
        blending the Darcy and conductance flux models by the static
        per-connection type."""
        (sat, dsat, kr, dkr, den, dden, vis, dvis, por, dpor) = aux
        ic = self._internal()
        iu = self._const("in_up", P, lambda: ic.id_up, "i")
        idn = self._const("in_dn", P, lambda: ic.id_dn, "i")
        if dyn and "perm" in dyn:
            uva = self._const("in_uva", P, lambda: np.abs(ic.unit_vec))
            pv = dyn["perm"]
            perm_up = (uva[:, 0] * pv[:, iu, 0] + uva[:, 1] * pv[:, iu, 1]
                       + uva[:, 2] * pv[:, iu, 2])
            perm_dn = (uva[:, 0] * pv[:, idn, 0] + uva[:, 1] * pv[:, idn, 1]
                       + uva[:, 2] * pv[:, idn, 2])
        else:
            perm_up = self._const("in_perm_up", P, lambda: (
                np.abs(ic.unit_vec[:, 0]) * self.perm[ic.id_up, 0]
                + np.abs(ic.unit_vec[:, 1]) * self.perm[ic.id_up, 1]
                + np.abs(ic.unit_vec[:, 2]) * self.perm[ic.id_up, 2]))
            perm_dn = self._const("in_perm_dn", P, lambda: (
                np.abs(ic.unit_vec[:, 0]) * self.perm[ic.id_dn, 0]
                + np.abs(ic.unit_vec[:, 1]) * self.perm[ic.id_dn, 1]
                + np.abs(ic.unit_vec[:, 2]) * self.perm[ic.id_dn, 2]))
        d_up = (dyn["in_dist_up"] if dyn and "in_dist_up" in dyn
                else self._const("in_dist_up", P, lambda: ic.dist_up))
        d_dn = (dyn["in_dist_dn"] if dyn and "in_dist_dn" in dyn
                else self._const("in_dist_dn", P, lambda: ic.dist_dn))
        ar = (dyn["in_area"] if dyn and "in_area" in dyn
              else self._const("in_area", P, lambda: ic.area))
        uz = self._const("in_uz", P, lambda: ic.unit_vec[:, 2])
        flux, dfu, dfd = darcy_flux(
            P[:, iu], P[:, idn], kr[:, iu], kr[:, idn], dkr[:, iu],
            dkr[:, idn], den[:, iu], den[:, idn], dden[:, iu], dden[:, idn],
            vis[:, iu], vis[:, idn], dvis[:, iu], dvis[:, idn],
            perm_up, perm_dn, d_up, d_dn, ar, uz, internal=True)
        ca = self.conn_in
        if ca is not None and ca.any_conductance:
            krg, dkrg_up, dkrg_dn = conductance_krg(
                P[:, iu], P[:, idn], ca.sp_up, ca.sp_dn, ca.cond_type,
                self._const("in_cond", P, lambda: ca.conductance),
                self._const("in_cond_up", P, lambda: ca.conductance_up),
                self._const("in_cond_dn", P, lambda: ca.conductance_dn),
                ca.upwind_weight)
            cflux, cdfu, cdfd = conductance_flux(
                P[:, iu], P[:, idn], den[:, iu], den[:, idn], dden[:, iu],
                dden[:, idn], krg, dkrg_up, dkrg_dn, ar)
            is_cond = ca.flux_type == int(FluxType.CONDUCTANCE)
            flux = _swhere(is_cond, cflux, flux)
            dfu = _swhere(is_cond, cdfu, dfu)
            dfd = _swhere(is_cond, cdfd, dfd)
        return ic, flux, dfu, dfd

    def _bc_fluxes(self, P, aux, bc_value=None, dyn=None):
        """(bc cell ids, flux, dflux_dn, dflux_up) over BC connections.

        ``swap_order`` connections (coupled-GE BCs on the higher-rank side)
        reproduce the reference's argument swap (RichardsMod.F90:96-113,
        707-742); the swapped Darcy evaluation also flips unit_z so the
        gravity term follows the exchanged orientation (the mass-conserving
        fix of KNOWN_GAPS #8)."""
        (sat, dsat, kr, dkr, den, dden, vis, dvis, por, dpor) = aux
        bc_ids, bdup, bddn, barea, buvz, bcode = self._bc_concat()
        if not bc_ids.size:
            z = P.new_zeros((P.shape[0], 0))
            return bc_ids, z, z, z
        bids = self._const("bc_ids", P, lambda: bc_ids, "i")
        P_bc = self._bc_aux_pressure(P, bc_value)
        sp_b, pp_b, temp_b = self._dyn_bc_params(dyn, P)
        (sat_b, dsat_b, kr_b, dkr_b, den_b, dden_b, vis_b, dvis_b,
         por_b, dpor_b) = richards_aux(P_bc, sp_b, pp_b, temp_b,
                                       torch.ones_like(P_bc),
                                       self.density_type)
        if dyn and "perm" in dyn:
            # directional perm on both sides from the adjacent cell's
            # dynamic values (BC auxvars inherit the cell's parameters)
            uva = self._const("bc_uva", P,
                              lambda: np.abs(self._bc_unit_vecs()))
            pv = dyn["perm"]
            perm_cell = (uva[:, 0] * pv[:, bids, 0]
                         + uva[:, 1] * pv[:, bids, 1]
                         + uva[:, 2] * pv[:, bids, 2])
            perm_b = perm_cell
        else:
            perm_b = self._const("bc_perm_b", P, lambda: self._bc_perms()[0])
            perm_cell = self._const("bc_perm_cell", P,
                                    lambda: self._bc_perms()[1])
        bdup_e = (dyn["bc_dist_up"] if dyn and "bc_dist_up" in dyn
                  else self._const("bc_dist_up", P, lambda: bdup))
        bddn_e = (dyn["bc_dist_dn"] if dyn and "bc_dist_dn" in dyn
                  else self._const("bc_dist_dn", P, lambda: bddn))
        barea_e = (dyn["bc_area"] if dyn and "bc_area" in dyn
                   else self._const("bc_area", P, lambda: barea))
        buz = self._const("bc_uz", P, lambda: buvz)
        seep = bcode == int(Cond.SEEPAGE_BC)
        Pc_ = P[:, bids]
        flux, _dfu, dfd = darcy_flux(
            P_bc, Pc_, kr_b, kr[:, bids], dkr_b, dkr[:, bids], den_b,
            den[:, bids], dden_b, dden[:, bids], vis_b, vis[:, bids],
            dvis_b, dvis[:, bids], perm_b, perm_cell,
            bdup_e, bddn_e, barea_e, buz, internal=False, cond_kind=bcode,
            seepage_mask=seep)
        # Darcy-coupled BCs: the up-side pressure is the partner GE's
        # unknown, so dflux/dP_up is a live off-diagonal entry; for true
        # Dirichlet data it is zero
        is_otr = np.asarray(bcode == int(Cond.DIRICHLET_FRM_OTR_GOVEQ))
        dfu = _swhere(is_otr, _dfu, torch.zeros_like(_dfu))
        swap_np = self._bc_swap_mask() & is_otr
        if swap_np.any():
            flux2, dfu2, dfd2 = darcy_flux(
                Pc_, P_bc, kr[:, bids], kr_b, dkr[:, bids], dkr_b,
                den[:, bids], den_b, dden[:, bids], dden_b, vis[:, bids],
                vis_b, dvis[:, bids], dvis_b, perm_cell, perm_b,
                bdup_e, bddn_e, barea_e, -buz, internal=False,
                cond_kind=bcode, seepage_mask=seep)
            flux = _swhere(swap_np, -flux2, flux)
            dfd = _swhere(swap_np, -dfu2, dfd)
            dfu = _swhere(swap_np, -dfd2, dfu)
        ca = self.conn_bc
        if ca is not None and ca.any_conductance:
            krg, dkrg_up, dkrg_dn = conductance_krg(
                P_bc, Pc_, ca.sp_up, ca.sp_dn, ca.cond_type,
                self._const("bc_cond", P, lambda: ca.conductance),
                self._const("bc_cond_up", P, lambda: ca.conductance_up),
                self._const("bc_cond_dn", P, lambda: ca.conductance_dn),
                ca.upwind_weight)
            swap = self._bc_swap_mask()
            dkrg_up_eff = _swhere(swap, dkrg_dn, dkrg_up)
            dkrg_dn_eff = _swhere(swap, dkrg_up, dkrg_dn)
            cflux, cdfu, cdfd = conductance_flux(
                P_bc, Pc_, den_b, den[:, bids], dden_b, dden[:, bids],
                krg, dkrg_up_eff, dkrg_dn_eff, barea_e)
            is_cond = ca.flux_type == int(FluxType.CONDUCTANCE)
            flux = _swhere(is_cond, cflux, flux)
            dfd = _swhere(is_cond, cdfd, dfd)
            dfu = _swhere(is_cond, cdfu, dfu)
        return bc_ids, flux, dfd, dfu

    def _ss_terms(self, P, ss_value):
        ss_ids, ss_code = self._ss_concat()
        sids = self._const("ss_ids", P, lambda: ss_ids, "i")
        Pc = self._const("ss_pc", P, lambda: self.ss_pot_sink_pressure)
        nn = self._const("ss_nn", P, lambda: self.ss_pot_sink_exponent)
        contrib, ss_vals = _ss_factors(P[:, sids], ss_value, Pc, nn, ss_code)
        return sids, contrib, ss_vals

    def _defaults(self, P, ss_value, accum_prev):
        ncol = P.shape[0]
        if ss_value is None:
            ss_value = torch.as_tensor(self.ss_value, dtype=P.dtype,
                                       device=P.device).expand(ncol, -1)
        if accum_prev is None:
            accum_prev = torch.as_tensor(self.accum_prev, dtype=P.dtype,
                                         device=P.device).expand(ncol, -1)
        return ss_value, accum_prev

    def _eval(self, P, dt, bc_value, ss_value, accum_prev, dyn, want_F,
              want_J):
        """Shared body of residual / jacobian_values /
        residual_and_jac_values (one constitutive evaluation)."""
        ss_value, accum_prev = self._defaults(P, ss_value, accum_prev)
        n = self.mesh.ncells_local
        active = self._active()
        aux = self._cell_aux(P, dyn)
        (sat, dsat, kr, dkr, den, dden, vis, dvis, por, dpor) = aux
        vol = self._vol(P, dyn)
        F = vals = None
        if want_F:
            F = _swhere(active, por * den * sat * vol / dt,
                        torch.zeros_like(P)) - accum_prev

        ic, flux, dfu, dfd = self._internal_fluxes(P, aux, dyn)
        iu = self._const("in_up", P, lambda: ic.id_up, "i")
        idn = self._const("in_dn", P, lambda: ic.id_dn, "i")
        both = active[ic.id_up] & active[ic.id_dn]
        if want_F:
            flux = _swhere(both, flux, torch.zeros_like(flux))
            F = F.index_add(1, iu, -flux).index_add(1, idn, flux)
        if want_J:
            dfu = _swhere(both, dfu, torch.zeros_like(dfu))
            dfd = _swhere(both, dfd, torch.zeros_like(dfd))
            parts = [-dfu, -dfd, dfu, dfd]

        bc_ids, flux_b, dfd_b, dfu_b = self._bc_fluxes(P, aux, bc_value, dyn)
        if bc_ids.size:
            bids = self._const("bc_ids", P, lambda: bc_ids, "i")
            act_b = active[bc_ids]
            if want_F:
                F = F.index_add(1, bids, _swhere(act_b, flux_b,
                                                 torch.zeros_like(flux_b)))
            if want_J:
                parts.append(_swhere(act_b, dfd_b, torch.zeros_like(dfd_b)))

        ss_ids, _ = self._ss_concat()
        if ss_ids.size:
            sids, contrib, ss_vals = self._ss_terms(P, ss_value)
            if want_F:
                F = F.index_add(1, sids, -contrib)
            if want_J:
                parts.append(ss_vals)

        if want_J:
            accum_deriv = ((dpor * den * sat + por * dden * sat
                            + por * den * dsat) * vol / dt)[:, :n]
            parts.append(_swhere(active[:n], accum_deriv,
                                 torch.ones_like(accum_deriv)))
            # off-diagonal coupling tail: J[c, other] += dflux_dP_up for
            # COND_DIRICHLET_FRM_OTR_GOVEQ conns (order of coupling_coords)
            for cond, off, other, cells in self.coupled_bc_slices():
                parts.append(dfu_b[:, off:off + cond.num_connections])
            vals = torch.cat(parts, dim=1)
        return F, vals

    def residual(self, P, dt, bc_value=None, ss_value=None, accum_prev=None,
                 dyn=None):
        """F [ncol, ncells_local]."""
        return self._eval(P, dt, bc_value, ss_value, accum_prev, dyn,
                          True, False)[0]

    def jacobian_values(self, P, dt, bc_value=None, ss_value=None, dyn=None):
        """A-contribution values [ncol, ncoo] in coo_coords order (then the
        coupling tail)."""
        return self._eval(P, dt, bc_value, ss_value, None, dyn,
                          False, True)[1]

    def residual_and_jac_values(self, P, dt, bc_value=None, ss_value=None,
                                accum_prev=None, dyn=None):
        """(F, jacobian values) from ONE constitutive/flux evaluation; the
        same math as the two separate calls."""
        return self._eval(P, dt, bc_value, ss_value, accum_prev, dyn,
                          True, True)

    # ---- staging (VSFMMPPSetSoilsCLM) -------------------------------------
    def set_soils(self, filter_vsfmc, watsat, hksat, bsw, sucsat,
                  residual_sat, satfunc_type: str, density_type: int,
                  grav=C.GRAV_CLM, denh2o=C.DENH2O):
        vish2o = 0.001002
        watsat = np.asarray(watsat)
        ncol, nlev = watsat.shape
        self.density_type = density_type
        first = int(np.nonzero(np.asarray(filter_vsfmc) == 1)[0][0])
        for c in range(ncol):
            src = c if filter_vsfmc[c] == 1 else first
            for j in range(nlev):
                icell = c * nlev + j
                perm = hksat[src, j] * vish2o / (denh2o * grav) * 0.001
                alpha = 1.0 / (sucsat[src, j] * grav)
                lam = 1.0 / bsw[src, j]
                sat_res = residual_sat[src, j]
                self.perm[icell, :] = perm
                self.por_params.porosity_base[icell] = watsat[src, j]
                if satfunc_type == "brooks_corey":
                    self.sat_params.set_bc(icell, sat_res, alpha, lam)
                elif satfunc_type == "smooth_brooks_corey_bz2":
                    self.sat_params.set_sbc_bz2(icell, sat_res, alpha, lam,
                                                -0.9 / alpha)
                elif satfunc_type == "smooth_brooks_corey_bz3":
                    self.sat_params.set_sbc_bz3(icell, sat_res, alpha, lam,
                                                -0.9 / alpha)
                elif satfunc_type == "van_genuchten":
                    self.sat_params.set_vg(icell, sat_res, alpha, lam)
                else:
                    raise ValueError(f"Unknown satfunc {satfunc_type}")
        self._copy_params_to_bc_ss()

    def set_soil_permeability(self, perm_x, perm_y, perm_z):
        """RichardsODESetSoilPermeability incl. BC/SS auxvar copies."""
        n = len(np.asarray(perm_x))
        self.perm[:n, 0] = perm_x
        self.perm[:n, 1] = perm_y
        self.perm[:n, 2] = perm_z
        self.bc_perm[:] = self.perm[self._bc_concat()[0]]
        self.invalidate()

    def set_soil_porosity(self, por):
        """RichardsODEPressureAuxVarSetPorosity incl. BC/SS copies."""
        self.por_params.porosity_base[:self.mesh.ncells_all] = por
        bc_ids = self._bc_concat()[0]
        self.bc_por_params.porosity_base[:] = \
            self.por_params.porosity_base[bc_ids]
        self.invalidate()

    def set_saturation_function(self, satfunc_type, alpha, lam, sat_res):
        """RichardsODEPressureAuxVarSetSatFunc + SetSatFunc dispatch
        (SaturationFunction.F90:1392-1428), with BC/SS auxvar copies."""
        for icell in range(len(np.asarray(alpha))):
            t = int(np.asarray(satfunc_type)[icell]) \
                if np.ndim(satfunc_type) else int(satfunc_type)
            a, l_, s = (float(np.asarray(alpha)[icell]),
                        float(np.asarray(lam)[icell]),
                        float(np.asarray(sat_res)[icell]))
            if t == sf.SAT_FUNC_BROOKS_COREY:
                self.sat_params.set_bc(icell, s, a, l_)
            elif t == sf.SAT_FUNC_SMOOTHED_BROOKS_COREY_BZ2:
                self.sat_params.set_sbc_bz2(icell, s, a, l_, -0.9 / a)
            elif t == sf.SAT_FUNC_SMOOTHED_BROOKS_COREY_BZ3:
                self.sat_params.set_sbc_bz3(icell, s, a, l_, -0.9 / a)
            elif t == sf.SAT_FUNC_VAN_GENUCHTEN:
                self.sat_params.set_vg(icell, s, a, l_)
            elif t == sf.SAT_FUNC_FETCH2:
                self.sat_params.set_fetch2(icell, a, l_)
            elif t == sf.SAT_FUNC_CHUANG:
                self.sat_params.set_chuang(icell, a, l_)
            else:
                raise ValueError(f"Unknown satfunc type {t}")
        self._copy_params_to_bc_ss()

    def set_relative_permeability(self, relperm_type, p1, p2):
        """VSFMMPPSetRelativePermeability (MultiPhysicsProbVSFM.F90:
        1216-1300), with BC/SS auxvar copies."""
        relperm_type = np.asarray(relperm_type)
        for icell in range(relperm_type.size):
            t = int(relperm_type[icell])
            if t <= 0:
                continue
            if t == sf.RELPERM_FUNC_WEIBULL:
                self.sat_params.set_weibull_relperm(icell, p1[icell],
                                                    p2[icell])
            elif t == sf.RELPERM_FUNC_CAMPBELL:
                self.sat_params.set_campbell_relperm(icell, p1[icell],
                                                     p2[icell])
            elif t == sf.RELPERM_FUNC_MUALEM:
                self.sat_params.relperm_func_type[icell] = t
            else:
                raise ValueError(t)
        self._copy_params_to_bc_ss()

    def set_ss_auxvar(self, var_type, values):
        """VSFMMPPSetSourceSinkAuxVarRealValue
        (MultiPhysicsProbVSFM.F90:1437-1520)."""
        if var_type == Var.POT_MASS_SINK_PRESSURE:
            self.ss_pot_sink_pressure[:] = values
        elif var_type == Var.POT_MASS_SINK_EXPONENT:
            self.ss_pot_sink_exponent[:] = values
        else:
            raise NotImplementedError(var_type)
        self.invalidate()

    def _conn_aux(self, kind) -> ConnAuxVars:
        return self.conn_in if kind == AuxVarKind.CONN_INTERNAL else self.conn_bc

    def set_conn_int_value(self, kind, var_type, values):
        """VSFMMPPSetAuxVarConnIntValue."""
        ca = self._conn_aux(kind)
        if var_type == Var.FLUX_TYPE:
            ca.flux_type[:] = values
        elif var_type == Var.CONDUCTANCE_TYPE:
            vals = np.asarray(values)
            ca.cond_type[:] = np.where(vals == 0, ca.cond_type, vals)
        else:
            raise NotImplementedError(var_type)
        self.invalidate()

    def set_conn_real_value(self, kind, var_type, values):
        """VSFMMPPSetAuxVarConnRealValue."""
        ca = self._conn_aux(kind)
        if var_type == Var.CONDUCTANCE:
            ca.conductance[:] = values
        elif var_type == Var.CONDUCTANCE_UP:
            ca.conductance_up[:] = values
        elif var_type == Var.CONDUCTANCE_DN:
            ca.conductance_dn[:] = values
        else:
            raise NotImplementedError(var_type)
        self.invalidate()

    def set_conn_relperm(self, kind, set_upwind, relperm_itype, p1, p2):
        """RichardsODESetRelativePermeabilityAuxVarConn
        (GoveqnRichardsODEPressureType.F90:3318-3424)."""
        ca = self._conn_aux(kind)
        relperm_itype = np.asarray(relperm_itype)
        for i in range(relperm_itype.size):
            if relperm_itype[i] <= 0:
                continue
            sp = ca.sp_up if set_upwind[i] else ca.sp_dn
            t = int(relperm_itype[i])
            if t == sf.RELPERM_FUNC_WEIBULL:
                sp.set_weibull_relperm(i, p1[i], p2[i])
            elif t == sf.RELPERM_FUNC_CAMPBELL:
                sp.set_campbell_relperm(i, p1[i], p2[i])
            elif t == sf.RELPERM_FUNC_MUALEM:
                pass
            else:
                raise ValueError(t)
        self.invalidate()

    def set_conn_satfunc(self, kind, set_upwind, satfunc_itype, p1, p2, p3):
        """RichardsODESetSaturationFunctionAuxVarConn."""
        ca = self._conn_aux(kind)
        satfunc_itype = np.asarray(satfunc_itype)
        for i in range(satfunc_itype.size):
            if satfunc_itype[i] <= 0:
                continue
            sp = ca.sp_up if set_upwind[i] else ca.sp_dn
            t = int(satfunc_itype[i])
            if t == sf.SAT_FUNC_VAN_GENUCHTEN:
                sp.set_vg(i, p3[i], p1[i], p2[i])
            elif t == sf.SAT_FUNC_BROOKS_COREY:
                sp.set_bc(i, p3[i], p1[i], p2[i])
            elif t == sf.SAT_FUNC_FETCH2:
                sp.set_fetch2(i, p1[i], p2[i])
            elif t == sf.SAT_FUNC_CHUANG:
                sp.set_chuang(i, p1[i], p2[i])
            else:
                raise ValueError(t)
        self.invalidate()

    def _copy_params_to_bc_ss(self):
        """BC/SS auxvars inherit the adjacent cell's parameters
        (VSFMMPPSetSoilsCLM:422-471)."""
        bc_ids = self._bc_concat()[0]
        for fld in dataclasses.fields(sf.SatParams):
            getattr(self.bc_sat_params, fld.name)[:] = np.asarray(
                getattr(self.sat_params, fld.name))[bc_ids]
        self.bc_por_params.porosity_base[:] = \
            self.por_params.porosity_base[bc_ids]
        self.bc_perm[:] = self.perm[bc_ids]
        ss_ids = self._ss_concat()[0]
        if ss_ids.size:
            for fld in dataclasses.fields(sf.SatParams):
                getattr(self.ss_sat_params, fld.name)[:] = np.asarray(
                    getattr(self.sat_params, fld.name))[ss_ids]
        self.invalidate()


class VSFMSoE:
    """SOE_RE_ODE data: the GE list, offsets, the CSR template and the
    solution vectors (numpy, one column).  Its serial SNES stepper is not
    ported: ``batched.vsfm_compiled`` steps the problem."""

    def __init__(self):
        self.goveqns: List[RichardsGE] = []
        self.itype = int(SOEType.RE_ODE)
        self.soln = None
        self.soln_prev = None
        self.soln_prev_clm = None
        self.template: Optional[CSRTemplate] = None
        self.snes_stol = 1e-10
        self.cumulative_newton_iterations = 0
        self.metrics = None

    @property
    def n_total(self):
        return sum(g.mesh.ncells_local for g in self.goveqns)

    def setup(self):
        self.offsets = np.cumsum([0] + [g.mesh.ncells_local
                                        for g in self.goveqns])
        n = self.n_total
        # built lazily: coupled-BC sparsity needs update_connections()
        self.template = None
        self.soln = np.zeros(n)
        self.soln_prev = np.zeros(n)
        self.soln_prev_clm = np.zeros(n)

    def _ensure_template(self):
        if self.template is not None:
            return
        offs = self.offsets
        rows, cols = [], []
        for g, off in zip(self.goveqns, offs[:-1]):
            r, c = g.coo_coords(off, off)
            rows.append(r)
            cols.append(c)
            rc, cc = g.coupling_coords(off, offs[:-1])
            rows.append(rc)
            cols.append(cc)
        n = self.n_total
        self.template = csr_template(n, n, np.concatenate(rows),
                                     np.concatenate(cols))


class VSFMMPP(MPPBase):
    """mpp_vsfm_type facade with the 8-step builder contract."""

    GE_CLASSES = {GEType.RE: RichardsGE}
    SS_COND_TYPES = (Cond.MASS_RATE, Cond.DOWNREG_MASS_RATE_CAMPBELL,
                     Cond.DOWNREG_MASS_RATE_FETCH2)

    def __init__(self):
        super().__init__()
        self.soe = VSFMSoE()

    def add_coupling_bcs_in_goveqn(self, ieqn, name, unit, id_of_other_goveqs,
                                   conn_set):
        """SOEBaseAddCouplingBCsInGovEqn: a COND_DIRICHLET_FRM_OTR_GOVEQ
        boundary condition whose 'up' side lives in another GE."""
        ge = self.soe.goveqns[ieqn - 1]
        cond = Condition(name=name, units=unit,
                         itype=int(Cond.DIRICHLET_FRM_OTR_GOVEQ),
                         conn_set=conn_set,
                         rank_of_other_goveqs=list(id_of_other_goveqs))
        cond.ensure_value()
        cond.coupled_cells = None
        ge.boundary_conditions.append(cond)
        return cond

    def update_connections(self):
        """VSFMSOEUpdateConnections (SystemOfEquationsVSFMType.F90:
        1174-1468): pair coupled BCs between GE pairs, rewire each BC
        connection's 'up' side to the partner GE's cell, set swap_order on
        the higher-rank GE's condition, and exchange the BC-side cell
        parameters and conn-auxvar up-side relperm/conductance."""
        ges = self.soe.goveqns

        def _bc_offset(ge, cond):
            off = 0
            for c in ge.boundary_conditions:
                if c is cond:
                    return off
                off += c.num_connections
            raise KeyError(cond)

        for i in range(len(ges)):
            for j in range(i + 1, len(ges)):
                conds_i = [c for c in ges[i].boundary_conditions
                           if c.itype == int(Cond.DIRICHLET_FRM_OTR_GOVEQ)
                           and (j + 1) in c.rank_of_other_goveqs]
                conds_j = [c for c in ges[j].boundary_conditions
                           if c.itype == int(Cond.DIRICHLET_FRM_OTR_GOVEQ)
                           and (i + 1) in c.rank_of_other_goveqs]
                for ci, cj in zip(conds_i, conds_j):
                    if ci.num_connections != cj.num_connections:
                        raise ValueError("coupled BC size mismatch")
                    cj.swap_order = True
                    ci.coupled_cells = cj.conn_set.id_dn.copy()
                    cj.coupled_cells = ci.conn_set.id_dn.copy()
                    ci.conn_set.dist_up = cj.conn_set.dist_dn.copy()
                    cj.conn_set.dist_up = ci.conn_set.dist_dn.copy()
                    oi = _bc_offset(ges[i], ci)
                    oj = _bc_offset(ges[j], cj)
                    m = ci.num_connections
                    for fld in dataclasses.fields(sf.SatParams):
                        a = getattr(ges[i].bc_sat_params, fld.name)
                        b = getattr(ges[j].bc_sat_params, fld.name)
                        tmp = a[oi:oi + m].copy()
                        a[oi:oi + m] = b[oj:oj + m]
                        b[oj:oj + m] = tmp
                    a = ges[i].bc_por_params.porosity_base
                    b = ges[j].bc_por_params.porosity_base
                    tmp = a[oi:oi + m].copy()
                    a[oi:oi + m] = b[oj:oj + m]
                    b[oj:oj + m] = tmp
                    tmp = ges[i].bc_perm[oi:oi + m].copy()
                    ges[i].bc_perm[oi:oi + m] = ges[j].bc_perm[oj:oj + m]
                    ges[j].bc_perm[oj:oj + m] = tmp
                    ca_i, ca_j = ges[i].conn_bc, ges[j].conn_bc
                    for fld in dataclasses.fields(sf.SatParams):
                        ai = getattr(ca_i.sp_up, fld.name)
                        aj = getattr(ca_j.sp_up, fld.name)
                        ai[oi:oi + m] = getattr(ca_j.sp_dn, fld.name)[oj:oj + m]
                        aj[oj:oj + m] = getattr(ca_i.sp_dn, fld.name)[oi:oi + m]
                    ca_i.conductance_up[oi:oi + m] = \
                        ca_j.conductance_dn[oj:oj + m]
                    ca_j.conductance_up[oj:oj + m] = \
                        ca_i.conductance_dn[oi:oi + m]
        for g in ges:
            g.invalidate()

    def setup_problem(self):
        self.soe.setup()

    def set_soils(self, filter_vsfmc, watsat, hksat, bsw, sucsat,
                  residual_sat, satfunc_type, density_type, goveqn_id=1):
        self.soe.goveqns[goveqn_id - 1].set_soils(
            filter_vsfmc, watsat, hksat, bsw, sucsat, residual_sat,
            satfunc_type, density_type)

    # per-GE property setters (VSFMMPPSet* pass-throughs) ------------------
    def set_density_type(self, igoveqn, density_type):
        """VSFMMPPSetDensityType (MultiPhysicsProbVSFM.F90:1115-1152)."""
        self.soe.goveqns[igoveqn - 1].density_type = int(density_type)

    def set_soil_permeability(self, igoveqn, perm_x, perm_y, perm_z):
        self.soe.goveqns[igoveqn - 1].set_soil_permeability(perm_x, perm_y,
                                                            perm_z)

    def set_soil_porosity(self, igoveqn, por):
        self.soe.goveqns[igoveqn - 1].set_soil_porosity(por)

    def set_saturation_function(self, igoveqn, satfunc_type, alpha, lam,
                                sat_res):
        self.soe.goveqns[igoveqn - 1].set_saturation_function(
            satfunc_type, alpha, lam, sat_res)

    def set_relative_permeability(self, igoveqn, relperm_type, p1, p2):
        self.soe.goveqns[igoveqn - 1].set_relative_permeability(
            relperm_type, p1, p2)

    def set_ss_auxvar(self, igoveqn, var_type, values):
        self.soe.goveqns[igoveqn - 1].set_ss_auxvar(var_type, values)

    def set_conn_int_value(self, igoveqn, kind, var_type, values):
        self.soe.goveqns[igoveqn - 1].set_conn_int_value(kind, var_type,
                                                         values)

    def set_conn_real_value(self, igoveqn, kind, var_type, values):
        self.soe.goveqns[igoveqn - 1].set_conn_real_value(kind, var_type,
                                                          values)

    def set_conn_relperm(self, igoveqn, kind, set_upwind, relperm_itype,
                         p1, p2):
        self.soe.goveqns[igoveqn - 1].set_conn_relperm(
            kind, set_upwind, relperm_itype, p1, p2)

    def set_conn_satfunc(self, igoveqn, kind, set_upwind, satfunc_itype,
                         p1, p2, p3):
        self.soe.goveqns[igoveqn - 1].set_conn_satfunc(
            kind, set_upwind, satfunc_itype, p1, p2, p3)

    def restart(self, press_1d):
        """VSFMMPPRestart: seed soln/soln_prev/pressure_prev."""
        press = np.asarray(press_1d, np.float64).copy()
        self.soe.soln = press
        self.soe.soln_prev = press
        self.soe.soln_prev_clm = press
        for g, off in zip(self.soe.goveqns, self.soe.offsets[:-1]):
            g.pressure_prev = press[off:off + g.mesh.ncells_local]

    def set_data(self, auxvar_kind, var_type, soe_auxvar_id, data):
        """SetDataFromCLM: BC/SS condition values (1-based condition index
        in GE order, coupling BCs excluded, MultiPhysicsProbVSFM.F90:
        786-789)."""
        data = np.asarray(data, np.float64)
        if auxvar_kind == AuxVarKind.BC:
            idx = 0
            for g in self.soe.goveqns:
                for ci, cond in enumerate(g.boundary_conditions):
                    if cond.itype == int(Cond.DIRICHLET_FRM_OTR_GOVEQ):
                        continue
                    idx += 1
                    if idx == soe_auxvar_id:
                        off = sum(c.num_connections
                                  for c in g.boundary_conditions[:ci])
                        m = cond.num_connections
                        g.bc_value = g.bc_value.copy()
                        g.bc_value[off:off + m] = data
                        return
            raise IndexError(soe_auxvar_id)
        elif auxvar_kind == AuxVarKind.SS:
            idx = 0
            for g in self.soe.goveqns:
                for ci, cond in enumerate(g.source_sinks):
                    idx += 1
                    if idx == soe_auxvar_id:
                        off = sum(c.num_connections
                                  for c in g.source_sinks[:ci])
                        m = cond.num_connections
                        g.ss_value = g.ss_value.copy()
                        g.ss_value[off:off + m] = data
                        return
            raise IndexError(soe_auxvar_id)
        raise NotImplementedError(auxvar_kind)

    def get_data(self, auxvar_kind, var_type, goveqn_id=-1):
        """GetDataForCLM: pressure / saturation over all GEs (numpy)."""
        out = []
        for g in self.soe.goveqns:
            P = np.asarray(g.pressure, np.float64)
            if var_type == Var.PRESSURE:
                out.append(P)
            elif var_type == Var.LIQ_SAT:
                sat, _ = sf.press_to_sat(g.sat_params,
                                         torch.as_tensor(P))
                out.append(sat.numpy())
            else:
                raise NotImplementedError(var_type)
        return np.concatenate(out)

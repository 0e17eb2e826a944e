"""Temperature-based soil heat transport (the KSP path): GEs, SoE and the
MPP facade.

Counterpart of ``mpp_tpu/models/thermal.py`` (the reference's thermal-T
stack):

* the auxvar constitutive update (``ThermalKSPTemperatureSoilAuxType.F90:
  72-172``, the CLM soil thermal conductivity / heat capacity model; the
  snow and standing-surface-water laws);
* assembly (``GoveqnThermalKSPTemperatureSoilType.F90``): Accum, Divergence,
  DiffHeatFlux and OperatorsDiag as matrix contributions in ``coo_coords``
  order plus the right-hand side;
* soil property staging (``MultiPhysicsProbThermal.F90:76-208``), with
  the copy of cell properties onto the BC auxvars;
* the 8-step facade builder, cross-GE Dirichlet coupling and CLM-style
  ``set_r_data`` staging.

Staged per-cell and per-connection state is numpy (host configuration);
the assembly takes its device and dtype from the temperature tensor
``T [..., n]`` (any leading batch dimensions) and reads the staged arrays
at every call, so in-place rewrites of the mesh geometry between steps
are picked up; their device copies are kept per device and dtype and made
again only when the host values change.  ``dyn`` promotes per-step state
to explicit tensors (the compiled batched path,
``batched/ksp_compiled.py``).

The serial ``ThermalSOE.step_dt`` takes ``solver="block"`` (the batched
block-Thomas sweep over column chains); ``solver="ksp"``, the PETSc
GMRES(30)+ILU(0) replica, is not ported yet (ROADMAP Slice D): the port's
serial path is ``compile_ksp(mpp).install()``.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import List, Optional

import numpy as np
import torch

from mpp_tpu_torch import constants as C
from mpp_tpu_torch.constants import Cond, GEType, Var, AuxVarKind
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.dtypes.mesh import (Mesh, ConnectionSet,
                                       concat_connection_sets)
from mpp_tpu_torch.dtypes.conditions import Condition
from mpp_tpu_torch.dtypes.mpp_base import MPPBase
from mpp_tpu_torch.ops.sparse import csr_template, CSRTemplate


def _f(a, ref):
    """Staged numpy (or tensor) ``a`` as a tensor of ``ref``'s dtype and
    device."""
    return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                           dtype=ref.dtype, device=ref.device)


def _mask(a, ref):
    if torch.is_tensor(a):
        return a
    return torch.as_tensor(np.asarray(a, bool), device=ref.device)


def thermal_soil_aux(T, liq, ice, snow_water, num_snow_layer, tuning,
                     lun_type, is_shallow, por, tkmg, tkdry, csol, dz):
    """``ThermKSPTempSoilAuxVarCompute``
    (ThermalKSPTemperatureSoilAuxType.F90:72-172), elementwise over
    broadcastable tensors.

    Returns (therm_cond, heat_cap_pva).  ``lun_type``/``is_shallow`` are
    static: numpy, or tensors on T's device."""
    if not torch.is_tensor(lun_type):
        lun_type = torch.as_tensor(np.asarray(lun_type, np.int64),
                                   device=T.device)
    is_soil = (lun_type == C.IST_SOIL) | (lun_type == C.IST_CROP)
    is_wet = lun_type == C.IST_WET
    is_ice_lu = (lun_type == C.IST_ICE) | (lun_type == C.IST_ICE_MEC)
    shallow = _mask(is_shallow, T)

    # --- soil/crop branch ---------------------------------------------------
    satw = (liq / C.DENH2O + ice / C.DENICE) / (dz * por)
    satw = torch.clamp_max(satw, 1.0)
    wet_enough = satw > 0.1e-6
    satw_safe = torch.where(wet_enough, satw, 1.0)
    dke_unfrozen = torch.clamp_min(torch.log10(satw_safe) + 1.0, 0.0)
    dke = torch.where(T >= C.TFRZ, dke_unfrozen, satw_safe)
    liq_frac_num = liq / (C.DENH2O * dz)
    ice_frac_num = ice / (C.DENICE * dz)
    denom = liq_frac_num + ice_frac_num
    fl = liq_frac_num / torch.where(denom == 0, 1.0, denom)
    dksat = tkmg * C.TKWAT ** (fl * por) * C.TKICE ** ((1.0 - fl) * por)
    k_soil_shallow = torch.where(wet_enough,
                                 dke * dksat + (1.0 - dke) * tkdry, tkdry)
    k_soil = torch.where(shallow, k_soil_shallow, C.THK_BEDROCK)
    cap = csol * (1.0 - por) * dz + ice * C.CPICE + liq * C.CPLIQ
    cap = cap + torch.where(num_snow_layer == 0, snow_water * C.CPICE, 0.0)
    cap_soil = torch.where(shallow, cap,
                           csol * (1.0 - por) * dz + ice * C.CPICE
                           + liq * C.CPLIQ)
    cap_soil = cap_soil / dz

    # --- wetland / land-ice branches ---------------------------------------
    k_water = torch.where(T < C.TFRZ, torch.full_like(T, C.TKICE),
                          C.TKWAT)
    cap_wi = (ice * C.CPICE + liq * C.CPLIQ
              + torch.where(num_snow_layer == 0, snow_water * C.CPICE, 0.0)) \
        / dz
    k_wet = torch.where(shallow, k_water, C.THK_BEDROCK)
    cap_wet = torch.where(shallow, cap_wi, csol)

    therm_cond = torch.where(is_soil, k_soil,
                             torch.where(is_wet, k_wet,
                                         torch.where(is_ice_lu, k_water,
                                                     0.0)))
    heat_cap = torch.where(is_soil, cap_soil,
                           torch.where(is_wet, cap_wet,
                                       torch.where(is_ice_lu, cap_wi, 0.0)))
    return therm_cond, heat_cap


_THIN_SFCLAYER = 1.0e-6  # thin-surface-layer threshold (Snow/SSW aux types)


def thermal_snow_aux(liq, ice, frac, dz):
    """``ThermKSPTempSnowAuxVarCompute``
    (ThermalKSPTemperatureSnowAuxType.F90:55-86): snow bulk-density
    conductivity and per-volume heat capacity."""
    frac_safe = torch.where(frac > 0.0, frac, 1.0)
    bw = (ice + liq) / (frac_safe * dz)
    k = C.TKAIR + (7.75e-5 * bw + 1.105e-6 * bw * bw) * (C.TKICE - C.TKAIR)
    cap = torch.where(frac > 0.0,
                      torch.clamp_min((C.CPLIQ * liq + C.CPICE * ice)
                                      / frac_safe, _THIN_SFCLAYER),
                      _THIN_SFCLAYER)
    return k, cap / dz


def thermal_ssw_aux(frac, dz):
    """``ThermKSPTempSSWAuxVarCompute``
    (ThermalKSPTemperatureSSWAuxType.F90:45-74): standing surface water."""
    k = torch.full_like(frac, C.TKWAT)
    thick = (dz * frac * 1.0e3 > _THIN_SFCLAYER) & (frac > _THIN_SFCLAYER)
    cap = torch.where(thick, torch.full_like(
        frac, max(_THIN_SFCLAYER, C.CPLIQ * C.DENH2O)), _THIN_SFCLAYER)
    return k, cap


def _harmonic(k_up, k_dn, d_up, d_dn):
    """Distance-weighted harmonic mean conductivity
    (GoveqnThermalKSPTemperatureSoilType.F90:997-999)."""
    dist = d_up + d_dn
    return k_up * k_dn * dist / (k_up * d_dn + k_dn * d_up)


def _ref(T, dyn, ref=None):
    """The tensor whose dtype and device the staged arrays take: T, else
    ``ref``, else any tensor of ``dyn``, else an f64 CPU scalar."""
    if T is not None:
        return T
    if ref is not None:
        return ref
    for v in (dyn or {}).values():
        if torch.is_tensor(v):
            return v
    return torch.zeros((), dtype=torch.float64)


@dataclasses.dataclass
class ThermalSoilGE:
    """Soil thermal governing equation (GE_THERM_SOIL_TBASED)."""
    name: str
    mesh: Mesh
    itype: int = int(GEType.THERM_SOIL_TBASED)
    dof: int = 1
    boundary_conditions: List[Condition] = dataclasses.field(
        default_factory=list)
    source_sinks: List[Condition] = dataclasses.field(default_factory=list)

    # static per-cell soil properties (MPPThermalSetSoils)
    lun_type: np.ndarray = None
    is_shallow: np.ndarray = None
    por: np.ndarray = None
    tkmg: np.ndarray = None
    tkdry: np.ndarray = None
    csol: np.ndarray = None
    # dynamic per-cell state
    temperature: np.ndarray = None
    liq_areal_den: np.ndarray = None
    ice_areal_den: np.ndarray = None
    snow_water: np.ndarray = None
    num_snow_layer: np.ndarray = None
    tuning_factor: np.ndarray = None
    # BC aux state: per bc-connection
    bc_is_active: np.ndarray = None
    bc_frac: np.ndarray = None
    bc_value: np.ndarray = None       # condition value (Dirichlet T / flux)
    bc_dhsdT: np.ndarray = None
    # device copies of the staged arrays per (key, device, dtype), each
    # with the host values it was made from
    _tc: dict = dataclasses.field(default_factory=dict, repr=False,
                                  compare=False)

    def allocate_auxvars(self) -> None:
        n = self.mesh.ncells_all
        self.lun_type = np.zeros(n, np.int32)
        self.is_shallow = np.ones(n, bool)
        self.por = np.zeros(n)
        self.tkmg = np.zeros(n)
        self.tkdry = np.zeros(n)
        self.csol = np.zeros(n)
        self.temperature = np.zeros(n)
        self.liq_areal_den = np.zeros(n)
        self.ice_areal_den = np.zeros(n)
        self.snow_water = np.zeros(n)
        self.num_snow_layer = np.zeros(n, np.int32)
        self.tuning_factor = np.ones(n)
        nbc = sum(c.num_connections for c in self.boundary_conditions)
        self.bc_is_active = np.ones(nbc, bool)
        self.bc_frac = np.ones(nbc)
        self.bc_value = np.zeros(nbc)
        self.bc_dhsdT = np.zeros(nbc)
        nss = sum(c.num_connections for c in self.source_sinks)
        self.ss_values = np.zeros(nss)
        # exchanged state for COND_DIRICHLET_FRM_OTR_GOVEQ conns
        # (ThermalSOEGovEqnExchangeAuxVars copies VAR_TEMPERATURE /
        # VAR_THERMAL_COND from the coupled GE's cells)
        self.bc_exch_T = np.zeros(nbc)
        self.bc_exch_k = np.ones(nbc)
        # BC auxvar property copies (filled by set_soils)
        self.bc_lun_type = np.zeros(nbc, np.int32)
        self.bc_is_shallow = np.ones(nbc, bool)
        self.bc_por = np.zeros(nbc)
        self.bc_tkmg = np.zeros(nbc)
        self.bc_tkdry = np.zeros(nbc)
        self.bc_csol = np.zeros(nbc)

    # -- device copies of the staged arrays ---------------------------------
    def _dev(self, key, a, ref, kind="f"):
        """Staged numpy ``a`` as a tensor on ``ref``'s device: floats in
        ``ref``'s dtype, ``kind`` "i" as int64 indices, "b" as bool.  The
        copy is made again only when ``a``'s values differ from those it
        was made from, since the staged arrays (mesh geometry, properties)
        may be rewritten in place between steps."""
        a = np.asarray(a)
        dt = {"f": ref.dtype, "i": torch.long, "b": torch.bool}[kind]
        k = (key, str(ref.device), dt)
        hit = self._tc.get(k)
        if hit is not None and hit[0].shape == a.shape \
                and np.array_equal(hit[0], a):
            return hit[1]
        v = torch.as_tensor(a, dtype=dt, device=ref.device)
        self._tc[k] = (a.copy(), v)
        return v

    def _staged(self, d, key, name, ref, kind="f"):
        """``d[key]`` (a dynamic input) if given, else the staged attribute
        ``name`` on ``ref``'s device."""
        if key in d:
            return d[key]
        return self._dev(name, getattr(self, name), ref, kind)

    # -- static topology helpers --------------------------------------------
    def _internal(self) -> ConnectionSet:
        return concat_connection_sets(self.mesh.intrn_conn_sets)

    def _bc_concat(self):
        """(cell ids, dist_up, dist_dn, area, itype codes) over all BCs in
        condition order — the reference walks BCs accumulating sum_conn."""
        ids, dup, ddn, ar, code = [], [], [], [], []
        for cond in self.boundary_conditions:
            cs = cond.conn_set
            ids.append(cs.id_dn)
            dup.append(cs.dist_up)
            ddn.append(cs.dist_dn)
            ar.append(cs.area)
            code.append(np.full(cs.num_connections, cond.itype, np.int32))
        if not ids:
            z = np.zeros(0)
            return z.astype(np.int64), z, z, z, z.astype(np.int32)
        return (np.concatenate(ids).astype(np.int64), np.concatenate(dup),
                np.concatenate(ddn), np.concatenate(ar),
                np.concatenate(code))

    def _ss_concat(self):
        ids, code = [], []
        for cond in self.source_sinks:
            ids.append(cond.conn_set.id_dn)
            code.append(np.full(cond.conn_set.num_connections, cond.itype,
                                np.int32))
        if not ids:
            return np.zeros(0, np.int64), np.zeros(0, np.int32)
        return np.concatenate(ids).astype(np.int64), np.concatenate(code)

    def coo_coords(self, row_off: int = 0, col_off: int = 0):
        """Static COO coordinates of every A contribution, in assembly
        order: diag accum, internal (4/conn), BC diag (1/conn)."""
        n = self.mesh.ncells_local
        ic = self._internal()
        bc_ids = self._bc_concat()[0]
        rows = [np.arange(n), ic.id_up, ic.id_up, ic.id_dn, ic.id_dn, bc_ids]
        cols = [np.arange(n), ic.id_up, ic.id_dn, ic.id_up, ic.id_dn, bc_ids]
        return (np.concatenate(rows).astype(np.int64) + row_off,
                np.concatenate(cols).astype(np.int64) + col_off)

    def coupling_coords(self, row_off: int, col_off_by_rank: dict):
        """Off-diagonal COO coordinates for cross-GE Dirichlet coupling
        (ComputeOperatorsOffDiag, GoveqnThermalKSPTemperatureSnowType.F90:
        1202-1300): row = this GE's conn cell (id_dn), col = the coupled
        GE's cell (id_up), in _bc_concat order over FRM_OTR conns."""
        rows, cols = [], []
        for cond in self.boundary_conditions:
            if cond.itype != int(Cond.DIRICHLET_FRM_OTR_GOVEQ):
                continue
            other = getattr(cond, "other_geq_rank", None)
            if other is None:
                raise ValueError(f"coupling condition {cond.name} lacks "
                                 "other_geq_rank")
            cs = cond.conn_set
            rows.append(np.asarray(cs.id_dn, np.int64) + row_off)
            cols.append(np.asarray(cs.id_up, np.int64)
                        + col_off_by_rank[other])
        if not rows:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(rows), np.concatenate(cols)

    # ``dyn`` (optional dict of tensors) promotes per-step state from the
    # staged attributes to explicit inputs — the compiled batched KSP path
    # passes them.  Recognized keys: "liq", "ice", "snow_water",
    # "num_snow_layer", "tuning", "frac" (snow/ssw), "bc_frac", "bc_dhsdT".
    def aux(self, T, dyn=None, ref=None):
        """Internal-cell aux update (UpdateAuxVarsIntrn): (therm_cond,
        heat_cap) over T's cells."""
        d = dyn or {}
        r = _ref(T, d, ref)
        return thermal_soil_aux(
            T, self._staged(d, "liq", "liq_areal_den", r),
            self._staged(d, "ice", "ice_areal_den", r),
            self._staged(d, "snow_water", "snow_water", r),
            self._staged(d, "num_snow_layer", "num_snow_layer", r, "i"),
            self._staged(d, "tuning", "tuning_factor", r),
            self._dev("lun_type", self.lun_type, r, "i"),
            self._dev("is_shallow", self.is_shallow, r, "b"),
            self._dev("por", self.por, r), self._dev("tkmg", self.tkmg, r),
            self._dev("tkdry", self.tkdry, r),
            self._dev("csol", self.csol, r),
            self._dev("dz", self.mesh.dz, r))

    def bc_aux(self, T, bc_value=None, exch_T=None, exch_k=None, dyn=None):
        """BC auxvar update (UpdateAuxVarsBC): Dirichlet BCs take the
        condition value as temperature, flux BCs mirror the internal cell,
        cross-GE Dirichlet conns take the exchanged temperature AND
        conductivity; conductivity otherwise evaluated with the BC
        auxvar's own property copies and the adjacent cell's dz."""
        bc_ids, _, _, _, code = self._bc_concat()
        if bc_ids.size == 0:
            z = T.new_zeros(T.shape[:-1] + (0,))
            return z, z
        bc_value = self._dev("bc_value", self.bc_value, T) \
            if bc_value is None else _f(bc_value, T)
        exch_T = self._dev("bc_exch_T", self.bc_exch_T, T) \
            if exch_T is None else _f(exch_T, T)
        exch_k = self._dev("bc_exch_k", self.bc_exch_k, T) \
            if exch_k is None else _f(exch_k, T)
        is_dirichlet = self._dev("bc_is_dirichlet",
                                 code == int(Cond.DIRICHLET), T, "b")
        is_otr = self._dev("bc_is_otr",
                           code == int(Cond.DIRICHLET_FRM_OTR_GOVEQ), T, "b")
        T_bc = torch.where(is_dirichlet, bc_value,
                           T[..., self._dev("bc_ids", bc_ids, T, "i")])
        T_bc = torch.where(is_otr, exch_T, T_bc)
        k_bc = self._bc_own_conductivity(T_bc, bc_ids, dyn)
        k_bc = torch.where(is_otr, exch_k, k_bc)
        return T_bc, k_bc

    def _bc_own_conductivity(self, T_bc, bc_ids, dyn=None):
        dz_bc = self._dev("bc_dz", np.asarray(self.mesh.dz)[bc_ids], T_bc)
        z = torch.zeros_like(T_bc)
        k_bc, _cap = thermal_soil_aux(
            T_bc, z, z, z, torch.zeros_like(T_bc, dtype=torch.int32),
            torch.ones_like(T_bc),
            self._dev("bc_lun_type", self.bc_lun_type, T_bc, "i"),
            self._dev("bc_is_shallow", self.bc_is_shallow, T_bc, "b"),
            self._dev("bc_por", self.bc_por, T_bc),
            self._dev("bc_tkmg", self.bc_tkmg, T_bc),
            self._dev("bc_tkdry", self.bc_tkdry, T_bc),
            self._dev("bc_csol", self.bc_csol, T_bc), dz_bc)
        return k_bc

    def contributions(self, T, dt, cnfac, ss_values, bc_value=None,
                      exch_T=None, exch_k=None, dyn=None):
        """A-values (ordered per coo_coords) ``[..., nvals]``, rhs b
        ``[..., n]`` and the cross-GE coupling values, for T ``[..., n]``.

        Accum + Divergence (rhs) and OperatorsDiag (matrix) for the
        non-MATCH_CLM formulation (factor = 1), with per-connection
        areas."""
        d = dyn or {}
        shape = T.shape
        dev = partial(self._dev, ref=T)
        vol = dev("vol", self.mesh.vol)
        active_np = np.asarray(self.mesh.is_active, bool)
        active = dev("active", active_np, kind="b")
        k_cell, cap = (torch.broadcast_to(a, shape) for a in self.aux(T, dyn))

        # accumulation diag + rhs (Accum, OperatorsDiag diagonal)
        accum = cap * vol / (dt * self._staged(d, "tuning", "tuning_factor",
                                               T))
        diag_vals = torch.where(active, accum, 1.0)
        b = torch.where(active, accum * T, 0.0)

        # internal connections
        ic = self._internal()
        iu = dev("iu", ic.id_up, kind="i")
        idn = dev("idn", ic.id_dn, kind="i")
        both = dev("both", active_np[ic.id_up] & active_np[ic.id_dn],
                   kind="b")
        kavg = _harmonic(k_cell[..., iu], k_cell[..., idn],
                         dev("dist_up", ic.dist_up),
                         dev("dist_dn", ic.dist_dn))
        dist = dev("dist", ic.dist_up + ic.dist_dn)
        area = dev("area", ic.area)
        val = torch.where(both, (1.0 - cnfac) * kavg / dist * area, 0.0)
        intr_vals = torch.cat([val, -val, -val, val], dim=-1)
        flux = -kavg * (T[..., iu] - T[..., idn]) / dist
        add = torch.where(both, cnfac * flux * area, 0.0)
        b = b.index_add(-1, iu, add).index_add(-1, idn, -add)

        # boundary conditions
        bc_ids, bdup, bddn, barea, bcode = self._bc_concat()
        if bc_ids.size:
            bids = dev("bc_ids", bc_ids, kind="i")
            bc_value = dev("bc_value", self.bc_value) if bc_value is None \
                else _f(bc_value, T)
            bc_frac = self._staged(d, "bc_frac", "bc_frac", T)
            bc_dhsdT = self._staged(d, "bc_dhsdT", "bc_dhsdT", T)
            T_bc, k_bc = self.bc_aux(T, bc_value, exch_T, exch_k, dyn)
            bc_active = dev("bc_active", np.asarray(self.bc_is_active, bool)
                            & active_np[bc_ids], kind="b")
            kavg_b = _harmonic(k_bc, k_cell[..., bids],
                               dev("bc_dist_up", bdup),
                               dev("bc_dist_dn", bddn))
            dist_b = dev("bc_dist", bdup + bddn)
            area_b = dev("bc_area", barea)
            otr_np = bcode == int(Cond.DIRICHLET_FRM_OTR_GOVEQ)
            is_dir = dev("bc_is_dir", np.isin(
                bcode, (int(Cond.DIRICHLET),
                        int(Cond.DIRICHLET_FRM_OTR_GOVEQ))), kind="b")
            is_dir_otr = dev("bc_is_otr", otr_np, kind="b")
            is_hflux = dev("bc_is_hflux", bcode == int(Cond.HEAT_FLUX),
                           kind="b")
            # matrix diagonal (OperatorsDiag:1161-1218)
            dir_diag = bc_frac * (1.0 - cnfac) * kavg_b / dist_b * area_b
            hflux_diag = -bc_frac * bc_dhsdT * area_b
            bc_diag = torch.where(
                bc_active, torch.where(is_dir, dir_diag,
                                       torch.where(is_hflux, hflux_diag,
                                                   0.0)), 0.0)
            # rhs (Divergence:816-935)
            flux_b = -kavg_b * (T_bc - T[..., bids]) / dist_b
            rhs_dir = kavg_b / dist_b * T_bc * area_b
            rhs_dir_otr = -bc_frac * cnfac * flux_b * area_b
            # HEAT_FLUX rhs carries H - dhsdT*T_prev (the staged
            # cur_cond%value, GoveqnThermalKSPTemperatureSoilType.F90:
            # 344-348) so with the -frac*dhsdT diag the net surface flux
            # is H + dhsdT*(T_new - T_prev)
            rhs_hflux = (bc_value - bc_dhsdT * T[..., bids]) \
                * bc_frac * area_b
            bc_rhs = torch.where(
                bc_active,
                torch.where(is_dir_otr, rhs_dir_otr,
                            torch.where(is_hflux, rhs_hflux,
                                        torch.where(is_dir, rhs_dir, 0.0))),
                0.0)
            b = b.index_add(-1, bids, torch.broadcast_to(
                bc_rhs, shape[:-1] + bids.shape))
            # implicit cross-GE off-diagonal (-d flux/d T_other), aligned
            # with coupling_coords' FRM_OTR subset
            cpl_all = torch.where(bc_active,
                                  -bc_frac * (1.0 - cnfac) * kavg_b
                                  / dist_b * area_b, 0.0)
            cpl_vals = cpl_all[..., dev("bc_otr_slots", np.nonzero(otr_np)[0],
                                        kind="i")]
        else:
            bc_diag = T.new_zeros(shape[:-1] + (0,))
            cpl_vals = T.new_zeros(shape[:-1] + (0,))

        # source sinks: COND_HEAT_RATE adds the raw value (Divergence:937-970)
        ss_ids, _ = self._ss_concat()
        if ss_ids.size:
            sids = dev("ss_ids", ss_ids, kind="i")
            add_ss = torch.where(active[sids], _f(ss_values, T), 0.0)
            b = b.index_add(-1, sids, torch.broadcast_to(
                add_ss, shape[:-1] + sids.shape))

        vals = torch.cat([torch.broadcast_to(diag_vals, shape), intr_vals,
                          torch.broadcast_to(
                              bc_diag, shape[:-1] + bc_diag.shape[-1:])],
                         dim=-1)
        return vals, b, torch.broadcast_to(
            cpl_vals, shape[:-1] + cpl_vals.shape[-1:])

    # -- property staging (MPPThermalSetSoils) -------------------------------
    def set_soils(self, filter_thermal, lun_type, watsat, csol, tkmg, tkdry,
                  nlevsoi: Optional[int] = None):
        """Stage soil thermal properties.

        Args are CLM-shaped [ncol] / [ncol, nlevgrnd]; cells are ordered
        column-major (all levels of col 0, then col 1, ...), matching
        MultiPhysicsProbThermal.F90:154-185.  BC auxvars receive copies of
        the adjacent cell's properties (:187-206)."""
        watsat = np.asarray(watsat)
        filter_thermal = np.asarray(filter_thermal)
        ncol, nlev = watsat.shape
        nlevsoi = nlev if nlevsoi is None else nlevsoi
        first_active = int(np.nonzero(filter_thermal == 1)[0][0])
        src = np.where(filter_thermal == 1, np.arange(ncol), first_active)
        cells = slice(0, ncol * nlev)
        self.is_shallow[cells] = np.tile(np.arange(nlev) < nlevsoi, ncol)
        self.lun_type[cells] = np.repeat(np.asarray(lun_type)[src], nlev)
        self.por[cells] = np.asarray(watsat)[src].ravel()
        self.tkmg[cells] = np.asarray(tkmg)[src].ravel()
        self.tkdry[cells] = np.asarray(tkdry)[src].ravel()
        self.csol[cells] = np.asarray(csol)[src].ravel()
        self.mesh.set_grid_cell_filter(np.repeat(filter_thermal == 1, nlev))
        bc_ids = self._bc_concat()[0]
        self.bc_lun_type = self.lun_type[bc_ids]
        self.bc_is_shallow = self.is_shallow[bc_ids]
        self.bc_por = self.por[bc_ids]
        self.bc_tkmg = self.tkmg[bc_ids]
        self.bc_tkdry = self.tkdry[bc_ids]
        self.bc_csol = self.csol[bc_ids]


@dataclasses.dataclass
class ThermalSnowGE(ThermalSoilGE):
    """Snow thermal governing equation (GE_THERM_SNOW_TBASED,
    GoveqnThermalKSPTemperatureSnowType.F90).  The soil GE's assembly with
    the snow bulk-density law; the media couple through
    COND_DIRICHLET_FRM_OTR_GOVEQ conns."""
    itype: int = int(GEType.THERM_SNOW_TBASED)

    def allocate_auxvars(self) -> None:
        super().allocate_auxvars()
        self.frac = np.ones(self.mesh.ncells_all)

    def aux(self, T, dyn=None, ref=None):
        d = dyn or {}
        r = _ref(T, d, ref)
        return thermal_snow_aux(self._staged(d, "liq", "liq_areal_den", r),
                                self._staged(d, "ice", "ice_areal_den", r),
                                self._staged(d, "frac", "frac", r),
                                self._dev("dz", self.mesh.dz, r))

    def _bc_own_conductivity(self, T_bc, bc_ids, dyn=None):
        k_cell, _ = self.aux(None, dyn, ref=T_bc)
        return k_cell[..., self._dev("bc_ids", bc_ids, T_bc, "i")]

    def update_top_flux_conn(self):
        """Rewire the top heat-flux BC to the topmost ACTIVE snow layer of
        each column (ThermKSPTempSnowUpdateBoundaryConn :680-689: snow
        layers fill bottom-up, so the connection lands at
        nlevsno - num_snow_layer)."""
        nlev = self.mesh.nlev
        nsl = np.asarray(self.num_snow_layer).reshape(-1, nlev)[:, -1]
        for cond in self.boundary_conditions:
            if cond.itype == int(Cond.HEAT_FLUX):
                ncols = cond.conn_set.num_connections
                base = np.arange(ncols) * nlev
                cond.conn_set.id_dn = (base + nlev
                                       - np.minimum(nsl, nlev)).astype(
                    cond.conn_set.id_dn.dtype)


@dataclasses.dataclass
class ThermalSSWGE(ThermalSoilGE):
    """Standing-surface-water thermal GE (GE_THERM_SSW_TBASED,
    GoveqnThermalKSPTemperatureSSWType.F90)."""
    itype: int = int(GEType.THERM_SSW_TBASED)

    def allocate_auxvars(self) -> None:
        super().allocate_auxvars()
        self.frac = np.ones(self.mesh.ncells_all)

    def aux(self, T, dyn=None, ref=None):
        d = dyn or {}
        r = _ref(T, d, ref)
        return thermal_ssw_aux(self._staged(d, "frac", "frac", r),
                               self._dev("dz", self.mesh.dz, r))

    def _bc_own_conductivity(self, T_bc, bc_ids, dyn=None):
        k_cell, _ = self.aux(None, dyn, ref=T_bc)
        return k_cell[..., self._dev("bc_ids", bc_ids, T_bc, "i")]


class ThermalSOE:
    """System of equations for SOE_THERMAL_TBASED (KSP).

    Holds the GE list, the composite solution vector (numpy) and the
    solver, with PreStepDT / StepDT / PostSolve semantics
    (SystemOfEquationsThermalType.F90 + SystemOfEquationsBaseType.F90)."""

    def __init__(self):
        self.goveqns: List[ThermalSoilGE] = []
        self.soln = None
        self.soln_prev = None
        self.soln_prev_clm = None
        self.cnfac = C.CNFAC
        self.template: Optional[CSRTemplate] = None
        self._block_tpl = None
        self.cumulative_linear_iterations = 0
        self.metrics = None

    @property
    def n_total(self) -> int:
        return sum(g.mesh.ncells_local for g in self.goveqns)

    def setup(self):
        offs = np.cumsum([0] + [g.mesh.ncells_local for g in self.goveqns])
        col_off_by_rank = {i + 1: offs[i] for i in range(len(self.goveqns))}
        rows, cols = [], []
        for g, off in zip(self.goveqns, offs[:-1]):
            r, c = g.coo_coords(off, off)
            rows.append(r)
            cols.append(c)
        # cross-GE off-diagonal blocks (ComputeOperatorsOffDiag)
        for g, off in zip(self.goveqns, offs[:-1]):
            r, c = g.coupling_coords(off, col_off_by_rank)
            rows.append(r)
            cols.append(c)
        n = self.n_total
        self.offsets = offs
        self.template = csr_template(n, n, np.concatenate(rows),
                                     np.concatenate(cols))
        self.soln = np.zeros(n)
        self.soln_prev = np.zeros(n)
        self.soln_prev_clm = np.zeros(n)

    def rebuild_template(self):
        """Re-discover the sparsity after condition connections were
        rewired (e.g. snow-top flux retargeting with variable snl): the
        KSP path's MATPREALLOCATOR re-discovery
        (SystemOfEquationsBaseType.F90:593-613), run only on a topology
        change."""
        soln, prev, prev_clm = self.soln, self.soln_prev, self.soln_prev_clm
        self.setup()
        self.soln, self.soln_prev, self.soln_prev_clm = soln, prev, prev_clm
        self._block_tpl = None

    def exchange_auxvars(self, T):
        """Cross-GE BC staging (ThermalSOEGovEqnExchangeAuxVars,
        SystemOfEquationsThermalType.F90:770-919): every FRM_OTR condition
        receives the coupled GE's cell temperature and thermal
        conductivity at the conn's id_up cells.  ``T`` [n] (numpy or
        tensor); the staged exchange arrays are numpy."""
        T = torch.as_tensor(np.asarray(T, np.float64)) \
            if not torch.is_tensor(T) else T
        ks = []
        for g, off in zip(self.goveqns, self.offsets[:-1]):
            k, _cap = g.aux(T[off:off + g.mesh.ncells_local])
            ks.append(torch.broadcast_to(k, (g.mesh.ncells_local,))
                      .cpu().numpy())
        T_np = T.cpu().numpy()
        for g, off in zip(self.goveqns, self.offsets[:-1]):
            if not g.boundary_conditions:
                continue
            exch_T, exch_k = [], []
            for cond in g.boundary_conditions:
                m = cond.conn_set.num_connections
                if cond.itype == int(Cond.DIRICHLET_FRM_OTR_GOVEQ):
                    rank = cond.other_geq_rank
                    ids = np.asarray(cond.conn_set.id_up, np.int64)
                    exch_T.append(T_np[self.offsets[rank - 1] + ids])
                    exch_k.append(ks[rank - 1][ids])
                else:
                    exch_T.append(np.zeros(m))
                    exch_k.append(np.ones(m))
            g.bc_exch_T = np.concatenate(exch_T)
            g.bc_exch_k = np.concatenate(exch_k)

    def set_soln_prev_clm(self, data):
        self.soln_prev_clm = np.array(data, dtype=np.float64)

    def pre_step_dt(self):
        """ThermalSOEPreStepDT (SystemOfEquationsThermalType.F90:391-409)."""
        self.soln_prev = self.soln_prev_clm
        self.soln = self.soln_prev_clm

    def step_dt(self, dt: float, solver: str = "ksp", nstep: int = 1,
                device="cuda") -> bool:
        """KSP step (SOEBaseStepDT_KSP): assemble from soln_prev, solve,
        PostSolve copies soln -> soln_prev.

        ``solver="block"`` scatters the COO values into per-column
        tridiagonal blocks (``ops/block_structure.py``) and solves them with
        the batched block-Thomas sweep, on ``device`` (the card unless
        ``device="cpu"``).  ``solver="ksp"``, the reference's GMRES(30) +
        ILU(0), is not ported yet (ROADMAP Slice D): install
        ``compile_ksp(mpp)`` instead."""
        if solver != "block":
            raise NotImplementedError(
                f"ThermalSOE.step_dt(solver={solver!r}): the GMRES(30)+"
                "ILU(0) KSP is not ported yet (ROADMAP Slice D); use "
                "solver='block' or compile_ksp(mpp).install()")
        dev = device_of(device)
        T = torch.as_tensor(np.asarray(self.soln_prev, np.float64),
                            device=dev)
        self.exchange_auxvars(T)
        vals_list, b_list, cpl_list = [], [], []
        for g, off in zip(self.goveqns, self.offsets[:-1]):
            Tg = T[off:off + g.mesh.ncells_local][None, :]
            v, b, cpl = g.contributions(Tg, dt, self.cnfac,
                                        getattr(g, "ss_values", np.zeros(0)))
            vals_list.append(v)
            b_list.append(b)
            cpl_list.append(cpl)
        if any(int(c.shape[-1]) for c in cpl_list):
            raise NotImplementedError(
                "block solver does not support cross-GE coupling yet")
        if self._block_tpl is None:
            from mpp_tpu_torch.ops.block_structure import (
                BlockTridiagTemplate, chain_shape)
            rows, cols = [], []
            for g, off in zip(self.goveqns, self.offsets[:-1]):
                r, c = g.coo_coords(off, off)
                rows.append(r)
                cols.append(c)
            rows = np.concatenate(rows)
            cols = np.concatenate(cols)
            ncol, nlev = chain_shape(self.n_total, rows, cols)
            self._block_tpl = BlockTridiagTemplate(ncol, nlev, 1, rows, cols)
        x = self._block_tpl.solve(torch.cat(vals_list, dim=-1)[0],
                                  torch.cat(b_list, dim=-1)[0])
        self.soln = x.reshape(-1).cpu().numpy()
        self.cumulative_linear_iterations += 1
        self.soln_prev = self.soln
        for g, off in zip(self.goveqns, self.offsets[:-1]):
            g.temperature = self.soln[off:off + g.mesh.ncells_local]
        if self.metrics is not None:
            self.metrics.record(step=nstep, dt=dt, converged=True,
                                solver="block", linear_iterations=1)
        return True

    def get_soln(self) -> np.ndarray:
        return np.asarray(self.soln)


class ThermalMPP(MPPBase):
    """Problem facade (mpp_thermal_type) with the 8-step builder contract
    (MultiPhysicsProbBaseType.F90:32-74)."""

    GE_CLASSES = {GEType.THERM_SOIL_TBASED: ThermalSoilGE,
                  GEType.THERM_SNOW_TBASED: ThermalSnowGE,
                  GEType.THERM_SSW_TBASED: ThermalSSWGE}
    SS_COND_TYPES = ()   # routing by COND_BC/COND_SS alone

    def __init__(self):
        super().__init__()
        self.soe = ThermalSOE()

    def add_goveqn(self, ge_type, name, mesh_itype=None, mesh_index=None):
        return super().add_goveqn(ge_type, name, mesh_index)

    def add_coupling_condition(self, ieqn_1, ieqn_2, iregion_1, iregion_2):
        """MPPGovEqnAddCouplingCondition + ThermalMPPUpdatCouplingBCConnections
        (MultiPhysicsProbBaseType.F90:1017-1056,
        MultiPhysicsProbThermal.F90:443-570): a COND_DIRICHLET_FRM_OTR_GOVEQ
        BC on EACH GE whose conn set pairs this GE's region cells (id_dn)
        with the coupled GE's region cells (id_up)."""
        from mpp_tpu_torch.dtypes.regions import region_connection_set

        ge1 = self.soe.goveqns[ieqn_1 - 1]
        ge2 = self.soe.goveqns[ieqn_2 - 1]
        cs1 = region_connection_set(ge1.mesh, iregion_1)
        cs2 = region_connection_set(ge2.mesh, iregion_2)
        if cs1.num_connections != cs2.num_connections:
            raise ValueError("coupling regions differ in size")

        def make(cs_mine, cs_other, other_rank):
            cs = ConnectionSet(
                id_up=np.asarray(cs_other.id_dn, np.int32),
                id_dn=np.asarray(cs_mine.id_dn, np.int32),
                dist_up=np.array(cs_other.dist_dn, np.float64),
                dist_dn=np.array(cs_mine.dist_dn, np.float64),
                area=np.asarray(cs_mine.area),
                itype=np.asarray(cs_mine.itype),
                unit_vec=cs_mine.unit_vec)
            cond = Condition(
                name=f"BC_for_coupling_with_equation_{other_rank}",
                units="[K]", itype=int(Cond.DIRICHLET_FRM_OTR_GOVEQ),
                conn_set=cs)
            cond.ensure_value()
            cond.other_geq_rank = other_rank
            return cond

        ge1.boundary_conditions.append(make(cs1, cs2, ieqn_2))
        ge2.boundary_conditions.append(make(cs2, cs1, ieqn_1))

    def update_condition_conn_distances(self):
        """Refresh every BC/coupling connection's face distances from the
        CURRENT mesh dz (the reference restages VAR_DIST_UP/DN each CLM
        step and rebuilds condition connections,
        MPPThermalTBasedALM_Driver.F90:359-372 + UpdateConditionConnSet).
        Call it after the mesh dz arrays change (variable snow layers,
        standing-water film thickness)."""
        for g in self.soe.goveqns:
            for cond in g.boundary_conditions:
                cs = cond.conn_set
                if cond.itype == int(Cond.DIRICHLET_FRM_OTR_GOVEQ):
                    other = self.soe.goveqns[cond.other_geq_rank - 1]
                    cs.dist_up[:] = 0.5 * other.mesh.dz[cs.id_up]
                    cs.dist_dn[:] = 0.5 * g.mesh.dz[cs.id_dn]
                else:
                    cs.dist_dn[:] = 0.5 * g.mesh.dz[cs.id_dn]

    # CLM-style data staging -------------------------------------------------
    def set_soils(self, filter_thermal, lun_type, watsat, csol, tkmg, tkdry,
                  nlevsoi=None):
        found = [g for g in self.soe.goveqns
                 if g.itype == int(GEType.THERM_SOIL_TBASED)]
        if not found:
            raise RuntimeError("no soil thermal GE")
        found[0].set_soils(filter_thermal, lun_type, watsat, csol, tkmg,
                           tkdry, nlevsoi)

    def set_r_data(self, auxvar_kind, var_type, goveqn_id, data):
        """ThermalSOESetRDataFromCLM analog: stage one variable of GE
        ``goveqn_id`` (numpy, f64)."""
        g = self.soe.goveqns[goveqn_id - 1]
        data = np.array(data, dtype=np.float64)
        if auxvar_kind == AuxVarKind.INTERNAL:
            if var_type == Var.TUNING_FACTOR:
                g.tuning_factor = data
            elif var_type == Var.LIQ_AREAL_DEN:
                g.liq_areal_den = data
            elif var_type == Var.ICE_AREAL_DEN:
                g.ice_areal_den = data
            elif var_type == Var.FRAC:
                g.frac = data
            elif var_type == Var.SNOW_WATER:
                g.snow_water = data
            elif var_type == Var.NUM_SNOW_LYR:
                g.num_snow_layer = data.astype(np.int32)
            elif var_type == Var.ACTIVE:
                g.mesh.set_grid_cell_filter(data != 0)
            else:
                raise NotImplementedError(var_type)
        elif auxvar_kind == AuxVarKind.BC:
            if var_type == Var.BC_SS_CONDITION:
                g.bc_value = data
            elif var_type == Var.ACTIVE:
                g.bc_is_active = data != 0
            elif var_type == Var.FRAC:
                g.bc_frac = data
            elif var_type == Var.DHS_DT:
                g.bc_dhsdT = data
            else:
                raise NotImplementedError(var_type)
        elif auxvar_kind == AuxVarKind.SS:
            if var_type == Var.BC_SS_CONDITION:
                g.ss_values = data
            else:
                raise NotImplementedError(var_type)
        else:
            raise NotImplementedError(auxvar_kind)

"""The column form of the Richards assembly: F and the tridiagonal Jacobian
bands of a batch of soil columns, one pass a call.

A Richards GE qualifies (:func:`column_spec`) when its mesh is one column
of cells joined cell k to cell k + 1 by vertical faces and every piece of
its physics is one the column kernel computes: the smoothed Brooks-Corey
saturation with Mualem relative permeability, the TGDPB01 or constant
density, linear or constant porosity, Darcy fluxes only, boundary faces of
the Dirichlet, seepage or mass-flux kind, and mass-rate sinks, plain or
down-regulated.  The ALM template column is one such GE.

For such a GE, :func:`column_inputs` lays the evaluation's inputs out as
the kernel reads them, in the order of ``ARGS``: each one a tensor of the
state's dtype, per column ``[ncol, m]`` (any strides) or shared by every
column ``[m]``, or None where the call does not read it; a boundary face's
saturation parameters and temperature are None where they are the
adjacent cell's (the ``dyn`` contract).  ``hopper_kernels.
vsfm_column_assemble`` takes them: the kernel
(``csrc/vsfm_assembly_kernels.cu``) on the card, :func:`column_assemble_plain`
on the CPU: ``RichardsGE._eval``'s arithmetic on the same inputs, summed
into F and the bands in ``_eval`` and ``_tri_assemble``'s order.
"""
from __future__ import annotations

import numpy as np
import torch

from mpp_tpu_torch.constants import Cond
from mpp_tpu_torch.ops import eos, satfunc as sf
from mpp_tpu_torch.ops.porosity import (POROSITY_CONSTANT, POROSITY_LINEAR,
                                        PorosityParams)

#: the smoothed Brooks-Corey parameters, cell and boundary side
SBC_FIELDS = ("sat_res", "alpha", "bc_lambda", "sbc_pu", "sbc_ps", "sbc_b2",
              "sbc_b3")
_FACE_ARGS = ("in_dist_up", "in_dist_dn", "in_area", "in_uz")
_BC_ARGS = ("bc_value", "bc_dist_up", "bc_dist_dn", "bc_area", "bc_uz",
            *(f"bc_{f}" for f in SBC_FIELDS), "bc_temperature")
_SS_ARGS = ("ss_value", "ss_pc", "ss_nn")
#: the kernel's arguments (csrc/vsfm_assembly_kernels.cu: ColumnSlot)
ARGS = ("P", "dt", *SBC_FIELDS, "por_base", "por_ref", "por_slope", "perm",
        "vol", "temperature", *_FACE_ARGS, *_BC_ARGS, *_SS_ARGS,
        "accum_prev", "src")
#: what a slot's last axis runs over: cells, internal faces, boundary
#: connections, sinks, or one value a column
EXTENT = {**dict.fromkeys(ARGS, "cells"), "dt": "column",
          **dict.fromkeys(_FACE_ARGS, "faces"),
          **dict.fromkeys(_BC_ARGS, "bc"), **dict.fromkeys(_SS_ARGS, "ss")}
#: the modes: (F, bands)
MODES = {"residual": (True, False), "bands": (False, True),
         "both": (True, True)}
#: the deepest column the kernel takes (its kMaxLevels) and the shared
#: memory a launch may take (its kSmemBytes)
MAX_LEVELS = 256
MAX_SMEM_BYTES = 48 * 1024

_BC_KINDS = {int(Cond.DIRICHLET): 1, int(Cond.SEEPAGE_BC): 1 | 2,
             int(Cond.MASS_FLUX): 4}
_SS_KINDS = {int(Cond.MASS_RATE): 0, int(Cond.DOWNREG_MASS_RATE_CAMPBELL): 1,
             int(Cond.DOWNREG_MASS_RATE_FETCH2): 2}


def _vertical(uv):
    uv = np.asarray(uv, np.float64).reshape(-1, 3)
    return bool((uv[:, :2] == 0.0).all() and (np.abs(uv[:, 2]) == 1.0).all())


class ColumnSpec:
    """The static structure of a column GE, as the kernel and the plain form
    read it: the level count, each boundary connection's cell and kind,
    each sink's cell and kind, the density and porosity models.  The
    kernel's int32 table (each cell's boundary connections and sinks in
    connection order) goes to a device once."""

    def __init__(self, n, bc_cell, bc_code, ss_cell, ss_code, density,
                 linear_porosity):
        self.n = int(n)
        self.bc_cell = np.asarray(bc_cell, np.int64)
        self.bc_code = np.asarray(bc_code, np.int32)
        self.ss_cell = np.asarray(ss_cell, np.int64)
        self.ss_code = np.asarray(ss_code, np.int32)
        self.nbc, self.nss = self.bc_cell.size, self.ss_cell.size
        self.bc_kind = np.array([_BC_KINDS[int(c)] for c in self.bc_code],
                                np.int32)
        self.ss_kind = np.array([_SS_KINDS[int(c)] for c in self.ss_code],
                                np.int32)
        self.density = int(density)
        self.tgdpb01 = self.density == eos.DENSITY_TGDPB01
        self.linear_porosity = bool(linear_porosity)
        self.takes_value = bool((self.bc_kind & 1).any())
        self.downreg = bool((self.ss_kind > 0).any())
        self._tables = {}
        self._idx = {}

    def needs(self, mode):
        """The slots a call in ``mode`` reads, and those it may be given
        (the boundary side's own parameters)."""
        want_F, _ = MODES[mode]
        req = {"P", "dt", *SBC_FIELDS, "por_base", "perm", "vol"}
        if self.linear_porosity:
            req |= {"por_ref", "por_slope"}
        if self.tgdpb01:
            req.add("temperature")
        if self.n > 1:
            req |= {"in_dist_up", "in_dist_dn", "in_area", "in_uz"}
        opt = set()
        if self.nbc:
            req |= {"bc_dist_up", "bc_dist_dn", "bc_area", "bc_uz"}
            if self.takes_value:
                req.add("bc_value")
            opt |= {f"bc_{f}" for f in SBC_FIELDS}
            if self.tgdpb01:
                opt.add("bc_temperature")
        if self.nss and (want_F or self.downreg):
            req.add("ss_value")
        if self.nss and self.downreg:
            req |= {"ss_pc", "ss_nn"}
        if want_F:
            req |= {"accum_prev", "src"}
        return req, opt

    def smem_bytes(self, elem=8):
        """The shared memory of a launch (the kernel's column_smem_values):
        per column of a CTA's tile, six values a cell, six a face, six a
        boundary connection and one a sink."""
        cols = MAX_LEVELS // self.n
        return elem * cols * (6 * self.n + 6 * (self.n - 1) + 6 * self.nbc
                              + self.nss)

    def table(self, device):
        """The kernel's table on ``device``: bc_ptr, bc_list, bc_kind,
        bc_cell, ss_ptr, ss_list, ss_kind (int32)."""
        key = str(device)
        t = self._tables.get(key)
        if t is None:
            parts = []
            for cell, kind in ((self.bc_cell, self.bc_kind),
                               (self.ss_cell, self.ss_kind)):
                order = np.argsort(cell, kind="stable")
                ptr = np.searchsorted(cell[order], np.arange(self.n + 1))
                parts += [ptr, order, kind]
                if cell is self.bc_cell:
                    parts.append(cell)
            t = torch.as_tensor(np.concatenate(parts).astype(np.int32),
                                device=device)
            self._tables[key] = t
        return t

    def index(self, name, device):
        """The boundary connections' ("bc") or sinks' ("ss") cells as a
        long tensor on ``device`` (the plain form's gathers)."""
        key = (name, str(device))
        t = self._idx.get(key)
        if t is None:
            t = torch.as_tensor(getattr(self, f"{name}_cell"), device=device)
            self._idx[key] = t
        return t

    def check(self, arrays, mode):
        """Raise ValueError unless ``arrays`` (in ARGS order) are what a
        call in ``mode`` reads: tensors of P's dtype on P's device, [ncol, m]
        or [m] with m the slot's extent; returns ncol."""
        if mode not in MODES:
            raise ValueError(f"vsfm_column_assemble: mode {mode!r}: "
                             f"expected one of {sorted(MODES)}")
        if len(arrays) != len(ARGS):
            raise ValueError(f"vsfm_column_assemble: {len(arrays)} arrays, "
                             f"expected {len(ARGS)} ({', '.join(ARGS)})")
        P = arrays[0]
        if not isinstance(P, torch.Tensor) or P.dim() != 2 \
                or P.shape[1] != self.n:
            raise ValueError(f"vsfm_column_assemble: P must be [ncol, "
                             f"{self.n}]")
        if P.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"vsfm_column_assemble: dtype {P.dtype}")
        if P.device.type not in ("cpu", "cuda"):
            raise ValueError(f"vsfm_column_assemble: device {P.device}")
        ncol = P.shape[0]
        extent = {"cells": self.n, "faces": self.n - 1, "bc": self.nbc,
                  "ss": self.nss, "column": 1}
        req, opt = self.needs(mode)
        for name, a in zip(ARGS, arrays):
            if a is None:
                if name in req:
                    raise ValueError(f"vsfm_column_assemble: {name} missing "
                                     f"in mode {mode!r}")
                continue
            if name not in req and name not in opt:
                raise ValueError(f"vsfm_column_assemble: {name} is not read "
                                 f"in mode {mode!r}")
            if not isinstance(a, torch.Tensor):
                raise ValueError(f"vsfm_column_assemble: {name}: expected a "
                                 f"tensor, got {type(a)}")
            if a.dtype != P.dtype or a.device != P.device:
                raise ValueError(f"vsfm_column_assemble: {name} is "
                                 f"{a.dtype} on {a.device}, P {P.dtype} on "
                                 f"{P.device}")
            m = extent[EXTENT[name]]
            ok = (a.dim() == 2 and tuple(a.shape) == (ncol, m)) or \
                (a.dim() == 1 and a.shape[0] == m and name != "dt")
            if not ok:
                raise ValueError(f"vsfm_column_assemble: {name} has shape "
                                 f"{tuple(a.shape)}, expected [{ncol}, {m}]"
                                 + ("" if name == "dt" else f" or [{m}]"))
        return ncol


def column_spec(g):
    """The :class:`ColumnSpec` of Richards GE ``g``, or None where its
    structure or physics is outside the column kernel's."""
    mesh = g.mesh
    n = int(mesh.ncells_local)
    if n < 1 or n > MAX_LEVELS or int(mesh.ncells_all) != n \
            or not np.asarray(mesh.is_active, bool).all():
        return None
    ic = g._internal()
    if ic.num_connections != n - 1 \
            or not (np.asarray(ic.id_up) == np.arange(n - 1)).all() \
            or not (np.asarray(ic.id_dn) == np.arange(1, n)).all() \
            or not _vertical(ic.unit_vec):
        return None
    for ca in (g.conn_in, g.conn_bc):
        if ca is not None and ca.any_conductance:
            return None
    sbc = (sf.SAT_FUNC_SMOOTHED_BROOKS_COREY, sf.RELPERM_FUNC_MUALEM)
    bc_ids, _, _, _, _, bc_code = g._bc_concat()
    for params, m in ((g.sat_params, n), (g.bc_sat_params, bc_ids.size)):
        if not ((np.asarray(params.sat_func_type)[:m] == sbc[0]).all()
                and (np.asarray(params.relperm_func_type)[:m]
                     == sbc[1]).all()):
            return None
    if g.density_type not in (eos.DENSITY_CONSTANT, eos.DENSITY_TGDPB01):
        return None
    por_ids = np.asarray(g.por_params.porosity_id)[:n]
    linear = bool((por_ids == POROSITY_LINEAR).all())
    if not (linear or (por_ids == POROSITY_CONSTANT).all()):
        return None
    if not all(int(c) in _BC_KINDS for c in bc_code) \
            or (bc_ids.size and not _vertical(g._bc_unit_vecs())):
        return None
    ss_ids, ss_code = g._ss_concat()
    if not all(int(c) in _SS_KINDS for c in ss_code):
        return None
    spec = ColumnSpec(n, bc_ids, bc_code, ss_ids, ss_code, g.density_type,
                      linear)
    return spec if spec.smem_bytes() <= MAX_SMEM_BYTES else None


def column_inputs(g, spec, P, dt, bc_value, ss_value, accum_prev, src, dyn,
                  mode):
    """The kernel's arguments (ARGS order) for one evaluation of GE ``g``
    in ``mode``, from the compiled stepper's per-GE inputs: the dynamic
    parameters of ``dyn`` where it has them, else ``g``'s staged constants
    (the same as ``RichardsGE._eval`` reads)."""
    want_F, _ = MODES[mode]
    dyn = dyn or {}
    sat_d = dyn.get("sat", {})
    req, _ = spec.needs(mode)
    ref = P
    out = dict.fromkeys(ARGS)
    out["P"], out["dt"] = P, dt
    sp = g._const_obj("sat", ref, lambda: g.sat_params.to(ref.device,
                                                          ref.dtype))
    for f in SBC_FIELDS:
        out[f] = sat_d[f] if f in sat_d else getattr(sp, f)
    pp = g._const_obj("por", ref, lambda: g.por_params.to(ref.device,
                                                          ref.dtype))
    out["por_base"] = dyn["por_base"] if "por_base" in dyn \
        else pp.porosity_base
    if spec.linear_porosity:
        out["por_ref"], out["por_slope"] = (pp.pressure_reference,
                                            pp.lin_mod_slope)
    out["perm"] = dyn["perm"][..., 2] if "perm" in dyn else g._const(
        ("column", "perm_z"), ref, lambda: g.perm[:spec.n, 2])
    out["vol"] = dyn["vol"] if "vol" in dyn else g._const(
        "vol", ref, lambda: g.mesh.vol)
    if "temperature" in req:
        out["temperature"] = dyn["temperature"] if "temperature" in dyn \
            else g._staged("temperature", ref)
    if spec.n > 1:
        for key, fld in (("in_dist_up", "dist_up"), ("in_dist_dn", "dist_dn"),
                         ("in_area", "area")):
            out[key] = dyn[key] if key in dyn else g._const(
                key, ref, lambda f=fld: getattr(g._internal(), f))
        out["in_uz"] = g._const("in_uz", ref,
                                lambda: g._internal().unit_vec[:, 2])
    if spec.nbc:
        if spec.takes_value:
            out["bc_value"] = bc_value if bc_value is not None else \
                torch.as_tensor(g.bc_value, dtype=ref.dtype,
                                device=ref.device)
        for key, i in (("bc_dist_up", 1), ("bc_dist_dn", 2),
                       ("bc_area", 3)):
            out[key] = dyn[key] if key in dyn else g._const(
                key, ref, lambda i=i: g._bc_concat()[i])
        out["bc_uz"] = g._const("bc_uz", ref, lambda: g._bc_concat()[4])
        bsp = g._const_obj("bc_sat", ref, lambda: g.bc_sat_params.to(
            ref.device, ref.dtype))
        for f in SBC_FIELDS:
            # dynamic parameters: the BC auxvars inherit the cell's
            if f not in sat_d:
                out[f"bc_{f}"] = getattr(bsp, f)
        if "temperature" in req:
            if "bc_temperature" in dyn:
                out["bc_temperature"] = dyn["bc_temperature"]
            elif "temperature" not in dyn:
                out["bc_temperature"] = g._staged("bc_temperature", ref)
    if "ss_value" in req:
        out["ss_value"] = ss_value if ss_value is not None else \
            torch.as_tensor(g.ss_value, dtype=ref.dtype, device=ref.device)
    if spec.nss and spec.downreg:
        out["ss_pc"] = g._const("ss_pc", ref, lambda: g.ss_pot_sink_pressure)
        out["ss_nn"] = g._const("ss_nn", ref, lambda: g.ss_pot_sink_exponent)
    if want_F:
        out["accum_prev"] = accum_prev if accum_prev is not None else \
            torch.as_tensor(g.accum_prev, dtype=ref.dtype, device=ref.device)
        out["src"] = src
    return [out[a] for a in ARGS]


def _sbc_params(fields, m):
    """SatParams of m smoothed Brooks-Corey cells from the SBC ``fields``
    (dict of tensors; the other models' fields unused)."""
    kw = {k: fields.get(k, 0.0) for k in sf._REAL_FIELDS}
    return sf.SatParams(
        sat_func_type=np.full(m, sf.SAT_FUNC_SMOOTHED_BROOKS_COREY, np.int32),
        relperm_func_type=np.full(m, sf.RELPERM_FUNC_MUALEM, np.int32), **kw)


def _por_params(spec, m, base=0.0, ref=0.0, slope=0.0):
    model = POROSITY_LINEAR if spec.linear_porosity else POROSITY_CONSTANT
    return PorosityParams(porosity_id=np.full(m, model, np.int32),
                          porosity_base=base, pressure_reference=ref,
                          lin_mod_slope=slope)


def column_assemble_plain(spec, mode, *arrays):
    """The plain form of ``vsfm_column_assemble``: ``RichardsGE._eval``'s
    arithmetic (``richards_aux``, ``darcy_flux``, ``_ss_factors``) on the
    kernel's inputs, summed into F and the bands in ``_eval`` and
    ``_tri_assemble``'s order.  Returns F, (dl, d, du), or (F, (dl, d, du))
    by ``mode``."""
    # models.richards imports the kernels' module (through ops.snes), which
    # imports this one: its functions are taken at the call
    from mpp_tpu_torch.models.richards import (_ss_factors, _swhere,
                                               darcy_flux, richards_aux)
    want_F, want_J = MODES[mode]
    a = dict(zip(ARGS, arrays))
    P, dt, n = a["P"], a["dt"], spec.n
    one = torch.ones((), dtype=P.dtype, device=P.device)
    temp = a["temperature"] if a["temperature"] is not None else P
    sp = _sbc_params({f: a[f] for f in SBC_FIELDS}, n)
    pp = _por_params(spec, n, a["por_base"],
                     *((a["por_ref"], a["por_slope"])
                       if spec.linear_porosity else ()))
    (sat, dsat, kr, dkr, den, dden, vis, dvis, por, dpor) = richards_aux(
        P, sp, pp, temp, one, spec.density)
    perm, vol = a["perm"], a["vol"]
    F = d = None
    if want_F:
        F = por * den * sat * vol / dt - a["accum_prev"]
    if want_J:
        d = torch.zeros_like(P)
        dl, du = torch.zeros_like(P), torch.zeros_like(P)
    if n > 1:
        flux, dfu, dfd = darcy_flux(
            P[:, :-1], P[:, 1:], kr[:, :-1], kr[:, 1:], dkr[:, :-1],
            dkr[:, 1:], den[:, :-1], den[:, 1:], dden[:, :-1], dden[:, 1:],
            vis[:, :-1], vis[:, 1:], dvis[:, :-1], dvis[:, 1:],
            perm[..., :-1], perm[..., 1:], a["in_dist_up"], a["in_dist_dn"],
            a["in_area"], a["in_uz"], internal=True)
        if want_F:
            F[:, :-1] = F[:, :-1] + -flux
            F[:, 1:] = F[:, 1:] + flux
        if want_J:
            d[:, :-1] = d[:, :-1] + -dfu
            d[:, 1:] = d[:, 1:] + dfd
            du[:, :-1] = du[:, :-1] + -dfd
            dl[:, 1:] = dl[:, 1:] + dfu
    if spec.nbc:
        cells = spec.index("bc", P.device)
        Pc = P[:, cells]
        P_bc = _swhere(spec.bc_kind & 1, a["bc_value"], Pc)
        sp_b = _sbc_params({f: a[f"bc_{f}"] if a[f"bc_{f}"] is not None
                            else a[f][..., cells] for f in SBC_FIELDS},
                           spec.nbc)
        temp_b = a["bc_temperature"] if a["bc_temperature"] is not None \
            else temp[..., cells]
        (_, _, kr_b, dkr_b, den_b, dden_b, vis_b, dvis_b, _, _) = \
            richards_aux(P_bc, sp_b, _por_params(spec, spec.nbc), temp_b,
                         one, spec.density)
        perm_c = perm[..., cells]
        flux_b, _, dfd_b = darcy_flux(
            P_bc, Pc, kr_b, kr[:, cells], dkr_b, dkr[:, cells], den_b,
            den[:, cells], dden_b, dden[:, cells], vis_b, vis[:, cells],
            dvis_b, dvis[:, cells], perm_c, perm_c, a["bc_dist_up"],
            a["bc_dist_dn"], a["bc_area"], a["bc_uz"], internal=False,
            cond_kind=spec.bc_code,
            seepage_mask=spec.bc_code == int(Cond.SEEPAGE_BC))
        if want_F:
            F = F.index_add(1, cells, flux_b)
        if want_J:
            d = d.index_add(1, cells, dfd_b)
    if spec.nss and a["ss_value"] is not None:
        cells = spec.index("ss", P.device)
        contrib, ss_vals = _ss_factors(P[:, cells], a["ss_value"],
                                       a["ss_pc"], a["ss_nn"], spec.ss_code)
        if want_F:
            F = F.index_add(1, cells, -contrib)
        if want_J:
            d = d.index_add(1, cells, ss_vals)
    if want_F:
        F = F - a["src"]
    if want_J:
        d = d + (dpor * den * sat + por * dden * sat
                 + por * den * dsat) * vol / dt
        bands = (dl, d, du)
    return F if not want_J else bands if not want_F else (F, bands)


__all__ = ["ARGS", "MODES", "MAX_LEVELS", "ColumnSpec", "column_spec",
           "column_inputs", "column_assemble_plain"]

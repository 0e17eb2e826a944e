"""Canopy radiation transfer: shortwave and longwave GEs (KSP path).

Counterpart of ``mpp_tpu/models/radiation.py``, a reimplementation of:

* ``ge/GoveqnShortwave.F90`` — two-band (vis/nir) two-stream canopy
  shortwave: dof=4 per cell [Iup_vis, Idn_vis, Iup_nir, Idn_nir]; auxvar
  coefficients e/f/rad_source per band (``auxvar/ShortwaveAuxType.F90:
  131-169``); post-solve absorbed-radiation recovery (:532-602).
* ``ge/GoveqnLongwave.F90`` — single-band longwave with absorbed flux as a
  third dof [Iup, Idn, Iabs]; auxvar coefficients
  (``auxvar/LongwaveAuxType.F90:89-137``).

The layer graph is a vertical column (soil cell at the bottom, canopy
layers above, Dirichlet sky forcing at the top).  Both systems assemble a
banded CSR matrix; the serial ``step_dt`` solves it with the port's
PETSc-default GMRES + ILU(0) (``ops/ilu.py``) on the GE's device, and
``solver="block"`` with the exact batched block-Thomas sweep.  The GE
fields are f64 tensors on the GE's device (a caller may stage other
dtypes; the arithmetic promotes as the JAX form's does).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from mpp_tpu_torch.constants import GEType, STEFAN_BOLTZMAN_CONSTANT
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.dtypes.conditions import Condition
from mpp_tpu_torch.dtypes.mesh import (Mesh, ConnectionSet,
                                       concat_connection_sets)
from mpp_tpu_torch.dtypes.mpp_base import MPPBase
from mpp_tpu_torch.ops.ilu import ILU0, petsc_gmres
from mpp_tpu_torch.ops.sparse import csr_template, CSRTemplate


def _solve_ksp(template: CSRTemplate, coo_vals, b, ilu_cache, sync=None):
    data = template.assemble(coo_vals)
    if ilu_cache.get("ilu") is None:
        ilu_cache["ilu"] = ILU0(template.indptr, template.indices)
    ilu = ilu_cache["ilu"]
    lu = ilu.factor(data)
    x, iters, conv = petsc_gmres(template.indptr, template.indices, data,
                                 b, pc=ilu, pc_data=lu, sync=sync)
    return x, iters, conv


def _top_bot(mesh: Mesh, cs: ConnectionSet):
    """Per-connection (bottom cell, top cell) by z comparison
    (GoveqnShortwave.F90:400-417)."""
    z = mesh.zc
    up, dn = cs.id_up, cs.id_dn
    up_is_top = z[up] > z[dn]
    bot = np.where(up_is_top, dn, up)
    top = np.where(up_is_top, up, dn)
    return bot, top


class _RadiationGE:
    """Device helpers shared by the two radiation GEs."""

    def __post_init__(self):
        self.device = device_of(self.device)

    def _ix(self, key, make):
        """The index tensor ``make()`` (numpy) on the GE's device, made
        once per key."""
        cache = self.__dict__.setdefault("_index_cache", {})
        if key not in cache:
            cache[key] = torch.as_tensor(np.asarray(make(), np.int64),
                                         device=self.device)
        return cache[key]

    def _conns(self):
        ic = concat_connection_sets(self.mesh.intrn_conn_sets)
        return _top_bot(self.mesh, ic)

    def _zeros(self, *shape):
        return torch.zeros(shape, dtype=torch.float64, device=self.device)

    def _ones(self, n):
        return torch.ones(n, dtype=torch.float64, device=self.device)

    def _of_soil(self, key, make):
        """A tensor made from ``is_soil`` by ``make`` on the GE's device,
        made again when the caller assigns another ``is_soil`` array."""
        cache = self.__dict__.setdefault("_soil_cache", {})
        hit = cache.get(key)
        if hit is None or hit[0] is not self.is_soil:
            hit = (self.is_soil, torch.as_tensor(make(self.is_soil),
                                                 device=self.device))
            cache[key] = hit
        return hit[1]

    def _soil(self):
        return self._of_soil("soil", lambda s: np.asarray(s, bool))

    def _soil_cells(self, leaf=False):
        n = self.mesh.ncells_local
        return self._of_soil(("cells", leaf), lambda s: np.nonzero(
            ~s[:n] if leaf else s[:n])[0].astype(np.int64))

    @staticmethod
    def _cat(vals):
        """Concatenate in the promoted dtype, f64 at least (as
        ``jnp.concatenate`` with the f64 ones of the JAX form)."""
        dt = torch.float64
        for v in vals:
            dt = torch.promote_types(dt, v.dtype)
        return torch.cat([v.to(dt) for v in vals])


@dataclasses.dataclass
class ShortwaveGE(_RadiationGE):
    """GE_SHORTWAVE (dof=4: [Iup_b1, Idn_b1, Iup_b2, Idn_b2])."""
    name: str
    mesh: Mesh
    itype: int = int(GEType.SHORTWAVE)
    dof: int = 4
    nband: int = 2
    nleaf: int = 2
    boundary_conditions: List[Condition] = dataclasses.field(
        default_factory=list)
    device: torch.device | str = "cuda"

    def allocate_auxvars(self):
        n = self.mesh.ncells_all
        nb = self.nband
        self.is_soil = np.zeros(n, bool)
        z = self._zeros
        self.Iskyb = z(n, nb)
        self.Iskyd = z(n, nb)
        self.leaf_rho = z(n, nb)
        self.leaf_tau = z(n, nb)
        self.leaf_omega = z(n, nb)
        self.leaf_td = z(n)
        self.leaf_tb = z(n)
        self.leaf_tbcum = z(n)
        self.leaf_dpai = z(n)
        self.leaf_fssh = z(n, self.nleaf)
        self.soil_albedo_b = z(n, nb)
        self.soil_albedo_d = z(n, nb)
        nbc = sum(c.num_connections for c in self.boundary_conditions)
        self.bc_Iskyb = z(nbc, nb)
        self.bc_Iskyd = z(nbc, nb)
        self.Iup = z(n, nb)
        self.Idn = z(n, nb)
        self.Iabs_leaf = z(n, self.nleaf * nb)
        self.Iabs_soil = z(n, nb)

    def aux(self):
        """e, f, rad_source [n, nband] (ShortwaveAuxVarCompute)."""
        soil = self._soil()[:, None]
        aa = (1.0 - self.leaf_td)[:, None] * self.leaf_rho
        bb = (1.0 - self.leaf_td)[:, None] * self.leaf_tau \
            + self.leaf_td[:, None]
        aa_safe = torch.where(aa == 0, 1.0, aa)
        f_leaf = aa - bb * bb / aa_safe
        e_leaf = bb / aa_safe
        rs_leaf = self.Iskyb * (self.leaf_tbcum
                                * (1.0 - self.leaf_tb))[:, None]
        f_soil = self.soil_albedo_b
        e_soil = torch.zeros_like(f_soil)
        rs_soil = self.Iskyb * self.leaf_tbcum[:, None] * self.soil_albedo_d
        e = torch.where(soil, e_soil, e_leaf)
        f = torch.where(soil, f_soil, f_leaf)
        rs = torch.where(soil, rs_soil, rs_leaf)
        return e, f, rs

    # dof helpers: 0-based dof index of (cell, band, which) with which
    # 0=Iup, 1=Idn
    def _idx(self, cells, band, which):
        return cells * self.dof + band * self.nband + which

    def coo_coords(self):
        n = self.mesh.ncells_local
        bot, top = self._conns()
        rows, cols = [np.arange(n * self.dof)], [np.arange(n * self.dof)]
        soil_cells = np.nonzero(self.is_soil)[0]
        for band in range(self.nband):
            r = self._idx(soil_cells, band, 0)
            rows.append(r)
            cols.append(r + 1)
            # connection entries (4 per conn per band)
            rows += [self._idx(bot, band, 1), self._idx(top, band, 0),
                     self._idx(bot, band, 1), self._idx(top, band, 0)]
            cols += [self._idx(bot, band, 0), self._idx(top, band, 1),
                     self._idx(top, band, 0), self._idx(bot, band, 1)]
        return np.concatenate(rows), np.concatenate(cols)

    def matrix_values(self):
        n = self.mesh.ncells_local
        e, f, rs = self.aux()
        soil_cells = self._soil_cells()
        topj = self._ix("top", lambda: self._conns()[1])
        vals = [self._ones(n * self.dof)]
        for band in range(self.nband):
            vals.append(-f[soil_cells, band])
            ftop = -f[topj, band]
            etop = -e[topj, band]
            vals += [ftop, ftop, etop, etop]
        return self._cat(vals)

    def rhs(self):
        n = self.mesh.ncells_local
        e, f, rs = self.aux()
        b = self._zeros(n * self.dof)
        soil = self._soil()
        for band in range(self.nband):
            up_idx = self._ix(("up", band), lambda: np.arange(n) * self.dof
                              + band * self.nband)
            b[up_idx] = torch.where(
                soil, rs[:, band],
                rs[:, band] * (self.leaf_rho[:, band]
                               - self.leaf_tau[:, band] * e[:, band])
            ).to(b.dtype)
        topj = self._ix("top", lambda: self._conns()[1])
        for band in range(self.nband):
            dn_idx = self._ix(("dn", band), lambda: self._conns()[0]
                              * self.dof + band * self.nband + 1)
            b[dn_idx] = (rs[topj, band]
                         * (self.leaf_tau[topj, band]
                            - self.leaf_rho[topj, band] * e[topj, band])
                         ).to(b.dtype)
        off = 0
        for ic, cond in enumerate(self.boundary_conditions):
            m = cond.conn_set.num_connections
            for band in range(self.nband):
                idx = self._ix(("bc", ic, band),
                               lambda: cond.conn_set.id_dn * self.dof
                               + band * self.nband + 1)
                b[idx] = self.bc_Iskyd[off:off + m, band].to(b.dtype)
            off += m
        return b

    def save_soln(self, x):
        n = self.mesh.ncells_local
        x = x.reshape(n, self.dof)
        self.Iup = x[:, 0::2]
        self.Idn = x[:, 1::2]

    def post_solve(self):
        """Absorbed radiation recovery (ShortwavePostSolve:532-602)."""
        n = self.mesh.ncells_local
        soil = self._soil()[:, None]
        # diffuse absorbed: soil: (1-albedo_d)*Idn ; leaf: (1-td)(1-omega)*
        # (Idn_self + Iup_below)
        topj = self._ix("top", lambda: self._conns()[1])
        botj = self._ix("bot", lambda: self._conns()[0])
        Iup_below = self._zeros(n, self.nband)
        Iup_below[topj] = self.Iup[botj].to(Iup_below.dtype)
        diffuse_soil = (1.0 - self.soil_albedo_d) * self.Idn
        diffuse_leaf = ((1.0 - self.leaf_td)[:, None]
                        * (1.0 - self.leaf_omega)
                        * (self.Idn + Iup_below))
        direct_soil = (self.Iskyb * self.leaf_tbcum[:, None]
                       * (1.0 - self.soil_albedo_b))
        direct_leaf = (self.Iskyb
                       * (self.leaf_tbcum * (1.0 - self.leaf_tb))[:, None]
                       * (1.0 - self.leaf_omega))
        self.Iabs_soil = torch.where(soil, diffuse_soil + direct_soil, 0.0)
        sun = diffuse_leaf * self.leaf_fssh[:, 0:1] + direct_leaf
        shade = diffuse_leaf * self.leaf_fssh[:, 1:2]
        denom_sun = self.leaf_fssh[:, 0:1] * self.leaf_dpai[:, None]
        denom_shade = self.leaf_fssh[:, 1:2] * self.leaf_dpai[:, None]
        abs_sun = torch.where(
            denom_sun > 0, sun / torch.where(denom_sun == 0, 1.0, denom_sun),
            0.0)
        abs_shade = torch.where(
            denom_shade > 0,
            shade / torch.where(denom_shade == 0, 1.0, denom_shade), 0.0)
        # layout [band0_sun, band0_shade, band1_sun, band1_shade]
        iabs = torch.stack([abs_sun[:, 0], abs_shade[:, 0],
                            abs_sun[:, 1], abs_shade[:, 1]], dim=1)
        self.Iabs_leaf = torch.where(soil, 0.0, iabs)


@dataclasses.dataclass
class LongwaveGE(_RadiationGE):
    """GE_LONGWAVE (dof=3: [Iup, Idn, Iabs])."""
    name: str
    mesh: Mesh
    itype: int = int(GEType.LONGWAVE)
    dof: int = 3
    nleaf: int = 1  # GoveqnLongwave.F90:66
    boundary_conditions: List[Condition] = dataclasses.field(
        default_factory=list)
    device: torch.device | str = "cuda"

    def allocate_auxvars(self):
        n = self.mesh.ncells_all
        z = self._zeros
        self.is_soil = np.zeros(n, bool)
        self.trans = z(n)
        self.leaf_rho = z(n)
        self.leaf_tau = z(n)
        self.leaf_emiss = z(n)
        self.leaf_temperature = z(n, self.nleaf)
        self.leaf_fssh = z(n, self.nleaf)
        self.leaf_dpai = z(n, self.nleaf)
        self.ground_temperature = z(n)
        self.ground_emiss = z(n)
        nbc = sum(c.num_connections for c in self.boundary_conditions)
        self.bc_Idn = z(nbc)
        self.Iup = z(n)
        self.Idn = z(n)
        self.Iabs = z(n)

    def aux(self):
        """(e, f, rad_source) per cell (LongwaveAuxVarCompute)."""
        soil = self._soil()
        aa = (1.0 - self.trans) * self.leaf_tau + self.trans
        bb = (1.0 - self.trans) * self.leaf_rho
        bb_safe = torch.where(bb == 0, 1.0, bb)
        e = aa / bb_safe
        f_leaf = bb - aa * aa / bb_safe
        f_soil = 1.0 - self.ground_emiss
        rs_soil = (STEFAN_BOLTZMAN_CONSTANT * self.ground_emiss
                   * self.ground_temperature ** 4.0)
        rs_leaf = torch.sum(self.leaf_emiss[:, None]
                            * STEFAN_BOLTZMAN_CONSTANT
                            * self.leaf_temperature ** 4.0 * self.leaf_fssh,
                            dim=1) * (1.0 - self.trans)
        f = torch.where(soil, f_soil, f_leaf)
        rs = torch.where(soil, rs_soil, rs_leaf)
        return e, f, rs

    def coo_coords(self):
        n = self.mesh.ncells_local
        bot, top = self._conns()
        d = self.dof
        soil_cells = np.nonzero(self.is_soil[:n])[0]
        leaf_cells = np.nonzero(~self.is_soil[:n])[0]
        rows = [np.arange(n * d)]
        cols = [np.arange(n * d)]
        # soil: (Iup,Idn), (Iabs,Iup), (Iabs,Idn)
        rows += [soil_cells * d, soil_cells * d + 2, soil_cells * d + 2]
        cols += [soil_cells * d + 1, soil_cells * d, soil_cells * d + 1]
        # leaf: (Iabs, Idn)
        rows += [leaf_cells * d + 2]
        cols += [leaf_cells * d + 1]
        # conns: (Idn_bot, Iup_bot), (Iup_top, Idn_top),
        #        (Idn_bot, Iup_top), (Iup_top, Idn_bot), (Iabs_top, Iup_bot)
        rows += [bot * d + 1, top * d, bot * d + 1, top * d, top * d + 2]
        cols += [bot * d, top * d + 1, top * d, bot * d + 1, bot * d]
        return np.concatenate(rows), np.concatenate(cols)

    def matrix_values(self):
        n = self.mesh.ncells_local
        e, f, rs = self.aux()
        soil_cells = self._soil_cells()
        leaf_cells = self._soil_cells(leaf=True)
        topj = self._ix("top", lambda: self._conns()[1])
        em_t = -self.leaf_emiss * (1.0 - self.trans)
        ns = soil_cells.shape[0]
        return self._cat([self._ones(n * self.dof),
                -f[soil_cells],
                self._ones(ns),
                -self._ones(ns),
                em_t[leaf_cells],
                -f[topj], -f[topj], -e[topj], -e[topj],
                em_t[topj]])

    def rhs(self):
        n = self.mesh.ncells_local
        e, f, rs = self.aux()
        soil = self._soil()
        b = self._zeros(n * self.dof)
        up_idx = self._ix("up", lambda: np.arange(n) * self.dof)
        b[up_idx] = torch.where(soil, rs, (1.0 - e) * rs).to(b.dtype)
        b[up_idx + 2] = torch.where(soil, 0.0, -2.0 * rs).to(b.dtype)
        topj = self._ix("top", lambda: self._conns()[1])
        dn_idx = self._ix("dn", lambda: self._conns()[0] * self.dof + 1)
        b[dn_idx] = ((1.0 - e[topj]) * rs[topj]).to(b.dtype)
        off = 0
        for ic, cond in enumerate(self.boundary_conditions):
            m = cond.conn_set.num_connections
            idx = self._ix(("bc", ic),
                           lambda: cond.conn_set.id_dn * self.dof + 1)
            b[idx] = self.bc_Idn[off:off + m].to(b.dtype)
            off += m
        return b

    def save_soln(self, x):
        n = self.mesh.ncells_local
        x = x.reshape(n, self.dof)
        self.Iup, self.Idn, self.Iabs = x[:, 0], x[:, 1], x[:, 2]


class _RadiationMPPBase(MPPBase):
    """Shared facade for the single-GE KSP canopy problems; the GE's
    tensors live on ``device`` (the card unless ``device="cpu"``).
    ``host_syncs`` counts the host reads of the serial KSP's GMRES
    predicates."""

    GE_CLS = None

    def __init__(self, device="cuda"):
        super().__init__()
        self.device = device_of(device)
        self.goveqns = []
        self._ilu_cache = {}
        self.template: Optional[CSRTemplate] = None
        self.block_template = None
        self.cumulative_linear_iterations = 0
        self.metrics = None
        self.host_syncs = 0

    def _sync(self, value):
        """Read a device predicate on the host (one counted sync)."""
        self.host_syncs += 1
        return bool(value.item())

    @property
    def soe(self):
        return self

    def _goveqns(self):
        return self.goveqns

    def add_goveqn(self, name="ge", mesh_index=None):
        idx = mesh_index if mesh_index is not None else len(self.goveqns)
        ge = self.GE_CLS(name=name, mesh=self.meshes[idx],
                         device=self.device)
        self.goveqns.append(ge)
        return len(self.goveqns)

    def setup_problem(self):
        pass

    def step_dt(self, dt, istep=1, solver="ksp"):
        """One KSP step.  ``solver="ksp"`` is the golden-parity path
        (GMRES+ILU(0) iterate, as PETSc records it); ``solver="block"``
        is the batched production form — the same COO values scattered
        into per-column block-tridiagonal form and solved exactly with the
        batched block-Thomas sweep (ops/block_structure.py)."""
        ge = self.goveqns[0]
        vals = ge.matrix_values()
        b = ge.rhs()
        if solver == "block":
            if self.block_template is None:
                from mpp_tpu_torch.ops.block_structure import \
                    BlockTridiagTemplate
                r, c = ge.coo_coords()
                nlev = ge.mesh.nlev
                ncol = ge.mesh.ncells_local // nlev
                self.block_template = BlockTridiagTemplate(ncol, nlev,
                                                           ge.dof, r, c)
            x = self.block_template.solve(vals, b).reshape(-1)
            conv, iters = True, 1
        else:
            if self.template is None:
                r, c = ge.coo_coords()
                n = ge.mesh.ncells_local * ge.dof
                self.template = csr_template(n, n, r, c)
            x, iters, conv = _solve_ksp(self.template, vals, b,
                                        self._ilu_cache, sync=self._sync)
        self.cumulative_linear_iterations += iters
        ge.save_soln(x)
        if hasattr(ge, "post_solve"):
            ge.post_solve()
        if self.metrics is not None:
            self.metrics.record(step=istep, dt=dt, converged=bool(conv),
                                solver=solver, linear_iterations=int(iters))
        return bool(conv), 0


class ShortwaveMPP(_RadiationMPPBase):
    GE_CLS = ShortwaveGE


class LongwaveMPP(_RadiationMPPBase):
    GE_CLS = LongwaveGE

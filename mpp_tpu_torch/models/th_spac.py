"""Multi-mesh coupled TH system of equations (SPAC network).

Counterpart of ``mpp_tpu/models/th_spac.py``: the reference's
th_manoli2014 configuration (``src/driver/standalone/thermal-e/
th_manoli2014_problem.F90``) carries N meshes, each with a Richards mass
GE and an enthalpy energy GE (:818-861), coupled on each mesh (P and T
shared, :865-890) and across meshes at coupling connections (soil<->root
over every root layer, root<->xylem at the junction; :891-967).

As in the JAX package:

* Each cross-mesh coupling flux is evaluated once per connection with
  internal-connection weighting and added with opposite signs to both
  sides, which conserves exactly (the reference's swapped per-GE
  boundary conditions are not exactly antisymmetric, KNOWN_GAPS #7).
* The Jacobian of the coupled residual is a colored forward-mode one: the
  structural sparsity (each mesh's two-point stencil in the 2x2 {P, T}
  blocks plus the coupling pairs) is distance-2 greedy-colored once on
  the host, and each Newton iteration evaluates ``ncolors`` JVPs
  (``torch.func.vmap`` over ``torch.func.jvp``) of the residual into a
  compressed Jacobian, gathered into the CSR template.
* The stepper is the JAX module's own: a Newton with a simple halving
  backtracking (at most 12 halvings, sufficient decrease ``1e-4 * lam``)
  inside a dt-cut ladder that gives up past 20 cuts; one ILU(0) factor
  and one GMRES solve at rtol 1e-12 a Newton iteration.  ILU(0) of the
  network has 200 levels a sweep at scale 1 and 2000 at scale 10, each a
  few small kernels.

The residual is a pure function of the state, the previous accumulation
and dt: the mass GEs take the temperature through their ``dyn`` argument
and the accumulations as arguments, so nothing is stored on a GE while
the JVPs run.  The solution lives in host numpy (``soln``); the residual,
the Jacobian and the linear solve run on ``device`` (the card unless
``"cpu"``), and ``host_syncs`` counts the solver's device-to-host reads.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import List

import numpy as np
import torch

from mpp_tpu_torch.constants import GEType, SOEType
from mpp_tpu_torch.dtypes.mpp_base import MPPBase
from mpp_tpu_torch.models.richards import RichardsGE, _swhere, darcy_flux
from mpp_tpu_torch.models.thermal_enthalpy import (ThermalEnthalpyGE,
                                                   enthalpy_flux)
from mpp_tpu_torch.ops.ilu import ILU0, petsc_gmres
from mpp_tpu_torch.ops.snes import HostSyncs
from mpp_tpu_torch.ops.sparse import csr_template

F64 = torch.float64


@dataclasses.dataclass
class CouplingConnSet:
    """A cross-mesh two-point coupling set between mesh pair (ia, ib).

    The flux is evaluated with side b in the 'up' slot and side a in the
    'dn' slot; ``unit_z`` is the up->dn unit vector's z-component (the
    b->a direction), so gravity enters exactly as for an internal
    connection."""
    ia: int
    ib: int
    cells_a: np.ndarray
    cells_b: np.ndarray
    dist_a: np.ndarray     # dn-side half distance
    dist_b: np.ndarray     # up-side half distance
    area: np.ndarray
    unit_z: np.ndarray


def color_columns(indptr, indices, row_ids):
    """Distance-2 greedy coloring of a CSR pattern's columns (two columns
    conflict if a row holds both), column by column in index order, the
    smallest free color each: returns ``color`` [n] (int64)."""
    nn = len(indptr) - 1
    rows_of_col = [[] for _ in range(nn)]
    for e in range(indices.size):
        rows_of_col[indices[e]].append(row_ids[e])
    cols_of_row = [indices[indptr[r]:indptr[r + 1]] for r in range(nn)]
    color = np.full(nn, -1, np.int64)
    for j in range(nn):
        forbidden = set()
        for r in rows_of_col[j]:
            for j2 in cols_of_row[r]:
                if color[j2] >= 0:
                    forbidden.add(int(color[j2]))
        k = 0
        while k in forbidden:
            k += 1
        color[j] = k
    return color


class THSpacSoE:
    """N-pair coupled TH Newton solve on X = [P_1..P_N; T_1..T_N]."""

    #: device of the residual, the Jacobian and the linear solve
    device = "cuda"

    def __init__(self):
        self.mass_ges: List[RichardsGE] = []
        self.energy_ges: List[ThermalEnthalpyGE] = []
        self.couplings: List[CouplingConnSet] = []
        self.itype = int(SOEType.TH)
        self.soln = None
        self.soln_prev = None
        self.use_dynamic_linesearch = False
        self.snes_stol = 1e-10
        self.rtol = 1e-8
        self.atol = 1e-50
        self.max_it = 50
        self.cumulative_newton_iterations = 0
        self.cumulative_linear_iterations = 0
        self.metrics = None          # optional io.metrics.MetricsStream
        self.syncs = HostSyncs()
        self._jac_plan = None
        self._dev = {}

    @property
    def goveqns(self):
        return list(self.mass_ges) + list(self.energy_ges)

    @property
    def host_syncs(self):
        return self.syncs.n

    def setup(self):
        sizes = [g.mesh.ncells_local for g in self.mass_ges]
        self.sizes = sizes
        self.offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int)
        self.ntot = int(self.offsets[-1])
        self.soln = np.zeros(2 * self.ntot)
        self.soln_prev = np.zeros(2 * self.ntot)
        self._jac_plan = None
        self._dev = {}

    # -- sparse Jacobian plan (built lazily after couplings exist) ---------
    def _build_jac_plan(self):
        """Structural sparsity, distance-2 column coloring and CSR template
        (host numpy, the JAX module's construction in the same order)."""
        rows, cols = [], []
        for i, (gm, ge) in enumerate(zip(self.mass_ges, self.energy_ges)):
            off = int(self.offsets[i])
            for g in (gm, ge):
                r, c = g.coo_coords(off, off)
                rows.append(r.astype(np.int64))
                cols.append(c.astype(np.int64))
        for c_ in self.couplings:
            a = self.offsets[c_.ia] + np.asarray(c_.cells_a, np.int64)
            b = self.offsets[c_.ib] + np.asarray(c_.cells_b, np.int64)
            rows += [a, b]
            cols += [b, a]
        rows = np.concatenate(rows)
        cols = np.concatenate(cols)
        n = self.ntot
        R = np.concatenate([rows, rows, rows + n, rows + n])
        C = np.concatenate([cols, cols + n, cols, cols + n])
        tpl = csr_template(2 * n, 2 * n, R, C)
        row_ids = tpl.row_ids()
        color = color_columns(tpl.indptr, tpl.indices, row_ids)
        ncolors = int(color.max()) + 1
        seeds = np.zeros((ncolors, 2 * n))
        seeds[color, np.arange(2 * n)] = 1.0
        self._jac_plan = {
            "tpl": tpl,
            "color": color,
            "entry_row": row_ids.astype(np.int64),
            "entry_color": color[tpl.indices].astype(np.int64),
            "seeds": seeds,
            "ncolors": ncolors,
            "ilu": ILU0(tpl.indptr, tpl.indices),
        }
        self._dev = {}

    def _consts(self, device):
        """The plan's and the couplings' index and geometry arrays as
        tensors on ``device`` (built once a device)."""
        key = str(device)
        d = self._dev.get(key)
        if d is None:
            if self._jac_plan is None:
                self._build_jac_plan()
            plan = self._jac_plan
            t = lambda a, dt=F64: torch.as_tensor(np.asarray(a), dtype=dt,
                                                  device=device)
            d = {"seeds": t(plan["seeds"]),
                 "entry_row": t(plan["entry_row"], torch.long),
                 "entry_color": t(plan["entry_color"], torch.long),
                 "cpl": [dict(ca=t(c.cells_a, torch.long),
                              cb=t(c.cells_b, torch.long),
                              perm_a=t(self.mass_ges[c.ia].perm[c.cells_a, 2]),
                              perm_b=t(self.mass_ges[c.ib].perm[c.cells_b, 2]),
                              eperm_a=t(
                                  self.energy_ges[c.ia].perm[c.cells_a, 2]),
                              eperm_b=t(
                                  self.energy_ges[c.ib].perm[c.cells_b, 2]),
                              dist_a=t(c.dist_a), dist_b=t(c.dist_b),
                              area=t(c.area), unit_z=t(c.unit_z))
                         for c in self.couplings],
                 "bc_temp": [t(np.asarray(g.bc_temperature, np.float64))[None]
                             for g in self.mass_ges]}
            self._dev[key] = d
        return d

    def _sparse_jac_data(self, res, X):
        """CSR data [nnz] of J = dres/dX via ``ncolors`` JVPs (the
        compressed Jacobian; exact under the distance-2 coloring)."""
        d = self._consts(X.device)
        compressed = torch.func.vmap(
            lambda s: torch.func.jvp(res, (X,), (s,))[1])(d["seeds"])
        return compressed[d["entry_color"], d["entry_row"]]

    # -- functional pieces (P, T: lists of [1, n_i] tensors) --------------
    def _split(self, X):
        """[2 ntot] -> (P, T), each a list of [1, n_i] views, mesh by mesh."""
        P = [X[None, self.offsets[i]:self.offsets[i + 1]]
             for i in range(len(self.sizes))]
        T = [X[None, self.ntot + self.offsets[i]:
               self.ntot + self.offsets[i + 1]]
             for i in range(len(self.sizes))]
        return P, T

    def _mass_dyn(self, i, T, d):
        """The mass GE's temperature input: the energy GE's T on the
        cells, the staged value on the BC auxvars."""
        return {"temperature": T, "bc_temperature": d["bc_temp"][i]}

    def _mass_coupling_flux(self, k, c: CouplingConnSet, P, T, d):
        """Internal-style Darcy flux between the coupled cells."""
        ga, gb = self.mass_ges[c.ia], self.mass_ges[c.ib]
        aux_a = ga._cell_aux(P[c.ia], self._mass_dyn(c.ia, T[c.ia], d))
        aux_b = gb._cell_aux(P[c.ib], self._mass_dyn(c.ib, T[c.ib], d))
        (_, _, kr_a, dkr_a, den_a, dden_a, vis_a, dvis_a, _, _) = aux_a
        (_, _, kr_b, dkr_b, den_b, dden_b, vis_b, dvis_b, _, _) = aux_b
        g = d["cpl"][k]
        ca, cb = g["ca"], g["cb"]
        flux, _, _ = darcy_flux(
            P[c.ib][:, cb], P[c.ia][:, ca], kr_b[:, cb], kr_a[:, ca],
            dkr_b[:, cb], dkr_a[:, ca], den_b[:, cb], den_a[:, ca],
            dden_b[:, cb], dden_a[:, ca], vis_b[:, cb], vis_a[:, ca],
            dvis_b[:, cb], dvis_a[:, ca], g["perm_b"], g["perm_a"],
            g["dist_b"], g["dist_a"], g["area"], g["unit_z"], internal=True)
        return flux

    def _energy_coupling_flux(self, k, c: CouplingConnSet, P, T, d):
        """Advective + conductive enthalpy flux between coupled cells."""
        ga, gb = self.energy_ges[c.ia], self.energy_ges[c.ib]
        a = ga._cell_aux_e(T[c.ia], P[c.ia])
        b = gb._cell_aux_e(T[c.ib], P[c.ib])
        g = d["cpl"][k]
        ca, cb = g["ca"], g["cb"]
        mflux, _, _ = darcy_flux(
            P[c.ib][:, cb], P[c.ia][:, ca], b["kr"][:, cb], a["kr"][:, ca],
            b["dkr_dP"][:, cb], a["dkr_dP"][:, ca], b["den"][:, cb],
            a["den"][:, ca], b["dden_dP"][:, cb], a["dden_dP"][:, ca],
            b["vis"][:, cb], a["vis"][:, ca], b["dvis_dP"][:, cb],
            a["dvis_dP"][:, ca], g["eperm_b"], g["eperm_a"], g["dist_b"],
            g["dist_a"], g["area"], g["unit_z"], internal=True)
        eflux, _, _ = enthalpy_flux(
            T[c.ib][:, cb], T[c.ia][:, ca], b["hl"][:, cb], a["hl"][:, ca],
            b["tc"][:, cb], a["tc"][:, ca], g["dist_b"], g["dist_a"],
            g["area"], mflux, internal=True)
        return eflux

    def _residual_pure(self, X, accum_prev_m, accum_prev_e, dt):
        """The coupled residual [2 ntot] at X [2 ntot]: a pure function of
        its arguments (the previous accumulations are lists of [1, n_i])."""
        d = self._consts(X.device)
        P, T = self._split(X)
        Fm, Fe = [], []
        for i, (gm, ge) in enumerate(zip(self.mass_ges, self.energy_ges)):
            Fm.append(gm.residual(P[i], dt, accum_prev=accum_prev_m[i],
                                  dyn=self._mass_dyn(i, T[i], d)))
            Fe.append(ge.residual_e(T[i], P[i], dt,
                                    accum_prev=accum_prev_e[i]))
        for k, c in enumerate(self.couplings):
            g = d["cpl"][k]
            mflux = self._mass_coupling_flux(k, c, P, T, d)
            Fm[c.ia] = Fm[c.ia].index_add(1, g["ca"], mflux)
            Fm[c.ib] = Fm[c.ib].index_add(1, g["cb"], -mflux)
            eflux = self._energy_coupling_flux(k, c, P, T, d)
            Fe[c.ia] = Fe[c.ia].index_add(1, g["ca"], eflux)
            Fe[c.ib] = Fe[c.ib].index_add(1, g["cb"], -eflux)
        return torch.cat(Fm + Fe, dim=1)[0]

    def totals(self, X):
        """(total water [kmol], total energy) of state X (numpy or a
        tensor [2 ntot]) on ``device``: sums of the GEs' accumulations."""
        X = torch.as_tensor(np.asarray(X, np.float64) if not isinstance(
            X, torch.Tensor) else X, dtype=F64, device=self.device)
        d = self._consts(X.device)
        P, T = self._split(X)
        m = e = 0.0
        for i, (gm, ge) in enumerate(zip(self.mass_ges, self.energy_ges)):
            m += float(torch.sum(gm.accum(P[i],
                                          self._mass_dyn(i, T[i], d))))
            e += float(torch.sum(ge.accum_e(T[i], P[i])))
        return m, e

    # -- solver ------------------------------------------------------------
    def _accums(self, X, dt):
        """The previous accumulations over dt at X [2 ntot] (a tensor)."""
        d = self._consts(X.device)
        P, T = self._split(X)
        am, ae = [], []
        for i, (gm, ge) in enumerate(zip(self.mass_ges, self.energy_ges)):
            n = self.sizes[i]
            acc = gm.accum(P[i], self._mass_dyn(i, T[i], d)) / dt
            am.append(_swhere(gm._active()[:n], acc, torch.zeros_like(acc)))
            acc = ge.accum_e(T[i], P[i]) / dt
            ae.append(_swhere(ge._active()[:n], acc, torch.zeros_like(acc)))
        return am, ae

    def step_dt(self, dt, nstep=1):
        """Newton with backtracking on the full coupled system inside a
        dt-cut ladder (SOEBaseStepDT_SNES semantics): returns
        (converged, reason)."""
        time = 0.0
        dt_iter = float(dt)
        num_time_cuts = 0
        converged = False
        reason = 0
        while True:
            ok, its = self._newton(dt_iter)
            if not ok:
                num_time_cuts += 1
                dt_iter *= 0.5
                self.soln = self.soln_prev
                reason = -3
            else:
                converged = True
                reason = 3
                time += dt_iter
                self.cumulative_newton_iterations += its
                self.soln_prev = self.soln
            if num_time_cuts > 20:
                if self.metrics is not None:
                    self.metrics.record(step=nstep, dt=dt, converged=False,
                                        reason=int(reason),
                                        dt_cuts=num_time_cuts)
                return False, reason
            if time >= dt * (1.0 - 1e-12):
                break
        if self.metrics is not None:
            self.metrics.record(step=nstep, dt=dt, dt_used=dt_iter,
                                converged=converged, reason=int(reason),
                                dt_cuts=num_time_cuts,
                                newton_iterations=int(its))
        return converged, reason

    def _newton(self, dt):
        """One Newton solve from ``soln`` at dt: returns (converged,
        iterations).  Each residual norm of the line search, with the
        iterate's and the direction's norms, is one host read."""
        dev = torch.device(self.device)
        Xp = torch.as_tensor(np.asarray(self.soln_prev, np.float64),
                             dtype=F64, device=dev)
        am, ae = self._accums(Xp, dt)
        res = partial(self._residual_pure, accum_prev_m=am,
                      accum_prev_e=ae, dt=dt)
        self._consts(dev)
        plan = self._jac_plan
        tpl, ilu = plan["tpl"], plan["ilu"]
        X = torch.as_tensor(np.asarray(self.soln, np.float64), dtype=F64,
                            device=dev)
        F = res(X)
        fnorm = float(self.syncs.download(torch.linalg.norm(F)))
        if not np.isfinite(fnorm):
            return False, 0
        ttol = max(fnorm * self.rtol, self.atol)
        for it in range(self.max_it):
            data = self._sparse_jac_data(res, X)
            lu = ilu.factor(data)
            dx, lin_its, _ = petsc_gmres(tpl.indptr, tpl.indices, data, -F,
                                         pc=ilu, pc_data=lu, rtol=1e-12,
                                         atol=1e-50, sync=self.syncs.flag)
            self.cumulative_linear_iterations += int(lin_its)
            lam = 1.0
            for _ in range(12):          # simple backtracking
                Xn = X + lam * dx
                Fn = res(Xn)
                fn, xnorm, dxnorm = (float(v) for v in self.syncs.download(
                    torch.stack([torch.linalg.norm(Fn), torch.linalg.norm(Xn),
                                 torch.linalg.norm(dx)])))
                if np.isfinite(fn) and fn <= fnorm * (1.0 - 1e-4 * lam) \
                        or fn < ttol:
                    break
                lam *= 0.5
            else:
                return False, it + 1
            snorm = lam * dxnorm
            X, F, fnorm = Xn, Fn, fn
            if fnorm < ttol or snorm < self.snes_stol * xnorm:
                self.soln = self.syncs.download(X)
                return True, it + 1
        return False, self.max_it


class THSpacMPP(MPPBase):
    """Facade for the multi-mesh TH SPAC problem (MPP_TH_SNES_CLM)."""

    def __init__(self):
        super().__init__()
        self.soe = THSpacSoE()

    def add_goveqn(self, ge_type, name, mesh_index):
        mesh = self.meshes[mesh_index]
        if ge_type == GEType.RE:
            self.soe.mass_ges.append(RichardsGE(name=name, mesh=mesh))
            return len(self.soe.mass_ges)
        if ge_type == GEType.THERM_SOIL_EBASED:
            self.soe.energy_ges.append(ThermalEnthalpyGE(name=name,
                                                         mesh=mesh))
            return len(self.soe.energy_ges)
        raise NotImplementedError(ge_type)

    def add_coupling(self, ia, ib, cells_a, cells_b, dist_a, dist_b, area,
                     unit_z):
        self.soe.couplings.append(CouplingConnSet(
            ia=ia, ib=ib,
            cells_a=np.asarray(cells_a, np.int64),
            cells_b=np.asarray(cells_b, np.int64),
            dist_a=np.asarray(dist_a, np.float64),
            dist_b=np.asarray(dist_b, np.float64),
            area=np.asarray(area, np.float64),
            unit_z=np.asarray(unit_z, np.float64)))

    def restart(self, press_1d, temp_1d):
        X = np.concatenate([np.asarray(press_1d, np.float64),
                            np.asarray(temp_1d, np.float64)])
        self.soe.soln = X
        self.soe.soln_prev = X

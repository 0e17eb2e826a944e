"""Compiled batched KSP: facade-built linear problems as a batched step.

Counterpart of ``CompiledKSP`` / ``compile_ksp`` in
``mpp_tpu/batched/ksp_compiled.py`` (the reference's ``SOEBaseStepDT_KSP``,
SystemOfEquationsBaseType.F90:555-647).  A problem built through a KSP
facade (``ThermalMPP``) is frozen into one batched assemble+solve timestep
over ``ncol`` independent copies of the problem (one row of the
``[ncol, n]`` state per column):

* the same assembly as ``models/thermal.py`` (``contributions``), evaluated
  batched with explicit dynamic inputs;
* the cross-GE auxvar exchange (``ThermalSOEGovEqnExchangeAuxVars``,
  SystemOfEquationsThermalType.F90:770-919) as a gather of the partner
  GE's temperature and conductivity into per-connection slots;
* the linear solve chosen from the sparsity, as in the JAX package:
  - tridiagonal (single vertical chains): the COO values scattered into
    (dl, d, du) with ``index_add_`` and solved by the Thomas kernel
    (``ops/hopper_kernels.thomas``; its plain version for CPU tensors);
  - block-tridiagonal over level-major blocks (the 3-media thermal
    problem at one column): ``ops/block_structure.BlockTridiagTemplate``
    and the plain ``ops/block_thomas.block_thomas`` sweep;
  - otherwise a dense ``torch.linalg.solve`` per column.

``linear_solver="petsc"`` is accepted wherever the JAX package takes
Thomas before it reads the keyword (tridiagonal problems, where ILU(0) is
the exact LU); its non-tridiagonal GMRES(30)+ILU(0) plan is not ported
yet and raises (ROADMAP Slice D).  ``CompiledRadiation`` waits for
Slice E.
"""
from __future__ import annotations

import numpy as np
import torch

from mpp_tpu_torch.batched.vsfm_compiled import _rows
from mpp_tpu_torch.constants import Cond
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.ops import hopper_kernels as hk

__all__ = ["CompiledKSP", "compile_ksp"]


class CompiledKSP:
    """A facade-built KSP problem frozen into a batched stepper.

    Batched use::

        T, ok, iters = comp.step_batched(T, bc_values, ss_values, dt, dyn=dyn)

    Serial use (``soe.step_dt`` at ncol=1)::

        compile_ksp(mpp).install()
    """

    def __init__(self, mpp, linear_solver: str = "direct"):
        """``linear_solver``: "direct" (the default, the exact batched
        solver) or "petsc" (the reference's GMRES(30)+ILU(0) at rtol 1e-5,
        which is Thomas for a tridiagonal operator)."""
        if linear_solver not in ("petsc", "direct"):
            raise ValueError(f"linear_solver {linear_solver!r}: expected "
                             '"petsc" or "direct"')
        self.mpp = mpp
        soe = mpp.soe
        if soe.template is None:
            soe.setup()
        self.soe = soe
        self.template = soe.template
        self.offsets = soe.offsets
        self.goveqns = list(soe.goveqns)
        self.n = soe.n_total
        self.cnfac = soe.cnfac
        self.linear_solver = linear_solver

        # exchange plan: for each GE, the bc slots that are FRM_OTR and the
        # partner GE's global cell index they gather from
        self._exch_slots, self._exch_src = [], []
        for g in self.goveqns:
            slots, src = [], []
            off = 0
            for cond in g.boundary_conditions:
                m = cond.conn_set.num_connections
                if cond.itype == int(Cond.DIRICHLET_FRM_OTR_GOVEQ):
                    rank = cond.other_geq_rank
                    ids = np.asarray(cond.conn_set.id_up, np.int64)
                    slots.append(np.arange(off, off + m))
                    src.append(self.offsets[rank - 1] + ids)
                off += m
            self._exch_slots.append(np.concatenate(slots) if slots
                                    else np.zeros(0, np.int64))
            self._exch_src.append(np.concatenate(src) if src
                                  else np.zeros(0, np.int64))
        self._tc = {}
        self._plan_solver()

    # ---- solver plan ------------------------------------------------------
    def _coo(self):
        """Global COO coordinates in the order the concatenated
        ``contributions`` values are emitted: per-GE [diag, internal,
        bc-diag], then the per-GE coupling tails (ThermalSOE.setup order)."""
        col_off_by_rank = {i + 1: self.offsets[i]
                           for i in range(len(self.goveqns))}
        rows_l, cols_l = [], []
        for g, off in zip(self.goveqns, self.offsets[:-1]):
            r, c = g.coo_coords(off, off)
            rows_l.append(np.asarray(r, np.int64))
            cols_l.append(np.asarray(c, np.int64))
        for g, off in zip(self.goveqns, self.offsets[:-1]):
            r, c = g.coupling_coords(off, col_off_by_rank)
            rows_l.append(np.asarray(r, np.int64))
            cols_l.append(np.asarray(c, np.int64))
        return np.concatenate(rows_l), np.concatenate(cols_l)

    def _plan_solver(self):
        coo_r, coo_c = self._coo()
        self._coo_r, self._coo_c = coo_r, coo_c
        bw = int(np.abs(coo_r - coo_c).max(initial=0))
        self.is_tridiag = bw <= 1
        self.block_size = None
        self._bt = None
        if self.is_tridiag:
            # direct-diagonal assembly: each COO contribution scatters
            # straight into (dl, d, du)
            band = coo_c - coo_r + 1        # 0 = dl, 1 = d, 2 = du
            self._tri_idx = [np.nonzero(band == b)[0] for b in (0, 1, 2)]
            self._tri_rows = [coo_r[i] for i in self._tri_idx]
            return
        if self.linear_solver == "petsc":
            raise NotImplementedError(
                f"non-tridiagonal KSP problem (bandwidth {bw}) with "
                'linear_solver="petsc": the batched GMRES(30)+ILU(0) plan is '
                'not ported yet (ROADMAP Slice D); pass linear_solver="direct"')
        for b in range(bw, min(self.n // 2, 1024) + 1):
            # a candidate block size must both divide n AND give a true
            # block-tridiagonal cover: every entry within one block row of
            # the diagonal
            if self.n % b == 0 and \
                    (np.abs(coo_r // b - coo_c // b) <= 1).all():
                self.block_size = b
                break
        if self.block_size is not None:
            from mpp_tpu_torch.ops.block_structure import BlockTridiagTemplate
            self._bt = BlockTridiagTemplate(1, self.n // self.block_size,
                                            self.block_size, coo_r, coo_c)
        elif self.n > 4096:
            raise ValueError(
                f"no banded structure found and n={self.n} too large for "
                "batched dense LU")

    def _const(self, key, ref, build):
        """``build()`` (numpy indices) as a long tensor on ``ref``'s device,
        converted once."""
        k = (key, str(ref.device))
        v = self._tc.get(k)
        if v is None:
            v = torch.as_tensor(np.asarray(build(), np.int64),
                                device=ref.device)
            self._tc[k] = v
        return v

    # ---- batched evaluation ------------------------------------------------
    def _assemble(self, T, bc_values, ss_values, dt, dyn):
        """(A values in _coo order [ncol, nvals], rhs b [ncol, n])."""
        ncol = T.shape[0]
        ges = [(k, g, int(off), int(off) + g.mesh.ncells_local)
               for k, (g, off) in enumerate(zip(self.goveqns,
                                                self.offsets[:-1]))]
        k_all = None
        if any(s.size for s in self._exch_slots):
            k_all = torch.cat([torch.broadcast_to(
                g.aux(T[:, a:b], dyn[k])[0], (ncol, b - a))
                for k, g, a, b in ges], dim=1)
        vals_l, b_l, cpl_l = [], [], []
        for k, g, a, b in ges:
            nbc = sum(c.num_connections for c in g.boundary_conditions)
            exch_T = T.new_zeros((ncol, nbc))
            exch_k = T.new_ones((ncol, nbc))
            if self._exch_slots[k].size:
                slots = self._const(("exch_slots", k), T,
                                    lambda: self._exch_slots[k])
                src = self._const(("exch_src", k), T,
                                  lambda: self._exch_src[k])
                exch_T = exch_T.index_copy(1, slots, T[:, src])
                exch_k = exch_k.index_copy(1, slots, k_all[:, src])
            v, rhs, cpl = g.contributions(T[:, a:b], dt, self.cnfac,
                                          ss_values[k], bc_value=bc_values[k],
                                          exch_T=exch_T, exch_k=exch_k,
                                          dyn=dyn[k])
            vals_l.append(v)
            b_l.append(rhs)
            cpl_l.append(cpl)
        return torch.cat(vals_l + cpl_l, dim=1), torch.cat(b_l, dim=1)

    def _tri_bands(self, vals):
        """COO values [ncol, nvals] -> the (dl, d, du) bands [ncol, n] of a
        tridiagonal plan."""
        bands = []
        for i, (idx, rows) in enumerate(zip(self._tri_idx, self._tri_rows)):
            it = self._const(("tri_idx", i), vals, lambda: idx)
            rt = self._const(("tri_rows", i), vals, lambda: rows)
            bands.append(vals.new_zeros((vals.shape[0], self.n))
                         .index_add_(1, rt, vals[:, it]))
        return tuple(bands)

    def _solve(self, vals, b):
        """The plan's direct solve of the assembled systems: x [ncol, n]."""
        ncol = vals.shape[0]
        if self.is_tridiag:
            dl, d, du = self._tri_bands(vals)
            return hk.thomas(dl, d, du, b.contiguous())
        if self._bt is not None:
            from mpp_tpu_torch.ops.block_thomas import block_thomas
            L, D, U = self._bt.assemble(vals)
            nlev = self.n // self.block_size
            x = block_thomas(L, D, U, b.reshape(ncol, 1, nlev,
                                                self.block_size))
            return x.reshape(ncol, self.n)
        flat = self._const("dense_flat", vals,
                           lambda: self._coo_r * self.n + self._coo_c)
        dense = vals.new_zeros((ncol, self.n * self.n)) \
            .index_add_(1, flat, vals).view(ncol, self.n, self.n)
        return torch.linalg.solve(dense, b[..., None])[..., 0]

    # ---- public API -------------------------------------------------------
    def step_batched(self, T, bc_values, ss_values, dt, dyn=None):
        """Batched KSP step: T [ncol, n] (the previous solution — the KSP
        path assembles operators AND rhs from it, SOEBaseStepDT_KSP);
        bc_values/ss_values tuples of [ncol, nbc_g]/[ncol, nss_g] per GE;
        ``dyn`` tuple of per-GE dynamic-state dicts with leading [ncol]
        axes.  Returns (T_new, ok[ncol], linear_iterations): ``ok`` is the
        per-column finite-solution check of a direct solve."""
        if dyn is None:
            dyn = tuple({} for _ in self.goveqns)
        vals, b = self._assemble(T, tuple(bc_values), tuple(ss_values), dt,
                                 tuple(dict(d) for d in dyn))
        x = self._solve(vals, b)
        return x, torch.all(torch.isfinite(x), dim=-1), 1

    def gather_inputs(self, ncol=1, device="cuda", dtype=torch.float64):
        """The staged BC/SS condition values of every GE as ``[ncol, nbc]``
        / ``[ncol, nss]`` tensors (each column a copy), on the card unless
        ``device="cpu"``."""
        device = device_of(device)
        return (tuple(_rows(g.bc_value, ncol, device, dtype)
                      for g in self.goveqns),
                tuple(_rows(g.ss_values, ncol, device, dtype)
                      for g in self.goveqns))

    #: device of the serial drop-in step; :meth:`install` sets it
    serial_device = "cuda"

    def install(self, device="cuda"):
        """Route the SoE's ``step_dt`` through this stepper, so the facade
        problem drivers run on it unchanged; the serial step runs on
        ``device`` (the card unless ``device="cpu"``)."""
        self.serial_device = device_of(device)
        self.soe.step_dt = self.step_dt
        return self

    def step_dt(self, dt, solver=None, nstep: int = 1):
        """Drop-in for the SoE's KSP ``step_dt`` at ncol=1, in f64 on
        ``serial_device``; updates the SoE solution state (PostSolve)."""
        soe = self.soe
        dev = device_of(self.serial_device)
        bc, ss = self.gather_inputs(1, dev)
        T = torch.as_tensor(np.asarray(soe.soln_prev, np.float64),
                            device=dev)[None, :]
        Tn, ok, iters = self.step_batched(T, bc, ss, dt)
        converged = bool(ok[0])
        soe.soln = Tn[0].cpu().numpy()
        soe.cumulative_linear_iterations += int(iters)
        soe.soln_prev = soe.soln
        for g, off in zip(self.goveqns, self.offsets[:-1]):
            g.temperature = soe.soln[off:off + g.mesh.ncells_local]
        if soe.metrics is not None:
            soe.metrics.record(step=nstep, dt=dt, converged=converged,
                               solver="compiled",
                               linear_iterations=int(iters))
        return converged


def compile_ksp(mpp, **kw) -> CompiledKSP:
    """Freeze a fully staged KSP facade problem (``ThermalMPP``) into a
    batched stepper, after the 8-step builder sequence and property
    staging.  BC/SS condition values and the per-GE ``dyn`` state dicts
    are inputs of every step; the other staged arrays are read at each
    step."""
    return CompiledKSP(mpp, **kw)

"""Compiled batched VSFM: a facade-built problem as a batched Newton step.

Counterpart of ``mpp_tpu/batched/vsfm_compiled.py``.  A problem built
through the ``VSFMMPP`` facade is frozen into a batched implicit timestep
over ``ncol`` independent copies of the problem (one row of the
``[ncol, n]`` state per column):

* the same assembly as ``models/richards.py`` (residual and Jacobian
  values), evaluated batched — the JAX package's vmapped one-column
  functions written as tensor code;
* coupled-GE auxvar exchange as a gather of the partner GE's unknowns into
  the coupled-BC value slots;
* a solver plan supplies three hooks: ``_jac`` (the Jacobian in the plan's
  form), ``_solve`` (the Newton direction) and ``_matvec`` (J Y, the line
  search's initial slope); ``linesearch_jac="fused"`` builds the Jacobian
  with the residual at the line search's full-step trial instead
  (``_resjac``) and carries it into the next iteration.  The plans:
  - tridiagonal problems (the vertical-column case): the Jacobian
    assembled straight into its three bands with ``index_add_``, the
    Thomas kernel and the stencil-SpMV kernel (``ops/hopper_kernels.py``),
    under either ``linear_solver``;
  - otherwise the Jacobian as CSR data and J x as the ELL SpMV;
    "petsc" solves by the batched ILU(0) + GMRES(30) replica of the
    reference's inner solve (``batched/ilu_gmres.py``), "direct" by
    block-Thomas over level-major blocks (``ops/block_structure.
    block_solve``: the ``block_thomas_small`` kernel to block size 8, the
    plain sweep past it) or a batched dense LU;
  ``batched/th_compiled.py`` adds the 2x2 block-tridiagonal one;
* PETSc SNES NEWTONLS + SNESLineSearchBT (cubic) + SNESConvergedDefault,
  batched with per-column masks, straggler compaction, and the
  SOEBaseStepDT_SNES dt-cut ladder with per-column ladders
  (soe/SystemOfEquationsBaseType.F90:368-552).

The JAX package's ``lax.while_loop``/``lax.cond`` predicates are Python
control flow here: each one reads a device value on the host.  Every such
read goes through :meth:`CompiledVSFM._sync`, which counts it in
``host_syncs``.

A facade problem steps serially through ``VSFMSoE.step_dt`` (the serial
SNES of ``ops/snes.py``) or, after :meth:`CompiledVSFM.install`, through
this stepper at ncol=1.  With the NaN trap of ``config.py`` armed, each
residual and each Newton direction is checked for non-finite values.
"""
from __future__ import annotations

import numpy as np
import torch

from mpp_tpu_torch.config import check_finite
from mpp_tpu_torch.batched.ilu_gmres import (BatchedILU0, make_ell_matvec,
                                             petsc_gmres_batched)
from mpp_tpu_torch.constants import FMWH2O
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.ops import hopper_kernels as hk
from mpp_tpu_torch.ops.block_structure import BlockTridiagTemplate, \
    block_solve
from mpp_tpu_torch.ops.snes import (CONVERGED_FNORM_ABS,
                                    CONVERGED_FNORM_RELATIVE,
                                    CONVERGED_SNORM_RELATIVE,
                                    DIVERGED_FNORM_NAN, DIVERGED_LINE_SEARCH,
                                    DIVERGED_MAX_IT, DIVERGED_DTOL,
                                    SNESParams)

__all__ = ["CompiledVSFM", "compile_vsfm", "SNESParams"]


def _take(tree, idx):
    """Gather rows ``idx`` of every tensor in a nested dict/tuple."""
    if isinstance(tree, dict):
        return {k: _take(v, idx) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_take(v, idx) for v in tree)
    return tree[idx]


def _colnorm(A):
    return torch.sqrt(torch.sum(A * A, dim=-1))


def _rows(v, ncol, device, dtype):
    """A staged per-connection array as ``[ncol, len(v)]`` (each column a
    copy)."""
    return torch.as_tensor(np.asarray(v), dtype=dtype, device=device) \
        .expand(ncol, -1).contiguous()


class CompiledVSFM:
    """A facade-built VSFM problem frozen into a batched stepper.

    Batched use::

        X, iters, ok, reason = comp.step_batched(X, bc_values, ss_values, dt)
    """

    def __init__(self, mpp, snes: SNESParams = None, max_cuts: int = 20,
                 linear_solver: str = "petsc",
                 linesearch_jac: str = "separate"):
        """``linear_solver``: "petsc" (the default) replicates the
        reference's inner solve, batched ILU(0) + GMRES(30) at rtol 1e-5,
        so golden trajectories are reproduced; "direct" is the exact
        batched solver (block-Thomas or dense LU), within the Newton stop
        criterion's determinacy band of the goldens.  A tridiagonal
        problem runs Thomas for either (ILU(0) of a tridiagonal matrix is
        its exact LU).

        ``linesearch_jac``: "separate" (the default) evaluates the Jacobian
        at the start of each Newton iteration; "fused" evaluates residual
        and Jacobian together at the line search's full-step trial and
        carries the bands of the columns that settled there into the next
        iteration, re-evaluating those of backtracked columns.  The same
        iteration map either way."""
        if linear_solver not in ("petsc", "direct"):
            raise ValueError(f"linear_solver {linear_solver!r}: expected "
                             '"petsc" or "direct"')
        if linesearch_jac not in ("separate", "fused"):
            raise ValueError(f"linesearch_jac {linesearch_jac!r}: expected "
                             '"separate" or "fused"')
        self.linear_solver = linear_solver
        self._ls_fused = linesearch_jac == "fused"
        self.mpp = mpp
        soe = mpp.soe
        soe._ensure_template()
        self.template = soe.template
        self.offsets = soe.offsets
        self.goveqns = list(soe.goveqns)
        self.n = soe.n_total
        self.snes = snes or SNESParams(stol=soe.snes_stol)
        # f32 runs cannot meet the f64 PETSc defaults (rtol 1e-8 / stol
        # 1e-10 are below f32 resolution on ~1e5 Pa state): the dtype of
        # the state selects this parameter set
        self.snes_f32 = SNESParams(rtol=2e-4, atol=1e-8, stol=1e-6,
                                   ls_steptol=1e-8,
                                   ksp_rtol=self.snes.ksp_rtol)
        self.max_cuts = max_cuts
        # straggler-compaction divisor (see _snes_batched); 0 disables
        self.compact_frac = 8
        #: host reads of device predicates since construction
        self.host_syncs = 0

        # coupled-BC staging maps: for each GE, the bc_value slots that are
        # COND_DIRICHLET_FRM_OTR_GOVEQ and the global solution index whose
        # value they take (VSFMSOEGovEqnExchangeAuxVars as a gather)
        self._otr_slots, self._otr_src = [], []
        for g in self.goveqns:
            slots, src = [], []
            for cond, off, other, cells in g.coupled_bc_slices():
                slots.append(np.arange(off, off + cells.size))
                src.append(self.offsets[other] + cells)
            self._otr_slots.append(np.concatenate(slots) if slots
                                   else np.zeros(0, np.int64))
            self._otr_src.append(np.concatenate(src) if src
                                 else np.zeros(0, np.int64))
        self._tc = {}
        self._plan_solver()

    # ---- solver plan -----------------------------------------------------
    def _plan_solver(self):
        """Choose the linear solver from the discovered sparsity:

        * bandwidth <= 1: the tridiagonal plan under either keyword (ILU(0)
          of a tridiagonal matrix is its exact LU).  Each COO contribution
          (in the order the concatenated jacobian_values emit them) maps
          statically to (band, row), so assembly is three scatter-adds
          into (dl, d, du); the Thomas and stencil-SpMV kernels solve and
          multiply;
        * otherwise the CSR plans of :meth:`_plan_csr`."""
        t = self.template
        rows, cols = t.row_ids(), t.indices
        bw = int(np.abs(rows.astype(np.int64) - cols).max(initial=0))
        self.is_tridiag = bw <= 1
        if not self.is_tridiag:
            self._plan_csr(rows, cols, bw)
            return
        self.plan = "thomas"
        rows_l, cols_l = [], []
        for g, off in zip(self.goveqns, self.offsets[:-1]):
            r, c = g.coo_coords(off, off)
            rows_l += [r.astype(np.int64)]
            cols_l += [c.astype(np.int64)]
            rc, cc = g.coupling_coords(off, self.offsets[:-1])
            rows_l += [rc]
            cols_l += [cc]
        coo_r = np.concatenate(rows_l)
        coo_c = np.concatenate(cols_l)
        band = coo_c - coo_r + 1        # 0 = dl, 1 = d, 2 = du
        self._tri_idx = [np.nonzero(band == b)[0] for b in (0, 1, 2)]
        self._tri_rows = [coo_r[i] for i in self._tri_idx]

    def _plan_csr(self, rows, cols, bw):
        """The plans on the assembled CSR data (``mpp_tpu/batched/
        vsfm_compiled.py:168-212``): "petsc" is the batched ILU(0) +
        GMRES at the ``SNESParams`` ksp_rtol / ksp_atol / ksp_restart;
        "direct" takes the first block size b >= bandwidth that divides n
        and gives a true block-tridiagonal cover (every entry within one
        block row of the diagonal) and runs block-Thomas over n/b levels,
        else a batched dense LU up to n = 4096.  J x is the ELL SpMV."""
        t = self.template
        self._ell = make_ell_matvec(t.indptr, t.indices)
        self._ilu = self._bt = self.block_size = None
        if self.linear_solver == "petsc":
            self.plan = "petsc"
            self._ilu = BatchedILU0(t.indptr, t.indices)
            return
        r64, c64 = rows.astype(np.int64), cols.astype(np.int64)
        for b in range(bw, min(self.n // 2, 1024) + 1):
            if self.n % b == 0 and (np.abs(r64 // b - c64 // b) <= 1).all():
                self.block_size = b
                break
        if self.block_size is not None:
            self.plan = "block"
            self._bt = BlockTridiagTemplate(1, self.n // self.block_size,
                                            self.block_size, rows, cols)
        elif self.n > 4096:
            raise ValueError(
                f"no banded structure found and n={self.n} too large for "
                "batched dense LU")
        else:
            self.plan = "dense"

    def _const(self, key, ref, build, dtype=torch.long):
        """``build()`` (numpy) as a ``dtype`` tensor on ``ref``'s device,
        converted once."""
        k = (key, str(ref.device), dtype)
        v = self._tc.get(k)
        if v is None:
            v = torch.as_tensor(np.asarray(build()), dtype=dtype,
                                device=ref.device)
            self._tc[k] = v
        return v

    def _sync(self, value):
        """Read a device scalar on the host (one host synchronisation)."""
        self.host_syncs += 1
        return value.item()

    # ---- the plan's hooks: _jac, _solve, _matvec -----------------------------
    #: GMRES cycles and solves of the "petsc" plan since construction
    gmres_cycles = 0
    gmres_solves = 0
    _gmres_failed = None

    def gmres_unconverged(self):
        """(column, solve) pairs whose GMRES did not converge since
        construction (one host read)."""
        v = self._gmres_failed
        return 0 if v is None else int(self._sync(v))

    def _csr_solve(self, data, F):
        """J Y = F on the CSR data [ncol, nnz] by the CSR plan."""
        if self.plan == "petsc":
            sp = self.snes
            x, cycles, conv = petsc_gmres_batched(
                self._ell, data, F, ilu=self._ilu,
                pc_data=self._ilu.factor(data), rtol=sp.ksp_rtol,
                atol=sp.ksp_atol, restart=sp.ksp_restart, sync=self._sync)
            self.gmres_cycles += cycles
            self.gmres_solves += 1
            bad = torch.sum(~conv)
            self._gmres_failed = bad if self._gmres_failed is None \
                else self._gmres_failed + bad
            return x
        if self.plan == "block":
            ncol, b = F.shape[0], self.block_size
            L, D, U = self._bt.assemble(data)
            x = block_solve(L, D, U, F.reshape(ncol, 1, self.n // b, b))
            return x.reshape(ncol, self.n)
        dense = self.template.to_dense(data)
        return torch.linalg.solve(dense, F[..., None])[..., 0]

    def _solve(self, A, F):
        """Newton direction Y with J Y = F: the Thomas kernel on the bands
        of a tridiagonal plan, else the CSR plan on ``A = (data,)``."""
        if not self.is_tridiag:
            return self._csr_solve(A[0], F)
        dl, d, du = A
        return hk.thomas(dl, d, du, F.contiguous())

    def _matvec(self, A, x):
        """J x for the BT initial slope: the stencil-SpMV kernel on bands
        (f32 runs store them in bf16, tridiag_spmv_mixed; f64 runs keep
        full precision), the ELL SpMV on CSR data."""
        if not self.is_tridiag:
            return self._ell(A[0], x)
        dl, d, du = A
        x = x.contiguous()
        if x.dtype == torch.float32:
            return hk.tridiag_spmv_mixed(dl.to(torch.bfloat16),
                                         d.to(torch.bfloat16),
                                         du.to(torch.bfloat16), x)
        return hk.tridiag_spmv(dl, d, du, x)

    def _assemble_plan(self, v):
        """COO contribution values [ncol, nvals] -> the plan's Jacobian:
        the (dl, d, du) bands, or ``(data,)`` with the CSR data."""
        if self.is_tridiag:
            return self._tri_assemble(v)
        slots = self._const("csr_slots", v, lambda: self.template.slots)
        return (v.new_zeros((v.shape[0], self.template.nnz))
                .index_add_(1, slots, v),)

    # ---- batched evaluation ------------------------------------------------
    def _stage_bc(self, k, bc, X):
        if not self._otr_slots[k].size:
            return bc
        slots = self._const(("otr_slots", k), X, lambda: self._otr_slots[k])
        src = self._const(("otr_src", k), X, lambda: self._otr_src[k])
        return bc.index_copy(1, slots, X[:, src])

    def _ges(self):
        return [(k, g, int(off), int(off) + g.mesh.ncells_local)
                for k, (g, off) in enumerate(zip(self.goveqns,
                                                 self.offsets[:-1]))]

    def _residual(self, X, bc_values, ss_values, accum_prevs, dt, src, dyn):
        """F [ncol, n].  ``src``: per-cell mass source [ncol, n] (kmol/s,
        positive = source); ``dyn``: tuple of per-GE dynamic-parameter
        dicts with a leading [ncol] axis."""
        Fs = []
        for k, g, a, b in self._ges():
            F = g.residual(X[:, a:b], dt,
                           bc_value=self._stage_bc(k, bc_values[k], X),
                           ss_value=ss_values[k], accum_prev=accum_prevs[k],
                           dyn=dyn[k])
            Fs.append(F - src[:, a:b])
        return torch.cat(Fs, dim=1)

    def _tri_assemble(self, v):
        """COO contribution values [ncol, nvals] -> (dl, d, du) bands."""
        out = []
        for b, (i, rows) in enumerate(zip(self._tri_idx, self._tri_rows)):
            it = self._const(("tri_idx", b), v, lambda: i)
            rt = self._const(("tri_rows", b), v, lambda: rows)
            out.append(v.new_zeros((v.shape[0], self.n))
                       .index_add_(1, rt, v[:, it]))
        return tuple(out)

    def _jac(self, X, bc_values, ss_values, dt, dyn):
        """The Jacobian as the plan's solver takes it (the coupled-BC
        gather first): the (dl, d, du) bands or ``(CSR data,)``."""
        vals = []
        for k, g, a, b in self._ges():
            vals.append(g.jacobian_values(
                X[:, a:b], dt, bc_value=self._stage_bc(k, bc_values[k], X),
                ss_value=ss_values[k], dyn=dyn[k]))
        return self._assemble_plan(torch.cat(vals, dim=1))

    def _resjac(self, X, bc_values, ss_values, accum_prevs, dt, src, dyn):
        """(F, the plan's Jacobian) from one constitutive evaluation per GE
        (``residual_and_jac_values``): the same math as ``_residual`` and
        ``_jac``."""
        Fs, vals = [], []
        for k, g, a, b in self._ges():
            F, v = g.residual_and_jac_values(
                X[:, a:b], dt, bc_value=self._stage_bc(k, bc_values[k], X),
                ss_value=ss_values[k], accum_prev=accum_prevs[k], dyn=dyn[k])
            Fs.append(F - src[:, a:b])
            vals.append(v)
        return (torch.cat(Fs, dim=1),
                self._assemble_plan(torch.cat(vals, dim=1)))

    def _accum_prev(self, X, dt, dyn):
        out = []
        for k, g, a, b in self._ges():
            acc = g.accum(X[:, a:b], dyn=dyn[k]) / dt
            active = np.asarray(g.mesh.is_active, bool)
            if not active.all():
                acc = torch.where(torch.as_tensor(active, device=X.device),
                                  acc, 0.0)
            out.append(acc)
        return tuple(out)

    # ---- batched Newton (SNES NEWTONLS + BT linesearch) --------------------
    def _snes_batched(self, X0, bc, ss, accum_prev, dt, src, dyn, tols):
        """Returns (X, iters, reason[ncol]) with the PETSc
        SNESConvergedReason codes.  ``tols`` = (rtol, stol, mass_tol_kg)
        host floats (the ALM retry ladder's tightening).

        Straggler compaction: once at most ncol/compact_frac columns
        remain unconverged (ncol >= 4096), they are gathered into a narrow
        batch that continues alone and is scattered back, so the stiff
        tail costs 1/compact_frac of a full-batch iteration."""
        sp = self.snes if X0.dtype == torch.float64 else self.snes_f32
        rtol, stol, mass_tol = tols
        ncol = X0.shape[0]
        compact = self.compact_frac
        K = (ncol // compact) if compact and ncol >= 4096 else 0

        fused = self._ls_fused

        def make_body(bc, ss, accum_prev, dtl, src, dyn, fnorm0, ttol):
            ncol_b = dtl.shape[0]
            kbt = max(1, ncol_b // 8)

            def res(X):
                F = self._residual(X, bc, ss, accum_prev, dtl, src, dyn)
                check_finite(f"{type(self).__name__} residual", F)
                return F

            def jac_of(X, idx=None):
                if idx is None:
                    return self._jac(X, bc, ss, dtl, dyn)
                return self._jac(X[idx], tuple(b[idx] for b in bc),
                                 tuple(v[idx] for v in ss), dtl[idx],
                                 _take(dyn, idx))

            def next_jac(Xw, A_try, stale):
                """The fused mode's Jacobian at the accepted iterate: the
                first-trial bands stand for every column settled at the
                full step; columns that backtracked are re-evaluated, as a
                narrow gather of at most ncol/8 columns, or the whole batch
                when more backtracked."""
                n_st = self._sync(torch.sum(stale))
                if n_st == 0:
                    return A_try
                if kbt < ncol_b and n_st <= kbt:
                    # stale first (stable)
                    idx = torch.argsort((~stale).to(torch.int8),
                                        stable=True)[:kbt]
                    Af = jac_of(Xw, idx)
                    return tuple(a.index_copy(0, idx, f)
                                 for a, f in zip(A_try, Af))
                return jac_of(Xw)

            def bt_linesearch(X, F, fnorm, Y, initslope, done):
                """Batched SNESLineSearchBT (cubic), per-column lambda.
                Returns (ok, X_new, G, A_new, gnorm, snorm); A_new (the
                Jacobian at X_new) only in the fused mode."""
                ynorm0 = _colnorm(Y)
                zero = ynorm0 == 0.0
                safe_y = torch.where(zero, 1.0, ynorm0)
                clampf = torch.where(ynorm0 > sp.ls_maxstep,
                                     sp.ls_maxstep / safe_y, 1.0)
                Y = Y * clampf[:, None]
                ynorm = torch.clamp_max(ynorm0, sp.ls_maxstep)
                minlam = sp.ls_steptol / safe_y

                def accept_of(lam, gnorm):
                    return (0.5 * gnorm * gnorm
                            <= 0.5 * fnorm * fnorm
                            + lam * sp.ls_alpha * initslope)

                lam = torch.full_like(fnorm, sp.ls_damping)
                Xw = torch.where(done[:, None], X, X - lam[:, None] * Y)
                if fused:
                    G, A_try = self._resjac(Xw, bc, ss, accum_prev, dtl, src,
                                            dyn)
                    check_finite(f"{type(self).__name__} residual", G)
                else:
                    G, A_try = res(Xw), None
                gnorm = _colnorm(G)
                acc = accept_of(lam, gnorm) | zero | done
                fail = ~acc & ~torch.isfinite(gnorm)
                settled_first = acc | fail
                lamprev, gnormprev = lam, gnorm

                # quadratic backtrack for the columns that did not accept
                # the full step; skipped when all did (the common case)
                if self._sync(torch.all(acc | fail)):
                    lam2, Xw2, G2, gnorm2 = lam, Xw, G, gnorm
                else:
                    settled = acc | fail
                    denom = (gnorm * gnorm - fnorm * fnorm
                             - 2.0 * lam * initslope)
                    lamq = -initslope / torch.where(denom == 0.0, 1.0, denom)
                    lamq = torch.where(lamq > 0.5 * lam, 0.5 * lam, lamq)
                    lamq = torch.where(lamq <= 0.1 * lam, 0.1 * lam, lamq)
                    lamq = torch.where(torch.isfinite(lamq), lamq, 0.1 * lam)
                    lam2 = torch.where(settled, lam, lamq)
                    Xw2 = torch.where((settled | done)[:, None], Xw,
                                      X - lam2[:, None] * Y)
                    G2 = res(Xw2)
                    gnorm2 = torch.where(settled, gnorm, _colnorm(G2))
                    Xw2 = torch.where(settled[:, None], Xw, Xw2)
                    G2 = torch.where(settled[:, None], G, G2)

                lam, gnorm, Xw, G = lam2, gnorm2, Xw2, G2
                it = 0
                while it < sp.ls_max_it and \
                        self._sync(torch.any(~acc & ~fail)):
                    newly = accept_of(lam, gnorm) & ~fail
                    acc2 = acc | newly
                    fail2 = fail | (~acc2 & ((lam <= minlam)
                                             | ~torch.isfinite(gnorm)))
                    active = ~acc2 & ~fail2
                    # cubic model (linesearchbt.c)
                    t1 = (0.5 * (gnorm * gnorm - fnorm * fnorm)
                          - lam * initslope)
                    t2 = (0.5 * (gnormprev * gnormprev - fnorm * fnorm)
                          - lamprev * initslope)
                    dl_ = torch.where(lam == lamprev, 1.0, lam - lamprev)
                    a = (t1 / (lam * lam)
                         - t2 / (lamprev * lamprev)) / dl_
                    b = (-lamprev * t1 / (lam * lam)
                         + lam * t2 / (lamprev * lamprev)) / dl_
                    dsc = torch.clamp_min(b * b - 3.0 * a * initslope, 0.0)
                    lamt = torch.where(a == 0.0, -initslope / (2.0 * b),
                                       (-b + torch.sqrt(dsc)) / (3.0 * a))
                    lamn = torch.where(lamt > 0.5 * lam, 0.5 * lam, lamt)
                    lamn = torch.where(lamn <= 0.1 * lam, 0.1 * lam, lamn)
                    lamn = torch.where(torch.isfinite(lamn), lamn, 0.1 * lam)
                    lamprev = torch.where(active, lam, lamprev)
                    gnormprev = torch.where(active, gnorm, gnormprev)
                    lam = torch.where(active, lamn, lam)
                    Xw = torch.where(active[:, None], X - lam[:, None] * Y,
                                     Xw)
                    G3 = res(Xw)
                    gnorm = torch.where(active, _colnorm(G3), gnorm)
                    G = torch.where(active[:, None], G3, G)
                    acc, fail = acc2, fail2
                    it += 1
                # final accept check for the last evaluation
                newly = accept_of(lam, gnorm) & ~fail
                acc = acc | newly
                fail = fail | ~acc
                snorm = torch.abs(lam) * ynorm
                A_new = next_jac(Xw, A_try, ~settled_first) if fused \
                    else None
                return acc & ~fail, Xw, G, A_new, gnorm, snorm

            def body(state):
                X, F, fnorm, it, done, reason, A = state
                if not fused:
                    # the Jacobian at the iteration's start point
                    # (SOEBaseStepDT_SNES -> SNESSolve)
                    A = jac_of(X)
                Y = self._solve(A, F)
                check_finite(f"{type(self).__name__} Newton direction", Y)
                # BT initslope from the true Jacobian action
                W = self._matvec(A, Y)
                islope = torch.sum(F * W, dim=-1)
                islope = torch.where(islope > 0.0, -islope, islope)
                islope = torch.where(islope == 0.0, -1.0, islope)
                ok, Xn, Gn, An, gnormn, snorm = bt_linesearch(
                    X, F, fnorm, Y, islope, done)
                # PETSc SNESSolve_NEWTONLS failure path: a failed line
                # search with stol*xnorm > ynorm means the update is
                # already negligible — SNORM convergence at the pre-step
                # iterate
                ynorm_full = _colnorm(Y)
                xnorm_pre = _colnorm(X)
                tiny = ~ok & (stol * xnorm_pre > ynorm_full)
                keep = done | tiny
                ok = ok | tiny
                X2 = torch.where(keep[:, None], X, Xn)
                F2 = torch.where(keep[:, None], F, Gn)
                fnorm2 = torch.where(keep, fnorm, gnormn)
                xnorm = _colnorm(X2)
                # SNESConvergedDefault ordering
                nan = ~torch.isfinite(fnorm2)
                r = torch.zeros_like(reason)
                r = torch.where(~ok, DIVERGED_LINE_SEARCH, r)
                r = torch.where(tiny, CONVERGED_SNORM_RELATIVE, r)
                r = torch.where(nan, DIVERGED_FNORM_NAN, r)
                r = torch.where((r == 0) & (fnorm2 < sp.atol),
                                CONVERGED_FNORM_ABS, r)
                r = torch.where((r == 0) & (snorm < stol * xnorm),
                                CONVERGED_SNORM_RELATIVE, r)
                r = torch.where((r == 0) & (fnorm2 <= ttol),
                                CONVERGED_FNORM_RELATIVE, r)
                r = torch.where((r == 0) & (fnorm2 >= sp.divtol * fnorm0),
                                DIVERGED_DTOL, r)
                # mass-closure gate (the ALM audit integrand
                # |sum F| * dt * FMWH2O): with mass_tol > 0 a column may
                # not declare convergence while its own balance is open
                if mass_tol > 0.0:
                    msum_kg = (torch.abs(torch.sum(F2, dim=-1))
                               * dtl[:, 0] * FMWH2O)
                    r = torch.where((r > 0) & ~(msum_kg <= mass_tol), 0, r)
                newly = (r != 0) & ~done
                reason2 = torch.where(newly, r, reason)
                it2 = it + 1
                done2 = done | newly
                if it2 >= sp.max_it:
                    reason2 = torch.where(~done2, DIVERGED_MAX_IT, reason2)
                # the fused An needs no keep-merge: a done column's trial
                # point is X itself, and tiny/failed columns are done now
                return (X2, F2, fnorm2, it2, done2, reason2, An)

            return body

        # ---- phase A: full batch (until all done or only the stiff tail
        # of <= K columns remains) ----
        if fused:
            F0, A0 = self._resjac(X0, bc, ss, accum_prev, dt, src, dyn)
        else:
            F0, A0 = self._residual(X0, bc, ss, accum_prev, dt, src, dyn), None
        check_finite(f"{type(self).__name__} residual", F0)
        fnorm0 = _colnorm(F0)
        ttol = fnorm0 * rtol
        nan0 = ~torch.isfinite(fnorm0)
        small0 = fnorm0 < sp.atol
        done0 = nan0 | small0
        reason0 = torch.where(
            nan0, DIVERGED_FNORM_NAN,
            torch.where(small0, CONVERGED_FNORM_ABS,
                        torch.zeros_like(fnorm0, dtype=torch.int32)))
        bodyA = make_body(bc, ss, accum_prev, dt, src, dyn, fnorm0, ttol)
        st = (X0, F0, fnorm0, 0, done0, reason0, A0)
        nrem = None
        while st[3] < sp.max_it:
            nrem = self._sync(torch.sum(~st[4]))
            if nrem == 0 or (K and nrem <= K):
                break
            st = bodyA(st)
            nrem = None

        if K:
            if nrem is None:
                nrem = self._sync(torch.sum(~st[4]))
            if nrem > 0:
                X, F, fnorm, it, done, reason, A = st
                # not-done first (stable)
                idx = torch.argsort(done.to(torch.int8), stable=True)[:K]
                bodyB = make_body(
                    tuple(b[idx] for b in bc), tuple(v[idx] for v in ss),
                    tuple(a[idx] for a in accum_prev), dt[idx], src[idx],
                    _take(dyn, idx), fnorm0[idx], ttol[idx])
                sB = (X[idx], F[idx], fnorm[idx], it, done[idx],
                      reason[idx], None if A is None else _take(A, idx))
                while sB[3] < sp.max_it and self._sync(torch.any(~sB[4])):
                    sB = bodyB(sB)
                Xb, Fb, fnb, itb, db, rb, _ = sB
                st = (X.index_copy(0, idx, Xb), F.index_copy(0, idx, Fb),
                      fnorm.index_copy(0, idx, fnb), itb,
                      done.index_copy(0, idx, db),
                      reason.index_copy(0, idx, rb), None)
        X, F, fnorm, iters, done, reason, _ = st
        reason = torch.where(reason == 0, DIVERGED_MAX_IT, reason)
        return X, iters, reason

    # ---- StepDT ladder (SOEBaseStepDT_SNES, per-column) --------------------
    def _step_dt_batched(self, X_prev, bc, ss, dt, src, dyn, tols):
        """One driver timestep ``dt``: per-column Newton with per-column
        dt-cut ladders (x0.5, up to max_cuts, keeping the column's previous
        solution on divergence).  Returns (X, iters, success, reason)."""
        zcol = X_prev[:, 0] * 0.0
        dt_total = float(dt) + zcol
        X = X_prev
        t = zcol
        dtc = dt_total
        ncuts = torch.zeros_like(zcol, dtype=torch.int32)
        failed = zcol < -1.0
        iters = 0
        reason = torch.zeros_like(zcol, dtype=torch.int32)
        while self._sync(torch.any((t < dt_total) & ~failed)):
            active = (t < dt_total) & ~failed
            dte = torch.minimum(dtc, dt_total - t)
            dte = torch.where(active, dte, dt_total)
            accum_prev = self._accum_prev(X, dte[:, None], dyn)
            Xn, nits, rsn = self._snes_batched(X, bc, ss, accum_prev,
                                               dte[:, None], src, dyn, tols)
            conv = rsn > 0
            ok = active & conv
            div = active & ~conv
            X = torch.where(ok[:, None], Xn, X)
            t = torch.where(ok, t + dte, t)
            ncuts = torch.where(div, ncuts + 1, ncuts)
            dtc = torch.where(div, 0.5 * dtc, dtc)
            failed = failed | (ncuts > self.max_cuts)
            reason = torch.where(active, rsn, reason)
            iters += nits
        return X, iters, (t >= dt_total) & ~failed, reason

    # ---- mass-balance audit (ALM-style, MPPVSFMALM_Driver.F90:~660) -------
    def column_storage(self, X, dyn=None):
        """Total water storage per column [kmol]: the sum of
        por*den*sat*vol over all cells (X [ncol, n])."""
        dyn = self._dyn_or_empty(dyn)
        tot = 0.0
        for k, g, a, b in self._ges():
            acc = g.accum(X[:, a:b], dyn=dyn[k])
            active = np.asarray(g.mesh.is_active, bool)
            if not active.all():
                acc = torch.where(torch.as_tensor(active, device=X.device),
                                  acc, 0.0)
            tot = tot + torch.sum(acc, dim=1)
        return tot

    def column_bc_flux(self, X, bc_values, dyn=None):
        """Net assembled BC flux per column [kmol/s], with the residual's
        sign convention (F_cell += flux)."""
        if not any(len(g._bc_concat()[0]) for g in self.goveqns):
            return X.new_zeros(X.shape[0])
        dyn = self._dyn_or_empty(dyn)
        tot = 0.0
        for k, g, a, b in self._ges():
            P = X[:, a:b]
            aux = g._cell_aux(P, dyn[k])
            bc_ids, flux_b, _, _ = g._bc_fluxes(P, aux, bc_values[k], dyn[k])
            if bc_ids.size:
                tot = tot + torch.sum(flux_b, dim=1)
        return tot

    # ---- public API --------------------------------------------------------
    def _dyn_or_empty(self, dyn):
        if dyn is None:
            return tuple({} for _ in self.goveqns)
        dyn = tuple(dict(d) for d in dyn)
        if any(("sat" in d or "perm" in d or "por_base" in d) for d in dyn) \
                and any(s.size for s in self._otr_slots):
            raise NotImplementedError(
                "dynamic constitutive parameters are not supported on "
                "problems with coupled-GE BCs (update_connections swaps "
                "BC-side parameters between GEs; the dyn gather assumes "
                "own-cell inheritance)")
        return dyn

    def step_batched(self, X, bc_values, ss_values, dt, src=None, dyn=None,
                     rtol=None, stol=None, mass_tol_kg=None):
        """Batched step: X [ncol, n]; bc_values/ss_values tuples of
        [ncol, nbc_g]/[ncol, nss_g] per GE; optional ``src`` [ncol, n]
        per-cell mass source; optional ``dyn`` tuple of per-GE
        dynamic-parameter dicts with leading [ncol] axes; optional
        ``rtol``/``stol`` overrides; optional ``mass_tol_kg`` per-column
        mass-closure gate.  Returns (X, total_newton_iters, success[ncol],
        reason[ncol])."""
        if src is None:
            src = torch.zeros_like(X)
        dyn = self._dyn_or_empty(dyn)
        sp = self.snes if X.dtype == torch.float64 else self.snes_f32
        tols = (float(sp.rtol if rtol is None else rtol),
                float(sp.stol if stol is None else stol),
                float(0.0 if mass_tol_kg is None else mass_tol_kg))
        return self._step_dt_batched(X, tuple(bc_values), tuple(ss_values),
                                     dt, src, dyn, tols)

    def gather_inputs(self, ncol=1, device="cuda", dtype=torch.float64):
        """The staged BC/SS condition values of every GE as ``[ncol, nbc]``
        / ``[ncol, nss]`` tensors (each column a copy), on the card unless
        ``device="cpu"``."""
        device = device_of(device)
        return (tuple(_rows(g.bc_value, ncol, device, dtype)
                      for g in self.goveqns),
                tuple(_rows(g.ss_value, ncol, device, dtype)
                      for g in self.goveqns))

    #: device of the serial drop-in step; :meth:`install` sets it
    serial_device = "cuda"

    def install(self, device="cuda"):
        """Route the SoE's ``step_dt`` through this stepper, so the facade
        problem drivers run on it unchanged; the serial step runs on
        ``device`` (the card unless ``device="cpu"``)."""
        self.serial_device = device_of(device)
        self.mpp.soe.step_dt = self.step_dt
        return self

    def _step_dt_serial(self, dt, istep, dyn):
        """One ``dt`` of the SoE's own solution as a single f64 column on
        ``serial_device``; updates the SoE state on convergence.  Returns
        (converged, reason)."""
        soe = self.mpp.soe
        dev = device_of(self.serial_device)
        bc, ss = self.gather_inputs(1, dev)
        X = torch.as_tensor(np.asarray(soe.soln, np.float64),
                            device=dev)[None, :]
        Xn, iters, ok, reason = self.step_batched(X, bc, ss, dt, dyn=dyn)
        converged = bool(ok[0])
        if converged:
            soe.cumulative_newton_iterations += int(iters)
            soe.soln = Xn[0].cpu().numpy().copy()
            soe.soln_prev = soe.soln
        if soe.metrics is not None:
            soe.metrics.record(step=istep, dt=dt, converged=converged,
                               reason=int(reason[0]),
                               newton_iterations=int(iters))
        return converged, int(reason[0])

    def step_dt(self, dt, istep=1):
        """Drop-in for ``soe.step_dt``: the batched path at ncol=1."""
        converged, reason = self._step_dt_serial(dt, istep, None)
        if converged:
            soln = self.mpp.soe.soln
            for g, off in zip(self.goveqns, self.offsets[:-1]):
                g.pressure = soln[off:off + g.mesh.ncells_local]
        return converged, reason


def compile_vsfm(mpp, **kw) -> CompiledVSFM:
    """Freeze a fully staged ``VSFMMPP`` into a batched stepper (after the
    8-step builder sequence, property staging and, for coupled problems,
    ``update_connections()``)."""
    return CompiledVSFM(mpp, **kw)


def vsfm_stepper(mpp, use_compiled=False, device="cuda", **kw):
    """The problem drivers' choice of stepper: the serial SNES of
    ``VSFMSoE.step_dt`` on ``device`` (the card unless ``"cpu"``), or with
    ``use_compiled`` this stepper at ncol=1 (``compile_vsfm(mpp,
    **kw).install(device)``).  Returns the compiled stepper or None."""
    device = device_of(device)
    mpp.soe.device = device
    if use_compiled:
        return compile_vsfm(mpp, **kw).install(device)
    return None

"""Batched ILU(0) + PETSc-default GMRES(30), and the padded-row CSR SpMV.

Counterpart of ``mpp_tpu/batched/ilu_gmres.py``.  The reference's SNES and
KSP inner solves are PETSc defaults: GMRES(30), left-preconditioned with
ILU(0) in natural ordering, classical Gram-Schmidt, Givens rotations,
convergence on the recurrence-estimated preconditioned residual, rtol
1e-5 (``MultiPhysicsProbBaseType.F90:1309-1317`` sets nothing beyond
defaults).  The golden trajectories embed the iterate this algorithm
stops at, so the port replicates it with a batch axis of columns.

* :class:`BatchedILU0`: the padded factor and triangular-solve schedules
  are built in numpy, as in the JAX package, plus a wavefront level for
  each row (one more than the highest level among the row's strictly
  lower neighbours; the backward sweep's levels likewise over the upper
  neighbours), and split once into an ``ops/ilu0_schedule.ILU0Schedule``:
  the connected components binned into parts, each with its own steps
  and levels.  The factor and the apply are one launch each of
  ``hopper_kernels.ilu0_factor`` / ``ilu0_apply`` on the card (a grid of
  systems x parts, the levels a loop in shared memory); on the CPU their
  plain forms run the parts' levels in lockstep: the rows of a level
  never read or write each other's slots, so all of them, and all columns
  of the batch, go in one gather / multiply / scatter, with the arithmetic
  of each row as JAX's row scan has it (the IKJ update order, the
  padded-width sum).  A level loop is ~nx+ny+nz steps on a structured
  mesh where a row loop is n.
* :func:`petsc_gmres_batched`: fixed-shape Arnoldi cycles with per-column
  convergence; a column that converges at inner step ``mj`` takes the
  mj-truncated correction.  The cycle loop and the Arnoldi loop are
  Python loops; their predicates (any column left, every column found or
  done in an earlier cycle) are read on the host through the caller's
  counted ``sync``, one read a step and one a cycle.  The Arnoldi loop
  stops once every column has converged: the steps JAX still runs then
  change no column's truncated correction.  An inner step (after the
  matvec and the preconditioner apply) is one ``hopper_kernels.
  gmres_arnoldi`` call and a cycle's end one ``gmres_update`` call: on the
  card one launch each, which also writes the loop predicate the sync
  reads (Gram-Schmidt, the Givens rotations, the back substitution and the
  bookkeeping in ``csrc/gmres_kernels.cu``, the basis made once a solve);
  on the CPU their plain forms, the eager ops over a basis zero-filled
  every cycle.  Both go through a ``hopper_kernels.GmresLauncher`` made
  once a workspace: the full check, and on the card the plan and the
  bound pointers, once a solve there (once a cycle on the CPU); a step
  checks only its fresh w and j.  ``CARD_CALLS`` counts the steps and
  cycles on the card.

Of the JAX package's ``lax.scan``, ``fori_loop`` and ``while_loop``s
(outside any Pallas kernel), the ILU(0) sweeps and GMRES's inner step and
cycle update run as hand-written kernels on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from mpp_tpu_torch.ops import hopper_kernels as hk

# PETSc's cap on GMRES cycles as the port's solves run them
MAXCYCLES = 100

#: on CUDA tensors: factorizations and applies over every BatchedILU0, and
#: GMRES inner steps and cycles over every gmres_cycles; each is one launch
#: of its kernel (hopper_kernels.LAUNCHES: ilu0_factor, ilu0_apply,
#: gmres_arnoldi, gmres_update)
CARD_CALLS = {"factor": 0, "apply": 0, "arnoldi": 0, "update": 0}


def _count(t, which):
    if t.device.type == "cuda":
        CARD_CALLS[which] += 1


def _ell_layout(indptr, indices, rows, which):
    """Padded per-row layout of the CSR slots of ``rows``: ``which(i)`` is
    the slot range of row i.  Returns (pos, col) with the pads at slot -1
    and column -1 (the caller points them at an appended zero)."""
    spans = [which(i) for i in rows]
    W = max([hi - lo for lo, hi in spans] + [1])
    pos = np.full((len(rows), W), -1, np.int64)
    col = np.full((len(rows), W), -1, np.int64)
    for r, (lo, hi) in enumerate(spans):
        pos[r, :hi - lo] = np.arange(lo, hi)
        col[r, :hi - lo] = indices[lo:hi]
    return pos, col


def _levels(deps, order):
    """Wavefront level of each row: 0 without dependencies, else one more
    than the highest level among them (``order`` visits dependencies
    first)."""
    lev = np.zeros(len(deps), np.int64)
    for i in order:
        if len(deps[i]):
            lev[i] = 1 + lev[deps[i]].max()
    return lev


class BatchedILU0:
    """ILU(0) on a fixed CSR sparsity, batched over the leading axes.

    Mirrors ``mpp_tpu/batched/ilu_gmres.py:BatchedILU0`` (PETSc PCILU
    defaults: levels=0, natural ordering, no shift): the same IKJ update
    order and triangular sweeps, scheduled by wavefront level."""

    def __init__(self, indptr, indices):
        self.indptr = indptr = np.asarray(indptr, np.int64)
        self.indices = indices = np.asarray(indices, np.int64)
        self.n = n = len(indptr) - 1
        self.nnz = nnz = int(indices.size)
        diag_pos = np.empty(n, np.int64)
        for i in range(n):
            lo, hi = indptr[i], indptr[i + 1]
            cols = indices[lo:hi]
            d = np.searchsorted(cols, i)
            if d == hi - lo or cols[d] != i:
                raise ValueError(f"row {i} missing diagonal")
            diag_pos[i] = lo + d
        self.diag_pos = diag_pos

        # ---- the IKJ schedule of each row (JAX's padded rows) --------------
        rows_low = []
        for i in range(n):
            lo, hi = indptr[i], indptr[i + 1]
            lows = []
            for p in range(lo, hi):
                k = indices[p]
                if k >= i:
                    break
                klo, khi = indptr[k], indptr[k + 1]
                kcols = indices[klo:khi]
                pairs = []
                for q in range(p + 1, hi):
                    j = indices[q]
                    r = np.searchsorted(kcols, j)
                    if r < khi - klo and kcols[r] == j and j > k:
                        pairs.append((q, klo + r))
                lows.append((p, diag_pos[k], pairs))
            rows_low.append(lows)
        self.maxL = max((len(x) for x in rows_low), default=0)
        self.maxP = max((len(pr) for x in rows_low for _, _, pr in x),
                        default=0)

        # ---- wavefront levels ---------------------------------------------
        lower = [indices[indptr[i]:diag_pos[i]] for i in range(n)]
        upper = [indices[diag_pos[i] + 1:indptr[i + 1]] for i in range(n)]
        lev_f = _levels(lower, range(n))
        lev_b = _levels(upper, range(n - 1, -1, -1))
        self.levels_fwd = int(lev_f.max(initial=-1)) + 1
        self.levels_bwd = int(lev_b.max(initial=-1)) + 1

        # factor: per (level, l), the rows' (pos_ik, diag_k) and their
        # pairs (pos_ij, pos_ik, pos_kj), the multiplier read back from its
        # slot
        def by_level(lev, nlev):
            """The rows of each level, ascending."""
            order = np.argsort(lev, kind="stable")
            cut = np.searchsorted(lev[order], np.arange(nlev + 1))
            return [order[cut[L]:cut[L + 1]] for L in range(nlev)]
        rows_f = by_level(lev_f, self.levels_fwd)

        steps = []
        for L in range(1, self.levels_fwd):
            rows = rows_f[L]
            for step in range(max(len(rows_low[i]) for i in rows)):
                lp, ld, pij, pik, pkj = [], [], [], [], []
                for i in rows:
                    if step < len(rows_low[i]):
                        p, dk, pairs = rows_low[i][step]
                        for q, qk in pairs:
                            pij.append(q)
                            pik.append(p)
                            pkj.append(qk)
                        lp.append(p)
                        ld.append(dk)
                steps.append((lp, ld, pij, pik, pkj))

        # sweeps: per level the rows and their padded (slot, column)
        # layout; pads read slot nnz / column n, an appended zero
        def sweep(lev, nlev, which, skip_empty):
            out = []
            for L, rows in enumerate(by_level(lev, nlev)):
                if skip_empty and L == 0:
                    continue               # no lower entries: y_i = b_i
                pos, col = _ell_layout(indptr, indices, rows, which)
                pos[pos < 0] = nnz
                col[col < 0] = n
                out.append((rows, pos, col))
            return out

        bwd = sweep(lev_b, self.levels_bwd,
                    lambda i: (diag_pos[i] + 1, indptr[i + 1]), False)
        self.schedule = hk.ILU0Schedule(
            indptr, indices, steps,
            sweep(lev_f, self.levels_fwd,
                  lambda i: (indptr[i], diag_pos[i]), True),
            bwd, [diag_pos[rows] for rows, _, _ in bwd])
        #: factorizations and preconditioner applies since construction
        self.factors = 0
        self.applies = 0

    def factor(self, data):
        """Numeric IKJ factorization: data ``[..., nnz]`` -> LU values
        (``hopper_kernels.ilu0_factor``)."""
        self.factors += 1
        _count(data, "factor")
        f = hk.ilu0_factor(data.reshape(-1, self.nnz).contiguous(),
                           self.schedule)
        return f.reshape(data.shape)

    def prepare(self, f):
        """The factor values in the apply's ``[B, nnz]`` contiguous form,
        made once for the many applies of a GMRES call."""
        return f.reshape(-1, self.nnz).contiguous()

    def solve(self, f, b):
        """(LU)^-1 b, batched: ``f`` the factor values ``[..., nnz]``, ``b``
        ``[..., n]`` (``hopper_kernels.ilu0_apply``)."""
        self.applies += 1
        _count(b, "apply")
        x = hk.ilu0_apply(self.prepare(f),
                          b.reshape(-1, self.n).contiguous(), self.schedule)
        return x.reshape(b.shape)


def make_ell_matvec(indptr, indices):
    """``matvec(data, x)``: y = A x for CSR data ``[..., nnz]`` and x
    ``[..., n]``, batched over the leading axes of both (counterpart of
    ``mpp_tpu/batched/ilu_gmres.py:make_ell_matvec``).  Each row is padded
    to the widest row; the padding contributes 0."""
    indptr = np.asarray(indptr, np.int64)
    indices = np.asarray(indices, np.int64)
    n = len(indptr) - 1
    W = max(int(np.diff(indptr).max(initial=0)), 1)
    pos = np.zeros((n, W), np.int64)
    col = np.zeros((n, W), np.int64)
    val = np.zeros((n, W), bool)
    for i in range(n):
        for w, p in enumerate(range(indptr[i], indptr[i + 1])):
            pos[i, w] = p
            col[i, w] = indices[p]
            val[i, w] = True
    cache = {}

    def matvec(data, x):
        key = str(x.device)
        if key not in cache:
            cache[key] = tuple(torch.as_tensor(a, device=x.device)
                               for a in (pos, col, val))
        post, colt, valt = cache[key]
        prod = torch.where(valt, data[..., post] * x[..., colt], 0.0)
        return torch.sum(prod, dim=-1)

    return matvec


def _host_sync(value):
    return bool(value.item())


def _colnorm(A):
    return torch.sqrt(torch.sum(A * A, dim=-1))


def gmres_cycles(matvec, data, b, ilu: BatchedILU0 = None, pc_data=None,
                 rtol=1e-5, atol=1e-50, restart=30, maxcycles=MAXCYCLES,
                 sync=None, full_restart=False, maxiter=None):
    """:func:`petsc_gmres_batched` with the inner iterations of each
    column: returns (x, cycles, converged[ncol], iterations[ncol]).

    The Krylov dimension is min(restart, n), as the batched JAX engine
    has it; ``full_restart`` takes ``restart`` itself, as the serial numpy
    engine does (``mpp_tpu/ops/ilu.py:petsc_gmres``), whose Arnoldi runs on
    past n steps on a small system.  ``maxiter`` caps the inner iterations
    (the cycle stops at the cap), as the numpy engine counts them."""
    sync = sync or _host_sync
    ncol, n = b.shape
    m = restart if full_restart else min(restart, n)
    pc = None if ilu is None else ilu.prepare(pc_data)

    def M(r):
        return ilu.solve(pc, r) if ilu is not None else r

    x = torch.zeros_like(b)
    r0 = M(b - matvec(data, x))
    rnorm0 = _colnorm(r0)
    tol = torch.clamp_min(rtol * rnorm0, atol)
    done = rnorm0 <= tol
    its = torch.zeros(ncol, dtype=torch.int64, device=b.device)
    # the loop predicates as the kernels write them: [every column found
    # or done after an even / odd inner step, a column left after a cycle]
    flags = torch.ones(3, dtype=torch.bool, device=b.device)
    # a cycle's truncation and converged columns, rewritten in place
    mj = torch.empty(ncol, dtype=torch.int64, device=b.device)
    found = torch.empty(ncol, dtype=torch.bool, device=b.device)
    left = torch.any(~done)
    ws = launch = None
    k = 0
    capped = False
    while k < maxcycles and not capped and sync(left):
        # the first cycle's residual is r0 itself (x is still zero)
        r = r0 if k == 0 else M(b - matvec(data, x))
        fresh = hk.gmres_workspace(b, m, ws)
        if fresh is not ws:
            # checked, and on the card planned and bound, once a workspace
            ws = fresh
            launch = hk.GmresLauncher(*ws, tol, mj, found, done, flags, x,
                                      its)
        V, H, cs, sn, g = ws
        beta = _colnorm(r)
        torch.le(beta, tol, out=found)
        V[:, 0] = r / torch.where(beta == 0, 1.0, beta)[:, None]
        g[:, 0] = beta
        mj.fill_(m).masked_fill_(found, 0)
        for j in range(m):
            w = M(matvec(data, V[:, j])).contiguous()
            # a column still running has taken k*m + j + 1 inner steps
            cap = maxiter is not None and k * m + j + 1 >= maxiter
            _count(b, "arnoldi")
            launch.arnoldi(w, j, cap)
            if cap:
                capped = True
                break
            # columns done in an earlier cycle keep x whatever this one
            # computes for them, so they do not hold the loop
            if j + 1 < m and sync(flags[j % 2]):
                break
        _count(b, "update")
        launch.update()
        left = flags[2]
        k += 1
    return x, k, done, its


def petsc_gmres_batched(matvec, data, b, ilu: BatchedILU0 = None,
                        pc_data=None, rtol=1e-5, atol=1e-50, restart=30,
                        maxcycles=MAXCYCLES, sync=None):
    """Batched GMRES(m) replicating PETSc's KSPGMRES defaults
    (``mpp_tpu/batched/ilu_gmres.py:petsc_gmres_batched``).

    ``matvec(data, x)``: batched SpMV; ``b`` [ncol, n] (the dtype and
    device of the solve); ``ilu``/``pc_data``: the left preconditioner
    (:class:`BatchedILU0` and its factor values, or their
    :meth:`BatchedILU0.prepare` form); ``sync(flag)``: reads a device bool
    on the host (the caller's counted synchronisation).  Returns (x,
    cycles, converged[ncol]): the convergence mask mirrors
    KSPGetConvergedReason as the reference's KSP stepper surfaces it
    (SystemOfEquationsBaseType.F90:625-645)."""
    x, k, done, _ = gmres_cycles(matvec, data, b, ilu, pc_data, rtol, atol,
                                 restart, maxcycles, sync)
    return x, k, done

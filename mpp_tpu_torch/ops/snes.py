"""SNES-compatible Newton solver with line searches, and the batched
Newton's parameter set.

Counterpart of ``mpp_tpu/ops/snes.py``.  The reference's golden answers
embed the exact Newton / line-search / GMRES trajectory of PETSc's
defaults (``soe/SystemOfEquationsBaseType.F90:368-552``), so the serial
:func:`snes_solve` replicates, as the JAX package's numpy path does:

* SNESSolve_NEWTONLS iteration structure, with the stol exit of a failed
  line search whose full Newton update is already negligible;
* SNESLineSearchBT (cubic backtracking, alpha=1e-4, steptol=1e-12,
  max_it=40, damping=1), plus BASIC, L2 and CP, used by the dynamic
  line-search rotation;
* SNESConvergedDefault (atol=1e-50, rtol=1e-8, stol from the caller,
  divtol=1e4, max_it=50, max_funcs=10000);
* inner KSP = GMRES(30) + ILU(0) at rtol 1e-5 (``ops/ilu.py``).

The control flow and every vector norm stay in host f64 numpy, as in the
JAX package, so that the branch decisions match it bit for bit.  The
residual and the Jacobian are evaluated by the caller on its device; the
ILU(0) factor, the GMRES solve and the line search's J Y run on the
device of the Jacobian's values.  Each crossing of a device vector to the
host (a residual, a Newton direction, J Y, a GMRES predicate) is one host
sync, counted by :class:`HostSyncs`; with the NaN trap of ``config.py``
armed, each residual and each Newton direction is checked.

``SNESParams`` is the constant set of SNESConvergedDefault +
SNESLineSearchBT used by the compiled batched stepper
(``mpp_tpu/batched/vsfm_compiled.py:52-66``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from mpp_tpu_torch.config import check_finite
from mpp_tpu_torch.ops.ilu import ILU0, csr_matvec, petsc_gmres

CONVERGED_FNORM_ABS = 2
CONVERGED_FNORM_RELATIVE = 3
CONVERGED_SNORM_RELATIVE = 4
CONVERGED_ITERATING = 0
DIVERGED_FUNCTION_COUNT = -2
DIVERGED_FNORM_NAN = -4
DIVERGED_MAX_IT = -5
DIVERGED_LINE_SEARCH = -6
DIVERGED_DTOL = -8

LS_BASIC = "basic"
LS_BT = "bt"
LS_L2 = "l2"
LS_CP = "cp"


class SNESParams(NamedTuple):
    """SNESConvergedDefault + SNESLineSearchBT constants."""
    atol: float = 1e-50
    rtol: float = 1e-8
    stol: float = 1e-10
    max_it: int = 50
    divtol: float = 1e4
    ls_alpha: float = 1e-4
    ls_maxstep: float = 1e8
    ls_steptol: float = 1e-12
    ls_max_it: int = 40
    ls_damping: float = 1.0
    ksp_rtol: float = 1e-5
    ksp_atol: float = 1e-50
    ksp_restart: int = 30


@dataclasses.dataclass
class SNESOptions:
    atol: float = 1e-50
    rtol: float = 1e-8
    stol: float = 1e-10
    max_it: int = 50
    max_funcs: int = 10000
    divtol: float = 1e4
    linesearch: str = LS_BT
    ls_alpha: float = 1e-4
    ls_maxstep: float = 1e8
    ls_steptol: float = 1e-12
    ls_max_it: int = 40
    ls_damping: float = 1.0
    ksp_rtol: float = 1e-5
    ksp_atol: float = 1e-50
    ksp_restart: int = 30
    ksp_maxiter: int = 10000


@dataclasses.dataclass
class SNESResult:
    x: np.ndarray
    reason: int
    iterations: int
    linear_iterations: int
    fnorm: float


class HostSyncs:
    """Counts the serial solver's device-to-host crossings: ``download``
    copies a device vector to a host f64 numpy array, ``flag`` reads a
    device bool (both one sync, also on the CPU, where they cost a copy)."""

    def __init__(self):
        self.n = 0

    def download(self, t):
        self.n += 1
        return t.detach().to("cpu", torch.float64).numpy()

    def flag(self, t):
        self.n += 1
        return bool(t.item())


def _ls_bt(func, X, F, fnorm, Y, jac_matvec, opts, nfuncs):
    """SNESLineSearchBT with cubic order (PETSc linesearchbt.c semantics).

    Returns (success, X_new, F_new, fnorm_new, lambda, ynorm, nfuncs).
    """
    alpha = opts.ls_alpha
    ynorm = np.linalg.norm(Y)
    if ynorm == 0.0:
        return True, X.copy(), F.copy(), fnorm, 1.0, 0.0, nfuncs
    if ynorm > opts.ls_maxstep:
        Y = Y * (opts.ls_maxstep / ynorm)
        ynorm = opts.ls_maxstep
    minlambda = opts.ls_steptol / ynorm

    W = jac_matvec(Y)
    initslope = float(np.dot(F, W))
    if initslope > 0.0:
        initslope = -initslope
    if initslope == 0.0:
        initslope = -1.0

    lam = opts.ls_damping
    Xw = X - lam * Y
    G = func(Xw)
    nfuncs += 1
    gnorm = np.linalg.norm(G)
    if 0.5 * gnorm * gnorm <= 0.5 * fnorm * fnorm + lam * alpha * initslope:
        return True, Xw, G, gnorm, lam, lam * ynorm, nfuncs

    # initial backtrack: quadratic model
    lambdatemp = -initslope / (gnorm * gnorm - fnorm * fnorm
                               - 2.0 * lam * initslope)
    lambdaprev = lam
    gnormprev = gnorm
    if lambdatemp > 0.5 * lam:
        lambdatemp = 0.5 * lam
    if lambdatemp <= 0.1 * lam:
        lam = 0.1 * lam
    else:
        lam = lambdatemp
    Xw = X - lam * Y
    G = func(Xw)
    nfuncs += 1
    gnorm = np.linalg.norm(G)

    for _ in range(opts.ls_max_it):
        if (0.5 * gnorm * gnorm
                <= 0.5 * fnorm * fnorm + lam * alpha * initslope):
            return True, Xw, G, gnorm, lam, lam * ynorm, nfuncs
        if lam <= minlambda:
            return False, Xw, G, gnorm, lam, lam * ynorm, nfuncs
        # cubic model
        t1 = 0.5 * (gnorm * gnorm - fnorm * fnorm) - lam * initslope
        t2 = (0.5 * (gnormprev * gnormprev - fnorm * fnorm)
              - lambdaprev * initslope)
        a = (t1 / (lam * lam) - t2 / (lambdaprev * lambdaprev)) \
            / (lam - lambdaprev)
        b = (-lambdaprev * t1 / (lam * lam)
             + lam * t2 / (lambdaprev * lambdaprev)) / (lam - lambdaprev)
        d = b * b - 3.0 * a * initslope
        if d < 0.0:
            d = 0.0
        if a == 0.0:
            lambdatemp = -initslope / (2.0 * b)
        else:
            lambdatemp = (-b + np.sqrt(d)) / (3.0 * a)
        lambdaprev = lam
        gnormprev = gnorm
        if lambdatemp > 0.5 * lam:
            lambdatemp = 0.5 * lam
        if lambdatemp <= 0.1 * lam:
            lam = 0.1 * lam
        else:
            lam = lambdatemp
        Xw = X - lam * Y
        G = func(Xw)
        nfuncs += 1
        gnorm = np.linalg.norm(G)
    # exceeded ls_max_it
    return False, Xw, G, gnorm, lam, lam * ynorm, nfuncs


def _ls_basic(func, X, F, fnorm, Y, jac_matvec, opts, nfuncs):
    """Full step (SNESLINESEARCHBASIC) with damping."""
    lam = opts.ls_damping
    ynorm = np.linalg.norm(Y)
    Xw = X - lam * Y
    G = func(Xw)
    nfuncs += 1
    gnorm = np.linalg.norm(G)
    return (bool(np.isfinite(gnorm)), Xw, G, gnorm, lam, lam * ynorm,
            nfuncs)


def _ls_l2(func, X, F, fnorm, Y, jac_matvec, opts, nfuncs):
    """SNESLineSearchL2: one secant step (PETSc's default max_it for l2)
    on the derivative of ||F(x - lam Y)||^2 (linesearchl2.c)."""
    lam = opts.ls_damping
    ynorm = np.linalg.norm(Y)
    if ynorm == 0.0:
        return True, X.copy(), F.copy(), fnorm, 1.0, 0.0, nfuncs
    lam_old = 0.0
    fnrm_old = fnorm * fnorm
    Xw = X - lam * Y
    G = func(Xw)
    nfuncs += 1
    fnrm = float(np.dot(G, G))
    for _ in range(1):
        if fnrm == fnrm_old:
            break
        lam_update = lam - 0.5 * fnrm * (lam - lam_old) / (fnrm - fnrm_old)
        if not np.isfinite(lam_update) or lam_update > 1e100:
            break
        lam_old, fnrm_old = lam, fnrm
        lam = lam_update
        Xw = X - lam * Y
        G = func(Xw)
        nfuncs += 1
        fnrm = float(np.dot(G, G))
    gnorm = np.sqrt(fnrm)
    return (bool(np.isfinite(gnorm)), Xw, G, gnorm, lam, abs(lam) * ynorm,
            nfuncs)


def _ls_cp(func, X, F, fnorm, Y, jac_matvec, opts, nfuncs):
    """SNESLineSearchCP: one secant step on <F(x - lam Y), Y>."""
    lam = opts.ls_damping
    ynorm = np.linalg.norm(Y)
    if ynorm == 0.0:
        return True, X.copy(), F.copy(), fnorm, 1.0, 0.0, nfuncs
    lam_old = 0.0
    fty_old = float(np.dot(F, Y))
    Xw = X - lam * Y
    G = func(Xw)
    nfuncs += 1
    fty = float(np.dot(G, Y))
    for _ in range(1):
        if fty == fty_old:
            break
        lam_update = lam - fty * (lam - lam_old) / (fty - fty_old)
        if not np.isfinite(lam_update) or lam_update > 1e100:
            break
        lam_old, fty_old = lam, fty
        lam = lam_update
        Xw = X - lam * Y
        G = func(Xw)
        nfuncs += 1
        fty = float(np.dot(G, Y))
    gnorm = np.linalg.norm(G)
    return (bool(np.isfinite(gnorm)), Xw, G, gnorm, lam, abs(lam) * ynorm,
            nfuncs)


_LINESEARCHES = {LS_BT: _ls_bt, LS_BASIC: _ls_basic, LS_L2: _ls_l2,
                 LS_CP: _ls_cp}


def snes_solve(func: Callable, jac: Callable, x0: np.ndarray,
               opts: Optional[SNESOptions] = None,
               syncs: Optional[HostSyncs] = None) -> SNESResult:
    """Newton-with-line-search solve of F(x) = 0.

    ``func(x) -> F``: host f64 numpy in and out (the caller evaluates on
    its device and counts the download).  ``jac(x) -> (indptr, indices,
    data)``: the CSR Jacobian, ``data`` a tensor [nnz] on the device of the
    solve.  Inner solves are GMRES(30) + ILU(0) like PETSc's defaults;
    ``syncs`` counts the solver's own host reads (a new
    :class:`HostSyncs` if not given)."""
    opts = opts or SNESOptions()
    syncs = syncs if syncs is not None else HostSyncs()
    ls = _LINESEARCHES[opts.linesearch]
    X = np.array(x0, np.float64, copy=True)
    nfuncs = 0
    lin_its_total = 0

    F = func(X)
    nfuncs += 1
    fnorm = np.linalg.norm(F)
    if not np.isfinite(fnorm):
        return SNESResult(X, DIVERGED_FNORM_NAN, 0, 0, fnorm)
    ttol = fnorm * opts.rtol
    rnorm0 = fnorm
    if fnorm < opts.atol:
        return SNESResult(X, CONVERGED_FNORM_ABS, 0, 0, fnorm)

    ilu = None
    num_ls_failures = 0
    max_ls_failures = 1  # snes->maxFailures default

    for it in range(opts.max_it):
        indptr, indices, data = jac(X)
        if ilu is None:
            ilu = ILU0(indptr, indices)
        lu = ilu.factor(data)
        Fd = torch.as_tensor(F, dtype=data.dtype, device=data.device)
        Yd, lin_its, _ = petsc_gmres(indptr, indices, data, Fd, pc=ilu,
                                     pc_data=lu, rtol=opts.ksp_rtol,
                                     atol=opts.ksp_atol,
                                     restart=opts.ksp_restart,
                                     maxiter=opts.ksp_maxiter,
                                     sync=syncs.flag)
        lin_its_total += lin_its
        Y = syncs.download(Yd)
        check_finite("snes_solve: Newton direction", Y)

        def jac_matvec(v, indptr=indptr, indices=indices, data=data):
            vd = torch.as_tensor(v, dtype=data.dtype, device=data.device)
            return syncs.download(csr_matvec(indptr, indices, data, vd))

        X_pre, F_pre, fnorm_pre = X, F, fnorm
        ok, X, F, fnorm, lam, snorm, nfuncs = ls(
            func, X, F, fnorm, Y, jac_matvec, opts, nfuncs)
        if not ok:
            # PETSc SNESSolve_NEWTONLS failure path (ls.c): a failed line
            # search whose full Newton update is already negligible
            # (stol*xnorm > ynorm) exits CONVERGED_SNORM_RELATIVE at the
            # pre-step iterate, the near-equilibrium case
            if opts.stol * np.linalg.norm(X_pre) > np.linalg.norm(Y):
                return SNESResult(X_pre, CONVERGED_SNORM_RELATIVE, it + 1,
                                  lin_its_total, fnorm_pre)
            num_ls_failures += 1
            if num_ls_failures >= max_ls_failures:
                return SNESResult(X, DIVERGED_LINE_SEARCH, it + 1,
                                  lin_its_total, fnorm)
        xnorm = np.linalg.norm(X)

        # SNESConvergedDefault at iteration it+1
        if not np.isfinite(fnorm):
            return SNESResult(X, DIVERGED_FNORM_NAN, it + 1, lin_its_total,
                              fnorm)
        if fnorm < opts.atol:
            return SNESResult(X, CONVERGED_FNORM_ABS, it + 1, lin_its_total,
                              fnorm)
        if nfuncs >= opts.max_funcs:
            return SNESResult(X, DIVERGED_FUNCTION_COUNT, it + 1,
                              lin_its_total, fnorm)
        if snorm < opts.stol * xnorm:
            return SNESResult(X, CONVERGED_SNORM_RELATIVE, it + 1,
                              lin_its_total, fnorm)
        if fnorm <= ttol:
            return SNESResult(X, CONVERGED_FNORM_RELATIVE, it + 1,
                              lin_its_total, fnorm)
        if fnorm >= opts.divtol * rnorm0:
            return SNESResult(X, DIVERGED_DTOL, it + 1, lin_its_total, fnorm)

    return SNESResult(X, DIVERGED_MAX_IT, opts.max_it, lin_its_total, fnorm)


def snes_step_dt(soe, dt, nstep, residual, jacobian, ls_list):
    """SOEBaseStepDT_SNES (SystemOfEquationsBaseType.F90:368-552) over a
    serial SoE: ``soe.pre_solve(dt)``, :func:`snes_solve` from
    ``soe.soln`` with the line search ``ls_list`` rotates through on
    failure (when ``soe.use_dynamic_linesearch``), then halving dt, up to
    20 cuts.  ``residual(X, dt)`` / ``jacobian(X, dt)`` are the SoE's
    callbacks; ``soe.post_solve(x)`` takes a converged iterate.  Counts
    the iterations and host syncs on ``soe``, records ``soe.metrics``.
    Returns (converged, reason)."""
    time = 0.0
    dt_iter = dt
    num_time_cuts = 0
    max_num_time_cuts = 20
    linesearch_iter = 0
    converged = False
    reason = 0
    res = None
    while True:
        soe.pre_solve(dt_iter)
        opts = SNESOptions(stol=soe.snes_stol,
                           linesearch=ls_list[linesearch_iter])
        res = snes_solve(lambda X: residual(X, dt_iter),
                         lambda X: jacobian(X, dt_iter),
                         np.asarray(soe.soln), opts, soe.syncs)
        reason = res.reason
        if res.reason < 0:
            linesearch_iter += 1
            if not (soe.use_dynamic_linesearch
                    and linesearch_iter < len(ls_list)):
                linesearch_iter = 0
                num_time_cuts += 1
                dt_iter = 0.5 * dt_iter
            soe.soln = soe.soln_prev
        else:
            converged = True
            time += dt_iter
            soe.cumulative_newton_iterations += res.iterations
            soe.cumulative_linear_iterations += res.linear_iterations
            soe.post_solve(res.x)
        if num_time_cuts > max_num_time_cuts:
            converged = False
            break
        if time >= dt:
            break
    if soe.metrics is not None:
        soe.metrics.record(
            step=nstep, dt=dt, dt_used=dt_iter, converged=converged,
            reason=int(reason), dt_cuts=num_time_cuts,
            newton_iterations=int(res.iterations),
            linear_iterations=int(res.linear_iterations),
            fnorm=float(res.fnorm))
    return converged, reason

"""Krylov linear solvers: CG, BiCGStab, GMRES(m) (the KSP replacement).

Counterpart of ``mpp_tpu/ops/krylov.py`` (which replaces PETSc KSP,
``soe/SystemOfEquationsBaseType.F90:555-647``).  Every solver takes a
``matvec`` closure (CSR SpMV, batched tridiagonal or dense) and an
optional left preconditioner ``M`` (a closure y = M^{-1} r) on 1-D
tensors of one device.

The loops are plain Python loops over tensors with the JAX loops'
stopping rules and iteration counts: ||r||_2 <= max(rtol * ||b||_2, atol)
(PETSc KSPConvergedDefault; GMRES measures the preconditioned residual),
tested before every iteration.  The test reads the device on the host
once an iteration; ``KrylovResult.host_syncs`` counts those reads.  GMRES
keeps the JAX form's arithmetic: modified Gram-Schmidt, Givens
rotations, every one of the m Arnoldi steps of a cycle, and ``maxiter``
counting cycles.  The default rtol is tight (1e-12), as the reference's
answers came from solves converged to machine precision.

Known fault, shared with the JAX form (ROADMAP Queue 3): the GMRES
cycle's rotation loop zeroes each new subdiagonal entry before its
Givens rotation, so a cycle is one Galerkin step along its first Arnoldi
vector, not a GMRES(m) cycle (see :func:`gmres`).  No solver path of
either package calls this ``gmres``; the serial and batched solves use
``ops/ilu.petsc_gmres`` / ``batched/ilu_gmres``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class KrylovResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorm: torch.Tensor
    converged: bool
    #: device-to-host reads of the solve (the loop tests)
    host_syncs: int


def _identity(r):
    return r


def _tol(b, rtol, atol):
    return torch.clamp_min(rtol * torch.linalg.norm(b), atol)


def cg(matvec: Callable, b: torch.Tensor, x0: Optional[torch.Tensor] = None,
       M: Optional[Callable] = None, rtol: float = 1e-12, atol: float = 0.0,
       maxiter: int = 10000) -> KrylovResult:
    """Preconditioned conjugate gradients for SPD systems."""
    M = M or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    tol = _tol(b, rtol, atol)
    r = b - matvec(x)
    z = M(r)
    p = z
    rz = torch.vdot(r, z)
    k = syncs = 0
    while True:
        syncs += 1
        if not (bool(torch.linalg.norm(r) > tol) and k < maxiter):
            break
        Ap = matvec(p)
        alpha = rz / torch.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = torch.vdot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        k += 1
    rn = torch.linalg.norm(r)
    return KrylovResult(x, k, rn, bool(rn <= tol), syncs + 1)


def bicgstab(matvec: Callable, b: torch.Tensor,
             x0: Optional[torch.Tensor] = None, M: Optional[Callable] = None,
             rtol: float = 1e-12, atol: float = 0.0,
             maxiter: int = 10000) -> KrylovResult:
    """Preconditioned BiCGStab for general (nonsymmetric) systems."""
    M = M or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    tol = _tol(b, rtol, atol)
    r = b - matvec(x)
    rhat = r
    eps = torch.finfo(b.dtype).tiny
    p = v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    k = syncs = 0
    while True:
        syncs += 1
        if not (bool(torch.linalg.norm(r) > tol) and k < maxiter):
            break
        rho_new = torch.vdot(rhat, r)
        beta = (rho_new / torch.where(rho == 0, eps, rho)) * (
            alpha / torch.where(omega == 0, eps, omega))
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = matvec(phat)
        alpha = rho_new / torch.vdot(rhat, v)
        s = r - alpha * v
        shat = M(s)
        t = matvec(shat)
        tt = torch.vdot(t, t)
        omega = torch.vdot(t, s) / torch.where(tt == 0, eps, tt)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
    rn = torch.linalg.norm(r)
    return KrylovResult(x, k, rn, bool(rn <= tol), syncs + 1)


def _gmres_cycle(matvec, M, b, x, m, tol):
    """One GMRES(m) cycle from x: all m Arnoldi steps (steps after
    convergence are harmless), then the triangular solve; returns the
    new x."""
    n = b.shape[0]
    r = M(b - matvec(x))
    beta = torch.linalg.norm(r)
    V = b.new_zeros((m + 1, n))
    V[0] = r / torch.where(beta == 0, 1.0, beta)
    H = b.new_zeros((m + 1, m))
    cs = b.new_zeros(m)
    sn = b.new_zeros(m)
    g = b.new_zeros(m + 1)
    g[0] = beta
    for j in range(m):
        w = M(matvec(V[j]))
        # modified Gram-Schmidt against v_0..v_j
        hcol = b.new_zeros(m + 1)
        for i in range(j + 1):
            hij = torch.vdot(V[i], w)
            w = w - hij * V[i]
            hcol[i] = hij
        hlast = torch.linalg.norm(w)
        hcol[j + 1] = hlast
        V[j + 1] = w / torch.where(hlast == 0, 1.0, hlast)
        # the rotations of the JAX form's loop over all m slots: slots
        # i < j rotate (hcol[i], hcol[i+1]); every slot i also rewrites
        # hcol[i+1] with the not-yet-set (zero) cs[i] / sn[i] for i >= j
        for i in range(m):
            a, c = hcol[i].clone(), hcol[i + 1].clone()
            hcol[i + 1] = -sn[i] * a + cs[i] * c
            if i < j:
                hcol[i] = cs[i] * a + sn[i] * c
        # the new rotation, zeroing hcol[j+1]
        denom = torch.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
        denom = torch.where(denom == 0, 1.0, denom)
        c, s = hcol[j] / denom, hcol[j + 1] / denom
        hcol[j] = c * hcol[j] + s * hcol[j + 1]
        hcol[j + 1] = 0.0
        cs[j] = c
        sn[j] = s
        gj = g[j].clone()
        g[j + 1] = -s * gj
        g[j] = c * gj
        H[:, j] = hcol
    # back-substitution H[:m, :m] y = g[:m] (upper triangular)
    y = b.new_zeros(m)
    for i in range(m):
        j = m - 1 - i
        num = g[j] - torch.dot(H[j, :], y)
        hjj = H[j, j]
        y[j] = num / torch.where(hjj == 0, 1.0, hjj)
    return x + torch.einsum("i,in->n", y, V[:m])


def gmres(matvec: Callable, b: torch.Tensor,
          x0: Optional[torch.Tensor] = None, M: Optional[Callable] = None,
          restart: int = 30, rtol: float = 1e-12, atol: float = 0.0,
          maxiter: int = 1000) -> KrylovResult:
    """Left-preconditioned restarted GMRES(m) with modified Gram-Schmidt,
    as the JAX form computes it.

    ``maxiter`` counts outer restarts.

    Not real GMRES: the rotation loop of :func:`_gmres_cycle` applies the
    not-yet-set rotation cs[j] = sn[j] = 0 at slot j, which zeroes the new
    subdiagonal entry, so the least-squares right-hand side keeps only
    g[0] and every cycle returns x + (beta / h00) v0, one Galerkin step
    along the preconditioned residual; m - 1 of its m matvecs are wasted
    and a system of n <= m unknowns does not converge in one cycle.  The
    JAX form does the same (ROADMAP Queue 3,
    ``tests/test_torch_krylov.py::test_gmres_cycle_is_one_step_along_v0``).
    Use ``ops/ilu.petsc_gmres`` for a real GMRES."""
    M = M or _identity
    x = torch.zeros_like(b) if x0 is None else x0
    m = min(restart, b.shape[0])
    tol = _tol(M(b), rtol, atol)
    k = syncs = 0
    while True:
        syncs += 1
        rn = torch.linalg.norm(M(b - matvec(x)))
        if not (bool(rn > tol) and k < maxiter):
            break
        x = _gmres_cycle(matvec, M, b, x, m, tol)
        k += 1
    return KrylovResult(x, k, rn, bool(rn <= tol), syncs + 1)


def jacobi_preconditioner(diag: torch.Tensor) -> Callable:
    inv = 1.0 / diag
    return lambda r: inv * r


def dense_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Direct dense solve: the exact answer for small systems."""
    return torch.linalg.solve(A, b)

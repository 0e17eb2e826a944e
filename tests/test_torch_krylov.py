"""The port's Krylov solvers (mpp_tpu_torch/ops/krylov.py) against the JAX
package's (mpp_tpu/ops/krylov.py), on the CPU in f64.

Two systems of n = 256 from numpy seed 0: an SPD one (A A^T + 12.8 I)
and a nonsymmetric one (4 I + noise).  Every solver runs on both, with
and without the Jacobi preconditioner: equal iteration counts and
convergence flags, solutions within 1e-10 (absolute; |x| ~ 1).  CG on
the nonsymmetric system does not converge in either package and stops
at its 10000-iteration cap; it is held all the same.  ``dense_solve``
within 1e-12.

``test_gmres_cycle_is_one_step_along_v0`` shows a fault that both
packages' ``gmres`` share (ROADMAP Queue 3): on a nonsymmetric system of
n = 8 < m = 30, where real GMRES converges within one cycle of n inner
iterations (``ops/ilu.petsc_gmres`` here), one cycle of either package
returns the Galerkin step x0 + (r.r / r.Ar) r along the first residual
(within 1e-12 relative), and the solve needs many cycles (equal counts
in both packages).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpp_tpu.ops import krylov as jk
from mpp_tpu_torch.ops import krylov as tk

N = 256
ATOL = 1e-10


def _systems():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((N, N)) * 0.1
    spd = a @ a.T + N * 0.05 * np.eye(N)
    nonsym = np.eye(N) * 4.0 + rng.standard_normal((N, N)) * 0.1
    b = rng.standard_normal(N)
    return {"spd": spd, "nonsym": nonsym}, b


SYSTEMS, RHS = _systems()


@pytest.mark.parametrize("system", ["spd", "nonsym"])
@pytest.mark.parametrize("jacobi", [False, True])
@pytest.mark.parametrize("solver", ["cg", "bicgstab", "gmres"])
def test_solver_matches_jax(solver, jacobi, system):
    A = SYSTEMS[system]
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    dj = jnp.asarray(np.diag(A).copy())
    dt = torch.as_tensor(np.diag(A).copy())
    rj = getattr(jk, solver)(lambda x: Aj @ x, jnp.asarray(RHS),
                             M=jk.jacobi_preconditioner(dj) if jacobi
                             else None)
    rt = getattr(tk, solver)(lambda x: At @ x, torch.as_tensor(RHS),
                             M=tk.jacobi_preconditioner(dt) if jacobi
                             else None)
    assert rt.iters == int(rj.iters)
    assert rt.converged == bool(rj.converged)
    assert rt.converged or (solver == "cg" and system == "nonsym")
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(float(rt.resnorm), float(rj.resnorm),
                               rtol=1e-6, atol=1e-13)
    # one host read a loop test, one for the final flag
    assert rt.host_syncs == rt.iters + 2


def test_dense_solve_matches_jax():
    A = SYSTEMS["nonsym"]
    xj = np.asarray(jk.dense_solve(jnp.asarray(A), jnp.asarray(RHS)))
    xt = tk.dense_solve(torch.as_tensor(A), torch.as_tensor(RHS)).numpy()
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-12)


def test_gmres_cycle_is_one_step_along_v0():
    n = 8
    rng = np.random.default_rng(1)
    A = np.eye(n) * 4.0 + rng.standard_normal((n, n))
    b = rng.standard_normal(n)
    Aj, At = jnp.asarray(A), torch.as_tensor(A)
    bt = torch.as_tensor(b)
    # a real GMRES(30) converges in at most n inner iterations
    from mpp_tpu_torch.ops.ilu import petsc_gmres
    rows, cols = np.nonzero(np.ones((n, n)))
    indptr = np.arange(0, n * n + 1, n)
    x_ref, inner, ok = petsc_gmres(indptr, cols, At[rows, cols], bt,
                                   rtol=1e-12, restart=30)
    assert ok and inner <= n
    # one cycle of either package: x = (r.r / r.Ar) r from x0 = 0
    step = b * (b @ b) / (b @ A @ b)
    one_t = tk.gmres(lambda x: At @ x, bt, maxiter=1)
    one_j = jk.gmres(lambda x: Aj @ x, jnp.asarray(b), maxiter=1)
    assert one_t.iters == int(one_j.iters) == 1
    np.testing.assert_allclose(one_t.x.numpy(), step, rtol=1e-12)
    np.testing.assert_allclose(np.asarray(one_j.x), step, rtol=1e-12)
    # so the whole solve takes many cycles, the same number in both
    rt = tk.gmres(lambda x: At @ x, bt)
    rj = jk.gmres(lambda x: Aj @ x, jnp.asarray(b))
    assert rt.converged and bool(rj.converged)
    assert rt.iters == int(rj.iters) > 1
    np.testing.assert_allclose(rt.x.numpy(), x_ref.numpy(), rtol=0,
                               atol=1e-10)

"""The non-tridiagonal plans of the port's CompiledVSFM (batched ILU(0) +
GMRES(30) "petsc", block-Thomas and dense-LU "direct") on the ported
VSFM problems (vchannel and SPAC here, spac_campbell in
tests/test_torch_vsfm_campbell.py), against the JAX package's same plan.

Each problem is built by both packages' drivers from the same arguments
and stepped by the compiled steppers at ncol=1, f64: the port's on the
CPU, the JAX package's ``compile_vsfm(mpp, linear_solver=plan)``.  Every
step must agree in convergence and SNES reason, the cumulative Newton
iterations must be equal, and the pressures agree at rtol 1e-9 (the
plans are compared like with like: "petsc" and "direct" agree only within
the Newton stop criterion's determinacy band).
"""
import numpy as np
import pytest
import torch

from mpp_tpu.batched.vsfm_compiled import compile_vsfm as jcompile
from mpp_tpu.problems import vsfm_spac as jspac
from mpp_tpu.problems import vsfm_vchannel as jvch
from mpp_tpu_torch.batched.vsfm_compiled import compile_vsfm
from mpp_tpu_torch.constants import AuxVarKind, Var
from mpp_tpu_torch.ops import hopper_kernels as hk
from mpp_tpu_torch.problems import vsfm_spac as tspac
from mpp_tpu_torch.problems import vsfm_vchannel as tvch

RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# name: (JAX driver, port driver, kwargs, dt, nstep, per-step staging);
# spac_campbell's are in tests/test_torch_vsfm_campbell.py
PROBLEMS = {
    "vchannel_nz2": (jvch.run_vsfm_vchannel_problem,
                     tvch.run_vsfm_vchannel_problem, {"nz": 2}, 8640.0, 1,
                     None),
    "spac": (jspac.run_vsfm_spac_problem, tspac.run_vsfm_spac_problem, {},
             3600.0, 2, None),
}


def _steps(mpp, dt, nstep, stage):
    out = []
    for istep in range(1, nstep + 1):
        if stage is not None:
            stage(mpp, dt)
        out.append(tuple(mpp.soe.step_dt(dt, istep)))
    return out


def run_pair(problem, plan, **stepper_kw):
    """Build ``problem`` (a PROBLEMS entry) with both drivers, install
    ``plan``'s stepper in each and step both; returns (JAX mpp, JAX
    stepper, port mpp, port stepper, JAX step results, port's)."""
    jrun, trun, kw, dt, nstep, make_stage = problem
    mj = jrun(nstep=0, **kw)
    cj = jcompile(mj, linear_solver=plan, **stepper_kw).install()
    mt = trun(nstep=0, use_compiled=True, linear_solver=plan, device="cpu",
              **kw)
    ct = mt.soe.step_dt.__self__
    if stepper_kw:
        ct = compile_vsfm(mt, linear_solver=plan, **stepper_kw).install("cpu")
    stage = make_stage or (lambda: None)
    rj = _steps(mj, dt, nstep, stage())
    rt = _steps(mt, dt, nstep, stage())
    return mj, cj, mt, ct, rj, rt


def check_plan_matches_jax(problem, plan):
    mj, cj, mt, ct, rj, rt = run_pair(problem, plan)
    # the JAX package's choice: block-Thomas where a block size covers
    # the pattern (vchannel's 200-cell levels), else dense LU
    expect = "petsc" if plan == "petsc" else (
        "block" if cj.block_size else "dense")
    assert ct.plan == expect and not ct.is_tridiag
    assert ct.block_size == cj.block_size
    assert rt == rj and all(ok for ok, _ in rt)
    assert mt.soe.cumulative_newton_iterations \
        == mj.soe.cumulative_newton_iterations
    Pj = mj.get_data(AuxVarKind.INTERNAL, Var.PRESSURE)
    Pt = mt.get_data(AuxVarKind.INTERNAL, Var.PRESSURE)
    np.testing.assert_allclose(Pt, Pj, rtol=RTOL)
    if plan == "petsc":
        assert ct.gmres_cycles > 0 and ct.gmres_unconverged() == 0
    else:
        assert ct.gmres_cycles == 0
    assert hk.LAUNCHES["thomas"] == 0          # CPU tensors: plain forms


@pytest.mark.parametrize("plan", ["petsc", "direct"])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_plan_matches_jax(name, plan):
    check_plan_matches_jax(PROBLEMS[name], plan)


def test_fused_linesearch_on_spac_matches_jax():
    """linesearch_jac="fused" carries the CSR Jacobian of the full-step
    trial into the next iteration, as JAX's fused mode does."""
    mj, cj, mt, ct, rj, rt = run_pair(PROBLEMS["spac"], "petsc",
                                      linesearch_jac="fused")
    assert ct._ls_fused and rt == rj
    np.testing.assert_allclose(
        mt.get_data(AuxVarKind.INTERNAL, Var.PRESSURE),
        mj.get_data(AuxVarKind.INTERNAL, Var.PRESSURE), rtol=RTOL)


def test_dense_and_block_plans_solve_the_jacobian():
    """The direct plans' Newton direction solves the assembled CSR
    Jacobian (dense numpy solve of CSRTemplate.to_dense)."""
    for name in ("vchannel_nz2", "spac"):
        _, trun, kw, *_ = PROBLEMS[name]
        mt = trun(nstep=0, use_compiled=True, linear_solver="direct",
                  device="cpu", **kw)
        ct = mt.soe.step_dt.__self__
        bc, ss = ct.gather_inputs(2, "cpu")
        X = torch.as_tensor(np.asarray(mt.soe.soln))[None].repeat(2, 1)
        X[1] += 50.0
        dyn = ct._dyn_or_empty(None)
        (data,) = ct._jac(X, bc, ss, torch.full((2, 1), 3600.0), dyn)
        F = torch.as_tensor(np.random.default_rng(1).standard_normal(
            (2, ct.n)))
        Y = ct._solve((data,), F)
        dense = ct.template.to_dense(data).numpy()
        np.testing.assert_allclose(Y.numpy(),
                                   np.linalg.solve(dense, F.numpy()[..., None])[..., 0],
                                   rtol=1e-8, atol=1e-12 * float(
                                       Y.abs().max()))
        np.testing.assert_allclose(ct._matvec((data,), Y).numpy(),
                                   F.numpy(), rtol=1e-7, atol=1e-9)

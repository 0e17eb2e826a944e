"""spac_campbell, single-GE and multi-GE (the COND_DIRICHLET_FRM_OTR_GOVEQ
gather), through the port's "petsc" (ILU(0) + GMRES(30)) and "direct"
plans of CompiledVSFM against the JAX package's same plan.

As in tests/test_torch_vsfm_plans.py, whose helpers this file uses: both
drivers build the problem from the same arguments, the compiled steppers
run 3 hourly steps at ncol=1, f64 (the port's on the CPU) under the same
diurnal sink; every step agrees in convergence and SNES reason, the
cumulative Newton iterations are equal and the pressures agree at rtol
1e-9.
"""
import numpy as np
import pytest
import torch

from mpp_tpu.problems import vsfm_spac_campbell as jcamp
from mpp_tpu_torch.constants import AuxVarKind, Var
from mpp_tpu_torch.problems import vsfm_spac_campbell as tcamp
from test_torch_vsfm_plans import check_plan_matches_jax


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _campbell_stage():
    """spac_campbell's per-step staging: the diurnal sink."""
    state = {"time": 0.0}

    def stage(mpp, dt):
        mpp.set_data(AuxVarKind.SS, Var.BC_SS_CONDITION, 1,
                     np.full(1, -jcamp._transpiration(state["time"])))
        state["time"] += dt
    return stage


PROBLEMS = {
    name: (jcamp.run_vsfm_spac_campbell_problem,
           tcamp.run_vsfm_spac_campbell_problem, {"multi_goveqns": multi},
           3600.0, 3, _campbell_stage)
    for name, multi in (("spac_campbell", False),
                        ("spac_campbell_multi", True))}


@pytest.mark.parametrize("plan", ["petsc", "direct"])
@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_plan_matches_jax(name, plan):
    check_plan_matches_jax(PROBLEMS[name], plan)

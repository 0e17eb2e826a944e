"""The serial VSFM SNES of the port on the operator-split vchannel, the
three-GE manoli2014 and the FETCH2 xylem (spac_on_hillslope and
spac_mms in tests/test_torch_vsfm_spac_mms.py), against the JAX
package's serial SNES, both on the CPU in f64.

Each problem runs through both packages' drivers with their defaults.
At every step the convergence flag, the SNES reason and the Newton and
linear iterations are equal and the solution agrees within rtol 1e-9;
the operator split's regression file (the only one of these problems
with a writer) agrees within rtol 1e-9.  Cuts for time: the operator
split at nz = 2 with 1 of 3 steps, manoli2014 1 of 3 steps; fetch2 runs
its own 1 step.
"""
import numpy as np
import pytest
import torch

from mpp_tpu.models.richards import VSFMSoE as JSoE
from mpp_tpu.problems import vsfm_manoli2014 as jman
from mpp_tpu.problems import vsfm_spac_fetch2 as jfetch
from mpp_tpu.problems import vsfm_vchannel_operator_split as jsplit
from mpp_tpu_torch.models.richards import VSFMSoE as TSoE
from mpp_tpu_torch.problems import vsfm_manoli2014 as tman
from mpp_tpu_torch.problems import vsfm_spac_fetch2 as tfetch
from mpp_tpu_torch.problems import vsfm_vchannel_operator_split as tsplit
from serial_parity import (RTOL, assert_regression_files_match,
                           assert_steps_match, run_pairs)

# name: (JAX runner, port runner, kwargs, pick the mpp(s) of the result)
PROBLEMS = {
    "vchannel_operator_split": (
        jsplit.run_vsfm_vchannel_operator_split_problem,
        tsplit.run_vsfm_vchannel_operator_split_problem,
        {"nz": 2, "nstep": 1}, lambda r: r),
    "manoli2014": (jman.run_vsfm_manoli2014_problem,
                   tman.run_vsfm_manoli2014_problem, {"nstep": 1},
                   lambda r: (r,)),
    "spac_fetch2": (jfetch.run_vsfm_spac_fetch2_problem,
                    tfetch.run_vsfm_spac_fetch2_problem, {},
                    lambda r: (r,)),
}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs():
    """{name: (JAX result, JAX step log, port result, port step log)}."""
    return run_pairs(PROBLEMS, JSoE, TSoE)


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_steps_match_jax(runs, name):
    rj, lj, rt, lt = runs[name]
    assert_steps_match(lt, lj)
    pick = PROBLEMS[name][3]
    for mj, mt in zip(pick(rj), pick(rt)):
        assert mt.soe.cumulative_newton_iterations == \
            mj.soe.cumulative_newton_iterations > 0
        assert mt.soe.cumulative_linear_iterations == \
            mj.soe.cumulative_linear_iterations
        for gj, gt in zip(mj.soe.goveqns, mt.soe.goveqns):
            np.testing.assert_allclose(np.asarray(gt.pressure),
                                       np.asarray(gj.pressure), rtol=RTOL)


def test_operator_split_regression_matches_jax(runs, tmp_path):
    rj, _, rt, _ = runs["vchannel_operator_split"]
    fj = jsplit.output_regression(rj[1], str(tmp_path / "jax"), 6)
    ft = tsplit.output_regression(rt[1], str(tmp_path / "port"), 6)
    assert_regression_files_match(fj, ft)

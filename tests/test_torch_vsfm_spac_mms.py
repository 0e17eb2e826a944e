"""The serial VSFM SNES of the port on the laterally connected hillslope
columns (with the BT <-> L2 line-search rotation) and the three-GE SPAC
manufactured solution, against the JAX package's serial SNES, both on
the CPU in f64: at every step equal convergence, SNES reason, Newton
and linear iterations and the solution within rtol 1e-9, and the
manufactured-solution errors.  Cuts for time: hillslope its own 1 step,
spac_mms at grid_factor = 1 (its default is 2).
"""
import numpy as np
import pytest
import torch

from mpp_tpu.models.richards import VSFMSoE as JSoE
from mpp_tpu.problems import vsfm_spac_mms as jsmms
from mpp_tpu.problems import vsfm_spac_on_hillslope as jhill
from mpp_tpu_torch.models.richards import VSFMSoE as TSoE
from mpp_tpu_torch.problems import vsfm_spac_mms as tsmms
from mpp_tpu_torch.problems import vsfm_spac_on_hillslope as thill
from serial_parity import RTOL, assert_steps_match, run_pairs

# name: (JAX runner, port runner, kwargs, pick the mpp(s) of the result)
PROBLEMS = {
    "spac_on_hillslope": (jhill.run_vsfm_spac_on_hillslope_problem,
                          thill.run_vsfm_spac_on_hillslope_problem, {},
                          lambda r: (r[0],)),
    "spac_mms": (jsmms.run_vsfm_spac_mms_problem,
                 tsmms.run_vsfm_spac_mms_problem, {"grid_factor": 1},
                 lambda r: (r[0],)),
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


def test_spac_mms_errors_match_jax(runs):
    """The manufactured-solution errors of each GE (and the truths)."""
    rj, _, rt, _ = runs["spac_mms"]
    for a, b in zip(rt[1], rj[1]):
        np.testing.assert_allclose(a, b, rtol=1e-15)
    np.testing.assert_allclose(tsmms.pressure_errors(rt[0], rt[1]),
                               jsmms.pressure_errors(rj[0], rj[1]),
                               rtol=1e-6)


def test_hillslope_returns_elevations(runs):
    rj, _, rt, _ = runs["spac_on_hillslope"]
    np.testing.assert_array_equal(rt[1], rj[1])
    assert rt[0].soe.use_dynamic_linesearch

"""The serial VSFM SNES of the port on Srivastava & Yeh (1991), against
the JAX package's serial SNES, both on the CPU in f64: the spin-up to
the steady initial profile and the drying steps, step by step (equal
convergence, reason, Newton and linear iterations; solution within rtol
1e-9), and the regression file within rtol 1e-9.  Cut for time: nz = 20
(of 200) and 2 of 24 steps; the spin-up runs to its own stop.
"""
import numpy as np
import pytest
import torch

from mpp_tpu.models.richards import VSFMSoE as JSoE
from mpp_tpu.problems import vsfm_sy1991 as jsy
from mpp_tpu_torch.models.richards import VSFMSoE as TSoE
from mpp_tpu_torch.problems import vsfm_sy1991 as tsy
from serial_parity import (assert_regression_files_match,
                           assert_steps_match, run_pairs)

PROBLEMS = {"sy1991": (jsy.run_vsfm_sy1991_problem,
                       tsy.run_vsfm_sy1991_problem,
                       {"nz": 20, "nstep": 2})}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    return run_pairs(PROBLEMS, JSoE, TSoE)["sy1991"]


def test_steps_match_jax(run):
    mj, lj, mt, lt = run
    assert len(lt) > 2                      # spin-up steps, then the run
    assert_steps_match(lt, lj)
    assert mt.soe.cumulative_newton_iterations == \
        mj.soe.cumulative_newton_iterations > 0


def test_spinup_ic_matches_jax(run):
    """The initial state is the spin-up's steady profile."""
    mj, _, mt, _ = run
    np.testing.assert_allclose(mt.press_ic, mj.press_ic, rtol=1e-9)


def test_regression_file_matches_jax(run, tmp_path):
    mj, _, mt, _ = run
    fj = jsy.output_regression(mj, str(tmp_path / "jax"), 6)
    ft = tsy.output_regression(mt, str(tmp_path / "port"), 6)
    assert_regression_files_match(fj, ft)

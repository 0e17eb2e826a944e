"""The serial VSFM SNES of the port (``VSFMSoE.step_dt`` over
``ops/snes.snes_solve``) on the one-column problems celia1990,
wt_dynamics and mms (sy1991 in tests/test_torch_vsfm_sy1991.py),
against the JAX package's serial SNES, both on the CPU in f64.

Each problem runs through both packages' drivers with their defaults
(``use_compiled=False``).  At every step, spin-up steps included, the
convergence flag, the SNES reason and the Newton and linear iterations
are equal and the solution agrees within rtol 1e-9; the regression files
agree within rtol 1e-9 of each section's scale.  The sizes and step
counts are cut for time, as PROBLEMS says; the JAX runs are shared by a
module-scoped fixture.
"""
import numpy as np
import pytest
import torch

from mpp_tpu.models.richards import VSFMSoE as JSoE
from mpp_tpu.problems import vsfm_celia1990 as jcelia
from mpp_tpu.problems import vsfm_mms as jmms
from mpp_tpu.problems import vsfm_wt_dynamics as jwt
from mpp_tpu_torch.models.richards import VSFMSoE as TSoE
from mpp_tpu_torch.problems import vsfm_celia1990 as tcelia
from mpp_tpu_torch.problems import vsfm_mms as tmms
from mpp_tpu_torch.problems import vsfm_wt_dynamics as twt
from serial_parity import (assert_regression_files_match,
                           assert_steps_match, run_pairs)

# name: (JAX runner, port runner, kwargs, writer pair, pick the mpp);
# celia1990 at nz = 30 and 3 of its 24 steps; wt_dynamics at nz = 20,
# 2 of 24 steps; mms at its own nx = 20 (one step)
PROBLEMS = {
    "celia1990": (jcelia.run_vsfm_celia1990_problem,
                  tcelia.run_vsfm_celia1990_problem,
                  {"nz": 30, "nstep": 3}, (jcelia, tcelia)),
    "wt_dynamics": (jwt.run_vsfm_wt_dynamics_problem,
                    twt.run_vsfm_wt_dynamics_problem,
                    {"nz": 20, "nstep": 2}, (jwt, twt)),
    "mms": (jmms.run_vsfm_mms_problem, tmms.run_vsfm_mms_problem,
            {"nx": 20}, (jmms, tmms)),
}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mpp(r):
    return r[0] if isinstance(r, tuple) else r


@pytest.fixture(scope="module")
def runs():
    """{name: (JAX mpp, JAX step log, port mpp, port step log)}."""
    return {name: (_mpp(rj), lj, _mpp(rt), lt) for name, (rj, lj, rt, lt)
            in run_pairs(PROBLEMS, JSoE, TSoE).items()}


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_steps_match_jax(runs, name):
    mj, lj, mt, lt = runs[name]
    assert_steps_match(lt, lj)
    assert mt.soe.cumulative_newton_iterations == \
        mj.soe.cumulative_newton_iterations > 0
    assert mt.soe.cumulative_linear_iterations == \
        mj.soe.cumulative_linear_iterations
    # the serial path launches no kernel and crosses to the host at
    # least once a Newton iteration (the Newton direction)
    assert mt.soe.host_syncs >= mt.soe.cumulative_newton_iterations


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_regression_file_matches_jax(runs, name, tmp_path):
    mj, _, mt, _ = runs[name]
    jmod, tmod = PROBLEMS[name][3]
    fj = jmod.output_regression(mj, str(tmp_path / "jax"), 6)
    ft = tmod.output_regression(mt, str(tmp_path / "port"), 6)
    assert_regression_files_match(fj, ft)


def test_mms_error_matches_jax(runs):
    mj, _, mt, _ = runs["mms"]
    P_true = jmms.manufactured_pressure(mj.meshes[0].xc)
    np.testing.assert_allclose(
        tmms.manufactured_pressure(mt.meshes[0].xc), P_true, rtol=1e-15)
    assert tmms.pressure_error(mt, P_true) == pytest.approx(
        jmms.pressure_error(mj, P_true), rel=1e-6)


def test_compiled_option_reaches_thomas():
    """``use_compiled=True`` steps celia1990 through the compiled stepper
    (its tridiagonal plan: the thomas kernel's plain form on the CPU), to
    within the serial path's result at the Newton tolerance."""
    mt = tcelia.run_vsfm_celia1990_problem(nz=30, nstep=2,
                                           use_compiled=True, device="cpu")
    comp = mt.soe.step_dt.__self__
    assert comp.is_tridiag
    ms = tcelia.run_vsfm_celia1990_problem(nz=30, nstep=2, device="cpu")
    np.testing.assert_allclose(mt.soe.soln, ms.soe.soln, rtol=1e-6)

"""The problem runners' ``use_compiled`` / ``compiled`` keyword: each
ported runner takes the JAX runner's keyword with its default, so the
same call selects the same stepper in both packages.

The default call of the TH runners (the serial SNES) and of
thermal_mms (the serial KSP) is held against the JAX package's default
call on the CPU in f64: the solution within rtol 1e-9 and equal Newton
and linear iterations (the VSFM runners:
tests/test_torch_runner_defaults.py).  Cuts for time: mass_and_heat at
nx = 12, thermal_mms 2-D at 6 x 5 cells.
"""
import inspect

import numpy as np
import pytest
import torch

from mpp_tpu.problems import th as jth
from mpp_tpu.problems import thermal_mms as jtm
from mpp_tpu_torch.batched.ksp_compiled import CompiledKSP
from mpp_tpu_torch.batched.th_compiled import CompiledTH
from mpp_tpu_torch.problems import th as tth
from mpp_tpu_torch.problems import thermal_mms as ttm

RTOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _soe(r):
    m = r[0] if isinstance(r, tuple) else r
    return m.soe


# name: (JAX runner, port runner, kwargs, keyword, compiled stepper class)
RUNNERS = {
    "mass_and_heat": (jth.run_mass_and_heat, tth.run_mass_and_heat,
                      {"nx": 12}, "compiled", CompiledTH),
    "th_mms": (jth.run_th_mms, tth.run_th_mms, {"nx": 20}, "compiled",
               CompiledTH),
    "thermal_mms_1d": (jtm.run_thermal_mms_problem,
                       ttm.run_thermal_mms_problem, {"problem_type": 1},
                       "use_compiled", CompiledKSP),
    "thermal_mms_2d": (jtm.run_thermal_mms_problem,
                       ttm.run_thermal_mms_problem,
                       {"problem_type": 2, "nx": 6, "ny": 5},
                       "use_compiled", CompiledKSP),
}


@pytest.mark.parametrize("name", list(RUNNERS))
def test_default_call_matches_jax(name):
    jrun, trun, kw, _, _ = RUNNERS[name]
    sj, st = _soe(jrun(**kw)), _soe(trun(device="cpu", **kw))
    # the default is the SoE's own serial step, in both packages
    assert "step_dt" not in vars(st) and "step_dt" not in vars(sj)
    np.testing.assert_allclose(np.asarray(st.soln), np.asarray(sj.soln),
                               rtol=RTOL)
    assert st.cumulative_linear_iterations == \
        sj.cumulative_linear_iterations > 0
    if hasattr(sj, "cumulative_newton_iterations"):
        assert st.cumulative_newton_iterations == \
            sj.cumulative_newton_iterations > 0


@pytest.mark.parametrize("name", ["mass_and_heat", "th_mms",
                                  "thermal_mms_1d"])
def test_keyword_selects_the_compiled_stepper(name):
    """With the keyword set, the SoE steps through the compiled stepper
    (nstep=0 where the runner takes it: only the choice is checked)."""
    _, trun, kw, key, cls = RUNNERS[name]
    kw = dict(kw, **{key: True})
    if "nstep" in inspect.signature(trun).parameters:
        kw["nstep"] = 0
    st = _soe(trun(device="cpu", **kw))
    assert isinstance(st.step_dt.__self__, cls)

"""The problem runners' ``use_compiled`` / ``compiled`` keyword: each
ported runner takes the JAX runner's keyword with its default, so the
same call selects the same stepper in both packages.

The default call of each VSFM runner (the serial SNES) is held against
the JAX package's default call on the CPU in f64: the solution within
rtol 1e-9 and equal Newton and linear iterations (the TH and thermal
runners: tests/test_torch_runner_defaults_th.py).  Cuts for time:
vsfm_spac_campbell 1 of 24 steps, vchannel at nz = 2 with 1 of 3 steps.
"""
import inspect

import numpy as np
import pytest
import torch

from mpp_tpu.problems import vsfm_spac as jspac
from mpp_tpu.problems import vsfm_spac_campbell as jcamp
from mpp_tpu.problems import vsfm_vchannel as jvch
from mpp_tpu_torch.batched.vsfm_compiled import CompiledVSFM
from mpp_tpu_torch.problems import vsfm_spac as tspac
from mpp_tpu_torch.problems import vsfm_spac_campbell as tcamp
from mpp_tpu_torch.problems import vsfm_vchannel as tvch

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
    "vsfm_spac": (jspac.run_vsfm_spac_problem, tspac.run_vsfm_spac_problem,
                  {}, "use_compiled", CompiledVSFM),
    "vsfm_spac_campbell": (jcamp.run_vsfm_spac_campbell_problem,
                           tcamp.run_vsfm_spac_campbell_problem,
                           {"nstep": 1}, "use_compiled", CompiledVSFM),
    "vsfm_spac_campbell_multi": (jcamp.run_vsfm_spac_campbell_problem,
                                 tcamp.run_vsfm_spac_campbell_problem,
                                 {"nstep": 1, "multi_goveqns": True},
                                 "use_compiled", CompiledVSFM),
    "vsfm_vchannel": (jvch.run_vsfm_vchannel_problem,
                      tvch.run_vsfm_vchannel_problem,
                      {"nz": 2, "nstep": 1}, "use_compiled", CompiledVSFM),
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
    assert st.cumulative_newton_iterations == \
        sj.cumulative_newton_iterations > 0


@pytest.mark.parametrize("name", ["vsfm_spac", "vsfm_vchannel"])
def test_keyword_selects_the_compiled_stepper(name):
    """With the keyword set, the SoE steps through the compiled stepper
    (nstep=0 where the runner takes it: only the choice is checked)."""
    _, trun, kw, key, cls = RUNNERS[name]
    kw = dict(kw, **{key: True})
    if "nstep" in inspect.signature(trun).parameters:
        kw["nstep"] = 0
    st = _soe(trun(device="cpu", **kw))
    assert isinstance(st.step_dt.__self__, cls)

"""The port's thermal KSP "petsc" plan against the JAX package: the 2-D
and 3-D thermal MMS through ``compile_ksp("petsc")`` and the serial
``ThermalSOE.step_dt(solver="ksp")`` on the coupled 3-media problem.

All f64 on the CPU, inputs from the packages' drivers.  Tolerances: the
MMS solutions at rtol 1e-10 with equal GMRES counts (one linear solve a
step); the 3-media serial KSP at atol 1e-10 K, as
tests/test_ksp_compiled.py:65-73 holds JAX's compiled path against its
serial one.
"""
import numpy as np
import pytest
import torch

from mpp_tpu.problems import thermal_mms as jtm
from mpp_tpu.problems.thermal_3media import ThreeMediaProblem as JThree
from mpp_tpu_torch.problems import thermal_mms as ttm
from mpp_tpu_torch.problems.thermal_3media import ThreeMediaProblem


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ptype,dims", [(2, {"nx": 4, "ny": 4}),
                                        (3, {"nx": 4, "ny": 4, "nz": 4})],
                         ids=["2d", "3d"])
def test_thermal_mms_petsc_matches_jax(ptype, dims):
    """The 2-D and 3-D MMS through compile_ksp("petsc") (the 3-D case
    with the column-major staging quirk) against JAX's compiled KSP."""
    mj, sj = jtm.run_thermal_mms_problem(ptype, use_compiled=True, **dims)
    mt, st = ttm.run_thermal_mms_problem(ptype, use_compiled=True,
                                         device="cpu", **dims)
    comp = mt.soe.step_dt.__self__
    assert not comp.is_tridiag and comp._ilu is not None
    np.testing.assert_allclose(st, np.asarray(sj), rtol=1e-10)
    assert mt.soe.cumulative_linear_iterations \
        == mj.soe.cumulative_linear_iterations > 0
    assert comp.host_syncs > 0


def test_thermal_soe_ksp_step_on_three_media_matches_jax():
    """ThermalSOE.step_dt(solver="ksp"), the serial GMRES(30) + ILU(0)
    with the cross-GE coupling, 2 steps of the 3-media problem at 3
    columns, against JAX's serial path."""
    pj = JThree(ncol=3)
    pt = ThreeMediaProblem(ncol=3, device="cpu")
    for p in (pj, pt):
        p.set_initial_temperature(260.0, 272.0, 278.0)
        p.set_top_fluxes(-30.0, 0.0, 5.0)
    soe = pt.mpp.soe
    for _ in range(2):
        pj.step(1800.0)
        assert type(soe).step_dt(soe, 1800.0, solver="ksp", device="cpu")
    np.testing.assert_allclose(soe.soln, np.asarray(pj.mpp.soe.soln),
                               rtol=0, atol=1e-10)
    assert soe.cumulative_linear_iterations \
        == pj.mpp.soe.cumulative_linear_iterations
    with pytest.raises(ValueError):
        type(soe).step_dt(soe, 1800.0, solver="gmres", device="cpu")

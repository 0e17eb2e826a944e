"""The port's standalone enthalpy SoE against the JAX package:
``CompiledThermalEnthalpy`` (batched) and the serial
``ThermalEnthalpySoE.step_dt``, each one linearised update a step with
ILU(0) + GMRES(30), on the heat-transport problems.

All f64 on the CPU, inputs from the packages' drivers and numpy seed 0
where perturbed.  Tolerances: temperatures at rtol 1e-10 with equal GMRES
counts (a single linear update, no Newton loop to absorb rounding).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpp_tpu.batched.th_compiled import compile_thermal_enthalpy as jcompile_te
from mpp_tpu.problems import th as jth
from mpp_tpu_torch.batched.th_compiled import compile_thermal_enthalpy
from mpp_tpu_torch.problems import th as tth

DT = 3600.0


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("compiled", [False, True],
                         ids=["serial", "compiled"])
def test_heat_transport_1d_matches_jax(compiled):
    """run_heat_transport_1d(nz=20), 2 steps: the serial
    ThermalEnthalpySoE.step_dt (ops/ilu) or CompiledThermalEnthalpy,
    against the same path of the JAX package."""
    mj, Tj = jth.run_heat_transport_1d(nz=20, compiled=compiled)
    mt, Tt = tth.run_heat_transport_1d(nz=20, compiled=compiled,
                                       device="cpu")
    np.testing.assert_allclose(Tt, np.asarray(Tj), rtol=1e-10)
    assert mt.soe.cumulative_linear_iterations \
        == mj.soe.cumulative_linear_iterations > 0
    assert np.ptp(Tt) > 1.0                   # the BCs reach the column


def test_compiled_enthalpy_batched_columns():
    """CompiledThermalEnthalpy over 3 columns with their own Dirichlet
    temperatures equals JAX's, and reports GMRES convergence."""
    mj, _ = jth.run_heat_transport_1d(nz=20, nstep=1)
    mt, _ = tth.run_heat_transport_1d(nz=20, nstep=1, device="cpu")
    cj, ct = jcompile_te(mj), compile_thermal_enthalpy(mt)
    rng = np.random.default_rng(0)
    T = np.asarray(mj.soe.soln_prev)[None] + rng.uniform(-1, 1, (3, 20))
    P = np.tile(np.asarray(mj.soe.ge.pressure)[:20], (3, 1))
    bc = np.stack([[300.0, 290.0], [303.15, 293.15], [310.0, 280.0]])
    Tn_j, cyc_j, conv_j = cj.step_batched(jnp.asarray(T), jnp.asarray(P),
                                          jnp.asarray(bc), DT)
    Tn_t, cyc_t, conv_t = ct.step_batched(*(torch.as_tensor(a)
                                            for a in (T, P, bc)), DT)
    assert cyc_t == int(cyc_j) and bool(conv_t.all()) and bool(conv_j.all())
    np.testing.assert_allclose(Tn_t.numpy(), np.asarray(Tn_j), rtol=1e-10)


def test_heat_transport_with_advection_matches_jax(tmp_path):
    """The staged pressure field, passed as an array and read from a PETSc
    binary Vec (``pressure_ic_file``), against JAX's run with the array."""
    nx = 20
    p_ic = 91325.0 + 2e3 * np.sin(np.linspace(0.0, 3.0, nx))
    mj, Tj = jth.run_heat_transport_1d_with_advection(nx=nx, pressure_ic=p_ic)
    mt, Tt = tth.run_heat_transport_1d_with_advection(nx=nx, pressure_ic=p_ic,
                                                      device="cpu")
    np.testing.assert_allclose(Tt, np.asarray(Tj), rtol=1e-10)
    from mpp_tpu_torch.io.petsc_vec import write_vec
    path = str(tmp_path / "pressure_ic.bin")
    write_vec(path, p_ic)
    _, Tf = tth.run_heat_transport_1d_with_advection(
        nx=nx, pressure_ic_file=path, device="cpu")
    np.testing.assert_allclose(Tf, np.asarray(Tj), rtol=1e-10)

"""The "petsc" inner solve of the port's TH slice against the JAX
package: ``CompiledTH``'s ILU(0) + GMRES(30) plan, batched and through
``run_th_mms``'s default plan.  The standalone enthalpy SoE is held in
tests/test_torch_enthalpy.py, the thermal KSP's "petsc" plan in
tests/test_torch_thermal_ksp.py.

All f64 on the CPU, inputs from the packages' drivers.  Tolerances:
stepper states at rtol 1e-9 with equal Newton iterations and reasons (as
tests/test_torch_th.py holds the direct stepper).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpp_tpu.batched.th_compiled import compile_th as jcompile_th
from mpp_tpu.problems import th as jth
from mpp_tpu_torch.batched.th_compiled import CompiledTH, compile_th
from mpp_tpu_torch.models.thermal_enthalpy import ThermalEnthalpySoE
from mpp_tpu_torch.ops import hopper_kernels as hk
from mpp_tpu_torch.problems import th as tth

DT = 3600.0
NCOL = 4


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_compiled_th_petsc_matches_jax():
    """CompiledTH(linear_solver="petsc") at nx=12, 4 columns with their
    own top temperature, 2 steps, against JAX's compile_th(mpp).  The
    inputs are the port's staged ones (the port's driver stages the
    energy BCs before the first step)."""
    mj, _ = jth.run_mass_and_heat(nx=12, nstep=0)
    mt, _ = tth.run_mass_and_heat(nx=12, nstep=0, device="cpu")
    cj, ct = jcompile_th(mj), compile_th(mt)
    assert ct.plan == "petsc" and cj._ilu is not None
    X0 = np.tile(np.asarray(mt.soe.soln), (NCOL, 1))
    bc, ss = (tuple(a.numpy().copy() for a in t)
              for t in ct.gather_inputs(NCOL, "cpu"))
    bc[1][:, 0] = np.linspace(296.15, 310.15, NCOL)
    dyn = tuple({k: v.numpy() for k, v in d.items()}
                for d in ct._serial_dyn(NCOL, "cpu"))
    Xj = jnp.asarray(X0)
    bcj = tuple(jnp.asarray(b) for b in bc)
    ssj = tuple(jnp.asarray(s) for s in ss)
    dynj = tuple({k: jnp.asarray(v) for k, v in d.items()} for d in dyn)
    Xt, bct, sst, dynt = CompiledTH.inputs_from_numpy(X0, bc, ss, dyn, "cpu",
                                                      torch.float64)
    for step in range(2):
        Xj, it_j, ok_j, r_j = cj.step_batched(Xj, bcj, ssj, DT, dyn=dynj)
        Xt, it_t, ok_t, r_t = ct.step_batched(Xt, bct, sst, DT, dyn=dynt)
        assert int(it_j) == it_t, step
        np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-9)
    assert bool(ok_t.all())
    assert ct.gmres_cycles > 0 and ct.gmres_unconverged() == 0
    assert hk.LAUNCHES["block_thomas2"] == 0


def test_th_mms_petsc_matches_jax_serial():
    """run_th_mms's default plan is JAX's ("petsc"); its one step lands on
    JAX's serial SNES + ILU(0)/GMRES iterate."""
    mj, Pj = jth.run_th_mms(nx=20)
    mt, Pt = tth.run_th_mms(nx=20, compiled=True, device="cpu")
    assert mt.soe.step_dt.__self__.plan == "petsc"
    np.testing.assert_allclose(mt.soe.soln, np.asarray(mj.soe.soln),
                               rtol=1e-9)


def test_entry_points_default_to_the_card():
    """The new drivers and the serial enthalpy step run on the card unless
    told otherwise; without one they raise, and nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from mpp_tpu_torch.models.richards import VSFMSoE
    from mpp_tpu_torch.problems import vsfm_spac
    assert ThermalEnthalpySoE.device == VSFMSoE.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        tth.run_heat_transport_1d(nz=4)
    with pytest.raises(RuntimeError, match="cuda"):
        vsfm_spac.run_vsfm_spac_problem()
    mpp = vsfm_spac.run_vsfm_spac_problem(nstep=0, device="cpu")
    mpp.soe.device = "cuda"                 # the serial SNES on the card
    with pytest.raises(RuntimeError, match="cuda"):
        mpp.soe.step_dt(3600.0)


def jax_plan_gap(ncol=64, nh=64):
    """The JAX package's own gap between its "petsc" and "direct" TH
    steppers: chip_smoke.py's phase (q) configuration (mass_and_heat at
    ``nh`` cells, the per-column top temperature 296.15-310.15 K) at
    ``ncol`` columns, one dt=3600 s step of each plan from the same start
    state (the staged initial state after one direct step, as (h) starts).
    Returns {"max_abs_dP_Pa", "max_abs_dT_K"}; run this file as a script
    to print it (chip_smoke.py's TH_PLAN_BOUND is ten times its reading).
    """
    mj, _ = jth.run_mass_and_heat(nx=nh, nstep=0)
    mj.set_data(jth.AuxVarKind.BC, jth.Var.BC_SS_CONDITION, 1, [303.15])
    mj.set_data(jth.AuxVarKind.BC, jth.Var.BC_SS_CONDITION, 2, [293.15])
    ge = mj.soe.ge_energy
    ge.bc_pressure = ge.bc_pressure.at[:].set(91325.0)
    direct, petsc = jcompile_th(mj, linear_solver="direct"), jcompile_th(mj)
    bc1, ss1 = direct.gather_inputs(1)
    X0, _, ok, _ = direct.step_batched(mj.soe.soln[None, :], bc1, ss1, DT,
                                       dyn=direct._serial_dyn(1))
    assert bool(ok.all())
    X = jnp.broadcast_to(X0, (ncol, X0.shape[1]))
    bc, ss = direct.gather_inputs(ncol)
    bc = (bc[0], bc[1].at[:, 0].set(jnp.linspace(296.15, 310.15, ncol)))
    out = []
    for comp in (petsc, direct):
        Xn, _, ok, _ = comp.step_batched(X, bc, ss, DT,
                                         dyn=comp._serial_dyn(ncol))
        assert bool(ok.all())
        out.append(np.asarray(Xn))
    d = np.abs(out[0] - out[1])
    return {"max_abs_dP_Pa": float(d[:, :nh].max()),
            "max_abs_dT_K": float(d[:, nh:].max())}


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_th_petsc.py
    import json
    import jax
    jax.config.update("jax_enable_x64", True)
    print(json.dumps(jax_plan_gap()))

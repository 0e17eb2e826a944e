"""The port's serial MLC facade (``models/mlc.MLCMPP``), its compiled
stepper (``batched/mlc_compiled.CompiledMLC``) and ``run_mlc_problem``
against the JAX package's, on the CPU in f64.

Tolerances:
* one serial step at (ncair, ntree) = (1, 1), (2, 1), (2, 2): the solution
  within ATOL = 1e-10 (K and kg/kg; measured 6e-12) with equal GMRES
  inner iterations.  Both packages assemble in the same host numpy; the
  GMRES(30) + ILU(0) iterate is the same algorithm in another summation
  order, stopped at PETSc's rtol 1e-5.  The leaf fluxes PostSolve
  derives agree within FLUX_RTOL = 1e-9 of their largest magnitude
  (measured 2.2e-11: a flux of ~300 W/m2 is 2 c_p g_bh times a ~1e-11 K
  temperature difference);
* the compiled step within ATOL of the JAX compiled step (equal GMRES
  cycles) and of the port's serial step, JAX's own bound between its two
  paths (tests/test_batched_mlc.py:119; measured 2e-12);
* ``compute_rhs`` / ``compute_operators`` on the same staged state (the
  JAX MPP's arrays copied into the port's): the same COO entries in the
  same order, the values and the right-hand side within 1e-13 relative
  (measured equal).
"""
import json

import numpy as np
import pytest
import torch

from mpp_tpu.io.metrics import MetricsStream as JMetrics
from mpp_tpu.problems import mlc as jmlc
from mpp_tpu_torch.io.metrics import MetricsStream
from mpp_tpu_torch.models.mlc import MLCMPP
from mpp_tpu_torch.problems import mlc as tmlc
from mpp_tpu_torch.problems import thermal_mms as ttm

ATOL = 1e-10
FLUX_RTOL = 1e-9
ASSEMBLY_RTOL = 1e-13
DT = 300.0
SHAPES = [(1, 1), (2, 1), (2, 2)]
IDS = ["1x1", "2x1", "2x2"]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ncair,ntree", SHAPES, ids=IDS)
def test_serial_step_matches_jax(ncair, ntree):
    mj = jmlc.run_mlc_problem(ncair, ntree)
    mt = tmlc.run_mlc_problem(ncair, ntree, device="cpu")
    assert mt.device.type == "cpu" and mt.soln.dtype == np.float64
    np.testing.assert_allclose(mt.soln, mj.soln, rtol=0, atol=ATOL)
    assert mt.cumulative_linear_iterations \
        == mj.cumulative_linear_iterations > 0
    # the auxvars PostSolve derives from the solution: the states within
    # ATOL, the leaf fluxes within FLUX_RTOL of their largest magnitude
    for k in ("at_T", "av_q", "at_leaf_sh_flux", "av_leaf_trans_flux"):
        want = getattr(mj, k)
        tol = ATOL if k in ("at_T", "av_q") \
            else FLUX_RTOL * np.abs(want).max()
        np.testing.assert_allclose(getattr(mt, k), want, rtol=0, atol=tol)
    # GMRES predicates and one solution download, all counted
    assert mt.host_syncs >= 2


@pytest.mark.parametrize("ncair,ntree", SHAPES, ids=IDS)
def test_compiled_step_matches_jax_and_serial(ncair, ntree):
    mj = jmlc.run_mlc_problem(ncair, ntree, use_compiled=True)
    mt = tmlc.run_mlc_problem(ncair, ntree, use_compiled=True, device="cpu")
    ms = tmlc.run_mlc_problem(ncair, ntree, device="cpu")
    comp = mt.soe.step_dt.__self__
    assert comp.device.type == "cpu" and comp.dtype == torch.float64
    np.testing.assert_allclose(mt.soln, mj.soln, rtol=0, atol=ATOL)
    np.testing.assert_allclose(mt.soln, ms.soln, rtol=0, atol=ATOL)
    assert mt.cumulative_linear_iterations \
        == mj.cumulative_linear_iterations == comp.gmres_cycles == 1
    assert comp._ilu.factors == 1 and comp._ilu.applies > 0
    assert comp.host_syncs >= 2


def _staged(mpp):
    """Re-stage a stepped problem for its next step, as step_dt does."""
    mpp.dtime = DT
    mpp._vol_air = mpp._compute_vol_air()
    mpp.pre_solve()
    return mpp


def _port_copy(mj):
    """A port MLCMPP holding the JAX MPP's staged state, array for array."""
    mt = MLCMPP(mj.ncair, mj.ntree, nz_cair=mj.nlev - 1,
                z_cair=mj.dz_cair * (mj.nlev - 1), device="cpu")
    for k, v in vars(mj).items():
        if isinstance(v, np.ndarray):
            setattr(mt, k, v.copy())
    mt.leaf = [{k: v.copy() for k, v in ge.items()} for ge in mj.leaf]
    mt.dtime = mj.dtime
    return mt


@pytest.mark.parametrize("ncair,ntree", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_assembly_matches_jax_entry_for_entry(ncair, ntree):
    mj = _staged(jmlc.run_mlc_problem(ncair, ntree))
    mt = _port_copy(mj)
    bj, bt = mj.compute_rhs(), mt.compute_rhs()
    rj, cj, vj = mj.compute_operators()
    rt, ct, vt = mt.compute_operators()
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_allclose(vt, vj, rtol=ASSEMBLY_RTOL, atol=0)
    np.testing.assert_allclose(bt, bj, rtol=ASSEMBLY_RTOL, atol=0)
    # and the port's own re-staged state after its own step is the JAX
    # state's within the solution tolerance
    ms = _staged(tmlc.run_mlc_problem(ncair, ntree, device="cpu"))
    np.testing.assert_allclose(ms.compute_rhs(), bj, rtol=1e-8, atol=ATOL)


def test_compiled_step_reports_unconverged_gmres(monkeypatch):
    """A compiled solve that runs out of GMRES cycles says so: step_dt
    returns False with the cycle cap, the metrics record it, and
    run_mlc_problem raises.  A negative tolerance keeps every column
    unconverged for all of the cap's cycles; the cap is cut from PETSc's
    100 to 2, in the solve and in the stepper alike, to keep the test
    short."""
    import mpp_tpu_torch.batched.mlc_compiled as mc
    solve = mc.petsc_gmres_batched
    cap = 2
    monkeypatch.setattr(mc, "MAXCYCLES", cap)
    monkeypatch.setattr(mc, "petsc_gmres_batched", lambda *a, **k: solve(
        *a, rtol=-1.0, atol=-1.0, maxcycles=cap, **k))
    with pytest.raises(RuntimeError, match="diverged"):
        tmlc.run_mlc_problem(1, 1, use_compiled=True, device="cpu")
    monkeypatch.setattr(mc, "petsc_gmres_batched", solve)
    mpp = tmlc.run_mlc_problem(1, 1, use_compiled=True, device="cpu")
    mpp.soe.metrics = MetricsStream()
    monkeypatch.setattr(mc, "petsc_gmres_batched", lambda *a, **k: solve(
        *a, rtol=-1.0, atol=-1.0, maxcycles=cap, **k))
    assert mpp.soe.step_dt(DT, 2) == (False, cap)
    assert mpp.soe.metrics.last()["converged"] is False


def test_metrics_stream_records_port_soes(tmp_path):
    """A MetricsStream attached to a port SoE records each step: the MLC
    SoE and the thermal KSP SoE (whose compiled step records too); the
    JSONL file and the totals match the JAX stream's on the same
    records."""
    path = tmp_path / "m.jsonl"
    stream = MetricsStream(str(path))
    mlc = tmlc.run_mlc_problem(1, 1, device="cpu")
    mlc.soe.metrics = stream
    conv, iters = mlc.step_dt(DT, nstep=2)
    assert conv and iters > 0
    mpp, _ = ttm.run_thermal_mms_problem(1, use_compiled=True, device="cpu")
    mpp.soe.metrics = stream
    assert mpp.soe.step_dt(1.0)
    stream.close()
    recs = [json.loads(line) for line in open(path)]
    assert len(recs) == len(stream.records) == 2
    assert recs[0]["step"] == 2 and recs[0]["linear_iterations"] == iters
    assert recs[1]["solver"] == "compiled" and recs[1]["converged"] is True
    jstream = JMetrics()
    for r in stream.records:
        jstream.record(**{k: v for k, v in r.items() if k != "t_wall"})
    assert stream.totals() == jstream.totals()
    assert stream.last() == recs[-1]


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        MLCMPP()
    with pytest.raises(RuntimeError, match="cuda"):
        tmlc.run_mlc_problem()

"""The port's coupled 5-MPP ml_model orchestrator (``MLModel``,
``run_ml_model_problem``) and its phase timers against the JAX package's,
on the CPU in f64.

Both packages run hour 13 in 3 substeps of 300 s under the synthetic
diurnal forcing, with checkpoints.  The shortwave and longwave KSPs and
the MLC's GMRES(30) + ILU(0) stop at PETSc's rtol 1e-5 in another
summation order, and the photosynthesis Newton's finite-difference
Jacobian is bit-sensitive (KNOWN_GAPS #6), so the runs agree to round-off
grown through the substeps, not bit for bit.  Tolerances:
T_TOL = 1e-8 K for the leaf and air temperatures (measured 4e-11),
Q_TOL = 1e-13 kg/kg for the air vapor (measured 5e-15), and REL = 1e-9
of each field's largest magnitude for the wind, the conductances, the
checkpoints and the substep accumulators (measured at most 1.6e-11, the
absorbed longwave); the photosynthesis Newton takes as many iterations.

The checkpoint files are PETSc-binary Vecs: a port ``MLModel`` restored
from the files the JAX ``MLModel`` wrote holds the same state bit for bit,
and goes on through hour 14 within the same tolerances.
"""
import numpy as np
import pytest
import torch

from mpp_tpu.problems import ml_model as jml
from mpp_tpu_torch.constants import TFRZ
from mpp_tpu_torch.io.petsc_vec import read_vec
from mpp_tpu_torch.io.timers import PhaseTimers
from mpp_tpu_torch.problems import ml_model as tml

T_TOL = 1e-8
Q_TOL = 1e-13
REL = 1e-9
MLC_CKPT = "mlc_checkpoint.013.3.bin"
PSY_CKPT = "photosynthesis_checkpoint.013.3.bin"


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def day_runs(tmp_path_factory):
    dj = tmp_path_factory.mktemp("jax")
    dt = tmp_path_factory.mktemp("port")
    mj = jml.run_ml_model_problem(beg_step=13, end_step=13, nsubstep=3,
                                  checkpoint_data=True,
                                  checkpoint_dir=str(dj))
    mt = tml.run_ml_model_problem(beg_step=13, end_step=13, nsubstep=3,
                                  checkpoint_data=True,
                                  checkpoint_dir=str(dt), device="cpu")
    return mj, mt, dj, dt


def _rel(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got - want).max()) / scale
    assert err <= rel, err


def assert_models_match(mt, mj):
    for k in ("tleaf_sun", "tleaf_shd", "tair"):
        np.testing.assert_allclose(getattr(mt, k), getattr(mj, k), rtol=0,
                                   atol=T_TOL)
    np.testing.assert_allclose(mt.qair, mj.qair, rtol=0, atol=Q_TOL)
    assert abs(mt.tg - mj.tg) <= T_TOL
    for k in ("wind", "gs_sun", "gs_shd", "gbh", "gbv", "gbc",
              "ileaf_sun_vis", "labs_leaf_sun"):
        _rel(getattr(mt, k), getattr(mj, k))
    assert set(mt.accum) == set(mj.accum)
    for k in mj.accum:
        _rel(mt.accum[k], mj.accum[k])
    assert mt.psy.soe.cumulative_newton_iterations \
        == mj.psy.soe.cumulative_newton_iterations > 0
    assert mt.mlc.cumulative_linear_iterations \
        == mj.mlc.cumulative_linear_iterations > 0


def test_day_run_matches_jax(day_runs):
    mj, mt, _, _ = day_runs
    assert_models_match(mt, mj)
    # every stage's device reads are counted; the CPU timers make none
    assert mt.timers.host_syncs == 0
    assert mt.host_syncs >= mt.mlc.host_syncs + mt.lwv.host_syncs > 0


def test_coupled_daytime_physics(day_runs):
    """tests/test_ml_model.py's envelope, on the port's run."""
    _, m, _, _ = day_runs
    assert np.all(m.gs_sun > 0.01), "sunlit stomata should be open at noon"
    assert np.all(m.accum["anet_leaf_sun"] > 0.0)
    assert np.all(m.accum["tr_leaf_sun"] > 0.0)
    assert np.all((m.tleaf_sun > TFRZ + 5.0) & (m.tleaf_sun < TFRZ + 45.0))
    assert np.all((m.tair > TFRZ) & (m.tair < TFRZ + 45.0))
    assert np.all((m.qair > 0.0) & (m.qair < 0.05))
    assert m.accum["rn_leaf_sun"].mean() > m.accum["rn_leaf_shd"].mean()
    assert m.accum["gs_leaf_sun"].mean() > m.accum["gs_leaf_shd"].mean()
    assert np.all((m.gbh > 0) & (m.gbh < 100))
    assert m.wind[-1] > m.wind[m.nbot] > 0.0


def test_phase_timers(day_runs):
    """Every sub-solver phase is timed (ml_model_problem.F90:323-336), as
    the JAX model's timers count them."""
    mj, m, _, _ = day_runs
    rep, rep_j = m.timers.report(), mj.timers.report()
    assert set(rep) == set(rep_j) == {"SWV", "LWV", "LBL", "PHY", "MLC"}
    assert {k: s["count"] for k, s in rep.items()} \
        == {k: s["count"] for k, s in rep_j.items()}
    assert rep["SWV"]["count"] == 1 and rep["MLC"]["count"] == 3
    assert all(s["total_s"] > 0 for s in rep.values())
    lines = str(m.timers).splitlines()
    assert lines[0].split() == ["Phase", "Count", "Total(s)", "Mean(s)"]
    assert [ln.split()[0] for ln in lines[1:]] == sorted(rep)


def test_checkpoint_files_match_jax(day_runs):
    _, _, dj, dt = day_runs
    for name in (MLC_CKPT, PSY_CKPT):
        vj = read_vec(str(dj / name))
        vt = read_vec(str(dt / name))
        assert vt.shape == vj.shape
        _rel(vt, vj)


def _restored(mod, dj, bc, **kw):
    m = mod.MLModel(**kw)
    m.initialize_from_checkpoint(str(dj / MLC_CKPT), str(dj / PSY_CKPT), bc)
    return m


def test_restore_from_jax_checkpoint_bitwise(day_runs):
    """The port restores the state the JAX model wrote, bit for bit, and
    stages it exactly as the JAX model restoring the same files does."""
    mj, _, dj, _ = day_runs
    bc_j = jml.synthetic_diurnal_bc(14, mj.bc)
    rj = _restored(jml, dj, bc_j)
    rt = _restored(tml, dj, tml.synthetic_diurnal_bc(14, mj.bc),
                   device="cpu")
    for k in ("tleaf_sun", "tleaf_shd", "tair", "qair", "wind"):
        np.testing.assert_array_equal(getattr(rt, k), getattr(mj, k))
        np.testing.assert_array_equal(getattr(rt, k), getattr(rj, k))
    assert rt.tg == rj.tg
    avj, avt = rj.psy.soe.ge.avars, rt.psy.soe.ge.avars
    for k in ("leaf_psi", "tleaf_prev", "gleaf_w_soln"):
        np.testing.assert_array_equal(getattr(avt, k), getattr(avj, k))
    np.testing.assert_array_equal(avt.tleaf_prev, mj.psy.soe.ge.avars.tleaf)
    # the MLC state and what its post-load PreSolve derives from it
    np.testing.assert_array_equal(rt.mlc.soln, rj.mlc.soln)
    for k in ("at_T", "av_q", "at_conn_ga", "av_bc_q", "at_bc_T"):
        np.testing.assert_array_equal(getattr(rt.mlc, k),
                                      getattr(rj.mlc, k))
    np.testing.assert_array_equal(rt.mlc.cturb.wind, rj.mlc.cturb.wind)


def test_resumed_run_matches_jax(day_runs):
    """Both packages restored from the JAX checkpoint go on through hour
    14 (2 substeps) alike, inside the physical envelope."""
    mj, _, dj, _ = day_runs
    rj = _restored(jml, dj, jml.synthetic_diurnal_bc(14, mj.bc))
    rt = _restored(tml, dj, tml.synthetic_diurnal_bc(14, mj.bc),
                   device="cpu")
    rj.run(beg_step=14, end_step=14, nsubstep=2)
    rt.run(beg_step=14, end_step=14, nsubstep=2)
    assert_models_match(rt, rj)
    assert np.all((rt.tleaf_sun > TFRZ) & (rt.tleaf_sun < TFRZ + 45.0))
    assert np.all(rt.gs_sun > 0.0)


def test_single_column_only():
    with pytest.raises(NotImplementedError, match="single canopy column"):
        tml.MLModel(ncair=2, device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for make in (tml.MLModel, tml.run_ml_model_problem, PhaseTimers):
        with pytest.raises(RuntimeError, match="cuda"):
            make()

"""ALM driver of the PyTorch port (mpp_tpu_torch/driver/alm.py) against the
JAX driver (mpp_tpu/driver/alm.py) on the shapes of tests/test_alm.py.

f64 throughout.  Each scenario runs one ALM step in both packages from
the same state and forcing: attempts, Newton iterations and the retry
counters must be identical; P within rtol 1e-9; the CLM outputs
(h2osoi_liq/ice, smp_l, zwt, qflx_seepage) within rtol 1e-9 (they are
algebraic in P); the audit error, a difference of ~1e2 kg storages
near 1e-9 kg, within 1e-10 kg absolute.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpp_tpu.driver import alm as jalm
from mpp_tpu_torch.driver import alm as talm

RTOL = 1e-9
OUTPUTS = ("h2osoi_liq", "h2osoi_ice", "smp_l", "zwt", "qflx_seepage",
           "qflx_drain_tot")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small batches: torch's intra-op threads only add contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _soil_kwargs(ncol=6, nz=15, dz=0.1):
    shape = (ncol, nz)
    return dict(
        watsat=np.full(shape, 0.368),
        hksat=np.full(shape, 0.0070556),      # mm/s (CLM-ish)
        bsw=np.full(shape, 2.0),              # lambda = 0.5
        sucsat=np.full(shape, 29.772),        # 1/(alpha*g), m of water
        residual_sat=np.full(shape, 0.2772),
        dz=np.full(shape, dz), area=np.ones(ncol))


def _hetero_kwargs(ncol=4, nz=10, seed=0):
    rng = np.random.default_rng(seed)
    shape = (ncol, nz)
    return dict(watsat=0.35 + 0.1 * rng.random(shape),
                hksat=0.004 * (0.5 + rng.random(shape)),
                bsw=2.0 + 2.0 * rng.random(shape),
                sucsat=20.0 + 20.0 * rng.random(shape),
                residual_sat=0.10 + 0.1 * rng.random(shape),
                dz=np.full(shape, 0.1), area=1.0 + rng.random(ncol),
                include_seepage_bc=True)


def _pair(**kw):
    return (jalm.alm_vsfm_initialize(**kw),
            talm.alm_vsfm_initialize(device="cpu", **kw))


@pytest.fixture(scope="module")
def closed15():
    return _pair(**_soil_kwargs())


@pytest.fixture(scope="module")
def seep10():
    return _pair(**_hetero_kwargs())


def _set_state(pair, P):
    pj, pt = pair
    pj.P = jnp.asarray(P)
    pt.P = torch.as_tensor(P)


def _step_both(pair, dtime, **forcing):
    pj, pt = pair
    oj = jalm.alm_vsfm_solve(pj, dtime, **forcing)
    ot = talm.alm_vsfm_solve(pt, dtime, **forcing)
    for k in ("attempts", "newton_iters", "diverged_count",
              "mass_bal_err_count", "escalated_cols"):
        assert oj[k] == ot[k], (k, oj[k], ot[k])
    np.testing.assert_allclose(pt.P.numpy(), np.asarray(pj.P), rtol=RTOL)
    for k in OUTPUTS:
        np.testing.assert_allclose(ot[k].numpy(), np.asarray(oj[k]),
                                   rtol=RTOL, atol=1e-300, err_msg=k)
    assert abs(oj["abs_mass_error_col"] - ot["abs_mass_error_col"]) < 1e-10
    assert ot["abs_mass_error_col"] < talm.MAX_ABS_MASS_ERROR_COL
    assert ot["host_round_trips_per_step"] == ot["dispatches_per_step"] > 0
    return oj, ot


def _closed15_cases(ncol, nz):
    rootr = np.zeros((ncol, nz))
    rootr[:, -5:] = 0.2
    fi = np.zeros((ncol, nz))
    fi[:, :3] = 0.5
    return {
        "no_flux": (3.5355e3, 1800.0, {}),
        "infiltration": (3.5355e3, 1800.0,
                         {"qflx_infl": np.full(ncol, 5e-4)}),
        "et_sink": (9.0e4, 1800.0, {"qflx_tran_veg": np.full(ncol, 2e-4),
                                    "rootr": rootr}),
        "frac_ice": (3.5355e3, 600.0, {"frac_ice": fi}),
        "dew_sublimation_snow": (2.0e4, 900.0,
                                 {"qflx_dew": np.full(ncol, 1e-4),
                                  "qflx_sub_snow": np.full(ncol, 3e-5),
                                  "mflx_snowlyr": np.full(ncol, 2e-4)}),
    }


@pytest.mark.parametrize("case", sorted(_closed15_cases(6, 15)))
def test_closed_column_scenarios(closed15, case):
    P0, dtime, forcing = _closed15_cases(6, 15)[case]
    _set_state(closed15, np.full((6, 15), P0))
    _step_both(closed15, dtime, **forcing)


def test_drainage_split_below_water_table(closed15):
    """Saturated bottom half, dry top: the drainage sinks split below the
    water table with the watmin limiter."""
    Pcol = np.concatenate([np.full(7, 1.5e5), np.full(8, 2.0e3)])
    _set_state(closed15, np.tile(Pcol, (6, 1)))
    oj, ot = _step_both(closed15, 600.0, qflx_drain=np.full(6, 1e-3))
    assert np.all(ot["qflx_drain_tot"].numpy() > 0)


def test_seepage_sheds_excess_water(seep10):
    """Saturated heterogeneous columns under infiltration with the seepage
    BC: qflx_seepage carries the infiltration back out."""
    _set_state(seep10, np.full((4, 10), 1.05e5))
    qinfl = np.full(4, 1e-3)
    oj, ot = _step_both(seep10, 1800.0, qflx_infl=qinfl)
    np.testing.assert_allclose(ot["qflx_seepage"].numpy(), qinfl, rtol=2e-2)


def test_all_forcings_two_steps(seep10):
    rng = np.random.default_rng(3)
    rootr = np.zeros((4, 10))
    rootr[:, -4:] = 0.25
    _set_state(seep10, np.full((4, 10), 2.0e3))
    forcing = dict(qflx_infl=2e-4 * (0.2 + rng.random(4)),
                   qflx_tran_veg=1e-4 * rng.random(4), rootr=rootr,
                   qflx_drain=np.full(4, 5e-5),
                   t_soil=273.15 + 10.0 + 5.0 * rng.random((4, 10)))
    for _ in range(2):
        _step_both(seep10, 1800.0, **forcing)


def test_state_from_numpy_handover(seep10):
    """Two JAX steps, then the JAX state moves into a freshly built port
    problem; both step on from the one state."""
    pj, _ = seep10
    pj.P = jnp.asarray(np.full((4, 10), 3.0e3))
    kw = dict(qflx_infl=np.full(4, 3e-4), qflx_drain=np.full(4, 2e-5))
    for _ in range(2):
        jalm.alm_vsfm_solve(pj, 1800.0, **kw)
    pt = talm.alm_vsfm_initialize(device="cpu", **_hetero_kwargs())
    tree = lambda d: {k: tree(v) if isinstance(v, dict) else np.asarray(v)
                      for k, v in d.items()}
    P, dyn = talm.state_from_numpy(
        np.asarray(pj.P), tuple(tree(d) for d in pj.dyn),
        device="cpu", dtype=torch.float64)
    # a freshly built problem matches the JAX one by construction
    for k, v in dyn[0].items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                assert torch.equal(pt.dyn[0][k][kk], vv), kk
        else:
            assert torch.equal(pt.dyn[0][k], v), k
    pt.P, pt.dyn = P, dyn
    _step_both((pj, pt), 1800.0, **kw)


def test_retry_ladder_tightens_on_audit_failure(monkeypatch):
    """A forced audit failure: the driver tightens and re-solves
    (mass_bal_err_count=1, attempts=2), as Driver.F90:886-905."""
    prob = talm.alm_vsfm_initialize(device="cpu",
                                    **_soil_kwargs(ncol=2, nz=4))
    calls = {"n": 0}
    real = talm._audit_err

    def fake(*args):
        calls["n"] += 1
        err = real(*args)
        return err + 1.0 if calls["n"] == 1 else err

    monkeypatch.setattr(talm, "_audit_err", fake)
    out = talm.alm_vsfm_solve(prob, 600.0)
    assert out["mass_bal_err_count"] == 1
    assert out["attempts"] == 2
    assert out["abs_mass_error_col"] < talm.MAX_ABS_MASS_ERROR_COL


def test_retry_ladder_aborts_after_max_attempts(monkeypatch):
    prob = talm.alm_vsfm_initialize(device="cpu",
                                    **_soil_kwargs(ncol=2, nz=4))
    monkeypatch.setattr(talm, "_audit_err", lambda *a: np.full(2, 1.0))
    with pytest.raises(RuntimeError, match="failed to converge"):
        talm.alm_vsfm_solve(prob, 60.0)


def test_f32_throughput_mode_converges():
    """f32 state without escalation, the relaxed audit of the throughput
    mode; the state stays f32."""
    soil = _hetero_kwargs(ncol=8, nz=12, seed=1)
    prob = talm.alm_vsfm_initialize(dtype=torch.float32, escalate_f64=False,
                                    device="cpu",
                                    P0=np.full((8, 12), 3.5355e3), **soil)
    prob.audit_threshold_kg = 1e-3
    out = talm.alm_vsfm_solve(prob, 1800.0, qflx_infl=np.full(8, 2e-4))
    assert out["abs_mass_error_col"] < 1e-3
    assert prob.P.dtype == torch.float32
    assert bool(torch.isfinite(prob.P).all())


def test_unported_options_raise():
    """The UGDM lateral model (ugrid) and column sharding (device_mesh)
    wait for Slice G; the ring lateral and f32 escalation are ported."""
    with pytest.raises(NotImplementedError, match="Slice G"):
        talm.alm_vsfm_initialize(lateral_connectivity=True, ugrid=object(),
                                 device="cpu", **_soil_kwargs(ncol=2, nz=4))
    with pytest.raises(NotImplementedError, match="Slice G"):
        talm.alm_vsfm_initialize(lateral_connectivity=True,
                                 device_mesh=object(), device="cpu",
                                 **_soil_kwargs(ncol=2, nz=4))
    prob = talm.alm_vsfm_initialize(dtype=torch.float32, device="cpu",
                                    lateral_connectivity=True,
                                    **_soil_kwargs(ncol=2, nz=4))
    assert prob.escalate_f64 and "Lateral_flux" in prob.ss_slices


def test_f32_escalates_failing_columns_to_f64():
    """tests/test_alm.py:221 on both packages: f32 state (escalation on by
    default) with a stiff infiltration front on half the columns; the
    failing half is re-solved in f64.  Equal escalated_cols and retry
    counters, P within 1e-6 relative of JAX, audit < 1e-5 kg, the state
    f32."""
    ncol, nz = 8, 48
    soil = _soil_kwargs(ncol, nz, dz=0.05)
    P0 = np.full((ncol, nz), 1.0e3)
    pj = jalm.alm_vsfm_initialize(P0=P0, dtype=jnp.float32, **soil)
    pt = talm.alm_vsfm_initialize(P0=P0, dtype=torch.float32, device="cpu",
                                  **soil)
    qinfl = np.zeros(ncol)
    qinfl[: ncol // 2] = 8e-3
    oj = jalm.alm_vsfm_solve(pj, 3600.0, qflx_infl=qinfl)
    ot = talm.alm_vsfm_solve(pt, 3600.0, qflx_infl=qinfl)
    assert ot["escalated_cols"] == oj["escalated_cols"] == ncol // 2
    for k in ("attempts", "mass_bal_err_count", "diverged_count"):
        assert ot[k] == oj[k], k
    assert ot["abs_mass_error_col"] < talm.MAX_ABS_MASS_ERROR_COL
    assert pt.P.dtype == torch.float32
    np.testing.assert_allclose(pt.P.numpy(), np.asarray(pj.P), rtol=1e-6)
    # the unpack at the escalated state
    np.testing.assert_allclose(ot["smp_l"].numpy(), np.asarray(oj["smp_l"]),
                               rtol=1e-6)
    np.testing.assert_allclose(ot["zwt"].numpy(), np.asarray(oj["zwt"]),
                               rtol=1e-6)


def test_ring_lateral_matches_jax():
    """The single-device ring lateral (Driver:465-532 'source_sink'):
    wet and dry halves relax toward each other, two 600 s steps at
    ncol 8, nz 8, f64; qflx_lateral and P within rtol 1e-10 of JAX, the
    far columns see no net flux on the first step, the pair-antisymmetric
    source conserves mass."""
    ncol, nz = 8, 8
    P0 = np.full((ncol, nz), 3.5355e3)
    P0[: ncol // 2] = 9.0e4
    kw = dict(P0=P0, lateral_connectivity=True, lateral_conductance=1e-10,
              **_soil_kwargs(ncol, nz))
    pj = jalm.alm_vsfm_initialize(**kw)
    pt = talm.alm_vsfm_initialize(device="cpu", **kw)
    assert pt.ss_slices == pj.ss_slices
    m0 = float(talm.cell_mass_kg(pt, pt.P).sum())
    for step in range(2):
        oj = jalm.alm_vsfm_solve(pj, 600.0)
        ot = talm.alm_vsfm_solve(pt, 600.0)
        qj, qt = np.asarray(oj["qflx_lateral"]), ot["qflx_lateral"].numpy()
        np.testing.assert_allclose(qt, qj, rtol=1e-10, atol=1e-300)
        np.testing.assert_allclose(pt.P.numpy(), np.asarray(pj.P),
                                   rtol=1e-10)
        assert abs(qt[0]) < 1e-12 and abs(qt[-1]) < 1e-12
        if step == 0:
            far = np.r_[0:ncol // 2 - 1, ncol // 2 + 1:ncol]
            assert np.abs(qt[far]).max() < 1e-12
        assert qt[ncol // 2 - 1] > 0 and qt[ncol // 2] < 0
        assert abs(float(qt.sum())) < 1e-10
        assert ot["abs_mass_error_col"] < talm.MAX_ABS_MASS_ERROR_COL
    m1 = float(talm.cell_mass_kg(pt, pt.P).sum())
    assert m1 == pytest.approx(m0, rel=1e-6)


def test_water_table_detection():
    prob = talm.alm_vsfm_initialize(device="cpu",
                                    **_soil_kwargs(ncol=2, nz=10))
    Pcol = np.linspace(1.5e5, 0.2e5, 10)      # saturated bottom, dry top
    smp_l = (np.tile(Pcol, (2, 1)) - 101325.0) / (1000.0 * 9.80616) * 1e3
    zwt_t = talm._water_table_depth(torch.as_tensor(smp_l), prob.zi)
    zwt_j = jalm._water_table_depth(smp_l, prob.zi)
    np.testing.assert_allclose(zwt_t.numpy(), np.asarray(zwt_j), rtol=1e-14)
    assert np.all(zwt_t.numpy() > 0.0) and np.all(zwt_t.numpy() < 1.0)

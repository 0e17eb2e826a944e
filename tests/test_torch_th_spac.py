"""The TH-SPAC network of the PyTorch port (models/th_spac.py,
problems/th_manoli2014.py) against the JAX package, on the CPU in f64.

Both packages build ``build_th_manoli2014()`` (500 unknowns, 12 colors)
and take ONE step of 8640 s in a module fixture: the JAX package's own
test takes NSTEP = 3, cut here to one because a JAX step costs ~25 s on
the CPU.  Held:

* the step: equal convergence, reason, Newton and GMRES iterations, the
  solution within rtol 1e-9 (``serial_parity.RTOL``), and equal metrics
  records (every field but the wall clock);
* the Jacobian plan: equal CSR pattern, ``ncolors`` and colors;
* the colored Jacobian at the initial state: the CSR data within 1e-12
  of max |J| of JAX's ``_sparse_jac_data``, and of a dense
  ``torch.func.jacfwd``, which is exactly zero outside the pattern;
* conservation of mass and energy to 1e-12 relative and the isothermal
  bound (0 < max |T - 283.15| < 0.01 K), as tests/test_th_manoli2014.py;
* the CLI type (``nstep=1``) through the runner, against the fixture's
  step;
* port only: at ``scale=2`` one step conserves mass to 1e-8 relative.
"""
from functools import partial

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpp_tpu.io.metrics import MetricsStream as JMetrics
from mpp_tpu.problems import th_manoli2014 as jtm
from mpp_tpu_torch.io.metrics import MetricsStream
from mpp_tpu_torch.problems import th_manoli2014 as ttm
from serial_parity import RTOL

DT = 8640.0
JAC_RTOL = 1e-12


def _jax_totals(soe, X):
    P, T = soe._split(jnp.asarray(X))
    m = e = 0.0
    for i, (gm, ge) in enumerate(zip(soe.mass_ges, soe.energy_ges)):
        gm.temperature = T[i]
        m += float(jnp.sum(gm.accum(P[i])))
        e += float(jnp.sum(ge.accum_e(T[i], P[i])))
    return m, e


def _step(soe, stream):
    soe.metrics = stream
    n0 = soe.cumulative_newton_iterations
    l0 = soe.cumulative_linear_iterations
    ok, reason = soe.step_dt(DT, 1)
    return (bool(ok), int(reason), soe.cumulative_newton_iterations - n0,
            soe.cumulative_linear_iterations - l0)


@pytest.fixture(scope="module")
def stepped():
    """(JAX mpp, port mpp, their step summaries, the port's initial
    totals), each after one step with a metrics stream attached."""
    jm = jtm.build_th_manoli2014()
    tm = ttm.build_th_manoli2014(device="cpu")
    totals0 = tm.soe.totals(tm.soe.soln)
    sj = _step(jm.soe, JMetrics())
    st = _step(tm.soe, MetricsStream())
    return jm, tm, sj, st, totals0


def test_step_matches_jax(stepped):
    jm, tm, sj, st, _ = stepped
    assert st == sj and sj[0] and sj[2] > 0 and sj[3] > 0
    np.testing.assert_allclose(tm.soe.soln, np.asarray(jm.soe.soln),
                               rtol=RTOL)
    assert tm.soe.host_syncs > 0


def test_metrics_record_matches_jax(stepped):
    jm, tm, *_ = stepped
    rj, rt = jm.soe.metrics.last(), tm.soe.metrics.last()
    rj.pop("t_wall")
    rt.pop("t_wall")
    assert rt == rj and rt["converged"] is True and rt["dt"] == DT


def test_coloring_matches_jax(stepped):
    jm, tm, *_ = stepped
    pj, pt = jm.soe._jac_plan, tm.soe._jac_plan
    np.testing.assert_array_equal(pt["tpl"].indptr, pj["tpl"].indptr)
    np.testing.assert_array_equal(pt["tpl"].indices, pj["tpl"].indices)
    assert pt["ncolors"] == pj["ncolors"] == 12
    np.testing.assert_array_equal(pt["entry_color"],
                                  np.asarray(pj["entry_color"]))
    seeds = np.asarray(pj["seeds"])
    np.testing.assert_array_equal(pt["color"], seeds.argmax(axis=0))


def test_colored_jacobian_matches_jax_and_dense():
    jm = jtm.build_th_manoli2014()
    tm = ttm.build_th_manoli2014(device="cpu")
    js, ts = jm.soe, tm.soe
    am, ae = js._accums(js.soln_prev, DT)
    jres = partial(js._residual_pure, accum_prev_m=am, accum_prev_e=ae,
                   dt=DT)
    js._build_jac_plan()
    jdata = np.asarray(js._sparse_jac_data(jres, jnp.asarray(js.soln)))

    X = torch.as_tensor(ts.soln, dtype=torch.float64)
    am, ae = ts._accums(X, DT)
    res = partial(ts._residual_pure, accum_prev_m=am, accum_prev_e=ae,
                  dt=DT)
    data = ts._sparse_jac_data(res, X).numpy()
    scale = np.abs(jdata).max()
    assert np.abs(data - jdata).max() <= JAC_RTOL * scale

    tpl = ts._jac_plan["tpl"]
    n = 2 * ts.ntot
    J_sparse = np.zeros((n, n))
    J_sparse[tpl.row_ids(), tpl.indices] = data
    J_dense = torch.func.jacfwd(res)(X).numpy()
    assert np.abs(J_sparse - J_dense).max() <= JAC_RTOL * \
        np.abs(J_dense).max()
    mask = np.zeros_like(J_dense, bool)
    mask[tpl.row_ids(), tpl.indices] = True
    assert np.abs(np.where(mask, 0.0, J_dense)).max() == 0.0
    # the residual at the same state, for completeness
    np.testing.assert_allclose(res(X).numpy(),
                               np.asarray(jres(jnp.asarray(js.soln))),
                               rtol=0, atol=JAC_RTOL * np.abs(
                                   np.asarray(jres(jnp.asarray(js.soln)))
                               ).max())


def test_conservation_and_isothermal_bound(stepped):
    jm, tm, _, _, (m0, e0) = stepped
    m1, e1 = tm.soe.totals(tm.soe.soln)
    assert abs(m1 - m0) / m0 < 1e-12
    assert abs(e1 - e0) / abs(e0) < 1e-12
    js = jtm.build_th_manoli2014().soe
    mj0 = _jax_totals(js, js.soln)
    np.testing.assert_allclose((m0, e0), mj0, rtol=1e-12)
    T = tm.soe.soln[tm.soe.ntot:]
    dT = np.max(np.abs(T - ttm.TEMP_INITIAL))
    assert 0.0 < dT < 0.01


def test_runner_and_cli_type(stepped, tmp_path, monkeypatch):
    """The CLI's th_manoli2014 type (nstep=1) calls the runner on the CPU,
    which takes the fixture's step."""
    _, tm, *_ = stepped
    from mpp_tpu_torch import cli
    from mpp_tpu_torch.models.th_spac import THSpacSoE
    calls, solns = [], []
    runner, step_dt = ttm.run_th_manoli2014_problem, THSpacSoE.step_dt

    def run(**kw):
        calls.append(kw)
        mpp = runner(**kw)
        assert len(mpp.soe.goveqns) == 6
        return mpp

    def tapped(self, dt, nstep=1):
        out = step_dt(self, dt, nstep)
        solns.append(self.soln)
        return out

    monkeypatch.setattr(ttm, "run_th_manoli2014_problem", run)
    monkeypatch.setattr(THSpacSoE, "step_dt", tapped)
    nl = tmp_path / "th_manoli2014.namelist"
    nl.write_text("&mpp_driver\n  problem_type = 'th_manoli2014'\n/\n"
                  "&problem_options\n  nstep = 1\n/\n")
    assert cli.main(["-namelist", str(nl), "-device", "cpu"]) == 0
    assert calls == [dict(dtime=DT, nstep=1, device=torch.device("cpu"))]
    assert len(solns) == 1
    np.testing.assert_array_equal(solns[0], tm.soe.soln)


def test_scale2_conserves_mass():
    mpp = ttm.build_th_manoli2014(scale=2, device="cpu")
    soe = mpp.soe
    assert 2 * soe.ntot == 1000
    m0, _ = soe.totals(soe.soln)
    ok, reason = soe.step_dt(DT)
    assert ok, reason
    assert soe._jac_plan["ncolors"] <= 40
    m1, _ = soe.totals(soe.soln)
    assert abs(m1 - m0) <= 1e-8 * abs(m0)


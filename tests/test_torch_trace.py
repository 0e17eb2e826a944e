"""The port's span recorder (``mpp_tpu_torch/io/timers.py``) and the spans
of its stepped path, on the CPU.

The recorder's nesting, parent links, step identifiers and the
benchmark's self-time arithmetic (``benchmark/spans.py``); that it records
nothing while off and records under torch.profiler; that it adds no
profiler event; that the ALM step and the V-catchment's serial step give
bitwise-equal results and equal host syncs with spans on and off; that a
step's ``sync`` spans are its counted syncs; and that every span of the
stepped path appears.
"""
import collections
import os
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpp_tpu_torch.batched.vsfm_compiled import compile_vsfm
from mpp_tpu_torch.driver import alm
from mpp_tpu_torch.io import timers
from mpp_tpu_torch.problems import vsfm_vchannel as vch

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")

SPAN_NAMES = {"alm.step", "newton.step", "newton.serial_step",
              "newton.snes", "newton.line_search", "assembly.residual",
              "assembly.jacobian", "assembly.resjac", "assembly.accum",
              "assembly.constitutive", "linsolve", "sync"}


@pytest.fixture(autouse=True)
def _fresh_recorder():
    timers.enable(None)
    timers.clear()
    yield
    timers.enable(None)
    timers.clear()


@pytest.fixture(scope="module")
def spans_mod():
    """``benchmark/spans.py`` (and the ``devtrace`` it imports)."""
    sys.path.insert(0, BENCH)
    try:
        import spans
        import devtrace
    finally:
        sys.path.remove(BENCH)
    return types.SimpleNamespace(spans=spans, devtrace=devtrace)


def _alm_problem(ncol=64, nz=15, seed=3):
    rng = np.random.default_rng(seed)
    shape = (ncol, nz)
    prob = alm.alm_vsfm_initialize(
        watsat=0.35 + 0.1 * rng.random(shape),
        hksat=0.004 * (0.5 + rng.random(shape)),
        bsw=2.0 + 2.0 * rng.random(shape),
        sucsat=20.0 + 20.0 * rng.random(shape),
        residual_sat=0.10 + 0.1 * rng.random(shape),
        dz=np.full(shape, 0.1), area=1.0 + rng.random(ncol),
        P0=np.full(shape, 9.0e4), include_seepage_bc=True, device="cpu")
    rootr = np.zeros(shape)
    rootr[:, -5:] = 0.2
    forcing = dict(qflx_infl=np.full(ncol, 3e-4),
                   qflx_tran_veg=np.full(ncol, 1e-4), rootr=rootr)
    return prob, forcing


@pytest.fixture(scope="module")
def alm_case():
    prob, forcing = _alm_problem()
    return prob, prob.P.clone(), forcing


def _alm_step(case, mode):
    """One ALM step from the case's state with the recorder in ``mode``:
    (output, the step's counted syncs, its spans)."""
    prob, P0, forcing = case
    prob.P = P0.clone()
    timers.clear()
    timers.enable(mode)
    syncs0 = prob.comp.host_syncs
    out = alm.alm_vsfm_solve(prob, 1800.0, **forcing)
    timers.enable(None)
    return out, prob.comp.host_syncs - syncs0, timers.spans()


# ---- the recorder ---------------------------------------------------------

def test_nesting_parents_steps_and_attrs():
    timers.enable()
    a = timers.begin("a")
    b = timers.begin("b", {"k": 1})
    with timers.Site("c"):
        pass
    timers.end(b)
    timers.end(a, {"n": 2})
    d = timers.begin("d")
    timers.end(d)
    s = timers.spans()
    assert [x.name for x in s] == ["a", "b", "c", "d"]
    assert [x.index for x in s] == [0, 1, 2, 3]
    assert [x.parent for x in s] == [-1, 0, 1, -1]
    assert s[0].step == s[1].step == s[2].step != s[3].step
    assert s[0].attrs == {"n": 2} and s[1].attrs == {"k": 1}
    assert s[0].start_ns <= s[1].start_ns <= s[2].start_ns
    assert s[2].end_ns <= s[1].end_ns <= s[0].end_ns <= s[3].start_ns
    # a span left open inside another closes with it
    e = timers.begin("e")
    timers.begin("f")
    timers.end(e)
    e_, f_ = timers.spans()[-2:]
    assert f_.parent == e_.index and f_.end_ns == e_.end_ns
    assert timers.RECORDER.open == []
    # a time window keeps the spans inside it
    assert [x.name for x in timers.spans(s[3].start_ns, s[3].end_ns)] == \
        ["d"]


def test_a_site_closes_its_own_span_on_an_exception():
    timers.enable()
    site = timers.Site("outer")
    with pytest.raises(ValueError):
        with site:
            timers.begin("left_open")
            raise ValueError
    assert timers.RECORDER.open == []
    assert all(s.end_ns is not None for s in timers.spans())


def test_off_records_nothing():
    assert timers.begin("x") == -1
    timers.end(-1)
    with timers.Site("y"):
        pass
    assert timers.spans() == [] and timers.RECORDER.open == []
    timers.enable(False)
    with profile(activities=[ProfilerActivity.CPU]):
        assert timers.begin("x") == -1
    assert timers.spans() == []


def test_records_under_the_profiler(alm_case):
    _, _, off = _alm_step(alm_case, None)
    assert off == []
    prob, P0, forcing = alm_case
    prob.P = P0.clone()
    with profile(activities=[ProfilerActivity.CPU]):
        alm.alm_vsfm_solve(prob, 1800.0, **forcing)
    names = {s.name for s in timers.spans()}
    assert {"alm.step", "newton.step", "sync"} <= names
    n = len(timers.spans())
    _alm_step(alm_case, None)
    assert len(timers.spans()) == 0 and n > 0


def test_phase_timers_phases_are_spans():
    pt = timers.PhaseTimers(device="cpu")
    with pt.phase("LWV"):
        pass
    assert timers.spans() == []
    timers.enable()
    with pt.phase("LWV"):
        with pt.phase("LBL"):
            pass
    s = timers.spans()
    assert [x.name for x in s] == ["LWV", "LBL"] and s[1].parent == 0
    assert pt.report()["LWV"]["count"] == 2 and pt.host_syncs == 0


def test_no_profiler_events_added(alm_case):
    """The same kineto events, name for name, with the recorder on (as
    under every profiler) and forced off; no span is an event."""
    _alm_step(alm_case, None)            # the stepper's constants cached

    def events(mode):
        prob, P0, forcing = alm_case
        prob.P = P0.clone()
        timers.clear()
        timers.enable(mode)
        with profile(activities=[ProfilerActivity.CPU]) as p:
            alm.alm_vsfm_solve(prob, 1800.0, **forcing)
        timers.enable(None)
        return collections.Counter(
            e.name() for e in p.profiler.kineto_results.events())

    on, off = events(None), events(False)
    assert on == off and sum(on.values()) > 0
    assert not SPAN_NAMES & set(on)


# ---- the stepped path -------------------------------------------------------

@pytest.mark.parametrize("linesearch_jac", ["separate", "fused"])
def test_alm_step_equal_with_spans_and_syncs_spanned(alm_case,
                                                     linesearch_jac):
    prob = alm_case[0]
    comp = prob.comp
    if linesearch_jac == "fused":
        prob.comp = compile_vsfm(prob.mpp, linear_solver="direct",
                                 linesearch_jac="fused")
    try:
        out0, syncs0, spans0 = _alm_step(alm_case, None)
        out1, syncs1, spans1 = _alm_step(alm_case, True)
    finally:
        prob.comp = comp
    assert spans0 == []
    for k, v in out0.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, out1[k]), k
        else:
            assert v == out1[k], k
    assert syncs0 == syncs1 == out1["host_round_trips_per_step"] > 0
    names = [s.name for s in spans1]
    assert names.count("sync") == out1["host_round_trips_per_step"]
    assert names.count("alm.step") == 1 and spans1[0].name == "alm.step"
    assert {s.step for s in spans1} == {spans1[0].step}
    want = {"alm.step", "newton.step", "newton.snes", "newton.line_search",
            "assembly.accum", "assembly.constitutive", "linsolve", "sync",
            "assembly.resjac" if linesearch_jac == "fused"
            else "assembly.jacobian"}
    assert want <= set(names)
    assert [s.attrs for s in spans1 if s.name == "linsolve"][0] == \
        {"plan": "thomas"}
    for s in spans1:
        if s.name == "newton.snes":
            a = s.attrs
            assert 0 <= a["cols_unconverged"] <= a["cols_evaluated"]
            assert a["cols_evaluated"] % 64 == 0


@pytest.fixture(scope="module")
def vchannels():
    return {plan: vch.run_vsfm_vchannel_problem(
        nz=3, nstep=0, use_compiled=True, linear_solver=plan, device="cpu")
        for plan in ("petsc", "direct")}


@pytest.mark.parametrize("plan", ["petsc", "direct"])
def test_serial_step_equal_with_spans_and_syncs_spanned(vchannels, plan):
    mpp = vchannels[plan]
    comp = mpp.soe.step_dt.__self__
    ic = np.array(mpp.soe.soln, np.float64)

    def step(mode):
        mpp.restart(ic)
        timers.clear()
        timers.enable(mode)
        syncs0 = comp.host_syncs
        ok, reason = mpp.soe.step_dt(8640.0, 1)
        timers.enable(None)
        return (ok, reason, np.array(mpp.soe.soln), comp.host_syncs - syncs0,
                timers.spans())

    ok0, r0, X0, n0, s0 = step(None)
    ok1, r1, X1, n1, s1 = step(True)
    assert ok0 and ok1 and r0 == r1 and s0 == []
    assert np.array_equal(X0, X1) and n0 == n1 > 3
    names = [s.name for s in s1]
    assert names.count("sync") == n1
    assert s1[0].name == "newton.serial_step" and s1[0].parent == -1
    assert names.count("newton.serial_step") == 1
    # the serial step's reads of its result are its last three syncs,
    # children of the serial step itself
    tail = [s for s in s1 if s.name == "sync"][-3:]
    assert all(s.parent == s1[0].index for s in tail)
    assert {s.attrs["plan"] for s in s1 if s.name == "linsolve"} == \
        {"petsc" if plan == "petsc" else "block"}
    assert SPAN_NAMES - {"alm.step", "assembly.resjac"} <= set(names)


# ---- the benchmark's arithmetic of spans ------------------------------------

def _span(i, name, a, b, parent=-1, attrs=None):
    s = timers.Span(i, name, a, parent, 0, attrs)
    s.end_ns = b
    return s


def test_self_time_arithmetic(spans_mod, monkeypatch):
    sm, dt = spans_mod.spans, spans_mod.devtrace
    fake = [_span(0, "root", 0, 100),
            _span(1, "kid", 10, 30, 0), _span(2, "kid", 30, 50, 0),
            _span(3, "grandkid", 21, 29, 1), _span(4, "kid", 60, 70, 0),
            _span(5, "root", 200, 260),
            _span(6, "newton.snes", 210, 220, 5,
                  {"cols_evaluated": 64, "cols_unconverged": 16}),
            _span(7, "newton.snes", 230, 240, 5,
                  {"cols_evaluated": 8, "cols_unconverged": 8})]
    own = sm.self_ns(fake)
    # the root less the union of its children (10-50 and 60-70)
    assert own[0] == 100 - 40 - 10
    assert own[1] == 20 - 8 and own[2] == 20 and own[3] == 8
    assert own[5] == 60 - 20
    # self times partition the root spans
    assert sum(own.values()) == 100 + 60
    monkeypatch.setattr(timers, "spans", lambda lo, hi: [
        s for s in fake if s.start_ns >= lo and s.end_ns <= hi])
    ns = 1e-9
    run = types.SimpleNamespace(
        trace=dt.Trace(device=[("k", 40 * ns, 80 * ns),
                               ("k", 150 * ns, 170 * ns)],
                       host=[], window=(0.0, 300 * ns)),
        records=[{}, {}])
    ms = lambda v: v * 1e-6 / 2
    assert sm.self_ms_per_step(run, ("root",)) == pytest.approx(ms(90))
    assert sm.self_ms_per_step(run, ("kid",)) == pytest.approx(ms(42))
    assert sm.self_ms_per_step(run, ("absent",)) is None
    assert sm.outside_ms_per_step(run) == pytest.approx(ms(300 - 160))
    assert sm.useful_col_pct(run) == pytest.approx(100 * 24 / 72)
    # idle 0-40, 80-150, 170-300 (240 ns); under no span: 100-150,
    # 170-200 and 260-300 (120 ns)
    assert sm.idle_unspanned_pct(run) == pytest.approx(50.0)
    # the same idle by the innermost span open over it
    want = {"root": 30 + 40, "kid": 12 + 10, "grandkid": 8,
            "newton.snes": 20, "(none)": 120}
    got = sm.idle_by_span(run)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(ms(v), abs=1e-9), k
    assert sm.overlap_s([(0, 2), (3, 5)], [(1, 4)]) == 2
    # a program without the recorder: every reader finds nothing
    monkeypatch.delattr(timers, "spans")
    assert sm.window_spans(run) == []
    assert sm.self_ms_per_step(run, ("root",)) is None
    assert sm.idle_unspanned_pct(run) is None
    assert sm.useful_col_pct(run) is None

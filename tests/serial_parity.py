"""Helpers of the serial-SNES parity tests (tests/test_torch_*serial*.py):
a per-step record of each package's serial ``step_dt`` and the checks
that hold the port to the JAX package step by step."""
import numpy as np

RTOL = 1e-9


def tap(monkeypatch, cls):
    """Wrap ``cls.step_dt`` (the serial SoE's) so that every step appends
    (converged, reason, Newton iterations, linear iterations, soln) to
    the returned list."""
    log = []
    orig = cls.step_dt

    def step_dt(self, dt, nstep=1):
        n0 = self.cumulative_newton_iterations
        l0 = self.cumulative_linear_iterations
        ok, reason = orig(self, dt, nstep)
        log.append((bool(ok), int(reason),
                    self.cumulative_newton_iterations - n0,
                    self.cumulative_linear_iterations - l0,
                    np.array(np.asarray(self.soln), np.float64)))
        return ok, reason

    monkeypatch.setattr(cls, "step_dt", step_dt)
    return log


def assert_steps_match(log_t, log_j, rtol=RTOL):
    """Every step: equal convergence, SNES reason, Newton and linear
    iterations; the solution after it within ``rtol``."""
    assert len(log_t) == len(log_j) > 0
    for k, (t, j) in enumerate(zip(log_t, log_j)):
        assert t[:4] == j[:4], (k, t[:4], j[:4])
        np.testing.assert_allclose(t[4], j[4], rtol=rtol, err_msg=str(k))


def assert_regression_files_match(fj, ft, rtol=RTOL):
    """Two regression files: identical sections, categories and sampled
    cells, every number within ``rtol`` of the section's largest
    magnitude."""
    from mpp_tpu_torch.io import regression as treg
    sj = treg.parse_regression(open(fj).read())
    st = treg.parse_regression(open(ft).read())
    assert list(st) == list(sj) and sj
    for name, secj in sj.items():
        sect = st[name]
        assert sect["category"] == secj["category"]
        assert list(sect["values"]) == list(secj["values"])
        vj = np.array(list(secj["values"].values()))
        vt = np.array(list(sect["values"].values()))
        scale = max(float(np.abs(vj).max()), 1e-300)
        assert float(np.abs(vt - vj).max()) / scale <= rtol, name


def run_pairs(problems, jax_soe, port_soe):
    """Run each entry ``name: (JAX runner, port runner, kwargs, ...)`` of
    ``problems`` through both packages (the port's on the CPU), tapping
    each package's serial SoE class; returns {name: (JAX result, JAX step
    log, port result, port step log)}."""
    import pytest
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for name, (jrun, trun, kw, *_) in problems.items():
            lj = tap(mp, jax_soe)
            rj = jrun(**kw)
            mp.undo()
            lt = tap(mp, port_soe)
            rt = trun(device="cpu", **kw)
            mp.undo()
            out[name] = (rj, lj, rt, lt)
    finally:
        mp.undo()
    return out

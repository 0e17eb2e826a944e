"""The port's serial SNES (``ops/snes.snes_solve``), its GMRES counts,
``config.read_namelist`` and the NaN trap, against the JAX package on the
CPU in f64.

``snes_solve`` runs the same small nonlinear system (a tridiagonal
operator plus a cubic term, n = 12) from the same starts through each
line search in both packages: equal reasons, Newton and linear
iterations, and iterates within rtol 1e-9 (the host numpy control flow
is the JAX package's, so the branch decisions match).  The l2 search
from the negative start runs to DIVERGED_MAX_IT in both.
"""
import numpy as np
import pytest
import torch

from mpp_tpu import config as jconfig
from mpp_tpu.ops import ilu as jilu
from mpp_tpu.ops import snes as jsnes
from mpp_tpu_torch import config
from mpp_tpu_torch.ops import ilu as tilu
from mpp_tpu_torch.ops import snes as tsnes

RTOL = 1e-9
N = 12
_B = np.random.default_rng(0).normal(size=N)


def _residual(x):
    y = x ** 3 + 2.0 * x - _B
    y[1:] -= x[:-1]
    y[:-1] -= x[1:]
    return y


def _csr(n):
    rows, cols = [], []
    for i in range(n):
        for j in (i - 1, i, i + 1):
            if 0 <= j < n:
                rows.append(i)
                cols.append(j)
    indptr = np.concatenate([[0], np.cumsum(np.bincount(rows,
                                                        minlength=n))])
    return indptr, np.asarray(cols), np.asarray(rows)


_INDPTR, _INDICES, _ROWS = _csr(N)


def _jacobian_np(x):
    data = np.where(_ROWS == _INDICES, 3.0 * x[_ROWS] ** 2 + 2.0, -1.0)
    return _INDPTR, _INDICES, data


def _jacobian_t(x):
    indptr, indices, data = _jacobian_np(x)
    return indptr, indices, torch.as_tensor(data)


@pytest.mark.parametrize("x0", [10.0, -3.0], ids=["pos", "neg"])
@pytest.mark.parametrize("ls", ["bt", "basic", "l2", "cp"])
def test_snes_solve_matches_jax(ls, x0):
    start = np.full(N, x0)
    rj = jsnes.snes_solve(_residual, _jacobian_np, start,
                          jsnes.SNESOptions(linesearch=ls))
    syncs = tsnes.HostSyncs()
    rt = tsnes.snes_solve(_residual, _jacobian_t, start,
                          tsnes.SNESOptions(linesearch=ls), syncs)
    assert (rt.reason, rt.iterations, rt.linear_iterations) == \
        (rj.reason, rj.iterations, rj.linear_iterations)
    np.testing.assert_allclose(rt.x, rj.x, rtol=RTOL, atol=1e-14)
    assert rt.fnorm == pytest.approx(rj.fnorm, rel=1e-6, abs=1e-12)
    # one Newton direction a step, one J Y each BT step, GMRES predicates
    assert syncs.n >= rt.iterations


def _system(n, seed):
    rng = np.random.default_rng(seed)
    indptr, indices, rows = _csr(n)
    data = rng.normal(size=indices.size)
    data[rows == indices] += 4.0
    return indptr, indices, data, rng.normal(size=n)


@pytest.mark.parametrize("maxiter", [10000, 3])
@pytest.mark.parametrize("pc", [False, True], ids=["nopc", "ilu"])
def test_petsc_gmres_counts_match_numpy_engine(pc, maxiter):
    """On a system smaller than the restart length (n = 12 < 30) the
    inner iterations, the convergence flag and x equal the numpy
    engine's, also when ``maxiter`` stops the solve inside a cycle."""
    indptr, indices, data, b = _system(N, 3)
    kw = dict(rtol=1e-12, maxiter=maxiter)
    if pc:
        ij, it = jilu.ILU0(indptr, indices), tilu.ILU0(indptr, indices)
        kj = dict(pc=ij, pc_data=ij.factor(data))
        kt = dict(pc=it, pc_data=it.factor(torch.as_tensor(data)))
    else:
        kj = kt = {}
    xj, itj, cj = jilu.petsc_gmres(indptr, indices, data, b, **kj, **kw)
    xt, itt, ct = tilu.petsc_gmres(indptr, indices, torch.as_tensor(data),
                                   torch.as_tensor(b), **kt, **kw)
    assert (itt, ct) == (itj, cj)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=RTOL, atol=1e-12)
    if maxiter == 3 and not pc:
        assert itt == 3 and not ct


NAMELISTS = [
    "&mpp_driver\n  problem_type = 'bogus'\n/\n",
    "&mpp_driver\n  problem_type = 'vsfm_mms'\n/\n"
    "&regression_test\n  write_regression_output = .true.\n"
    "  num_cells = 5\n/\n&problem_options\n  nx = 20\n/\n",
    "! a comment line\n&mpp_driver\n problem_type = \"thermal_mms\" ! tail\n"
    "/\n&problem_options\n  problem_type = 2\n  dt = 8.64d3\n"
    "  flags = T, .f., .TRUE.\n  grid = 1, 2 3\n  name = word\n/\n",
]


@pytest.mark.parametrize("i", range(len(NAMELISTS)))
def test_read_namelist_matches_jax(i, tmp_path):
    text = NAMELISTS[i]
    assert config.read_namelist(text) == jconfig.read_namelist(text)
    path = tmp_path / "x.namelist"
    path.write_text(text)
    assert config.read_namelist(str(path)) == \
        jconfig.read_namelist(str(path))


@pytest.fixture
def armed():
    config.enable_nan_debug()
    yield
    config.enable_nan_debug("disable")


def test_nan_trap_env_hook(monkeypatch):
    monkeypatch.setenv("MPP_DEBUG_NANS", "1")
    try:
        assert config.maybe_enable_nan_debug_from_env()
        assert config.DEBUG_NANS
    finally:
        config.enable_nan_debug("disable")
    monkeypatch.setenv("MPP_DEBUG_NANS", "0")
    assert not config.maybe_enable_nan_debug_from_env()
    assert not config.DEBUG_NANS
    with pytest.raises(ValueError):
        config.enable_nan_debug("other")
    # disarmed, a check returns without reading its value
    config.check_finite("stage", torch.tensor([np.nan]))


def _celia(nstep, **kw):
    from mpp_tpu_torch.problems import vsfm_celia1990 as tc
    return tc.run_vsfm_celia1990_problem(nz=12, nstep=nstep, device="cpu",
                                         **kw)


def test_nan_trap_raises_on_nan_residual(armed):
    """Armed, the serial SNES and the compiled stepper raise
    FloatingPointError naming the stage at a NaN residual (a NaN staged
    into the top boundary condition)."""
    from mpp_tpu_torch.constants import AuxVarKind, Var
    for use_compiled, stage in ((False, "VSFMSoE residual"),
                                (True, "CompiledVSFM residual")):
        mpp = _celia(0, use_compiled=use_compiled)
        mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1,
                     np.full(1, np.nan))
        with pytest.raises(FloatingPointError, match=stage):
            mpp.soe.step_dt(3600.0, 1)


def test_nan_trap_celia_runs_clean(armed):
    """celia1990 steps clean under the armed trap, to the same state as
    without it."""
    clean = _celia(2)
    np.testing.assert_array_equal(clean.soe.soln, _clean_reference())


def _clean_reference():
    config.enable_nan_debug("disable")
    try:
        return _celia(2).soe.soln
    finally:
        config.enable_nan_debug()

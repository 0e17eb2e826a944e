"""Batched Newton stepper of the PyTorch port (mpp_tpu_torch/batched/
vsfm_compiled.py) against the JAX compiled stepper.

celia1990 columns built through each package's facade; f64 runs must take
identical Newton iteration counts and SNES reasons, with states within
rtol 1e-9 (ulp-level differences in the constitutive chain, amplified by
a few Newton iterations, stay far below it).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from mpp_tpu_torch import entry
from mpp_tpu_torch.batched import vsfm_compiled as tvc
from mpp_tpu_torch.ops import hopper_kernels as hk


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small batches: torch's intra-op threads only add contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _celia_inputs(ncol, nz, np_dtype=np.float64):
    X = np.full((ncol, nz), 3.5355e3, np_dtype)
    bc = np.stack([np.linspace(5.0e4, 9.8e4, ncol),
                   np.full(ncol, 3.5355e3)], axis=1).astype(np_dtype)
    ss = np.zeros((ncol, 0), np_dtype)
    return X, bc, ss


def test_celia_steps_match_jax():
    """celia1990, nz=16, ncol=8, f64, three 3600 s steps."""
    nz, ncol = 16, 8
    _, comp_j = graft._build_compiled_celia(nz)
    _, comp_t = entry.build_compiled_celia(nz)
    X, bc, ss = _celia_inputs(ncol, nz)
    Xj, Xt = jnp.asarray(X), torch.as_tensor(X)
    for step in range(3):
        Xj, it_j, ok_j, r_j = comp_j.step_batched(
            Xj, (jnp.asarray(bc),), (jnp.asarray(ss),), 3600.0)
        Xt, it_t, ok_t, r_t = comp_t.step_batched(
            Xt, (torch.as_tensor(bc),), (torch.as_tensor(ss),), 3600.0)
        assert int(it_j) == it_t, step
        np.testing.assert_array_equal(np.asarray(r_j), r_t.numpy())
        np.testing.assert_array_equal(np.asarray(ok_j), ok_t.numpy())
        np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-9)
    assert bool(ok_t.all())
    assert hk.LAUNCHES["thomas"] == 0      # CPU tensors: plain versions


def test_batched_columns_independent():
    """ncol > 1 at nz=100: each column solves its own problem, identical
    to solving it alone (as tests/test_vsfm_compiled.py:86)."""
    nz = 100
    _, comp = entry.build_compiled_celia(nz)
    tops = np.array([9.3991e4, 8.0e4, 5.0e4])
    X = torch.full((3, nz), 3.5355e3, dtype=torch.float64)
    bc = (torch.as_tensor(np.stack([[t, 3.5355e3] for t in tops])),)
    ss = (torch.zeros((3, 0), dtype=torch.float64),)
    Xb, iters, ok, reason = comp.step_batched(X, bc, ss, 3600.0)
    assert bool(ok.all()), reason
    for c in range(3):
        X1, _, ok1, _ = comp.step_batched(X[c:c + 1], (bc[0][c:c + 1],),
                                          (ss[0][c:c + 1],), 3600.0)
        assert bool(ok1.all())
        np.testing.assert_allclose(Xb[c].numpy(), X1[0].numpy(), rtol=0,
                                   atol=1e-8)
    assert float((Xb[0] - Xb[2]).abs().max()) > 1.0


def test_straggler_compaction_matches_full_batch(monkeypatch):
    """Straggler compaction (ncol >= 4096) reproduces the full-batch solve
    exactly (as tests/test_vsfm_compiled.py:142), and really runs."""
    nz, ncol = 16, 4096
    _, comp = entry.build_compiled_celia(nz)
    X, bc, ss = _celia_inputs(ncol, nz, np.float32)
    args = (torch.as_tensor(X), (torch.as_tensor(bc),),
            (torch.as_tensor(ss),), 3600.0)
    comp.compact_frac = 0
    P_ref, it_ref, ok_ref, r_ref = comp.step_batched(*args)
    gathers = []
    real_take = tvc._take
    monkeypatch.setattr(tvc, "_take",
                        lambda t, i: gathers.append(len(i)) or real_take(t, i))
    comp.compact_frac = 8
    P_c, it_c, ok_c, r_c = comp.step_batched(*args)
    assert gathers and max(gathers) == ncol // 8
    assert bool(ok_ref.all()) and bool(ok_c.all())
    assert torch.equal(P_c, P_ref)
    assert torch.equal(r_c, r_ref)


def test_f32_run_converges():
    """An f32 run takes the f32 parameter set and the mixed bf16 action
    and converges."""
    nz, ncol = 32, 8
    _, comp = entry.build_compiled_celia(nz)
    X, bc, ss = _celia_inputs(ncol, nz, np.float32)
    Xt = torch.as_tensor(X)
    for _ in range(2):
        Xt, iters, ok, reason = comp.step_batched(
            Xt, (torch.as_tensor(bc),), (torch.as_tensor(ss),), 3600.0)
        assert bool(ok.all()), reason
    assert Xt.dtype == torch.float32 and bool(torch.isfinite(Xt).all())
    # the top heads (5e4 .. 9.8e4 Pa) wetted the top cell
    assert float(Xt[:, -1].min()) > 2.0e4


def test_entry_runs():
    fn, (X0, bc0) = entry.entry(device="cpu", ncol=4, nz=16)
    X1 = fn(X0, bc0)
    assert X1.shape == (4, 16) and bool(torch.isfinite(X1).all())
    assert float(X1[:, -1].min()) > float(X0.max())


def test_unported_plans_raise():
    mpp, _ = entry.build_compiled_celia(8)
    with pytest.raises(NotImplementedError):
        tvc.compile_vsfm(mpp, linesearch_jac="fused")
    with pytest.raises(ValueError):
        tvc.compile_vsfm(mpp, linesearch_jac="other")


def test_serial_drop_in_matches_jax():
    """install() routes soe.step_dt through the batched stepper at ncol=1
    (gather_inputs of the staged BCs); two steps against the JAX
    package's compiled step_dt."""
    from mpp_tpu.constants import AuxVarKind, Var
    nz = 16
    mpp_j, comp_j = graft._build_compiled_celia(nz)
    mpp_t, comp_t = entry.build_compiled_celia(nz)
    assert comp_t.install("cpu") is comp_t
    for mpp in (mpp_j, mpp_t):
        mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1, [9.3991e4])
        mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 2, [3.5355e3])
    bc, ss = comp_t.gather_inputs(3, "cpu")
    assert bc[0].shape == (3, 2) and ss[0].shape == (3, 0)
    np.testing.assert_array_equal(bc[0][2].numpy(), [9.3991e4, 3.5355e3])
    for istep in (1, 2):
        ok_j, r_j = comp_j.step_dt(3600.0, istep)
        ok_t, r_t = mpp_t.soe.step_dt(3600.0, istep)
        assert ok_j and ok_t and r_j == r_t
        np.testing.assert_allclose(mpp_t.soe.soln,
                                   np.asarray(mpp_j.soe.soln), rtol=1e-9)
    assert mpp_t.soe.cumulative_newton_iterations == \
        mpp_j.soe.cumulative_newton_iterations
    g = mpp_t.soe.goveqns[0]
    np.testing.assert_array_equal(g.pressure, mpp_t.soe.soln)

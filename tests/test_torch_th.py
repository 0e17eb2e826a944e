"""The coupled TH slice of the PyTorch port (models/thermal_enthalpy.py,
batched/th_compiled.py, problems/th.py) against the JAX package.

Both packages build the same problems from the same numpy arguments
(``run_mass_and_heat``, ``run_th_mms``); the staged parameters must be
identical.  The GE assembly is compared on 4 perturbed columns (whole
columns below, across and above PRESSURE_REF, so the EOS clamp switches
inside the batch) with the
JAX functions vmapped, f64, rtol 1e-12 with an absolute floor of 1e-12 of
the array's largest entry (the residual is a difference of terms of that
size).  The stepper is held to the JAX direct stepper
(``compile_th(mpp, linear_solver="direct")``): equal Newton iterations
and reasons, states within rtol 1e-9 (ulp-level differences of the
constitutive chain, amplified by a few Newton iterations).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpp_tpu.batched.th_compiled import compile_th as jcompile_th
from mpp_tpu.models.thermal_enthalpy import (
    richards_offdiag_t_values as j_offdiag_t)
from mpp_tpu.problems import th as jth
from mpp_tpu_torch.batched.th_compiled import CompiledTH, compile_th
from mpp_tpu_torch.models.thermal_enthalpy import (
    richards_offdiag_t_values as t_offdiag_t)
from mpp_tpu_torch.ops import hopper_kernels as hk
from mpp_tpu_torch.problems import th as tth

DT = 3600.0
NCOL = 4


@pytest.fixture(autouse=True, scope="module")
def _threads():
    """Small batches: torch's intra-op threads only add contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problems():
    """{name: (JAX mpp, port mpp)}, each with its BCs staged and one step
    taken (the JAX package's serial step, the port's compiled one)."""
    return {"mass_and_heat": (jth.run_mass_and_heat(nx=12)[0],
                              tth.run_mass_and_heat(nx=12, device="cpu")[0]),
            "th_mms": (jth.run_th_mms(nx=20)[0],
                       tth.run_th_mms(nx=20, device="cpu")[0])}


@pytest.fixture(scope="module")
def mh20():
    """nx=20 mass_and_heat in both packages with their direct steppers."""
    mj = jth.run_mass_and_heat(nx=20)[0]
    mt = tth.run_mass_and_heat(nx=20, device="cpu")[0]
    return (mj, jcompile_th(mj, linear_solver="direct"),
            mt, compile_th(mt, linear_solver="direct"))


def _close(got, ref, rtol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _columns(mj, seed):
    """Inputs of NCOL perturbed columns around the JAX problem's state, as
    numpy: X [NCOL, 2n], bc/ss per GE, dyn, accum_prev per GE."""
    rng = np.random.default_rng(seed)
    soe = mj.soe
    n = soe.n
    X = np.tile(np.asarray(soe.soln), (NCOL, 1))
    # per-column pressure offsets put whole columns below, across and
    # above PRESSURE_REF; small per-cell noise keeps the Darcy gradients
    # near the problems' own
    P = X[:, :n]
    P += (101325.0 - P.mean()) + np.array([-2e4, 0.0, 1e4, 2e4])[:, None]
    P += rng.uniform(-200.0, 200.0, (NCOL, n))
    X[:, n:] += rng.uniform(-3.0, 3.0, (NCOL, n))
    bc = [np.tile(np.asarray(g.bc_value), (NCOL, 1)) for g in soe.goveqns]
    ss = [np.tile(np.asarray(g.ss_value), (NCOL, 1)) * (
        1.0 + 0.1 * rng.uniform(-1, 1, (NCOL, np.size(g.ss_value))))
        for g in soe.goveqns]
    bc[1] = bc[1] + rng.uniform(-2.0, 2.0, bc[1].shape)
    ge, gm = soe.ge_energy, soe.ge_mass
    bcp = np.tile(np.asarray(ge.bc_pressure), (NCOL, 1)) \
        + rng.uniform(-5e3, 5e3, (NCOL, np.size(ge.bc_pressure)))
    bct = np.tile(np.asarray(gm.bc_temperature), (NCOL, 1)) \
        + rng.uniform(-2.0, 2.0, (NCOL, np.size(gm.bc_temperature)))
    dyn = ({"bc_temperature": bct}, {"bc_pressure": bcp})
    ap = [rng.uniform(-1.0, 1.0, (NCOL, n)) * 1e2 for _ in range(2)]
    return X, tuple(bc), tuple(ss), dyn, tuple(ap)


def _jax_in(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("name", ["mass_and_heat", "th_mms"])
def test_staged_parameters_identical(problems, name):
    mj, mt = problems[name]
    for gj, gt in zip(mj.soe.goveqns, mt.soe.goveqns):
        assert type(gj).__name__ == type(gt).__name__
        assert gj.density_type == gt.density_type
        arrays = ["perm", "bc_perm", "bc_value", "bc_temperature",
                  "frac_liq_sat"]
        # th_mms's sources are computed (the saturation function's pow in
        # each package's libm, then a pert=1e-6 central difference that
        # amplifies its ulp differences): held to rtol 1e-10, not bitwise
        np.testing.assert_allclose(gt.ss_value, np.asarray(gj.ss_value),
                                   rtol=1e-10, atol=0)
        if type(gt).__name__ == "ThermalEnthalpyGE":
            assert gj.int_energy_type == gt.int_energy_type
            arrays += ["therm_cond_wet", "therm_cond_dry", "therm_alpha",
                       "heat_cap_soil", "den_soil", "bc_therm_cond_wet",
                       "bc_therm_cond_dry", "bc_therm_alpha", "bc_pressure"]
        for a in arrays:
            np.testing.assert_array_equal(np.asarray(getattr(gt, a)),
                                          np.asarray(getattr(gj, a)), a)
        for sp in ("sat_params", "bc_sat_params", "por_params",
                   "bc_por_params"):
            fj, ft = _fields(getattr(gj, sp)), _fields(getattr(gt, sp))
            assert sorted(fj) == sorted(ft)
            for k in ft:
                np.testing.assert_array_equal(np.asarray(ft[k]),
                                              np.asarray(fj[k]), f"{sp}.{k}")
    tj, tt = mj.soe.template, mt.soe.template
    np.testing.assert_array_equal(tt.indptr, tj.indptr)
    np.testing.assert_array_equal(tt.indices, tj.indices)
    np.testing.assert_array_equal(tt.slots, np.asarray(tj.slots))


@pytest.mark.parametrize("name", ["mass_and_heat", "th_mms"])
def test_ge_assembly_matches_jax(problems, name):
    """accum_e, residual_e, jacobian_e_values, offdiag_p_values,
    richards_offdiag_t_values, and CompiledTH's residual and assembled
    Jacobian on 4 perturbed columns."""
    mj, mt = problems[name]
    X, bc, ss, dyn, ap = _columns(mj, seed=len(name))
    n = mj.soe.n
    Xt, bct, sst, dynt = CompiledTH.inputs_from_numpy(
        X, bc, ss, dyn, "cpu", torch.float64)
    apt = tuple(torch.as_tensor(a) for a in ap)
    Pj, Tj = jnp.asarray(X[:, :n]), jnp.asarray(X[:, n:])
    Pt, Tt = Xt[:, :n], Xt[:, n:]
    gej, get_ = mj.soe.ge_energy, mt.soe.ge_energy
    bcv, bcp = bc[1], dyn[1]["bc_pressure"]

    _close(get_.accum_e(Tt, Pt), jax.vmap(gej.accum_e)(Tj, Pj))
    ref = jax.vmap(lambda T, P, b, s, a, p: gej.residual_e(
        T, P, DT, bc_value=b, ss_value=s, accum_prev=a, bc_pressure=p))(
            Tj, Pj, *_jax_in(bcv, ss[1], ap[1], bcp))
    _close(get_.residual_e(Tt, Pt, DT, bc_value=bct[1], ss_value=sst[1],
                           accum_prev=apt[1], bc_pressure=dynt[1][
                               "bc_pressure"]), ref)
    for fn in ("jacobian_e_values", "offdiag_p_values"):
        ref = jax.vmap(lambda T, P, b, p: getattr(gej, fn)(
            T, P, DT, bc_value=b, bc_pressure=p))(Tj, Pj, *_jax_in(bcv, bcp))
        got = getattr(get_, fn)(Tt, Pt, DT, bc_value=bct[1],
                                bc_pressure=dynt[1]["bc_pressure"])
        _close(got, ref)
    _close(t_offdiag_t(mt.soe.ge_mass, Pt, Tt, DT),
           jax.vmap(lambda P, T: j_offdiag_t(mj.soe.ge_mass, P, T, DT))(
               Pj, Tj))

    cj = jcompile_th(mj, linear_solver="direct")
    ct = compile_th(mt, linear_solver="direct")
    dynj = tuple({k: jnp.asarray(v) for k, v in d.items()} for d in dyn)
    ref = jax.vmap(lambda x, b0, b1, s0, s1, d0, d1: cj._jac_one(
        x, (b0, b1), (s0, s1), DT, (d0, d1)))(
            jnp.asarray(X), *_jax_in(*bc, *ss), *dynj)
    _close(ct._jac(Xt, bct, sst, DT, dynt), ref)
    src = np.zeros_like(X)
    ref = jax.vmap(lambda x, b0, b1, s0, s1, a0, a1, d0, d1, sr:
                   cj._residual_one(x, (b0, b1), (s0, s1), (a0, a1), DT, sr,
                                    (d0, d1)))(
        jnp.asarray(X), *_jax_in(*bc, *ss, *ap), *dynj, jnp.asarray(src))
    _close(ct._residual(Xt, bct, sst, apt, DT, torch.as_tensor(src), dynt),
           ref)
    ref = jax.vmap(lambda x, d0, d1: cj._accum_prev_one(x, DT, (d0, d1)))(
        jnp.asarray(X), *dynj)
    for g, r in zip(ct._accum_prev(Xt, DT, dynt), ref):
        _close(g, r)


def test_solve_equals_dense_solve(problems):
    """The interleaved 2x2 block plan through block_thomas2 equals a dense
    solve of the assembled Jacobian at the staged state (as
    tests/test_block_thomas.py:85).  (A saturated column without mass BCs
    is a near-singular Neumann problem, ill-posed for any solver.)"""
    mj, mt = problems["mass_and_heat"]
    ct = compile_th(mt, linear_solver="direct")
    cj = jcompile_th(mj, linear_solver="direct")
    Xt, bct, sst, dynt = CompiledTH.inputs_from_numpy(
        *_linspace_top(mj, cj, NCOL), "cpu", torch.float64)
    data = ct._jac(Xt, bct, sst, DT, dynt).numpy()
    t = ct.template
    dense = np.zeros((NCOL, ct.n, ct.n))
    dense[:, t.row_ids(), t.indices] = data
    F = np.random.default_rng(0).standard_normal((NCOL, ct.n))
    Y = ct._solve(torch.as_tensor(data), torch.as_tensor(F)).numpy()
    Yd = np.linalg.solve(dense, F[..., None])[..., 0]
    np.testing.assert_allclose(Y, Yd, rtol=1e-9, atol=1e-12)
    # the ELL matvec is the dense product
    np.testing.assert_allclose(
        ct._matvec(torch.as_tensor(data), torch.as_tensor(Yd)).numpy(),
        F, rtol=1e-9, atol=1e-9)


def _linspace_top(mj, cj, ncol):
    """th_batched's inputs (bench.py:808-818) from the JAX stepper, as
    numpy: the staged state, the per-column top temperature, the staged
    cross-data."""
    X0 = np.tile(np.asarray(mj.soe.soln), (ncol, 1))
    bc, ss = (tuple(np.array(a) for a in t) for t in cj.gather_inputs(ncol))
    bc[1][:, 0] = np.linspace(296.15, 310.15, ncol)
    dyn = tuple({k: np.array(v) for k, v in d.items()}
                for d in cj._serial_dyn(ncol))
    return X0, bc, ss, dyn


def test_three_steps_match_jax_direct_stepper(mh20):
    mj, cj, mt, ct = mh20
    X0, bc, ss, dyn = _linspace_top(mj, cj, NCOL)
    # the two packages' one-column steps of the builders landed together
    np.testing.assert_allclose(mt.soe.soln, np.asarray(mj.soe.soln),
                               rtol=1e-7)
    Xj, bcj, ssj = jnp.asarray(X0), _jax_in(*bc), _jax_in(*ss)
    dynj = tuple({k: jnp.asarray(v) for k, v in d.items()} for d in dyn)
    Xt, bct, sst, dynt = CompiledTH.inputs_from_numpy(X0, bc, ss, dyn,
                                                      "cpu", torch.float64)
    for step in range(3):
        Xj, it_j, ok_j, r_j = cj.step_batched(Xj, bcj, ssj, DT, dyn=dynj)
        Xt, it_t, ok_t, r_t = ct.step_batched(Xt, bct, sst, DT, dyn=dynt)
        assert int(it_j) == it_t, step
        np.testing.assert_array_equal(np.asarray(r_j), r_t.numpy())
        np.testing.assert_array_equal(np.asarray(ok_j), ok_t.numpy())
        np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-9)
    assert bool(ok_t.all())
    # heterogeneity is live
    n = ct.nh
    assert float((Xt[0, n:] - Xt[-1, n:]).abs().max()) > 1e-3
    assert hk.LAUNCHES["block_thomas2"] == 0      # CPU tensors: plain


def test_batched_columns_equal_single_column_solves(mh20):
    mj, cj, mt, ct = mh20
    X0, bc, ss, dyn = _linspace_top(mj, cj, NCOL)
    X, bc, ss, dyn = CompiledTH.inputs_from_numpy(X0, bc, ss, dyn, "cpu",
                                                  torch.float64)
    Xb, _, ok, _ = ct.step_batched(X, bc, ss, DT, dyn=dyn)
    assert bool(ok.all())
    for c in (0, NCOL - 1):
        one = lambda t: t[c:c + 1]
        Xc, _, okc, _ = ct.step_batched(
            one(X), tuple(map(one, bc)), tuple(map(one, ss)), DT,
            dyn=tuple({k: one(v) for k, v in d.items()} for d in dyn))
        assert bool(okc[0])
        np.testing.assert_allclose(Xc[0].numpy(), Xb[c].numpy(), rtol=1e-12)


def test_column_storage_conserved(mh20):
    """No BC or source on the mass GE: a converged f64 step keeps each
    column's water within the Newton tolerance."""
    mj, cj, mt, ct = mh20
    X0, bc, ss, dyn = CompiledTH.inputs_from_numpy(
        *_linspace_top(mj, cj, NCOL), "cpu", torch.float64)
    X1, _, ok, _ = ct.step_batched(X0, bc, ss, DT, dyn=dyn)
    assert bool(ok.all())
    dm = (ct.column_storage(X1, dyn) - ct.column_storage(X0, dyn)).abs()
    assert float(dm.max()) * 18.01534 < 1e-6


def test_th_mms_step_matches_jax_direct_stepper(problems):
    """One compiled th_mms step from the uniform initial state: the JAX
    direct stepper and the port's (whose run_th_mms took exactly it)."""
    mj, mt = problems["th_mms"]
    n = mj.soe.n
    mms = jth._MMS(0.0, 10.0)
    xc = 0.25 + np.arange(n) * 0.5
    X0 = np.concatenate([np.full(n, np.mean(mms.pressure(xc))),
                         np.full(n, np.mean(mms.temperature(xc)))])[None]
    cj = jcompile_th(mj, linear_solver="direct")
    ct = compile_th(mt, linear_solver="direct")
    bc, ss = cj.gather_inputs(1)
    dyn = cj._serial_dyn(1)
    Xj, it_j, ok_j, r_j = cj.step_batched(jnp.asarray(X0), bc, ss, 1.0,
                                          dyn=dyn)
    Xt, it_t, ok_t, r_t = ct.step_batched(
        *CompiledTH.inputs_from_numpy(X0, bc, ss, (), "cpu",
                                      torch.float64)[:3], 1.0,
        dyn=ct._serial_dyn(1, "cpu"))
    assert bool(ok_j[0]) and bool(ok_t[0])
    assert int(it_j) == it_t and int(r_j[0]) == int(r_t[0])
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-9)
    np.testing.assert_allclose(mt.soe.soln, np.asarray(Xj[0]), rtol=1e-9)


def test_f32_step_converges(mh20):
    """f32 with the production tolerances of bench.py:807 converges, in
    a few Newton iterations, near the f64 state."""
    mj, cj, mt, ct = mh20
    inputs = _linspace_top(mj, cj, NCOL)
    X32, bc, ss, dyn = CompiledTH.inputs_from_numpy(*inputs, "cpu",
                                                    torch.float32)
    X64 = CompiledTH.inputs_from_numpy(*inputs, "cpu", torch.float64)
    for _ in range(2):
        X32, it, ok, reason = ct.step_batched(X32, bc, ss, DT, dyn=dyn,
                                              rtol=2e-3, stol=1e-5)
        assert bool(ok.all()), reason
        assert it <= 10
        X64 = (ct.step_batched(*X64[:3], DT, dyn=X64[3])[0],) + X64[1:]
    assert X32.dtype == torch.float32 and bool(torch.isfinite(X32).all())
    dX = (X32.double() - X64[0]).abs()
    n = ct.nh
    assert float(dX[:, :n].max()) < 20.0 and float(dX[:, n:].max()) < 0.05


def test_unported_paths_raise():
    mt, _ = tth.run_mass_and_heat(nx=6, nstep=0, device="cpu")
    with pytest.raises(NotImplementedError):
        compile_th(mt)                      # the default "petsc" plan
    with pytest.raises(ValueError):
        compile_th(mt, linear_solver="other")
    with pytest.raises(NotImplementedError):
        tth.run_mass_and_heat(nx=6, compiled=False,
                              device="cpu")
    with pytest.raises(NotImplementedError):
        tth.run_th_mms(nx=6, compiled=False, device="cpu")
    from mpp_tpu_torch.models.thermal_enthalpy import THSoE
    with pytest.raises(NotImplementedError):
        THSoE.step_dt(mt.soe, DT)           # the serial SNES (Slice D)


def test_unstepped_problem_is_staged():
    """A problem returned with nstep=0 has its energy BCs staged and
    steps through the installed compiled stepper."""
    mt, _ = tth.run_mass_and_heat(nx=6, nstep=0, device="cpu")
    ge = mt.soe.ge_energy
    np.testing.assert_array_equal(ge.bc_value, [303.15, 293.15])
    np.testing.assert_array_equal(ge.bc_pressure, [91325.0, 91325.0])
    converged, reason = mt.soe.step_dt(DT, 1)
    assert converged and reason > 0
    assert mt.soe.cumulative_newton_iterations > 0
    np.testing.assert_array_equal(ge.temperature, mt.soe.soln[6:])

"""Thermal KSP slice of the PyTorch port (mpp_tpu_torch/models/thermal.py,
ops/block_structure.py, batched/ksp_compiled.py, problems/thermal_mms.py,
problems/thermal_3media.py, driver/thermal_alm.py) against the JAX
package on the CPU in f64.

Tolerances: the constitutive functions within rtol 1e-14 (the same
elementwise formulas); every solve of the port's compiled "direct" KSP
within rtol 1e-12 of the JAX package's compiled "direct" KSP on the same
inputs (a Thomas sweep, a block-Thomas sweep or a dense LU of the same
assembled system); one column of a batch bitwise equal to its solve
alone.  The physics tests of tests/test_thermal_3media.py and
tests/test_thermal_alm.py run on the port unchanged but for
``device="cpu"``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpp_tpu import constants as JC
from mpp_tpu.models import thermal as jth
from mpp_tpu.ops import block_structure as jbs
from mpp_tpu_torch import constants as C
from mpp_tpu_torch.batched.ksp_compiled import compile_ksp
from mpp_tpu_torch.constants import AuxVarKind, Var
from mpp_tpu_torch.driver.thermal_alm import thermal_alm_solve
from mpp_tpu_torch.models import thermal as tth
from mpp_tpu_torch.ops import block_structure as tbs
from mpp_tpu_torch.ops import hopper_kernels as hk
from mpp_tpu_torch.problems import thermal_mms as ttm
from mpp_tpu_torch.problems.thermal_3media import (NLEVGRND, NLEVSNO,
                                                   ThreeMediaProblem)

RTOL = 1e-12
TFRZ = C.TFRZ


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small systems: torch's intra-op threads only add contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


# ---- the constitutive functions -----------------------------------------
def _soil_aux_inputs(n=64, seed=0):
    rng = np.random.default_rng(seed)
    lun = rng.choice([JC.IST_SOIL, JC.IST_CROP, JC.IST_WET, JC.IST_ICE,
                      JC.IST_ICE_MEC, 7], n)
    return dict(
        T=TFRZ + 10.0 * (rng.random(n) - 0.5),
        liq=np.where(rng.random(n) < 0.2, 0.0, 30.0 * rng.random(n)),
        ice=np.where(rng.random(n) < 0.5, 0.0, 20.0 * rng.random(n)),
        snow_water=5.0 * rng.random(n),
        num_snow_layer=rng.integers(0, 3, n),
        tuning=np.ones(n), lun_type=lun, is_shallow=rng.random(n) < 0.8,
        por=0.3 + 0.2 * rng.random(n), tkmg=1.0 + 2.0 * rng.random(n),
        tkdry=0.1 + 0.2 * rng.random(n), csol=2e6 * (0.5 + rng.random(n)),
        dz=0.02 + 0.2 * rng.random(n))


@pytest.mark.parametrize("fn", ["soil", "snow", "ssw", "harmonic"])
def test_aux_functions_match_jax(fn):
    rng = np.random.default_rng(4)
    if fn == "soil":
        kw = _soil_aux_inputs()
        static = ("lun_type", "is_shallow")
        kj = {k: (v if k in static or k == "num_snow_layer"
                  else jnp.asarray(v)) for k, v in kw.items()}
        kt = {k: (v if k in static else torch.as_tensor(v))
              for k, v in kw.items()}
        jout = jth.thermal_soil_aux(**kj)
        tout = tth.thermal_soil_aux(**kt)
    elif fn == "snow":
        n = 50
        args = (10.0 * rng.random(n), 40.0 * rng.random(n),
                np.where(rng.random(n) < 0.3, 0.0, rng.random(n)),
                0.01 + 0.1 * rng.random(n))
        jout = jth.thermal_snow_aux(*map(jnp.asarray, args))
        tout = tth.thermal_snow_aux(*map(_t, args))
    elif fn == "ssw":
        n = 50
        args = (np.where(rng.random(n) < 0.3, 0.0, rng.random(n)),
                np.where(rng.random(n) < 0.3, 1e-10, 1e-3 * rng.random(n)))
        jout = jth.thermal_ssw_aux(*map(jnp.asarray, args))
        tout = tth.thermal_ssw_aux(*map(_t, args))
    else:
        args = [0.1 + rng.random(40) for _ in range(4)]
        jout = (jth._harmonic(*map(jnp.asarray, args)),)
        tout = (tth._harmonic(*map(_t, args)),)
    for a, b in zip(jout, tout):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-14,
                                   atol=0)


def test_block_structure_matches_jax():
    """chain_shape and the (L, D, U) scatter of BlockTridiagTemplate, and
    its solve, on a 3-chain, 2-dof pattern."""
    ncol, nlev, dof = 3, 5, 2
    rows, cols = [], []
    for c in range(ncol):
        for k in range(nlev):
            for dk in (-1, 0, 1):
                if 0 <= k + dk < nlev:
                    for i in range(dof):
                        for j in range(dof):
                            rows.append((c * nlev + k) * dof + i)
                            cols.append((c * nlev + k + dk) * dof + j)
    rows, cols = np.array(rows), np.array(cols)
    assert tbs.chain_shape(ncol * nlev, rows // dof * dof, cols // dof * dof,
                           dof) == jbs.chain_shape(ncol * nlev, rows // dof
                                                   * dof, cols // dof * dof,
                                                   dof)
    n1 = ncol * nlev
    r1 = np.repeat(np.arange(n1), 1)
    assert tbs.chain_shape(n1, np.r_[r1, r1[:-1]], np.r_[r1, r1[1:]]) == \
        (1, n1)
    rng = np.random.default_rng(2)
    vals = rng.standard_normal(rows.size)
    vals[rows == cols] += 10.0
    b = rng.standard_normal(ncol * nlev * dof)
    jt = jbs.BlockTridiagTemplate(ncol, nlev, dof, rows, cols)
    tt = tbs.BlockTridiagTemplate(ncol, nlev, dof, rows, cols)
    for a, c in zip(jt.assemble(jnp.asarray(vals)), tt.assemble(_t(vals))):
        np.testing.assert_array_equal(c.numpy(), np.asarray(a))
    np.testing.assert_allclose(tt.solve(_t(vals), _t(b)).numpy(),
                               np.asarray(jt.solve(jnp.asarray(vals),
                                                   jnp.asarray(b))),
                               rtol=RTOL)
    with pytest.raises(ValueError):
        tbs.chain_shape(4, np.array([0]), np.array([2]))


# ---- the 1-D MMS problem through the compiled KSP -----------------------
@pytest.fixture(scope="module")
def mms1d():
    """The 1-D MMS problem in both packages (20 cells, one step each)."""
    from mpp_tpu.problems import thermal_mms as jtm
    mpp_j, soln_j = jtm.run_thermal_mms_problem(1, use_compiled=True)
    mpp_t, soln_t = ttm.run_thermal_mms_problem(1, device="cpu")
    return mpp_j, soln_j, mpp_t, soln_t


def test_mms_1d_solution_matches_jax(mms1d):
    """run_thermal_mms_problem(1): the port's compiled step ("petsc",
    Thomas on a tridiagonal operator) against JAX's compiled step."""
    _, soln_j, mpp_t, soln_t = mms1d
    np.testing.assert_allclose(soln_t, np.asarray(soln_j), rtol=RTOL)
    # the manufactured solution 10 sin(pi x) + 270 at the cell centres
    x = (np.arange(20) + 0.5) / 20
    assert np.abs(soln_t - (10 * np.sin(np.pi * x) + 270.0)).max() < 0.05
    assert mpp_t.soe.cumulative_linear_iterations == 1


@pytest.mark.parametrize("linear_solver", ["direct", "petsc"])
def test_mms_1d_compiled_step_matches_jax(mms1d, linear_solver):
    """compile_ksp on the 1-D MMS problem: a batched step of 4 columns
    from perturbed states, both keywords (Thomas either way)."""
    from mpp_tpu.batched.ksp_compiled import compile_ksp as jcompile
    mpp_j, _, mpp_t, _ = mms1d
    cj = jcompile(mpp_j, linear_solver=linear_solver)
    ct = compile_ksp(mpp_t, linear_solver=linear_solver)
    assert ct.is_tridiag and cj.is_tridiag
    rng = np.random.default_rng(3)
    ncol, n = 4, ct.n
    T0 = 280.0 + 10.0 * rng.random((ncol, n))
    bcj, ssj = cj.gather_inputs(ncol)
    bct, sst = ct.gather_inputs(ncol, "cpu")
    np.testing.assert_array_equal(bct[0].numpy(), np.asarray(bcj[0]))
    Tj, okj, _ = cj.step_batched(jnp.asarray(T0), bcj, ssj, 1800.0)
    Tt, okt, _ = ct.step_batched(_t(T0), bct, sst, 1800.0)
    assert bool(okt.all()) and bool(np.asarray(okj).all())
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=RTOL)
    assert hk.LAUNCHES["thomas"] == 0       # CPU tensors: plain versions


def test_batched_heterogeneous_thermal_columns(mms1d):
    """tests/test_ksp_compiled.py:74 on the port: 5 columns with their
    own moisture and Dirichlet BCs in one step; each column bitwise equal
    to its step alone, and within 1e-12 of JAX's batched step."""
    from mpp_tpu.batched.ksp_compiled import compile_ksp as jcompile
    mpp_j, _, mpp_t, _ = mms1d
    cj = jcompile(mpp_j, linear_solver="petsc")
    ct = compile_ksp(mpp_t, linear_solver="petsc")
    g = ct.goveqns[0]
    n, ncol = ct.n, 5
    rng = np.random.default_rng(1)
    T0 = 280.0 + 10.0 * rng.random((ncol, n))
    bc = np.broadcast_to(np.asarray(g.bc_value), (ncol,) + g.bc_value.shape) \
        + rng.random((ncol, g.bc_value.shape[0]))
    ss = np.broadcast_to(np.asarray(g.ss_values),
                         (ncol,) + g.ss_values.shape).copy()
    liq = 5.0 * rng.random((ncol, n))
    Tn, ok, _ = ct.step_batched(_t(T0), (_t(bc),), (_t(ss),), 1.0,
                                dyn=({"liq": _t(liq)},))
    assert bool(ok.all())
    for c in range(ncol):
        Tc, okc, _ = ct.step_batched(_t(T0[c:c + 1]), (_t(bc[c:c + 1]),),
                                     (_t(ss[c:c + 1]),), 1.0,
                                     dyn=({"liq": _t(liq[c:c + 1])},))
        assert torch.equal(Tc[0], Tn[c]), c
    assert float((Tn[0] - Tn[1]).abs().max()) > 1e-3
    Tj, okj, _ = cj.step_batched(jnp.asarray(T0), (jnp.asarray(bc),),
                                 (jnp.asarray(ss),), 1.0,
                                 dyn=({"liq": jnp.asarray(liq)},))
    np.testing.assert_allclose(Tn.numpy(), np.asarray(Tj), rtol=RTOL)


def test_staged_arrays_copied_once_and_again_after_rewrite():
    """The GE keeps its device copies of the staged arrays between steps,
    and a step after an in-place rewrite of the mesh geometry equals the
    step of a problem built with that geometry (bitwise)."""
    def step(comp, T0):
        bc, ss = comp.gather_inputs(3, "cpu")
        return comp.step_batched(_t(T0), bc, ss, 1800.0)[0]

    def rewrite(mpp):
        mesh = mpp.soe.goveqns[0].mesh
        mesh.dz[:] *= 1.25
        mesh.vol[:] *= 1.25
        cs = mesh.intrn_conn_sets[0]
        cs.dist_up[:] *= 1.25
        cs.dist_dn[:] *= 1.25

    mpp, _ = ttm.run_thermal_mms_problem(1, device="cpu")
    comp = compile_ksp(mpp)
    g = comp.goveqns[0]
    T0 = 280.0 + 10.0 * np.random.default_rng(2).random((3, comp.n))
    step(comp, T0)
    copies = {k: v[1] for k, v in g._tc.items()}
    assert copies
    step(comp, T0)
    assert all(g._tc[k][1] is v for k, v in copies.items())
    rewrite(mpp)
    got = step(comp, T0)
    assert g._tc[("dz", "cpu", torch.float64)][1] is not \
        copies[("dz", "cpu", torch.float64)]
    fresh, _ = ttm.run_thermal_mms_problem(1, device="cpu")
    rewrite(fresh)
    fresh.soe.goveqns[0]._tc.clear()        # every array copied anew
    assert torch.equal(got, step(compile_ksp(fresh), T0))


def test_block_solver_of_the_soe_matches_jax():
    """ThermalSOE.step_dt(solver="block") (BlockTridiagTemplate over the
    column chain) against JAX's on the 1-D MMS problem."""
    from mpp_tpu.problems import thermal_mms as jtm
    mpp_j, _ = jtm.run_thermal_mms_problem(1, nstep=0)
    mpp_t, _ = ttm.run_thermal_mms_problem(1, nstep=0, device="cpu")
    for mpp in (mpp_j, mpp_t):
        g = mpp.soe.goveqns[0]
        g.ss_values = np.asarray(g.ss_values) * 0.0 + 3.0
        mpp.soe.cnfac = 0.5
    for _ in range(2):
        assert mpp_j.soe.step_dt(900.0, solver="block")
        assert type(mpp_t.soe).step_dt(mpp_t.soe, 900.0, solver="block",
                                       device="cpu")
        np.testing.assert_allclose(mpp_t.soe.soln,
                                   np.asarray(mpp_j.soe.soln), rtol=RTOL)
    with pytest.raises(NotImplementedError):
        type(mpp_t.soe).step_dt(mpp_t.soe, 900.0, solver="ksp",
                                device="cpu")


def test_petsc_plan_accepted_only_where_it_is_thomas():
    """"petsc" runs Thomas on the tridiagonal 1-D problem; the 2-D MMS
    mesh needs GMRES(30)+ILU(0) and raises (Slice D); any other keyword
    raises ValueError."""
    mpp, _ = ttm.run_thermal_mms_problem(1, nstep=0, device="cpu")
    assert compile_ksp(mpp, linear_solver="petsc").is_tridiag
    with pytest.raises(ValueError):
        compile_ksp(mpp, linear_solver="gmres")
    with pytest.raises(NotImplementedError, match="Slice D"):
        ttm.run_thermal_mms_problem(2, nx=4, ny=4, device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ttm.run_thermal_mms_problem(1)
    with pytest.raises(RuntimeError, match="cuda"):
        ThreeMediaProblem()


# ---- the 3-media problem --------------------------------------------------
@pytest.mark.parametrize("ncol", [1, 3])
def test_three_media_matches_jax_compiled_direct(ncol):
    """Snow ⊕ ssw ⊕ soil with inter-GE Dirichlet coupling, 3 steps of the
    compiled "direct" KSP in both packages: the block-Thomas plan at one
    column, the dense plan at three."""
    from mpp_tpu.batched.ksp_compiled import compile_ksp as jcompile
    from mpp_tpu.problems.thermal_3media import ThreeMediaProblem as JP
    pj, pt = JP(ncol=ncol), ThreeMediaProblem(ncol=ncol, device="cpu")
    for p in (pj, pt):
        p.set_initial_temperature(260.0, 272.0, 278.0)
        p.set_top_fluxes(-30.0, 0.0, 5.0)
    cj = jcompile(pj.mpp, linear_solver="direct").install()
    ct = pt.install()
    assert (ct.block_size is not None) == (ncol == 1) == \
        (cj.block_size is not None)
    for _ in range(3):
        outj, outt = pj.step(1800.0), pt.step(1800.0)
        for a, b in zip(outj, outt):
            np.testing.assert_allclose(b, a, rtol=RTOL)


def test_three_media_equilibrium_is_invariant():
    p = ThreeMediaProblem(device="cpu")
    T0 = TFRZ - 2.0
    p.set_initial_temperature(T0, T0, T0)
    p.set_top_fluxes(0.0, 0.0, 0.0)
    for arr in p.step(1800.0):
        np.testing.assert_allclose(arr, T0, rtol=0, atol=1e-8)


def test_three_media_energy_conservation_under_flux():
    p = ThreeMediaProblem(device="cpu")
    p.set_initial_temperature(TFRZ - 5.0, TFRZ - 1.0, TFRZ + 2.0)
    fluxes = (-30.0, 0.0, 0.0)
    p.set_top_fluxes(*fluxes)
    dt = 600.0
    e0 = p.energy(p.mpp.soe.soln_prev)
    p.step(dt)
    e1 = p.energy()
    expected = dt * sum(fluxes)
    assert abs((e1 - e0) - expected) < 1e-4 * abs(expected)


def test_three_media_cooling_propagates_through_media():
    p = ThreeMediaProblem(device="cpu")
    p.set_initial_temperature(TFRZ - 1.0, TFRZ - 1.0, TFRZ - 1.0)
    p.set_top_fluxes(-50.0, 0.0, 0.0)
    for _ in range(20):
        Ts, Tw, Tg = p.step(600.0)
    assert Ts[0] < Ts[-1] < Tg[-1]
    assert np.all(np.diff(Ts) > 0)
    assert abs(Tg[-1] - (TFRZ - 1.0)) < 0.5


def test_three_media_flux_continuity_steady_state():
    p = ThreeMediaProblem(device="cpu")
    p.set_initial_temperature(TFRZ - 2.0, TFRZ - 2.0, TFRZ - 2.0)
    Q = -10.0
    p.set_top_fluxes(Q, 0.0, 0.0)
    for _ in range(400):
        Ts, Tw, Tg = p.step(3600.0)
    ge = p.ge_snow
    k_snow, _ = ge.aux(None)
    k = float(k_snow[0])
    dz = float(ge.mesh.dz[0])
    flux_num = -k * np.diff(Ts) / dz
    np.testing.assert_allclose(flux_num, Q, rtol=0.05)


def test_three_media_partial_snow_activation():
    p = ThreeMediaProblem(device="cpu")
    nsl = 2
    active = np.zeros(NLEVSNO, bool)
    active[NLEVSNO - nsl:] = True
    p.mpp.set_r_data(AuxVarKind.INTERNAL, Var.NUM_SNOW_LYR, p.i_snow,
                     np.full(NLEVSNO, nsl))
    p.mpp.set_r_data(AuxVarKind.INTERNAL, Var.ACTIVE, p.i_snow,
                     active.astype(np.int64))
    p.ge_snow.update_top_flux_conn()
    assert int(p.ge_snow.boundary_conditions[0].conn_set.id_dn[0]) \
        == NLEVSNO - nsl
    T0 = TFRZ - 3.0
    p.set_initial_temperature(T0, T0, T0)
    p.set_top_fluxes(-40.0, 0.0, 0.0)
    Ts, Tw, Tg = p.step(600.0)
    np.testing.assert_allclose(Ts[:NLEVSNO - nsl], 0.0, atol=1e-12)
    assert Ts[NLEVSNO - nsl] < T0 - 0.01


# ---- the CLM-facing driver -------------------------------------------------
NCOL = 3


def _clm_state(ncol=NCOL, snl=-3, T0=270.0, frac_sno=0.9, frac_h2osfc=0.05):
    nlev = NLEVSNO + NLEVGRND
    return dict(
        t_soisno=np.full((ncol, nlev), T0),
        t_h2osfc=np.full(ncol, T0),
        snl=np.full(ncol, snl),
        dz_snow=np.full((ncol, NLEVSNO), 0.04),
        dz_soil=np.tile(0.025 * 1.35 ** np.arange(NLEVGRND), (ncol, 1)),
        h2osoi_liq=np.concatenate(
            [np.full((ncol, NLEVSNO), 1.0),
             np.full((ncol, NLEVGRND), 8.0)], axis=1),
        h2osoi_ice=np.concatenate(
            [np.full((ncol, NLEVSNO), 6.0),
             np.zeros((ncol, NLEVGRND))], axis=1),
        h2osno=np.full(ncol, 21.0),
        h2osfc=np.full(ncol, 10.0),
        frac_sno_eff=np.full(ncol, frac_sno),
        frac_h2osfc=np.full(ncol, frac_h2osfc),
        sabg_lyr=np.zeros((ncol, NLEVSNO + 1)),
        dhsdT=np.zeros(ncol),
        hs_soil=np.zeros(ncol),
        hs_top_snow=np.zeros(ncol),
        hs_h2osfc=np.zeros(ncol))


def _alm(**kw):
    return thermal_alm_solve(ThreeMediaProblem(ncol=NCOL, device="cpu"),
                             1800.0, **kw)


def test_thermal_alm_matches_jax_compiled_direct():
    """One CLM coupling step with every staging path live (snl=-3, film,
    fluxes, dhsdT, absorbed solar), the JAX driver's solve routed through
    its compiled "direct" KSP."""
    from mpp_tpu.batched.ksp_compiled import compile_ksp as jcompile
    from mpp_tpu.driver import thermal_alm as jta
    from mpp_tpu.problems.thermal_3media import ThreeMediaProblem as JP
    st = _clm_state()
    st["hs_top_snow"] = np.full(NCOL, 60.0)
    st["hs_h2osfc"] = np.full(NCOL, 20.0)
    st["hs_soil"] = np.full(NCOL, 40.0)
    st["dhsdT"] = np.full(NCOL, -10.0)
    st["sabg_lyr"][:, NLEVSNO - 2] = 30.0
    st["sabg_lyr"][:, NLEVSNO] = 15.0
    pj = JP(ncol=NCOL)
    real = pj.mpp.soe.rebuild_template

    def rebuild():
        real()
        jcompile(pj.mpp, linear_solver="direct").install()
    pj.mpp.soe.rebuild_template = rebuild
    tvj = jta.thermal_alm_solve(pj, 1800.0, **st)
    tvt = _alm(**st)
    np.testing.assert_array_equal(np.isnan(tvt), np.isnan(tvj))
    ok = ~np.isnan(tvj)
    np.testing.assert_allclose(tvt[ok], tvj[ok], rtol=RTOL)


def test_thermal_alm_equilibrium_is_invariant():
    tv = _alm(**_clm_state(T0=269.0))
    active = ~np.isnan(tv)
    assert np.allclose(tv[active], 269.0, atol=1e-8)


def test_thermal_alm_snl_masks_inactive_layers():
    tv = _alm(**_clm_state(snl=-2))
    assert np.all(np.isnan(tv[:, :NLEVSNO - 2]))
    assert np.all(np.isfinite(tv[:, NLEVSNO - 2:NLEVSNO]))
    assert np.all(np.isfinite(tv[:, NLEVSNO + 1:]))


def test_thermal_alm_surface_flux_warms_from_top():
    st = _clm_state(T0=270.0)
    st["hs_top_snow"] = np.full(NCOL, 80.0)
    st["hs_h2osfc"] = np.full(NCOL, 80.0)
    st["hs_soil"] = np.full(NCOL, 80.0)
    tv = _alm(**st)
    top_snow = tv[:, NLEVSNO - 3]
    bot_snow = tv[:, NLEVSNO - 1]
    assert np.all(top_snow > 270.0)
    assert np.all(top_snow > bot_snow)
    assert np.all(tv[:, NLEVSNO + 1] > tv[:, -1])
    assert np.allclose(tv[:, -1], 270.0, atol=0.5)


def test_thermal_alm_dhsdT_damps_warming():
    st = _clm_state()
    st["hs_top_snow"] = np.full(NCOL, 80.0)
    tv1 = _alm(**st)
    st["dhsdT"] = np.full(NCOL, -20.0)
    tv2 = _alm(**st)
    i_top = NLEVSNO - 3
    assert np.all(tv2[:, i_top] < tv1[:, i_top])
    assert np.all(tv2[:, i_top] > 270.0)


def test_thermal_alm_sabg_layer_source():
    st = _clm_state()
    st["sabg_lyr"][:, NLEVSNO - 2] = 30.0
    tv = _alm(**st)
    assert np.all(tv[:, NLEVSNO - 2] > 270.0)


def test_thermal_alm_dhsdT_alone_is_neutral():
    st = _clm_state(T0=271.0)
    st["dhsdT"] = np.full(NCOL, -25.0)
    tv = _alm(**st)
    active = ~np.isnan(tv)
    assert np.allclose(tv[active], 271.0, atol=1e-8)


# ---- on the card -----------------------------------------------------------
@pytest.mark.cuda
def test_compiled_thomas_plan_card_matches_cpu():
    """On the card: compile_ksp's Thomas plan (the thermal_batched cell's
    set-up at 64 columns, f64) launches the Thomas kernel and equals the
    CPU's step within rtol 1e-9."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    mpp, _ = ttm.run_thermal_mms_problem(1, nx=64, device="cpu")
    comp = compile_ksp(mpp, linear_solver="direct")
    rng = np.random.default_rng(0)
    ncol = 64
    T0 = 280.0 + 10.0 * rng.random((ncol, comp.n))
    liq = 5.0 * rng.random((ncol, comp.n))
    out = {}
    for dev in ("cpu", "cuda"):
        bc, ss = comp.gather_inputs(ncol, dev)
        hk.reset_launches()
        T, ok, _ = comp.step_batched(
            torch.as_tensor(T0, device=dev), bc, ss, 1800.0,
            dyn=({"liq": torch.as_tensor(liq, device=dev)},))
        assert bool(ok.all())
        out[dev] = (T.cpu(), hk.LAUNCHES["thomas"])
    assert out["cpu"][1] == 0 and out["cuda"][1] == 1
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-9,
                               atol=0)

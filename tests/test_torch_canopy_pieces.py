"""The canopy slice's elementwise and assembly pieces in the port against
the JAX package, on numpy-seeded inputs, all f64 on the CPU.

Tolerances: elementwise and assembly pieces (sat_vap, the psihat lookup,
the Obukhov presolve, LBL, the radiation GEs' matrix values and right-hand
sides, the MLC blocks) within 1e-12 relative to the largest magnitude of
the JAX output (transcendentals differ in the last bit between PyTorch
and XLA); the exact block-Thomas solves (longwave m = 3, MLC m = 4) within
1e-10 relative; the GMRES(30) + ILU(0) iterates within 1e-8 of the
largest flux with equal iteration counts (the same iteration in another
summation order, stopped at PETSc's rtol 1e-5; measured 2e-12 for Iup /
Idn and 1e-9 for the absorbed flux Iabs, held on the fluxes' scale).  The hybrid Obukhov solve takes as many iterations as JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpp_tpu.batched import mlc as jmlc
from mpp_tpu.dtypes.conditions import Condition as JCondition
from mpp_tpu.batched import turbulence as jturb
from mpp_tpu.models import lbl as jlbl
from mpp_tpu.models import radiation as jrad
from mpp_tpu.ops import satvap as jsat
from mpp_tpu.ops.block_structure import BlockTridiagTemplate as JTpl
from mpp_tpu.problems import canopy_radiation as jcr
from mpp_tpu_torch.batched import mlc as tmlc
from mpp_tpu_torch.constants import Cond
from mpp_tpu_torch.dtypes.conditions import Condition as TCondition
from mpp_tpu_torch.batched import turbulence as tturb
from mpp_tpu_torch.models import lbl as tlbl
from mpp_tpu_torch.models import radiation as trad
from mpp_tpu_torch.ops import satvap as tsat
from mpp_tpu_torch.ops.block_structure import BlockTridiagTemplate as TTpl
from mpp_tpu_torch.problems import canopy_radiation as tcr

ELEM = 1e-12
SOLVE = 1e-10
KRYLOV = 1e-8


def _close(got, want, rel, scale=None):
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    if scale is None:
        scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max()) / max(scale, 1e-300)
    assert err <= rel, (err, rel)


def test_sat_vap_matches_jax():
    """Both branches (ice below 0 C, water above) and both clamps."""
    t = np.random.default_rng(0).uniform(180.0, 390.0, 4096)
    t[:4] = [273.15, 273.15 - 75.0, 373.15, 150.0]
    es_j, d_j = jsat.sat_vap(jnp.asarray(t))
    es_t, d_t = tsat.sat_vap(torch.as_tensor(t))
    _close(es_t, es_j, ELEM)
    _close(d_t, d_j, ELEM)
    _close(tsat.lat_vap(torch.as_tensor(t)), jsat.lat_vap(jnp.asarray(t)),
           ELEM)


@pytest.fixture(scope="module")
def tables():
    return jturb.load_psihat_jnp(), tturb.load_psihat_tables("cpu")


@pytest.mark.parametrize("which", ["m", "h"])
def test_psihat_lookup_matches_jax(tables, which):
    """At the grid nodes, between them, beyond both ends of both axes
    (the off-grid 0.5/0.5 rows) and on the descending z grid's edges."""
    jt, tt = tables
    zg = np.asarray(getattr(jt, "zdt_" + which))
    lg = np.asarray(getattr(jt, "dtl_" + which))
    rng = np.random.default_rng(1)
    z_nodes, l_nodes = np.meshgrid(zg, lg[::7], indexing="ij")
    z_mid = 0.5 * (zg[1:] + zg[:-1])
    l_mid = 0.5 * (lg[1:] + lg[:-1])
    zdt = np.concatenate([
        z_nodes.ravel(), rng.choice(z_mid, 400),
        [zg[0] + 1.0, zg[-1] - 1.0, zg[0], zg[-1]] * 10,
        rng.uniform(zg[-1] - 5.0, zg[0] + 5.0, 400)])
    dtl = np.concatenate([
        l_nodes.ravel(), rng.choice(l_mid, 400),
        np.repeat([lg[0] - 0.5, lg[-1] + 0.5, lg[0], lg[-1],
                   lg[0] - 9.0, lg[-1] + 9.0, lg[3], lg[-4],
                   0.0, 0.5], 4),
        rng.uniform(lg[0] - 2.0, lg[-1] + 2.0, 400)])
    args_j = [getattr(jt, f + "_" + which) for f in ("zdt", "dtl", "psi")]
    args_t = [getattr(tt, f + "_" + which) for f in ("zdt", "dtl", "psi")]
    want = jturb.lookup_psihat_jnp(jnp.asarray(zdt), jnp.asarray(dtl),
                                   *args_j)
    got = tturb.lookup_psihat(torch.as_tensor(zdt), torch.as_tensor(dtl),
                              *args_t)
    _close(got, want, ELEM)


def test_presolve_matches_jax(tables):
    """obukhov_length + wind + conductances at 8 columns of seeded forcing
    and canopy-top state (stable and unstable lanes), with the hybrid's
    iterations counted on both sides."""
    jt, tt = tables
    nc = 8
    rng = np.random.default_rng(2)
    zs = np.zeros((nc, 93))
    zs[:, 1:] = 0.25 + np.arange(92) * 0.5
    kw = dict(hc=np.full(nc, 21.0), zref=np.full(nc, 46.0),
              pref=np.full(nc, 98620.0), uref=rng.uniform(1.0, 8.0, nc),
              qref=rng.uniform(0.005, 0.012, nc),
              tref=rng.uniform(285.0, 300.0, nc),
              tcan=rng.uniform(283.0, 303.0, nc),
              qcan=rng.uniform(0.005, 0.013, nc), pai=np.full(nc, 5.05))
    jinp = jturb.derive_inputs(**{k: jnp.asarray(v) for k, v in kw.items()})
    tinp = tturb.derive_inputs(**{k: torch.as_tensor(v)
                                  for k, v in kw.items()})
    evals = []

    def counted(x):
        jax.debug.callback(lambda: evals.append(1))
        return jturb.obukhov_residual(jt, jinp, x)

    x0, x1 = jnp.full(nc, 100.0), jnp.full(nc, -100.0)
    _, jaux_h = jax.jit(lambda a, b: jturb.batched_hybrid(
        counted, a, b, 0.01))(x0, x1)
    jax.effects_barrier()
    jaux, jwind, jga = jax.jit(lambda i: jturb.presolve(jt, i, zs, 43))(jinp)
    syncs = []
    taux, twind, tga, iters = tturb.presolve(
        tt, tinp, torch.as_tensor(zs), 43,
        sync=lambda v: syncs.append(1) or v.item())
    assert iters == len(evals) - 2 > 0      # two evaluations before the loop
    assert len(syncs) == iters + 1
    for name in jaux._fields:
        _close(getattr(taux, name), getattr(jaux, name), ELEM)
    _close(twind, jwind, ELEM)
    _close(tga, jga, ELEM)


def test_lbl_compute_matches_jax():
    rng = np.random.default_rng(3)
    n = 2 * 2 * 93
    vals = dict(pref=np.full(n, 98620.0), tref=rng.uniform(285, 300, n),
                wind=rng.uniform(0.0, 6.0, n), tair=rng.uniform(285, 300, n),
                tleaf=rng.uniform(283, 305, n), dleaf=np.full(n, 0.04))
    mesh = jcr.canopy_mesh(92, ncair=4)
    jge = jlbl.LeafBoundaryLayerGE(name="lbl", mesh=mesh)
    tge = tlbl.LeafBoundaryLayerGE(name="lbl", mesh=tcr.canopy_mesh(
        92, ncair=4), device="cpu")
    jge.allocate_auxvars()
    tge.allocate_auxvars()
    for k, v in vals.items():
        setattr(jge, k, jnp.asarray(v))
        setattr(tge, k, torch.as_tensor(v))
    for got, want in zip(tge.compute(), jge.compute()):
        _close(got, want, ELEM)


def _longwave_pair(nc=2, seed=4):
    """The pipeline's longwave GE at ``nc`` columns in both packages, with
    seeded leaf / ground temperatures and transmittances."""
    rng = np.random.default_rng(seed)
    nlev = 93
    n = nc * nlev
    is_soil = np.zeros(n, bool)
    is_soil[0::nlev] = True
    gem = np.where(is_soil, 0.96, 0.0)
    fssh = rng.uniform(0, 1, n)
    fields = dict(
        trans=rng.uniform(0.85, 0.99, n), leaf_rho=np.full(n, 0.02),
        leaf_tau=np.zeros(n), leaf_emiss=np.full(n, 0.98),
        ground_emiss=gem,
        ground_temperature=np.where(is_soil, rng.uniform(285, 300, n), 0.0),
        leaf_temperature=rng.uniform(285, 305, (n, 2)),
        leaf_fssh=np.stack([fssh, 1.0 - fssh], axis=1),
        leaf_dpai=rng.uniform(0, 0.3, (n, 2)),
        bc_Idn=rng.uniform(300, 420, nc))
    out = []
    for mod, cr, arr, cond_cls, kw in (
            (jrad, jcr, jnp.asarray, JCondition, {}),
            (trad, tcr, torch.as_tensor, TCondition, {"device": "cpu"})):
        ge = mod.LongwaveGE(name="lw", mesh=cr.canopy_mesh(92, ncair=nc),
                            nleaf=2, **kw)
        cond = cond_cls(name="sky", units="W/m2", itype=int(Cond.DIRICHLET),
                        conn_set=cr._top_bc_conns(92, nc, 0.5))
        cond.ensure_value()
        ge.boundary_conditions = [cond]
        ge.allocate_auxvars()
        ge.is_soil = is_soil
        for k, v in fields.items():
            setattr(ge, k, arr(v))
        out.append(ge)
    return out


def test_longwave_ge_matches_jax():
    """matrix_values, rhs, the coo pattern and the block-Thomas solve
    (dof = 3) of the pipeline's longwave GE at 2 columns."""
    jge, tge = _longwave_pair()
    rj, cj = jge.coo_coords()
    rt, ct = tge.coo_coords()
    np.testing.assert_array_equal(rt, rj)
    np.testing.assert_array_equal(ct, cj)
    vj, bj = jge.matrix_values(), jge.rhs()
    vt, bt = tge.matrix_values(), tge.rhs()
    _close(vt, vj, ELEM)
    _close(bt, bj, ELEM)
    xj = JTpl(2, 93, 3, rj, cj).solve(vj, bj)
    xt = TTpl(2, 93, 3, rt, ct).solve(vt, bt)
    _close(xt, xj, SOLVE)


def test_radiation_mpp_steps_match_jax():
    """The serial GMRES(30) + ILU(0) step (``solver="ksp"``) and the
    block step of the longwave and shortwave reference problems."""
    for run, fields in ((jcr.run_longwave_problem, ("Iup", "Idn", "Iabs")),
                        (jcr.run_shortwave_problem,
                         ("Iup", "Idn", "Iabs_leaf", "Iabs_soil"))):
        tname = run.__name__
        mj = run()
        mt = getattr(tcr, tname)(device="cpu")
        assert mt.cumulative_linear_iterations \
            == mj.cumulative_linear_iterations > 0
        gj, gt = mj.goveqns[0], mt.goveqns[0]
        # the scale of the iterate, and of Iabs, a difference of fluxes
        scale = max(float(np.abs(np.asarray(gj.Iup)).max()),
                    float(np.abs(np.asarray(gj.Idn)).max()))
        for f in fields:
            _close(getattr(gt, f), getattr(gj, f), KRYLOV, scale)
        _close(gt.matrix_values(), gj.matrix_values(), ELEM)
        _close(gt.rhs(), gj.rhs(), ELEM)
        mj.step_dt(300.0, solver="block")
        mt.step_dt(300.0, solver="block")
        for f in fields:
            _close(getattr(gt, f), getattr(gj, f), SOLVE, scale)


def _mlc_inputs(nc=3, nlev=93, seed=5):
    """Seeded, physically plausible MLC block inputs (one tree, sun and
    shade slots, some leafless levels)."""
    rng = np.random.default_rng(seed)
    u = lambda lo, hi, *s: rng.uniform(lo, hi, s)
    dpai = u(0.0, 0.3, nc, nlev, 2)
    dpai[:, :6] = 0.0
    dpai[:, 44:] = 0.0
    fssh = u(0.0, 1.0, nc, nlev)
    return dict(
        at_T=u(288, 300, nc, nlev), av_q=u(0.006, 0.012, nc, nlev),
        leaf_T=u(286, 304, nc, nlev, 2), cpair=u(29.0, 29.5, nc),
        rhomol=u(39.5, 41.0, nc), pref=np.full(nc, 98620.0),
        leaf_cpair=np.asarray(29.3), leaf_pref=np.asarray(98620.0),
        soil_rhg=np.full(nc, 0.998), soil_rn=u(20, 200, nc),
        soil_tk=np.full(nc, 1.26), soil_dz=np.full(nc, 7.1e-3),
        soil_res=np.full(nc, 3361.5), soil_T=u(290, 296, nc),
        gbh_air=u(0.5, 3.0, nc, nlev, 2), gbv_air=u(0.5, 3.0, nc, nlev, 2),
        leaf_gs=u(0.002, 0.3, nc, nlev, 2), leaf_fwet=np.zeros((nc, nlev, 2)),
        leaf_fdry=np.where(dpai > 0, 0.82, 0.0),
        leaf_fssh=np.stack([fssh, 1.0 - fssh], -1), leaf_dpai=dpai,
        leaf_gbh=u(0.5, 3.0, nc, nlev, 2), leaf_gbv=u(0.5, 3.0, nc, nlev, 2),
        leaf_rn=u(-10, 150, nc, nlev, 2), leaf_cp=np.full((nc, nlev, 2),
                                                          744.5),
        conn_ga=u(0.3, 5.0, nc, nlev - 1), bc_ga=u(1.0, 4.0, nc),
        bc_T=u(293, 300, nc), bc_q=u(0.008, 0.011, nc),
        vol_air=np.asarray(0.5))


def test_mlc_assemble_and_step_match_jax():
    """(L, D, U, b) of the m = 4 canopy system and its block-Thomas step."""
    fields = _mlc_inputs()
    jin = jmlc.MLCBlockInputs(**{k: jnp.asarray(v) for k, v in
                                 fields.items()})
    tin = tmlc.MLCBlockInputs(**{k: torch.as_tensor(v) for k, v in
                                 fields.items()})
    for got, want in zip(tmlc.assemble(tin, 300.0),
                         jmlc.assemble(jin, 300.0)):
        _close(got, want, ELEM)
    _close(tmlc.step(tin, 300.0), jmlc.step(jin, 300.0), SOLVE)

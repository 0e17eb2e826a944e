"""GMRES(m)'s inner step and cycle update (hopper_kernels.gmres_arnoldi /
gmres_update, csrc/gmres_kernels.cu) under batched/ilu_gmres.gmres_cycles,
against the JAX package, and the wrappers' contract.

On the CPU the wrappers run their plain forms (the port's eager step and
update); the `cuda` cases hold the kernels to those plain forms on the card
and skip here.  JAX is imported by the CPU cases only, so `python -m pytest
--noconftest -m cuda tests/test_torch_gmres_kernels.py` runs on a card
machine without it.

Systems: random M-matrix-like CSR systems on 2-D / 3-D stencils (numpy
seeds), ILU(0)-preconditioned as every caller runs them.  References: the
JAX package's batched engine (``petsc_gmres_batched``: x, cycles and the
convergence mask) and its numpy engine (``ops/ilu.py:petsc_gmres``: each
column's inner iterations, and the serial solves with the Krylov
dimension ``restart`` past n and the ``maxiter`` cap).  Tolerances, f64:
x at rtol 1e-10 (test_torch_ilu_gmres.py's: the Gram-Schmidt contractions
associate differently, at rounding level), iterations, cycles and masks
equal; f32: x within 1e-4 of max |x| of JAX's f32 run (both sit ~1e-6 from
the f64 solution on these systems).  On the card: V, H and g within 1e-12
(f64) / 1e-5 (f32) of max |.| of the plain form, mj, found, its and the
flags equal.
"""
import numpy as np
import pytest
import torch

from mpp_tpu_torch.batched import ilu_gmres as tig
from mpp_tpu_torch.ops import hopper_kernels as hk
from mpp_tpu_torch.ops import ilu as tilu
from mpp_tpu_torch.ops.sparse import csr_template

F32_REL = 1e-4
CARD_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture(autouse=True)
def _fresh_counters():
    hk.reset_launches()
    yield
    if not torch.cuda.is_available():
        # CPU tensors never launch a kernel
        assert all(v == 0 for v in hk.LAUNCHES.values()), hk.LAUNCHES


def _system(dims, ncol, seed):
    """(template, data [ncol, nnz], b [ncol, n]) on the nearest-neighbour
    stencil of a grid of shape ``dims``: off-diagonals in [-1, -0.05),
    diagonals 1.05-2 times the row's off-diagonal sum, b standard normal."""
    ids = np.arange(int(np.prod(dims))).reshape(dims[::-1])
    r, c = [ids.ravel()], [ids.ravel()]
    for ax in range(len(dims)):
        a = np.take(ids, range(ids.shape[ax] - 1), axis=ax).ravel()
        b = np.take(ids, range(1, ids.shape[ax]), axis=ax).ravel()
        r += [a, b]
        c += [b, a]
    r, c = np.concatenate(r), np.concatenate(c)
    n = int(r.max()) + 1
    t = csr_template(n, n, r, c)
    rows = t.row_ids()
    rng = np.random.default_rng(seed)
    data = -rng.uniform(0.05, 1.0, (ncol, t.nnz))
    off = rows != t.indices
    dsum = np.zeros((ncol, n))
    np.add.at(dsum.T, rows[off], -data[:, off].T)
    diag = ~off
    data[:, diag] = dsum[:, rows[diag]] * rng.uniform(1.05, 2.0, (ncol, n))
    return t, data, rng.standard_normal((ncol, n))


def _port(t, data, b, dtype=torch.float64, device="cpu", **kw):
    """gmres_cycles on the port, ILU(0)-preconditioned: (x, cycles, done,
    its, host syncs) as numpy / ints."""
    il = tig.BatchedILU0(t.indptr, t.indices)
    mt = tig.make_ell_matvec(t.indptr, t.indices)
    d = torch.as_tensor(data, dtype=dtype, device=device)
    bt = torch.as_tensor(b, dtype=dtype, device=device)
    syncs = []
    x, k, done, its = tig.gmres_cycles(
        mt, d, bt, ilu=il, pc_data=il.factor(d),
        sync=lambda v: syncs.append(1) or bool(v.item()), **kw)
    return (x.cpu().numpy(), k, done.cpu().numpy(), its.cpu().numpy(),
            len(syncs))


def _jax_batched(t, data, b, dtype=np.float64, **kw):
    import jax.numpy as jnp
    from mpp_tpu.batched import ilu_gmres as jig
    ij = jig.BatchedILU0(t.indptr, t.indices)
    dj = jnp.asarray(data.astype(dtype))
    x, k, done = jig.petsc_gmres_batched(
        jig.make_ell_matvec(t.indptr, t.indices), dj,
        jnp.asarray(b.astype(dtype)), ilu=ij, pc_data=ij.factor(dj), **kw)
    return np.asarray(x), int(k), np.asarray(done)


def _numpy_iterations(t, data, b, **kw):
    """Each column's (inner iterations, converged) from the JAX package's
    numpy engine; its Krylov dimension is ``restart`` itself."""
    from mpp_tpu.ops import ilu as jilu
    pj = jilu.ILU0(t.indptr, t.indices)
    out = []
    for dc, bc in zip(data, b):
        _, it, conv = jilu.petsc_gmres(t.indptr, t.indices, dc, bc, pc=pj,
                                       pc_data=pj.factor(dc), **kw)
        out.append((it, conv))
    return out


def _hold_x(got, ref, rel=None):
    if rel is None:
        np.testing.assert_allclose(got, ref, rtol=1e-10,
                                   atol=1e-12 * np.abs(ref).max())
    else:
        assert np.abs(got - ref).max() <= rel * np.abs(ref).max()


# ---- against the JAX package ----------------------------------------------

@pytest.mark.parametrize("restart", [30, 4])
@pytest.mark.parametrize("dims", [(6, 5), (4, 3, 5)], ids=["2d", "3d"])
def test_cycles_match_jax(dims, restart):
    """x, cycles and the mask as the JAX batched engine; each column's
    inner iterations as the numpy engine (n >= restart: the same Krylov
    dimension in both engines)."""
    t, data, b = _system(dims, 5, seed=sum(dims) + restart)
    x, k, done, its, syncs = _port(t, data, b, restart=restart, rtol=1e-8)
    xj, kj, dj = _jax_batched(t, data, b, restart=restart, rtol=1e-8)
    assert k == kj and bool(done.all()) and np.array_equal(done, dj)
    _hold_x(x, xj)
    ref = _numpy_iterations(t, data, b, restart=restart, rtol=1e-8)
    assert its.tolist() == [it for it, _ in ref]
    assert all(conv for _, conv in ref)
    assert syncs >= k


def test_column_converged_before_the_first_step():
    """b = 0 in one column: done before the first cycle, x = 0, no inner
    iteration; the others as JAX."""
    t, data, b = _system((6, 5), 4, seed=21)
    b[1] = 0.0
    x, k, done, its, _ = _port(t, data, b, rtol=1e-9)
    xj, kj, dj = _jax_batched(t, data, b, rtol=1e-9)
    assert k == kj and np.array_equal(done, dj) and bool(done.all())
    assert its[1] == 0 and not np.any(x[1])
    _hold_x(x, xj)
    ref = _numpy_iterations(t, data, b, rtol=1e-9)
    assert its.tolist() == [it for it, _ in ref]


def test_done_columns_keep_x_over_later_cycles():
    """Columns converging in different cycles (restart 3, diagonals 1-30
    times stronger): those done early keep x over the later cycles, as
    JAX's where(done, x, x2)."""
    t, data, b = _system((6, 5), 5, seed=13)
    data[:, t.row_ids() == t.indices] *= np.array(
        [1.0, 1.2, 2.0, 5.0, 30.0])[:, None]
    x, k, done, its, _ = _port(t, data, b, restart=3, rtol=1e-10)
    xj, kj, dj = _jax_batched(t, data, b, restart=3, rtol=1e-10)
    assert k == kj > 2 and np.array_equal(done, dj) and len(set(its)) > 2
    _hold_x(x, xj)
    ref = _numpy_iterations(t, data, b, restart=3, rtol=1e-10)
    assert its.tolist() == [it for it, _ in ref]


def test_nan_column_stays_in_its_column():
    """A NaN in one column's right-hand side: that column never converges
    and its x is NaN, in both packages; the cycles run to maxcycles; every
    other column as JAX."""
    t, data, b = _system((6, 5), 4, seed=5)
    b[2, 7] = np.nan
    x, k, done, its, _ = _port(t, data, b, rtol=1e-9, maxcycles=4)
    xj, kj, dj = _jax_batched(t, data, b, rtol=1e-9, maxcycles=4)
    assert k == kj == 4 and np.array_equal(done, dj)
    assert not done[2] and bool(np.delete(done, 2).all())
    assert np.isnan(x[2]).all() and np.isnan(xj[2]).all()
    _hold_x(np.delete(x, 2, 0), np.delete(xj, 2, 0))
    ref = _numpy_iterations(t, np.delete(data, 2, 0), np.delete(b, 2, 0),
                            rtol=1e-9)
    assert np.delete(its, 2).tolist() == [it for it, _ in ref]


def test_f32_matches_jax_f32():
    """f32 throughout: cycles and the mask as JAX's f32 run, x within
    F32_REL of max |x|."""
    t, data, b = _system((4, 3, 5), 6, seed=8)
    x, k, done, its, _ = _port(t, data, b, dtype=torch.float32, rtol=1e-4)
    assert x.dtype == np.float32
    xj, kj, dj = _jax_batched(t, data, b, dtype=np.float32, rtol=1e-4)
    assert xj.dtype == np.float32
    assert k == kj and np.array_equal(done, dj) and bool(done.all())
    _hold_x(x, xj, F32_REL)
    assert np.all(its >= 1)


@pytest.mark.parametrize("n", [8, 20])
def test_serial_krylov_dimension_past_n(n):
    """ops/ilu.petsc_gmres (restart 30 > n: the Arnoldi runs on past the
    breakdown, hlast ~ 0) against the numpy engine: equal iterations and
    convergence, x at rtol 1e-10."""
    from mpp_tpu.ops import ilu as jilu
    t, data, b = _system((n,), 1, seed=40 + n)
    data, b = data[0], b[0]
    pj, pt = jilu.ILU0(t.indptr, t.indices), tilu.ILU0(t.indptr, t.indices)
    xj, itj, cj = jilu.petsc_gmres(t.indptr, t.indices, data, b, pc=pj,
                                   pc_data=pj.factor(data), rtol=1e-12)
    d = torch.as_tensor(data)
    xt, itt, ct = tilu.petsc_gmres(t.indptr, t.indices, d,
                                   torch.as_tensor(b), pc=pt,
                                   pc_data=pt.factor(d), rtol=1e-12)
    assert (itt, ct) == (itj, cj) and ct
    _hold_x(xt.numpy(), xj)


@pytest.mark.parametrize("maxiter", [3, 7, 12])
def test_maxiter_cap_matches_numpy_engine(maxiter):
    """The inner-iteration cap (restart 5): the cycle stops at the cap, as
    the numpy engine counts it."""
    from mpp_tpu.ops import ilu as jilu
    t, data, b = _system((6, 5), 1, seed=9)
    data, b = data[0], b[0]
    pj, pt = jilu.ILU0(t.indptr, t.indices), tilu.ILU0(t.indptr, t.indices)
    kw = dict(rtol=1e-14, restart=5, maxiter=maxiter)
    xj, itj, cj = jilu.petsc_gmres(t.indptr, t.indices, data, b, pc=pj,
                                   pc_data=pj.factor(data), **kw)
    d = torch.as_tensor(data)
    xt, itt, ct = tilu.petsc_gmres(t.indptr, t.indices, d,
                                   torch.as_tensor(b), pc=pt,
                                   pc_data=pt.factor(d), **kw)
    assert (itt, ct) == (itj, cj) == (maxiter, False)
    _hold_x(xt.numpy(), xj)


# ---- the wrappers -----------------------------------------------------------

def _cycle_state(ncol, n, m, j, dtype=torch.float64, seed=0, device="cpu"):
    """A cycle's state before inner step j, the steps before it run through
    the plain form on random vectors (numpy seed): a dict of the
    wrappers' arguments, with w for step j, x and its.  Columns 0 mod 4
    converge at step j (tol 2 |g_j|), 1 mod 4 were found before it, 2 mod
    4 are done."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype)
    b = draw(ncol, n)
    V, H, cs, sn, g = hk.gmres_workspace(b, m)
    V[:, 0] = b / hk._colnorm(b)[:, None]
    g[:, 0] = torch.as_tensor(rng.uniform(0.5, 2.0, ncol), dtype=dtype)
    tiny = torch.full((ncol,), 1e-30, dtype=dtype)
    mj = torch.full((ncol,), m, dtype=torch.int64)
    found = torch.zeros(ncol, dtype=torch.bool)
    done = torch.zeros(ncol, dtype=torch.bool)
    flags = torch.ones(3, dtype=torch.bool)
    for i in range(j):
        hk.gmres_arnoldi_plain(V, H, cs, sn, g, draw(ncol, n), tiny, mj,
                               found, done, flags, i)
    idx = torch.arange(ncol)
    tol = torch.where(idx % 4 == 0, 2 * g[:, j].abs(), tiny)
    found |= idx % 4 == 1
    mj = torch.where(idx % 4 == 1, j, mj)
    done |= idx % 4 == 2
    st = dict(V=V, H=H, cs=cs, sn=sn, g=g, w=draw(ncol, n), tol=tol, mj=mj,
              found=found, done=done, flags=flags, x=draw(ncol, n),
              its=torch.as_tensor(rng.integers(0, 9, ncol)))
    return {k: v.to(device) for k, v in st.items()}


ARNOLDI = ("V", "H", "cs", "sn", "g", "w", "tol", "mj", "found", "done",
           "flags")
UPDATE = ("V", "H", "g", "mj", "found", "done", "x", "its", "flags")
LAUNCHER = ("V", "H", "cs", "sn", "g", "tol", "mj", "found", "done", "flags",
            "x", "its")


def _clone(st):
    return {k: v.clone() for k, v in st.items()}


def test_wrappers_on_cpu_are_the_plain_forms_and_launch_nothing():
    """On CPU tensors the wrappers run the plain forms, bit for bit, and
    count no launch; gmres_cycles counts no card step or cycle."""
    for j in (0, 3, 5):
        st = _cycle_state(6, 11, 6, j, seed=j)
        a, b = _clone(st), _clone(st)
        hk.gmres_arnoldi(*(a[k] for k in ARNOLDI), j, cap=j == 3)
        hk.gmres_arnoldi_plain(*(b[k] for k in ARNOLDI), j, cap=j == 3)
        for k in ARNOLDI:
            assert torch.equal(a[k], b[k]), (j, k)
        assert bool(a["found"][0]) and int(a["mj"][0]) == j + 1
        hk.gmres_update(*(a[k] for k in UPDATE))
        hk.gmres_update_plain(*(b[k] for k in UPDATE))
        for k in UPDATE:
            assert torch.equal(a[k], b[k]), (j, k)
    before = dict(tig.CARD_CALLS)
    t, data, b = _system((6, 5), 3, seed=2)
    _port(t, data, b)
    assert not any(hk.LAUNCHES.values()) and tig.CARD_CALLS == before


def test_arnoldi_flags_and_cap():
    """The device words the host reads: after step j flags[j % 2] is
    "every column found or done", flags[(j + 1) % 2] True and flags[2]
    False; the update sets flags[2] to "a column left" and flags[0:2]
    True.  With cap, every column not found takes mj = j + 1."""
    st = _cycle_state(8, 9, 5, 2, seed=4)
    hk.gmres_arnoldi(*(st[k] for k in ARNOLDI), 2, cap=True)
    f = st["found"] | st["done"]
    assert st["flags"].tolist() == [bool(f.all()), True, False]
    assert not bool(f.all())
    assert torch.equal(st["mj"][~st["found"]],
                       torch.full_like(st["mj"][~st["found"]], 3))
    hk.gmres_update(*(st[k] for k in UPDATE))
    assert st["flags"].tolist() == [True, True, bool((~st["done"]).any())]
    st = _cycle_state(4, 9, 5, 1, seed=5)
    st["found"][:] = True
    hk.gmres_arnoldi(*(st[k] for k in ARNOLDI), 1)
    assert st["flags"].tolist() == [True, True, False]


#: a wrong argument (name: (key, transform)) and the wrappers that take it
BAD = {
    "mixed_dtype": ("H", lambda a: a.float()),
    "int_tol": ("tol", lambda a: a.long()),
    "mixed_device": ("g", lambda a: a.to("meta")),
    "non_contiguous_w": ("w", lambda a: torch.cat([a, a], 1)[:, ::2]),
    "non_contiguous_x": ("x", lambda a: a.t().contiguous().t()),
    "wrong_H": ("H", lambda a: a[:, :-1].contiguous()),
    "wrong_w": ("w", lambda a: a[:, 1:].contiguous()),
    "wrong_x": ("x", lambda a: a[:, 1:].contiguous()),
    "wrong_flags": ("flags", lambda a: a[:2].clone()),
    "float_mj": ("mj", lambda a: a.double()),
    "bool_its": ("its", lambda a: a.bool()),
    "f32_x": ("x", lambda a: a.float()),
}


def _arnoldi(d, j=1):
    hk.gmres_arnoldi(*(d[k] for k in ARNOLDI), j)


def _update(d):
    hk.gmres_update(*(d[k] for k in UPDATE))


@pytest.mark.parametrize("case", sorted(BAD))
def test_wrappers_raise_value_error(case):
    """Shapes, dtypes (one float dtype a call), devices and contiguity are
    checked before anything runs: each wrapper that takes the argument
    raises, and no array changes."""
    st = _cycle_state(4, 7, 5, 1, seed=1)
    key, bad = BAD[case]
    d = dict(st)
    d[key] = bad(st[key])
    snapshot = _clone(st)
    takers = [fn for names, fn in ((ARNOLDI, _arnoldi), (UPDATE, _update))
              if key in names]
    assert takers
    for fn in takers:
        with pytest.raises(ValueError):
            fn(d)
    for k in st:
        assert torch.equal(st[k], snapshot[k]), k


@pytest.mark.parametrize("case", sorted(BAD))
def test_launcher_raises_value_error(case):
    """The launcher gmres_cycles binds once a workspace refuses what the
    wrappers refuse, with ValueError: every argument but w when it is
    made, w at the step that takes it; no array changes."""
    st = _cycle_state(4, 7, 5, 1, seed=1)
    key, bad = BAD[case]
    d = dict(st)
    d[key] = bad(st[key])
    snapshot = _clone(st)
    bound = {k: d[k] for k in LAUNCHER}
    if key == "w":
        launch = hk.GmresLauncher(*bound.values())
        with pytest.raises(ValueError):
            launch.arnoldi(d["w"], 1)
    else:
        with pytest.raises(ValueError):
            hk.GmresLauncher(*bound.values())
    for k in st:
        assert torch.equal(st[k], snapshot[k]), k


def test_cycles_check_once_a_workspace():
    """gmres_cycles makes one launcher (one full check) a workspace: on the
    CPU, whose basis is zero-filled every cycle, as many as the cycles, not
    the steps; the launcher's steps and updates are the wrappers' plain
    forms."""
    t, data, b = _system((6, 5), 5, seed=13)
    data[:, t.row_ids() == t.indices] *= np.array(
        [1.0, 1.2, 2.0, 5.0, 30.0])[:, None]
    before = hk.GmresLauncher.checks, hk.GmresLauncher.plans
    x, k, done, its, syncs = _port(t, data, b, restart=3, rtol=1e-10)
    assert k > 2 and syncs > k
    assert hk.GmresLauncher.checks - before[0] == k
    assert hk.GmresLauncher.plans == before[1]


@pytest.mark.parametrize("form", ["warp", "cluster"])
@pytest.mark.parametrize("m", [1, 4, 30])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_forms_fit_shared_memory(form, m, dtype):
    """Each form's launches (without the slots a launch adds only where
    they fit) take at most ON_CHIP_BYTES for m <= 30, at the widest
    columns a CTA and the most CTAs."""
    elem = torch.empty((), dtype=dtype).element_size()
    widths = (32,) if form == "warp" else (32, 512)
    for threads in widths:
        for kernel in ("arnoldi", "update"):
            assert 0 < hk.gmres_smem(kernel, form, m, threads, elem) <= \
                hk.ON_CHIP_BYTES


@pytest.mark.parametrize("part", ["no_stage", "no_dots", "no_correction",
                                  "no_normalise", "no_tail", "no_column"])
def test_split_variants_apply_to_the_source(part):
    """Every GMRES_VARIANTS edit of this checkout's kernel finds its text
    (the --gmres-split builds), and changes it."""
    from mpp_tpu_torch.tools import resident_variants as rv
    base = open(rv.os.path.join(rv._PKG, rv.GMRES_SOURCE)).read()
    edits = {part: rv.GMRES_VARIANTS["this"][part]}
    assert rv.variant_source(part, rv.GMRES_SOURCE, edits) != base


@pytest.mark.parametrize("j", [5, -1, True, 1.0])
def test_arnoldi_rejects_j_out_of_range(j):
    st = _cycle_state(4, 7, 5, 1, seed=2)
    with pytest.raises(ValueError):
        _arnoldi(st, j)


def test_wrappers_reject_an_empty_batch():
    st = {k: (v if k == "flags" else v[:0])
          for k, v in _cycle_state(4, 7, 5, 1, seed=3).items()}
    for fn in (_arnoldi, _update):
        with pytest.raises(ValueError):
            fn(st)


@pytest.mark.parametrize("ncol, n, form", [
    (8192, 128, "warp"), (8192, 64, "warp"), (1, 32, "warp"),
    (1023, 128, "cluster"), (1024, 128, "warp"), (8192, 129, "cluster"),
    (1, 6000, "cluster"), (1, 8000, "cluster"), (1, 500, "cluster"),
    (1, 5000, "cluster"), (1, 100, "cluster"), (1, 95232, "cluster")])
def test_form_rule_picks_by_shape(ncol, n, form):
    """The path shapes: (q)'s [8192, 64-cell TH columns] many short
    columns, the single long systems of (r), (s), (w1), (x1) and (v3);
    and each side of the thresholds."""
    for dtype in (torch.float64, torch.float32):
        assert hk.gmres_form(ncol, n, 30, dtype) == form
        plan = hk.gmres_plan(ncol, n, 30, dtype)
        assert plan["form"] == form
        assert hk.GMRES_FORMS[plan["code"]] == form
        if form == "cluster":
            assert 1 <= plan["ctas"] <= hk.GMRES_CLUSTER_MAX
            assert plan["ctas"] * plan["chunk"] >= n
            assert (plan["ctas"] - 1) * plan["chunk"] < n
            assert 32 <= plan["threads"] <= hk.GMRES_CTA_THREADS
            assert plan["threads"] % 32 == 0


def test_form_rule_is_monotone_and_fits_shared_memory():
    """More columns or shorter ones never leave the warp form; a Krylov
    dimension whose warp-form update outgrows shared memory takes the
    cluster form; one past the cluster form's raises."""
    for n in (1, 32, 33, 128, 129, 500, 4096, 20000):
        forms = [hk.gmres_form(c, n, 30, torch.float64)
                 for c in (1, 10, 64, 1023, 1024, 8192)]
        assert forms == sorted(forms, key=("cluster", "warp").index)
    assert hk.gmres_form(8192, 128, 30, torch.float64) == "warp"
    assert hk.gmres_form(8192, 128, 100, torch.float64) == "cluster"
    with pytest.raises(ValueError):
        hk.gmres_plan(1, 100, 200, torch.float64)
    assert hk.gmres_plan(1, 100, 160, torch.float32)["form"] == "cluster"


def test_workspace_zero_filled_every_cycle_on_the_cpu():
    b = torch.ones(3, 5, dtype=torch.float64)
    ws = hk.gmres_workspace(b, 4)
    assert [tuple(a.shape) for a in ws] == [(3, 5, 5), (3, 5, 4), (3, 4),
                                            (3, 4), (3, 5)]
    ws[0].fill_(1.0)
    again = hk.gmres_workspace(b, 4, ws)
    assert again is not ws and not any(bool(a.any()) for a in again)


# ---- the kernels on the card ------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


@pytest.fixture
def force_form(monkeypatch):
    """Force the GMRES kernels' form by patching the rule's thresholds."""
    def force(form):
        warp = form == "warp"
        monkeypatch.setattr(hk, "GMRES_WARP_MAX_N", 10**9 if warp else 0)
        monkeypatch.setattr(hk, "GMRES_WARP_MIN_COLS", 10**9)
    return force


def _hold(label, got, ref, tol):
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    err = float((got - ref).abs().max()) if ref.numel() else 0.0
    assert err <= tol * max(scale, 1e-300), (label, err, scale)


def _hold_step(st_card, st_ref, j, dtype):
    tol = CARD_TOL[dtype]
    _hold("V", st_card["V"][:, :j + 2].cpu(), st_ref["V"][:, :j + 2], tol)
    _hold("H", st_card["H"][:, :, j].cpu(), st_ref["H"][:, :, j], tol)
    for k in ("cs", "sn"):
        _hold(k, st_card[k][:, j].cpu(), st_ref[k][:, j], tol)
    _hold("g", st_card["g"][:, :j + 2].cpu(), st_ref["g"][:, :j + 2], tol)
    for k in ("mj", "found", "flags"):
        assert torch.equal(st_card[k].cpu(), st_ref[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("form", ["warp", "cluster"])
@pytest.mark.parametrize("ncol, n, m", [
    (33, 1, 1), (33, 31, 4), (9, 32, 30), (9, 33, 30), (5, 1000, 30),
    (2, 5000, 30), (1, 40000, 8), (64, 128, 30), (1, 100, 30),
    (1, 500, 30), (1, 6000, 30)])
def test_kernels_match_plain_on_gpu(force_form, form, dtype, ncol, n, m):
    """Each kernel against its plain form at steps 0, m // 2 and m - 1,
    the card's V past row j + 1 NaN (never read) where the plain form's is
    zero; then the update."""
    _need_card()
    force_form(form)
    for j in sorted({0, m // 2, m - 1}):
        st = _cycle_state(ncol, n, m, j, dtype, seed=ncol + n + j)
        card = {k: v.to("cuda") for k, v in st.items()}
        card["V"][:, j + 2:] = float("nan")
        hk.gmres_arnoldi(*(card[k] for k in ARNOLDI), j)
        hk.gmres_arnoldi_plain(*(st[k] for k in ARNOLDI), j)
        torch.cuda.synchronize()
        _hold_step(card, st, j, dtype)
        # the update's precondition: mj <= the steps run (j + 1)
        for d in (card, st):
            d["mj"].clamp_(max=j + 1)
        card["flags"][2] = False
        hk.gmres_update(*(card[k] for k in UPDATE))
        hk.gmres_update_plain(*(st[k] for k in UPDATE))
        _hold("x", card["x"].cpu(), st["x"], CARD_TOL[dtype])
        for k in ("its", "done", "flags"):
            assert torch.equal(card[k].cpu(), st[k]), k
    assert hk.LAUNCHES["gmres_arnoldi"] > 0 and hk.LAUNCHES["gmres_update"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["warp", "cluster"])
@pytest.mark.parametrize("dims, ncol, kw", [
    ((6, 5), 7, dict(rtol=1e-9)), ((4, 3, 5), 5, dict(restart=4)),
    ((20,), 3, dict(restart=30, full_restart=True, rtol=1e-12)),
    ((6, 5), 2, dict(restart=5, maxiter=7, rtol=1e-14))])
def test_gmres_cycles_on_gpu_match_the_cpu(force_form, form, dims, ncol, kw):
    """A whole solve on the card against the same solve on the CPU: x at
    rtol 1e-10, equal cycles, masks, iterations and host syncs; one launch
    a step and a cycle (ilu_gmres.CARD_CALLS); one full check and one plan
    for the card's whole solve (the launcher of its one workspace)."""
    _need_card()
    force_form(form)
    t, data, b = _system(dims, ncol, seed=len(dims) + ncol)
    before = dict(tig.CARD_CALLS)
    bound = hk.GmresLauncher.checks, hk.GmresLauncher.plans
    got = _port(t, data, b, device="cuda", **kw)
    assert (hk.GmresLauncher.checks - bound[0],
            hk.GmresLauncher.plans - bound[1]) == (1, 1)
    ref = _port(t, data, b, **kw)
    _hold_x(got[0], ref[0])
    assert got[1:2] == ref[1:2] and got[4] == ref[4]
    assert np.array_equal(got[2], ref[2]) and np.array_equal(got[3], ref[3])
    calls = {k: tig.CARD_CALLS[k] - before[k] for k in before}
    assert calls["arnoldi"] == hk.LAUNCHES["gmres_arnoldi"] > 0
    assert calls["update"] == hk.LAUNCHES["gmres_update"] == got[1]


@pytest.mark.cuda
def test_smem_matches_the_launcher_on_gpu():
    """The plan's shared bytes are the launcher's."""
    _need_card()
    from mpp_tpu_torch.ops import _build
    lib = _build.library()
    for m in (1, 4, 30, 100):
        for form, threads in (("warp", 32), ("cluster", 512),
                              ("cluster", 96)):
            for kernel in ("arnoldi", "update"):
                for elem in (4, 8):
                    for ctas in (1, 12, 16):
                        assert lib.mpp_gmres_smem(
                            ("arnoldi", "update").index(kernel),
                            hk.GMRES_FORMS.index(form), m, threads, ctas,
                            elem) == hk.gmres_smem(kernel, form, m, threads,
                                                   elem, ctas)

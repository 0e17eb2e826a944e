"""The ILU(0) schedule's parts and the kernels' programs
(``ops/ilu0_schedule.py``), on the CPU: the connected components binned
into parts, each part's steps and levels, the plain forms walking the
parts in lockstep, and a numpy walk of every kernel program
(``emulate_factor`` / ``emulate_apply``, step for step what
``csrc/ilu0_kernels.cu`` does, the streamed forms' copies landing as early
as the ring allows) against the plain forms; the ``cuda`` cases run the
kernels themselves in each form.

Sparsities: CompiledMLC's template at 2 and 8 columns (226 / 904
components), the TH column (2x2 blocks, nx 16) as four diagonal blocks,
600 dense 2x2 blocks, the TH column and th_manoli2014 (one component
each), a comb of chains joined at a hub (every level as wide as the comb)
and an arrow chain (a root, side rows hanging on it, a chain over them:
the side rows' slots stay live from the first step to the last).

Tolerances, relative to the largest entry of the reference: the factor
bit for bit (its plain form and the kernels round every operation on its
own, and parts keep each slot's order of operations); the apply 1e-13
(f64) / 1e-5 (f32) (padded rows summed in orders that may differ); JAX's
``BatchedILU0`` within 1e-13 / 1e-5 (XLA's CPU backend contracts
multiply-subtracts into FMAs); ``torch.triangular_solve`` (the apply's
library yardstick) within 1e-12 / 1e-5.
"""
from unittest import mock

import numpy as np
import pytest
import torch

from mpp_tpu_torch.batched import ilu_gmres as tig
from mpp_tpu_torch.ops import hopper_kernels as hk
from mpp_tpu_torch.ops import ilu0_schedule as isch
from mpp_tpu_torch.ops.sparse import csr_template

TOL = {np.float64: 1e-13, np.float32: 1e-5}
DTYPES = (np.float64, np.float32)
DT_IDS = ("f64", "f32")


def _coo(r, c):
    r, c = np.concatenate(r), np.concatenate(c)
    n = int(max(r.max(), c.max())) + 1
    t = csr_template(n, n, r, c)
    return t.indptr, t.indices


def _th_column(nx=16):
    r, c = [], []
    for i in range(nx):
        for j in (i - 1, i, i + 1):
            if 0 <= j < nx:
                for a in range(2):
                    for b in range(2):
                        r.append(2 * i + a)
                        c.append(2 * j + b)
    return np.array(r), np.array(c)


def _th_blocks(copies=4):
    r, c = _th_column()
    m = 32
    return _coo([r + k * m for k in range(copies)],
                [c + k * m for k in range(copies)])


def _wide(nblocks=600):
    k = np.arange(4 * nblocks)
    return np.arange(0, 4 * nblocks + 1, 2), 2 * (k // 4) + k % 2


def _comb(width, length):
    """``width`` chains of ``length`` rows (chain c, position p at row
    p * width + c) and a hub row after them joined to every chain's last
    row: every level of either sweep holds ``width`` rows."""
    ids = np.arange(width * length).reshape(length, width)
    hub = width * length
    a, b = ids[:-1].ravel(), ids[1:].ravel()
    last = ids[-1]
    diag = np.arange(hub + 1)
    return _coo([diag, a, b, last, np.full(width, hub)],
                [diag, b, a, np.full(width, hub), last])


def _arrow_chain(side):
    """Row 0 a root; rows 1..side hang on it; rows side+1..2 side a chain,
    its j-th row joined to side row j: each side row's diagonal is
    updated at the first step and read at chain level j."""
    A = np.arange(1, side + 1)
    L = np.arange(side + 1, 2 * side + 1)
    diag = np.arange(2 * side + 1)
    zero = np.zeros(side, np.int64)
    return _coo([diag, zero, A, A, L, L[:-1], L[1:]],
                [diag, A, zero, L, A, L[1:], L[:-1]])


def _mlc(ncair):
    from mpp_tpu_torch.problems import mlc as tmlc
    t = tmlc.run_mlc_problem(ncair, 1, use_compiled=True,
                             device="cpu").soe.step_dt.__self__.template
    return t.indptr, t.indices


def _manoli():
    from mpp_tpu_torch.problems import th_manoli2014 as tm
    soe = tm.build_th_manoli2014(scale=1, device="cpu").soe
    soe._build_jac_plan()
    b = soe._jac_plan["ilu"].batched
    return b.indptr, b.indices


SPARSITIES = {
    "mlc_2col": lambda: _mlc(2),
    "mlc_8col": lambda: _mlc(8),
    "th_blocks": _th_blocks,
    "wide_blocks": _wide,
    "th_column": lambda: _coo(*[[a] for a in _th_column()]),
    "th_manoli2014": _manoli,
    "comb_33": lambda: _comb(33, 40),
    "arrow_chain": lambda: _arrow_chain(40),
}
_PATTERNS, _ILU = {}, {}


def _one_component(indptr, indices):
    return np.zeros(len(indptr) - 1, np.int64)


def _ilu(name, parts=True):
    """The BatchedILU0 of sparsity ``name``; with ``parts=False`` its rows
    taken as one component, so its schedule is one part (the reference the
    parts are held to)."""
    if name not in _PATTERNS:
        _PATTERNS[name] = SPARSITIES[name]()
    if (name, parts) not in _ILU:
        with mock.patch.object(isch, "components",
                               isch.components if parts else _one_component):
            _ILU[name, parts] = tig.BatchedILU0(*_PATTERNS[name])
    return _ILU[name, parts]


def _system(ilu, B, dt, seed):
    """Random M-matrices on ``ilu``'s sparsity: off-diagonals in [-1,
    -0.05), diagonals 1.05-2 times one plus the row's off-diagonal sum;
    b standard normal."""
    rows = np.repeat(np.arange(ilu.n), np.diff(ilu.indptr))
    rng = np.random.default_rng(seed)
    data = -rng.uniform(0.05, 1.0, (B, ilu.nnz))
    diag = rows == ilu.indices
    dsum = np.add.reduceat(np.where(diag, 0.0, data), ilu.indptr[:-1],
                           axis=1)
    data[:, diag] = (1.0 - dsum) * rng.uniform(1.05, 2.0, (B, ilu.n))
    return data.astype(dt), rng.standard_normal((B, ilu.n)).astype(dt)


# ---- the parts ------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SPARSITIES))
def test_parts_cover_every_row_step_and_level_once(name):
    ilu = _ilu(name)
    s, whole = ilu.schedule, _ilu(name, parts=False).schedule
    P = len(s.parts)
    rows = np.concatenate([p["rows"] for p in s.parts])
    slots = np.concatenate([p["slots"] for p in s.parts])
    assert sorted(rows.tolist()) == list(range(ilu.n))
    assert sorted(slots.tolist()) == list(range(ilu.nnz))
    # a component lies in one part; parts never share a slot's row
    comp = isch.components(ilu.indptr, ilu.indices)
    assert s.ncomponents == comp.max() + 1
    for c in range(s.ncomponents):
        assert np.unique(s.part_of_row[comp == c]).size == 1
    for p, part in enumerate(s.parts):
        assert (s.part_of_row[part["rows"]] == p).all()
        assert (s.row_of_slot[part["slots"]] >= 0).all()
        assert np.isin(s.row_of_slot[part["slots"]], part["rows"]).all()
    # every step entry, pair and level row of the whole schedule exactly
    # once among the parts
    for i, k in enumerate(("lp", "ld", "pij", "pik", "pkj")):
        got = np.concatenate([st[i] for p in s.parts for st in p["steps"]]
                             + [np.zeros(0, np.int64)])
        want, = whole.sections("cpu", "factor", k)
        assert sorted(got.tolist()) == sorted(want.tolist())
    for key, tag in (("fwd", "f_"), ("bwd", "b_")):
        got = np.concatenate([lv[0] for p in s.parts for lv in p[key]]
                             + [np.zeros(0, np.int64)])
        want, = whole.sections("cpu", "apply", tag + "rows")
        assert sorted(got.tolist()) == sorted(want.tolist())
    if s.ncomponents == 1:
        assert P == 1
        np.testing.assert_array_equal(s.factor, whole.factor)
        np.testing.assert_array_equal(s.apply, whole.apply)


@pytest.mark.parametrize("name", sorted(SPARSITIES))
def test_part_levels_are_the_whole_schedule_restricted(name):
    """A part's steps and levels are the whole schedule's, restricted to
    its rows, empty ones dropped, in the same order."""
    s = _ilu(name).schedule
    whole = _ilu(name, parts=False).schedule.parts[0]
    ros = s.row_of_slot
    for p, part in enumerate(s.parts):
        mine = s.part_of_row == p
        want = []
        for st in whole["steps"]:
            a, q = mine[ros[st[0]]], mine[ros[st[2]]]
            if a.any():
                want.append((st[0][a], st[1][a], st[2][q], st[3][q],
                             st[4][q]))
        assert len(want) == len(part["steps"])
        for got, w in zip(part["steps"], want):
            for x, y in zip(got, w):
                np.testing.assert_array_equal(x, y)
        for key in ("fwd", "bwd"):
            want = [(lv[0][mine[lv[0]]], lv[1][mine[lv[0]]])
                    for lv in whole[key] if mine[lv[0]].any()]
            assert len(want) == len(part[key])
            for (rows, pos, _), (wr, wp) in zip(part[key], want):
                np.testing.assert_array_equal(rows, wr)
                # the same slots, the pads trimmed to the part's widest row
                np.testing.assert_array_equal(pos, wp[:, :pos.shape[1]])
                assert (wp[:, pos.shape[1]:] == s.nnz).all()
        if part["dpos"]:
            np.testing.assert_array_equal(
                np.concatenate(part["dpos"]),
                _ilu(name).diag_pos[np.concatenate(
                    [lv[0] for lv in part["bwd"]])])


def test_mlc_columns_are_parts():
    """CompiledMLC's template: 113 components a column (one of 260 rows,
    the rest single rows) in about one part a column."""
    for name, ncol in (("mlc_2col", 2), ("mlc_8col", 8)):
        s = _ilu(name).schedule
        assert s.ncomponents == 113 * ncol
        assert ncol <= len(s.parts) <= ncol + 2


@pytest.mark.parametrize("name", sorted(SPARSITIES))
@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
def test_partitioned_plain_forms_match_the_whole(name, dt):
    """The plain factor on the partitioned schedule is bit for bit the
    one-part schedule's; the apply within 1e-13 (f64) / 1e-5 (f32)."""
    ilu, whole = _ilu(name), _ilu(name, parts=False)
    data, b = (torch.as_tensor(a) for a in _system(ilu, 3, dt, seed=7))
    f = hk.ilu0_factor_plain(data, ilu.schedule)
    fw = hk.ilu0_factor_plain(data, whole.schedule)
    assert torch.equal(f, fw)
    x = hk.ilu0_apply_plain(f, b, ilu.schedule)
    xw = hk.ilu0_apply_plain(f, b, whole.schedule)
    tol = 1e-13 if dt == np.float64 else TOL[dt]
    assert torch.isfinite(x).all()
    assert float((x - xw).abs().max()) <= tol * float(xw.abs().max())


@pytest.mark.parametrize("name", ["mlc_2col", "mlc_8col", "th_blocks"])
@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
def test_parts_match_jax(name, dt):
    # imported here: the card's machine runs this file's cuda cases
    # without JAX
    import jax.numpy as jnp
    from mpp_tpu.batched import ilu_gmres as jig
    ilu = _ilu(name)
    data, b = _system(ilu, 2, dt, seed=11)
    ij = jig.BatchedILU0(ilu.indptr, ilu.indices)
    fj = np.asarray(ij.factor(jnp.asarray(data)))
    ft = ilu.factor(torch.as_tensor(data)).numpy()
    assert ft.dtype == fj.dtype == dt
    assert np.abs(ft - fj).max() <= TOL[dt] * np.abs(fj).max()
    xj = np.asarray(ij.solve(jnp.asarray(fj), jnp.asarray(b)))
    xt = ilu.solve(torch.as_tensor(fj), torch.as_tensor(b)).numpy()
    assert np.isfinite(xt).all()
    assert np.abs(xt - xj).max() <= TOL[dt] * np.abs(xj).max()


# ---- the kernels' programs, walked in numpy -------------------------------

def h100_limits(elem, **over):
    """The limits ``mpp_ilu0_limit`` reports on the H100 build (227 KB a
    block, two stages of 4096 words and 16 KB of values), with
    ``over``rides."""
    lim = dict(staged_bytes=227 * 1024, stage_words=4096,
               stage_values=16384 // elem, stages=2)
    lim.update(over)
    ring = lim["stages"] * 4 * lim["stage_words"]
    lim.setdefault("factor_cells", (227 * 1024 - ring) // elem)
    lim.setdefault("apply_rows", (227 * 1024 - ring - lim["stages"] * elem
                                  * lim["stage_values"]) // elem)
    return lim


#: limits that force each form: the H100's, everything streamed through
#: small stages, streamed with a few cells / rows on chip (the rest
#: spilled), and stages so small that steps, levels and rows are cut
FORMS = {
    "staged": {},
    "streamed": dict(staged_bytes=0, stage_words=160, stage_values=64),
    "spilled": dict(staged_bytes=0, stage_words=160, stage_values=64,
                    factor_cells=3, apply_rows=5),
    "cut_rows": dict(staged_bytes=0, stage_words=16, stage_values=6),
}


def _table(w, p):
    t = int(w[4]) + isch.FIELDS * p
    return w[t:t + isch.FIELDS]


def _factor_step(prog, v):
    """One record [rows, width, (p, d) x rows, (pij, pkj) x rows x width]:
    each row's multiplier (d < 0: already in p), then its pairs."""
    nr, wd = int(prog[0]), int(prog[1])
    pd = prog[2:2 + 2 * nr].reshape(nr, 2)
    tab = prog[2 + 2 * nr:2 + 2 * nr + 2 * nr * wd].reshape(nr, wd, 2)
    for r in range(nr):
        p, d = pd[r]
        m = v[p] if d < 0 else v[p] / v[d]
        v[p] = m
        for q, kj in tab[r]:
            v[q] = v[q] - m * v[kj]
    return 2 + 2 * nr + 2 * nr * wd


def emulate_factor(plan, data, limits):
    """``csrc/ilu0_kernels.cu``'s factor on ``plan``'s program, one system
    and part at a time; the streamed form's gathers land as soon as the
    ring issues them and its cells start as NaN, so a cell reused too early
    or a slot never written shows."""
    w = plan["program"]["words"].astype(np.int64)
    out = np.full_like(data, np.nan)
    for p in range(int(w[0])):
        pt = _table(w, p)
        for b in range(data.shape[0]):
            if plan["form"] == "staged":
                slots = w[pt[0]:pt[0] + pt[1]]
                v = np.concatenate([data[b, slots], np.zeros(1, data.dtype)])
                prog, cur = w[pt[2]:pt[2] + pt[3]], 0
                for _ in range(int(pt[4])):
                    cur += _factor_step(prog[cur:], v)
                out[b, slots] = v[:-1]
                continue
            assert pt[4] <= plan["on_chip"] + plan["spill"]
            cells = np.full(int(pt[4]), np.nan, data.dtype)
            nch = int(pt[0])
            ch = w[pt[1]:pt[1] + isch.FIELDS * nch].reshape(-1, isch.FIELDS)
            u = w[pt[2]:pt[2] + pt[3]]
            out[b, u] = data[b, u]

            def fetch(j):
                if j < nch:
                    g = w[ch[j, 3]:ch[j, 3] + 2 * ch[j, 4]].reshape(-1, 2)
                    cells[g[:, 0]] = data[b, g[:, 1]]

            def write_back(j):
                if j >= 0:
                    g = w[ch[j, 5]:ch[j, 5] + 2 * ch[j, 6]].reshape(-1, 2)
                    out[b, g[:, 1]] = cells[g[:, 0]]
            NS = limits["stages"]
            for j in range(NS - 1):
                fetch(j)
            for j in range(nch):
                assert ch[j, 1] <= limits["stage_words"]
                write_back(j - 1)
                fetch(j + NS - 1)
                prog, cur = w[ch[j, 0]:ch[j, 0] + ch[j, 1]], 0
                for _ in range(int(ch[j, 2])):
                    cur += _factor_step(prog[cur:], cells)
            write_back(nch - 1)
    return out


def _apply_level(prog, fv, y, back):
    nr, wd = int(prog[0]), int(prog[1])
    rows = prog[2:2 + nr]
    tab = prog[2 + nr:2 + nr + 2 * nr * wd].reshape(nr, wd, 2)
    dia = prog[2 + nr + 2 * nr * wd:]
    for r in range(nr):
        acc = y.dtype.type(0)
        for q in range(wd):
            acc = acc + fv[tab[r, q, 0]] * y[tab[r, q, 1]]
        i = rows[r]
        y[i] = (y[i] - acc) / fv[dia[r]] if back else y[i] - acc
    return 2 + nr + 2 * nr * wd + (nr if back else 0)


def emulate_apply(plan, f, rhs, limits):
    """``csrc/ilu0_kernels.cu``'s apply on ``plan``'s program, as
    :func:`emulate_factor`."""
    w = plan["program"]["words"].astype(np.int64)
    x = np.full_like(rhs, np.nan)
    zero = np.zeros(1, f.dtype)
    for p in range(int(w[0])):
        pt = _table(w, p)
        rows = w[pt[0]:pt[0] + pt[1]]
        for b in range(rhs.shape[0]):
            y = np.concatenate([rhs[b, rows], zero])
            if plan["form"] == "staged":
                fv = np.concatenate([f[b, w[pt[2]:pt[2] + pt[3]]], zero])
                prog, cur = w[pt[4]:pt[4] + pt[5]], 0
                for L in range(int(pt[6] + pt[7])):
                    cur += _apply_level(prog[cur:], fv, y, L >= pt[6])
            else:
                assert len(rows) + 1 <= plan["on_chip"] + plan["spill"]
                nch = int(pt[2])
                ch = w[pt[3]:pt[3] + isch.FIELDS * nch].reshape(
                    -1, isch.FIELDS)
                level = 0
                for j in range(nch):
                    assert ch[j, 1] <= limits["stage_words"]
                    assert ch[j, 4] + 2 <= limits["stage_values"]
                    fv = np.concatenate([zero, zero + 1, f[b, w[
                        ch[j, 3]:ch[j, 3] + ch[j, 4]]]])
                    prog, cur = w[ch[j, 0]:ch[j, 0] + ch[j, 1]], 0
                    for _ in range(int(ch[j, 2])):
                        cur += _apply_level(prog[cur:], fv, y,
                                            level >= pt[4])
                        level += 1
            x[b, rows] = y[:-1]
    return x


PROGRAM_CASES = [(name, form) for name in
                 ("mlc_2col", "th_blocks", "wide_blocks", "th_column",
                  "comb_33", "arrow_chain") for form in FORMS] + \
    [("th_manoli2014", "staged"), ("th_manoli2014", "streamed"),
     ("th_manoli2014", "cut_rows")]


@pytest.mark.parametrize("name,form", PROGRAM_CASES,
                         ids=[f"{n}-{f}" for n, f in PROGRAM_CASES])
@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
def test_programs_walk_to_the_plain_forms(name, form, dt):
    """Each kernel program, walked in numpy as the kernel walks it, gives
    the plain factor bit for bit and the plain apply within TOL, in the
    form its limits force."""
    ilu = _ilu(name)
    s = ilu.schedule
    elem = np.dtype(dt).itemsize
    lim = h100_limits(elem, **FORMS[form])
    data, rhs = _system(ilu, 2, dt, seed=3)
    plan_f = s.plan("factor", elem, 2, lim)
    plan_a = s.plan("apply", elem, 2, lim)
    want = "staged" if form == "staged" else "streamed"
    assert plan_f["form"] == plan_a["form"] == want
    if form == "spilled":
        assert plan_a["spill"] > 0
    if form == "cut_rows" and name == "th_manoli2014":
        # rows with more pairs than a record holds go on without a divisor
        recs = [r for st in s.parts[0]["steps"]
                for r in s._step_pieces(st, lim["stage_words"] - 3)]
        assert any((r[1] < 0).any() for r in recs)
    f = emulate_factor(plan_f, data, lim)
    fp = hk.ilu0_factor_plain(torch.as_tensor(data), s).numpy()
    np.testing.assert_array_equal(f.view(np.uint8), fp.view(np.uint8))
    x = emulate_apply(plan_a, fp, rhs, lim)
    xp = hk.ilu0_apply_plain(torch.as_tensor(fp), torch.as_tensor(rhs),
                             s).numpy()
    assert np.isfinite(x).all()
    assert np.abs(x - xp).max() <= TOL[dt] * np.abs(xp).max()


def test_factor_cells_spill_where_slots_stay_live():
    """The arrow chain's side rows keep their diagonals live from the
    first step to the chain's end: the streamed factor needs about one
    cell a side row, and with fewer on chip spills the rest."""
    s = _ilu("arrow_chain").schedule
    lim = h100_limits(8, **FORMS["streamed"])
    plan = s.plan("factor", 8, 1, lim)
    assert plan["program"]["cells"] >= 40 and plan["spill"] == 0
    lim = h100_limits(8, **FORMS["spilled"])
    plan = s.plan("factor", 8, 1, lim)
    assert plan["on_chip"] == 3 and plan["spill"] == \
        plan["program"]["cells"] - 3


# ---- the rule -------------------------------------------------------------

def test_rule_lanes_follow_the_widths():
    """G: the power of two with the fewest rounds for the slowest part,
    at most a warp; a comb of 32 chains runs a warp a system, and so does
    one of 33 (two rounds a level); a narrow sparsity (no step or level
    over 32 items) the next power of two over its widest but at least
    MIN_LANES, several systems a warp."""
    comb32 = tig.BatchedILU0(*_comb(32, 40)).schedule
    comb33 = _ilu("comb_33").schedule
    for s in (comb32, comb33):
        assert s.lanes("apply") == s.lanes("factor") == isch.WARP
    for name in ("th_column", "th_blocks", "th_manoli2014", "mlc_2col"):
        s = _ilu(name).schedule
        widest = max(max(w, default=1) for w in s.widths("factor"))
        assert s.lanes("factor") == max(isch.MIN_LANES,
                                        1 << (widest - 1).bit_length())
    # the MLC's merged single rows make a wide level, but the 260-row
    # columns decide: a warp
    assert _ilu("mlc_8col").schedule.lanes("apply") == 32


def test_rule_staged_systems_and_limits():
    """The staged form while the largest part's program and one system's
    values fit; its systems a block within the block's shared memory and
    the batch; a batch that does not divide the systems a block runs a
    short last block; streamed past the limit."""
    s = _ilu("th_column").schedule
    for B in (1, 7, 8192):
        for elem in (4, 8):
            lim = h100_limits(elem)
            plan = s.plan("factor", elem, B, lim)
            assert plan["form"] == "staged" and 1 <= plan["systems"] <= B
            assert plan["smem"] <= lim["staged_bytes"]
            assert plan["blocks"] == -(-B // plan["systems"])
            assert plan["threads"] == 32 * -(-plan["systems"]
                                             // (32 // plan["lanes"]))
    plan = s.plan("factor", 8, 8192, h100_limits(8))
    need = plan["smem"] - (plan["systems"] - 1) * plan["program"][
        "stride"] * 8
    lim = h100_limits(8, staged_bytes=need)
    assert s.plan("factor", 8, 3, lim)["form"] == "staged"
    lim = h100_limits(8, staged_bytes=need - 1)
    assert s.plan("factor", 8, 3, lim)["form"] == "streamed"


# ---- the library yardstick ------------------------------------------------

@pytest.mark.parametrize("name", ["th_column", "mlc_2col", "th_manoli2014"])
@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
def test_triangular_solve_is_the_apply(name, dt):
    """``chip_smoke.py`` (y)'s library yardstick for the apply, two
    ``torch.triangular_solve`` calls on the block-diagonal CSR of the
    systems' L and U (cuSPARSE on a card), is the plain apply."""
    import chip_smoke
    ilu = _ilu(name)
    data, b = (torch.as_tensor(a) for a in _system(ilu, 3, dt, seed=5))
    f = hk.ilu0_factor_plain(data, ilu.schedule)
    L, U = chip_smoke.ilu_triangular_csr(torch, f, ilu)
    x = chip_smoke.ilu_library_apply(torch, L, U, b)
    xp = hk.ilu0_apply_plain(f, b, ilu.schedule)
    tol = 1e-12 if dt == np.float64 else 1e-5
    assert float((x - xp).abs().max()) <= tol * float(xp.abs().max())


# ---- on the card ----------------------------------------------------------

def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


#: per form: the sparsity (a name, or the arrow chain of this many side
#: rows, for 4 / 8 byte values), B and the form each kernel's plan must
#: take; the arrow chain of 3000 side rows streams with nothing spilled
#: and its root row cut into pieces, that of 51000 / 26000 spills
GPU_FORMS = {
    "warp_a_system": ("th_manoli2014", 2, "staged"),
    "systems_a_warp": ("th_column", 64, "staged"),
    "warp_rounds": ("comb_33", 3, "staged"),
    "batch_not_dividing": ("th_column", 1001, "staged"),
    "many_parts": ("mlc_8col", 5, "staged"),
    "streamed": ({4: 3000, 8: 3000}, 2, "streamed"),
    "streamed_spilled": ({4: 51000, 8: 26000}, 2, "streamed"),
}


def _plans_on_gpu(ilu, B, dt):
    """The two kernels' plans on the card; the library's limits are the
    ones the CPU tests assume."""
    elem = np.dtype(dt).itemsize
    lim = hk.ilu0_limits(getattr(torch, np.dtype(dt).name))
    assert lim == h100_limits(elem)
    return [ilu.schedule.plan(k, elem, B, lim) for k in ("factor", "apply")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GPU_FORMS))
@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
def test_kernel_forms_on_gpu(case, dt):
    """On the card (``python -m pytest -m cuda tests/``): each form's
    kernels against their plain forms (:func:`_holds_on_gpu`)."""
    _needs_gpu()
    name, B, form = GPU_FORMS[case]
    ilu = _ilu(name) if isinstance(name, str) else \
        tig.BatchedILU0(*_arrow_chain(name[np.dtype(dt).itemsize]))
    plans = _plans_on_gpu(ilu, B, dt)
    assert all(p["form"] == form for p in plans)
    if case == "systems_a_warp":
        assert plans[0]["lanes"] < 32 and plans[0]["systems"] > 1
    if case == "warp_rounds":
        assert plans[1]["lanes"] == 32
    if case == "batch_not_dividing":
        assert all(B % p["systems"] for p in plans)
    if case == "streamed":
        assert all(p["spill"] == 0 for p in plans)
    if case == "streamed_spilled":
        assert all(p["spill"] > 0 for p in plans)
    _holds_on_gpu(ilu, B, dt)


@pytest.mark.cuda
@pytest.mark.parametrize("side", [3000, 12000, 26000])
@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
def test_streamed_arrow_chains_on_gpu(side, dt):
    """The streamed forms on arrow chains from nothing spilled (3000
    side rows) to the f64 factor's cells spilled (26000), each root row
    wider than a ring stage."""
    _needs_gpu()
    ilu = tig.BatchedILU0(*_arrow_chain(side))
    assert all(p["form"] == "streamed" for p in _plans_on_gpu(ilu, 2, dt))
    _holds_on_gpu(ilu, 2, dt)


def _holds_on_gpu(ilu, B, dt):
    """The kernels on the card against their plain forms on random
    systems: the factor bit for bit, the apply within 1e-12 / 1e-5, one
    launch each."""
    s = ilu.schedule
    data, b = (torch.as_tensor(a, device="cuda")
               for a in _system(ilu, B, dt, seed=B))
    hk.reset_launches()
    f = ilu.factor(data)
    x = ilu.solve(f, b)
    assert hk.LAUNCHES["ilu0_factor"] == hk.LAUNCHES["ilu0_apply"] == 1
    assert torch.equal(f, hk.ilu0_factor_plain(data, s))
    xp = hk.ilu0_apply_plain(f, b, s)
    tol = 1e-12 if dt == np.float64 else 1e-5
    assert float((x - xp).abs().max()) <= tol * float(xp.abs().max())
    hk.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("dt", DTYPES, ids=DT_IDS)
def test_triangular_solve_on_gpu(dt):
    """The library yardstick on the card (cuSPARSE) against the kernels'
    apply at (q)'s kind of shape."""
    _needs_gpu()
    import chip_smoke
    ilu = _ilu("th_column")
    data, b = (torch.as_tensor(a, device="cuda")
               for a in _system(ilu, 64, dt, seed=9))
    f = ilu.factor(data)
    L, U = chip_smoke.ilu_triangular_csr(torch, f, ilu)
    x = chip_smoke.ilu_library_apply(torch, L, U, b)
    xk = ilu.solve(f, b)
    tol = 1e-12 if dt == np.float64 else 1e-5
    assert float((x - xk).abs().max()) <= tol * float(xk.abs().max())

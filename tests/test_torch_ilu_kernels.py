"""The ILU(0) factor and apply of the port (``hopper_kernels.ilu0_factor`` /
``ilu0_apply`` through ``batched/ilu_gmres.BatchedILU0``; on the CPU their
plain forms) against the JAX package's ``lax.scan`` form and a scalar
reference, on the sparsities of the solver paths: a 2x2-block TH column
(nx 16), celia1990's tridiagonal column (nz 100), a 7-point 3-D MMS grid
(4 x 4 x 4) and the th_manoli2014 network at scale 1.

Tolerances, relative to the largest entry of the reference:
- the factor equals, bit for bit, a scalar IKJ loop that rounds every
  operation on its own (m = f_ik / f_kk, then f_ij - (m f_kj)): the
  arithmetic the CUDA kernel repeats.  Against JAX it is held at 1e-13
  (f64) / 1e-5 (f32): XLA's CPU backend contracts m f_kj and the
  subtraction into a fused multiply-add, so the two differ in the last bit
  here and there (up to 9e-16 absolute on these systems);
- the apply, on the same factor values, within 1e-13 (f64) / 1e-5 (f32):
  both sum each padded row of products, in orders that may differ.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpp_tpu.batched import ilu_gmres as jig
from mpp_tpu_torch.batched import ilu_gmres as tig
from mpp_tpu_torch.ops import hopper_kernels as hk
from mpp_tpu_torch.ops.sparse import csr_template

TOL = {np.float64: 1e-13, np.float32: 1e-5}


def _block_column(nx=16):
    """The TH column: 2x2 blocks (P, T interleaved), each cell coupled to
    its neighbours above and below."""
    r, c = [], []
    for i in range(nx):
        for j in (i - 1, i, i + 1):
            if 0 <= j < nx:
                for a in range(2):
                    for b in range(2):
                        r.append(2 * i + a)
                        c.append(2 * j + b)
    return np.array(r), np.array(c)


def _stencil(dims):
    """The nearest-neighbour stencil on a natural-ordered grid, diagonal
    included (3-D: the 7-point stencil)."""
    ids = np.arange(int(np.prod(dims))).reshape(dims[::-1])
    r, c = [ids.ravel()], [ids.ravel()]
    for ax in range(len(dims)):
        a = np.take(ids, range(ids.shape[ax] - 1), axis=ax).ravel()
        b = np.take(ids, range(1, ids.shape[ax]), axis=ax).ravel()
        r += [a, b]
        c += [b, a]
    return np.concatenate(r), np.concatenate(c)


def _manoli():
    from mpp_tpu_torch.problems import th_manoli2014 as tm
    soe = tm.build_th_manoli2014(scale=1, device="cpu").soe
    soe._build_jac_plan()
    tpl = soe._jac_plan["tpl"]
    return tpl.row_ids(), tpl.indices


SPARSITIES = {"th_column": _block_column,
              "celia_tridiagonal": lambda: _stencil((100,)),
              "mms_3d": lambda: _stencil((4, 4, 4)),
              "th_manoli2014": _manoli}
_TEMPLATES = {}


def _template(name):
    if name not in _TEMPLATES:
        r, c = SPARSITIES[name]()
        n = int(r.max()) + 1
        _TEMPLATES[name] = csr_template(n, n, r, c)
    return _TEMPLATES[name]


def _system(name, B, np_dtype, seed):
    """(template, data [B, nnz], b [B, n]): off-diagonals in [-1, -0.05),
    diagonals 1.05-2 times the row's off-diagonal sum, unsymmetric."""
    t = _template(name)
    rows = t.row_ids()
    rng = np.random.default_rng(seed)
    data = -rng.uniform(0.05, 1.0, (B, t.nnz))
    off = rows != t.indices
    dsum = np.zeros((B, t.n_rows))
    np.add.at(dsum.T, rows[off], -data[:, off].T)
    diag = ~off
    data[:, diag] = dsum[:, rows[diag]] * rng.uniform(1.05, 2.0,
                                                      (B, t.n_rows))
    b = rng.standard_normal((B, t.n_rows))
    return t, data.astype(np_dtype), b.astype(np_dtype)


def _scalar_ikj(indptr, indices, data):
    """PETSc's row loop of ILU(0) (IKJ, levels 0), one scalar at a time in
    the data's precision: every operation rounded on its own."""
    f = data.copy()
    n = len(indptr) - 1
    for g in f:
        for i in range(n):
            lo, hi = indptr[i], indptr[i + 1]
            for p in range(lo, hi):
                k = indices[p]
                if k >= i:
                    break
                kc = indices[indptr[k]:indptr[k + 1]]
                m = g[p] / g[indptr[k] + np.searchsorted(kc, k)]
                g[p] = m
                for q in range(p + 1, hi):
                    r = np.searchsorted(kc, indices[q])
                    if r < len(kc) and kc[r] == indices[q]:
                        g[q] = g[q] - m * g[indptr[k] + r]
    return f


CASES = [(name, B, np_dtype) for name in SPARSITIES for B in (1, 3)
         for np_dtype in (np.float64, np.float32)]
IDS = [f"{n}-B{B}-{d.__name__}" for n, B, d in CASES]


@pytest.mark.parametrize("name,B,np_dtype", CASES, ids=IDS)
def test_factor_is_the_scalar_ikj_bit_for_bit(name, B, np_dtype):
    t, data, _ = _system(name, B, np_dtype, seed=B)
    it = tig.BatchedILU0(t.indptr, t.indices)
    got = it.factor(torch.as_tensor(data)).numpy()
    ref = _scalar_ikj(t.indptr, t.indices, data)
    assert got.dtype == np_dtype
    np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


@pytest.mark.parametrize("name,B,np_dtype", CASES, ids=IDS)
def test_factor_and_apply_match_jax(name, B, np_dtype):
    t, data, b = _system(name, B, np_dtype, seed=10 + B)
    tol = TOL[np_dtype]
    ij = jig.BatchedILU0(t.indptr, t.indices)
    it = tig.BatchedILU0(t.indptr, t.indices)
    fj = np.array(ij.factor(jnp.asarray(data)))
    ft = it.factor(torch.as_tensor(data)).numpy()
    assert ft.dtype == fj.dtype == np_dtype
    assert np.abs(ft - fj).max() <= tol * np.abs(fj).max()
    xj = np.asarray(ij.solve(jnp.asarray(fj), jnp.asarray(b)))
    xt = it.solve(torch.as_tensor(fj), torch.as_tensor(b)).numpy()
    assert xt.dtype == np_dtype and xt.shape == b.shape
    assert np.isfinite(xt).all()
    assert np.abs(xt - xj).max() <= tol * np.abs(xj).max()


def _lower_pairs(t, i):
    """The IKJ work of row i: [(slot ik, slot kk, [(slot ij, slot kj)])]."""
    ip, ix = t.indptr, t.indices
    out = []
    for p in range(ip[i], ip[i + 1]):
        k = ix[p]
        if k >= i:
            break
        kc = ix[ip[k]:ip[k + 1]]
        pairs = [(q, ip[k] + np.searchsorted(kc, ix[q]))
                 for q in range(p + 1, ip[i + 1])
                 if ix[q] in kc and ix[q] > k]
        out.append((p, ip[k] + np.searchsorted(kc, k), pairs))
    return out


@pytest.mark.parametrize("name", sorted(SPARSITIES))
def test_schedule_covers_every_step_and_level_once(name):
    """The flattened offsets cover every IKJ step, pair and sweep row
    exactly once, in an order that respects every dependency."""
    t = _template(name)
    n, nnz = t.n_rows, t.nnz
    it = tig.BatchedILU0(t.indptr, t.indices)
    s = it.schedule
    lp, ld, pij, pik, pkj = (a.numpy() for a in s.sections(
        "cpu", "factor", "lp", "ld", "pij", "pik", "pkj"))
    lp_ptr, pair_ptr = s.ptrs["lp_ptr"], s.ptrs["pair_ptr"]
    assert s.factor[0] == len(lp_ptr) - 1 == len(pair_ptr) - 1
    for ptr, arr in ((lp_ptr, lp), (pair_ptr, pij)):
        assert ptr[0] == 0 and ptr[-1] == len(arr)
        assert all(a <= b for a, b in zip(ptr, ptr[1:]))
    # every (ik, kk) step once, every (ij, ik, kj) pair once, each pair in
    # the step of its multiplier
    want_steps, want_pairs = set(), set()
    for i in range(n):
        for p, dk, pairs in _lower_pairs(t, i):
            want_steps.add((p, dk))
            want_pairs.update((q, p, qk) for q, qk in pairs)
    got_steps = list(zip(lp.tolist(), ld.tolist()))
    got_pairs = list(zip(pij.tolist(), pik.tolist(), pkj.tolist()))
    assert sorted(got_steps) == sorted(want_steps)
    assert sorted(got_pairs) == sorted(want_pairs)
    step_of = np.repeat(np.arange(len(lp_ptr) - 1), np.diff(lp_ptr))
    pair_step = np.repeat(np.arange(len(pair_ptr) - 1), np.diff(pair_ptr))
    where = dict(zip(lp.tolist(), step_of.tolist()))
    assert all(where[p] == st for p, st in zip(pik.tolist(), pair_step))
    # a slot is final before a later step reads it: a pivot or f_kj is
    # written in an earlier step only, a multiplier's slot updated by the
    # pairs of earlier steps only
    last_write, pair_write = {}, {}
    for st in range(len(lp_ptr) - 1):
        for q in lp[lp_ptr[st]:lp_ptr[st + 1]].tolist():
            last_write[q] = st
        for q in pij[pair_ptr[st]:pair_ptr[st + 1]].tolist():
            last_write[q] = pair_write[q] = st
    for st, p, d in zip(step_of, lp.tolist(), ld.tolist()):
        assert last_write.get(d, -1) < st and pair_write.get(p, -1) < st
    for st, q in zip(pair_step, pkj.tolist()):
        assert last_write.get(q, -1) < st
    # the sweeps: the forward one takes every row with a lower entry once,
    # the back one every row once, each after the rows it reads
    lower = [t.indices[t.indptr[i]:t.indptr[i + 1]] for i in range(n)]
    for tag, rows_want, deps in (
            ("f_", {i for i in range(n) if (lower[i] < i).any()},
             lambda i: lower[i][lower[i] < i]),
            ("b_", set(range(n)), lambda i: lower[i][lower[i] > i])):
        rows, pos, col = (a.numpy() for a in s.sections(
            "cpu", "apply", tag + "rows", tag + "pos", tag + "col"))
        row_ptr, tab_ptr = s.ptrs[tag + "row_ptr"], s.ptrs[tag + "tab_ptr"]
        widths = s.ptrs[tag + "width"]
        assert row_ptr[0] == 0 and row_ptr[-1] == len(rows)
        assert tab_ptr[0] == 0 and tab_ptr[-1] == len(pos) == len(col)
        assert sorted(rows.tolist()) == sorted(rows_want)
        level = {}
        for L, w in enumerate(widths):
            assert tab_ptr[L + 1] - tab_ptr[L] == (row_ptr[L + 1]
                                                   - row_ptr[L]) * w
            tab_p = pos[tab_ptr[L]:tab_ptr[L + 1]].reshape(-1, w)
            tab_c = col[tab_ptr[L]:tab_ptr[L + 1]].reshape(-1, w)
            for i, ps, cs in zip(rows[row_ptr[L]:row_ptr[L + 1]], tab_p,
                                 tab_c):
                level[int(i)] = L
                d = deps(i)
                assert cs[:len(d)].tolist() == d.tolist()
                assert (cs[len(d):] == n).all() and (ps[len(d):] == nnz).all()
                assert (t.indices[ps[:len(d)]] == d).all()
        for i in rows_want:
            assert all(level.get(int(j), -1) < level[i] for j in deps(i))
    dpos = s.sections("cpu", "apply", "dpos")[0].numpy()
    b_rows = s.sections("cpu", "apply", "b_rows")[0].numpy()
    assert (dpos == it.diag_pos[b_rows]).all()


def test_cpu_runs_the_plain_forms():
    """On CPU tensors BatchedILU0 runs the plain forms: no launch, no card
    call counted, the plain functions' results."""
    t, data, b = _system("mms_3d", 3, np.float64, seed=5)
    it = tig.BatchedILU0(t.indptr, t.indices)
    hk.reset_launches()
    before = dict(tig.CARD_CALLS)
    d, bb = torch.as_tensor(data), torch.as_tensor(b)
    f = it.factor(d)
    x = it.solve(f, bb)
    assert not any(hk.LAUNCHES.values()) and tig.CARD_CALLS == before
    assert (it.factors, it.applies) == (1, 1)
    assert torch.equal(f, hk.ilu0_factor_plain(d, it.schedule))
    assert torch.equal(x, hk.ilu0_apply_plain(f, bb, it.schedule))
    # one system without a batch axis, as ops/ilu.ILU0 passes it
    np.testing.assert_array_equal(it.solve(f[1], bb[1]).numpy(),
                                  x[1].numpy())


def _bad_calls():
    t, data, b = _system("th_column", 2, np.float64, seed=2)
    s = tig.BatchedILU0(t.indptr, t.indices).schedule
    d, bb = torch.as_tensor(data), torch.as_tensor(b)
    f = hk.ilu0_factor(d, s)
    wide = torch.zeros(2, 2 * t.nnz, dtype=torch.float64)
    return {
        "factor_int_dtype": lambda: hk.ilu0_factor(d.long(), s),
        "factor_f16": lambda: hk.ilu0_factor(d.half(), s),
        "factor_1d": lambda: hk.ilu0_factor(d[0], s),
        "factor_wrong_nnz": lambda: hk.ilu0_factor(d[:, 1:], s),
        "factor_not_contiguous": lambda: hk.ilu0_factor(wide[:, ::2], s),
        "factor_not_a_schedule": lambda: hk.ilu0_factor(d, None),
        "apply_mixed_dtypes": lambda: hk.ilu0_apply(f, bb.float(), s),
        "apply_wrong_n": lambda: hk.ilu0_apply(f, bb[:, 1:], s),
        "apply_batch_mismatch": lambda: hk.ilu0_apply(f, bb[:1], s),
        "apply_not_contiguous": lambda: hk.ilu0_apply(f, bb.t().contiguous()
                                                      .t(), s),
        "apply_int_dtype": lambda: hk.ilu0_apply(f.long(), bb.long(), s),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_wrappers_refuse_what_the_kernels_do_not_take(case):
    with pytest.raises(ValueError):
        _bad_calls()[case]()


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
def test_kernels_match_plain_on_gpu(np_dtype):
    """On the card (``python -m pytest -m cuda tests/``): the factor bit for
    bit and the apply within TOL against their plain forms, on every
    sparsity at 1 and 300 systems, and on block-diagonal 2x2 systems whose
    levels hold more rows than a block's threads; one launch each."""
    _needs_gpu()
    tol = TOL[np_dtype]
    blocks = np.arange(2400)            # 600 diagonal 2x2 blocks
    wide = csr_template(1200, 1200, 2 * (blocks // 4) + (blocks % 4) // 2,
                        2 * (blocks // 4) + blocks % 2)
    for name in list(SPARSITIES) + ["wide"]:
        for B in (1, 300):
            if name == "wide":
                t = wide
                rng = np.random.default_rng(B)
                data = rng.uniform(-1, 1, (B, t.nnz))
                data[:, t.row_ids() == t.indices] += 4.0
                data = data.astype(np_dtype)
                b = rng.standard_normal((B, t.n_rows)).astype(np_dtype)
            else:
                t, data, b = _system(name, B, np_dtype, seed=B)
            it = tig.BatchedILU0(t.indptr, t.indices)
            d = torch.as_tensor(data, device="cuda")
            bb = torch.as_tensor(b, device="cuda")
            hk.reset_launches()
            f = it.factor(d)
            x = it.solve(f, bb)
            assert hk.LAUNCHES["ilu0_factor"] == hk.LAUNCHES["ilu0_apply"] \
                == 1
            fp = hk.ilu0_factor_plain(d, it.schedule)
            xp = hk.ilu0_apply_plain(f, bb, it.schedule)
            assert torch.equal(f, fp)
            assert float((x - xp).abs().max()) <= tol * float(
                xp.abs().max())
    hk.reset_launches()

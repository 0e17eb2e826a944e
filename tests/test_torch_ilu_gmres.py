"""The port's batched ILU(0) + GMRES(30) (batched/ilu_gmres.py) and its
one-system API (ops/ilu.py) against the JAX package.

Inputs are random diagonally dominant CSR systems (numpy seeds) on three
sparsities: a 2-D 5-point stencil, a 3-D 7-point stencil and a SPAC-like
tree (a hub row and column coupled to every leaf, leaves to a soil
chain).  Tolerances, f64: the factor and the preconditioner apply at rtol
1e-12 (the same arithmetic per row; only the padded-width sums may
associate differently); GMRES solutions at rtol 1e-10 with equal cycle
counts and convergence masks (the Gram-Schmidt contractions associate
differently from XLA's, at rounding level).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpp_tpu.batched import ilu_gmres as jig
from mpp_tpu.ops import ilu as jilu
from mpp_tpu_torch.batched import ilu_gmres as tig
from mpp_tpu_torch.ops import ilu as tilu
from mpp_tpu_torch.ops.sparse import csr_template


def _stencil(dims):
    """(rows, cols) of the nearest-neighbour stencil on a natural-ordered
    grid of shape ``dims`` (x fastest), diagonal included."""
    ids = np.arange(int(np.prod(dims))).reshape(dims[::-1])
    r, c = [ids.ravel()], [ids.ravel()]
    for ax in range(len(dims)):
        a = np.take(ids, range(ids.shape[ax] - 1), axis=ax).ravel()
        b = np.take(ids, range(1, ids.shape[ax]), axis=ax).ravel()
        r += [a, b]
        c += [b, a]
    return np.concatenate(r), np.concatenate(c)


def _tree(nleaf=12, nsoil=10):
    """Leaf (0) - hub (1) - nleaf roots, each root coupled to one soil
    cell of a soil chain (the vsfm_spac_campbell network shape)."""
    n0 = 2 + nleaf
    n = n0 + nsoil
    e = [(0, 1)] + [(1, 2 + k) for k in range(nleaf)] \
        + [(2 + k, n0 + k % nsoil) for k in range(nleaf)] \
        + [(n0 + k, n0 + k + 1) for k in range(nsoil - 1)]
    e = np.array(e)
    d = np.arange(n)
    return (np.concatenate([d, e[:, 0], e[:, 1]]),
            np.concatenate([d, e[:, 1], e[:, 0]]))


SPARSITIES = {"2d": lambda: _stencil((7, 6)),
              "3d": lambda: _stencil((4, 3, 5)),
              "tree": _tree}


def _system(name, ncol, seed):
    """(template, data [ncol, nnz], b [ncol, n]): random off-diagonals in
    [-1, 0), diagonals 1.05-2 times the row's off-diagonal sum (M-matrix
    like, as the steppers' Jacobians), unsymmetric."""
    r, c = SPARSITIES[name]()
    n = int(r.max()) + 1
    t = csr_template(n, n, r, c)
    rows = t.row_ids()
    rng = np.random.default_rng(seed)
    data = -rng.uniform(0.05, 1.0, (ncol, t.nnz))
    off = rows != t.indices
    dsum = np.zeros((ncol, n))
    np.add.at(dsum.T, rows[off], -data[:, off].T)
    diag = ~off
    data[:, diag] = dsum[:, rows[diag]] * rng.uniform(1.05, 2.0,
                                                      (ncol, n))
    b = rng.standard_normal((ncol, n))
    return t, data, b


@pytest.mark.parametrize("name", sorted(SPARSITIES))
def test_factor_and_solve_match_jax(name):
    t, data, b = _system(name, 5, seed=len(name))
    ij = jig.BatchedILU0(t.indptr, t.indices)
    it = tig.BatchedILU0(t.indptr, t.indices)
    assert (it.maxL, it.maxP) == (ij.maxL, ij.maxP)
    assert it.levels_fwd < t.n_rows           # the level schedule bites
    fj = np.asarray(ij.factor(jnp.asarray(data)))
    ft = it.factor(torch.as_tensor(data))
    np.testing.assert_allclose(ft.numpy(), fj, rtol=1e-12, atol=0)
    xj = np.asarray(ij.solve(jnp.asarray(fj), jnp.asarray(b)))
    xt = it.solve(ft, torch.as_tensor(b))
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-12, atol=0)
    # the prepared form applies the same preconditioner
    np.testing.assert_array_equal(it.solve(it.prepare(ft),
                                           torch.as_tensor(b)).numpy(),
                                  xt.numpy())


@pytest.mark.parametrize("restart", [30, 4])
@pytest.mark.parametrize("name", sorted(SPARSITIES))
def test_gmres_matches_jax(name, restart):
    """Restart 30 (one cycle) and 4 (several cycles); the columns' scales
    differ so they converge in different cycles."""
    t, data, b = _system(name, 6, seed=7 + len(name))
    data[::2] *= np.linspace(1.0, 3.0, t.nnz)   # different spectra
    ij = jig.BatchedILU0(t.indptr, t.indices)
    it = tig.BatchedILU0(t.indptr, t.indices)
    mj = jig.make_ell_matvec(t.indptr, t.indices)
    mt = tig.make_ell_matvec(t.indptr, t.indices)
    dj, bj = jnp.asarray(data), jnp.asarray(b)
    dt_, bt = torch.as_tensor(data), torch.as_tensor(b)
    xj, kj, cj = jig.petsc_gmres_batched(mj, dj, bj, ilu=ij,
                                         pc_data=ij.factor(dj),
                                         restart=restart, rtol=1e-8)
    syncs = []
    xt, kt, ct = tig.petsc_gmres_batched(
        mt, dt_, bt, ilu=it, pc_data=it.factor(dt_), restart=restart,
        rtol=1e-8, sync=lambda v: syncs.append(1) or bool(v))
    assert kt == int(kj) and len(syncs) >= kt
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert bool(ct.all())
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10,
                               atol=1e-12 * np.abs(np.asarray(xj)).max())
    if restart == 4:
        assert kt > 1
        # columns finish in different cycles
        _, _, _, its = tig.gmres_cycles(mt, dt_, bt, ilu=it,
                                        pc_data=it.factor(dt_), restart=4,
                                        rtol=1e-8)
        assert len(set(its.tolist())) > 1
    # the residual of the preconditioned system meets the tolerance
    # (an unpreconditioned solve as a cross-check of the same x)
    r = bt - mt(dt_, xt)
    assert float((r.norm(dim=1) / bt.norm(dim=1)).max()) < 1e-5


def test_done_columns_do_not_hold_the_arnoldi_loop():
    """Restart 4, six columns converging in different cycles.  A column
    done in an earlier cycle keeps its x whatever a later cycle computes
    for it, so neither its later residual nor its later Arnoldi steps may
    change the result or the work.  The run is repeated with the explicit
    residual of each done column read 1e6 x off in every later cycle (the
    operator adds a vector to x's image, never to a Krylov vector's), so
    such a column never converges again: x, cycles, the mask and the host
    syncs and Arnoldi steps equal the unperturbed run's, and x equals
    JAX's at rtol 1e-10."""
    t, data, b = _system("2d", 6, seed=13)
    # diagonals 1-30 times stronger: the columns finish in cycles 1-3
    data[:, t.row_ids() == t.indices] *= np.array(
        [1.0, 1.02, 1.3, 2.0, 4.0, 30.0])[:, None]
    it = tig.BatchedILU0(t.indptr, t.indices)
    mt = tig.make_ell_matvec(t.indptr, t.indices)
    dt_, bt = torch.as_tensor(data), torch.as_tensor(b)
    off = torch.as_tensor(np.random.default_rng(1).standard_normal(b.shape)
                          * 1e6 * np.abs(b).max())
    gm = dict(ilu=it, pc_data=it.factor(dt_), restart=4, rtol=1e-10)
    # the columns done after c cycles, c = 0, 1, ...
    done_after = [tig.gmres_cycles(mt, dt_, bt, maxcycles=c, **gm)[2]
                  for c in range(8)]

    def run(perturb):
        work = dict(syncs=0, arnoldi=0, residuals=0)

        def matvec(d, v):
            y = mt(d, v)
            if v._base is not None:           # a Krylov vector, V[:, j]
                work["arnoldi"] += 1
                return y
            # the explicit residual of x at the start of cycle c
            c = work["residuals"]
            work["residuals"] += 1
            if perturb:
                y = y + torch.where(done_after[c][:, None], off, 0.0)
            return y

        def sync(v):
            work["syncs"] += 1
            return bool(v)

        x, k, conv, its = tig.gmres_cycles(matvec, dt_, bt, sync=sync, **gm)
        return x, k, conv, its, work

    x0, k0, c0, its0, w0 = run(False)
    x1, k1, c1, its1, w1 = run(True)
    assert k0 > 2 and len(set(its0.tolist())) > 2 and bool(c0.all())
    assert k0 < len(done_after) and bool(done_after[k0 - 1].any())
    assert w1["residuals"] == w0["residuals"] == k0
    assert (k1, w1) == (k0, w0)
    np.testing.assert_array_equal(x1.numpy(), x0.numpy())
    np.testing.assert_array_equal(c1.numpy(), c0.numpy())
    np.testing.assert_array_equal(its1.numpy(), its0.numpy())
    ij = jig.BatchedILU0(t.indptr, t.indices)
    dj = jnp.asarray(data)
    xj, kj, cj = jig.petsc_gmres_batched(
        jig.make_ell_matvec(t.indptr, t.indices), dj, jnp.asarray(b),
        ilu=ij, pc_data=ij.factor(dj), restart=4, rtol=1e-10)
    assert int(kj) == k0
    np.testing.assert_allclose(x0.numpy(), np.asarray(xj), rtol=1e-10,
                               atol=1e-12 * np.abs(np.asarray(xj)).max())


def test_gmres_without_preconditioner_matches_jax():
    t, data, b = _system("2d", 3, seed=3)
    mj = jig.make_ell_matvec(t.indptr, t.indices)
    mt = tig.make_ell_matvec(t.indptr, t.indices)
    xj, kj, cj = jig.petsc_gmres_batched(mj, jnp.asarray(data),
                                         jnp.asarray(b), restart=10)
    xt, kt, ct = tig.petsc_gmres_batched(mt, torch.as_tensor(data),
                                         torch.as_tensor(b), restart=10)
    assert kt == int(kj)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-10,
                               atol=1e-12 * np.abs(np.asarray(xj)).max())


def test_gmres_reports_non_convergence():
    """tests/test_th_compiled.py:99-125's case: a tolerance GMRES cannot
    meet within its cycle budget reports non-convergence."""
    t, _, _ = _system("tree", 1, seed=0)
    rng = np.random.default_rng(0)
    data = rng.random((1, t.nnz)) + 0.1
    mt = tig.make_ell_matvec(t.indptr, t.indices)
    mj = jig.make_ell_matvec(t.indptr, t.indices)
    b = np.ones((1, t.n_rows))
    xt, kt, ct = tig.petsc_gmres_batched(mt, torch.as_tensor(data),
                                         torch.as_tensor(b), rtol=1e-300,
                                         atol=0.0, maxcycles=1)
    xj, kj, cj = jig.petsc_gmres_batched(mj, jnp.asarray(data),
                                         jnp.asarray(b), rtol=1e-300,
                                         atol=0.0, maxcycles=1)
    assert not bool(ct[0]) and not bool(cj[0]) and kt == int(kj) == 1
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-9)


@pytest.mark.parametrize("restart", [30, 5])
@pytest.mark.parametrize("name", ["3d", "tree"])
def test_serial_petsc_gmres_matches_jax_numpy(name, restart):
    """ops/ilu.petsc_gmres (one column over the batched engine, tensors)
    against the JAX package's numpy petsc_gmres: equal inner iterations
    and convergence, x at rtol 1e-10; ILU0 and csr_matvec alike."""
    t, data, b = _system(name, 1, seed=11)
    data, b = data[0], b[0]
    pj = jilu.ILU0(t.indptr, t.indices)
    pt = tilu.ILU0(t.indptr, t.indices)
    lj = pj.factor(data)
    lt = pt.factor(torch.as_tensor(data))
    np.testing.assert_allclose(lt.numpy(), lj, rtol=1e-12)
    np.testing.assert_allclose(pt.solve(lt, torch.as_tensor(b)).numpy(),
                               pj.solve(lj, b), rtol=1e-12)
    np.testing.assert_allclose(
        tilu.csr_matvec(t.indptr, t.indices, torch.as_tensor(data),
                        torch.as_tensor(b)).numpy(),
        jilu.csr_matvec(t.indptr, t.indices, data, b), rtol=1e-14)
    xj, itj, cj = jilu.petsc_gmres(t.indptr, t.indices, data, b, pc=pj,
                                   pc_data=lj, restart=restart, rtol=1e-9)
    xt, itt, ct = tilu.petsc_gmres(t.indptr, t.indices,
                                   torch.as_tensor(data), torch.as_tensor(b),
                                   pc=pt, pc_data=lt, restart=restart,
                                   rtol=1e-9)
    assert (itt, ct) == (itj, cj) and ct
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-10,
                               atol=1e-12 * np.abs(xj).max())
    m = tilu.CSRMatrix(t.n_rows, t.indptr, t.indices, data)
    np.testing.assert_allclose(m.matvec(xt).numpy(),
                               jilu.CSRMatrix(t.n_rows, t.indptr, t.indices,
                                              data).matvec(xj), rtol=1e-9)

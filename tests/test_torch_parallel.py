"""Column parallelism of the PyTorch port in one process
(mpp_tpu_torch/parallel/*, the ALM ``ugrid=`` path) against the JAX
package, on the CPU in f64.

* ``process_local_slice`` and ``initialize_distributed``'s
  single-process no-op; a 1-rank gloo group (FileStore under
  ``tmp_path``, 30 s timeout): the ColumnGroup, ``shard_columns`` and the
  clamped 1-D halo;
* ``UGrid.partition``: every UGDM array equal to JAX's element for
  element, at 1, 2, 4 and 8 parts, with and without a petsc permutation
  (the grids of tests/test_ugrid.py:24,55); the orderings' round trip;
* ``UGDM.lateral_darcy_source`` at world size 1 against JAX's
  ``lateral_darcy_source_global`` within rtol 1e-12;
* the ALM ``ugrid=`` step in one process against JAX's 1-device UGDM
  path on tests/test_alm.py:280's 4 x 4 x 12 case: equal attempts and
  Newton iterations, the state within rtol 1e-9 and ``qflx_lateral``
  within 1e-9 of its largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpp_tpu.driver import alm as jalm
from mpp_tpu.parallel import ugrid as jug
from mpp_tpu_torch.driver import alm as talm
from mpp_tpu_torch.parallel import distributed as tdist
from mpp_tpu_torch.parallel import sharding as tsh
from mpp_tpu_torch.parallel import ugrid as tug

FIELDS = ("own_global_nat", "own_mask", "export_idx", "ghost_src", "edge_a",
          "edge_b", "edge_w", "edge_mask", "nat2petsc", "petsc2nat",
          "edge_dist_a", "edge_dist_b", "edge_area", "edge_dzc")


def test_process_local_slice_partition():
    n, parts = 103, 8
    spans = [tdist.process_local_slice(n, parts, i) for i in range(parts)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    for (a, b), (c, d) in zip(spans, spans[1:]):
        assert b == c
    sizes = [b - a for a, b in spans]
    assert max(sizes) - min(sizes) <= 1


def test_single_process_group(monkeypatch, tmp_path):
    import torch.distributed as dist
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert tdist.initialize_distributed() is False
    with pytest.raises(RuntimeError):
        tdist.global_column_mesh()
    assert tdist.initialize_distributed(
        init_method=f"file://{tmp_path}/store", world_size=1, rank=0,
        backend="gloo", timeout_s=30.0)
    try:
        g = tsh.column_mesh()
        assert g == tdist.ColumnGroup(None, 0, 1, torch.device("cpu"))
        x = torch.as_tensor(np.arange(12.0).reshape(4, 3))
        np.testing.assert_array_equal(tsh.shard_columns(x, g), x)
        left, right = tsh.halo_exchange_1d(x, g)
        assert torch.equal(left, x[0]) and torch.equal(right, x[-1])
        src = tsh.lateral_flux_op_split(x, 2.0, g)
        ref = -2.0 * ((x - torch.cat([x[:1], x[:-1]]))
                      + (x - torch.cat([x[1:], x[-1:]])))
        assert torch.equal(src, ref)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("permuted", [False, True])
def test_partition_matches_jax(ndev, permuted):
    rng = np.random.default_rng(1)
    if permuted:
        shape, perm = (5, 5), rng.permutation(25)
    else:
        shape, perm = (6, 4), None
    jd = jug.UGrid.regular_2d(*shape).partition(ndev, petsc_order=perm)
    td = tug.UGrid.regular_2d(*shape).partition(ndev, petsc_order=perm)
    for k in ("ndev", "n_own", "n_export", "n_ghost", "n_edge"):
        assert getattr(td, k) == getattr(jd, k), k
    for k in FIELDS:
        a, b = getattr(td, k), np.array(getattr(jd, k))
        assert isinstance(a, torch.Tensor)
        assert a.dtype == torch.as_tensor(b).dtype, k
        np.testing.assert_array_equal(a.numpy(), b, err_msg=k)


def test_orderings_roundtrip_with_permutation():
    rng = np.random.default_rng(1)
    dm = tug.UGrid.regular_2d(5, 5).partition(4,
                                              petsc_order=rng.permutation(25))
    x = rng.uniform(size=(25, 2))
    np.testing.assert_array_equal(dm.sharded_to_natural(
        dm.natural_to_sharded(x)), x)
    xt = torch.as_tensor(x)
    sh = dm.natural_to_sharded(xt)
    np.testing.assert_array_equal(sh.numpy(), dm.natural_to_sharded(x))
    assert torch.equal(dm.sharded_to_natural(sh), xt)
    n2p, p2n = dm.nat2petsc.numpy(), dm.petsc2nat.numpy()
    np.testing.assert_array_equal(p2n[n2p], np.arange(25))
    with pytest.raises(ValueError):
        dm.halo_exchange(sh[:dm.n_own])        # 4 ranks need their group


def test_lateral_darcy_source_matches_jax_global():
    rng = np.random.default_rng(2)
    nz = 5
    ug_j = jug.UGrid.regular_2d(8, 4, dx=2.0, dy=1.0)
    ug_t = tug.UGrid.regular_2d(8, 4, dx=2.0, dy=1.0)
    elev = rng.uniform(0.0, 3.0, ug_j.ncol)
    for ug in (ug_j, ug_t):
        ug.edge_dist[:] = 10.0
        ug.col_elev = elev
    n = ug_t.ncol
    P = rng.uniform(3e3, 1.1e5, (n, nz))
    kr = rng.uniform(0.01, 1.0, (n, nz))
    perm = rng.uniform(1e-13, 1e-11, (n, nz))
    dz = rng.uniform(0.05, 0.3, (n, nz))
    ref = np.asarray(jug.lateral_darcy_source_global(
        ug_j, *(jnp.asarray(a) for a in (P, kr, perm, dz))))
    dm = ug_t.partition(1)
    got = dm.lateral_darcy_source(*(torch.as_tensor(a)
                                    for a in (P, kr, perm, dz)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())
    glob = tug.lateral_darcy_source_global(
        ug_t, *(torch.as_tensor(a) for a in (P, kr, perm, dz)))
    np.testing.assert_allclose(glob.numpy(), ref, rtol=1e-12, atol=0)
    assert abs(float(got.sum())) < 1e-12 * float(got.abs().sum())


def _soils(ncol, nz):
    shape = (ncol, nz)
    return dict(watsat=np.full(shape, 0.368),
                hksat=np.full(shape, 0.0070556), bsw=np.full(shape, 2.0),
                sucsat=np.full(shape, 29.772),
                residual_sat=np.full(shape, 0.2772),
                dz=np.full(shape, 0.1), area=np.ones(ncol))


def test_alm_ugrid_step_matches_jax_one_device():
    nx = ny = 4
    nz = 12
    ncol = nx * ny
    P0 = np.full((ncol, nz), 3.5355e3)
    P0[: ncol // 2] = 1.06e5
    grids = []
    for mod in (jug, tug):
        ug = mod.UGrid.regular_2d(nx, ny)
        ug.edge_dist[:] = 10.0
        ug.edge_area[:] = 10.0
        grids.append(ug)
    jp = jalm.alm_vsfm_initialize(P0=P0, lateral_connectivity=True,
                                  ugrid=grids[0], **_soils(ncol, nz))
    jo = jalm.alm_vsfm_solve(jp, 1800.0)
    tp = talm.alm_vsfm_initialize(P0=P0, lateral_connectivity=True,
                                  ugrid=grids[1], device="cpu",
                                  **_soils(ncol, nz))
    assert tp.ugdm is not None and tp.group is None
    to = talm.alm_vsfm_solve(tp, 1800.0)
    assert to["attempts"] == jo["attempts"]
    assert to["newton_iters"] == jo["newton_iters"]
    np.testing.assert_allclose(tp.P.numpy(), np.asarray(jp.P), rtol=1e-9)
    qj = np.asarray(jo["qflx_lateral"])
    qt = to["qflx_lateral"].numpy()
    np.testing.assert_allclose(qt, qj, rtol=0, atol=1e-9 * np.abs(qj).max())
    assert abs(qt.sum()) < 1e-10 * np.abs(qt).max()
    assert qt[: ncol // 2].sum() > 0.0 and qt[ncol // 2:].sum() < 0.0
    # the step's lateral source equals the natural-order reference
    P = torch.as_tensor(P0)
    src = talm._lateral_source(tp, P)
    ref = tug.lateral_darcy_source_global(
        tp.ugrid, P, talm._cell_kr(tp, P), tp.dyn[0]["perm"][..., 0],
        torch.as_tensor(tp.dz))
    np.testing.assert_allclose(src.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-12 * float(ref.abs().max()))
    with pytest.raises(ValueError, match="padding"):
        talm.alm_vsfm_initialize(P0=P0[:-1], lateral_connectivity=True,
                                 ugrid=grids[1], device="cpu",
                                 **_soils(ncol - 1, nz))

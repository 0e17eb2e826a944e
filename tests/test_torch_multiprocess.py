"""Column parallelism of the PyTorch port across real processes: gloo ranks
on the CPU (``torch.distributed``), against one process and against the
JAX package's sharded runs.

One launch of 4 rank processes (``subprocess.run`` with a 120 s timeout;
the launcher joins its ranks within 100 s and every collective waits at
most 60 s) joins one gloo group through a FileStore under ``tmp_path``
and forms the subgroups {0, 1}, {2, 3} and one of each rank.  On them:

* the ring ALM step of tests/test_shard_consistency.py (16 columns,
  nz 8, the wet half at 9e4 Pa, dt 600 s) at 1, 2 and 4 ranks: the 2- and
  4-rank states equal the 1-rank state within rtol 1e-12, and the JAX
  package's 8-shard run within rtol 1e-9 (P) and 1e-9 of the largest
  |qflx_lateral|;
* the UGDM halo exchange on the 6 x 4 grid of tests/test_ugrid.py at 4
  ranks: every owned and ghost value equals the natural-order source;
  its lateral sources sum to zero and equal the serial sum over edges
  within rtol 1e-12;
* the UGDM ALM step of tests/test_alm.py:280 (4 x 4 columns, nz 12,
  edges of 10 m) at 2 ranks: equal to the one-process port within rtol
  1e-9, with its lateral fluxes summing to zero;
* the ranks' lockstep in that 2-rank step: only rank 0's first attempt
  fails, by the audit (the driver's ``_audit_err`` seam adds 1 kg) or by
  divergence (its first batched solve reports every column unconverged).
  Both ranks must retry together, or rank 1 returns while rank 0 waits
  in the halo's all_gather until the collective timeout: both ranks
  report 2 attempts and the same counts, and the retried state equals
  the undisturbed 2-rank step within rtol 1e-9.

The worker script imports torch and mpp_tpu_torch only.
"""
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
NRANK = 4
RING = dict(ncol=16, nz=8, dt=600.0, g=1e-10, wet=9.0e4)
UG = dict(nx=4, ny=4, nz=12, dt=1800.0, wet=1.06e5)

WORKER = r'''
import multiprocessing, os, sys, time
import numpy as np

REPO, OUT, NRANK = sys.argv[1], sys.argv[2], int(sys.argv[3])
RING = dict(ncol=16, nz=8, dt=600.0, g=1e-10, wet=9.0e4)
UG = dict(nx=4, ny=4, nz=12, dt=1800.0, wet=1.06e5)


def soils(ncol, nz, dz=0.1):
    shape = (ncol, nz)
    return dict(watsat=np.full(shape, 0.368),
                hksat=np.full(shape, 0.0070556), bsw=np.full(shape, 2.0),
                sucsat=np.full(shape, 29.772),
                residual_sat=np.full(shape, 0.2772), dz=np.full(shape, dz),
                area=np.ones(ncol))


def rank_main(rank):
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from mpp_tpu_torch.driver import alm
    from mpp_tpu_torch.parallel.distributed import (initialize_distributed,
                                                    global_column_mesh,
                                                    process_local_slice)
    from mpp_tpu_torch.parallel.ugrid import UGrid
    assert initialize_distributed(init_method=f"file://{OUT}/store",
                                  world_size=NRANK, rank=rank,
                                  backend="gloo", timeout_s=60.0)
    world = global_column_mesh()
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    singles = [dist.new_group([r]) for r in range(NRANK)]
    groups = {1: global_column_mesh(singles[rank]),
              2: global_column_mesh(pairs[rank // 2]), 4: world}
    res = {}

    # the ring ALM step at 1, 2 and 4 ranks
    n, nz = RING["ncol"], RING["nz"]
    P0 = np.full((n, nz), 3.5355e3)
    P0[: n // 2] = RING["wet"]
    for size, g in groups.items():
        a, b = process_local_slice(n, g.world_size, g.rank)
        s = {k: v[a:b] for k, v in soils(n, nz).items()}
        prob = alm.alm_vsfm_initialize(
            P0=P0[a:b], lateral_connectivity=True,
            lateral_conductance=RING["g"], device_mesh=g, **s)
        out = alm.alm_vsfm_solve(prob, RING["dt"])
        res[f"ring{size}_P"] = prob.P.numpy()
        res[f"ring{size}_q"] = out["qflx_lateral"].numpy()
        res[f"ring{size}_span"] = np.array([a, b])
        res[f"ring{size}_audit"] = np.array([out["abs_mass_error_col"]])

    # the UGDM halo and lateral sources on an arbitrary graph, 4 ranks
    ug = UGrid.regular_2d(6, 4)
    dm = ug.partition(NRANK)
    x_nat = np.random.default_rng(0).uniform(size=(ug.ncol, 3))
    x_sh = dm.natural_to_sharded(x_nat)
    blk = torch.as_tensor(x_sh[rank * dm.n_own:(rank + 1) * dm.n_own])
    res["halo_ext"] = dm.halo_exchange(blk, world).numpy()
    res["halo_src"] = dm.lateral_source(blk[:, 0], 1.3e-3, world).numpy()

    # the UGDM ALM step at 2 ranks
    ug = UGrid.regular_2d(UG["nx"], UG["ny"])
    ug.edge_dist[:] = 10.0
    ug.edge_area[:] = 10.0
    g = groups[2]
    dm = ug.partition(g.world_size)
    n, nz = ug.ncol, UG["nz"]
    P0 = np.full((n, nz), 3.5355e3)
    P0[: n // 2] = UG["wet"]
    sl = slice(g.rank * dm.n_own, (g.rank + 1) * dm.n_own)
    s = {k: dm.natural_to_sharded(v)[sl] for k, v in soils(n, nz).items()}
    prob = alm.alm_vsfm_initialize(
        P0=dm.natural_to_sharded(P0)[sl], lateral_connectivity=True,
        ugrid=ug, device_mesh=g, **s)
    out = alm.alm_vsfm_solve(prob, UG["dt"])
    res["ugdm2_P"] = prob.P.numpy()
    res["ugdm2_q"] = out["qflx_lateral"].numpy()
    res["ugdm2_audit"] = np.array([out["abs_mass_error_col"]])

    # lockstep: only group rank 0's first attempt fails, once by the audit
    # (the driver's _audit_err seam) and once by divergence; every rank
    # must retry with it, or rank 1 leaves while rank 0 waits in the halo
    real_audit = alm._audit_err
    for case in ("audit", "diverged"):
        prob = alm.alm_vsfm_initialize(
            P0=dm.natural_to_sharded(P0)[sl], lateral_connectivity=True,
            ugrid=ug, device_mesh=g, **s)
        calls = [0]
        step = prob.comp._step_dt_batched

        def audit(*a, **k):
            calls[0] += 1
            err = real_audit(*a, **k)
            return err + 1.0 if g.rank == 0 and calls[0] == 1 else err

        def diverging(*a, **k):
            calls[0] += 1
            X, iters, done, reason = step(*a, **k)
            if g.rank == 0 and calls[0] == 1:
                done, reason = done & False, reason * 0 - 5
            return X, iters, done, reason

        if case == "audit":
            alm._audit_err = audit
        else:
            prob.comp._step_dt_batched = diverging
        try:
            out = alm.alm_vsfm_solve(prob, UG["dt"])
        finally:
            alm._audit_err = real_audit
        res[f"lockstep_{case}"] = np.array([
            out["attempts"], out["mass_bal_err_count"],
            out["diverged_count"], out["abs_mass_error_col"]])
        res[f"lockstep_{case}_P"] = prob.P.numpy()
    np.savez(f"{OUT}/rank{rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r,)) for r in range(NRANK)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + 100.0
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    codes = [p.exitcode for p in procs]
    print("RANK_EXIT_CODES", codes)
    sys.exit(0 if not alive and all(c == 0 for c in codes) else 1)
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The 4 ranks' results, by rank."""
    out = tmp_path_factory.mktemp("ranks")
    script = out / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(script), str(ROOT), str(out),
                           str(NRANK)], env=env, cwd=str(out),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(NRANK)]


def _gather(ranks, key, members):
    return np.concatenate([ranks[r][key] for r in members], axis=0)


def _jax_ring_8_shards():
    """The JAX package's ring step on its 8-device CPU mesh
    (tests/test_shard_consistency.py's _solve_on(8, 16))."""
    from mpp_tpu.driver import alm as jalm
    from mpp_tpu.parallel.sharding import column_mesh, shard_columns
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 CPU devices")
    n, nz = RING["ncol"], RING["nz"]
    mesh = column_mesh(8)
    shape = (n, nz)
    prob = jalm.alm_vsfm_initialize(
        watsat=np.full(shape, 0.368), hksat=np.full(shape, 0.0070556),
        bsw=np.full(shape, 2.0), sucsat=np.full(shape, 29.772),
        residual_sat=np.full(shape, 0.2772), dz=np.full(shape, 0.1),
        area=np.ones(n), P0=np.full(shape, 3.5355e3),
        lateral_connectivity=True, lateral_conductance=RING["g"],
        device_mesh=mesh)
    P0 = np.full(shape, 3.5355e3)
    P0[: n // 2] = RING["wet"]
    prob.P = shard_columns(jnp.asarray(P0), mesh)
    out = jalm.alm_vsfm_solve(prob, RING["dt"])
    return np.asarray(prob.P), np.asarray(out["qflx_lateral"])


def test_ring_step_equal_at_1_2_4_ranks_and_to_jax(ranks):
    P1 = {r: ranks[r]["ring1_P"] for r in range(NRANK)}
    for r in range(NRANK):
        np.testing.assert_array_equal(P1[r], P1[0])  # every rank alone
    P1, q1 = P1[0], ranks[0]["ring1_q"]
    for size, members in ((2, [0, 1]), (2, [2, 3]), (4, range(NRANK))):
        P = _gather(ranks, f"ring{size}_P", members)
        q = _gather(ranks, f"ring{size}_q", members)
        np.testing.assert_allclose(P, P1, rtol=1e-12, atol=0)
        np.testing.assert_allclose(q, q1, rtol=1e-12,
                                   atol=1e-12 * np.abs(q1).max())
        for r in members:
            assert ranks[r][f"ring{size}_audit"][0] < 1e-5
    Pj, qj = _jax_ring_8_shards()
    np.testing.assert_allclose(P1, Pj, rtol=1e-9, atol=0)
    np.testing.assert_allclose(q1, qj, rtol=0, atol=1e-9 * np.abs(qj).max())
    assert np.abs(q1).max() > 0 and abs(q1.sum()) < 1e-10 * np.abs(q1).sum()


def test_ugdm_halo_at_4_ranks(ranks):
    from mpp_tpu_torch.parallel.ugrid import UGrid
    ug = UGrid.regular_2d(6, 4)
    dm = ug.partition(NRANK)
    x_nat = np.random.default_rng(0).uniform(size=(ug.ncol, 3))
    og = dm.own_global_nat.numpy()
    exp_nat = og[np.arange(NRANK)[:, None], dm.export_idx.numpy()]
    flat = exp_nat.reshape(-1)
    src = np.zeros(ug.ncol)
    for (a, b), w in zip(ug.edges, ug.edge_weight):
        f = -1.3e-3 * w * (x_nat[a, 0] - x_nat[b, 0])
        src[a] += f
        src[b] -= f
    for d in range(NRANK):
        ext = ranks[d]["halo_ext"]
        own = og[d]
        np.testing.assert_array_equal(ext[:dm.n_own][own >= 0],
                                      x_nat[own[own >= 0]])
        np.testing.assert_array_equal(ext[dm.n_own:],
                                      x_nat[flat[dm.ghost_src[d].numpy()]])
    got = dm.sharded_to_natural(_gather(ranks, "halo_src", range(NRANK)))
    np.testing.assert_allclose(got, src, rtol=1e-12, atol=1e-15)
    assert abs(got.sum()) < 1e-12


def test_ugdm_alm_step_at_2_ranks_matches_one_process(ranks):
    from mpp_tpu_torch.driver import alm
    from mpp_tpu_torch.parallel.ugrid import UGrid
    ug = UGrid.regular_2d(UG["nx"], UG["ny"])
    ug.edge_dist[:] = 10.0
    ug.edge_area[:] = 10.0
    n, nz = ug.ncol, UG["nz"]
    shape = (n, nz)
    P0 = np.full(shape, 3.5355e3)
    P0[: n // 2] = UG["wet"]
    prob = alm.alm_vsfm_initialize(
        watsat=np.full(shape, 0.368), hksat=np.full(shape, 0.0070556),
        bsw=np.full(shape, 2.0), sucsat=np.full(shape, 29.772),
        residual_sat=np.full(shape, 0.2772), dz=np.full(shape, 0.1),
        area=np.ones(n), P0=P0, lateral_connectivity=True, ugrid=ug,
        device="cpu")
    out = alm.alm_vsfm_solve(prob, UG["dt"])
    for members in ([0, 1], [2, 3]):
        P = _gather(ranks, "ugdm2_P", members)
        q = _gather(ranks, "ugdm2_q", members)
        np.testing.assert_allclose(P, prob.P.numpy(), rtol=1e-9, atol=0)
        q1 = out["qflx_lateral"].numpy()
        np.testing.assert_allclose(q, q1, rtol=0,
                                   atol=1e-9 * np.abs(q1).max())
        assert abs(q.sum()) < 1e-10 * np.abs(q).max()
        assert max(ranks[r]["ugdm2_audit"][0] for r in members) < 1e-5
    assert bool(torch.isfinite(prob.P).all())


@pytest.mark.parametrize("case", ["audit", "diverged"])
def test_ugdm_ranks_retry_in_lockstep(ranks, case):
    for members in ([0, 1], [2, 3]):
        got = [ranks[r][f"lockstep_{case}"] for r in members]
        attempts, bal, div, audit = got[0]
        assert attempts == 2
        assert (bal, div) == ((1, 0) if case == "audit" else (0, 1))
        assert audit < 1e-5
        np.testing.assert_array_equal(got[1], got[0])
        np.testing.assert_allclose(
            _gather(ranks, f"lockstep_{case}_P", members),
            _gather(ranks, "ugdm2_P", members), rtol=1e-9, atol=0)

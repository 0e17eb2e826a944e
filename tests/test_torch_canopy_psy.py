"""The port's photosynthesis against the JAX package, f64 on the CPU, on
the photosynthesis suite's configurations (pathway x stomatal model).

* ``batched/photosynthesis.solve`` + ``post_solve`` against JAX's, from
  the same staged auxvars: equal boundedness and equal Newton iteration
  counts; the bounded iterates within the case's tolerance of
  tests/test_batched_photosynthesis.py:27 (quadratic convergence to the
  root for BB/Medlyn; the WUE/Bonan14 family converges linearly through
  an FD-noise-limited map, KNOWN_GAPS #6), gs and an within 50 times it,
  as that test holds JAX against the serial path.
* ``compile_photosynthesis(...).install()`` (the global-norm Newton)
  through ``run_photosynthesis_problem(compiled=True)`` against JAX's:
  equal iteration counts, the solution and the written-back gs/an within
  the same tolerances.
* ``run_photosynthesis_problem(compiled=False)``, the serial numpy path
  (the port's host copy), bitwise.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mpp_tpu.batched import photosynthesis as jbp
from mpp_tpu.models import photosynthesis as jph
from mpp_tpu.problems.photosynthesis import run_photosynthesis_problem as jrun
from mpp_tpu_torch.batched import photosynthesis as tbp
from mpp_tpu_torch.problems.photosynthesis import \
    run_photosynthesis_problem as trun

CASES = [
    ("c3", "ball-berry", 1e-8),
    ("c4", "ball-berry", 1e-8),
    ("c3", "medlyn", 1e-6),
    ("c4", "medlyn", 1e-8),
    ("c3", "wue", 2e-5),
    ("c3", "bonan14", 2e-5),
]
IDS = [f"{p}-{s}" for p, s, _ in CASES]


@pytest.mark.parametrize("pathway,scm,tol", CASES, ids=IDS)
def test_batched_solve_matches_jax(pathway, scm, tol):
    mpp = trun(pathway, scm, device="cpu")
    av = mpp.soe.ge.avars
    x0 = np.full((av.n, av.ndof),
                 0.9 * 380.0 if av.gstype in (jph.SCM_BBERRY,
                                              jph.SCM_MEDLYN) else 0.002)
    jcfg, jp = jbp.params_from_auxvars(av)
    jres, jb = jax.jit(lambda p, x: jbp.solve(jcfg, p, x))(jp, x0)
    jout = jbp.post_solve(jcfg, jp, jres.x, jb)
    tcfg, tp = tbp.params_from_auxvars(av, "cpu")
    assert dataclasses.astuple(tcfg) == dataclasses.astuple(jcfg)
    syncs = []
    tres, tb = tbp.solve(tcfg, tp, torch.as_tensor(x0),
                         sync=lambda v: syncs.append(1) or v.item())
    tout = tbp.post_solve(tcfg, tp, tres.x, tb)

    bounded = np.asarray(jb)
    np.testing.assert_array_equal(tb.numpy(), bounded)
    assert tres.iters == int(jres.iters[0]) > 0
    assert len(syncs) == tres.iters + 1
    np.testing.assert_array_equal(tres.converged.numpy(),
                                  np.asarray(jres.converged))
    np.testing.assert_allclose(tres.x.numpy()[bounded],
                               np.asarray(jres.x)[bounded], rtol=tol,
                               atol=tol)
    both = bounded.all(axis=1)
    for f in ("gs", "an"):
        np.testing.assert_allclose(getattr(tout, f).numpy()[both],
                                   np.asarray(getattr(jout, f))[both],
                                   rtol=50 * tol, atol=50 * tol, err_msg=f)


@pytest.mark.parametrize("pathway,scm,tol", CASES, ids=IDS)
def test_compiled_install_matches_jax(pathway, scm, tol):
    mj = jrun(pathway, scm, compiled=True)
    mt = trun(pathway, scm, compiled=True, device="cpu")
    comp = mt.soe.step_dt.__self__
    assert isinstance(comp, tbp.CompiledPhotosynthesis)
    assert comp.host_syncs > 0
    assert mt.soe.cumulative_newton_iterations \
        == mj.soe.cumulative_newton_iterations > 0
    np.testing.assert_allclose(mt.soe.soln, mj.soe.soln, rtol=tol, atol=tol)
    for f in ("gs_soln", "an_soln"):
        np.testing.assert_allclose(getattr(mt.soe.ge.avars, f),
                                   getattr(mj.soe.ge.avars, f),
                                   rtol=50 * tol, atol=50 * tol, err_msg=f)


@pytest.mark.parametrize("pathway,scm", [("c4", "medlyn"),
                                         ("c3", "bonan14")])
def test_serial_problem_matches_jax(pathway, scm):
    mj = jrun(pathway, scm)
    mt = trun(pathway, scm, device="cpu")
    np.testing.assert_array_equal(mt.soe.soln, mj.soe.soln)
    np.testing.assert_array_equal(mt.soe.ge.avars.gs_soln,
                                  mj.soe.ge.avars.gs_soln)
    assert mt.soe.cumulative_newton_iterations \
        == mj.soe.cumulative_newton_iterations


def test_entry_points_default_to_the_card():
    """Without a card, the default device raises; nothing falls back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        trun("c4", "medlyn")


def test_done_lanes_stay_frozen():
    """A lane done by iteration k keeps its iterate bit for bit in every
    later iteration of the masked Newton (dx = 0 for done lanes): the full
    run ends with the iterate a run cut at ``max_it`` = k gives it."""
    mpp = trun("c3", "medlyn", device="cpu")
    av = mpp.soe.ge.avars
    cfg, p = tbp.params_from_auxvars(av, "cpu")
    x0 = torch.full((av.n, 1), 0.9 * 380.0, dtype=torch.float64)
    full, _ = tbp.solve(cfg, p, x0)
    partial = 0
    for k in range(1, full.iters):
        cut, _ = tbp.solve(cfg, p, x0, max_it=k)
        assert cut.iters == k
        done = cut.converged
        partial += 0 < int(done.sum()) < av.n
        assert torch.equal(full.x[done], cut.x[done])
    assert partial     # some lanes finished before the others (45 of 93)

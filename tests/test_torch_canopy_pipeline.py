"""The port's batched canopy pipeline (turbulence -> longwave -> LBL ->
photosynthesis -> MLC, 93 levels) against the JAX package's, on the CPU.

JAX runs through ``staged_substep_fns(jax)`` (three jitted stages, built
once in a module fixture); its eager ``substep`` compiles every while loop
anew.  The port gets the same state and forcing through
``canopy_state_from_numpy`` / ``forcing_from_numpy``.

Tolerances, f64: the forcing records (the shortwave GMRES iterate and the
derived scalars) within 1e-10 relative; the state after each substep
within T_TOL = 1e-9 K and Q_TOL = 1e-12 (measured: 4e-11 K and 5e-13 after
3 substeps; the JAX package holds its batched pipeline against its serial
composition at 1e-5 K and 1e-8, tests/test_canopy_pipeline.py:295-298).
f32 diurnal (hours 6-13, 2 substeps): the f32 MLC block solve alone lands
up to 7e-3 K and 7e-5 from the f64 solve of the same inputs, in JAX as in
the port (measured on one substep), so the two f32 runs are held to
F32_T_TOL = 0.03 K and F32_Q_TOL = 2e-4 (measured 8.5e-3 K and 4.7e-5
apart over the 16 substeps).
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpp_tpu.batched.canopy_pipeline import CanopyPipeline as JPipeline
from mpp_tpu_torch.batched import canopy_pipeline as tcp
from mpp_tpu_torch.models.lbl import LeafBoundaryLayerGE
from mpp_tpu_torch.models.radiation import LongwaveGE, ShortwaveGE
from mpp_tpu_torch.problems.canopy_radiation import canopy_mesh
from mpp_tpu_torch.problems.ml_model import synthetic_diurnal_bc

T_TOL, Q_TOL = 1e-9, 1e-12
FORCING_TOL = 1e-10
F32_T_TOL, F32_Q_TOL = 0.03, 2e-4
TOLS = (T_TOL, Q_TOL, T_TOL, T_TOL)

# the two records of tests/test_canopy_pipeline.py:315-319
RECORDS = {
    "default": None,
    "morning": dict(sza=1.2, iskyb=(120.0, 120.0), iskyd=(40.0, 10.0),
                    irsky=350.0, tref=288.0, qref=0.007),
    "evening": dict(sza=1.45, iskyb=(5.0, 5.0), iskyd=(2.0, 0.5),
                    irsky=320.0, tref=283.0, qref=0.006, uref=3.0,
                    soil_T=290.0),
}


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pipes():
    jp = JPipeline(ncair=2)
    return jp, jp.staged_substep_fns(jax), tcp.CanopyPipeline(2,
                                                              device="cpu")


def _forcings(jp, tp, name):
    kw = RECORDS[name]
    if kw is None:
        return jp.default_forcing, tp.default_forcing
    return jp.make_forcing(**kw), tp.make_forcing(**kw)


@pytest.mark.parametrize("name", list(RECORDS))
def test_make_forcing_matches_jax(pipes, name):
    jp, _, tp = pipes
    jf, tf = _forcings(jp, tp, name)
    for field, a, b in zip(tcp.Forcing._fields, jf, tf):
        a = np.asarray(a)
        assert b.dtype == torch.float64 and tuple(b.shape) == a.shape
        scale = max(float(np.abs(a).max()), 1e-300)
        err = float(np.abs(b.numpy() - a).max()) / scale
        assert err <= FORCING_TOL, (field, err)


@pytest.mark.parametrize("name,nsub", [("default", 3), ("morning", 2),
                                       ("evening", 2)])
def test_substeps_match_jax(pipes, name, nsub):
    """Each substep's state from the same state and forcing."""
    jp, fns, tp = pipes
    jf = _forcings(jp, tp, name)[0]
    tf = tcp.forcing_from_numpy(jf, "cpu")
    js = jp.initial_state()
    ts = tcp.canopy_state_from_numpy(js, "cpu")
    tfns = tp.staged_substep_fns()
    syncs, hyb, psy = tp.host_syncs, tp.hybrid_iterations, tp.psy_iterations
    for sub in range(nsub):
        js = jp.run_staged(fns, js, 300.0, jf)
        ts = tp.run_staged(tfns, ts, 300.0, tf)
        for field, a, b, tol in zip(tcp.CanopyState._fields, js, ts, TOLS):
            err = float(np.abs(b.numpy() - np.asarray(a)).max())
            assert err < tol, (sub, field, err)
    # one host read per masked-loop iteration plus the exit test of each
    assert tp.hybrid_iterations > hyb and tp.psy_iterations > psy
    assert tp.host_syncs - syncs == (tp.hybrid_iterations - hyb) \
        + (tp.psy_iterations - psy) + 2 * nsub


def test_fused_hour_matches_staged(pipes):
    """fused_hour_fn is the staged substep composition, bit for bit."""
    _, _, tp = pipes
    s0 = tp.initial_state()
    staged = s0
    for _ in range(3):
        staged = tp.run_staged(tp.staged_substep_fns(), staged)
    fused = tp.fused_hour_fn(nsubstep=3)(s0, tp.default_forcing)
    for a, b in zip(staged, fused):
        assert torch.equal(a, b)


def test_f32_diurnal_matches_jax_and_checkpoints():
    """Hours 6-13 x 2 substeps of the synthetic diurnal forcing in f32
    (the hours of tests/test_canopy_pipeline.py:321): the canopy-top
    trajectory against JAX's, every state field f32, the top warming into
    midday, and the hourly checkpoint read back bit for bit."""
    jp = JPipeline(ncair=2, dtype=jnp.float32)
    js, jtraj = jp.run_diurnal(jp.initial_state(), beg_step=6, end_step=13,
                               nsubstep=2, bc_provider=synthetic_diurnal_bc,
                               fused=False)
    tp = tcp.CanopyPipeline(2, dtype=torch.float32, device="cpu")
    with tempfile.TemporaryDirectory() as d:
        ts, ttraj = tp.run_diurnal(tp.initial_state(), beg_step=6,
                                   end_step=13, nsubstep=2,
                                   bc_provider=synthetic_diurnal_bc,
                                   checkpoint_dir=d)
        back = tp.restore(f"{d}/canopy_checkpoint.13.2.bin")
    for a, b in zip(ts, back):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)
    for hour in range(6, 14):
        for (a, b), tol in zip(zip(jtraj[hour], ttraj[hour]),
                               (F32_T_TOL, F32_Q_TOL)):
            assert b.dtype == np.float32
            assert float(np.abs(b - a).max()) < tol, (hour, a, b)
    for field, a, b in zip(tcp.CanopyState._fields, js, ts):
        tol = F32_Q_TOL if field == "q_air" else F32_T_TOL
        err = float(np.abs(b.numpy() - np.asarray(a)).max())
        assert err < tol, (field, err)
    assert torch.isfinite(ts.T_air).all()
    assert (ttraj[13][0] > ttraj[6][0]).all()


def test_default_device_is_the_card():
    """CanopyPipeline's and the canopy GEs' default device is "cuda":
    without a card each raises, and none falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    mesh = canopy_mesh(92, ncair=2)
    for build in (lambda: tcp.CanopyPipeline(2),
                  lambda: ShortwaveGE(name="sw", mesh=mesh),
                  lambda: LongwaveGE(name="lw", mesh=mesh),
                  lambda: LeafBoundaryLayerGE(name="lbl", mesh=mesh)):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
    assert LongwaveGE(name="lw", mesh=mesh, device="cpu").device.type == \
        "cpu"

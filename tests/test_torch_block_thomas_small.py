"""The block_thomas_small wrapper (mpp_tpu_torch/ops/hopper_kernels.py) and
its routes (ops/block_structure.block_solve) against the JAX package's
block_thomas, the lax.scan sweeps of mpp_tpu/ops/block_thomas.py.

On the CPU the wrapper runs its plain form (ops/block_thomas.block_thomas);
the `cuda` cases hold the CUDA kernel to that plain form on the card and
skip here.  JAX is imported by the CPU cases only, so `python -m pytest
--noconftest -m cuda tests/test_torch_block_thomas_small.py` runs on a
card machine without it.  Tolerances: f64 rtol 1e-10 / atol 1e-12 (the
same recurrence; the tiny matmuls' summation order differs); f32 1e-6 of
max |x| against JAX's f32 scan (both sit ~1e-7 from the f64 solve over
these 9 levels).  The routing cases spy on the wrapper and on the plain
level loop behind ``block_solve``.
"""
import numpy as np
import pytest
import torch

from mpp_tpu_torch.ops import block_structure as bs
from mpp_tpu_torch.ops import block_thomas as tbt
from mpp_tpu_torch.ops import hopper_kernels as hk

F32_REL = 1e-6


@pytest.fixture(autouse=True)
def _fresh_counters():
    hk.reset_launches()
    yield
    # CPU tensors never launch a kernel
    assert all(v == 0 for v in hk.LAUNCHES.values()), hk.LAUNCHES


def _system(lead, n, m, seed, swap=False):
    """Random block diagonally dominant systems (numpy, f64): L, D, U
    ``lead + [n, m, m]``, b ``lead + [n, m]``.  ``swap``: the rows of every
    D block rotated up by one and its leading diagonal zeroed, so that each
    level's small solve needs a row swap (m >= 2)."""
    rng = np.random.default_rng(seed)
    shape = tuple(lead) + (n, m, m)
    L = 0.2 * rng.standard_normal(shape)
    U = 0.2 * rng.standard_normal(shape)
    D = 0.2 * rng.standard_normal(shape) + \
        (2.5 + rng.random(shape[:-1]))[..., None] * np.eye(m)
    if swap:
        D = np.roll(D, -1, axis=-2).copy()
        D[..., 0, 0] = 0.0
    b = rng.standard_normal(shape[:-1])
    return L, D, U, b


def _both(sys_np, np_dtype=np.float64):
    """(the wrapper's x, JAX's scan x) on ``sys_np`` cast to np_dtype."""
    import jax.numpy as jnp
    from mpp_tpu.ops import block_thomas as jbt
    args = [a.astype(np_dtype) for a in sys_np]
    got = hk.block_thomas_small(*(torch.as_tensor(a) for a in args))
    ref = np.asarray(jbt.block_thomas(*(jnp.asarray(a) for a in args)))
    assert got.dtype == torch.as_tensor(args[3]).dtype
    assert tuple(got.shape) == args[3].shape
    return got.numpy(), ref


@pytest.mark.parametrize("m", range(1, 9))
def test_wrapper_matches_jax_scan_f64(m):
    got, ref = _both(_system((4,), 9, m, seed=m))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("m", range(1, 9))
def test_wrapper_matches_jax_scan_f32(m):
    got, ref = _both(_system((4,), 9, m, seed=10 + m), np.float32)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= F32_REL * np.abs(ref).max()


@pytest.mark.parametrize("lead", [(), (5,), (5, 1)], ids=["none", "B", "B1"])
@pytest.mark.parametrize("m", [3, 4])
def test_wrapper_leading_dims(lead, m):
    got, ref = _both(_system(lead, 6, m, seed=20 + m))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("m", range(2, 9))
def test_wrapper_row_swaps(m):
    """Every D block's leading diagonal is zero: small_solve pivots (m >=
    3; m = 2 is the adjugate) at every level; x solves the system."""
    sys_np = _system((3,), 8, m, seed=30 + m, swap=True)
    got, ref = _both(sys_np)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)
    L, D, U, b = (torch.as_tensor(a) for a in sys_np)
    back = tbt.block_tridiag_matvec(L, D, U, torch.as_tensor(got))
    np.testing.assert_allclose(back.numpy(), sys_np[3], rtol=1e-10,
                               atol=1e-10)


def _bad_inputs():
    blk = torch.ones(4, 8, 3, 3, dtype=torch.float64)
    b = torch.ones(4, 8, 3, dtype=torch.float64)
    big = torch.ones(2, 4, 9, 9, dtype=torch.float64)
    return {
        "m > 8": (big, big, big, torch.ones(2, 4, 9, dtype=torch.float64)),
        "int dtype": (blk.long(), blk.long(), blk.long(), b.long()),
        "mixed dtypes": (blk, blk.float(), blk, b),
        "block shape": (blk, blk, torch.ones(4, 8, 2, 2,
                                             dtype=torch.float64), b),
        "level mismatch": (blk, blk, blk, torch.ones(4, 9, 3,
                                                     dtype=torch.float64)),
        "batch mismatch": (blk, blk, blk, torch.ones(5, 8, 3,
                                                     dtype=torch.float64)),
        "1-d rhs": (blk[0, 0], blk[0, 0], blk[0, 0], b[0, 0]),
        "non-contiguous": (blk.transpose(0, 1).contiguous().transpose(0, 1),
                           blk, blk, b),
        "not a tensor": (blk.numpy(), blk, blk, b),
        "meta device": (blk.to("meta"), blk.to("meta"), blk.to("meta"),
                        b.to("meta")),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_bad_inputs_raise(case):
    with pytest.raises(ValueError):
        hk.block_thomas_small(*_bad_inputs()[case])


# ---- routes: which callers reach the wrapper ------------------------------

@pytest.fixture
def spies(monkeypatch):
    """Record the (m, dtype) of every call of the wrapper and of the plain
    level loop behind block_solve."""
    calls = {"kernel": [], "plain": []}

    def spy(key, fn):
        def wrapped(L, D, U, b):
            calls[key].append((b.shape[-1], b.dtype))
            return fn(L, D, U, b)
        return wrapped
    monkeypatch.setattr(hk, "block_thomas_small",
                        spy("kernel", hk.block_thomas_small))
    monkeypatch.setattr(bs, "block_thomas", spy("plain", bs.block_thomas))
    return calls


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_canopy_substep_calls_the_wrapper_twice(spies, dtype):
    """One substep: the longwave solve (m = 3, f64 staging) and the MLC
    solve (m = 4, the pipeline's dtype)."""
    from mpp_tpu_torch.batched.canopy_pipeline import CanopyPipeline
    pipe = CanopyPipeline(ncair=2, dtype=dtype, device="cpu")
    state = pipe.substep(pipe.initial_state(), 300.0)
    assert spies["kernel"] == [(3, torch.float64), (4, dtype)]
    assert spies["plain"] == []
    assert all(bool(torch.isfinite(a).all()) for a in state)


@pytest.mark.parametrize("ntree,routed", [(1, True), (3, True), (4, False)],
                         ids=["m4", "m8", "m10"])
def test_mlc_step_routes_by_block_size(spies, ntree, routed):
    """batched/mlc.step on the staged MLC problem: m = 2 + 2 ntree."""
    from mpp_tpu_torch.batched import mlc as bmlc
    from mpp_tpu_torch.problems.mlc import run_mlc_problem
    mpp = run_mlc_problem(2, ntree, device="cpu")
    mpp.dtime = 300.0
    mpp._vol_air = mpp._compute_vol_air()
    mpp.pre_solve()
    spies["kernel"].clear()
    spies["plain"].clear()
    x = bmlc.step(bmlc.inputs_from_mpp(mpp, device="cpu"), 300.0)
    m = 2 + 2 * ntree
    assert x.shape[-1] == m and bool(torch.isfinite(x).all())
    assert spies["kernel" if routed else "plain"] == [(m, torch.float64)]
    assert spies["plain" if routed else "kernel"] == []


@pytest.mark.parametrize("lateral,routed", [((4, 2), True), ((3, 3), False)],
                         ids=["b8", "b9"])
def test_vsfm_block_plan_routes_by_block_size(spies, monkeypatch, lateral,
                                              routed):
    """The "direct" block plan of compile_vsfm on vsfm_vchannel cut to
    NX x NY lateral cells (the block size) x 3 levels, one step."""
    from mpp_tpu_torch.problems import vsfm_vchannel as vch
    monkeypatch.setattr(vch, "NX", lateral[0])
    monkeypatch.setattr(vch, "NY", lateral[1])
    mpp = vch.run_vsfm_vchannel_problem(nz=3, nstep=1, use_compiled=True,
                                        linear_solver="direct", device="cpu")
    comp = mpp.soe.step_dt.__self__
    b = lateral[0] * lateral[1]
    assert comp.plan == "block" and comp.block_size == b
    used, unused = ("kernel", "plain") if routed else ("plain", "kernel")
    assert spies[used] and set(spies[used]) == {(b, torch.float64)}
    assert spies[unused] == []


def _ksp_step(comp, ncol=2):
    bc, ss = comp.gather_inputs(ncol, "cpu")
    T = torch.full((ncol, comp.n), 285.0, dtype=torch.float64)
    dyn = tuple({"liq": torch.full_like(T[:, :g.mesh.ncells_local], 2.0)}
                for g in comp.goveqns)
    T, ok, _ = comp.step_batched(T, bc, ss, 1800.0, dyn=dyn)
    assert bool(ok.all()) and bool(torch.isfinite(T).all())


@pytest.mark.parametrize("case,b,routed", [("3d_3x3x3", 9, False),
                                           ("2d_4x4", 4, True),
                                           ("three_media", 3, True)])
def test_ksp_block_plan_routes_by_block_size(spies, case, b, routed):
    """The block plan of compile_ksp: the thermal MMS in 2-D (4 x 4) and
    3-D (3 x 3 x 3) under "direct", and the 3-media column."""
    from mpp_tpu_torch.batched.ksp_compiled import compile_ksp
    from mpp_tpu_torch.problems import thermal_mms
    from mpp_tpu_torch.problems.thermal_3media import ThreeMediaProblem
    if case == "three_media":
        p = ThreeMediaProblem(device="cpu")
        p.set_initial_temperature(265.0, 272.0, 278.0)
        p.set_top_fluxes(-30.0, 0.0, 5.0)
        p.step(1800.0)
        comp = p._comp
    else:
        dims = dict(nx=4, ny=4) if case == "2d_4x4" else dict(nx=3, ny=3,
                                                               nz=3)
        mpp, _ = thermal_mms.run_thermal_mms_problem(
            2 if case == "2d_4x4" else 3, nstep=0, device="cpu", **dims)
        comp = compile_ksp(mpp, linear_solver="direct")
        _ksp_step(comp)
    assert comp.block_size == b
    used, unused = ("kernel", "plain") if routed else ("plain", "kernel")
    assert spies[used] and set(spies[used]) == {(b, torch.float64)}
    assert spies[unused] == []


# ---- on the card: the kernel against its plain form -----------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


def _on_card(sys_np, dtype):
    return [torch.as_tensor(a, dtype=dtype, device="cuda") for a in sys_np]


def _hold_on_card(sys_np, dtype):
    """The kernel against the plain form on the card: f64 within 1e-12 of
    max |x|; f32 no farther from the plain f64 solve than twice the plain
    f32 solve is."""
    t = _on_card(sys_np, dtype)
    got = hk.block_thomas_small(*t)
    assert hk.LAUNCHES["block_thomas_small"] == 1
    hk.reset_launches()
    ref = tbt.block_thomas(*t)
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float64:
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= 1e-12 * scale
    else:
        ref64 = tbt.block_thomas(*(a.double() for a in t))
        own = float((ref.double() - ref64).abs().max())
        assert float((got.double() - ref64).abs().max()) <= 2 * own


@pytest.mark.cuda
@pytest.mark.parametrize("swap", [False, True], ids=["dominant", "swap"])
@pytest.mark.parametrize("n", [1, 2, 93])
@pytest.mark.parametrize("m", range(1, 9))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kernel_matches_plain_on_gpu(dtype, m, n, swap):
    """On the card (`python -m pytest -m cuda tests/`): every m at a batch
    no warp's systems divide (33) and at the canopy's (4096)."""
    _need_card()
    sys_np = _system((4096,), n, m, seed=40 + m + n, swap=swap and m > 1)
    _hold_on_card(sys_np, dtype)
    _hold_on_card([a[:33] for a in sys_np], dtype)


@pytest.mark.cuda
def test_kernel_keeps_a_nan_in_its_system_on_gpu():
    """A NaN in one system's D reaches that system's x and no other's."""
    _need_card()
    L, D, U, b = _system((64,), 20, 4, seed=50)
    D[5, 7, 2, 1] = np.nan
    t = _on_card((L, D, U, b), torch.float64)
    got = hk.block_thomas_small(*t)
    ref = tbt.block_thomas(*t)
    hk.reset_launches()
    assert not bool(torch.isfinite(got[5]).all())
    keep = torch.arange(64, device="cuda") != 5
    assert bool(torch.isfinite(got[keep]).all())
    scale = float(ref[keep].abs().max())
    assert float((got[keep] - ref[keep]).abs().max()) <= 1e-12 * scale

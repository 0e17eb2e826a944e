"""The block_thomas_large wrapper (mpp_tpu_torch/ops/hopper_kernels.py) and
block_solve's m >= 9 route (ops/block_structure.block_solve) against the
JAX package's block_thomas, the lax.scan sweeps of mpp_tpu/ops/
block_thomas.py with small_solve's jnp.linalg.solve branch (m > 8).

On the CPU the wrapper runs its plain form (ops/block_thomas.block_thomas,
torch.linalg.solve a level); the `cuda` cases hold the CUDA kernel to that
plain form on the card and skip here.  JAX is imported by the CPU cases
only, so `python -m pytest --noconftest -m cuda
tests/test_torch_block_thomas_large.py` runs on a card machine without it.
Tolerances: f64 rtol 1e-10 / atol 1e-12 (the same recurrence; LAPACK's
and the products' summation orders differ); f32 1e-5 of max |x| against
JAX's f32 scan (both sit ~1e-6 from the f64 solve on these systems, whose
off-diagonal entries are scaled by 1 / sqrt(m) to keep them block
diagonally dominant at every m).
"""
import numpy as np
import pytest
import torch

from mpp_tpu_torch.ops import block_structure as bs
from mpp_tpu_torch.ops import block_thomas as tbt
from mpp_tpu_torch.ops import hopper_kernels as hk

F32_REL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_counters():
    hk.reset_launches()
    yield
    # CPU tensors never launch a kernel
    assert all(v == 0 for v in hk.LAUNCHES.values()), hk.LAUNCHES


def _system(lead, n, m, seed, swap=False):
    """Random block diagonally dominant systems (numpy, f64): L, D, U
    ``lead + [n, m, m]``, b ``lead + [n, m]``; off-diagonal entries of
    spread 0.5 / sqrt(m), diagonals 2.5-3.5.  ``swap``: the rows of every D
    block rotated up by one and its leading diagonal zeroed, so that each
    level's LU swaps rows at every column."""
    rng = np.random.default_rng(seed)
    shape = tuple(lead) + (n, m, m)
    sd = 0.5 / np.sqrt(m)
    L = sd * rng.standard_normal(shape)
    U = sd * rng.standard_normal(shape)
    D = sd * rng.standard_normal(shape) + \
        (2.5 + rng.random(shape[:-1]))[..., None] * np.eye(m)
    if swap:
        D = np.roll(D, -1, axis=-2).copy()
        D[..., 0, 0] = 0.0
    b = rng.standard_normal(shape[:-1])
    return L, D, U, b


def _both(sys_np, np_dtype=np.float64, through=None):
    """(x through ``through`` (default block_solve), JAX's scan x) on
    ``sys_np`` cast to np_dtype."""
    import jax.numpy as jnp
    from mpp_tpu.ops import block_thomas as jbt
    args = [a.astype(np_dtype) for a in sys_np]
    fn = bs.block_solve if through is None else through
    got = fn(*(torch.as_tensor(a) for a in args))
    ref = np.asarray(jbt.block_thomas(*(jnp.asarray(a) for a in args)))
    assert got.dtype == torch.as_tensor(args[3]).dtype
    assert tuple(got.shape) == args[3].shape
    return got.numpy(), ref


@pytest.fixture
def spy(monkeypatch):
    """The (m, dtype) of every block_thomas_large call."""
    calls = []
    fn = hk.block_thomas_large

    def wrapped(L, D, U, b):
        calls.append((b.shape[-1], b.dtype))
        return fn(L, D, U, b)
    monkeypatch.setattr(hk, "block_thomas_large", wrapped)
    return calls


@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("m", [9, 10, 20, 40, 64])
def test_block_solve_large_matches_jax_scan_f64(spy, m, n):
    got, ref = _both(_system((3,), n, m, seed=m + n))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)
    assert spy == [(m, torch.float64)]


@pytest.mark.parametrize("n", [1, 2, 5])
@pytest.mark.parametrize("m", [9, 10, 20, 40, 64])
def test_block_solve_large_matches_jax_scan_f32(spy, m, n):
    got, ref = _both(_system((3,), n, m, seed=100 + m + n), np.float32)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= F32_REL * np.abs(ref).max()
    assert spy == [(m, torch.float32)]


@pytest.mark.parametrize("lead", [(), (4,), (2, 3), (4, 1)],
                         ids=["none", "B", "B2", "B1"])
@pytest.mark.parametrize("m", [9, 20])
def test_block_solve_large_leading_dims(spy, lead, m):
    got, ref = _both(_system(lead, 4, m, seed=200 + m))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)
    assert spy == [(m, torch.float64)]


@pytest.mark.parametrize("n", [1, 5])
@pytest.mark.parametrize("m", [9, 10, 20, 40, 64])
def test_block_solve_large_row_swaps(spy, m, n):
    """Every D block's leading diagonal is zero and its rows rotated: the
    level's LU swaps rows; x solves the system."""
    sys_np = _system((2,), n, m, seed=300 + m + n, swap=True)
    got, ref = _both(sys_np)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)
    L, D, U, b = (torch.as_tensor(a) for a in sys_np)
    back = tbt.block_tridiag_matvec(L, D, U, torch.as_tensor(got))
    np.testing.assert_allclose(back.numpy(), sys_np[3], rtol=1e-10,
                               atol=1e-10)
    assert spy == [(m, torch.float64)]


def test_wrapper_called_directly_matches_jax_scan():
    got, ref = _both(_system((5,), 3, 12, seed=400),
                     through=hk.block_thomas_large)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


def _bad_inputs():
    blk = torch.ones(4, 8, 10, 10, dtype=torch.float64)
    b = torch.ones(4, 8, 10, dtype=torch.float64)
    small = torch.ones(2, 4, 8, 8, dtype=torch.float64)
    return {
        "m < 9": (small, small, small, torch.ones(2, 4, 8,
                                                   dtype=torch.float64)),
        "int dtype": (blk.long(), blk.long(), blk.long(), b.long()),
        "mixed dtypes": (blk, blk.float(), blk, b),
        "block shape": (blk, blk, torch.ones(4, 8, 9, 9,
                                             dtype=torch.float64), b),
        "level mismatch": (blk, blk, blk, torch.ones(4, 9, 10,
                                                     dtype=torch.float64)),
        "batch mismatch": (blk, blk, blk, torch.ones(5, 8, 10,
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
        hk.block_thomas_large(*_bad_inputs()[case])


def test_block_solve_never_runs_the_plain_loop_itself(monkeypatch):
    """block_solve reaches the plain level loop only through a wrapper (on
    CPU tensors): with both wrappers replaced, it never calls it."""
    def boom(*a):
        raise AssertionError("the plain level loop was called")
    monkeypatch.setattr(tbt, "block_thomas", boom)
    monkeypatch.setattr(hk, "block_thomas", boom)
    seen = []
    monkeypatch.setattr(hk, "block_thomas_small",
                        lambda L, D, U, b: seen.append("small") or b)
    monkeypatch.setattr(hk, "block_thomas_large",
                        lambda L, D, U, b: seen.append("large") or b)
    for m in (8, 9):
        L, D, U, b = (torch.as_tensor(a) for a in _system((2,), 3, m, 500))
        bs.block_solve(L, D, U, b)
    assert seen == ["small", "large"]


# ---- on the card: the kernel against its plain form -----------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


def _hold_on_card(sys_np, dtype):
    """The kernel against the plain form on the card: f64 within 1e-11 of
    max |x|; f32 no farther from the plain f64 solve than twice the plain
    f32 solve is."""
    t = [torch.as_tensor(a, dtype=dtype, device="cuda") for a in sys_np]
    got = hk.block_thomas_large(*t)
    assert hk.LAUNCHES["block_thomas_large"] == 1
    hk.reset_launches()
    ref = tbt.block_thomas(*t)
    assert bool(torch.isfinite(got).all())
    if dtype == torch.float64:
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= 1e-11 * scale
    else:
        ref64 = tbt.block_thomas(*(a.double() for a in t))
        own = float((ref.double() - ref64).abs().max())
        assert float((got.double() - ref64).abs().max()) <= 2 * own


@pytest.mark.cuda
@pytest.mark.parametrize("swap", [False, True], ids=["dominant", "swap"])
@pytest.mark.parametrize("n", [1, 2, 30])
@pytest.mark.parametrize("m", [9, 16, 33, 119, 120, 200])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kernel_matches_plain_on_gpu(dtype, m, n, swap):
    """On the card (`python -m pytest -m cuda tests/`): around the shared
    memory edge (119 / 120, both dtypes work in f64) and at the vchannel's
    b = 200, at 1 and 33 systems."""
    _need_card()
    sys_np = _system((33,), n, m, seed=600 + m + n, swap=swap)
    _hold_on_card(sys_np, dtype)
    _hold_on_card([a[:1] for a in sys_np], dtype)


@pytest.mark.cuda
def test_kernel_shared_memory_edge_on_gpu():
    """The largest block kept in shared memory is the one the tests above
    straddle, in both dtypes (the kernel works in f64)."""
    _need_card()
    assert hk.max_on_chip("block_thomas_large", torch.float64) == 119
    assert hk.max_on_chip("block_thomas_large", torch.float32) == 119


@pytest.mark.cuda
def test_kernel_keeps_a_nan_in_its_system_on_gpu():
    """A NaN in one system's D reaches that system's x and no other's."""
    _need_card()
    L, D, U, b = _system((16,), 6, 12, seed=700)
    D[5, 3, 2, 1] = np.nan
    t = [torch.as_tensor(a, device="cuda") for a in (L, D, U, b)]
    got = hk.block_thomas_large(*t)
    ref = tbt.block_thomas(*t)
    hk.reset_launches()
    assert not bool(torch.isfinite(got[5]).all())
    keep = torch.arange(16, device="cuda") != 5
    assert bool(torch.isfinite(got[keep]).all())
    scale = float(ref[keep].abs().max())
    assert float((got[keep] - ref[keep]).abs().max()) <= 1e-11 * scale

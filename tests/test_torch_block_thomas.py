"""Block-tridiagonal solves of the PyTorch port (mpp_tpu_torch/ops/
block_thomas.py and the block_thomas2 wrapper of ops/hopper_kernels.py)
against the JAX package (mpp_tpu/ops/block_thomas.py and the Pallas
pallas_block_thomas2, run in interpret mode as its own tests run it).

Tolerances: rtol 1e-10 for the solves (the same recurrences; only the
summation order of the tiny matmuls and libm can differ, amplified by the
elimination over the levels), rtol 1e-12 for the matvec and the f64 2x2
sweep against the JAX scan, rtol/atol 2e-5 for f32 against the Pallas
kernel (it multiplies by 1/det where the plain form divides).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpp_tpu.ops import block_thomas as jbt
from mpp_tpu.ops.pallas_kernels import pallas_block_thomas2
from mpp_tpu_torch.ops import block_thomas as tbt
from mpp_tpu_torch.ops import hopper_kernels as hk


@pytest.fixture(autouse=True)
def _fresh_counters():
    hk.reset_launches()
    yield
    # CPU tensors never launch a kernel
    assert all(v == 0 for v in hk.LAUNCHES.values()), hk.LAUNCHES


def _system(B, n, m, seed, np_dtype=np.float64):
    """Random block-tridiagonal systems with dominant diagonal blocks (as
    tests/test_block_thomas.py)."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(B, n, m, m))
    U = rng.normal(size=(B, n, m, m))
    D = rng.normal(size=(B, n, m, m)) + 6.0 * np.eye(m)
    b = rng.normal(size=(B, n, m))
    return tuple(a.astype(np_dtype) for a in (L, D, U, b))


def _pallas_system(ncol, n, seed, np_dtype):
    """The systems of tests/test_pallas_kernels.py:97-103."""
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((ncol, n, 2, 2)) * 0.2
    U = rng.standard_normal((ncol, n, 2, 2)) * 0.2
    D = rng.standard_normal((ncol, n, 2, 2))
    D[..., 0, 0] += 3.0
    D[..., 1, 1] += 3.0
    b = rng.standard_normal((ncol, n, 2))
    return tuple(a.astype(np_dtype) for a in (L, D, U, b))


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5])
def test_block_thomas_matches_jax(m):
    L, D, U, b = _system(3, 7, m, seed=m)
    ref = np.asarray(jbt.block_thomas(*(jnp.asarray(a) for a in
                                        (L, D, U, b))))
    got = tbt.block_thomas(*(torch.as_tensor(a) for a in (L, D, U, b)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 8])
def test_small_solve_matches_jax_with_pivoting(m):
    """Including systems that need a row swap (zero leading diagonal),
    as tests/test_block_thomas.py:67-82."""
    rng = np.random.default_rng(7 + m)
    A = rng.standard_normal((6, 3, m, m))
    if m >= 2:
        A[0, 0, 0, 0] = 0.0
    if m >= 3:
        A[1, 2, 1, 1] = 0.0
    B = rng.standard_normal((6, 3, m, 2))
    got = tbt.small_solve(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    ref = np.asarray(jbt.small_solve(jnp.asarray(A), jnp.asarray(B)))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(got, np.linalg.solve(A, B), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("m", [1, 2, 4])
def test_block_tridiag_matvec_matches_jax(m):
    L, D, U, x = _system(3, 9, m, seed=20 + m)
    ref = np.asarray(jbt.block_tridiag_matvec(*(jnp.asarray(a) for a in
                                                (L, D, U, x))))
    got = tbt.block_tridiag_matvec(*(torch.as_tensor(a) for a in
                                     (L, D, U, x)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)
    # and it inverts the solve
    xs = tbt.block_thomas(*(torch.as_tensor(a) for a in (L, D, U, x)))
    back = tbt.block_tridiag_matvec(*(torch.as_tensor(a) for a in
                                      (L, D, U)), xs)
    np.testing.assert_allclose(back.numpy(), x, rtol=1e-10, atol=1e-10)


def test_block_thomas2_matches_pallas_interpret_f32():
    """The wrapper on CPU tensors (its plain version) against the Pallas
    kernel in interpret mode at f32 [256, 32]."""
    L, D, U, b = _pallas_system(256, 32, 0, np.float32)
    ref = np.asarray(pallas_block_thomas2(
        *(jnp.asarray(a) for a in (L, D, U, b)), interpret=True))
    got = hk.block_thomas2(*(torch.as_tensor(a) for a in (L, D, U, b)))
    assert got.dtype == torch.float32 and got.shape == (256, 32, 2)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-5, atol=2e-5)


# the level counts the CUDA kernel's tiling and chunking must get right
# (chip_smoke.py adds 500 on the card)
EDGE_LEVELS = [1, 2, 7, 31, 33, 100, 257]


@pytest.mark.parametrize("n", [30, 7] + [n for n in EDGE_LEVELS if n != 7])
def test_block_thomas2_matches_jax_scan_f64(n):
    L, D, U, b = _pallas_system(64, n, n, np.float64)
    ref = np.asarray(jbt.block_thomas(*(jnp.asarray(a) for a in
                                        (L, D, U, b))))
    got = hk.block_thomas2(*(torch.as_tensor(a) for a in (L, D, U, b)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-12)


def _bad_inputs():
    blk = torch.ones(4, 8, 2, 2, dtype=torch.float64)
    b = torch.ones(4, 8, 2, dtype=torch.float64)
    return {
        "int dtype": (blk.long(), blk.long(), blk.long(), b.long()),
        "mixed dtypes": (blk, blk.float(), blk, b),
        "block shape": (blk, blk, torch.ones(4, 8, 3, 3,
                                             dtype=torch.float64), b),
        "rhs shape": (blk, blk, blk, torch.ones(4, 8, 3,
                                                dtype=torch.float64)),
        "level mismatch": (blk, blk, blk, torch.ones(4, 9, 2,
                                                     dtype=torch.float64)),
        "2-d rhs": (blk, blk, blk, b[..., 0]),
        "non-contiguous": (blk.transpose(0, 1).contiguous().transpose(0, 1),
                           blk, blk, b),
        "not a tensor": (blk.numpy(), blk, blk, b),
        "meta device": (blk.to("meta"), blk.to("meta"), blk.to("meta"),
                        b.to("meta")),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_block_thomas2_bad_inputs_raise(case):
    with pytest.raises(ValueError):
        hk.block_thomas2(*_bad_inputs()[case])


def _gpu_system(ncol, n, seed):
    """Block diagonally dominant systems (chip_smoke.py's block_systems)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(seed)
    L = 0.2 * rng.standard_normal((ncol, n, 2, 2))
    U = 0.2 * rng.standard_normal((ncol, n, 2, 2))
    D = 0.2 * rng.standard_normal((ncol, n, 2, 2))
    D[..., 0, 0] = 2.5 + rng.random((ncol, n))
    D[..., 1, 1] = 2.5 + rng.random((ncol, n))
    b = rng.standard_normal((ncol, n, 2))
    return L, D, U, b


GPU_TOLS = ((torch.float64, 1e-12), (torch.float32, 2e-5))


@pytest.mark.cuda
def test_block_thomas2_kernel_matches_plain_on_gpu():
    """On the card: the CUDA kernel against its plain version at the TH
    shape (run there with `python -m pytest -m cuda tests/`)."""
    L, D, U, b = _gpu_system(4096, 64, 3)
    for dtype, tol in GPU_TOLS:
        t = [torch.as_tensor(a, dtype=dtype, device="cuda")
             for a in (L, D, U, b)]
        got = hk.block_thomas2(*t)
        ref = tbt.block_thomas(*t)
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=tol * float(ref.abs().max()))
    assert hk.LAUNCHES["block_thomas2"] == 2
    hk.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("n", EDGE_LEVELS + [500])
@pytest.mark.parametrize("ncol", [1000, 8193])
@pytest.mark.parametrize("dtype,tol", GPU_TOLS, ids=["f64", "f32"])
def test_block_thomas2_kernel_edge_shapes_on_gpu(ncol, n, dtype, tol):
    """On the card: the kernel where its tiles of 32 columns and its level
    chunks end ragged, and where Cp and dp leave shared memory (n >= 257
    in f64, n=500 in f32); tolerance of max |x|."""
    t = [torch.as_tensor(a, dtype=dtype, device="cuda")
         for a in _gpu_system(ncol, n, 6)]
    top = hk.max_on_chip("block_thomas2", dtype)
    assert (n > top) == (n >= (257 if dtype == torch.float64 else 500))
    got, ref = hk.block_thomas2(*t), tbt.block_thomas(*t)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=tol * float(ref.abs().max()))
    assert hk.LAUNCHES["block_thomas2"] == 1
    hk.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", GPU_TOLS, ids=["f64", "f32"])
def test_block_thomas2_kernel_misaligned_inputs_on_gpu(dtype, tol):
    """On the card: inputs that start one element into a larger buffer
    (data_ptr not 16-byte aligned)."""
    t = []
    for a in _gpu_system(1000, 31, 7):
        buf = torch.empty(a.size + 1, dtype=dtype, device="cuda")
        t.append(buf[1:].view(a.shape).copy_(torch.as_tensor(a)))
    assert all(a.data_ptr() % 16 for a in t)
    got, ref = hk.block_thomas2(*t), tbt.block_thomas(*t)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=tol * float(ref.abs().max()))
    hk.reset_launches()

"""Kernel wrappers of the PyTorch port (mpp_tpu_torch/ops/hopper_kernels.py)
against the JAX package's Pallas kernels (mpp_tpu/ops/pallas_kernels.py).

On the CPU the JAX functions take their jnp fallback and the port's
wrappers take their plain PyTorch versions, so these tests hold the plain
versions to the JAX arithmetic.  The CUDA kernels themselves are held to
the plain versions on the card by chip_smoke.py and by the ``cuda``-marked
test below.

Tolerances: f64 rtol 1e-12 and f32 rtol 1e-5 (the same recurrences; the
JAX f32 Thomas fallback and the port's plain form both divide by denom,
so only summation order can differ); the mixed action rtol 1e-5 (f32
arithmetic on bf16-rounded bands, both rounding to nearest even).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpp_tpu.ops import pallas_kernels as pk
from mpp_tpu_torch.ops import hopper_kernels as hk
from mpp_tpu_torch.ops import tridiag

SHAPES = [(16, 32), (8, 30)]
# the level counts the CUDA Thomas kernel's tiling and chunking must get
# right (chip_smoke.py adds 500 and 900 on the card), at small ncol here
EDGE_LEVELS = [1, 2, 7, 31, 33, 100, 257]
EDGE_SHAPES = [(5 + i % 2 * 4, nz) for i, nz in enumerate(EDGE_LEVELS)]
DTYPES = [(np.float64, torch.float64, 1e-12), (np.float32, torch.float32, 1e-5)]


def _bands(shape, seed, np_dtype):
    rng = np.random.default_rng(seed)
    dl = (rng.random(shape) - 0.5).astype(np_dtype)
    du = (rng.random(shape) - 0.5).astype(np_dtype)
    d = (2.5 + rng.random(shape)).astype(np_dtype)     # diagonally dominant
    x = rng.standard_normal(shape).astype(np_dtype)
    return dl, d, du, x


@pytest.fixture(autouse=True)
def _fresh_counters():
    hk.reset_launches()
    yield
    # CPU tensors never launch a kernel
    assert all(v == 0 for v in hk.LAUNCHES.values()), hk.LAUNCHES


@pytest.mark.parametrize("shape", SHAPES + EDGE_SHAPES)
@pytest.mark.parametrize("np_dtype,dtype,rtol", DTYPES)
def test_thomas_matches_pallas_thomas(shape, np_dtype, dtype, rtol):
    """The wrapper on CPU tensors (its plain version) against the JAX
    package's pallas_thomas, which solves with mpp_tpu.ops.tridiag.thomas
    off the TPU."""
    dl, d, du, b = _bands(shape, 0, np_dtype)
    ref = np.asarray(pk.pallas_thomas(*(jnp.asarray(a) for a in
                                        (dl, d, du, b))))
    got = hk.thomas(*(torch.as_tensor(a) for a in (dl, d, du, b)))
    assert got.dtype == dtype and got.shape == shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol, atol=0)
    # and it solves the system
    T = torch.as_tensor
    resid = tridiag.tridiag_matvec(T(dl), T(d), T(du), got) - T(b)
    assert float(resid.abs().max()) < 50 * rtol


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("np_dtype,dtype,rtol", DTYPES)
def test_tridiag_spmv_matches_pallas(shape, np_dtype, dtype, rtol):
    dl, d, du, x = _bands(shape, 1, np_dtype)
    ref = np.asarray(pk.tridiag_spmv(*(jnp.asarray(a) for a in
                                       (dl, d, du, x))))
    got = hk.tridiag_spmv(*(torch.as_tensor(a) for a in (dl, d, du, x)))
    assert got.dtype == dtype
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol, atol=rtol)


@pytest.mark.parametrize("shape", SHAPES)
def test_tridiag_spmv_mixed_matches_pallas(shape):
    dl, d, du, x = _bands(shape, 2, np.float32)
    bands_j = [jnp.asarray(a).astype(jnp.bfloat16) for a in (dl, d, du)]
    bands_t = [torch.as_tensor(a).to(torch.bfloat16) for a in (dl, d, du)]
    # the bf16 casts round identically (round to nearest even in both)
    for bj, bt in zip(bands_j, bands_t):
        np.testing.assert_array_equal(
            np.asarray(bj).view(np.uint16),
            bt.view(torch.int16).numpy().view(np.uint16))
    ref = np.asarray(pk.tridiag_spmv_mixed(*bands_j, jnp.asarray(x)))
    got = hk.tridiag_spmv_mixed(*bands_t, torch.as_tensor(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def _bad_inputs():
    a = torch.ones(4, 8, dtype=torch.float64)
    return {
        "int dtype": (a.long(), a.long(), a.long(), a.long()),
        "mixed dtypes": (a, a.float(), a, a),
        "shape mismatch": (a, a, a, torch.ones(4, 9, dtype=torch.float64)),
        "1-d": (a[0], a[0], a[0], a[0]),
        "non-contiguous": (a.t(), a.t(), a.t(), a.t()),
        "not a tensor": (a.numpy(), a, a, a),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
@pytest.mark.parametrize("fn", [hk.thomas, hk.tridiag_spmv],
                         ids=["thomas", "tridiag_spmv"])
def test_bad_inputs_raise(fn, case):
    with pytest.raises(ValueError):
        fn(*_bad_inputs()[case])


def test_mixed_rejects_wide_bands_and_wide_state():
    a32 = torch.ones(4, 8, dtype=torch.float32)
    b16 = a32.to(torch.bfloat16)
    with pytest.raises(ValueError):
        hk.tridiag_spmv_mixed(a32, a32, a32, a32)
    with pytest.raises(ValueError):
        hk.tridiag_spmv_mixed(b16, b16, b16, a32.double())


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


@pytest.mark.cuda
def test_kernels_match_plain_on_gpu():
    """On the card: each kernel against its plain version at the ALM
    shape (run there with `python -m pytest -m cuda tests/`)."""
    _needs_gpu()
    for np_dtype, dtype, rtol in DTYPES:
        dl, d, du, x = (torch.as_tensor(a, device="cuda")
                        for a in _bands((4096, 30), 3, np_dtype))
        pairs = [(hk.thomas(dl, d, du, x), tridiag.thomas(dl, d, du, x)),
                 (hk.tridiag_spmv(dl, d, du, x),
                  tridiag.tridiag_matvec(dl, d, du, x))]
        if dtype == torch.float32:
            b16 = [t.to(torch.bfloat16) for t in (dl, d, du)]
            pairs.append((hk.tridiag_spmv_mixed(*b16, x),
                          hk.tridiag_spmv_mixed_plain(*b16, x)))
        for got, ref in pairs:
            torch.testing.assert_close(got, ref, rtol=rtol, atol=rtol)
    hk.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("nz", EDGE_LEVELS + [500, 900])
@pytest.mark.parametrize("ncol", [1000, 8193])
@pytest.mark.parametrize("np_dtype,dtype,rtol", DTYPES)
def test_thomas_kernel_edge_shapes_on_gpu(ncol, nz, np_dtype, dtype, rtol):
    """On the card: the Thomas kernel against its plain version where its
    tiles of 32 columns and its level chunks end ragged, and where cp and
    bp leave shared memory (nz=500 in f64, nz=900 in both); tolerance of
    max |x|."""
    _needs_gpu()
    top = hk.max_on_chip("thomas", dtype)
    assert (nz > top) == (nz >= (500 if dtype == torch.float64 else 900))
    dl, d, du, b = (torch.as_tensor(a, device="cuda")
                    for a in _bands((ncol, nz), 4, np_dtype))
    got, ref = hk.thomas(dl, d, du, b), tridiag.thomas(dl, d, du, b)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=rtol * float(ref.abs().max()))
    assert hk.LAUNCHES["thomas"] == 1
    hk.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("np_dtype,dtype,rtol", DTYPES)
def test_thomas_kernel_misaligned_inputs_on_gpu(np_dtype, dtype, rtol):
    """On the card: inputs that start one element into a larger buffer
    (data_ptr not 16-byte aligned)."""
    _needs_gpu()
    shape = (1000, 31)
    args = []
    for a in _bands(shape, 5, np_dtype):
        buf = torch.empty(a.size + 1, dtype=dtype, device="cuda")
        args.append(buf[1:].view(shape).copy_(torch.as_tensor(a)))
    assert all(t.data_ptr() % 16 for t in args)
    got, ref = hk.thomas(*args), tridiag.thomas(*args)
    torch.testing.assert_close(got, ref, rtol=0,
                               atol=rtol * float(ref.abs().max()))
    hk.reset_launches()

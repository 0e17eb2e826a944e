"""The SpMV family of the PyTorch port against the JAX package.

* ``hopper_kernels.tridiag_spmv_chain`` / ``tridiag_jacobi_smooth`` on CPU
  tensors (their plain versions) against ``mpp_tpu.ops.pallas_kernels``'
  functions (their jnp path on the CPU): f64 rtol 1e-12, f32 rtol 1e-5 (the
  same operations in the same order; only XLA's and torch's CPU kernels
  differ, by contraction or vector width).
* The harness ``mpp_tpu_torch/tools/exp_spmv.py`` against the JAX tool
  ``tools/exp_spmv.py``, loaded by path and run under
  ``pltpu.force_tpu_interpret_mode()``: ``pallas_kernel(8)``,
  ``bf16_variant(8)`` and ``packed_kernel(8)`` at [16, 128] f32, single
  applications to 1e-6 of max |y| and chained sums (3 applications) to
  rtol 1e-5.  The JAX tool's roll and grid-semantics variants cannot run
  here: ``pallas_kernel(..., roll=True)`` raises "shift must be
  non-negative" in interpret mode (its ``pltpu.roll(xx, -1, 1)``), and
  ``pallas_kernel_cp`` raises AttributeError (this JAX has no
  ``pltpu.TPUCompilerParams``).  They compute the tool's ``jnp_concat``,
  so the port's forms are held to that.

The CUDA kernels are held to the plain versions on the card by
chip_smoke.py phases (k) and (l) and by the ``cuda``-marked tests below.
"""
import importlib.util
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mpp_tpu.ops import pallas_kernels as pk
from mpp_tpu.ops.tridiag import thomas as jthomas
from mpp_tpu_torch.ops import hopper_kernels as hk
from mpp_tpu_torch.ops import tridiag
from mpp_tpu_torch.tools import exp_spmv as te

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = [(16, 32), (8, 30), (4, 128)]
ITERS = [1, 4, 30]
DTYPES = [(np.float64, torch.float64, 1e-12),
          (np.float32, torch.float32, 1e-5)]
HARNESS_SHAPE = (16, 128)
HARNESS_ITERS = 3


@pytest.fixture(autouse=True)
def _fresh_counters():
    hk.reset_launches()
    yield
    # CPU tensors never launch a kernel
    assert all(v == 0 for v in hk.LAUNCHES.values()), hk.LAUNCHES


def _system(shape, seed, np_dtype):
    """Diagonally dominant bands, x and b; ||T||_inf <= 4.5."""
    rng = np.random.default_rng(seed)
    dl = (rng.random(shape) - 0.5).astype(np_dtype)
    du = (rng.random(shape) - 0.5).astype(np_dtype)
    d = (2.5 + rng.random(shape)).astype(np_dtype)
    x = rng.standard_normal(shape).astype(np_dtype)
    b = rng.standard_normal(shape).astype(np_dtype)
    return dl, d, du, x, b


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("np_dtype,dtype,rtol", DTYPES)
def test_chain_matches_pallas(shape, iters, np_dtype, dtype, rtol):
    dl, d, du, x, _ = _system(shape, 0, np_dtype)
    scale = 0.25                       # ||scale T||_inf <= 1
    ref = pk.tridiag_spmv_chain(*(jnp.asarray(a) for a in (dl, d, du, x)),
                                iters=iters, scale=scale)
    got = hk.tridiag_spmv_chain(*(torch.as_tensor(a) for a in
                                  (dl, d, du, x)), iters, scale)
    assert got.dtype == dtype
    _close(got, ref, rtol)


@pytest.mark.parametrize("iters", ITERS)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("np_dtype,dtype,rtol", DTYPES)
def test_jacobi_matches_pallas(shape, iters, np_dtype, dtype, rtol):
    dl, d, du, x, b = _system(shape, 1, np_dtype)
    ref = pk.tridiag_jacobi_smooth(*(jnp.asarray(a) for a in
                                     (dl, d, du, b, x)), iters=iters)
    got = hk.tridiag_jacobi_smooth(*(torch.as_tensor(a) for a in
                                     (dl, d, du, b, x)), iters)
    assert got.dtype == dtype
    _close(got, ref, rtol)


def test_jacobi_converges_to_thomas():
    """200 sweeps at omega=0.9 reach the Thomas solution (the system and
    tolerance of tests/test_pallas_kernels.py:36-44)."""
    rng = np.random.default_rng(0)
    shape = (16, 32)
    d = rng.uniform(4.0, 5.0, shape)
    dl = rng.uniform(0.1, 0.9, shape)
    du = rng.uniform(0.1, 0.9, shape)
    b = np.random.default_rng(7).uniform(-1.0, 1.0, shape)
    T = torch.as_tensor
    x = hk.tridiag_jacobi_smooth(T(dl), T(d), T(du), T(b),
                                 torch.zeros(shape, dtype=torch.float64),
                                 200, omega=0.9)
    x_exact = hk.thomas(T(dl), T(d), T(du), T(b))
    np.testing.assert_allclose(x.numpy(), x_exact.numpy(), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(
        x_exact.numpy(), np.asarray(jthomas(*(jnp.asarray(a) for a in
                                               (dl, d, du, b)))),
        rtol=1e-12)


def test_zero_iterations_return_x():
    dl, d, du, x, b = (torch.as_tensor(a) for a in
                       _system((4, 8), 2, np.float64))
    assert torch.equal(hk.tridiag_spmv_chain(dl, d, du, x, 0, 0.5), x)
    assert torch.equal(hk.tridiag_jacobi_smooth(dl, d, du, b, x, 0), x)


# --- the harness ------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_tool():
    """The JAX package's tools/exp_spmv.py, loaded by path, with ITERS cut
    before any chained function traces it."""
    spec = importlib.util.spec_from_file_location(
        "jax_exp_spmv", ROOT / "tools" / "exp_spmv.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.ITERS = HARNESS_ITERS
    return mod


@pytest.fixture(scope="module")
def harness_inputs():
    """(numpy, JAX, torch) forms of the harness's bands and x at
    HARNESS_SHAPE, drawn as the port's ``inputs`` draws them."""
    t = te.inputs(*HARNESS_SHAPE, seed=3, device="cpu")
    arrs = tuple(a.numpy() for a in t)
    return arrs, tuple(jnp.asarray(a) for a in arrs), t


def _sum_close(got, ref):
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def _apply(variant, t):
    return variant.apply(*variant.prep(*t), t[3])


@pytest.mark.parametrize("name", ["pallas_kernel", "bf16_variant"])
def test_harness_variant_matches_jax_tool(jax_tool, harness_inputs, name):
    _, j, t = harness_inputs
    with pltpu.force_tpu_interpret_mode():
        ref = getattr(jax_tool, name)(8)(*j)
        ref_sum = jax_tool.chained(getattr(jax_tool, name)(8))(*j)
    variant = getattr(te, name)(8)
    _close(_apply(variant, t), ref, 1e-6)
    _sum_close(te.chained(variant, HARNESS_ITERS)(*t), ref_sum)


def test_harness_packed_matches_jax_tool(jax_tool, harness_inputs):
    _, j, t = harness_inputs
    with pltpu.force_tpu_interpret_mode():
        ref_sum = jax_tool.packed_kernel(8)(*j)
    _sum_close(te.chained(te.packed_kernel(8), HARNESS_ITERS)(*t), ref_sum)
    ops = te.packed_kernel(8).prep(*t)
    assert ops[0].shape == (HARNESS_SHAPE[0], 3 * HARNESS_SHAPE[1])


@pytest.mark.parametrize("variant", [
    te.pallas_kernel(8, roll=True), te.pallas_kernel_cp(8, "arbitrary"),
    te.pallas_kernel_cp(8, "parallel")], ids=["roll", "arbitrary", "parallel"])
def test_harness_roll_and_cp_match_jnp_concat(jax_tool, harness_inputs,
                                              variant):
    """The JAX tool's roll and _cp forms do not run here (module
    docstring); they compute its jnp_concat."""
    _, j, t = harness_inputs
    _close(_apply(variant, t), jax_tool.jnp_concat(*j), 1e-6)
    _sum_close(te.chained(variant, HARNESS_ITERS)(*t),
               jax_tool.chained(jax_tool.jnp_concat)(*j))


@pytest.mark.parametrize("name", ["jnp_concat", "jnp_pad"])
def test_harness_torch_forms_match_jax_tool(jax_tool, harness_inputs, name):
    _, j, t = harness_inputs
    _close(getattr(te, name)(*t), getattr(jax_tool, name)(*j), 1e-6)


def test_harness_ceiling_body(harness_inputs):
    """The ceiling's one pass is the JAX tool's loop body
    min(a + x*(b - x*c), 2) * 0.9 with (a, b, c) = (dl, d, du)."""
    (a, b, c, x), _, t = harness_inputs
    want = np.minimum(a + x * (b - x * c), 2.0) * 0.9
    _close(_apply(te.CEILING, t), want.astype(np.float32), 1e-6)
    _sum_close(te.chained(te.CEILING, 2)(*t),
               (np.minimum(a + want * (b - want * c), 2.0) * 0.9).sum())


def test_harness_variant_list_and_inputs():
    names = list(te.variants())
    assert names[:5] == ["pallas_b512", "pallas_b1024", "pallas_b2048",
                         "pallas_b4096", "pallas_roll_b1024"]
    assert len(names) == 14 and len(te.variants(fast=True)) == 4
    dl, d, du, x = te.inputs(8, 16, device="cpu")
    assert all(a.dtype == torch.float32 and a.shape == (8, 16)
               for a in (dl, d, du, x))
    assert 1.0 <= float(d.min()) and float(d.max()) <= 2.0
    assert 0.1 <= float(dl.min()) and float(du.max()) <= 0.2


def test_harness_refuses_to_run_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        te.run(data=te.inputs(8, 16, device="cpu"))


# --- wrapper checks ---------------------------------------------------------
def _bad_calls():
    a = torch.ones(4, 8, dtype=torch.float64)
    f = a.float()
    wide = torch.ones(2, hk.RESIDENT_MAX_NZ + 1, dtype=torch.float64)
    return {
        "chain nz above the resident limit":
            lambda: hk.tridiag_spmv_chain(wide, wide, wide, wide, 1),
        "chain negative iters": lambda: hk.tridiag_spmv_chain(a, a, a, a, -1),
        "chain float iters": lambda: hk.tridiag_spmv_chain(a, a, a, a, 2.0),
        "chain mixed dtypes": lambda: hk.tridiag_spmv_chain(a, f, a, a, 1),
        "jacobi nz above the resident limit":
            lambda: hk.tridiag_jacobi_smooth(wide, wide, wide, wide, wide, 1),
        "jacobi shape mismatch": lambda: hk.tridiag_jacobi_smooth(
            a, a, a, torch.ones(4, 9, dtype=torch.float64), a, 1),
        "jacobi non-contiguous": lambda: hk.tridiag_jacobi_smooth(
            a, a, a, a, torch.ones(8, 4, dtype=torch.float64).t(), 1),
        "variant f64": lambda: hk.spmv_variant(a, a, a, a, block=2),
        "variant exchange": lambda: hk.spmv_variant(f, f, f, f, "shift", 2),
        "variant grid": lambda: hk.spmv_variant(f, f, f, f, "roll", 2, "x"),
        "variant block not dividing ncol":
            lambda: hk.spmv_variant(f, f, f, f, "concat", 3),
        "packed t shape": lambda: hk.spmv_packed(f, f),
        "packed t dtype": lambda: hk.spmv_packed(
            torch.ones(4, 24, dtype=torch.float64), f),
        "ceiling f64": lambda: hk.stream_ceiling(a, a, a, a),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls()))
def test_bad_inputs_raise(case):
    with pytest.raises(ValueError):
        _bad_calls()[case]()


def test_resident_limit_is_accepted():
    n = hk.RESIDENT_MAX_NZ
    dl, d, du, x, b = (torch.as_tensor(a) for a in
                       _system((2, n), 4, np.float64))
    y = hk.tridiag_spmv_chain(dl, d, du, x, 2, 0.25)
    _close(y, tridiag.tridiag_matvec(dl, d, du, tridiag.tridiag_matvec(
        dl, d, du, x) * 0.25).numpy() * 0.25, 1e-12)
    assert hk.tridiag_jacobi_smooth(dl, d, du, b, x, 2).shape == (2, n)


# --- on the card ------------------------------------------------------------
def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 30), (256, 64), (64, 300)])
@pytest.mark.parametrize("np_dtype,dtype,rtol", DTYPES)
def test_resident_kernels_match_plain_on_gpu(shape, np_dtype, dtype, rtol):
    """The chain and the smoother on the card against their plain
    versions (run there with `python -m pytest -m cuda tests/`)."""
    _cuda_or_skip()
    dl, d, du, x, b = (torch.as_tensor(a, device="cuda") for a in
                       _system(shape, 5, np_dtype))
    pairs = [(hk.tridiag_spmv_chain(dl, d, du, x, 30, 0.25),
              tridiag.tridiag_spmv_chain(dl, d, du, x, 30, 0.25)),
             (hk.tridiag_jacobi_smooth(dl, d, du, b, x, 30, 0.9),
              tridiag.tridiag_jacobi_smooth(dl, d, du, b, x, 30, 0.9))]
    for got, ref in pairs:
        scale = float(ref.abs().max())
        assert float((got - ref).abs().max()) <= rtol * scale
    hk.reset_launches()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pallas_b128", "pallas_roll_b1024",
                                  "pallas_b256_arb", "pallas_b512_par",
                                  "pallas_bf16diag_b1024",
                                  "pallas_packed_b512"])
def test_harness_kernels_match_plain_on_gpu(name):
    _cuda_or_skip()
    t = te.inputs(2048, 256, seed=6, device="cuda")
    for v in (te.variants()[name], te.CEILING):
        ops = v.prep(*t)
        got, ref = v.apply(*ops, t[3]), v.plain(*ops, t[3])
        assert float((got - ref).abs().max()) <= \
            te.RTOL * float(ref.abs().max())
    hk.reset_launches()

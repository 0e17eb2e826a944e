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


# ---- the route by shape and the cluster form's plan (host side) ------------

#: the block plans' and the MLC's shapes (chip_smoke.BTL_PATHS) and the form
#: the rule gives each
PATH_FORMS = (((1, 30, 200), torch.float64, "cluster"),
              ((1, 2, 40), torch.float64, "block"),
              ((1, 20, 20), torch.float64, "block"),
              ((4096, 93, 10), torch.float32, "block"),
              ((4096, 93, 10), torch.float64, "block"))


@pytest.mark.parametrize("shape,dtype,form", PATH_FORMS,
                         ids=[f"{s}-{str(d)[6:]}" for s, d, _ in PATH_FORMS])
def test_rule_picks_the_form_at_every_path_shape(shape, dtype, form):
    """As the forms' device times at these shapes have it (``resident_
    variants.py --btl-forms``): the cluster form at vchannel's one system
    of b = 200, the block form at spac_campbell's one system of b = 40,
    the 2-D MMS's of b = 20 and the MLC's 4096 systems."""
    nsys, n, m = shape
    assert hk.btl_form(nsys, m, dtype) == form
    plan = hk.btl_launch(nsys, n, m, dtype)
    assert plan["form"] == form and plan["code"] == hk.BTL_FORMS.index(form)
    assert (plan["ctas"] > 0) == (form == "cluster")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_rule_is_monotone_in_systems_and_block_size(dtype):
    """Fewer systems or wider blocks never leave the cluster form (within
    the blocks the cluster plan covers); its edges: m 47 / 48 at one
    system, 8 / 9 systems at m = 119, 132 / 133 past it."""
    assert hk.btl_form(1, 47, dtype) == "block"
    assert hk.btl_form(1, 48, dtype) == "cluster"
    assert hk.btl_form(8, 119, dtype) == "cluster"
    assert hk.btl_form(9, 119, dtype) == "block"
    assert hk.btl_form(132, 120, dtype) == "cluster"
    assert hk.btl_form(133, 120, dtype) == "block"
    systems = (1, 2, 4, 8, 16, 33, 132, 528, 4096)
    sizes = [m for m in range(hk.BLOCK_LARGE_MIN, 1025)
             if hk.btl_cluster_plan(m) is not None]
    assert sizes[-1] == 1024
    for m in sizes[::7] + [sizes[-1]]:
        picks = [hk.btl_form(B, m, dtype) == "cluster" for B in systems]
        assert picks == sorted(picks, reverse=True), (m, picks)
    for B in systems:
        picks = [hk.btl_form(B, m, dtype) == "cluster" for m in sizes]
        assert picks == sorted(picks), (B, picks)


@pytest.mark.parametrize("form", ["block", "cluster"])
def test_forced_form_is_the_wrapper_launch(monkeypatch, form):
    """Tests and tools force a form by patching the rule's thresholds; the
    launch then takes it (on the CPU the wrapper still runs the plain
    form)."""
    big = 1 << 30
    for name, value in zip(("BTL_CLUSTER_MIN_M", "BTL_CLUSTER_MAX_SYSTEMS",
                            "BTL_CLUSTER_MAX_SYSTEMS_WIDE"),
                           (0, big, big) if form == "cluster"
                           else (big, -1, -1)):
        monkeypatch.setattr(hk, name, value)
    for nsys, n, m in ((1, 30, 200), (4096, 93, 10), (33, 2, 9)):
        plan = hk.btl_launch(nsys, n, m, torch.float64)
        assert plan["form"] == form
        assert plan["code"] == hk.BTL_FORMS.index(form)
        want = hk.btl_cluster_plan(m)["ctas"] if form == "cluster" else 0
        assert plan["ctas"] == want
    got, ref = _both(_system((2,), 3, 12, seed=410),
                     through=hk.block_thomas_large)
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)


def test_unknown_form_raises(monkeypatch):
    monkeypatch.setattr(hk, "btl_form", lambda nsys, m, dtype: "bogus")
    with pytest.raises(ValueError, match="bogus"):
        hk.btl_launch(1, 2, 20, torch.float64)
    L, D, U, b = (torch.as_tensor(a) for a in _system((1,), 2, 20, 411))
    with pytest.raises(ValueError, match="bogus"):
        hk.block_thomas_large(L, D, U, b)


def _owners(m, ctas):
    """The cluster form's column ownership as the kernel computes it:
    panel g (16 columns) to CTA g % ctas, X's column j with denom's, the
    rhs (column m) to the CTA of panel m // 16; {cta: (denom columns, X
    columns)}."""
    own = {r: ([], []) for r in range(ctas)}
    for j in range(m):
        r = (j // hk.BTL_PANEL) % ctas
        own[r][0].append(j)
        own[r][1].append(j)
    own[(m // hk.BTL_PANEL) % ctas][1].append(m)
    return own


@pytest.mark.parametrize("m", [9, 16, 17, 31, 32, 33, 40, 64, 65, 119, 120,
                               200, 256, 257, 300, 512, 1024])
def test_cluster_plan_splits_the_columns(m):
    """Every CTA of the plan holds at least one panel; its columns fit its
    tile (panels_a_cta panels, the X part one more for the rhs); the tiles
    partition W's 2m + 1 columns; on-chip plans fit a CTA's shared
    memory, the rest a global scratch of the layout's size."""
    plan = hk.btl_cluster_plan(m)
    ctas, panels = plan["ctas"], plan["panels"]
    assert panels == -(-m // hk.BTL_PANEL)
    assert 1 <= ctas <= min(panels, hk.BTL_CLUSTER_MAX_CTAS)
    assert plan["panels_a_cta"] == -(-panels // ctas)
    own = _owners(m, ctas)
    cap = plan["panels_a_cta"] * hk.BTL_PANEL
    for r, (den, xs) in own.items():
        assert 0 < len(den) <= cap and len(xs) <= cap + 1
        assert plan["ld"] > 2 * cap and plan["ld"] % 2 == 1
    assert sorted(j for d, _ in own.values() for j in d) == list(range(m))
    assert sorted(j for _, x in own.values() for j in x) == \
        list(range(m + 1))
    assert plan["smem"] <= hk.ON_CHIP_BYTES
    if plan["on_chip"]:
        assert plan["scratch"] == 0
        assert plan["smem"] == plan["smem_on_chip"]
    else:
        assert plan["scratch"] == plan["big"] > 0
        assert plan["smem_on_chip"] > hk.ON_CHIP_BYTES
        assert ctas == min(panels, hk.BTL_CLUSTER_MAX_CTAS)


def test_cluster_plan_takes_the_fewest_ctas_that_fit():
    """From the preferred count (fewer where m has fewer panels) up: the
    first count whose tiles fit shared memory; 8 CTAs at (r)'s m = 200,
    16 at m = 256, the scratch from m = 300 on, none past the small
    arrays' room."""
    assert hk.btl_cluster_plan(200)["ctas"] == 8
    assert hk.btl_cluster_plan(200)["on_chip"]
    assert hk.btl_cluster_plan(40)["ctas"] == 3
    assert hk.btl_cluster_plan(256)["ctas"] == 16
    assert not hk.btl_cluster_plan(300)["on_chip"]
    assert hk.btl_cluster_plan(6000) is None
    for m in (20, 64, 130, 200, 256):
        plan = hk.btl_cluster_plan(m)
        lo = min(hk.BTL_CLUSTER_CTAS, plan["panels"])
        for fewer in range(lo, plan["ctas"]):
            assert hk.btl_cluster_layout(m, fewer)["smem_on_chip"] > \
                hk.ON_CHIP_BYTES


def test_block_form_limit_and_scratch_sizes():
    assert hk.btl_block_max_on_chip() == 119
    assert hk.btl_block_smem(119, True) <= hk.ON_CHIP_BYTES < \
        hk.btl_block_smem(120, True)
    plan = hk.btl_launch(4096, 93, 10, torch.float32)
    assert (plan["cp"], plan["ws"]) == (4096 * 93 * 10 * 11, 0)
    plan = hk.btl_launch(200, 2, 120, torch.float64)
    assert plan["form"] == "block" and plan["ws"] == 200 * 120 * 241
    assert hk.btl_launch(1, 1, 200, torch.float64)["cp"] == 0
    plan = hk.btl_launch(2, 3, 512, torch.float64)
    assert plan["form"] == "cluster"
    assert plan["ws"] == 2 * plan["ctas"] * hk.btl_cluster_plan(512)["big"]


# ---- the measurement tool's block_thomas_large modes -----------------------

@pytest.mark.parametrize("mode", [["--btl"], ["--btl-forms"]],
                         ids=["btl", "btl_forms"])
def test_measurement_modes_refuse_to_run_without_cuda(monkeypatch, mode):
    from mpp_tpu_torch.tools import resident_variants as rv
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        rv.main(mode + ["--tree", "parent=."])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
def test_measurement_hold_accepts_plain_and_refuses_a_wrong_x(dtype):
    """The tool's gate: the plain solve holds; one off by 1e-9 of max |x|
    (f64) or 1e-3 (f32) does not."""
    from mpp_tpu_torch.tools import resident_variants as rv
    f64 = [torch.as_tensor(a) for a in _system((3,), 4, 12, seed=96,
                                               swap=True)]
    f32 = [a.float() for a in f64]
    args = f64 if dtype == torch.float64 else f32
    x = tbt.block_thomas(*args)
    rv._btl_hold(torch, "plain", x, f32, f64)
    bad = x.clone()
    bad[1, 2, 3] += (1e-9 if dtype == torch.float64 else 1e-3) * \
        float(x.abs().max())
    with pytest.raises(RuntimeError, match="off the plain form"):
        rv._btl_hold(torch, "perturbed", bad, f32, f64)


def test_measurement_variants_apply_to_the_source():
    """Every BTL_VARIANTS edit finds its text in the kernel's source."""
    from mpp_tpu_torch.tools import resident_variants as rv
    base = open(rv.os.path.join(rv._PKG, rv.BTL_SOURCE)).read()
    for name in rv.BTL_VARIANTS:
        assert rv.variant_source(name, rv.BTL_SOURCE, rv.BTL_VARIANTS) != base


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


@pytest.fixture
def force_form(monkeypatch):
    """Force block_thomas_large's form by patching the rule's
    thresholds."""
    def force(form):
        big = 1 << 30
        for name, value in zip(("BTL_CLUSTER_MIN_M",
                                "BTL_CLUSTER_MAX_SYSTEMS",
                                "BTL_CLUSTER_MAX_SYSTEMS_WIDE"),
                               (0, big, big) if form == "cluster"
                               else (big, -1, -1)):
            monkeypatch.setattr(hk, name, value)
    return force


@pytest.mark.cuda
@pytest.mark.parametrize("swap", [False, True], ids=["dominant", "swap"])
@pytest.mark.parametrize("n", [1, 2, 30])
@pytest.mark.parametrize("m", [9, 31, 32, 33, 64, 65, 119, 120, 200, 256])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("form", ["block", "cluster"])
def test_each_form_matches_plain_on_gpu(force_form, form, dtype, m, n, swap):
    """On the card, each form forced: the panel edges (31 / 32 / 33, 64 /
    65), the block form's shared-memory edge (119 / 120), (r)'s b = 200
    and m = 256 (16 CTAs), at 1, 2 and 33 systems."""
    _need_card()
    force_form(form)
    sys_np = _system((33,), n, m, seed=900 + m + n, swap=swap)
    assert hk.btl_launch(33, n, m, dtype)["form"] == form
    for B in (1, 2, 33):
        _hold_on_card([a[:B] for a in sys_np], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [300, 512])
def test_cluster_form_with_its_tiles_in_the_scratch_on_gpu(force_form, m):
    """Past the cluster's shared memory (the plan's on_chip False)."""
    _need_card()
    force_form("cluster")
    assert not hk.btl_cluster_plan(m)["on_chip"]
    for dtype in (torch.float64, torch.float32):
        _hold_on_card(_system((2,), 3, m, seed=950 + m, swap=True), dtype)


@pytest.mark.cuda
def test_cluster_layout_matches_the_launcher_on_gpu():
    """The plan's shared bytes and scratch values are the launcher's."""
    _need_card()
    from mpp_tpu_torch.ops import _build
    lib = _build.library()
    for m in (9, 20, 64, 119, 200, 256, 300, 1024, 4096):
        for ctas in (1, 2, 3, 8, 13, 16):
            lay = hk.btl_cluster_layout(m, ctas)
            assert lib.mpp_block_thomas_large_cluster_smem(m, ctas, 1) == \
                lay["smem_on_chip"]
            assert lib.mpp_block_thomas_large_cluster_smem(m, ctas, 0) == \
                lay["smem_off_chip"]
            assert lib.mpp_block_thomas_large_cluster_scratch(m, ctas) == \
                lay["big"]


@pytest.mark.cuda
def test_cluster_form_keeps_a_nan_in_its_system_on_gpu(force_form):
    """Under the cluster form, a NaN in one system's D reaches that
    system's x and no other's."""
    _need_card()
    force_form("cluster")
    L, D, U, b = _system((5,), 6, 70, seed=701)
    D[3, 2, 40, 7] = np.nan
    t = [torch.as_tensor(a, device="cuda") for a in (L, D, U, b)]
    got = hk.block_thomas_large(*t)
    ref = tbt.block_thomas(*t)
    hk.reset_launches()
    assert not bool(torch.isfinite(got[3]).all())
    keep = torch.arange(5, device="cuda") != 3
    assert bool(torch.isfinite(got[keep]).all())
    scale = float(ref[keep].abs().max())
    assert float((got[keep] - ref[keep]).abs().max()) <= 1e-11 * scale


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

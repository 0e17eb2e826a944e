"""The column assembly (``hopper_kernels.vsfm_column_assemble``).

On the CPU its plain form (``models/richards_column.column_assemble_plain``)
is held to ``RichardsGE._eval`` + ``CompiledVSFM._tri_assemble`` on
ALM-built problems: F, the bands and both; f64 and f32; with and without
the seepage BC; plain and down-regulated sinks; a gathered narrow batch.
The plan is chosen from the problem's structure: the ALM template is a
column, vchannel, a van Genuchten column and a coupled problem are not.

The ``cuda`` cases run the kernel against the eager ``_eval`` on the card
and one ALM step against the CPU's (``python -m pytest --noconftest -m cuda
tests/test_torch_vsfm_column_assembly.py`` on the card machine; no JAX).
"""
import numpy as np
import pytest
import torch

from mpp_tpu_torch.batched.vsfm_compiled import _take, compile_vsfm
from mpp_tpu_torch.constants import Cond
from mpp_tpu_torch.driver import alm
from mpp_tpu_torch.models import richards_column as rc
from mpp_tpu_torch.ops import hopper_kernels as hk

F64, F32 = torch.float64, torch.float32
MODES = ("residual", "bands", "both")
# the plain form against _eval on the CPU: the same operations in the same
# order, so equal within a few roundings
PLAIN_REL = 1e-12


def _problem(ncol, nz, dtype, device, seepage=True, downreg=False, seed=0):
    """An ALM column problem with per-column soils (a few distinct bsw, as
    a soil texture map gives), and one evaluation's inputs: the state, dt,
    the BC and sink values, the previous accumulation, a source and the
    dyn dict (temperature varying by cell)."""
    rng = np.random.default_rng(seed)
    shape = (ncol, nz)
    prob = alm.alm_vsfm_initialize(
        watsat=0.35 + 0.1 * rng.random(shape),
        hksat=0.004 * (0.5 + rng.random(shape)),
        bsw=2.0 + 0.5 * rng.integers(0, 5, shape),
        sucsat=20.0 + 20.0 * rng.random(shape),
        residual_sat=0.05 + 0.05 * rng.random(shape),
        dz=0.05 + 0.1 * rng.random(shape), area=0.5 + rng.random(ncol),
        P0=101325.0 + 2e4 * rng.standard_normal(shape),
        include_seepage_bc=seepage, dtype=dtype, device=device)
    g = prob.comp.goveqns[0]
    if downreg:
        # ET down-regulated by Campbell's factor, drainage by FETCH2's
        kinds = {"Evapotranspiration_Flux": Cond.DOWNREG_MASS_RATE_CAMPBELL,
                 "Drainage_Flux": Cond.DOWNREG_MASS_RATE_FETCH2}
        for cond in g.source_sinks:
            cond.itype = int(kinds.get(cond.name, cond.itype))
        nss = len(g.ss_value)
        g.ss_pot_sink_pressure[:] = -1e5 * (1.0 + rng.random(nss))
        g.ss_pot_sink_exponent[:] = 1.0 + 2.0 * rng.random(nss)
        g.invalidate()
    spec = rc.column_spec(g)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    dyn = dict(prob.dyn[0])
    dyn["temperature"] = t(283.15 + 20.0 * rng.random(shape))
    inputs = dict(
        P=prob.P, dt=t(np.full((ncol, 1), 1800.0)),
        bc=t(np.full((ncol, spec.nbc), 101325.0)
             + 5e3 * rng.standard_normal((ncol, spec.nbc))),
        ss=t(1e-4 * rng.standard_normal((ncol, spec.nss))),
        ap=t(rng.random(shape)), src=t(1e-4 * rng.random(shape)), dyn=dyn)
    return prob, g, spec, inputs


def _eager(prob, g, mode, x):
    """``_eval`` + ``_tri_assemble``: F - src and the bands."""
    F, v = g._eval(x["P"], x["dt"], x["bc"], x["ss"], x["ap"], x["dyn"],
                   mode != "bands", mode != "residual")
    F = None if F is None else F - x["src"]
    bands = None if v is None else prob.comp._tri_assemble(v)
    return {"residual": F, "bands": bands, "both": (F, bands)}[mode]


def _column(g, spec, mode, x):
    args = rc.column_inputs(g, spec, x["P"], x["dt"], x["bc"], x["ss"],
                            x["ap"], x["src"], x["dyn"], mode)
    return hk.vsfm_column_assemble(*args, spec=spec, mode=mode)


def _flat(out, mode):
    """(name, tensor) of a result in ``mode``."""
    if mode == "residual":
        return [("F", out)]
    bands = list(zip(("dl", "d", "du"), out if mode == "bands" else out[1]))
    return bands if mode == "bands" else [("F", out[0])] + bands


def _rel_gaps(got, ref, mode):
    """Each output's max |got - ref| over max |ref|."""
    return {k: float((a.double() - b.double()).abs().max()
                     / b.double().abs().max().clamp_min(1e-300))
            for (k, a), (_, b) in zip(_flat(got, mode), _flat(ref, mode))}


@pytest.mark.parametrize("gathered", [False, True])
@pytest.mark.parametrize("downreg", [False, True])
@pytest.mark.parametrize("seepage", [True, False])
@pytest.mark.parametrize("dtype", [F64, F32])
def test_plain_form_matches_eval(dtype, seepage, downreg, gathered):
    prob, g, spec, x = _problem(6, 10, dtype, "cpu", seepage, downreg)
    assert spec is not None and spec.downreg == downreg
    assert spec.nbc == int(seepage)
    if gathered:
        # the straggler batch: a gather of columns, as the compaction does
        idx = torch.tensor([4, 1, 3])
        x = {k: _take(v, idx) for k, v in x.items()}
    for mode in MODES:
        got = _column(g, spec, mode, x)
        ref = _eager(prob, g, mode, x)
        for k, gap in _rel_gaps(got, ref, mode).items():
            assert gap <= PLAIN_REL, (mode, k, gap)
        for k, t in _flat(got, mode):
            assert t.dtype == dtype and t.shape == x["P"].shape, k


def test_plain_form_without_dyn():
    """A column GE's staged constants stand in for absent dyn entries:
    the template column's own soils and geometry, no dyn at all."""
    prob, g, spec, x = _problem(3, 8, F64, "cpu")
    x["dyn"] = None
    for mode in MODES:
        got = _column(g, spec, mode, x)
        ref = _eager(prob, g, mode, x)
        for k, gap in _rel_gaps(got, ref, mode).items():
            assert gap <= PLAIN_REL, (mode, k, gap)


def test_modes_agree():
    """Each mode computes the same numbers as "both"."""
    _, g, spec, x = _problem(4, 7, F64, "cpu")
    F, bands = _column(g, spec, "both", x)
    assert torch.equal(_column(g, spec, "residual", x), F)
    for a, b in zip(_column(g, spec, "bands", x), bands):
        assert torch.equal(a, b)


def test_bad_inputs_raise():
    _, g, spec, x = _problem(4, 7, F64, "cpu")
    args = rc.column_inputs(g, spec, x["P"], x["dt"], x["bc"], x["ss"],
                            x["ap"], x["src"], x["dyn"], "both")
    i = rc.ARGS.index
    bad = {
        "mode": (args, "jacobian"),
        "missing": ([None if k == i("vol") else a
                     for k, a in enumerate(args)], "both"),
        "unread": (args, "bands"),
        "shape": ([a[:, :-1] if k == i("perm") else a
                   for k, a in enumerate(args)], "both"),
        "dtype": ([a.float() if k == i("alpha") else a
                   for k, a in enumerate(args)], "both"),
        "count": (args[:-1], "both"),
        "dt": ([a[:, 0] if k == i("dt") else a
                for k, a in enumerate(args)], "both"),
    }
    for case, (a, mode) in bad.items():
        with pytest.raises(ValueError):
            hk.vsfm_column_assemble(*a, spec=spec, mode=mode)


def test_alm_template_is_a_column():
    prob, g, spec, _ = _problem(2, 5, F64, "cpu")
    comp = prob.comp
    assert comp.assembly == "column" and comp.is_tridiag
    assert spec.n == 5 and spec.tgdpb01 and not spec.linear_porosity
    assert spec.nss == 2 * 5 + 4 and spec.nbc == 1
    # the table: each cell's boundary connections and sinks in order
    t = spec.table("cpu").numpy()
    n = spec.n
    assert list(t[:n + 1]) == [0] * n + [1]          # the seepage face: top
    assert list(t[n + 1:n + 4]) == [0, 1 | 2, n - 1]  # its kind and level
    ss_ptr = t[n + 4:2 * n + 5]
    assert ss_ptr[0] == 0 and ss_ptr[-1] == spec.nss
    # top cell: infiltration, ET, dew, drainage, snow, sublimation
    assert ss_ptr[-1] - ss_ptr[-2] == 6


def test_other_structures_take_the_eager_plan():
    from mpp_tpu_torch.problems import vsfm_celia1990, vsfm_spac_campbell
    from mpp_tpu_torch.problems import vsfm_vchannel as vch
    vchannel = vch.run_vsfm_vchannel_problem(
        nz=2, nstep=0, use_compiled=True, linear_solver="direct",
        device="cpu").soe.step_dt.__self__
    celia = vsfm_celia1990.run_vsfm_celia1990_problem(
        nz=10, nstep=0, use_compiled=True, device="cpu").soe.step_dt.__self__
    coupled = compile_vsfm(vsfm_spac_campbell.run_vsfm_spac_campbell_problem(
        nstep=0, multi_goveqns=True, device="cpu"), linear_solver="direct")
    assert celia.is_tridiag
    assert len(coupled.goveqns) > 1
    for comp in (vchannel, celia, coupled):
        assert comp.assembly == "eager" and comp._column is None


def test_cpu_alm_step_equals_the_eager_plan():
    """On the CPU the column plan runs the plain form: an ALM step equals
    the eager plan's bit for bit, and launches nothing."""
    outs = []
    hk.reset_launches()
    for plan in ("column", "eager"):
        prob = _problem(5, 9, F64, "cpu")[0]
        if plan == "eager":
            prob.comp._column = None
        outs.append(alm.alm_vsfm_solve(
            prob, 1800.0, qflx_infl=np.full(5, 2e-4),
            qflx_tran_veg=np.full(5, 1e-4),
            rootr=np.full((5, 9), 1.0 / 9.0)))
    assert hk.LAUNCHES["vsfm_column_assemble"] == 0
    a, b = outs
    assert a["newton_iters"] == b["newton_iters"] > 0
    for k in ("soilp", "h2osoi_liq", "qflx_seepage", "zwt"):
        assert torch.equal(a[k], b[k]), k


# ---- on the card ------------------------------------------------------------

def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")


# the kernel against the eager _eval on the card, of max |output|: the
# same formulas and the same pow / exp, but the kernel's multiply-adds may
# fuse and the eager index_add sums a cell's terms by atomics in any
# order; each rounding is amplified at most by P's cancellation in the
# Darcy potential (P ~ 1e5 Pa against differences of ~1e2-1e4 Pa), so f64
# agrees to ~1e-13 and f32 to ~1e-5
CARD_REL = {F64: 1e-11, F32: 2e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("ncol", [4096, 131072])
@pytest.mark.parametrize("dtype", [F64, F32])
def test_kernel_matches_eager_on_gpu(ncol, dtype):
    _needs_gpu()
    for seepage, downreg in ((True, False), (False, True)):
        prob, g, spec, x = _problem(ncol, 15, dtype, "cuda", seepage,
                                    downreg, seed=ncol)
        for mode in MODES:
            n0 = hk.LAUNCHES["vsfm_column_assemble"]
            got = _column(g, spec, mode, x)
            assert hk.LAUNCHES["vsfm_column_assemble"] == n0 + 1
            ref = _eager(prob, g, mode, x)
            torch.cuda.synchronize()
            for k, gap in _rel_gaps(got, ref, mode).items():
                assert gap <= CARD_REL[dtype], (mode, k, gap)
        idx = torch.arange(0, ncol, 7, device="cuda")
        xg = {k: _take(v, idx) for k, v in x.items()}
        got = _column(g, spec, "both", xg)
        for k, gap in _rel_gaps(got, _eager(prob, g, "both", xg),
                                "both").items():
            assert gap <= CARD_REL[dtype], ("gathered", k, gap)


@pytest.mark.cuda
def test_kernel_limits_on_gpu():
    """The plan's limits are the kernel's: the deepest column, the shared
    memory a launch takes at the ALM template's counts and at the deepest
    column's."""
    _needs_gpu()
    lib = hk._build.library()
    assert lib.mpp_vsfm_column_max_levels() == rc.MAX_LEVELS
    assert lib.mpp_vsfm_column_max_smem() == rc.MAX_SMEM_BYTES
    for n, nbc, nss in ((15, 1, 34), (30, 0, 64), (256, 2, 516), (1, 1, 6)):
        spec = rc.ColumnSpec(n, [n - 1] * nbc, [int(Cond.SEEPAGE_BC)] * nbc,
                             [0] * nss, [int(Cond.MASS_RATE)] * nss, 2,
                             False)
        for elem in (4, 8):
            assert lib.mpp_vsfm_column_smem(n, nbc, nss, elem) == \
                spec.smem_bytes(elem)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F64, F32])
def test_alm_step_card_matches_cpu(dtype):
    """One alm_vsfm_solve step through the column kernel on the card
    against the same step on the CPU (the plain form): equal iterations
    and attempts, P within rounding."""
    _needs_gpu()
    outs = {}
    for dev in ("cuda", "cpu"):
        prob = _problem(64, 15, dtype, dev, seed=7)[0]
        n0 = hk.LAUNCHES["vsfm_column_assemble"]
        outs[dev] = alm.alm_vsfm_solve(
            prob, 1800.0, qflx_infl=np.full(64, 2e-4),
            qflx_tran_veg=np.full(64, 1e-4),
            rootr=np.full((64, 15), 1.0 / 15.0))
        launched = hk.LAUNCHES["vsfm_column_assemble"] - n0
        assert (launched > 0) == (dev == "cuda")
    g, c = outs["cuda"], outs["cpu"]
    assert g["attempts"] == c["attempts"]
    if dtype == F64:
        assert g["newton_iters"] == c["newton_iters"]
    rel = float(((g["soilp"].cpu().double() - c["soilp"].double()).abs()
                 / c["soilp"].double().abs()).max())
    assert rel <= (1e-9 if dtype == F64 else 1e-5), rel

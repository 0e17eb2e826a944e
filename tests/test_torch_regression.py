"""The port's regression writers (``io/regression`` and the problems'
``output_regression*``) against the JAX package's, on the CPU in f64.

Each writer runs on the same problem built by both packages' drivers from
the same arguments (the VSFM problems stepped by both compiled "petsc"
steppers, as tests/test_torch_vsfm_plans.py does; the others by each
driver's default path).  The two files are parsed with the reader: the
sections, their categories and the sampled cells must be identical, and
every number (min / max / mean and each sampled cell, printed with 13
digits) must agree within RTOL of the section's largest magnitude
(measured: at most 1.2e-12, most sections equal to the printed digit).
The serial longwave problem stops GMRES(30) + ILU(0) at PETSc's rtol 1e-5
in both packages, in another summation order: the iterates agree within
1e-8 of the flux scale (tests/test_torch_canopy_pieces.py), and the
absorbed flux, a difference of fluxes, within 7.6e-9 of its own largest
value (measured), so that file is held to KRYLOV_RTOL.
"""
import numpy as np
import pytest
import torch

from mpp_tpu.io import regression as jreg
from mpp_tpu.problems import canopy_radiation as jcr
from mpp_tpu.problems import mlc as jmlc
from mpp_tpu.problems import photosynthesis as jps
from mpp_tpu.problems import th as jth
from mpp_tpu.problems import thermal_mms as jtm
from mpp_tpu.problems import vsfm_spac as jspac
from mpp_tpu.problems import vsfm_spac_campbell as jcamp
from mpp_tpu.problems import vsfm_vchannel as jvch
from mpp_tpu_torch.io import regression as treg
from mpp_tpu_torch.problems import canopy_radiation as tcr
from mpp_tpu_torch.problems import mlc as tmlc
from mpp_tpu_torch.problems import photosynthesis as tps
from mpp_tpu_torch.problems import th as tth
from mpp_tpu_torch.problems import thermal_mms as ttm
from mpp_tpu_torch.problems import vsfm_spac as tspac
from mpp_tpu_torch.problems import vsfm_spac_campbell as tcamp
from mpp_tpu_torch.problems import vsfm_vchannel as tvch
from test_torch_vsfm_campbell import PROBLEMS as CAMPBELL
from test_torch_vsfm_plans import PROBLEMS as VSFM, run_pair

RTOL = 1e-10
KRYLOV_RTOL = 1e-7
NUM_CELLS = 6


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _vsfm(problem, jw, tw):
    def run():
        mj, _, mt, _, _, _ = run_pair(problem, "petsc")
        return (lambda base: jw(mj, base, NUM_CELLS),
                lambda base: tw(mt, base, NUM_CELLS))
    return run


def _mpp_pair(jrun, trun, jw, tw, **kw):
    def run():
        mj = jrun(**kw)
        mt = trun(device="cpu", **kw)
        return (lambda base: jw(mj, base, NUM_CELLS),
                lambda base: tw(mt, base, NUM_CELLS))
    return run


def _soln_pair(jrun, trun, jw, tw, pick, **kw):
    def run():
        sj = pick(jrun(**kw))
        st = pick(trun(device="cpu", **kw))
        return (lambda base: jw(base, NUM_CELLS, sj),
                lambda base: tw(base, NUM_CELLS, st))
    return run


def _ps_run(run):
    return lambda device=None, **kw: (
        run("c3", "medlyn", **kw) if device is None
        else run("c3", "medlyn", device=device, **kw))


# writer id: a function that runs both problems and returns the JAX and
# the port writer, each taking a base file name
WRITERS = {
    "thermal_mms": _soln_pair(
        lambda: jtm.run_thermal_mms_problem(1, use_compiled=True),
        lambda device: ttm.run_thermal_mms_problem(1, use_compiled=True,
                                                   device=device),
        jtm.output_regression, ttm.output_regression, lambda r: r[1]),
    "vsfm_spac": _vsfm(VSFM["spac"], jspac.output_regression,
                       tspac.output_regression),
    "vsfm_spac_campbell": _vsfm(CAMPBELL["spac_campbell"],
                                jcamp.output_regression,
                                tcamp.output_regression),
    "vsfm_vchannel": _vsfm(VSFM["vchannel_nz2"], jvch.output_regression,
                           tvch.output_regression),
    "heat_transport_1d": _soln_pair(
        lambda: jth.run_heat_transport_1d(nz=20),
        lambda device: tth.run_heat_transport_1d(nz=20, device=device),
        jth.output_regression_heat_transport_1d,
        tth.output_regression_heat_transport_1d, lambda r: r[1]),
    "th": _soln_pair(
        lambda: jth.run_mass_and_heat(nx=12),
        lambda device: tth.run_mass_and_heat(nx=12, device=device),
        jth.output_regression_th, tth.output_regression_th,
        lambda r: np.asarray(r[0].soe.soln)),
    "shortwave": _mpp_pair(jcr.run_shortwave_problem,
                           tcr.run_shortwave_problem,
                           jcr.output_regression_shortwave,
                           tcr.output_regression_shortwave),
    "longwave": _mpp_pair(jcr.run_longwave_problem,
                          tcr.run_longwave_problem,
                          jcr.output_regression_longwave,
                          tcr.output_regression_longwave),
    "leafbndlyr": _mpp_pair(jcr.run_leafbndlyr_problem,
                            tcr.run_leafbndlyr_problem,
                            jcr.output_regression_leafbndlyr,
                            tcr.output_regression_leafbndlyr),
    "photosynthesis": _mpp_pair(_ps_run(jps.run_photosynthesis_problem),
                                _ps_run(tps.run_photosynthesis_problem),
                                jps.output_regression, tps.output_regression),
    "mlc": _mpp_pair(lambda: jmlc.run_mlc_problem(2, 1),
                     lambda device: tmlc.run_mlc_problem(2, 1,
                                                         device=device),
                     jmlc.output_regression, tmlc.output_regression),
    "mlc_two_tree": _mpp_pair(lambda: jmlc.run_mlc_problem(2, 2),
                              lambda device: tmlc.run_mlc_problem(
                                  2, 2, device=device),
                              jmlc.output_regression,
                              tmlc.output_regression),
}


def assert_files_match(fj, ft, rtol=RTOL):
    """Two regression files: identical sections, categories and keys;
    every number within ``rtol`` of its section's largest magnitude."""
    sj = treg.parse_regression(open(fj).read())
    st = treg.parse_regression(open(ft).read())
    assert list(st) == list(sj)
    for name, secj in sj.items():
        sect = st[name]
        assert sect["category"] == secj["category"]
        assert list(sect["values"]) == list(secj["values"])
        vj = np.array(list(secj["values"].values()))
        vt = np.array(list(sect["values"].values()))
        scale = max(float(np.abs(vj).max()), 1e-300)
        err = float(np.abs(vt - vj).max()) / scale
        assert err <= rtol, (name, err)
    return sj


@pytest.mark.parametrize("name", list(WRITERS))
def test_writer_matches_jax(name, tmp_path):
    jw, tw = WRITERS[name]()
    fj = jw(str(tmp_path / "jax"))
    ft = tw(str(tmp_path / "port"))
    assert fj.endswith("jax.regression") and ft.endswith("port.regression")
    sections = assert_files_match(
        fj, ft, KRYLOV_RTOL if name == "longwave" else RTOL)
    assert sections and all(
        any(k.startswith("cell") for k in s["values"])
        for s in sections.values())


def test_format_e21_13_matches_jax():
    rng = np.random.default_rng(11)
    vals = np.concatenate([
        rng.normal(size=200) * 10.0 ** rng.integers(-60, 60, size=200),
        [0.0, -0.0, 1e-51, -1e-51, 1.0, -1.0, 0.1, 9.99999999999995e-5,
         1.0e100, -123456.789]])
    for v in vals:
        assert treg.format_e21_13(float(v)) == jreg.format_e21_13(float(v))


def test_writer_takes_tensors_and_reads_back(tmp_path):
    """The same data as numpy, as a tensor and through the JAX writer give
    the same file; the reader and the baseline comparison agree with the
    JAX package's."""
    data = np.random.default_rng(3).normal(size=47) * 1e3
    files = []
    for mod, arr, tag in ((jreg, data, "j"), (treg, data, "n"),
                          (treg, torch.as_tensor(data), "t")):
        w = mod.RegressionWriter(str(tmp_path / tag), 5)
        w.write_data("x", "general", arr)
        w.write_data("y", "pressure", arr[:7])
        w.close()
        files.append(open(w.filename).read())
    assert files[0] == files[1] == files[2]
    assert treg.parse_regression(files[0]) == jreg.parse_regression(files[0])
    shifted = files[0].replace("E+03", "E+02", 1)
    tols = {"general": (1e-12, "relative"), "pressure": (1e-12, "absolute")}
    assert treg.compare_to_baseline(shifted, files[0], tols) \
        == jreg.compare_to_baseline(shifted, files[0], tols)
    assert treg.compare_to_baseline(files[1], files[0], tols) == []

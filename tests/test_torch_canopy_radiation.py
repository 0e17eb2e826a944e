"""The port's canopy reference problems and host pieces against the JAX
package, f64 on the CPU.

* ``run_shortwave_problem`` / ``run_longwave_problem`` with
  ``use_compiled=True`` (``compile_radiation``: one assemble, the batched
  ILU(0) factor and GMRES(30) a step): equal GMRES cycles, the fluxes
  within 1e-8 of the largest flux (the same GMRES(30) + ILU(0) iterate,
  stopped at PETSc's rtol 1e-5, in another summation order; measured
  2e-12 for Iup / Idn, 1e-9 for Iabs); ``run_leafbndlyr_problem`` within 1e-12.
* The ml_model pieces the pipeline reads (vegetation structure, beam
  extinction, transmittances, BC records, meshes) and the PETSc binary Vec
  round trip, exactly: they are host copies.
* The writers and drivers that raised naming a later slice until it
  landed (Slices E2 and F) run.
"""
import dataclasses

import numpy as np
import pytest
import torch

from mpp_tpu.io import petsc_vec as jvec
from mpp_tpu.problems import canopy_radiation as jcr
from mpp_tpu.problems import ml_model as jml
from mpp_tpu.problems import mlc as jmlc
from mpp_tpu_torch.batched.ksp_compiled import CompiledRadiation
from mpp_tpu_torch.io import petsc_vec as tvec
from mpp_tpu_torch.problems import canopy_radiation as tcr
from mpp_tpu_torch.problems import ml_model as tml
from mpp_tpu_torch.problems import mlc as tmlc
from mpp_tpu_torch.problems import photosynthesis as tps

KRYLOV = 1e-8


def _close(got, want, rel, scale=None):
    want = np.asarray(want)
    if scale is None:
        scale = float(np.abs(want).max())
    err = float(np.abs(got.cpu().numpy() - want).max()) / max(scale, 1e-300)
    assert err <= rel, (err, rel)


def _flux_scale(ge):
    """The largest flux of a radiation GE's solution: the scale of its
    GMRES iterate, and of Iabs, a difference of fluxes."""
    return max(float(np.abs(np.asarray(ge.Iup)).max()),
               float(np.abs(np.asarray(ge.Idn)).max()))


@pytest.mark.parametrize("name,fields,ncair", [
    ("run_shortwave_problem", ("Iup", "Idn", "Iabs_leaf", "Iabs_soil"), 1),
    ("run_longwave_problem", ("Iup", "Idn", "Iabs"), 1),
    ("run_longwave_problem", ("Iup", "Idn", "Iabs"), 3)],
    ids=["shortwave", "longwave", "longwave-3col"])
def test_compiled_radiation_matches_jax(name, fields, ncair):
    mj = getattr(jcr, name)(ncair=ncair, use_compiled=True)
    mt = getattr(tcr, name)(ncair=ncair, use_compiled=True, device="cpu")
    comp = mt.step_dt.__self__
    assert isinstance(comp, CompiledRadiation) and comp.host_syncs > 0
    assert mt.cumulative_linear_iterations \
        == int(mj.cumulative_linear_iterations) > 0
    scale = _flux_scale(mj.goveqns[0])
    for f in fields:
        _close(getattr(mt.goveqns[0], f), getattr(mj.goveqns[0], f), KRYLOV,
               scale)


def test_leafbndlyr_problem_matches_jax():
    mj = jcr.run_leafbndlyr_problem(ncair=2)
    mt = tcr.run_leafbndlyr_problem(ncair=2, device="cpu")
    for f in ("gbh", "gbv", "gbc"):
        _close(getattr(mt.goveqns[0], f), getattr(mj.goveqns[0], f), 1e-12)


def test_ml_model_host_pieces_match_jax():
    for ntree in (1, 2):
        vj = jml.compute_vertical_veg_structure(ntree)
        vt = tml.compute_vertical_veg_structure(ntree)
        for f in dataclasses.fields(vj):
            np.testing.assert_array_equal(getattr(vt, f.name),
                                          getattr(vj, f.name))
        np.testing.assert_array_equal(tml.compute_fssh(vt, 0.7),
                                      jml.compute_fssh(vj, 0.7))
        for make in ("create_canopy_and_soil_mesh",
                     "create_canopy_mesh_for_leaf"):
            a, b = getattr(jml, make)(vj, 3), getattr(tml, make)(vt, 3)
            np.testing.assert_array_equal(b.zc, a.zc)
            np.testing.assert_array_equal(b.intrn_conn_sets[0].id_dn,
                                          a.intrn_conn_sets[0].id_dn)
    for sza in (0.2, 0.9, 1.45):
        assert tml.compute_kb(0.25, sza) == jml.compute_kb(0.25, sza)
        assert tml.compute_transmittance(0.25, sza, 0.3, 1.0) \
            == jml.compute_transmittance(0.25, sza, 0.3, 1.0)
    np.testing.assert_array_equal(tmlc.get_dpai_fssh()[0],
                                  jmlc.get_dpai_fssh()[0])
    data = np.random.default_rng(7).uniform(0, 400, 31 * 4)
    pj = pt = None
    for istep in range(1, 5):
        pj = jml.bc_from_vec_row(data, istep, pj)
        pt = tml.bc_from_vec_row(data, istep, pt)
        for f in dataclasses.fields(pj):
            np.testing.assert_array_equal(getattr(pt, f.name),
                                          getattr(pj, f.name))
        sj = jml.synthetic_diurnal_bc(istep + 8)
        st = tml.synthetic_diurnal_bc(istep + 8)
        assert dataclasses.astuple(st)[:-2] == dataclasses.astuple(sj)[:-2]


def test_petsc_vec_round_trip_matches_jax(tmp_path):
    v = np.random.default_rng(8).normal(size=377)
    tvec.write_vec(str(tmp_path / "t.bin"), v)
    jvec.write_vec(str(tmp_path / "j.bin"), v)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin") \
        .read_bytes()
    np.testing.assert_array_equal(tvec.read_vec(str(tmp_path / "j.bin")), v)


@pytest.mark.parametrize("call", [
    lambda d: tcr.output_regression_shortwave(
        tcr.run_shortwave_problem(device="cpu"), d, 6),
    lambda d: tcr.output_regression_longwave(
        tcr.run_longwave_problem(device="cpu"), d, 6),
    lambda d: tcr.output_regression_leafbndlyr(
        tcr.run_leafbndlyr_problem(device="cpu"), d, 6),
    lambda d: tps.output_regression(
        tps.run_photosynthesis_problem("c3", "medlyn", device="cpu"), d, 6),
    lambda d: tmlc.run_mlc_problem(device="cpu"),
    lambda d: tmlc.output_regression(tmlc.run_mlc_problem(device="cpu"),
                                     d, 6),
    lambda d: tml.run_ml_model_problem(13, 13, nsubstep=1, device="cpu"),
    lambda d: tml.MLModel(device="cpu")],
    ids=["sw_regression", "lw_regression", "lbl_regression",
         "psy_regression", "run_mlc", "mlc_regression", "run_ml_model",
         "ml_model"])
def test_former_later_slice_entry_points_run(call, tmp_path):
    """The entry points that raised NotImplementedError naming a later
    slice (the writers Slice F, the MLC and ml_model drivers Slice E2)
    until that slice landed: each now runs on the CPU, and a writer writes
    its file (tests/test_torch_regression.py holds the files to JAX's)."""
    out = call(str(tmp_path / "out"))
    if isinstance(out, str):
        assert out.endswith(".regression") and open(out).read().startswith(
            "[")
    else:
        assert out is not None


def test_radiation_problems_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for run in (tcr.run_shortwave_problem, tcr.run_longwave_problem,
                tcr.run_leafbndlyr_problem):
        with pytest.raises(RuntimeError, match="cuda"):
            run()

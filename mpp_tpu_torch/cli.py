"""Namelist-driven problem dispatcher, the ``standalone_mpp`` analog
(counterpart of ``mpp_tpu/cli.py``).

The reference's regression harness runs a single binary with
``standalone_mpp -namelist <x>.namelist``; the namelist's ``&mpp_driver
problem_type`` selects the problem, ``&regression_test`` controls the
``.regression`` output, and ``&problem_options`` parameterizes the
problem (``src/driver/standalone/standalone_mpp.F90:26-222``).  This CLI
ingests the same ``.namelist`` files, runs every problem with the JAX
package's defaults and writes the same ``.regression`` files through
``io/regression.py``.

Usage::

    python -m mpp_tpu_torch.cli -namelist vsfm_celia1990.namelist
    python -m mpp_tpu_torch.cli -namelist vsfm_celia1990.namelist -device cpu

Without ``-device cpu`` the problems run on the card, and without a card
the CLI raises.  ``--debug-nans`` (or ``MPP_DEBUG_NANS=1``) arms the NaN
trap of ``config.py``.  Besides the JAX CLI's problem types it takes
``vsfm_mms`` (option ``nx``), the cheapest VSFM problem with a
regression writer.
"""
from __future__ import annotations

import os
import sys

from mpp_tpu_torch.config import (enable_nan_debug,
                                  maybe_enable_nan_debug_from_env,
                                  read_namelist)
from mpp_tpu_torch.device import device_of


def _dispatch(problem_type: str, opts: dict, device="cuda"):
    """Runs the problem on ``device``; returns a closure ``(filename_base,
    num_cells) -> filename or None`` that writes the regression file."""
    dev = {"device": device}
    if problem_type == "mass_and_heat":
        from mpp_tpu_torch.problems import th
        _mpp, soln = th.run_mass_and_heat(**dev)
        return lambda base, nc: th.output_regression_th(base, nc, soln)

    if problem_type == "heat_transport_1D":
        from mpp_tpu_torch.problems import th
        _mpp, temp = th.run_heat_transport_1d(**dev)
        return lambda base, nc: th.output_regression_heat_transport_1d(
            base, nc, temp)

    if problem_type == "th_mms":
        from mpp_tpu_torch.problems import th
        _mpp, soln = th.run_th_mms(**dev)
        return lambda base, nc: th.output_regression_th(base, nc, soln)

    if problem_type == "thermal_mms":
        from mpp_tpu_torch.problems import thermal_mms as tm
        kw = {}
        if "problem_type" in opts:
            kw["problem_type"] = int(opts["problem_type"])
        for key in ("nx", "ny", "nz"):
            if key in opts:
                kw[key] = int(opts[key])
        _mpp, soln = tm.run_thermal_mms_problem(**kw, **dev)
        return lambda base, nc: tm.output_regression(base, nc, soln)

    if problem_type == "vsfm_celia1990":
        from mpp_tpu_torch.problems import vsfm_celia1990 as p
        mpp = p.run_vsfm_celia1990_problem(**dev)
        return lambda base, nc: p.output_regression(mpp, base, nc)

    if problem_type == "vsfm_vchannel":
        from mpp_tpu_torch.problems import vsfm_vchannel as p
        mpp = p.run_vsfm_vchannel_problem(**dev)
        return lambda base, nc: p.output_regression(mpp, base, nc)

    if problem_type == "vsfm_spac":
        from mpp_tpu_torch.problems import vsfm_spac as p
        mpp = p.run_vsfm_spac_problem(**dev)
        return lambda base, nc: p.output_regression(mpp, base, nc)

    if problem_type == "vsfm_spac_campbell":
        from mpp_tpu_torch.problems import vsfm_spac_campbell as p
        multi = bool(opts.get("multi_goveqns_formulation", False))
        mpp = p.run_vsfm_spac_campbell_problem(multi_goveqns=multi, **dev)
        return lambda base, nc: p.output_regression(mpp, base, nc)

    if problem_type == "mlc":
        from mpp_tpu_torch.problems import mlc as p
        mpp = p.run_mlc_problem(ncair=int(opts.get("ncair", 1)),
                                ntree=int(opts.get("ntree", 1)), **dev)
        return lambda base, nc: p.output_regression(mpp, base, nc)

    if problem_type == "leafbndlyr":
        from mpp_tpu_torch.problems import canopy_radiation as p
        mpp = p.run_leafbndlyr_problem(**dev)
        return lambda base, nc: p.output_regression_leafbndlyr(mpp, base, nc)

    if problem_type == "longwave":
        from mpp_tpu_torch.problems import canopy_radiation as p
        mpp = p.run_longwave_problem(**dev)
        return lambda base, nc: p.output_regression_longwave(mpp, base, nc)

    if problem_type == "shortwave":
        from mpp_tpu_torch.problems import canopy_radiation as p
        mpp = p.run_shortwave_problem(**dev)
        return lambda base, nc: p.output_regression_shortwave(mpp, base, nc)

    if problem_type == "photosynthesis":
        from mpp_tpu_torch.problems import photosynthesis as p
        pathway = str(opts.get("photosynthesis_pathway", "c3"))
        scm = str(opts.get("stomatal_conductance_model", "medlyn"))
        mpp = p.run_photosynthesis_problem(pathway, scm, **dev)
        return lambda base, nc: p.output_regression(mpp, base, nc)

    if problem_type == "ml_model":
        from mpp_tpu_torch.problems import ml_model as p
        p.run_ml_model_problem(
            end_step=int(opts.get("end_step", 1)),
            nsubstep=int(opts.get("nsubstep", 12)),
            stomatal_conductance_model=str(
                opts.get("stomatal_conductance_model", "medlyn")), **dev)
        return lambda base, nc: None

    # Drivers the reference builds as standalone executables rather than
    # namelist-dispatched problems; exposed here for convenience.
    if problem_type == "vsfm_sy1991":
        from mpp_tpu_torch.problems import vsfm_sy1991 as p
        mpp = p.run_vsfm_sy1991_problem(
            problem_number=int(opts.get("problem_number", p.DRYING_PROBLEM)),
            **dev)
        return lambda base, nc: p.output_regression(mpp, base, nc)

    if problem_type == "vsfm_wt_dynamics":
        from mpp_tpu_torch.problems import vsfm_wt_dynamics as p
        mpp = p.run_vsfm_wt_dynamics_problem(**dev)
        return lambda base, nc: p.output_regression(mpp, base, nc)

    if problem_type == "vsfm_vchannel_operator_split":
        from mpp_tpu_torch.problems import vsfm_vchannel_operator_split as p
        _vert, lat = p.run_vsfm_vchannel_operator_split_problem(**dev)
        return lambda base, nc: p.output_regression(lat, base, nc)

    if problem_type == "vsfm_manoli2014":
        from mpp_tpu_torch.problems import vsfm_manoli2014 as p
        p.run_vsfm_manoli2014_problem(
            dtime=float(opts.get("dt", 8640.0)),
            nstep=int(opts.get("nstep", 3)), **dev)
        return lambda base, nc: None

    if problem_type == "vsfm_spac_mms":
        from mpp_tpu_torch.problems import vsfm_spac_mms as p
        p.run_vsfm_spac_mms_problem(
            grid_factor=int(opts.get("grid_factor", 2)), **dev)
        return lambda base, nc: None

    if problem_type == "vsfm_mms":
        from mpp_tpu_torch.problems import vsfm_mms as p
        mpp, _truth = p.run_vsfm_mms_problem(nx=int(opts.get("nx", 20)),
                                             **dev)
        return lambda base, nc: p.output_regression(mpp, base, nc)

    if problem_type == "th_manoli2014":
        from mpp_tpu_torch.problems import th_manoli2014 as p
        p.run_th_manoli2014_problem(
            dtime=float(opts.get("dt", 8640.0)),
            nstep=int(opts.get("nstep", 3)), **dev)
        return lambda base, nc: None

    if problem_type == "heat_transport_1D_with_advection":
        from mpp_tpu_torch.problems import th as p
        _mpp, temp = p.run_heat_transport_1d_with_advection(
            pressure_ic_file=opts.get("pressure_ic_file"), **dev)
        return lambda base, nc: p.output_regression_heat_transport_1d(
            base, nc, temp)

    raise SystemExit(f"problem_type = '{problem_type}' is unsupported.")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    namelist = None
    device = "cuda"
    for i, a in enumerate(argv):
        if a in ("-namelist", "--namelist") and i + 1 < len(argv):
            namelist = argv[i + 1]
        if a in ("-device", "--device") and i + 1 < len(argv):
            device = argv[i + 1]
    if not namelist:
        print("ERROR: -namelist <filename> was not defined. Bailing out.")
        raise SystemExit(-1)
    device = device_of(device)

    if "--debug-nans" in argv:
        enable_nan_debug()
    else:
        maybe_enable_nan_debug_from_env()

    groups = read_namelist(namelist)
    driver = groups.get("mpp_driver", {})
    regr = groups.get("regression_test", {})
    opts = groups.get("problem_options", {})
    problem_type = str(driver.get("problem_type", ""))

    filename_base = os.path.splitext(namelist)[0]
    writer = _dispatch(problem_type, opts, device)
    if regr.get("write_regression_output", False):
        fname = writer(filename_base, int(regr.get("num_cells", 0)))
        if fname:
            print(f"Wrote {fname}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

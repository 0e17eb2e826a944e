"""Srivastava & Yeh (1991) layered-soil infiltration/drainage benchmark.

Counterpart of ``mpp_tpu/problems/vsfm_sy1991.py``, which reimplements
``src/driver/standalone/vsfm/vsfm_sy1991_problem.F90``:
200-cell, 2 m column with a two-layer permeability contrast (low-K lower
100 cells 2.5281e-13 m^2, high-K upper 100 cells 2.5281e-12 m^2,
:392-396), van Genuchten lambda=0.5455, alpha=4e-4, residual sat 0.15
(:390-400), TGDPB01 density; a constant recharge mass-rate source at the
top cells (wetting 2.5e-6, drying 2.7778e-7 m/s times rho=997.16,
:489-497) and a Dirichlet bottom pressure pinned at the initial bottom
value (:494-499); 24 hourly implicit steps (:140-142).

The reference seeds the run from 200-entry steady-state pressure tables
(``press_ic_wetting/drying``, :17-100).  Those tables are themselves the
steady profiles of this same column under the *opposite* recharge, so we
generate the IC by spinning the model to steady state rather than
shipping the table: the WETTING problem starts from the drying-recharge
steady state and vice versa.

The steps run through the serial SNES of ``VSFMSoE.step_dt`` on
``device`` (the card unless ``device="cpu"``) or, with
``use_compiled``, the compiled batched stepper at ncol=1.
"""
from __future__ import annotations

import numpy as np

from mpp_tpu_torch import constants as C
from mpp_tpu_torch.constants import (Cond, ConnKind, GEType, MPPType, Region,
                                     Var, AuxVarKind, GRAVITY_CONSTANT)
from mpp_tpu_torch.dtypes.mesh import structured_mesh
from mpp_tpu_torch.batched.vsfm_compiled import vsfm_stepper
from mpp_tpu_torch.models.richards import VSFMMPP
from mpp_tpu_torch.ops import eos
from mpp_tpu_torch.io.regression import RegressionWriter

WETTING_PROBLEM = 1
DRYING_PROBLEM = 2

_RECHARGE_WETTING = 2.5e-6      # [m/s] (vsfm_sy1991_problem.F90:485)
_RECHARGE_DRYING = 2.7778e-7    # [m/s] (:486)
_RHO = 997.16                   # [kg/m^3] staging density (:493-497)


def _build_mpp(nz):
    mpp = VSFMMPP()
    mpp.set_name("Variably-Saturated-Flow-Model")
    mpp.set_id(MPPType.VSFM_SNES_CLM)
    mpp.set_num_meshes(1)
    mesh = structured_mesh("Soil mesh", 1.0, 1.0, 2.0, 1, 1, nz,
                           ConnKind.IN_Z_DIR)
    mpp.add_mesh(mesh)
    ieqn = mpp.add_goveqn(GEType.RE, "Richards Equation ODE")
    mpp.add_condition_in_goveqn(ieqn, Cond.SS,
                                "Constant flux condition at top",
                                "kg/s/m^2", Cond.MASS_RATE,
                                region=Region.SOIL_TOP_CELLS)
    mpp.add_condition_in_goveqn(ieqn, Cond.BC,
                                "Constant head condition at bottom", "Pa",
                                Cond.DIRICHLET,
                                region=Region.SOIL_BOTTOM_CELLS)
    mpp.allocate_auxvars()
    mpp.setup_problem()

    # Soil properties (vsfm_sy1991_problem.F90:385-400)
    porosity, lam, alpha = 0.4, 0.5455, 4.0e-4
    perm_high, perm_low = 2.5281e-12, 2.5281e-13
    vish2o = 0.001002
    conv = 1.0 / vish2o * (C.DENH2O * C.GRAV_CLM) / 0.001
    hksat = np.empty((1, nz))
    hksat[:, : nz // 2] = perm_low * conv
    hksat[:, nz // 2:] = perm_high * conv
    mpp.set_soils(filter_vsfmc=np.ones(1, np.int64),
                  watsat=np.full((1, nz), porosity),
                  hksat=hksat,
                  bsw=np.full((1, nz), 1.0 / lam),
                  sucsat=np.full((1, nz), 1.0 / (alpha * GRAVITY_CONSTANT)),
                  residual_sat=np.full((1, nz), 0.15),
                  satfunc_type="van_genuchten",
                  density_type=eos.DENSITY_TGDPB01)
    return mpp


def _spinup_steady_ic(nz, recharge, bot_pressure, device="cuda"):
    """Steady pressure profile under ``recharge``: the reference's
    press_ic tables regenerated by time-stepping to steady state (the
    serial SNES on ``device``)."""
    mpp = _build_mpp(nz)
    vsfm_stepper(mpp, False, device)
    mpp.restart(np.full(nz, bot_pressure))
    dt = 3600.0
    prev = None
    for istep in range(1, 300):
        mpp.set_data(AuxVarKind.SS, Var.BC_SS_CONDITION, 1,
                     np.full(1, recharge * _RHO))
        mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1,
                     np.full(1, bot_pressure))
        converged, _ = mpp.soe.step_dt(dt, istep)
        assert converged
        P = np.asarray(mpp.get_data(AuxVarKind.INTERNAL, Var.PRESSURE))
        if prev is not None and np.max(np.abs(P - prev)) < 1e-4:
            break
        prev = P
        dt = min(dt * 1.5, 86400.0 * 4)
    return P


def run_vsfm_sy1991_problem(nz=200, dtime=3600.0, nstep=24,
                            problem_number=DRYING_PROBLEM,
                            use_compiled=False, device="cuda"):
    if problem_number == DRYING_PROBLEM:
        recharge, ic_recharge = _RECHARGE_DRYING, _RECHARGE_WETTING
        bot = 101320.2       # press_ic_drying(1) (:163)
    elif problem_number == WETTING_PROBLEM:
        recharge, ic_recharge = _RECHARGE_WETTING, _RECHARGE_DRYING
        bot = 101281.1       # press_ic_wetting(1) (:18)
    else:
        raise ValueError("Valid problem numbers are: 1 or 2")

    press_ic = _spinup_steady_ic(nz, ic_recharge, bot, device)

    mpp = _build_mpp(nz)
    mpp.restart(press_ic)
    vsfm_stepper(mpp, use_compiled, device)
    for istep in range(1, nstep + 1):
        mpp.set_data(AuxVarKind.SS, Var.BC_SS_CONDITION, 1,
                     np.full(1, recharge * _RHO))
        mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1, np.full(1, bot))
        converged, reason = mpp.soe.step_dt(dtime, istep)
        assert converged, f"step {istep} diverged (reason {reason})"
    mpp.press_ic = press_ic
    return mpp


def output_regression(mpp, filename_base, num_cells):
    w = RegressionWriter(filename_base, num_cells)
    w.write_data("liquid_pressure", "pressure",
                 mpp.get_data(AuxVarKind.INTERNAL, Var.PRESSURE))
    w.write_data("liquid_saturation", "general",
                 mpp.get_data(AuxVarKind.INTERNAL, Var.LIQ_SAT))
    w.close()
    return w.filename

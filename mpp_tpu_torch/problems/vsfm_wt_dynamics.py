"""Water-table dynamics under constant rain (VSFM, SNES path).

Counterpart of ``mpp_tpu/problems/vsfm_wt_dynamics.py``, which reimplements
``src/driver/standalone/vsfm/vsfm_wt_dynamics_problem.F90``:
100-cell, 1 m column with celia-like van Genuchten soils (porosity 0.368,
lambda 0.5, alpha 3.4257e-4, perm 8.3913e-12; :366-369), hydrostatic
initial condition with the water table at 0.5 m depth
(``P = 101325 + (0.5 - z) * 997.16 * 9.80868``, :435-442), a constant
rain mass-rate source 2.5e-5*1e3 kg/s into the top cells (:468) and a
Dirichlet bottom pressure holding the initial hydrostatic value (:469);
24 hourly implicit steps (:58-60).  The water table rises as rain
recharges the column.

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


def run_vsfm_wt_dynamics_problem(nz=100, dtime=3600.0, nstep=24,
                                 use_compiled=False, device="cuda"):
    z_column = 1.0
    mpp = VSFMMPP()
    mpp.set_name("Variably-Saturated-Flow-Model")
    mpp.set_id(MPPType.VSFM_SNES_CLM)
    mpp.set_num_meshes(1)
    mesh = structured_mesh("Soil mesh", 1.0, 1.0, z_column, 1, 1, nz,
                           ConnKind.IN_Z_DIR)
    mpp.add_mesh(mesh)
    ieqn = mpp.add_goveqn(GEType.RE, "Richards Equation ODE")
    mpp.add_condition_in_goveqn(ieqn, Cond.SS, "Source at top", "kg/s",
                                Cond.MASS_RATE,
                                region=Region.SOIL_TOP_CELLS)
    mpp.add_condition_in_goveqn(ieqn, Cond.BC,
                                "Constant head condition at bottom", "Pa",
                                Cond.DIRICHLET,
                                region=Region.SOIL_BOTTOM_CELLS)
    mpp.allocate_auxvars()
    mpp.setup_problem()

    # Soil properties (vsfm_wt_dynamics_problem.F90:366-369)
    porosity, lam, alpha, perm = 0.368, 0.5, 3.4257e-4, 8.3913e-12
    vish2o = 0.001002
    hksat = perm / vish2o * (C.DENH2O * C.GRAV_CLM) / 0.001
    shape = (1, nz)
    mpp.set_soils(filter_vsfmc=np.ones(1, np.int64),
                  watsat=np.full(shape, porosity),
                  hksat=np.full(shape, hksat),
                  bsw=np.full(shape, 1.0 / lam),
                  sucsat=np.full(shape, 1.0 / (alpha * GRAVITY_CONSTANT)),
                  residual_sat=np.full(shape, 0.2772),
                  satfunc_type="van_genuchten",
                  density_type=eos.DENSITY_TGDPB01)

    # Hydrostatic IC, water table at 0.5 m (:435-442): z is the cell-center
    # height; level 0 is the bottom of the column.
    dz = z_column / nz
    z = (np.arange(nz) + 0.5) * dz
    press_ic = 101325.0 + (0.5 - z) * 997.16 * 9.80868
    mpp.restart(press_ic)

    rain = 2.5e-5 * 1e3                      # [kg/s] (:468)
    bot = 101325.0 + 0.5 * 997.16 * 9.80868  # (:469)
    vsfm_stepper(mpp, use_compiled, device)
    for istep in range(1, nstep + 1):
        mpp.set_data(AuxVarKind.SS, Var.BC_SS_CONDITION, 1, np.full(1, rain))
        mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1, np.full(1, bot))
        converged, reason = mpp.soe.step_dt(dtime, istep)
        assert converged, f"step {istep} diverged (reason {reason})"
    return mpp


def output_regression(mpp, filename_base, num_cells):
    w = RegressionWriter(filename_base, num_cells)
    w.write_data("liquid_pressure", "pressure",
                 mpp.get_data(AuxVarKind.INTERNAL, Var.PRESSURE))
    w.write_data("liquid_saturation", "general",
                 mpp.get_data(AuxVarKind.INTERNAL, Var.LIQ_SAT))
    w.close()
    return w.filename

"""Celia et al. (1990) 1-D infiltration benchmark (VSFM, SNES path).

Counterpart of ``mpp_tpu/problems/vsfm_celia1990.py``
(``src/driver/standalone/vsfm/vsfm_celia1990_problem.F90``): 100-cell
vertical column, van Genuchten soils, Dirichlet head at top (9.3991e4 Pa)
and bottom (3.5355e3 Pa), 24 hourly implicit steps from a uniform
3.5355e3 Pa initial condition.

The steps run through the serial SNES of ``VSFMSoE.step_dt`` or, with
``use_compiled``, the compiled batched stepper at ncol=1 (its Thomas
kernel solves the tridiagonal system), on ``device`` (the card unless
``device="cpu"``).
"""
from __future__ import annotations

import numpy as np

from mpp_tpu_torch import constants as C
from mpp_tpu_torch.constants import (Cond, ConnKind, GEType, MPPType, Region,
                                     Var, AuxVarKind, GRAVITY_CONSTANT)
from mpp_tpu_torch.batched.vsfm_compiled import vsfm_stepper
from mpp_tpu_torch.dtypes.mesh import structured_mesh
from mpp_tpu_torch.models.richards import VSFMMPP
from mpp_tpu_torch.ops import eos
from mpp_tpu_torch.problems.vsfm_spac import output_regression  # noqa: F401


def run_vsfm_celia1990_problem(nz=100, dtime=3600.0, nstep=24,
                               use_compiled=False, device="cuda"):
    mpp = VSFMMPP()
    mpp.set_name("Variably-Saturated-Flow-Model")
    mpp.set_id(MPPType.VSFM_SNES_CLM)
    mpp.set_num_meshes(1)
    mesh = structured_mesh("Soil mesh", 1.0, 1.0, 1.0, 1, 1, nz,
                           ConnKind.IN_Z_DIR)
    mpp.add_mesh(mesh)
    ieqn = mpp.add_goveqn(GEType.RE, "Richards Equation ODE")

    mpp.add_condition_in_goveqn(ieqn, Cond.BC,
                                "Constant head condition at top", "Pa",
                                Cond.DIRICHLET,
                                region=Region.SOIL_TOP_CELLS)
    mpp.add_condition_in_goveqn(ieqn, Cond.BC,
                                "Constant head condition at bottom", "Pa",
                                Cond.DIRICHLET,
                                region=Region.SOIL_BOTTOM_CELLS)
    mpp.allocate_auxvars()
    mpp.setup_problem()

    # Soil properties (vsfm_celia1990_problem.F90:279-345)
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

    mpp.restart(np.full(nz, 3.5355e3))

    vsfm_stepper(mpp, use_compiled, device)
    for istep in range(1, nstep + 1):
        mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1,
                     np.full(1, 9.3991e4))
        mpp.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 2,
                     np.full(1, 3.5355e3))
        converged, reason = mpp.soe.step_dt(dtime, istep)
        assert converged, f"step {istep} diverged (reason {reason})"
    return mpp

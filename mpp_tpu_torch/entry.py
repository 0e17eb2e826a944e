"""Entry points of the port: the celia1990 column on the batched stepper.

Counterpart of ``__graft_entry__._build_compiled_celia`` / ``entry()``:
the celia1990 infiltration problem (vsfm_celia1990_problem.F90:106-345,
van Genuchten soils, TGDPB01 density, Dirichlet head at top and bottom)
built through the facade and frozen into the batched stepper;
:func:`entry` returns one f32 timestep over a [256, 128] batch and its
inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from mpp_tpu_torch import constants as C
from mpp_tpu_torch.constants import (Cond, ConnKind, GEType, MPPType, Region,
                                     GRAVITY_CONSTANT)
from mpp_tpu_torch.dtypes.mesh import structured_mesh
from mpp_tpu_torch.batched.vsfm_compiled import compile_vsfm
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.models.richards import VSFMMPP
from mpp_tpu_torch.ops import eos


def build_compiled_celia(nz):
    """Facade-build the celia1990 problem with ``nz`` cells and freeze it
    into a batched stepper; returns (mpp, comp)."""
    mpp = VSFMMPP()
    mpp.set_id(MPPType.VSFM_SNES_CLM)
    mesh = structured_mesh("Soil mesh", 1.0, 1.0, 1.0, 1, 1, nz,
                           ConnKind.IN_Z_DIR)
    mpp.add_mesh(mesh)
    ieqn = mpp.add_goveqn(GEType.RE, "Richards Equation ODE")
    mpp.add_condition_in_goveqn(ieqn, Cond.BC, "top", "Pa", Cond.DIRICHLET,
                                region=Region.SOIL_TOP_CELLS)
    mpp.add_condition_in_goveqn(ieqn, Cond.BC, "bot", "Pa", Cond.DIRICHLET,
                                region=Region.SOIL_BOTTOM_CELLS)
    mpp.allocate_auxvars()
    mpp.setup_problem()
    porosity, lam, alpha, perm = 0.368, 0.5, 3.4257e-4, 8.3913e-12
    hksat = perm / 0.001002 * (C.DENH2O * C.GRAV_CLM) / 0.001
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
    return mpp, compile_vsfm(mpp)


def entry(device="cuda", ncol=256, nz=128):
    """(fn, (X0, bc0)): ``fn(X, bc)`` advances the f32 celia1990 batch by
    one 3600 s step and returns the new state.  On the card unless
    ``device="cpu"``."""
    device = device_of(device)
    dtype = torch.float32
    _, comp = build_compiled_celia(nz)
    X0 = torch.full((ncol, nz), 3.5355e3, dtype=dtype, device=device)
    bc0 = torch.tensor([[9.3991e4, 3.5355e3]], dtype=dtype,
                       device=device).repeat(ncol, 1)
    ss0 = torch.zeros((ncol, 0), dtype=dtype, device=device)

    def fn(X, bc):
        Xn, iters, ok, reason = comp.step_batched(X, (bc,), (ss0,), 3600.0)
        return Xn

    return fn, (X0, bc0)

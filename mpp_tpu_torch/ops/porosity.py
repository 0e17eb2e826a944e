"""Porosity models (constant, linear compressibility).

Counterpart of ``mpp_tpu/ops/porosity.py`` (PorosityFunctionMod.F90).
The per-cell model codes are static numpy configuration; the parameter
fields are numpy at set-up and tensors (or batched dynamic overrides)
when evaluated.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

POROSITY_CONSTANT = 1
POROSITY_LINEAR = 2


@dataclasses.dataclass
class PorosityParams:
    """SoA of ``porosity_params_type`` (PorosityFunctionMod.F90:20-31)."""
    porosity_id: np.ndarray       # static model codes
    porosity_base: object
    pressure_reference: object
    lin_mod_slope: object

    @staticmethod
    def constant(base):
        base = np.asarray(base, dtype=np.float64)
        return PorosityParams(
            porosity_id=np.full(base.shape, POROSITY_CONSTANT, np.int32),
            porosity_base=base,
            pressure_reference=np.zeros_like(base),
            lin_mod_slope=np.zeros_like(base))

    @staticmethod
    def linear(base, press_base, slope):
        base = np.asarray(base, dtype=np.float64)
        return PorosityParams(
            porosity_id=np.full(base.shape, POROSITY_LINEAR, np.int32),
            porosity_base=base,
            pressure_reference=np.broadcast_to(press_base, base.shape).copy(),
            lin_mod_slope=np.broadcast_to(slope, base.shape).copy())

    def to(self, device, dtype) -> "PorosityParams":
        """The parameter fields as tensors (model codes stay numpy)."""
        f = lambda v: torch.as_tensor(v, dtype=dtype, device=device)
        return PorosityParams(porosity_id=self.porosity_id,
                              porosity_base=f(self.porosity_base),
                              pressure_reference=f(self.pressure_reference),
                              lin_mod_slope=f(self.lin_mod_slope))


def porosity(params: PorosityParams, P):
    """(por, dpor/dP) (PorosityFunctionMod.F90:98-162)."""
    pp = params.to(P.device, P.dtype)
    lin = np.asarray(params.porosity_id == POROSITY_LINEAR)
    por_lin = pp.porosity_base + (P - pp.pressure_reference) * pp.lin_mod_slope
    por_const = pp.porosity_base + 0.0 * P
    if lin.all():
        return por_lin, torch.zeros_like(por_lin) + pp.lin_mod_slope
    if not lin.any():
        return por_const, torch.zeros_like(por_const)
    mask = torch.as_tensor(lin, device=P.device)
    por = torch.where(mask, por_lin, por_const)
    dpor = torch.where(mask, pp.lin_mod_slope, 0.0) + torch.zeros_like(por)
    return por, dpor

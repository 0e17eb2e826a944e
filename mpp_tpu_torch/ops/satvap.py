"""Saturation vapor pressure and latent heat of vaporization.

Counterpart of ``mpp_tpu/ops/satvap.py``: elementwise PyTorch on the
temperature tensor's device and dtype, a reimplementation of
``src/mpp/util/SatVapor.F90`` (Flatau et al. 1992 polynomial fits; Bonan
CLM-ml_v0 lineage).
"""
from __future__ import annotations

import torch

from mpp_tpu_torch.constants import TFRZ, HVAP, HSUB, MM_H2O

# Water polynomials, 0C..100C (SatVapor.F90:49-69)
_A = (6.11213476, 0.444007856, 0.143064234e-01, 0.264461437e-03,
      0.305903558e-05, 0.196237241e-07, 0.892344772e-10, -0.373208410e-12,
      0.209339997e-15)
_B = (0.444017302, 0.286064092e-01, 0.794683137e-03, 0.121211669e-04,
      0.103354611e-06, 0.404125005e-09, -0.788037859e-12, -0.114596802e-13,
      0.381294516e-16)
# Ice polynomials, -75C..0C (SatVapor.F90:73-93)
_C = (6.11123516, 0.503109514, 0.188369801e-01, 0.420547422e-03,
      0.614396778e-05, 0.602780717e-07, 0.387940929e-09, 0.149436277e-11,
      0.262655803e-14)
_D = (0.503277922, 0.377289173e-01, 0.126801703e-02, 0.249468427e-04,
      0.313703411e-06, 0.257180651e-08, 0.133268878e-10, 0.394116744e-13,
      0.498070196e-16)


def _horner(coeffs, x):
    out = torch.zeros_like(x) + coeffs[-1]
    for c in reversed(coeffs[:-1]):
        out = out * x + c
    return out


def sat_vap(t_K):
    """Saturation vapor pressure es [Pa] and des/dT [Pa/K]
    (SatVapor.F90:26-114)."""
    tc = torch.clamp(t_K - TFRZ, -75.0, 100.0)
    water = tc >= 0.0
    es = torch.where(water, _horner(_A, tc), _horner(_C, tc))
    desdt = torch.where(water, _horner(_B, tc), _horner(_D, tc))
    return es * 100.0, desdt * 100.0


def lat_vap(t_K):
    """Molar latent heat of vaporization [J/mol] (SatVapor.F90:117-140)."""
    lam = torch.where(t_K > TFRZ, torch.full_like(t_K, HVAP),
                      torch.full_like(t_K, HSUB))
    return lam * MM_H2O

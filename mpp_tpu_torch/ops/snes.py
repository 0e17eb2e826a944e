"""PETSc SNES reason codes and the batched Newton's parameter set.

The reason codes are PETSc's ``SNESConvergedReason`` values
(``mpp_tpu/ops/snes.py:31-39``); ``SNESParams`` is the constant set of
SNESConvergedDefault + SNESLineSearchBT used by the compiled batched
stepper (``mpp_tpu/batched/vsfm_compiled.py:52-66``).  The serial numpy
SNES of the JAX package is not ported: the port has no serial path.
"""
from __future__ import annotations

from typing import NamedTuple

CONVERGED_FNORM_ABS = 2
CONVERGED_FNORM_RELATIVE = 3
CONVERGED_SNORM_RELATIVE = 4
CONVERGED_ITERATING = 0
DIVERGED_FUNCTION_COUNT = -2
DIVERGED_FNORM_NAN = -4
DIVERGED_MAX_IT = -5
DIVERGED_LINE_SEARCH = -6
DIVERGED_DTOL = -8


class SNESParams(NamedTuple):
    """SNESConvergedDefault + SNESLineSearchBT constants."""
    atol: float = 1e-50
    rtol: float = 1e-8
    stol: float = 1e-10
    max_it: int = 50
    divtol: float = 1e4
    ls_alpha: float = 1e-4
    ls_maxstep: float = 1e8
    ls_steptol: float = 1e-12
    ls_max_it: int = 40
    ls_damping: float = 1.0
    ksp_rtol: float = 1e-5
    ksp_atol: float = 1e-50
    ksp_restart: int = 30

"""Roughness-sublayer (RSL) psi_hat lookup tables: the port's own copy of
``mpp_tpu/ops/rsl_psihat.py`` (numpy).

Reimplements ``src/mpp/util/RSLPsiHat.F90`` (table load from the PETSc
binary Vec ``share/rsl_psihat.bin``) and the bilinear interpolation
``CanopyTurbulence.F90:445-538`` (``LookupPsihat``).

The PETSc binary Vec format is two big-endian int32 words (classid
1211214, length) followed by ``length`` big-endian float64 values; the
payload layout is dtLgridM(41), zdtgridM(276), psigridM(276x41, row
major), then the same three arrays for heat (RSLPsiHat.F90:54-95).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np

NZ, NL = 276, 41  # RSLPsiHat.F90:14

_DEFAULT_PATH = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                             "share", "rsl_psihat.bin")


@dataclasses.dataclass(frozen=True)
class PsiHatTables:
    zdt_m: np.ndarray    # [NZ] descending z/dt grid, momentum
    dtl_m: np.ndarray    # [NL] ascending dt/L grid, momentum
    psi_m: np.ndarray    # [NZ, NL]
    zdt_h: np.ndarray
    dtl_h: np.ndarray
    psi_h: np.ndarray


_CACHE = {}


def load_psihat(path: str | None = None) -> PsiHatTables:
    """Load and split the psihat tables (RSLPsiHat.F90:26-100)."""
    if path is None:
        path = os.environ.get("MPP_RSL_PSIHAT", _DEFAULT_PATH)
    path = os.path.abspath(path)
    if path in _CACHE:
        return _CACHE[path]
    header = np.fromfile(path, dtype=">i4", count=2)
    n = int(header[1])
    if n != (NZ + NL + NZ * NL) * 2:
        raise ValueError(f"rsl_psihat.bin has wrong length {n}")
    data = np.fromfile(path, dtype=">f8", offset=8, count=n).astype(np.float64)
    pos = 0

    def take(count):
        nonlocal pos
        out = data[pos:pos + count]
        pos += count
        return out

    dtl_m = take(NL)
    zdt_m = take(NZ)
    psi_m = take(NZ * NL).reshape(NZ, NL)
    dtl_h = take(NL)
    zdt_h = take(NZ)
    psi_h = take(NZ * NL).reshape(NZ, NL)
    tables = PsiHatTables(zdt_m, dtl_m, psi_m, zdt_h, dtl_h, psi_h)
    _CACHE[path] = tables
    return tables


def lookup_psihat(zdt: float, dtl: float, zdtgrid: np.ndarray,
                  dtlgrid: np.ndarray, psigrid: np.ndarray) -> float:
    """Bilinear psihat lookup (CanopyTurbulence.F90:445-538).

    Off-grid queries collapse to the 0.5/0.5-weighted edge row/column
    exactly as the reference does.
    """
    nl = dtlgrid.shape[0]
    nz = zdtgrid.shape[0]

    if dtl <= dtlgrid[0]:
        l1 = l2 = 0
        wl1 = wl2 = 0.5
    elif dtl > dtlgrid[nl - 1]:
        l1 = l2 = nl - 1
        wl1 = wl2 = 0.5
    else:
        jj = int(np.searchsorted(dtlgrid, dtl, side="left")) - 1
        l1, l2 = jj, jj + 1
        wl1 = (dtlgrid[l2] - dtl) / (dtlgrid[l2] - dtlgrid[l1])
        wl2 = 1.0 - wl1

    # zdtgrid is descending
    if zdt > zdtgrid[0]:
        z1 = z2 = 0
        wz1 = wz2 = 0.5
    elif zdt < zdtgrid[nz - 1]:
        z1 = z2 = nz - 1
        wz1 = wz2 = 0.5
    else:
        ii = nz - 1 - int(np.searchsorted(zdtgrid[::-1], zdt, side="right"))
        if ii < 0:
            ii = 0
        z1, z2 = ii, ii + 1
        if z2 > nz - 1:
            z2 = nz - 1
        wz1 = (zdt - zdtgrid[z2]) / (zdtgrid[z1] - zdtgrid[z2])
        wz2 = 1.0 - wz1

    return (wz1 * wl1 * psigrid[z1, l1] + wz2 * wl1 * psigrid[z2, l1]
            + wz1 * wl2 * psigrid[z1, l2] + wz2 * wl2 * psigrid[z2, l2])

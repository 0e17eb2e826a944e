"""CLM-like global dimension/bounds registry.

The reference keeps host-model dimensions in mutable module globals
(``src/mpp/util/mpp_varpar.F90:7-45``: nlevsoi/nlevgrnd/nlevsno/
max_patch_per_col) and per-process column/gridcell bounds in
``src/mpp/util/mpp_bounds.F90:9-27``.  Here both live in one explicit
registry object (host Python, the port's copy of ``mpp_tpu/varpar.py``):
problems receive a ``VarPar`` (default CLM values) and a ``Bounds``
instead of reading hidden globals.  A module-level default instance
mirrors the reference's init/setter API for drivers that follow the
Fortran call shape (``mpp_varpar_init``, ``mpp_varpar_set_nlev*``,
``mpp_bounds_init_proc_bounds``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class VarPar:
    """mpp_varpar analog (mpp_varpar.F90:7-10 defaults)."""
    nlevsoi: int = 10           # hydrologically active soil layers
    nlevgrnd: int = 15          # ground layers
    nlevsno: int = 5            # maximum snow layers
    max_patch_per_col: int = 20

    # setter API shape of mpp_varpar.F90:23-95
    def init(self, nlevsoi: int, nlevgrnd: int, nlevsno: int,
             max_patch_per_col: int) -> None:
        self.nlevsoi = nlevsoi
        self.nlevgrnd = nlevgrnd
        self.nlevsno = nlevsno
        self.max_patch_per_col = max_patch_per_col

    def set_nlevsoi(self, nlev: int) -> None:
        self.nlevsoi = nlev

    def set_nlevgrnd(self, nlev: int) -> None:
        self.nlevgrnd = nlev

    def set_nlevsno(self, nlev: int) -> None:
        self.nlevsno = nlev


@dataclasses.dataclass
class Bounds:
    """mpp_bounds analog (mpp_bounds.F90:9-27).

    ``begX/endX`` are this process's owned gridcells (g) / columns (c);
    the ``_all`` variants include ghosts received from lateral neighbors.
    Fortran-style inclusive 1-based in the reference; here 0-based
    half-open [beg, end) like every other index in the framework.
    """
    begg: int = 0
    endg: int = 0
    begc: int = 0
    endc: int = 0
    begg_all: int = 0
    endg_all: int = 0
    begc_all: int = 0
    endc_all: int = 0
    nclumps: int = 0

    @property
    def ncols(self) -> int:
        return self.endc - self.begc

    @property
    def ncols_all(self) -> int:
        return self.endc_all - self.begc_all

    @property
    def ncols_ghost(self) -> int:
        return self.ncols_all - self.ncols

    def init_proc_bounds(self, begg, endg, begg_all, endg_all,
                         begc, endc, begc_all, endc_all) -> None:
        self.begg, self.endg = begg, endg
        self.begg_all, self.endg_all = begg_all, endg_all
        self.begc, self.endc = begc, endc
        self.begc_all, self.endc_all = begc_all, endc_all


# Module-level default instances for drivers that mirror the reference's
# global-registry call shape.  Library code must take VarPar/Bounds as
# explicit arguments (defaulting to these).
varpar = VarPar()
bounds = Bounds()

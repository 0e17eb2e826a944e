"""Standalone multi-layer canopy (MLC) problem: its constants and profiles.

Counterpart of ``mpp_tpu/problems/mlc.py``, which reimplements the
reference driver ``src/driver/standalone/mlc/``:

* ``mlc_problem.F90`` — problem construction and the single 300 s step
* ``mlc_global_vars.F90`` — geometry: z_cair=46 m, nz_cair=92, hc=21 m
* ``mlc_meshes.F90`` — canopy-air and canopy(leaf) column meshes
* ``mlc_parameters.F90`` — plant-area profile (beta-distribution
  integration), sunlit fraction profile, stomatal conductance and net
  radiation tables, turbulence and soil-surface parameters
* ``mlc_conditions.F90`` — Dirichlet atmospheric forcing at column tops
  and the 4-way internal coupling declaration

Regression tests: ``regression_tests/mlc/{mlc, mlc-two-ncair-two-tree}``.

The port carries the geometry, the parameter tables and
:func:`get_dpai_fssh`, which the canopy pipeline reads.
``run_mlc_problem`` and ``output_regression`` need the serial MLC facade
``models/mlc.MLCMPP`` (ROADMAP Slice E2) and raise.
"""
from __future__ import annotations

import math

import numpy as np


# Geometry (mlc_global_vars.F90:9-24)
Z_CAIR = 46.0
NZ_CAIR = 92
NZ_CLEAF = 92
HC = 21.0

# Uniform leaf-level parameters (mlc_parameters.F90:80-99, 208-230)
GBH = 2.268731551029694
GBV = 2.496430918408511
CP_LEAF = 744.5333333333334
FWET = 0.0
FDRY = 0.8218390792391702
PAI = 5.051612734794617
KB = 1.762817445019839

# Sunlit/shaded stomatal conductance and net radiation tables, canopy
# layers k=7..43 (1-based; mlc_parameters.F90:316-355, 382-419, 262-299,
# 458-495).  Physical input data of the reference test problem.
SUN_GS = {
    7: 0.1056193510550169, 8: 0.1058669704208841, 9: 0.1062166035088956,
    10: 0.1066846074875817, 11: 0.107285438728628, 12: 0.1080315168674592,
    13: 0.1089335362366439, 14: 0.1100012607812562, 15: 0.1112447128077408,
    16: 0.1126755044648808, 17: 0.1138467165585616, 18: 0.1170524695200598,
    19: 0.1186451281076514, 20: 0.1206859738130298, 21: 0.1228219389652392,
    22: 0.1263235652964973, 23: 0.1300019677357508, 24: 0.1322680545506565,
    25: 0.1367071935229807, 26: 0.140821675925868, 27: 0.1452273039039047,
    28: 0.1499262843535941, 29: 0.1549264640058029, 30: 0.1611234013632947,
    31: 0.1668845999057947, 32: 0.1727971327085968, 33: 0.1788628079180081,
    34: 0.1850771375553107, 35: 0.1934140277837149, 36: 0.19981166846502,
    37: 0.206162674701859, 38: 0.212479500822311, 39: 0.2173241738995193,
    40: 0.2228796106202699, 41: 0.2272584280787935, 42: 0.230366204352862,
    43: 0.2315636153119537,
}
SHD_GS = {
    7: 0.002, 8: 0.002, 9: 0.002, 10: 0.002, 11: 0.002, 12: 0.002,
    13: 0.002, 14: 0.002, 15: 0.002, 16: 0.002, 17: 0.002, 18: 0.002,
    19: 0.002, 20: 0.002, 21: 0.002, 22: 0.002, 23: 0.002,
    24: 0.0052146013029975334, 25: 0.0055227688387169205,
    26: 0.00929454391245553, 27: 0.009410127508926645,
    28: 0.012582674218550544, 29: 0.01699987442174327,
    30: 0.02303643510598494, 31: 0.0279038668160234,
    32: 0.03738530895949397, 33: 0.046808450662473224,
    34: 0.05903697728333576, 35: 0.0718908086890351,
    36: 0.08754777470335541, 37: 0.1059444058487105,
    38: 0.1228398700721039, 39: 0.1416660859387607,
    40: 0.1584170776550386, 41: 0.1712280540285039, 42: 0.180104862409209,
    43: 0.1844507421254655,
}
SUN_RN = {
    7: 139.9869857739781, 8: 139.8100113537029, 9: 139.7147998761629,
    10: 139.6645467566822, 11: 139.6422035725484, 12: 139.6392966303582,
    13: 139.6514847604817, 14: 139.6766021357984, 15: 139.7137254254163,
    16: 139.7627019640728, 17: 139.8238999626867, 18: 139.8980702313243,
    19: 139.9862631887909, 20: 140.0897684653183, 21: 140.2100538053315,
    22: 140.3486818847138, 23: 140.5071806149416, 24: 140.6868352048059,
    25: 140.8883584829672, 26: 141.1113792315132, 27: 141.3536664423189,
    28: 141.6099822011559, 29: 141.8704336551236, 30: 142.11819130939,
    31: 142.3264909566734, 32: 142.4550034158019, 33: 142.4460421185886,
    34: 142.2218178601452, 35: 141.6851596824207, 36: 140.7277716843982,
    37: 139.2518034108234, 38: 137.2114197261891, 39: 134.6805463548995,
    40: 131.9550915266485, 41: 129.736187309463, 42: 129.7993862020948,
    43: 143.7045065806239,
}
SHD_RN = {
    7: 1.411488333307743, 8: 1.23451391303259, 9: 1.139302435492522,
    10: 1.089049316011852, 11: 1.066706131878055, 12: 1.063799189687813,
    13: 1.075987319811279, 14: 1.101104695127997, 15: 1.138227984745972,
    16: 1.187204523402388, 17: 1.248402522016342, 18: 1.322572790653995,
    19: 1.41076574812054, 20: 1.514271024647946, 21: 1.634556364661143,
    22: 1.773184444043382, 23: 1.931683174271291, 24: 2.111337764135555,
    25: 2.312861042296822, 26: 2.535881790842842, 27: 2.778169001648555,
    28: 3.034484760485563, 29: 3.294936214453243, 30: 3.54269386871961,
    31: 3.750993516003037, 32: 3.879505975131512, 33: 3.870544677918208,
    34: 3.646320419474797, 35: 3.109662241750371, 36: 2.152274243727867,
    37: 0.676305970153017, 38: -1.364077714481233, 39: -3.89495108577087,
    40: -6.620405914021802, 41: -8.83931013120737, 42: -8.776111238575538,
    43: 5.12900913995361,
}


def get_dpai_fssh():
    """Plant-area-index increment and sunlit-fraction profiles
    (mlc_parameters.F90:233-313): numerical integration of a beta(3.5,2)
    plant-area density over each layer, zeroing of layers with
    dpai<0.01 and proportional redistribution, then cumulative
    Beer-Lambert sunlit fractions downward from the canopy top.

    Returns 1-based arrays dpai[0..93], fssh[0..93] (index 0 unused).
    """
    n = NZ_CLEAF + 1
    dpai = np.zeros(n + 1)
    fssh = np.zeros(n + 1)
    dz_leaf = Z_CAIR / NZ_CLEAF
    pbeta, qbeta = 3.5, 2.0
    lg = math.lgamma
    bnorm = math.exp(lg(pbeta) + lg(qbeta) - lg(pbeta + qbeta))
    for k in range(2, 43 + 1):
        zl = dz_leaf * (k - 2)
        zu = dz_leaf * (k - 1)
        acc = 0.0
        num_int = 100
        dz_int = (zu - zl) / num_int
        z_int = 0.0
        for i in range(1, num_int + 1):
            if i == 1:
                z_int = zl + 0.5 * dz_int
            else:
                z_int = z_int + dz_int
            zrel = min(z_int / HC, 1.0)
            beta_pdf = (zrel ** (pbeta - 1.0)
                        * (1.0 - zrel) ** (qbeta - 1.0)) / bnorm
            pad = (PAI / HC) * beta_pdf
            acc += pad * dz_int
        dpai[k] = acc

    pai_sum = 0.0
    for k in range(2, 43 + 1):
        pai_sum += dpai[k]
    pai_miss = 0.0
    for k in range(2, 43 + 1):
        if dpai[k] < 0.01:
            pai_miss += dpai[k]
            dpai[k] = 0.0
    if pai_miss > 0.0:
        pai_new = pai_sum - pai_miss
        for k in range(2, 43 + 1):
            dpai[k] = dpai[k] + pai_miss * (dpai[k] / pai_new)

    sumpai = 0.0
    for k in range(43, 6, -1):
        if k == 43:
            sumpai = 0.5 * dpai[k]
        else:
            sumpai = sumpai + 0.5 * (dpai[k + 1] + dpai[k])
        fssh[k] = math.exp(-KB * sumpai)
    return dpai, fssh


def run_mlc_problem(ncair: int = 1, ntree: int = 1,
                    use_compiled: bool = False):
    raise NotImplementedError(
        "run_mlc_problem needs the serial MLC facade models/mlc.MLCMPP, not "
        "ported yet (ROADMAP Slice E2)")


def output_regression(mpp, filename_base: str, num_cells: int) -> str:
    raise NotImplementedError(
        "output_regression needs models/mlc.MLCMPP and io/regression, not "
        "ported yet (ROADMAP Slice E2)")

"""Standalone multi-layer canopy (MLC) problem.

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

``run_mlc_problem`` builds the problem on the serial facade
``models/mlc.MLCMPP`` (host assembly, its KSP solve on ``device``, the
card unless ``device="cpu"``) or, with ``use_compiled``, steps it through
``batched/mlc_compiled.CompiledMLC``.  The canopy pipeline reads the
geometry, the parameter tables and :func:`get_dpai_fssh`.
"""
from __future__ import annotations

import math

import numpy as np

from mpp_tpu_torch.io.regression import RegressionWriter
from mpp_tpu_torch.models.mlc import MLCMPP

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
                    use_compiled: bool = False, device="cuda") -> MLCMPP:
    """Build and step the MLC problem (mlc_problem.F90:24-136) on
    ``device``.

    ``use_compiled`` routes step_dt through the compiled assemble+solve
    on the device (batched/mlc_compiled.py) instead of the host-side
    numpy assembly + device GMRES."""
    mpp = MLCMPP(ncair=ncair, ntree=ntree, nz_cair=NZ_CAIR, z_cair=Z_CAIR,
                 device=device)
    nlev = mpp.nlev
    ct = mpp.cturb

    dpai, fssh = get_dpai_fssh()

    # --- air temperature / vapor GE parameters
    # (mlc_parameters.F90:42-105, 108-173): canopy-air cells k=1..nz_cair
    for icair in range(ncair):
        for k in range(1, NZ_CAIR + 1):       # Fortran k (1-based)
            icell = icair * nlev + (k - 1)    # 0-based air cell
            mpp.at_gbh[icell, :] = GBH
            mpp.av_gbv[icell, :] = GBV
            for pre_dpai, pre_fwet, pre_fdry, pre_gs, pre_fssh in (
                (mpp.at_leaf_dpai, mpp.at_leaf_fwet, mpp.at_leaf_fdry,
                 mpp.at_leaf_gs, mpp.at_leaf_fssh),
                (mpp.av_leaf_dpai, mpp.av_leaf_fwet, mpp.av_leaf_fdry,
                 mpp.av_leaf_gs, mpp.av_leaf_fssh)):
                pre_dpai[icell, :] = dpai[k] / ntree
                pre_fwet[icell, :] = FWET
                pre_fdry[icell, :] = FDRY
                for il in range(ntree):
                    pre_gs[icell, il] = SUN_GS.get(k, 0.0)
                    pre_gs[icell, ntree + il] = SHD_GS.get(k, 0.0)
                    pre_fssh[icell, il] = fssh[k]
                    pre_fssh[icell, ntree + il] = 1.0 - fssh[k]
        soil = icair * nlev
        mpp.at_is_soil[soil] = True
        mpp.av_is_soil[soil] = True

    # --- leaf GE parameters (mlc_parameters.F90:176-230, 246-299, 422-495)
    for r, (gs_tab, rn_tab) in enumerate(((SUN_GS, SUN_RN),
                                          (SHD_GS, SHD_RN))):
        ge = mpp.leaf[r]
        for icair in range(ncair):
            for itree in range(ntree):
                for k in range(1, NZ_CLEAF + 2):     # Fortran k=1..93
                    icell = (icair * nlev * ntree + itree * nlev + (k - 1))
                    ge["gbh"][icell] = GBH
                    ge["gbv"][icell] = GBV
                    ge["cp"][icell] = CP_LEAF
                    ge["fwet"][icell] = FWET
                    ge["fdry"][icell] = FDRY
                    ge["dpai"][icell] = dpai[k] / ntree
                    if r == 0:
                        ge["fssh"][icell] = fssh[k]
                    else:
                        ge["fssh"][icell] = 1.0 - fssh[k]
                    if 7 <= k <= 43:
                        ge["gs"][icell] = gs_tab[k]
                        ge["rn"][icell] = rn_tab[k]

    # --- turbulence parameters (mlc_parameters.F90:498-548)
    for p in range(ncair):
        ct.pai[p] = PAI
        ct.hc[p] = HC
        ct.zref[p] = 46.0
        ct.pref[p] = 98620.0
        ct.uref[p] = 5.169
        ct.tref[p] = 295.9349938964844
        ct.rhref[p] = 53.871
        ct.tcan[p] = ct.tref[p]
        # qref is never initialized by the reference driver (fresh
        # allocation => 0); the derived eref/qcan are therefore 0 too.
        ct.qref[p] = 0.0
        ct.compute_derived_atm_inputs(p)
        ct.qcan[p] = ct.qref[p]

    # --- soil-surface parameters (mlc_parameters.F90:551-585)
    for p in range(ncair):
        ct.soil_tk[p] = 1.261326601469150
        ct.soil_dz[p] = 7.1006354171935350e-3
        ct.soil_temperature[p] = 294.8492736816406
        ct.soil_res[p] = 3361.509423807650
        ct.soil_rhg[p] = 0.9984057411945876
        ct.soil_rn[p] = 1.896127799819662

    # --- initial conditions (mlc_problem.F90:243-330)
    o = mpp.off
    mpp.soln[o[0]:o[0] + mpp.Na] = ct.tref[0]
    mpp.soln[o[1]:o[1] + mpp.Na] = ct.qref[0]
    mpp.soln[o[2]:o[2] + mpp.Nl] = ct.tref[0]
    mpp.soln[o[3]:o[3] + mpp.Nl] = ct.tref[0]
    mpp.soln_prev[:] = mpp.soln

    if use_compiled:
        from mpp_tpu_torch.batched.mlc_compiled import compile_mlc
        compile_mlc(mpp).install()
    # One 5-minute step (mlc_problem.F90:76-81)
    converged, iters = mpp.soe.step_dt(5.0 * 60.0)
    if not converged:
        raise RuntimeError("MLC KSP solve diverged")
    return mpp


def output_regression(mpp: MLCMPP, filename_base: str,
                      num_cells: int) -> str:
    """Write the regression file (output_regression_mlc_problem,
    mlc_problem.F90:333-395).  All four sections use a data array sized
    ntree*(nz_cair+1)*ncair; the air sections fill only the first
    (nz_cair+1)*ncair entries and keep trailing zeros — stats include
    the zero padding, as in the reference."""
    w = RegressionWriter(filename_base, num_cells)
    ncells_all = mpp.ntree * mpp.nlev * mpp.ncair
    ncells_air = mpp.nlev * mpp.ncair

    data = np.zeros(ncells_all)
    data[:ncells_air] = mpp.at_T
    w.write_data("air_temperature", "temperature", data)

    data = np.zeros(ncells_all)
    data[:ncells_air] = mpp.av_q
    w.write_data("air_vapor", "general", data)

    w.write_data("sunlit_leaf_temperature", "temperature", mpp.leaf[0]["T"])
    w.write_data("shaded_leaf_temperature", "temperature", mpp.leaf[1]["T"])
    w.close()
    return w.filename

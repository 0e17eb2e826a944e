"""Registry of IDs and physical constants: the port's own copy of
``mpp_tpu/constants.py`` (same names and values; the tests hold the two
equal).

Mirrors the enum/constant registry of the reference library
(``src/mpp/util/MultiPhysicsProbConstants.F90:17-217``) so that problem
definitions, condition types, and variable IDs carry the same meaning.  The
IDs are plain Python ints (static configuration).
"""
from __future__ import annotations

import enum


class Discretization(enum.IntEnum):
    VERTICAL_ONLY = 1
    HORIZONTAL_ONLY = 2
    THREE_DIM = 3
    VERTICAL_WITH_SS = 4


class MPPType(enum.IntEnum):
    """Problem (facade) ids — MultiPhysicsProbConstants.F90:23-31."""
    VSFM_SNES_CLM = 11
    THERMAL_TBASED_KSP_CLM = 12
    THERMAL_EBASED_SNES_CLM = 13
    TH_SNES_CLM = 14
    MLC_KSP = 15
    LBL_KSP = 16
    PHOTOSYNTHESIS_SNES = 17
    LONGWAVE_KSP = 18
    SHORTWAVE_KSP = 19


class SOEType(enum.IntEnum):
    """System-of-equations ids — MultiPhysicsProbConstants.F90:34-42."""
    RE_ODE = 101
    THERMAL_TBASED = 102
    THERMAL_EBASED = 103
    TH = 104
    MLC = 105
    LBL = 106
    PHOTOSYNTHESIS = 107
    LONGWAVE = 108
    SHORTWAVE = 109


class GEType(enum.IntEnum):
    """Governing-equation ids — MultiPhysicsProbConstants.F90:45-56."""
    RE = 201
    THERM_SOIL_TBASED = 202
    THERM_SNOW_TBASED = 203
    THERM_SSW_TBASED = 204
    THERM_SOIL_EBASED = 205
    CANOPY_AIR_TEMP = 206
    CANOPY_AIR_VAPOR = 207
    CANOPY_LEAF_TEMP = 208
    LEAF_BND_LAYER = 209
    PHOTOSYNTHESIS = 210
    LONGWAVE = 211
    SHORTWAVE = 212


class MeshType(enum.IntEnum):
    """Mesh ids — MultiPhysicsProbConstants.F90:59-66."""
    CLM_SOIL_COL = 301
    CLM_THERMAL_SOIL_COL = 302
    CLM_SNOW_COL = 303
    CLM_SSW_COL = 304
    SPAC_ROOT_COL = 305
    SPAC_XYLEM_COL = 306
    ALONG_GRAVITY = 311
    AGAINST_GRAVITY = 312


class Region(enum.IntEnum):
    """Region ids — MultiPhysicsProbConstants.F90:69-79."""
    SOIL_TOP_CELLS = 401
    SOIL_BOTTOM_CELLS = 402
    SOIL_CELLS = 403
    SOIL_CELLS_OF_NEIGH_MESH = 404
    SNOW_TOP_CELLS = 405
    SNOW_BOTTOM_CELLS = 406
    SSW_TOP_CELLS = 407
    ALL_CELLS = 408
    DEFINED_BY_CELL_ID = 409
    FACE_TOP = 410
    FACE_BOTTOM = 411


class Cond(enum.IntEnum):
    """Condition (BC/SS) types — MultiPhysicsProbConstants.F90:82-94."""
    NULL = 500
    BC = 501
    SS = 502
    MASS_RATE = 503
    MASS_FLUX = 504
    DIRICHLET = 505
    DIRICHLET_FRM_OTR_GOVEQ = 506
    HEAT_FLUX = 507
    DARCY_RATE = 508
    SEEPAGE_BC = 509
    HEAT_RATE = 511
    DOWNREG_MASS_RATE_CAMPBELL = 512
    DOWNREG_MASS_RATE_FETCH2 = 513


class Var(enum.IntEnum):
    """Variable ids — MultiPhysicsProbConstants.F90:97-170 (subset grows as
    subsystems land; values match the reference)."""
    XI = 601
    DXI_DP = 602
    DXI_DTIME = 603
    PRESSURE = 604
    TEMPERATURE = 605
    PRESSURE_PREV = 606
    BC_SS_CONDITION = 607
    LIQ_SAT = 608
    DENSITY_TYPE = 609
    MASS = 610
    SOIL_MATRIX_POT = 611
    FRAC_LIQ_SAT = 612
    LATERAL_MASS_EXCHANGED = 613
    BC_MASS_EXCHANGED = 614
    LIQ_AREAL_DEN = 615
    ICE_AREAL_DEN = 617
    FRAC = 618
    SNOW_WATER = 619
    NUM_SNOW_LYR = 620
    DHS_DT = 621
    THERMAL_COND = 622
    HEAT_CAP = 623
    ACTIVE = 624
    DX = 625
    DY = 626
    DZ = 627
    DIST_UP = 628
    DIST_DN = 629
    TUNING_FACTOR = 630
    XC = 631
    YC = 632
    ZC = 633
    AREA = 634
    VOLUME = 635
    CONDUCTANCE = 636
    FLUX_TYPE = 637
    POT_MASS_SINK_PRESSURE = 638
    POT_MASS_SINK_EXPONENT = 639
    PRESSURE_UP = 640
    PRESSURE_DN = 641
    CAMPBELL_HE = 642
    CAMPBELL_N = 643
    MASS_FLUX = 644
    CONDUCTANCE_TYPE = 645
    CONDUCTANCE_UP = 646
    CONDUCTANCE_DN = 647
    WATER_VAPOR = 648
    LEAF_TEMPERATURE = 649
    LEAF_BDN_LYR_COND_HEAT = 650
    LEAF_BDN_LYR_COND_H2O = 651
    LEAF_BDN_LYR_COND_CO2 = 652
    SCM_MEDLYN = 653
    SCM_BBERRY = 654
    SCM_WUE = 655
    SCM_BONAN14 = 656
    SCM_MANZONI11 = 657
    SCM_MODIFIED_BONAN14 = 658
    PHOTOSYNTHETIC_PATHWAY_C4 = 659
    PHOTOSYNTHETIC_PATHWAY_C3 = 660
    STOMATAL_CONDUCTANCE = 661
    LEAF_ABSORBED_SHORTWAVE_RAD_PER_LAI = 662
    SOIL_ABSORBED_SHORTWAVE_RAD_PER_GROUND = 663
    LEAF_ABSORBED_LONGWAVE_RAD_PER_LAI = 664
    SOIL_ABSORBED_LONGWAVE_RAD_PER_GROUND = 665
    GROSS_PHOTOSYNTHESIS = 666
    NET_PHOTOSYNTHESIS = 667
    LEAF_HEAT_STORAGE = 668
    LATENT_HEAT_FLUX = 669
    SENSIBLE_HEAT_FLUX = 670
    LEAF_TRANSPIRATION = 671
    POT_SINK_DOWNREG_FACTOR = 672
    SCM_OSMWANG = 673


class AuxVarKind(enum.IntEnum):
    """MultiPhysicsProbConstants.F90:172-177."""
    INTERNAL = 701
    BC = 702
    SS = 703
    CONN_INTERNAL = 704
    CONN_BC = 705
    BC_OTR_GOVEQ = 706


class SolverKind(enum.IntEnum):
    """MultiPhysicsProbConstants.F90:179-181."""
    TS = 801
    SNES = 802
    KSP = 803


class ConnKind(enum.IntEnum):
    """MultiPhysicsProbConstants.F90:183-191."""
    VERTICAL = 901
    HORIZONTAL = 902
    SET_INTERNAL = 903
    SET_LATERAL = 904
    SET_CONDITIONS = 905
    IN_X_DIR = 906
    IN_Y_DIR = 907
    IN_Z_DIR = 908
    IN_XYZ_DIR = 909


class FluxType(enum.IntEnum):
    """MultiPhysicsProbConstants.F90:193-196."""
    DARCY = 1001
    CONDUCTANCE = 1002
    CONDUCTANCE_CAMPBELL = 1003
    CONDUCTANCE_MANOLI = 1004


# --- Physical constants (MultiPhysicsProbConstants.F90:199-217) -------------
PRESSURE_REF = 101325.0          # [Pa]
GRAVITY_CONSTANT = 9.80665       # [m s^-2]
FMWH2O = 18.01534                # [kg kmol^-1]
STEFAN_BOLTZMAN_CONSTANT = 5.67e-08
VKC = 0.4                        # von Karman constant [-]
TFRZ = 273.15                    # [K]
MM_H2O = 18.02e-3                # [kg mol^-1]
MM_DRY_AIR = 28.97e-3            # [kg mol^-1]
HVAP = 2.501e6                   # [J/kg]
HSUB = 2.8347e6                  # [J/kg]
CPD = 1005.0                     # [J/kg/K]
CPW = 1846.0                     # [J/kg/K]
RGAS = 8.31446                   # [J/K/mol]
VISC_0C = 13.3e-06               # [m^2/s]
MOD_DIFF_HEAT_OC = 18.9e-6       # [m^2/s]
MOD_DIFF_H2O_OC = 21.8e-6        # [m^2/s]
MOD_DIFF_CO2_OC = 13.8e-6        # [m^2/s]

# --- CLM-like globals (mpp_varcon.F90:12-30). Module-level mutable config in
# the reference; here they are defaults collected into one place.  Problems
# that need to override them (e.g. cnfac=0 for steady state) pass explicit
# values through their config instead of mutating globals.
GRAV_CLM = 9.80616               # [m/s2] (mpp_varcon grav)
CPLIQ = 4.188e3                  # [J/kg-K]
CPICE = 2.11727e3                # [J/kg-K]
DENH2O = 1.000e3                 # [kg/m3]
DENICE = 0.917e3                 # [kg/m3]
TKAIR = 0.023                    # [W/m/K]
TKICE = 2.290                    # [W/m/K]
TKWAT = 0.57                     # [W/m/K]
THK_BEDROCK = 3.0                # [W/m/K]
CNFAC = 0.5                      # Crank-Nicolson factor
CAPR = 0.34                      # surface-T tuning factor

# Landunit type ids: the reference receives these from the host model
# (mpp_varcon_init_landunit).  The standalone drivers use 1-based CLM values.
IST_SOIL = 1
IST_CROP = 2
IST_ICE = 3
IST_ICE_MEC = 4
IST_DLAK = 5
IST_WET = 6

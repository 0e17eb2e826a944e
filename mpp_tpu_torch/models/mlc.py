"""Multi-layer canopy (MLC) model: coupled canopy air temperature, canopy
air vapor, and sunlit/shaded leaf temperature (KSP path).

The port's counterpart of ``mpp_tpu/models/mlc.py``, a reimplementation
of:

* ``soe/SystemOfEquationsMLCType.F90`` — 4-block coupled linear system
  with a turbulence presolve (Obukhov length / wind / conductance
  profiles) and pairwise auxvar exchange (:79-455)
* ``ge/GoveqnCanopyAirTemperatureType.F90`` — canopy-air energy balance
  with an eliminated ground-surface temperature row (alpha0/beta0/delta0/
  gamma0 of Bonan 2019 eqns 16.86-16.88; :585-730), Bonan formulation
  (``-DUSE_BONAN_FORMULATION`` is set globally, CMakeLists.txt:105)
* ``ge/GoveqnCanopyAirVaporType.F90`` — canopy-air water vapor balance
  with leaf transpiration sources and a held ground vapor row (:539-1160)
* ``ge/GoveqnCanopyLeafTemperatureType.F90`` — per-layer sun/shade leaf
  energy balance (:387-520)
* ``mpp/MultiPhysicsProbMLC.F90`` — problem facade

State is struct-of-arrays numpy float64 on the host, as in the JAX
package: the assembly is per-cell Python, and scalar reads of device
tensors would cost a synchronisation each.  The assembled block-CSR
system is solved with the PETSc-default-compatible GMRES(30)+ILU(0)
(``ops/ilu.py``) on ``device`` (the card unless ``device="cpu"``): the
CSR values and the right-hand side go up, the solution comes down, one
round trip a step.  The per-column turbulence presolve lives in
``models/canopy_turbulence.py``.

Block unknown layout (DMComposite order, MultiPhysicsProbBaseType.F90:
1237-1325): x = [T_air (Na) | q_air (Na) | T_sun (Nl) | T_shd (Nl)],
Na = ncan_lev*ncair, Nl = ncan_lev*ncair*ntree.
"""
from __future__ import annotations

import numpy as np
import torch

from mpp_tpu_torch.constants import HVAP, MM_H2O
from mpp_tpu_torch.constants import SOEType as _SOEType
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.dtypes.mpp_base import MPPBase
from mpp_tpu_torch.models.canopy_turbulence import (
    CanopyTurbulenceAuxVar, obukhov_length, wind_profile,
    aerodynamic_conductances)
from mpp_tpu_torch.ops.ilu import ILU0, petsc_gmres
from mpp_tpu_torch.ops.satvap import _A, _B
from mpp_tpu_torch.ops.sparse import csr_template

_SOE_MLC = _SOEType.MLC

LAMBDA = HVAP * MM_H2O


def satvap_np(t):
    """Flatau water-range polynomial es/desdt in numpy float64 (matches
    ``util/SatVapor.F90:95-113`` op-for-op for T > 0C)."""
    tc = np.minimum(np.maximum(np.asarray(t, np.float64) - 273.15, -75.0),
                    100.0)
    es = np.full_like(tc, _A[-1])
    for c in reversed(_A[:-1]):
        es = c + tc * es
    desdt = np.full_like(tc, _B[-1])
    for c in reversed(_B[:-1]):
        desdt = c + tc * desdt
    return es * 100.0, desdt * 100.0


class MLCSoE:
    """SoE surface of the MLC system (SystemOfEquationsMLCType.F90):
    step_dt + iteration counters + metrics.

    Deviation from the reference's per-GE object graph: the 3·ntree+2
    governing-equation blocks are FUSED at assembly into one SoA layout
    on the owning ``MLCMPP`` (the TPU-efficient form); this SoE carries
    the solver-orchestration surface over that fused state."""

    def __init__(self, mpp: "MLCMPP"):
        self.mpp = mpp
        self.itype = int(_SOE_MLC)
        self.metrics = None

    @property
    def cumulative_linear_iterations(self):
        return self.mpp.cumulative_linear_iterations

    def step_dt(self, dt: float, nstep: int = 1):
        conv, iters = self.mpp._step_dt_impl(dt)
        if self.metrics is not None:
            self.metrics.record(step=nstep, dt=dt, converged=bool(conv),
                                linear_iterations=int(iters))
        return conv, iters


class MLCMPP(MPPBase):
    """MLC multi-physics problem over ``ncair`` canopy-air columns with
    ``ntree`` trees per column (MultiPhysicsProbMLC.F90:30-37).

    Subclasses the shared facade base (builder surface: set_name/set_id/
    add_mesh); the GE registry is intentionally empty — MLC's governing
    equations are fused into SoA blocks at construction (see MLCSoE).
    The KSP solve runs on ``device``; ``host_syncs`` counts its host reads
    (GMRES's predicates and the solution's download)."""

    GE_CLASSES = {}

    def __init__(self, ncair: int = 1, ntree: int = 1, nz_cair: int = 92,
                 z_cair: float = 46.0, device="cuda"):
        super().__init__()
        self.device = device_of(device)
        self.host_syncs = 0
        self.soe = MLCSoE(self)
        self.ncair = ncair
        self.ntree = ntree
        self.dz_cair = z_cair / nz_cair
        self.nlev = nz_cair + 1          # ncan_lev
        self.Na = self.nlev * ncair      # canopy-air cells
        self.Nl = self.nlev * ncair * ntree  # leaf cells (per leaf GE)
        self.nleaf_slots = 2 * ntree     # sun slots [0,ntree), shd [ntree,2*ntree)
        self.dtime = 0.0

        self.cturb = CanopyTurbulenceAuxVar(ncair, self.nlev)

        Na, Nl, ns = self.Na, self.Nl, self.nleaf_slots

        # leaf->canopy-air map (GoveqnCanopyAirVaporType.F90:86-111):
        # leaf cell (icair, itree, k) -> air cell (icair, k)
        self.leaf2cair = np.zeros(Nl, np.int64)
        self.leaf_slot = np.zeros(Nl, np.int64)  # per-rank tree slot
        count = np.zeros(Na, np.int64)
        i = 0
        for icair in range(ncair):
            for itree in range(ntree):
                for k in range(self.nlev):
                    cair = icair * self.nlev + k
                    self.leaf2cair[i] = cair
                    self.leaf_slot[i] = count[cair]
                    count[cair] += 1
                    i += 1

        # --- canopy-air temperature GE auxvars (CanopyAirTemperatureAuxType)
        self.at_T = np.zeros(Na)          # primary
        self.at_T_prev = np.zeros(Na)
        self.at_qair = np.zeros(Na)
        self.at_cpair = np.zeros(Na)
        self.at_rhomol = np.zeros(Na)
        self.at_pref = np.zeros(Na)
        self.at_is_soil = np.zeros(Na, bool)
        self.at_soil_rhg = np.zeros(Na)
        self.at_soil_rn = np.zeros(Na)
        self.at_soil_tk = np.zeros(Na)
        self.at_soil_dz = np.zeros(Na)
        self.at_soil_resis = np.zeros(Na)
        self.at_soil_T = np.zeros(Na)
        self.at_gbh = np.zeros((Na, ns))
        self.at_leaf_T = np.zeros((Na, ns))
        self.at_leaf_gs = np.zeros((Na, ns))
        self.at_leaf_fwet = np.zeros((Na, ns))
        self.at_leaf_fdry = np.zeros((Na, ns))
        self.at_leaf_fssh = np.zeros((Na, ns))
        self.at_leaf_dpai = np.zeros((Na, ns))
        self.at_leaf_sh_flux = np.zeros((Na, ns))
        self.at_conn_ga = np.zeros(Na - ncair)   # internal conns per column
        self.at_bc_ga = np.zeros(ncair)
        self.at_bc_T = np.zeros(ncair)

        # --- canopy-air vapor GE auxvars (CanopyAirVaporAuxType)
        self.av_q = np.zeros(Na)          # primary
        self.av_q_prev = np.zeros(Na)
        self.av_T = np.zeros(Na)
        self.av_cpair = np.zeros(Na)
        self.av_rhomol = np.zeros(Na)
        self.av_pref = np.zeros(Na)
        self.av_is_soil = np.zeros(Na, bool)
        self.av_soil_rhg = np.zeros(Na)
        self.av_soil_rn = np.zeros(Na)
        self.av_soil_tk = np.zeros(Na)
        self.av_soil_dz = np.zeros(Na)
        self.av_soil_resis = np.zeros(Na)
        self.av_soil_T = np.zeros(Na)
        self.av_gbv = np.zeros((Na, ns))
        self.av_leaf_T = np.zeros((Na, ns))
        self.av_leaf_T_prev = np.zeros((Na, ns))
        self.av_leaf_gs = np.zeros((Na, ns))
        self.av_leaf_fwet = np.zeros((Na, ns))
        self.av_leaf_fdry = np.zeros((Na, ns))
        self.av_leaf_fssh = np.zeros((Na, ns))
        self.av_leaf_dpai = np.zeros((Na, ns))
        self.av_leaf_trans_flux = np.zeros((Na, ns))
        self.av_leaf_lh = np.zeros((Na, ns))
        self.av_conn_ga = np.zeros(Na - ncair)
        self.av_bc_ga = np.zeros(ncair)
        self.av_bc_q = np.zeros(ncair)
        self.av_bc_pref = np.zeros(ncair)

        # --- leaf temperature GEs (sun, shd) (CanopyLeafTemperatureAuxType)
        def leaf_ge():
            return {name: np.zeros(Nl) for name in
                    ("T", "T_prev", "air_T", "qcanopy", "pref", "cpair",
                     "gbh", "gbv", "gs", "rn", "heat_storage", "cp",
                     "fssh", "dpai", "fwet", "fdry")}
        self.leaf = [leaf_ge(), leaf_ge()]   # rank 1 = sun, rank 2 = shd

        # internal connections of the air mesh: (k, k+1) per column
        iu, idn = [], []
        for icair in range(ncair):
            base = icair * self.nlev
            for k in range(self.nlev - 1):
                iu.append(base + k)
                idn.append(base + k + 1)
        self.conn_up = np.array(iu, np.int64)
        self.conn_dn = np.array(idn, np.int64)
        # first internal connection touching each soil cell
        # (GoveqnCanopyAirTemperatureType.F90:559-591 SoilAirIConn)
        self.soil_iconn = {icair * self.nlev: icair * (self.nlev - 1)
                           for icair in range(ncair)}
        # top boundary cells (mlc_conditions.F90:62-90)
        self.bc_cell = np.array([(icair + 1) * self.nlev - 1
                                 for icair in range(ncair)], np.int64)

        # solution vector
        self.n = 2 * Na + 2 * Nl
        self.off = (0, Na, 2 * Na, 2 * Na + Nl)
        self.soln = np.zeros(self.n)
        self.soln_prev = np.zeros(self.n)
        self._template = None
        self._ilu = None
        self.cumulative_linear_iterations = 0

    # ------------------------------------------------------------------
    def save_primary_independent_var(self) -> None:
        """soln -> GE primary auxvars (MlcSoePreSolve / PostSolve)."""
        o = self.off
        self.at_T[:] = self.soln[o[0]:o[0] + self.Na]
        self.av_q[:] = self.soln[o[1]:o[1] + self.Na]
        self.leaf[0]["T"][:] = self.soln[o[2]:o[2] + self.Nl]
        self.leaf[1]["T"][:] = self.soln[o[3]:o[3] + self.Nl]

    def exchange_auxvars(self) -> None:
        """Pairwise GE auxvar exchange (SystemOfEquationsMLCType.F90:
        216-330, 498-523).

        The reference's source-sized identity copies are reproduced,
        including the quirk that leaf-GE ``air_temperature``/``qcanopy``
        receive only the first Na entries by identity map (inert for the
        solve — leaf assembly does not read them).
        """
        Na = self.Na
        # air temp <- vapor (VAR_WATER_VAPOR), leaf temps (slot-mapped)
        self.at_qair[:] = self.av_q
        # vapor <- air temp (VAR_TEMPERATURE), leaf temps
        self.av_T[:] = self.at_T
        for r in (0, 1):
            vals = self.leaf[r]["T"]
            slots = self.leaf_slot + r * self.ntree
            self.at_leaf_T[self.leaf2cair, slots] = vals
            self.av_leaf_T[self.leaf2cair, slots] = vals
            # leaf <- air temp / vapor: identity copy of first min(Nl,Na)
            self.leaf[r]["air_T"][:Na] = self.at_T[:Na]
            self.leaf[r]["qcanopy"][:Na] = self.av_q[:Na]

    def get_from_soe_auxvars_cturb(self) -> None:
        """Stage turbulence-derived state into the GEs
        (CAirTempGetFromSoeAuxVarsCtrub :285-338 and vapor/leaf analogs)."""
        ct = self.cturb
        nlev = self.nlev
        for icair in range(self.ncair):
            sl = slice(icair * nlev, (icair + 1) * nlev)
            self.at_cpair[sl] = ct.cpair[icair]
            self.at_rhomol[sl] = ct.rhomol[icair]
            self.at_pref[sl] = ct.pref[icair]
            self.av_cpair[sl] = ct.cpair[icair]
            self.av_rhomol[sl] = ct.rhomol[icair]
            self.av_pref[sl] = ct.pref[icair]
            soil = icair * nlev
            for pre in ("at", "av"):
                getattr(self, pre + "_soil_rhg")[soil] = ct.soil_rhg[icair]
                getattr(self, pre + "_soil_rn")[soil] = ct.soil_rn[icair]
                getattr(self, pre + "_soil_tk")[soil] = ct.soil_tk[icair]
                getattr(self, pre + "_soil_dz")[soil] = ct.soil_dz[icair]
                getattr(self, pre + "_soil_resis")[soil] = ct.soil_res[icair]
                getattr(self, pre + "_soil_T")[soil] = \
                    ct.soil_temperature[icair]
            csl = slice(icair * (nlev - 1), (icair + 1) * (nlev - 1))
            self.at_conn_ga[csl] = ct.ga_prof[icair, :nlev - 1]
            self.av_conn_ga[csl] = ct.ga_prof[icair, :nlev - 1]
            self.at_bc_ga[icair] = ct.ga_prof[icair, nlev - 1]
            self.at_bc_T[icair] = ct.thref[icair]
            self.av_bc_ga[icair] = ct.ga_prof[icair, nlev - 1]
            self.av_bc_pref[icair] = ct.pref[icair]
            self.av_bc_q[icair] = ct.eref[icair] / ct.pref[icair]
        # leaf GEs: uniform cpair/pref (last column wins, as in
        # CLeafTempGetFromSoeAuxVarsCturb :188-210)
        for ge in self.leaf:
            ge["cpair"][:] = ct.cpair[self.ncair - 1]
            ge["pref"][:] = ct.pref[self.ncair - 1]

    def pre_solve(self) -> None:
        """MlcSoePreSolve (SystemOfEquationsMLCType.F90:79-137)."""
        self.save_primary_independent_var()
        self.exchange_auxvars()
        obukhov_length(self.cturb)
        wind_profile(self.cturb)
        aerodynamic_conductances(self.cturb)
        self.get_from_soe_auxvars_cturb()
        # per-GE PreSolve: stash previous-step copies
        self.at_T_prev[:] = self.at_T
        self.av_q_prev[:] = self.av_q
        self.av_leaf_T_prev[:] = self.av_leaf_T
        for ge in self.leaf:
            ge["T_prev"][:] = ge["T"]

    # ------------------------------------------------------------------
    def _soil_coeffs(self, i: int):
        """gs0 / gamma0 / alpha0 / beta0 / delta0 for soil-air cell ``i``
        (GoveqnCanopyAirTemperatureType.F90:594-730)."""
        iconn = self.soil_iconn[i]
        ga = self.at_conn_ga[iconn]
        gsw = 1.0 / self.at_soil_resis[i] * self.at_rhomol[i]
        gs0 = gsw * ga / (gsw + ga)
        esat0, desat0 = satvap_np(self.at_T[i])
        qsat0 = esat0 / self.at_pref[i]
        dqsat0 = desat0 / self.at_pref[i]
        rhg = self.at_soil_rhg[i]
        gamma0 = (self.at_cpair[i] * ga + LAMBDA * rhg * gs0 * dqsat0
                  + self.at_soil_tk[i] / self.at_soil_dz[i])
        alpha0 = self.at_cpair[i] * ga / gamma0
        beta0 = LAMBDA * gs0 / gamma0
        delta0 = (self.at_soil_rn[i]
                  - LAMBDA * rhg * gs0 * (qsat0 - dqsat0 * self.at_T[i])
                  + self.at_soil_tk[i] / self.at_soil_dz[i]
                  * self.at_soil_T[i]) / gamma0
        return iconn, ga, gs0, qsat0, dqsat0, alpha0, beta0, delta0

    def _leaf_gleaf_et(self, ge: dict, i: int):
        """gleaf_et of a leaf cell (GoveqnCanopyLeafTemperatureType.F90:
        402-420): series stomatal/boundary conductance, dry/wet split."""
        gleaf = ge["gs"][i] * ge["gbv"][i] / (ge["gs"][i] + ge["gbv"][i])
        return gleaf * ge["fdry"][i] + ge["gbv"][i] * ge["fwet"][i]

    def compute_rhs(self) -> np.ndarray:
        """MlcSoeComputeRhs + per-GE ComputeRhs (Bonan formulation)."""
        self.exchange_auxvars()
        o = self.off
        b = np.zeros(self.n)
        dt = self.dtime

        # --- air temperature GE (CAirTempRhsAccumulation :733-788,
        #     CAirTempRhsDivergence :791-850)
        bt = b[o[0]:o[0] + self.Na]
        for i in range(self.Na):
            if self.at_is_soil[i]:
                iconn, ga, *_rest = self._soil_coeffs(i)
                delta0 = _rest[-1]
                bt[i] = delta0
                bt[i + 1] += delta0 * ga
            else:
                bt[i] += (self.at_rhomol[i] / dt * self.at_T[i]
                          * self._vol_air[i])
        for c, cell in enumerate(self.bc_cell):
            bt[cell] += self.at_bc_ga[c] * self.at_bc_T[c]

        # --- air vapor GE (CAirVaporComputeRhsAccumulation :742-841,
        #     CAirVaporRhsDivergence :844-905)
        bq = b[o[1]:o[1] + self.Na]
        for i in range(self.Na):
            if self.av_is_soil[i]:
                iconn = self.soil_iconn[i]
                esat0, desat0 = satvap_np(self.av_T[i])
                qsat0 = esat0 / self.av_pref[i]
                dqsat0 = desat0 / self.av_pref[i]
                gs0, delta0 = self._vapor_soil_gs0_delta0(i, iconn)
                bq[i] = self.av_q[i]
                bq[i + 1] += gs0 * self.av_soil_rhg[i] * (
                    qsat0 + dqsat0 * (delta0 - self.av_T[i]))
            else:
                bq[i] += (self.av_rhomol[i] / dt * self.av_q[i]
                          * self._vol_air[i])
                for l in range(self.nleaf_slots):
                    if self.av_leaf_dpai[i, l] > 0.0:
                        esat, desat = satvap_np(self.av_leaf_T[i, l])
                        qsat = esat / self.av_pref[i]
                        dqsat = desat / self.av_pref[i]
                        gleaf = (self.av_leaf_gs[i, l] * self.av_gbv[i, l]
                                 / (self.av_leaf_gs[i, l]
                                    + self.av_gbv[i, l]))
                        gleaf_et = (gleaf * self.av_leaf_fdry[i, l]
                                    + self.av_gbv[i, l]
                                    * self.av_leaf_fwet[i, l])
                        gleaf_et *= (self.av_leaf_fssh[i, l]
                                     * self.av_leaf_dpai[i, l])
                        bq[i] += gleaf_et * (
                            qsat - dqsat * self.av_leaf_T[i, l])
        for c, cell in enumerate(self.bc_cell):
            bq[cell] += self.av_bc_ga[c] * self.av_bc_q[c]

        # --- leaf temperature GEs (CLeafTempComputeRHS :387-441)
        for r in (0, 1):
            ge = self.leaf[r]
            bl = b[o[2 + r]:o[2 + r] + self.Nl]
            for i in range(self.Nl):
                if ge["dpai"][i] > 0.0:
                    esat, desat = satvap_np(ge["T"][i])
                    qsat = esat / ge["pref"][i]
                    dqsat = desat / ge["pref"][i]
                    gleaf_et = self._leaf_gleaf_et(ge, i)
                    bl[i] = (ge["rn"][i]
                             + ge["cp"][i] / dt * ge["T"][i]
                             - LAMBDA * (qsat - dqsat * ge["T"][i])
                             * gleaf_et)
        return b

    def _vapor_soil_gs0_delta0(self, i: int, iconn: int):
        """Vapor-GE gs0/delta0 at a soil cell (GoveqnCanopyAirVaporType.
        F90:565-740); identical formulas to the temperature GE but reading
        the vapor GE's staged auxvars."""
        ga = self.av_conn_ga[iconn]
        gsw = 1.0 / self.av_soil_resis[i] * self.av_rhomol[i]
        gs0 = gsw * ga / (gsw + ga)
        esat0, desat0 = satvap_np(self.av_T[i])
        qsat0 = esat0 / self.av_pref[i]
        dqsat0 = desat0 / self.av_pref[i]
        rhg = self.av_soil_rhg[i]
        gamma0 = (self.av_cpair[i] * ga + LAMBDA * rhg * gs0 * dqsat0
                  + self.av_soil_tk[i] / self.av_soil_dz[i])
        delta0 = (self.av_soil_rn[i]
                  - LAMBDA * rhg * gs0 * (qsat0 - dqsat0 * self.av_T[i])
                  + self.av_soil_tk[i] / self.av_soil_dz[i]
                  * self.av_soil_T[i]) / gamma0
        return gs0, delta0

    def _vapor_soil_alpha_beta(self, i: int, iconn: int):
        ga = self.av_conn_ga[iconn]
        gsw = 1.0 / self.av_soil_resis[i] * self.av_rhomol[i]
        gs0 = gsw * ga / (gsw + ga)
        esat0, desat0 = satvap_np(self.av_T[i])
        dqsat0 = desat0 / self.av_pref[i]
        rhg = self.av_soil_rhg[i]
        gamma0 = (self.av_cpair[i] * ga + LAMBDA * rhg * gs0 * dqsat0
                  + self.av_soil_tk[i] / self.av_soil_dz[i])
        alpha0 = self.av_cpair[i] * ga / gamma0
        beta0 = LAMBDA * gs0 / gamma0
        return gs0, dqsat0, alpha0, beta0

    def compute_operators(self):
        """MlcSoeComputeOperators: 4x4 block fill (:333-455) with the
        per-GE diag/off-diag assembly, Bonan formulation."""
        o = self.off
        rows, cols, vals = [], [], []

        def add(r, c, v):
            rows.append(r)
            cols.append(c)
            vals.append(v)

        dt = self.dtime

        # ===== air temperature diag (CAirTempComputeOperatorsDiag :854-1051)
        for i in range(self.Na):
            r = o[0] + i
            if self.at_is_soil[i]:
                iconn, ga, gs0, qsat0, dqsat0, alpha0, beta0, delta0 = \
                    self._soil_coeffs(i)
                add(r, o[0] + i, 1.0)
                add(r, o[0] + i + 1, -alpha0)
                add(o[0] + i + 1, o[0] + i + 1, -alpha0 * ga)
            else:
                add(r, o[0] + i, self.at_rhomol[i] / dt * self._vol_air[i])
                for l in range(self.nleaf_slots):
                    if self.at_leaf_dpai[i, l] > 0.0:
                        add(r, o[0] + i,
                            2.0 * self.at_gbh[i, l] * self.at_leaf_fssh[i, l]
                            * self.at_leaf_dpai[i, l])
        for j in range(self.conn_up.size):
            u, d = int(self.conn_up[j]), int(self.conn_dn[j])
            value = self.at_conn_ga[j]
            if not self.at_is_soil[u]:
                if not self.at_is_soil[d]:
                    add(o[0] + u, o[0] + d, -value)
                add(o[0] + u, o[0] + u, value)
            if not self.at_is_soil[d]:
                if not self.at_is_soil[u]:
                    add(o[0] + d, o[0] + u, -value)
                add(o[0] + d, o[0] + d, value)
        for c, cell in enumerate(self.bc_cell):
            add(o[0] + cell, o[0] + cell, self.at_bc_ga[c])

        # ===== air temperature off-diag (:1055-1161)
        # vs vapor
        for i in range(self.Na):
            if self.at_is_soil[i]:
                iconn, ga, gs0, qsat0, dqsat0, alpha0, beta0, delta0 = \
                    self._soil_coeffs(i)
                add(o[0] + i, o[1] + i + 1, -beta0)
                add(o[0] + i + 1, o[1] + i + 1, -beta0 * ga)
        # vs leaf GEs
        for r in (0, 1):
            for ileaf in range(self.Nl):
                cair = int(self.leaf2cair[ileaf])
                slot = int(self.leaf_slot[ileaf]) + r * self.ntree
                if self.at_leaf_dpai[cair, slot] > 0.0:
                    add(o[0] + cair, o[2 + r] + ileaf,
                        -2.0 * self.at_gbh[cair, r]
                        * self.at_leaf_fssh[cair, slot]
                        * self.at_leaf_dpai[cair, slot])

        # ===== air vapor diag (CAirVaporComputeOperatorsDiag :908-1113)
        for i in range(self.Na):
            r = o[1] + i
            if self.av_is_soil[i]:
                add(r, o[1] + i, 1.0)
                iconn = self.soil_iconn[i]
                gs0, dqsat0, alpha0v, beta0v = \
                    self._vapor_soil_alpha_beta(i, iconn)
                add(o[1] + i + 1, o[1] + i + 1,
                    -gs0 * dqsat0 * self.av_soil_rhg[i] * beta0v)
            else:
                add(r, o[1] + i, self.av_rhomol[i] / dt * self._vol_air[i])
                for l in range(self.nleaf_slots):
                    if self.av_leaf_dpai[i, l] > 0.0:
                        gleaf = (self.av_leaf_gs[i, l] * self.av_gbv[i, l]
                                 / (self.av_leaf_gs[i, l]
                                    + self.av_gbv[i, l]))
                        gleaf_et = (gleaf * self.av_leaf_fdry[i, l]
                                    + self.av_gbv[i, l]
                                    * self.av_leaf_fwet[i, l])
                        gleaf_et *= (self.av_leaf_fssh[i, l]
                                     * self.av_leaf_dpai[i, l])
                        add(r, o[1] + i, gleaf_et)
        for j in range(self.conn_up.size):
            u, d = int(self.conn_up[j]), int(self.conn_dn[j])
            if self.av_is_soil[u] or self.av_is_soil[d]:
                cell = u if self.av_is_soil[u] else d
                ga = self.av_conn_ga[j]
                gsw = 1.0 / self.av_soil_resis[cell] * self.av_rhomol[cell]
                value = gsw * ga / (gsw + ga)
            else:
                value = self.av_conn_ga[j]
            if not self.av_is_soil[u]:
                if not self.av_is_soil[d]:
                    add(o[1] + u, o[1] + d, -value)
                add(o[1] + u, o[1] + u, value)
            if not self.av_is_soil[d]:
                if not self.av_is_soil[u]:
                    add(o[1] + d, o[1] + u, -value)
                add(o[1] + d, o[1] + d, value)
        for c, cell in enumerate(self.bc_cell):
            add(o[1] + cell, o[1] + cell, self.av_bc_ga[c])

        # ===== air vapor off-diag (:1117-1263)
        # vs air temperature
        for i in range(self.Na):
            if self.av_is_soil[i]:
                add(o[1] + i, o[0] + i, 0.0)   # explicit-zero pattern slot
                iconn = self.soil_iconn[i]
                gs0, dqsat0, alpha0v, beta0v = \
                    self._vapor_soil_alpha_beta(i, iconn)
                add(o[1] + i + 1, o[0] + i + 1,
                    -self.av_soil_rhg[i] * dqsat0 * gs0 * alpha0v)
        # vs leaf GEs
        for r in (0, 1):
            for ileaf in range(self.Nl):
                cair = int(self.leaf2cair[ileaf])
                slot = int(self.leaf_slot[ileaf]) + r * self.ntree
                if self.av_leaf_dpai[cair, slot] > 0.0:
                    esat, desat = satvap_np(self.av_leaf_T[cair, slot])
                    dqsat = desat / self.av_pref[cair]
                    gbv = self.av_gbv[cair, r]
                    gleaf = (self.av_leaf_gs[cair, slot] * gbv
                             / (self.av_leaf_gs[cair, slot] + gbv))
                    gleaf_et = (gleaf * self.av_leaf_fdry[cair, slot]
                                + gbv * self.av_leaf_fwet[cair, slot])
                    gleaf_et *= (self.av_leaf_fssh[cair, slot]
                                 * self.av_leaf_dpai[cair, slot])
                    add(o[1] + cair, o[2 + r] + ileaf, -dqsat * gleaf_et)

        # ===== leaf temperature GEs (CLeafTempComputeOperatorsDiag
        # :444-520, OffDiag :523-580)
        for r in (0, 1):
            ge = self.leaf[r]
            for i in range(self.Nl):
                row = o[2 + r] + i
                if ge["dpai"][i] > 0.0:
                    esat, desat = satvap_np(ge["T"][i])
                    dqsat = desat / ge["pref"][i]
                    gleaf_et = self._leaf_gleaf_et(ge, i)
                    add(row, row,
                        ge["cp"][i] / dt
                        + 2.0 * ge["cpair"][i] * ge["gbh"][i]
                        + LAMBDA * dqsat * gleaf_et)
                    cair = int(self.leaf2cair[i])
                    add(row, o[0] + cair,
                        -2.0 * ge["cpair"][i] * ge["gbh"][i])
                    add(row, o[1] + cair, -LAMBDA * gleaf_et)
                else:
                    add(row, row, 1.0)
        return (np.asarray(rows, np.int64), np.asarray(cols, np.int64),
                np.asarray(vals, np.float64))

    # ------------------------------------------------------------------
    def step_dt(self, dt: float, nstep: int = 1):
        """Step through the SoE surface (metrics-aware)."""
        return self.soe.step_dt(dt, nstep)

    def _step_dt_impl(self, dt: float):
        """One KSP step (SOEBaseStepDT_KSP, SystemOfEquationsBaseType.F90:
        555-647): presolve, RHS, operators, GMRES+ILU(0), postsolve."""
        self.dtime = dt
        self._vol_air = self._compute_vol_air()
        self.pre_solve()
        b = self.compute_rhs()
        rows, cols, vals = self.compute_operators()
        if self._template is None:
            self._template = csr_template(self.n, self.n, rows, cols)
            self._ilu = ILU0(self._template.indptr, self._template.indices)
        data = np.zeros(self._template.nnz)
        np.add.at(data, self._template.slots, vals)
        f64 = dict(dtype=torch.float64, device=self.device)
        data = torch.as_tensor(data, **f64)
        lu = self._ilu.factor(data)
        x, iters, conv = petsc_gmres(self._template.indptr,
                                     self._template.indices, data,
                                     torch.as_tensor(b, **f64),
                                     pc=self._ilu, pc_data=lu,
                                     sync=self._sync)
        self.cumulative_linear_iterations += iters
        self.soln_prev[:] = self.soln
        self.soln[:] = x.cpu().numpy()
        self.host_syncs += 1
        self.post_solve()
        return bool(conv), iters

    def _sync(self, value):
        """Read a device predicate on the host (one counted sync)."""
        self.host_syncs += 1
        return bool(value.item())

    def _compute_vol_air(self) -> np.ndarray:
        """Cell volumes of the canopy-air mesh (dx=dy=1, dz=z_cair/nz;
        mlc_meshes.F90:85-100)."""
        return np.full(self.Na, self.dz_cair)

    def post_solve(self) -> None:
        """MlcSoePostSolve (:458-495) + per-auxvar PostSolve fluxes."""
        self.save_primary_independent_var()
        self.exchange_auxvars()
        # leaf sensible heat (CanopyAirTemperatureAuxType.F90:119-136)
        mask = self.at_leaf_dpai > 0.0
        self.at_leaf_sh_flux[mask] = (
            2.0 * self.at_cpair[:, None] * self.at_gbh
            * (self.at_leaf_T - self.at_T[:, None]))[mask]
        # leaf transpiration (CanopyAirVaporAuxType.F90:126-165)
        esat, desat = satvap_np(self.av_leaf_T_prev)
        qsat = esat / self.av_pref[:, None]
        dqsat = desat / self.av_pref[:, None]
        denom = self.av_leaf_gs + self.av_gbv
        gleaf = (self.av_leaf_gs * self.av_gbv
                 / np.where(denom == 0.0, 1.0, denom))
        gleaf_et = gleaf * self.av_leaf_fdry + self.av_gbv * self.av_leaf_fwet
        delta = (qsat + dqsat * (self.av_leaf_T - self.av_leaf_T_prev)
                 - self.av_q[:, None])
        mask_v = self.av_leaf_dpai > 0.0
        self.av_leaf_trans_flux[mask_v] = (gleaf_et * delta)[mask_v]
        self.av_leaf_lh[mask_v] = self.av_leaf_trans_flux[mask_v]
        # leaf heat storage (CanopyLeafTemperatureAuxType.F90:91-103)
        for ge in self.leaf:
            ge["heat_storage"][:] = (ge["T"] - ge["T_prev"]) * ge["cp"]

"""Compiled batched TH: the coupled Richards-mass + enthalpy-energy Newton.

Counterpart of ``CompiledTH`` / ``compile_th`` in
``mpp_tpu/batched/th_compiled.py``.  A problem built through the
``THMPP`` facade (``soe/SystemOfEquationsTHType.F90:736-1005``) is frozen
into a batched stepper over ``ncol`` independent columns, with X
``[ncol, 2n]`` = [P-block; T-block] per column:

* the 2x2 block Jacobian (J11 = dF_m/dP, J12 = dF_m/dT, J21 = dF_e/dP,
  J22 = dF_e/dT) assembled from the same GE code as
  ``models/thermal_enthalpy.py``, the pairwise auxvar exchange (the mass GE
  receives T, the energy GE P) as argument passing;
* the Newton, BT line search, dt-cut ladder and straggler compaction of
  ``batched/vsfm_compiled.CompiledVSFM``, through its three plan hooks;
* the "direct" plan: interleaving the unknowns per cell, [P_0, T_0, P_1,
  T_1, ...], turns the Jacobian into a block-tridiagonal system of 2x2
  blocks (every TH coupling is a nearest-neighbour two-point flux), solved
  exactly by the ``block_thomas2`` CUDA kernel (``ops/hopper_kernels.py``);
  J Y for the initial slope is the ELL SpMV on the CSR data.

The default ``linear_solver="petsc"`` (the reference's ILU(0)+GMRES(30),
golden-trajectory parity) is not ported yet and raises (ROADMAP Slice D):
pass ``linear_solver="direct"``.  ``CompiledThermalEnthalpy`` moves to
Slice D as well.  f32 runs take the f32 parameter set of the JAX package
(rtol 2e-4); production f32 callers pass ``rtol=2e-3, stol=1e-5`` to
``step_batched``, above the f32 energy-residual evaluation floor
(KNOWN_GAPS #13).
"""
from __future__ import annotations

import numpy as np
import torch

from mpp_tpu_torch.batched.ilu_gmres import make_ell_matvec
from mpp_tpu_torch.device import device_of
from mpp_tpu_torch.batched.vsfm_compiled import (CompiledVSFM, SNESParams,
                                                 _rows)
from mpp_tpu_torch.models.richards import _swhere
from mpp_tpu_torch.models.thermal_enthalpy import richards_offdiag_t_values
from mpp_tpu_torch.ops import hopper_kernels as hk


class CompiledTH(CompiledVSFM):
    """A facade-built TH problem frozen into a batched stepper.

    Serial drop-in (ncol=1)::

        comp = compile_th(mpp, linear_solver="direct").install()
        converged, reason = mpp.soe.step_dt(dt, istep)

    Batched: ``step_batched(X, bc_values, ss_values, dt, dyn=...)`` with
    bc/ss tuples per GE (mass, energy) and ``dyn = (dyn_mass, dyn_energy)``
    carrying the staged cross-data ``dyn_mass["bc_temperature"]`` [ncol,
    nbc_m] and ``dyn_energy["bc_pressure"]`` [ncol, nbc_e]
    (mass_and_heat_model_problem.F90:556-652); :meth:`_serial_dyn` gives
    the staged values.
    """

    def __init__(self, mpp, snes: SNESParams = None, max_cuts: int = 20,
                 linear_solver: str = "petsc"):
        if linear_solver not in ("petsc", "direct"):
            raise ValueError(linear_solver)
        if linear_solver == "petsc":
            raise NotImplementedError(
                'linear_solver="petsc" (the batched ILU(0)+GMRES replica of '
                "the reference's inner solve) is not ported yet (ROADMAP "
                'Slice D); use linear_solver="direct"')
        self.linear_solver = linear_solver
        self.mpp = mpp
        soe = mpp.soe
        if soe.template is None:
            soe.setup()
        self.ge_mass = soe.ge_mass
        self.ge_energy = soe.ge_energy
        self.goveqns = [self.ge_mass, self.ge_energy]
        if self.ge_mass.mesh.ncells_all != self.ge_mass.mesh.ncells_local:
            raise NotImplementedError("ghost cells in compiled TH")
        for g in self.goveqns:
            g.invalidate()           # set-up is frozen here
        self.nh = soe.n                    # cells per GE
        self.n = 2 * soe.n                 # system size [P; T]
        self.offsets = [0, self.nh, self.n]
        self.template = soe.template
        self.snes = snes or SNESParams(stol=soe.snes_stol)
        self.snes_f32 = SNESParams(rtol=2e-4, atol=1e-8, stol=1e-6,
                                   ls_steptol=1e-8,
                                   ksp_rtol=self.snes.ksp_rtol)
        self.max_cuts = max_cuts
        self.compact_frac = 8
        self._ls_fused = False        # TH has no fused residual+Jacobian
        self.host_syncs = 0
        # no COND_DIRICHLET_FRM_OTR_GOVEQ coupling in the TH SoE: the
        # inter-GE coupling is the internal-auxvar exchange
        self._otr_slots = [np.zeros(0, np.int64)] * 2
        self._otr_src = [np.zeros(0, np.int64)] * 2
        self._tc = {}
        self._plan_solver()

    # ---- interleaved 2x2 block-tridiagonal plan ----------------------------
    def _plan_solver(self):
        """The CSR slot of each (band B, level i, row slot a, column slot b)
        block entry, with a mask of the entries that exist (absent ones
        gather slot 0 and are masked to zero).  The template orders the
        unknowns [P-block; T-block] (the reference's DMComposite layout);
        level = index % nh, slot = index // nh."""
        t = self.template
        self._ell = make_ell_matvec(t.indptr, t.indices)
        nh = self.nh
        rows = t.row_ids().astype(np.int64)
        cols = t.indices.astype(np.int64)
        band = cols % nh - rows % nh
        if np.abs(band).max(initial=0) > 1:
            raise NotImplementedError(
                "TH couplings beyond nearest-neighbour cells: the dense-LU "
                "and ILU(0)+GMRES plans are not ported yet (ROADMAP Slice D)")
        slots = np.zeros((3, nh, 2, 2), np.int64)
        mask = np.zeros((3, nh, 2, 2), bool)
        s = np.arange(rows.size)
        idx = (band + 1, rows % nh, rows // nh, cols // nh)
        slots[idx] = s
        mask[idx] = True
        self._blk_slots = slots.reshape(-1)
        self._blk_mask = mask.reshape(-1)

    def _jac(self, X, bc_values, ss_values, dt, dyn):
        """2x2 block Jacobian as CSR data [ncol, nnz], contributions in
        the template order [J11, J12, J21, J22]
        (SystemOfEquationsTHType.F90:853-1005)."""
        P, T = X[:, :self.nh], X[:, self.nh:]
        bcp = dyn[1].get("bc_pressure")
        v1 = self.ge_mass.jacobian_values(
            P, dt, bc_value=bc_values[0], ss_value=ss_values[0],
            dyn=self._dyn_mass(dyn, T))
        v12 = richards_offdiag_t_values(self.ge_mass, P, T, dt)
        v21 = self.ge_energy.offdiag_p_values(T, P, dt,
                                              bc_value=bc_values[1],
                                              bc_pressure=bcp)
        v2 = self.ge_energy.jacobian_e_values(T, P, dt,
                                              bc_value=bc_values[1],
                                              bc_pressure=bcp)
        v = torch.cat([v1, v12, v21, v2], dim=1)
        slots = self._const("csr_slots", X, lambda: self.template.slots)
        return v.new_zeros((v.shape[0], self.template.nnz)) \
            .index_add_(1, slots, v)

    def _solve(self, data, F):
        """Newton direction Y with J Y = F: gather the interleaved blocks
        and run the block-Thomas kernel."""
        ncol, nh = F.shape[0], self.nh
        slots = self._const("blk_slots", data, lambda: self._blk_slots)
        mask = self._const("blk_mask", data, lambda: self._blk_mask,
                           torch.bool)
        blk = torch.where(mask, data[:, slots], 0.0) \
            .reshape(ncol, 3, nh, 2, 2)
        b = torch.stack([F[:, :nh], F[:, nh:]], dim=-1)
        x = hk.block_thomas2(blk[:, 0].contiguous(), blk[:, 1].contiguous(),
                             blk[:, 2].contiguous(), b)
        return torch.cat([x[..., 0], x[..., 1]], dim=-1)

    def _matvec(self, data, x):
        """J x on the CSR data (the ELL SpMV), for the BT initial slope."""
        return self._ell(data, x)

    # ---- batched evaluation (the TH exchange) ------------------------------
    def _dyn_mass(self, dyn, T):
        """Mass-GE dyn dict with the exchanged internal temperature
        (SOETHGovEqnExchangeAuxVars: the mass GE receives T)."""
        d = dict(dyn[0])
        d["temperature"] = T
        return d

    def _residual(self, X, bc_values, ss_values, accum_prevs, dt, src, dyn):
        P, T = X[:, :self.nh], X[:, self.nh:]
        F1 = self.ge_mass.residual(
            P, dt, bc_value=bc_values[0], ss_value=ss_values[0],
            accum_prev=accum_prevs[0], dyn=self._dyn_mass(dyn, T))
        F2 = self.ge_energy.residual_e(
            T, P, dt, bc_value=bc_values[1], ss_value=ss_values[1],
            accum_prev=accum_prevs[1],
            bc_pressure=dyn[1].get("bc_pressure"))
        return torch.cat([F1, F2], dim=1) - src

    def _mass_accum(self, X, dyn):
        P, T = X[:, :self.nh], X[:, self.nh:]
        acc = self.ge_mass.accum(P, dyn=self._dyn_mass(dyn, T))
        return _swhere(self.ge_mass._active(), acc, torch.zeros_like(acc))

    def _accum_prev(self, X, dt, dyn):
        P, T = X[:, :self.nh], X[:, self.nh:]
        ae = self.ge_energy.accum_e(T, P) / dt
        return (self._mass_accum(X, dyn) / dt,
                _swhere(self.ge_energy._active(), ae, torch.zeros_like(ae)))

    # ---- audit: TH water storage lives in the mass GE only -----------------
    def column_storage(self, X, dyn=None):
        """Water storage per column [kmol] (X [ncol, 2n])."""
        return torch.sum(self._mass_accum(X, self._dyn_or_empty(dyn)), dim=1)

    def column_bc_flux(self, X, bc_values, dyn=None):
        raise NotImplementedError("TH BC flux audit")

    # ---- inputs ------------------------------------------------------------
    def _serial_dyn(self, ncol, device="cuda", dtype=torch.float64):
        """The staged cross-data (mass-GE BC temperature, energy-GE BC
        pressure) as the ``dyn`` of ``ncol`` columns, on the card unless
        ``device="cpu"``."""
        device = device_of(device)
        return ({"bc_temperature": _rows(self.ge_mass.bc_temperature, ncol,
                                         device, dtype)},
                {"bc_pressure": _rows(self.ge_energy.bc_pressure, ncol,
                                      device, dtype)})

    @staticmethod
    def inputs_from_numpy(X, bc, ss, dyn, device, dtype):
        """The JAX stepper's inputs (X [ncol, 2n], the per-GE bc/ss tuples
        and the two dyn dicts, as numpy or anything ``np.array`` takes) as
        the port's tensors: returns (X, bc, ss, dyn)."""
        t = lambda a: torch.as_tensor(np.array(a), dtype=dtype,
                                      device=device)
        return (t(X), tuple(t(b) for b in bc), tuple(t(s) for s in ss),
                tuple({k: t(v) for k, v in d.items()} for d in dyn))

    def step_dt(self, dt, istep=1):
        """Drop-in for ``soe.step_dt``: one f64 column on
        ``serial_device`` with the staged cross-data."""
        converged, reason = self._step_dt_serial(
            dt, istep, self._serial_dyn(1, self.serial_device))
        if converged:
            soln = self.mpp.soe.soln
            self.ge_mass.pressure = soln[:self.nh]
            self.ge_energy.temperature = soln[self.nh:]
        return converged, reason


def compile_th(mpp, **kw) -> CompiledTH:
    """Freeze a fully staged ``THMPP`` into a batched stepper."""
    return CompiledTH(mpp, **kw)

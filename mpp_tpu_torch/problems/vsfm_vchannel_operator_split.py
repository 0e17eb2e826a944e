"""V-channel gravity drainage with vertical/lateral operator splitting.

Counterpart of ``mpp_tpu/problems/vsfm_vchannel_operator_split.py``, which
reimplements ``src/driver/standalone/vsfm/vsfm_vchannel_problem_operator_split
.F90``: the same 20x10x30 tilted V-channel as ``vsfm_vchannel``, but solved by
two independent VSFM problems on the same mesh — one holding only the
*vertical* internal connections (plus the optional seepage BC), one holding
only the *lateral* (x/y-horizontal) connections.  Each timestep solves the
vertical problem implicitly, copies soln -> {soln, soln_prev, soln_prev_clm}
of the lateral problem (F90:104-115), solves the lateral problem, and copies
back.  The initial water-table head is 10 m below the reference datum rather
than 2 m (F90:1092).

This is the single-process analog of the distributed lateral-flow operator
split (SURVEY.md §2.8): on a sharded column mesh the "lateral" half becomes
the ghost-exchange + explicit-lateral-flux stage.

The steps run through the serial SNES of ``VSFMSoE.step_dt`` on
``device`` (the card unless ``device="cpu"``).
"""
from __future__ import annotations

import numpy as np

from mpp_tpu_torch import constants as C
from mpp_tpu_torch.constants import (Cond, ConnKind, GEType, MPPType, Var,
                                     AuxVarKind)
from mpp_tpu_torch.dtypes.mesh import ConnectionSet
from mpp_tpu_torch.batched.vsfm_compiled import vsfm_stepper
from mpp_tpu_torch.models.richards import VSFMMPP
from mpp_tpu_torch.ops import eos
from mpp_tpu_torch.io.regression import RegressionWriter
from mpp_tpu_torch.problems.vsfm_vchannel import (NX, NY, DX, DY, DZ,
                                                  _build_mesh)


def _split_mesh(nz, which):
    """Build the vchannel mesh keeping only vertical or lateral conns.

    The reference builds the full connection lists then registers the
    vertical block with ``vsfm_mpp_vertical`` (F90:418-423) and the
    horizontal blocks with ``vsfm_mpp_lateral`` (F90:842).
    """
    mesh = _build_mesh(nz)
    cs = mesh.intrn_conn_sets[0]
    nvert = NX * NY * (nz - 1)
    sl = slice(0, nvert) if which == "vertical" else slice(nvert, None)
    mesh.intrn_conn_sets = [ConnectionSet(
        id_up=cs.id_up[sl], id_dn=cs.id_dn[sl],
        dist_up=cs.dist_up[sl], dist_dn=cs.dist_dn[sl],
        area=cs.area[sl], itype=cs.itype[sl])]
    return mesh


def _make_mpp(nz, which, with_seepage_bc):
    mpp = VSFMMPP()
    mpp.set_name(f"Variably-Saturated-Flow-Model For V Channel "
                 f"{'1D' if which == 'vertical' else '2D'}")
    mpp.set_id(MPPType.VSFM_SNES_CLM)
    mpp.add_mesh(_split_mesh(nz, which))
    ieqn = mpp.add_goveqn(GEType.RE, "Richards Equation ODE")

    # Seepage BC only on the vertical problem (F90:965-967)
    if with_seepage_bc and which == "vertical":
        ids = np.arange(NX * NY * (nz - 1), NX * NY * nz, dtype=np.int32)
        m = ids.size
        uv = np.zeros((m, 3))
        uv[:, 2] = -1.0
        cs = ConnectionSet(id_up=np.full(m, -1, np.int32), id_dn=ids,
                           dist_up=np.zeros(m), dist_dn=np.full(m, 0.5 * DZ),
                           area=np.full(m, DX * DY),
                           itype=np.full(m, int(ConnKind.VERTICAL), np.int32),
                           unit_vec=uv)
        mpp.add_condition_in_goveqn(ieqn, Cond.BC,
                                    "Constant head condition at top", "Pa",
                                    Cond.SEEPAGE_BC, conn_set=cs)
    mpp.allocate_auxvars()
    mpp.setup_problem()

    porosity, lam, alpha, perm = 0.368, 0.5, 3.4257e-4, 8.3913e-12
    vish2o = 0.001002
    hksat = perm / vish2o * (C.DENH2O * C.GRAV_CLM) / 0.001
    ncol = NX * NY
    shape = (ncol, nz)
    mpp.set_soils(filter_vsfmc=np.ones(ncol, np.int64),
                  watsat=np.full(shape, porosity),
                  hksat=np.full(shape, hksat),
                  bsw=np.full(shape, 1.0 / lam),
                  sucsat=np.full(shape, 1.0 / (alpha * C.GRAV_CLM)),
                  residual_sat=np.full(shape, 0.2772),
                  satfunc_type="van_genuchten",
                  density_type=eos.DENSITY_TGDPB01)
    return mpp


def run_vsfm_vchannel_operator_split_problem(nz=30, dtime=8640.0, nstep=3,
                                             with_seepage_bc=False,
                                             device="cuda"):
    n = NX * NY * nz
    ncol = NX * NY
    vert = _make_mpp(nz, "vertical", with_seepage_bc)
    lat = _make_mpp(nz, "lateral", with_seepage_bc)
    vsfm_stepper(vert, False, device)
    vsfm_stepper(lat, False, device)

    # IC: water table 10 m below datum (F90:1092)
    press_ic = np.empty(n)
    icell = 0
    for jz in range(1, nz + 1):
        for c in range(ncol):
            press_ic[icell] = ((18.75 - 0.5 * (jz - 1) - 10.0)
                               * 997.18 * 9.8 + 101325.0)
            icell += 1
    vert.restart(press_ic)
    lat.restart(press_ic)

    for istep in range(1, nstep + 1):
        if with_seepage_bc:
            vert.set_data(AuxVarKind.BC, Var.BC_SS_CONDITION, 1,
                          np.full(ncol, 101325.0))
        converged, reason = vert.soe.step_dt(dtime, istep)
        assert converged, f"vertical step {istep} diverged (reason {reason})"
        # VecCopy soln -> lateral {soln, soln_prev, soln_prev_clm}
        # (F90:104-107)
        lat.restart(np.asarray(vert.soe.soln))
        converged, reason = lat.soe.step_dt(dtime, istep)
        assert converged, f"lateral step {istep} diverged (reason {reason})"
        vert.restart(np.asarray(lat.soe.soln))
    return vert, lat


def output_regression(lat, filename_base, num_cells):
    """Regression output comes from the lateral problem (F90:1157-1163)."""
    w = RegressionWriter(filename_base, num_cells)
    w.write_data("liquid_pressure", "pressure",
                 lat.get_data(AuxVarKind.INTERNAL, Var.PRESSURE))
    w.write_data("liquid_saturation", "general",
                 lat.get_data(AuxVarKind.INTERNAL, Var.LIQ_SAT))
    w.close()
    return w.filename

"""The MLC bridge of the PyTorch port (``batched/mlc.inputs_from_mpp``)
against the JAX package's, on the CPU in f64.

Both packages stage the MLC problem as tests/test_batched_mlc.py does
(one step of ``run_mlc_problem``, then ``pre_solve`` for the next);
every field of the port's ``MLCBlockInputs`` equals JAX's within 1e-12
relative on the same MPP state, and within 1e-12 of the field's largest
magnitude on each package's own.  Then, as the JAX package's own tests
(tests/test_batched_mlc.py:43,72) and over the same (ncair, ntree)
cases: the port's block assembly equals its serial CSR assembly entry
for entry (rtol 1e-12, atol 1e-12), the block-Thomas solution equals the
dense solve of the serial system (rtol 1e-9, atol 1e-11) and, within
GMRES's stopping tolerance (rtol 1e-5, atol 5e-3 K), the serial step.
"""
import copy

import numpy as np
import pytest
import torch

from mpp_tpu.batched import mlc as jbmlc
from mpp_tpu.problems.mlc import run_mlc_problem as jrun
from mpp_tpu_torch.batched import mlc as tbmlc
from mpp_tpu_torch.problems.mlc import run_mlc_problem as trun

DT = 5.0 * 60.0
CASES = [(1, 1), (2, 2)]


def _stage(mpp):
    """An MLC problem advanced one step, then re-staged for the next step
    (what step_dt does before assembling)."""
    mpp.dtime = DT
    mpp._vol_air = mpp._compute_vol_air()
    mpp.pre_solve()
    return mpp


def _block_to_global(mpp):
    """Permutation: block coordinate (icair, k, row) -> serial index."""
    nc, nlev, nt = mpp.ncair, mpp.nlev, mpp.ntree
    ns = 2 * nt
    o = mpp.off
    g = np.zeros((nc, nlev, 2 + ns), np.int64)
    for ic in range(nc):
        for k in range(nlev):
            g[ic, k, 0] = o[0] + ic * nlev + k
            g[ic, k, 1] = o[1] + ic * nlev + k
            for s in range(ns):
                r, it = divmod(s, nt)
                g[ic, k, 2 + s] = o[2 + r] + (ic * nt + it) * nlev + k
    return g


@pytest.mark.parametrize("ncair,ntree", CASES)
def test_inputs_match_jax(ncair, ntree):
    """JAX's bridge reads only the MPP's numpy state, which the port's
    MLCMPP holds under the same names: on the same staged port MPP the two
    bridges agree within rtol 1e-12; on each package's own staged MPP
    (one serial step apart in round-off) within 1e-12 of each field's
    largest magnitude."""
    tm = _stage(trun(ncair=ncair, ntree=ntree, device="cpu"))
    jm = _stage(jrun(ncair=ncair, ntree=ntree))
    ti = tbmlc.inputs_from_mpp(tm)
    assert ti._fields == jbmlc.MLCBlockInputs._fields
    for ji, exact in ((jbmlc.inputs_from_mpp(tm), True),
                      (jbmlc.inputs_from_mpp(jm), False)):
        for name, a, b in zip(ti._fields, ti, ji):
            assert isinstance(a, torch.Tensor) and a.dtype == torch.float64
            b = np.asarray(b)
            assert tuple(a.shape) == b.shape, name
            atol = 0.0 if exact else 1e-12 * float(np.abs(b).max())
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-12, atol=atol,
                                       err_msg=name)
    assert ti.at_T.device == tm.device
    assert tbmlc.inputs_from_mpp(tm, device="meta").at_T.is_meta


def _serial_system(mpp):
    rows, cols, vals = mpp.compute_operators()
    A = np.zeros((mpp.n, mpp.n))
    np.add.at(A, (rows, cols), vals)
    return A, mpp.compute_rhs()


@pytest.mark.parametrize("ncair,ntree", CASES)
def test_block_assembly_matches_serial_csr(ncair, ntree):
    mpp = _stage(trun(ncair=ncair, ntree=ntree, device="cpu"))
    A_serial, b_serial = _serial_system(mpp)
    L, D, U, b = (a.numpy() for a in tbmlc.assemble(
        tbmlc.inputs_from_mpp(mpp), DT))
    g = _block_to_global(mpp)
    nc, nlev, _ = g.shape
    A_block = np.zeros_like(A_serial)
    bb = np.zeros(mpp.n)
    for ic in range(nc):
        for k in range(nlev):
            gi = g[ic, k]
            A_block[np.ix_(gi, gi)] += D[ic, k]
            if k > 0:
                A_block[np.ix_(gi, g[ic, k - 1])] += L[ic, k]
            if k < nlev - 1:
                A_block[np.ix_(gi, g[ic, k + 1])] += U[ic, k]
            bb[gi] = b[ic, k]
    np.testing.assert_allclose(A_block, A_serial, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(bb, b_serial, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("ncair,ntree", CASES)
def test_block_thomas_solution_matches_serial(ncair, ntree):
    mpp = _stage(trun(ncair=ncair, ntree=ntree, device="cpu"))
    x_blk = tbmlc.step(tbmlc.inputs_from_mpp(mpp), DT).numpy()
    A, b = _serial_system(mpp)
    x_exact = np.linalg.solve(A, b)
    g = _block_to_global(mpp)
    x_flat = np.zeros(mpp.n)
    x_flat[g.reshape(-1)] = x_blk.reshape(-1)
    np.testing.assert_allclose(x_flat, x_exact, rtol=1e-9, atol=1e-11)
    mpp2 = copy.deepcopy(mpp)
    mpp2.step_dt(DT)
    np.testing.assert_allclose(x_flat, mpp2.soln, rtol=1e-5, atol=5e-3)

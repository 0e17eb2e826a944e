"""Richards GE assembly of the PyTorch port (mpp_tpu_torch/models/
richards.py) against the JAX package, on batched states.

Two GEs: the celia1990 column (static van Genuchten soils, two Dirichlet
BCs) and the ALM template column (per-column heterogeneous CLM soils
through the ``dyn`` contract, TGDPB01 density, six mass-rate sinks and
the seepage BC).  The JAX one-column functions are vmapped over the
columns; the port evaluates the [ncol, n] batch directly.  f64, rtol
1e-11: the same formulas, with scatter sums in possibly another order.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from mpp_tpu.constants import PRESSURE_REF
from mpp_tpu.driver import alm as jalm
from mpp_tpu_torch import entry
from mpp_tpu_torch.driver import alm as talm

RTOL = 1e-11
NCOL = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small batches: torch's intra-op threads only add contention."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, atol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=atol)


def _states(n, seed):
    """[NCOL, n] pressures crossing PRESSURE_REF (saturated cells, and
    columns whose top cell is ponded or dry for the seepage clamp)."""
    rng = np.random.default_rng(seed)
    P = PRESSURE_REF + rng.uniform(-2.0e5, 4.0e4, (NCOL, n))
    P[0, -1] = PRESSURE_REF + 5e3
    P[1, -1] = PRESSURE_REF - 5e3
    return P


def _celia_pair(nz=16):
    ge_j = graft._build_compiled_celia(nz)[0].soe.goveqns[0]
    ge_t = entry.build_compiled_celia(nz)[0].soe.goveqns[0]
    return ge_j, ge_t


def _hetero_soil(ncol, nz, rng=None):
    rng = rng or np.random.default_rng(0)
    shape = (ncol, nz)
    return dict(watsat=0.35 + 0.1 * rng.random(shape),
                hksat=0.004 * (0.5 + rng.random(shape)),
                bsw=2.0 + 2.0 * rng.random(shape),
                sucsat=20.0 + 20.0 * rng.random(shape),
                residual_sat=0.10 + 0.1 * rng.random(shape),
                dz=np.full(shape, 0.1), area=1.0 + rng.random(ncol),
                include_seepage_bc=True)


def _alm_pair(ncol, nz, seed=0):
    rng = np.random.default_rng(seed)
    shape = (ncol, nz)
    soil = _hetero_soil(ncol, nz, rng)
    pj = jalm.alm_vsfm_initialize(**soil)
    pt = talm.alm_vsfm_initialize(device="cpu", **soil)
    T = 273.15 + 5.0 + 20.0 * rng.random(shape)
    fl = 0.5 + 0.5 * rng.random(shape)
    dj = dict(pj.dyn[0], temperature=jnp.asarray(T), frac_liq=jnp.asarray(fl))
    dt_ = dict(pt.dyn[0], temperature=torch.as_tensor(T),
               frac_liq=torch.as_tensor(fl))
    return pj.comp.goveqns[0], pt.comp.goveqns[0], dj, dt_


def _inputs(ge_j, seed):
    n = ge_j.mesh.ncells_local
    rng = np.random.default_rng(seed)
    nbc = ge_j.bc_value.shape[0]
    nss = ge_j.ss_value.shape[0]
    bc = PRESSURE_REF + rng.uniform(-9e4, 5e3, (NCOL, nbc))
    ss = rng.uniform(-1e-4, 1e-4, (NCOL, nss))
    ap = rng.uniform(0.0, 1e-3, (NCOL, n))
    return _states(n, seed), bc, ss, ap


CASES = ["celia", "alm"]


def _setup(case):
    if case == "celia":
        ge_j, ge_t = _celia_pair()
        dyn_j, dyn_t = {}, {}
    else:
        ge_j, ge_t, dyn_j, dyn_t = _alm_pair(NCOL, 12)
    P, bc, ss, ap = _inputs(ge_j, 7)
    return ge_j, ge_t, dyn_j, dyn_t, P, bc, ss, ap


def _jax_batched(fn, P, bc, ss, ap, dyn_j):
    axes = (0, 0, 0, 0, 0 if dyn_j else None)
    return jax.jit(jax.vmap(fn, in_axes=axes))(
        jnp.asarray(P), jnp.asarray(bc), jnp.asarray(ss), jnp.asarray(ap),
        dyn_j if dyn_j else None)


@pytest.mark.parametrize("case", CASES)
def test_residual(case):
    ge_j, ge_t, dyn_j, dyn_t, P, bc, ss, ap = _setup(case)
    dt = 1800.0
    ref = _jax_batched(lambda p, b, s, a, d: ge_j.residual(
        p, dt, bc_value=b, ss_value=s, accum_prev=a, dyn=d),
        P, bc, ss, ap, dyn_j)
    got = ge_t.residual(torch.as_tensor(P), dt, bc_value=torch.as_tensor(bc),
                        ss_value=torch.as_tensor(ss),
                        accum_prev=torch.as_tensor(ap), dyn=dyn_t)
    _close(got, ref, atol=1e-14 * float(np.abs(np.asarray(ref)).max()))


@pytest.mark.parametrize("case", CASES)
def test_jacobian_values(case):
    ge_j, ge_t, dyn_j, dyn_t, P, bc, ss, ap = _setup(case)
    dt = 1800.0
    ref = _jax_batched(lambda p, b, s, a, d: ge_j.jacobian_values(
        p, dt, bc_value=b, ss_value=s, dyn=d), P, bc, ss, ap, dyn_j)
    got = ge_t.jacobian_values(torch.as_tensor(P), dt,
                               bc_value=torch.as_tensor(bc),
                               ss_value=torch.as_tensor(ss), dyn=dyn_t)
    assert got.shape == ref.shape
    _close(got, ref)


@pytest.mark.parametrize("case", CASES)
def test_residual_and_jac_values(case):
    """The merged evaluation against JAX's, and bitwise equal to the
    port's two separate calls."""
    ge_j, ge_t, dyn_j, dyn_t, P, bc, ss, ap = _setup(case)
    dt = 900.0
    Fj, Vj = _jax_batched(lambda p, b, s, a, d: ge_j.residual_and_jac_values(
        p, dt, bc_value=b, ss_value=s, accum_prev=a, dyn=d),
        P, bc, ss, ap, dyn_j)
    args = dict(bc_value=torch.as_tensor(bc), ss_value=torch.as_tensor(ss),
                dyn=dyn_t)
    Pt, apt = torch.as_tensor(P), torch.as_tensor(ap)
    F, V = ge_t.residual_and_jac_values(Pt, dt, accum_prev=apt, **args)
    _close(F, Fj, atol=1e-14 * float(np.abs(np.asarray(Fj)).max()))
    _close(V, Vj)
    assert torch.equal(F, ge_t.residual(Pt, dt, accum_prev=apt, **args))
    assert torch.equal(V, ge_t.jacobian_values(Pt, dt, **args))


@pytest.mark.parametrize("case", CASES)
def test_accum_and_cell_aux(case):
    """Storage (accum) per cell, and the whole auxvar chain with the
    per-column dyn parameters."""
    ge_j, ge_t, dyn_j, dyn_t, P, bc, ss, ap = _setup(case)
    ref = jax.jit(jax.vmap(lambda p, d: ge_j.accum(p, dyn=d),
                           in_axes=(0, 0 if dyn_j else None)))(
        jnp.asarray(P), dyn_j if dyn_j else None)
    _close(ge_t.accum(torch.as_tensor(P), dyn=dyn_t), ref)
    if case == "alm":
        n = ge_j.mesh.ncells_local
        aux_j = jax.jit(jax.vmap(lambda p, d: ge_j._cell_aux(p, d)))(
            jnp.asarray(P), dyn_j)
        aux_t = ge_t._cell_aux(torch.as_tensor(P), dyn_t)
        for g, r in zip(aux_t, aux_j):
            _close(torch.broadcast_to(g, (NCOL, n)), r)


def test_per_column_dt():
    """A per-column dt [ncol, 1] (the dt-cut ladder's form) matches
    per-column JAX evaluations."""
    ge_j, ge_t, dyn_j, dyn_t, P, bc, ss, ap = _setup("alm")
    dts = np.array([1800.0, 900.0, 450.0, 225.0, 3600.0])
    ref = jax.jit(jax.vmap(lambda p, b, s, a, d, t: ge_j.residual(
        p, t, bc_value=b, ss_value=s, accum_prev=a, dyn=d)))(
        jnp.asarray(P), jnp.asarray(bc), jnp.asarray(ss), jnp.asarray(ap),
        dyn_j, jnp.asarray(dts[:, None]))
    got = ge_t.residual(torch.as_tensor(P), torch.as_tensor(dts[:, None]),
                        bc_value=torch.as_tensor(bc),
                        ss_value=torch.as_tensor(ss),
                        accum_prev=torch.as_tensor(ap), dyn=dyn_t)
    _close(got, ref, atol=1e-14 * float(np.abs(np.asarray(ref)).max()))


@pytest.mark.parametrize("case", CASES)
def test_csr_template_and_assembly(case):
    """The SoE's CSR template (sparsity + COO->CSR slot map) and the
    assembly of Jacobian values into it."""
    if case == "celia":
        soe_j = graft._build_compiled_celia(16)[0].soe
        soe_t = entry.build_compiled_celia(16)[0].soe
    else:
        soil = _hetero_soil(3, 9)
        soe_j = jalm.alm_vsfm_initialize(**soil).mpp.soe
        soe_t = talm.alm_vsfm_initialize(device="cpu", **soil).mpp.soe
    tj, tt = soe_j.template, soe_t.template
    for k in ("indptr", "indices", "slots"):
        np.testing.assert_array_equal(getattr(tt, k), getattr(tj, k))
    vals = np.random.default_rng(5).standard_normal((NCOL, tj.slots.size))
    ref = jax.vmap(tj.assemble)(jnp.asarray(vals))
    _close(tt.assemble(torch.as_tensor(vals)), ref)

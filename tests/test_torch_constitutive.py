"""Constitutive chain of the PyTorch port (mpp_tpu_torch/ops/{eos,satfunc,
porosity}.py) against the JAX package on the same numpy inputs.

Pressure sweeps cross PRESSURE_REF (the saturated switch) and, per cell,
the smoothed-Brooks-Corey switch points pu and ps.  Every CLM
saturation family, van Genuchten, and the xylem / relperm variants are
covered, alone and blended.  f64, rtol 1e-12: the same elementwise
formulas; only libm rounding of pow/exp can differ, by an ulp or so.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpp_tpu.constants import PRESSURE_REF
from mpp_tpu.ops import eos as jeos, porosity as jpor, satfunc as jsf
from mpp_tpu_torch.ops import eos as teos, porosity as tpor, satfunc as tsf

RTOL = 1e-12


def _close(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.broadcast_to(np.asarray(ref), got.shape)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0)


def _configure(sp, model, n):
    """Apply one model's setters (the same API in both packages)."""
    alpha = np.array([1e-4, 2.5e-4, 3.4257e-4, 5e-4])[:n]
    lam = np.array([0.25, 0.4, 0.5, 0.7])[:n]
    sr = np.array([0.1, 0.15, 0.2772, 0.05])[:n]
    for i in range(n):
        a, l_, s = float(alpha[i]), float(lam[i]), float(sr[i])
        m = model if model != "mixed" else (
            "van_genuchten", "sbc_bz3", "brooks_corey", "chuang")[i % 4]
        if m == "van_genuchten":
            sp.set_vg(i, s, a, l_)
        elif m == "brooks_corey":
            sp.set_bc(i, s, a, l_)
        elif m == "sbc_bz2":
            sp.set_sbc_bz2(i, s, a, l_, -0.9 / a)
        elif m == "sbc_bz3":
            sp.set_sbc_bz3(i, s, a, l_, -0.9 / a)
        elif m == "sbc":
            sp.set_sbc(i, s, a, l_, -0.9 / a, -3.0 / a)
        elif m == "fetch2":
            sp.set_fetch2(i, -3.0e6 * (1 + 0.1 * i), -2.0e6 * (1 + 0.1 * i))
        elif m == "chuang":
            sp.set_chuang(i, -1.0e6 * (1 + 0.1 * i), 2.0 + 0.5 * i)
        elif m == "weibull":
            sp.set_vg(i, s, a, l_)
            sp.set_weibull_relperm(i, 3.0e6 * (1 + 0.1 * i), 3.0 + i)
        elif m == "campbell":
            sp.set_bc(i, s, a, l_)
            sp.set_campbell_relperm(i, -1.0e3 * (1 + i), 5.0 + i)
        else:
            raise ValueError(m)
    return sp


MODELS = ["van_genuchten", "brooks_corey", "sbc_bz2", "sbc_bz3", "sbc",
          "fetch2", "chuang", "weibull", "campbell", "mixed"]
N = 4


def _pressures(sp_j):
    """[m, N] pressures: a capillary sweep across PRESSURE_REF plus, per
    cell, the SBC switch points pu/ps and their neighbourhoods."""
    pc = np.concatenate([-np.logspace(0, 7, 29), [-1e-3, 0.0, 1e-3, 1.0,
                                                  1e3, 1e4]])
    rows = [np.full(N, v) for v in pc]
    pu = np.asarray(sp_j.sbc_pu)
    ps = np.asarray(sp_j.sbc_ps)
    if np.any(pu != 0):
        for v in (pu, ps):
            rows += [v, v * (1 + 1e-9), v * (1 - 1e-9), 0.5 * (pu + ps)]
    return PRESSURE_REF + np.stack(rows)


def _pair(model):
    return (_configure(jsf.SatParams.zeros(N), model, N),
            _configure(tsf.SatParams.zeros(N), model, N))


@pytest.mark.parametrize("model", MODELS)
def test_press_to_sat_and_relperm(model):
    sp_j, sp_t = _pair(model)
    P = _pressures(sp_j)
    fl = np.linspace(0.3, 1.0, N) * np.ones_like(P)
    for ref, got in zip(jsf.press_to_sat(sp_j, jnp.asarray(P)),
                        tsf.press_to_sat(sp_t, torch.as_tensor(P))):
        _close(got, ref)
    for ref, got in zip(
            jsf.press_to_relperm(sp_j, jnp.asarray(P), jnp.asarray(fl)),
            tsf.press_to_relperm(sp_t, torch.as_tensor(P),
                                 torch.as_tensor(fl))):
        _close(got, ref)


@pytest.mark.parametrize("model", ["van_genuchten", "brooks_corey", "fetch2",
                                   "chuang"])
def test_sat_to_press(model):
    sp_j, sp_t = _pair(model)
    sat = np.linspace(0.3, 1.0, 15)[:, None] * np.ones(N)
    _close(tsf.sat_to_press(sp_t, torch.as_tensor(sat)),
           jsf.sat_to_press(sp_j, jnp.asarray(sat)))


@pytest.mark.parametrize("satfunc_type", list(tsf.CLM_SATFUNC_TYPES))
def test_satparams_dyn_clm_identical(satfunc_type):
    rng = np.random.default_rng(0)
    shape = (5, 7)
    sr = 0.1 + 0.1 * rng.random(shape)
    alpha = 1.0 / ((20 + 20 * rng.random(shape)) * 9.80616)
    lam = 1.0 / (2.0 + 2.0 * rng.random(shape))
    ref = jsf.satparams_dyn_clm(satfunc_type, sr, alpha, lam)
    got = tsf.satparams_dyn_clm(satfunc_type, sr, alpha, lam)
    assert sorted(ref) == sorted(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.mark.parametrize("density_type", [jeos.DENSITY_CONSTANT,
                                          jeos.DENSITY_TGDPB01,
                                          jeos.DENSITY_IFC67])
def test_density_and_viscosity(density_type):
    p = np.concatenate([np.linspace(2e4, 101325.0, 9),
                        np.linspace(101325.0, 1.5e7, 9), [101325.0 + 1e-6]])
    t = 273.15 + np.array([1.0, 10.0, 25.0, 60.0, 90.0])
    P, T = np.meshgrid(p, t, indexing="ij")
    ref = jeos.density(jnp.asarray(P), jnp.asarray(T), density_type)
    got = teos.density(torch.as_tensor(P), torch.as_tensor(T), density_type)
    for g, r in zip(got, ref):
        _close(g, r)
    for g, r in zip(teos.viscosity(torch.as_tensor(P), torch.as_tensor(T)),
                    jeos.viscosity(jnp.asarray(P), jnp.asarray(T))):
        _close(g, r)


def test_porosity_constant_and_linear():
    P = np.linspace(5e4, 3e5, 12)[:, None] * np.ones(3)
    base = np.array([0.3, 0.35, 0.45])
    for jp, tp in ((jpor.PorosityParams.constant(base),
                    tpor.PorosityParams.constant(base)),
                   (jpor.PorosityParams.linear(base, 101325.0, 1e-9),
                    tpor.PorosityParams.linear(base, 101325.0, 1e-9))):
        for g, r in zip(tpor.porosity(tp, torch.as_tensor(P)),
                        jpor.porosity(jp, jnp.asarray(P))):
            _close(g, r)


def _p_t_grid():
    """P 5e4-2e5 Pa (across the PRESSURE_REF clamp) by T 273.15-320 K."""
    p = np.concatenate([np.linspace(5e4, 2e5, 13), [PRESSURE_REF,
                                                    PRESSURE_REF + 1e-6]])
    t = np.linspace(273.15, 320.0, 7)
    return np.meshgrid(p, t, indexing="ij")


def test_enthalpy_ifc67():
    P, T = _p_t_grid()
    ref = jeos.enthalpy_ifc67(jnp.asarray(T - 273.15), jnp.asarray(P))
    got = teos.enthalpy_ifc67(torch.as_tensor(T - 273.15),
                              torch.as_tensor(P))
    for g, r in zip(got, ref):
        _close(g, r)
    # the numpy twin of the MMS sources is the same numpy code: bitwise
    np.testing.assert_array_equal(teos.enthalpy_ifc67_np(T - 273.15, P),
                                  jeos.enthalpy_ifc67_np(T - 273.15, P))


@pytest.mark.parametrize("itype", [jeos.INT_ENERGY_ENTHALPY_CONSTANT,
                                   jeos.INT_ENERGY_ENTHALPY_IFC67])
@pytest.mark.parametrize("density_type", [jeos.DENSITY_CONSTANT,
                                          jeos.DENSITY_IFC67])
def test_internal_energy_and_enthalpy(itype, density_type):
    """With the density (and derivatives, in kg/m^3) of the chosen model,
    as the enthalpy GE's auxvar chain calls it."""
    P, T = _p_t_grid()
    dj = [np.asarray(v) * 18.01534 for v in
          jeos.density(jnp.asarray(P), jnp.asarray(T), density_type)]
    ref = jeos.internal_energy_and_enthalpy(
        jnp.asarray(P), jnp.asarray(T), itype, jnp.asarray(dj[0]),
        jnp.asarray(dj[2]), jnp.asarray(dj[1]))
    got = teos.internal_energy_and_enthalpy(
        torch.as_tensor(P), torch.as_tensor(T), itype,
        torch.as_tensor(dj[0]), torch.as_tensor(dj[2]),
        torch.as_tensor(dj[1]))
    assert len(got) == len(ref) == 6
    for g, r in zip(got, ref):
        _close(g, r)

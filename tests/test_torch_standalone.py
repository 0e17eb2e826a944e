"""The port's own copies of the JAX package's host modules, and its device
rule.

* ``mpp_tpu_torch.constants`` holds the same enums and values as
  ``mpp_tpu.constants``;
* ``mpp_tpu_torch.dtypes`` builds the same meshes, connection sets and
  region sets as ``mpp_tpu.dtypes`` at the shapes the port uses (celia1990
  columns, the TH x-row and the th_mms XYZ row, the ALM column meshes);
* every entry point defaults to the card and raises, without falling back,
  on a machine without CUDA (``torch.cuda.is_available`` patched to
  False, so the check holds on any machine).
"""
import dataclasses
import enum

import numpy as np
import pytest
import torch

import mpp_tpu.constants as jc
from mpp_tpu.dtypes import mesh as jmesh, regions as jregions
from mpp_tpu_torch import constants as tc
from mpp_tpu_torch.dtypes import mesh as tmesh, regions as tregions
from mpp_tpu_torch.dtypes.conditions import count_cells, Condition
from mpp_tpu_torch.device import device_of

PUBLIC = sorted(n for n in dir(jc) if not n.startswith("_")
                and n not in ("annotations", "enum"))
ENUMS = [n for n in PUBLIC if isinstance(getattr(jc, n), enum.EnumMeta)]
VALUES = [n for n in PUBLIC if n not in ENUMS]


def test_constants_have_the_same_public_names():
    ours = sorted(n for n in dir(tc) if not n.startswith("_")
                  and n not in ("annotations", "enum"))
    assert ours == PUBLIC


@pytest.mark.parametrize("name", ENUMS)
def test_constants_enum_matches(name):
    ref, ours = getattr(jc, name), getattr(tc, name)
    assert [(m.name, m.value) for m in ours] == \
        [(m.name, m.value) for m in ref]
    assert type(ours) is type(ref)


def test_constants_values_match():
    for name in VALUES:
        assert getattr(tc, name) == getattr(jc, name), name
        assert type(getattr(tc, name)) is type(getattr(jc, name)), name


def _conn_arrays(cs):
    d = {f.name: getattr(cs, f.name) for f in dataclasses.fields(cs)}
    return {k: v for k, v in d.items() if v is not None}


def _same_conns(got, ref):
    g, r = _conn_arrays(got), _conn_arrays(ref)
    assert sorted(g) == sorted(r)
    for k in r:
        np.testing.assert_array_equal(g[k], r[k], err_msg=k)
        assert np.asarray(g[k]).dtype == np.asarray(r[k]).dtype, k


def _same_mesh(got, ref):
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if f.name in ("intrn_conn_sets", "lateral_conn_sets"):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                _same_conns(x, y)
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


STRUCTURED = {
    "celia_16": (1.0, 1.0, 1.0, 1, 1, 16, "IN_Z_DIR"),
    "celia_128": (1.0, 1.0, 1.0, 1, 1, 128, "IN_Z_DIR"),
    "th_row_12": (1.0, 1.0, 1.0, 12, 1, 1, "IN_X_DIR"),
    "th_mms_20": (10.0, 1.0, 1.0, 20, 1, 1, "IN_XYZ_DIR"),
    "box_3x2x4": (3.0, 2.0, 4.0, 3, 2, 4, "IN_XYZ_DIR"),
}


@pytest.mark.parametrize("case", sorted(STRUCTURED))
def test_structured_mesh_matches(case):
    *geo, conn = STRUCTURED[case]
    ref = jmesh.structured_mesh("m", *geo, getattr(jc.ConnKind, conn))
    got = tmesh.structured_mesh("m", *geo, getattr(tc.ConnKind, conn))
    _same_mesh(got, ref)
    for region in ("SOIL_TOP_CELLS", "SOIL_BOTTOM_CELLS", "ALL_CELLS"):
        _same_conns(tregions.region_connection_set(
                        got, getattr(tc.Region, region)),
                    jregions.region_connection_set(
                        ref, getattr(jc.Region, region)))


@pytest.mark.parametrize("ncols", [1, 3])
def test_column_mesh_matches(ncols):
    nz = 10
    dz = np.full(nz, 0.1)
    zc = -(np.cumsum(dz) - 0.5 * dz)
    kw = dict(ncols=ncols, itype=int(tc.MeshType.CLM_SOIL_COL))
    ref = jmesh.column_mesh("c", zc, dz, np.ones(nz), **kw)
    got = tmesh.column_mesh("c", zc, dz, np.ones(nz), **kw)
    _same_mesh(got, ref)


def test_conditions_count_cells():
    cs = tmesh.internal_connections(1, 1, 5, 1.0, 1.0, 0.2,
                                    tc.ConnKind.IN_Z_DIR)
    conds = [Condition(name="a", units="Pa", itype=int(tc.Cond.DIRICHLET),
                       conn_set=cs)]
    assert count_cells(conds) == cs.num_connections == 4


# --- the device rule --------------------------------------------------------
def _soils(ncol=2, nz=4):
    shape = (ncol, nz)
    return dict(watsat=np.full(shape, 0.368), hksat=np.full(shape, 0.007),
                bsw=np.full(shape, 2.0), sucsat=np.full(shape, 29.772),
                residual_sat=np.full(shape, 0.2772), dz=np.full(shape, 0.1),
                area=np.ones(ncol))


def _entry_points():
    from mpp_tpu_torch import entry
    from mpp_tpu_torch.driver import alm
    from mpp_tpu_torch.problems import th
    comp = entry.build_compiled_celia(6)[1]
    mpp_th = th.run_mass_and_heat(nx=4, nstep=0, device="cpu")[0]
    from mpp_tpu_torch.batched.th_compiled import compile_th
    comp_th = compile_th(mpp_th, linear_solver="direct")
    return {
        "entry": lambda: entry.entry(ncol=2, nz=6),
        "alm_vsfm_initialize": lambda: alm.alm_vsfm_initialize(**_soils()),
        "gather_inputs": lambda: comp.gather_inputs(2),
        "_serial_dyn": lambda: comp_th._serial_dyn(2),
        "install": lambda: comp.install(),
        "serial step_dt": lambda: compile_th(
            mpp_th, linear_solver="direct").step_dt(3600.0),
        "run_mass_and_heat": lambda: th.run_mass_and_heat(nx=4),
        "run_th_mms": lambda: th.run_th_mms(nx=4),
    }


@pytest.mark.parametrize("name", ["entry", "alm_vsfm_initialize",
                                  "gather_inputs", "_serial_dyn", "install",
                                  "serial step_dt", "run_mass_and_heat",
                                  "run_th_mms"])
def test_entry_point_defaults_to_the_card(monkeypatch, name):
    calls = _entry_points()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        calls[name]()


def test_device_of():
    assert device_of("cpu") == torch.device("cpu")
    assert device_of(torch.device("cpu")).type == "cpu"

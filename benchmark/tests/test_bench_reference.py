"""The comparison that decides ``correct``, on the CPU at small sizes: the
port passes it, the control (the nearest precision below the stated one)
fails it, and a run whose timed path is broken underneath fails it."""
import numpy as np
import pytest
import torch

import calibrate
import run
from systems import alm_vsfm

SMALL = {"elm_vsfm_r05.diurnal": {"ncol": 64},
         "vsfm_vchannel.direct": {"nz": 3},
         "vsfm_vchannel.petsc": {"nz": 3}}


def small_run(name, trace=0):
    return run.run_cell(name, 2 ** 33 + 17, 0.0, trace, device="cpu",
                        overrides=SMALL[name])


@pytest.mark.parametrize("name", sorted(SMALL))
def test_port_matches_reference(name):
    res = small_run(name)
    assert res["failed"] == 0 and res["attempted"] >= 3
    if name == "vsfm_vchannel.petsc":
        # at 3 layers the initial state is far from equilibrium (the first
        # step moves the pressure ~1.3e5 Pa), and GMRES at rtol 1e-5
        # inside Newton's stop at rtol 1e-8 of that residual leaves ~1e-2
        # Pa, against ~3e-5 Pa at the cell's 30 layers: the cell's limit
        # holds at the cell's size (PERF.md), this size is held to 0.1 Pa
        assert res["checks"]["p_gap_pa"]["value"] < 0.1, res["checks"]
        assert res["checks"]["ref_unconverged"]["value"] == 0
    else:
        assert res["correct"], res["checks"]


def test_traced_run_reads_its_counters():
    res = small_run("elm_vsfm_r05.diurnal", trace=1)
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m["alm_attempts_per_step"]["value"] >= 1.0
    assert m["newton_iters_per_step"]["value"] > 0
    # no device activity on the CPU: the device metrics are left out
    assert "thomas_roofline" not in m and "device_idle_pct" not in m


@pytest.mark.parametrize("name", ["elm_vsfm_r05.diurnal",
                                  "vsfm_vchannel.direct"])
def test_control_fails(name):
    """The control at a small size: the harness judges every seed's run
    not correct."""
    rows = calibrate.readings(name, [11, 12, 13], True, device="cpu",
                              overrides=SMALL[name])
    for r in rows:
        assert not r["correct"], r


def test_storm_traffic_steps_and_judges():
    """The generator's storm option, which no cell runs: the storm's
    columns take their top layer's hksat on the storm's steps, the sample
    the reference follows holds them, and the steps pass the comparison."""
    _, config, params = run.cell_files(run.manifest(),
                                       "elm_vsfm_r05.diurnal")
    storm = {"column_share": 0.0625, "steps": [28, 29, 30, 31]}
    params = dict(params, traffic=dict(params["traffic"], storm=storm))
    cell = alm_vsfm.Cell({**config, "ncol": 64}, params, 5, "cpu")
    f, cols = cell.forcing, cell.forcing.storm_cols
    assert cols.numel() == 4 and cell.kinds.count("storm") == 4
    hksat_top = torch.as_tensor(cell.soils["hksat"][:, -1])
    assert torch.equal(f.qflx_infl[28, cols], hksat_top[cols])
    assert set(cols.tolist()) <= set(cell.cols_np.tolist())
    for i in range(32):
        cell.step(i)
    assert cell.settle() == 0
    cell.release()
    numbers = cell.judge(np.random.default_rng([5, 1]))
    assert all(numbers[k] <= lim for k, lim in params["limits"].items()), \
        numbers


def alm_fault(kind):
    from mpp_tpu_torch.driver import alm
    orig = alm.alm_vsfm_solve

    def broken(prob, dtime, **kw):
        prev = prob.P
        out = orig(prob, dtime, **kw)
        new = out["soilp"]
        if kind == "unchanged":
            new = prev
        elif kind == "half":
            h = new.shape[0] // 2
            new = torch.cat([new[:h], prev[h:]])
        else:                       # one value altered by 1 Pa
            new = new.clone()
            new[0, -1] += 1.0
        prob.P = new
        return dict(out, soilp=new)
    return alm, "alm_vsfm_solve", broken


def vch_fault(kind):
    from mpp_tpu_torch.batched.vsfm_compiled import CompiledVSFM
    orig = CompiledVSFM._step_dt_serial

    def broken(self, dt, istep, dyn):
        soe = self.mpp.soe
        prev = np.array(soe.soln)
        out = orig(self, dt, istep, dyn)
        new = np.array(soe.soln)
        if kind == "unchanged":
            new = prev
        elif kind == "half":
            new[new.size // 2:] = prev[new.size // 2:]
        else:
            new[0] += 1.0
        soe.soln = new
        return out
    return CompiledVSFM, "_step_dt_serial", broken


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name,fault", [("elm_vsfm_r05.diurnal", alm_fault),
                                        ("vsfm_vchannel.direct", vch_fault)])
def test_broken_step_is_not_correct(monkeypatch, name, fault, kind):
    """The timed path broken underneath: a step that returns its state
    unchanged, half of the batch (or of the cells) left unstepped, one
    answer altered where it is produced."""
    owner, attr, broken = fault(kind)
    monkeypatch.setattr(owner, attr, broken)
    res = small_run(name)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    res = run.run_cell("vsfm_vchannel.direct", 5, 1.0, 0)
    assert res["correct"], res["checks"]

"""The program's spans in a traced run, on the CPU at small sizes: every
span metric a cell lists reads a number, and the self times with the time
outside every span make up the traced window."""
import types

import pytest

import devtrace
import run
import spans

SMALL = {"elm_vsfm_r05.diurnal": {"ncol": 64},
         "vsfm_vchannel.direct": {"nz": 3},
         "vsfm_vchannel.petsc": {"nz": 3}}

NEW = ("alm_self_ms_per_step", "newton_self_ms_per_step",
       "line_search_self_ms_per_step", "assembly_self_ms_per_step",
       "constitutive_ms_per_step", "linear_solve_self_ms_per_step",
       "sync_wait_ms_per_step", "newton_useful_col_pct",
       "idle_unspanned_pct")


@pytest.mark.parametrize("name", sorted(SMALL))
def test_traced_run_reads_the_span_metrics(name):
    bench = run.manifest()
    listed = [m for m in run.metrics_of(bench, "per_layer", name)
              if m["name"] in NEW]
    assert listed
    res = run.run_cell(name, 2 ** 33 + 5, 0.0, 1, device="cpu",
                       overrides=SMALL[name])
    for m in listed:
        v = res["metrics"].get(m["name"], {}).get("value")
        assert v is not None and v >= 0.0, m["name"]
    assert res["metrics"]["idle_unspanned_pct"]["value"] < 10.0


def test_self_times_make_up_the_window():
    """The cell's span metrics plus the window's time under no span equal
    the window a step: the spans nest and none stays open."""
    from mpp_tpu_torch.io import timers
    bench = run.manifest()
    name = "vsfm_vchannel.direct"
    entry, config, params = run.cell_files(bench, name)
    config = {**config, **SMALL[name]}
    from systems import vsfm_vchannel
    cell = vsfm_vchannel.Cell(config, params, 3, "cpu")
    cell.warm()
    timers.clear()
    tr = devtrace.profiled(lambda: [cell.step(i) for i in range(3)],
                           cuda=False)
    r = types.SimpleNamespace(trace=tr, records=cell.records, cell=cell)
    selfs = [m["name"] for m in run.metrics_of(bench, "per_layer", name)
             if m["source"] == "program_span"]
    total = sum(run.metric_reader(n).read(r) or 0.0 for n in selfs)
    window = tr.window_s * 1e3 / 3
    assert total + spans.outside_ms_per_step(r) == pytest.approx(window,
                                                                  rel=1e-4)
    assert timers.RECORDER.open == []

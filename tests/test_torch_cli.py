"""The port's namelist CLI (``python -m mpp_tpu_torch.cli``) against the
JAX package's (``mpp_tpu.cli``), on the CPU in f64.

Both CLIs run the same cheap namelists written into ``tmp_path``
(th_mms, thermal_mms) and their regression files agree within rtol 1e-9
of each section's scale.  The JAX CLI has no ``vsfm_mms`` problem type;
the port's file for it is held against the JAX package's
``run_vsfm_mms_problem`` and ``output_regression``.  Every problem type
of the JAX CLI's dispatcher (read from the text of ``mpp_tpu/cli.py``)
reaches a runner of the port, with each problem module stubbed out,
``th_manoli2014`` among them.
"""
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from mpp_tpu import cli as jcli
from mpp_tpu.problems import vsfm_mms as jmms
from mpp_tpu_torch import cli as tcli
from mpp_tpu_torch import config
from serial_parity import assert_regression_files_match

ROOT = pathlib.Path(__file__).resolve().parents[1]

NAMELISTS = {
    "th_mms": "&mpp_driver\n  problem_type = 'th_mms'\n/\n",
    "thermal_mms": "&mpp_driver\n  problem_type = 'thermal_mms'\n/\n"
                   "&problem_options\n  problem_type = 2\n  nx = 6\n"
                   "  ny = 5\n/\n",
    "vsfm_mms": "&mpp_driver\n  problem_type = 'vsfm_mms'\n/\n"
                "&problem_options\n  nx = 20\n/\n",
}
REGRESSION = "&regression_test\n  write_regression_output = .true.\n" \
             "  num_cells = 5\n/\n"


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _namelist(tmp_path, name, tag):
    d = tmp_path / tag
    d.mkdir(exist_ok=True)
    path = d / (name + ".namelist")
    path.write_text(NAMELISTS[name] + REGRESSION)
    return str(path)


@pytest.mark.parametrize("name", ["th_mms", "thermal_mms"])
def test_both_clis_write_the_same_file(tmp_path, name):
    nj = _namelist(tmp_path, name, "jax")
    nt = _namelist(tmp_path, name, "port")
    assert jcli.main(["-namelist", nj]) == 0
    assert tcli.main(["-namelist", nt, "-device", "cpu"]) == 0
    assert_regression_files_match(nj[:-len("namelist")] + "regression",
                                  nt[:-len("namelist")] + "regression")


def test_vsfm_mms_file_matches_jax_writer(tmp_path):
    nt = _namelist(tmp_path, "vsfm_mms", "port")
    assert tcli.main(["-namelist", nt, "-device", "cpu"]) == 0
    mj, _ = jmms.run_vsfm_mms_problem(nx=20)
    fj = jmms.output_regression(mj, str(tmp_path / "jax"), 5)
    assert_regression_files_match(fj, nt[:-len("namelist")] + "regression")


def test_module_entry_point_runs(tmp_path):
    """``python -m mpp_tpu_torch.cli -namelist X -device cpu`` in a fresh
    interpreter writes the file the in-process call writes."""
    nt = _namelist(tmp_path, "vsfm_mms", "proc")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-m", "mpp_tpu_torch.cli",
                           "-namelist", nt, "-device", "cpu"],
                          cwd=str(tmp_path), env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = nt[:-len("namelist")] + "regression"
    assert f"Wrote {out}" in proc.stdout
    ni = _namelist(tmp_path, "vsfm_mms", "inproc")
    tcli.main(["-namelist", ni, "-device", "cpu"])
    assert open(out).read() == \
        open(ni[:-len("namelist")] + "regression").read()


def _jax_problem_types():
    text = (ROOT / "mpp_tpu" / "cli.py").read_text()
    return sorted(set(re.findall(r'problem_type == "([^"]+)"', text)))


class _Result:
    """What a stubbed runner returns: unpacks into two more results."""

    def __iter__(self):
        return iter((_Result(), _Result()))


class _StubModule:
    DRYING_PROBLEM = 2

    def __init__(self, calls):
        self._calls = calls

    def __getattr__(self, name):
        def runner(*args, **kw):
            self._calls.append((name, kw.get("device")))
            return _Result()
        return runner


def test_port_dispatches_every_jax_problem_type(monkeypatch):
    import mpp_tpu_torch.problems as pkg
    types = _jax_problem_types()
    assert len(types) >= 21 and "vsfm_celia1990" in types
    calls = []
    for mod in ("th", "thermal_mms", "vsfm_celia1990", "vsfm_vchannel",
                "vsfm_spac", "vsfm_spac_campbell", "mlc",
                "canopy_radiation", "photosynthesis", "ml_model",
                "vsfm_sy1991", "vsfm_wt_dynamics",
                "vsfm_vchannel_operator_split", "vsfm_manoli2014",
                "vsfm_spac_mms", "vsfm_mms", "th_manoli2014"):
        monkeypatch.setattr(pkg, mod, _StubModule(calls), raising=False)
    for pt in types:
        del calls[:]
        writer = tcli._dispatch(pt, {}, "cpu")
        assert callable(writer), pt
        assert calls and calls[0][0].startswith("run_"), pt
        assert calls[0][1] == "cpu", pt
    with pytest.raises(SystemExit):
        tcli._dispatch("bogus", {}, "cpu")


def test_cli_requires_namelist_and_a_card(tmp_path):
    with pytest.raises(SystemExit):
        tcli.main([])
    nt = _namelist(tmp_path, "vsfm_mms", "card")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tcli.main(["-namelist", nt])


def test_debug_nans_flag_arms_the_trap(tmp_path, monkeypatch):
    monkeypatch.delenv("MPP_DEBUG_NANS", raising=False)
    nt = _namelist(tmp_path, "vsfm_mms", "nan")
    try:
        assert tcli.main(["-namelist", nt, "-device", "cpu",
                          "--debug-nans"]) == 0
        assert config.DEBUG_NANS
    finally:
        config.enable_nan_debug("disable")
    monkeypatch.setenv("MPP_DEBUG_NANS", "1")
    try:
        assert tcli.main(["-namelist", nt, "-device", "cpu"]) == 0
        assert config.DEBUG_NANS
    finally:
        config.enable_nan_debug("disable")

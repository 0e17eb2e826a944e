"""The PyTorch port never imports jax: a fresh interpreter imports every
module of mpp_tpu_torch, runs one ALM step and one TH step on the CPU, and
finds no jax in sys.modules; no source file of the package names jax in an
import."""
import os
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
import numpy as np
import mpp_tpu_torch
for m in pkgutil.walk_packages(mpp_tpu_torch.__path__, "mpp_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from mpp_tpu_torch.driver import alm
ncol, nz = 3, 6
shape = (ncol, nz)
prob = alm.alm_vsfm_initialize(
    watsat=np.full(shape, 0.368), hksat=np.full(shape, 0.0070556),
    bsw=np.full(shape, 2.0), sucsat=np.full(shape, 29.772),
    residual_sat=np.full(shape, 0.2772), dz=np.full(shape, 0.1),
    area=np.ones(ncol), include_seepage_bc=True)
out = alm.alm_vsfm_solve(prob, 1800.0, qflx_infl=np.full(ncol, 2e-4))
assert out["abs_mass_error_col"] < alm.MAX_ABS_MASS_ERROR_COL
import mpp_tpu_torch.batched.th_compiled, mpp_tpu_torch.problems.th
from mpp_tpu_torch.problems import th
mpp, soln = th.run_mass_and_heat(nx=6)
assert mpp.soe.cumulative_newton_iterations > 0 and np.isfinite(soln).all()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
print("JAX_MODULES", bad)
"""


def test_port_runs_without_importing_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_MODULES []" in proc.stdout, proc.stdout


def test_no_jax_import_in_sources():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
    offenders = [str(p) for p in (ROOT / "mpp_tpu_torch").rglob("*.py")
                 if pat.search(p.read_text())]
    assert offenders == []
    # from mpp_tpu only the jax-free host modules
    allowed = re.compile(r"from mpp_tpu\.(constants|varpar|dtypes\."
                         r"(mesh|conditions|regions|mpp_base)) import "
                         r"|from mpp_tpu import (constants|varpar)\b")
    for p in (ROOT / "mpp_tpu_torch").rglob("*.py"):
        for line in p.read_text().splitlines():
            s = line.strip()
            if re.match(r"(from|import) mpp_tpu\b", s) and \
                    not s.startswith(("from mpp_tpu_torch",
                                      "import mpp_tpu_torch")):
                assert allowed.match(s), f"{p}: {s}"

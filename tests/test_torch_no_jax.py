"""The PyTorch port stands alone: a fresh interpreter imports every module
of mpp_tpu_torch and chip_smoke, runs one ALM step and one TH step on the
CPU, and finds neither jax nor the JAX package ``mpp_tpu`` in sys.modules;
no source line of the port or of chip_smoke.py imports either."""
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
    area=np.ones(ncol), include_seepage_bc=True, device="cpu")
out = alm.alm_vsfm_solve(prob, 1800.0, qflx_infl=np.full(ncol, 2e-4))
assert out["abs_mass_error_col"] < alm.MAX_ABS_MASS_ERROR_COL
from mpp_tpu_torch.problems import th
mpp, soln = th.run_mass_and_heat(nx=6, device="cpu")
assert mpp.soe.cumulative_newton_iterations > 0 and np.isfinite(soln).all()
from mpp_tpu_torch.ops import hopper_kernels as hk
import torch
g = torch.Generator().manual_seed(0)
dl, d, du, b, x = (torch.rand((4, 40), generator=g, dtype=torch.float64)
                   for _ in range(5))
hk.tridiag_spmv_chain(dl, d + 2.0, du, x, 3, 0.25)
hk.tridiag_jacobi_smooth(dl, d + 2.0, du, b, x, 3)
bad = sorted(m for m in sys.modules if m.startswith("jax"))
print("JAX_MODULES", bad)
bad = sorted(m for m in sys.modules if m == "mpp_tpu"
             or m.startswith("mpp_tpu."))
print("MPP_TPU_MODULES", bad)
"""

IMPORT_OF = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|mpp_tpu)(\.|\s|,|$)")
DYNAMIC_IMPORT_OF = re.compile(
    r"""(import_module|__import__)\(\s*["'](jax|jaxlib|mpp_tpu)[."']""")


def _port_sources():
    return sorted((ROOT / "mpp_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


def test_port_runs_without_importing_jax():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_MODULES []" in proc.stdout, proc.stdout
    assert "MPP_TPU_MODULES []" in proc.stdout, proc.stdout


def test_no_jax_import_in_sources():
    offenders = []
    for p in _port_sources():
        for i, line in enumerate(p.read_text().splitlines(), 1):
            if IMPORT_OF.match(line) or DYNAMIC_IMPORT_OF.search(line):
                offenders.append(f"{p.relative_to(ROOT)}:{i}: {line.strip()}")
    assert offenders == []

"""Why the UGDM lateral ALM step with a wet half at 1.06e5 Pa does not
finish its second step at nz 30, in the PyTorch port and in the JAX
package alike (ROADMAP Queue 3).

The configuration is (x2)'s of ``chip_smoke.py`` cut to a 4 x 4 grid of
columns: edges of 10 m, nz 30, the heterogeneous CLM soils of numpy seed
0, the first half of the columns at 1.06e5 Pa and the rest at 3.5355e3
Pa, no forcing, dt 1800 s, f64, on the CPU.  The first step converges in
one batched Newton solve.  In the second, the batched dt-cut ladder
(``_step_dt_batched``) halves the substep of the columns that diverge,
15 times within its first 17 Newton solves, and then advances at
1800 / 2^15 s: the ladder never grows a substep back, so the step would
take about 2^15 more Newton solves (hours on this CPU).  Its work is
bounded only by 2^max_cuts solves (max_cuts = 20).

Both packages are driven in one subprocess (``subprocess.run`` with a
120 s timeout), each with its batched Newton solve wrapped to record the
smallest substep of every call and to stop the step after 20 calls (the
JAX package through a ``jax.debug.callback`` that raises).  The test
asserts the two sequences equal, the 15 cuts, and that the last calls
all stay at 1800 / 2^15 s.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
CAP = 20

SCRIPT = r'''
import json, os, sys
import numpy as np
REPO, CAP = sys.argv[1], int(sys.argv[2])
sys.path.insert(0, REPO)
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_enable_x64", True)
import torch
torch.set_num_threads(2)


class Stop(Exception):
    pass


def inputs(UGrid):
    ug = UGrid.regular_2d(4, 4)
    ug.edge_dist[:] = 10.0
    ug.edge_area[:] = 10.0
    ncol, nz = ug.ncol, 30
    rng = np.random.default_rng(0)
    shape = (ncol, nz)
    soils = dict(
        watsat=0.35 + 0.1 * rng.random(shape),
        hksat=0.004 * (0.5 + rng.random(shape)),
        bsw=2.0 + 2.0 * rng.random(shape),
        sucsat=20.0 + 20.0 * rng.random(shape),
        residual_sat=0.10 + 0.1 * rng.random(shape),
        dz=np.full(shape, 0.1), area=np.ones(ncol))
    P0 = np.full(shape, 3.5355e3)
    P0[:ncol // 2] = 1.06e5
    return dict(P0=P0, lateral_connectivity=True, ugrid=ug, **soils)


def two_steps(alm, prob, log):
    """The first step's Newton solves, then the second's until the cap."""
    out = []
    for _ in range(2):
        log.clear()
        try:
            alm.alm_vsfm_solve(prob, 1800.0)
            out.append({"finished": True, "dte": list(log)})
        except Exception:
            if len(log) < CAP:
                raise
            out.append({"finished": False, "dte": list(log)})
    return out


from mpp_tpu_torch.driver import alm as talm
from mpp_tpu_torch.parallel.ugrid import UGrid as TUGrid
prob = talm.alm_vsfm_initialize(device="cpu", **inputs(TUGrid))
log_t = []
solve_t = prob.comp._snes_batched


def port_solve(X, bc, ss, accum_prev, dte, *a):
    if len(log_t) >= CAP:
        raise Stop
    log_t.append(float(dte.min()))
    return solve_t(X, bc, ss, accum_prev, dte, *a)


prob.comp._snes_batched = port_solve
port = two_steps(talm, prob, log_t)

from mpp_tpu.driver import alm as jalm
from mpp_tpu.parallel.ugrid import UGrid as JUGrid
prob = jalm.alm_vsfm_initialize(**inputs(JUGrid))
log_j = []
solve_j = prob.comp._snes_batched


def record(dte):
    if len(log_j) >= CAP:
        raise Stop
    log_j.append(float(np.min(dte)))


def jax_solve(X, bc, ss, accum_prev, dte, *a):
    jax.debug.callback(record, dte, ordered=True)
    return solve_j(X, bc, ss, accum_prev, dte, *a)


prob.comp._snes_batched = jax_solve
ref = two_steps(jalm, prob, log_j)
print("LADDER " + json.dumps({"port": port, "jax": ref}))
'''


def test_second_step_cuts_to_dt_over_2_15_and_stays_there(tmp_path):
    script = tmp_path / "ladder.py"
    script.write_text(SCRIPT)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(script), str(ROOT),
                           str(CAP)], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("LADDER ")]
    got = json.loads(line[-1][len("LADDER "):])
    port, ref = got["port"], got["jax"]
    for steps in (port, ref):
        first, second = steps
        assert first == {"finished": True, "dte": [1800.0]}
        assert not second["finished"] and len(second["dte"]) == CAP
    cuts = lambda steps: [int(round(np.log2(1800.0 / d)))
                          for d in steps[1]["dte"]]
    assert cuts(port) == cuts(ref)
    c = cuts(port)
    first15 = c.index(15)
    assert first15 < 17 and max(c) == 15
    # no substep grows back: the step goes on at 1800 / 2^15 s
    assert c[first15:] == [15] * (CAP - first15)
    assert port[1]["dte"][-1] == ref[1]["dte"][-1] == 1800.0 / 2 ** 15

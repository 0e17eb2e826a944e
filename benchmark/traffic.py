"""The forcing generator of column cells: one simulated day of land-model
fluxes, made from a traffic file's parameters and the run's seed.

A traffic file (``workloads/<cell>.json``, key ``traffic``) gives:

* ``day_steps``: the steps of one day, replayed from the initial state;
* ``infiltration_mm_s``: [lo, hi] of each column's steady infiltration;
* ``transpiration_mm_s``: [lo, hi] of each column's midday transpiration,
  a half sine over ``daylight_steps`` [first, end) and nothing at night;
* ``root_levels``: transpiration drawn evenly from that many top levels;
* ``storm`` (optional): ``column_share`` of the columns, drawn from the
  seed, take their top layer's saturated conductivity (the most the soil
  takes in) as infiltration on ``steps``.

Every seed gets the same sizes and schedule; the seed draws the values.
"""
from __future__ import annotations

import math

import numpy as np
import torch


class ColumnForcing:
    """Per-step forcing on the device: ``qflx_infl`` and ``qflx_tran_veg``
    [day_steps, ncol] [mm/s], ``rootr`` [ncol, nz] (bottom first),
    ``kinds`` (the step kind of each step: "storm" or "plain") and
    ``storm_cols`` (long, the storm's columns; empty without one)."""

    def __init__(self, params, rng, ncol, nz, hksat_top, device):
        S = int(params["day_steps"])
        lo, hi = params["infiltration_mm_s"]
        infl = lo + (hi - lo) * rng.random(ncol)
        lo, hi = params["transpiration_mm_s"]
        tmax = lo + (hi - lo) * rng.random(ncol)
        d0, d1 = params["daylight_steps"]
        shape = np.array([math.sin(math.pi * (k + 0.5 - d0) / (d1 - d0))
                          if d0 <= k < d1 else 0.0 for k in range(S)])
        storm = params.get("storm")
        self.kinds = ["plain"] * S
        cols = np.zeros(0, np.int64)
        infl_sk = np.repeat(infl[None, :], S, axis=0)
        if storm:
            n = int(round(storm["column_share"] * ncol))
            cols = np.sort(rng.choice(ncol, size=n, replace=False))
            for k in storm["steps"]:
                infl_sk[k, cols] = hksat_top[cols]
                self.kinds[k] = "storm"
        f = lambda v: torch.as_tensor(v, dtype=torch.float64, device=device)
        self.qflx_infl = f(infl_sk)
        self.qflx_tran_veg = f(shape[:, None] * tmax[None, :])
        rootr = np.zeros((ncol, nz))
        rootr[:, nz - int(params["root_levels"]):] = \
            1.0 / int(params["root_levels"])
        self.rootr = f(rootr)
        self.storm_cols = torch.as_tensor(cols, device=device)
        self.day_steps = S

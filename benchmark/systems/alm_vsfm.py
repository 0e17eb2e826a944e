"""The ELM VSFM step (MPPVSFMALM_Solve) through the port's ALM driver:
``driver/alm.alm_vsfm_initialize`` in set-up, ``alm_vsfm_solve`` a step.

The land model is the caller: it hands the columns one day of forcing,
step after step, waits for each step, and replays the day from the initial
state, so every run does the same work a step whatever its speed.
"""
from __future__ import annotations

import numpy as np
import torch

import traffic
from reference import alm_vsfm as ref, vsfm


def layering(config):
    """Layer thicknesses [nz] (bottom first) and interface depths [nz + 1]
    (top first) of CLM4.5's exponential nodes z_j = s (exp(r (j - 0.5))
    - 1): interfaces halfway between nodes, the last one half a layer
    below the deepest node."""
    nz = int(config["nlevgrnd"])
    s, r = config["node_depth"]["scale_m"], config["node_depth"]["rate"]
    z = s * (np.exp(r * (np.arange(1, nz + 1) - 0.5)) - 1.0)
    zi = np.empty(nz + 1)
    zi[0] = 0.0
    zi[1:nz] = 0.5 * (z[:-1] + z[1:])
    zi[nz] = z[-1] + 0.5 * (z[-1] - z[-2])
    return np.diff(zi)[::-1].copy(), zi


def draw_soils(rng, ncol, nz, spec):
    """Per-column, per-level CLM soils [ncol, nz] (bottom first) from a
    texture drawn in the configuration's ranges: whole-percent sand and
    clay for the top ``texture_levels`` levels, the deepest of them
    repeated below (CLM4.5), through CLM4.5's mineral-soil pedotransfer
    functions (TN-503, after Cosby et al. 1984); the residual saturation
    is a residual water content drawn in its range over watsat."""
    nt = int(spec["texture_levels"])
    whole = lambda key: rng.integers(spec[key][0], spec[key][1] + 1,
                                     (ncol, nt)).astype(np.float64)
    sand, clay = whole("sand_pct"), whole("clay_pct")
    deep = np.minimum(np.arange(nz), nt - 1)        # top first
    sand, clay = sand[:, deep][:, ::-1], clay[:, deep][:, ::-1]
    watsat = 0.489 - 0.00126 * sand
    lo, hi = spec["residual_water_m3_m3"]
    theta_r = lo + (hi - lo) * rng.random((ncol, nz))
    return dict(watsat=watsat,
                hksat=0.0070556 * 10.0 ** (-0.884 + 0.0153 * sand),
                bsw=2.91 + 0.159 * clay,
                sucsat=10.0 * 10.0 ** (1.88 - 0.0131 * sand),
                residual_sat=theta_r / watsat)


def hydrostatic(rng, ncol, dz, span):
    """Pressure [ncol, nz] (bottom first) of columns at rest below a water
    table whose depth is drawn per column in ``span`` [m]: P = P_ref + rho
    g (d - zwt) at each layer centre's depth d, rho the TGDPB01 density at
    P_ref and the default temperature."""
    top_first = dz[::-1]
    d = (np.cumsum(top_first) - 0.5 * top_first)[::-1]
    zwt = span[0] + (span[1] - span[0]) * rng.random(ncol)
    rho = float(vsfm.density_tgdpb01(torch.tensor(vsfm.PRESSURE_REF,
                                                  dtype=torch.float64))
                ) * vsfm.FMWH2O
    return vsfm.PRESSURE_REF + rho * vsfm.GRAVITY * (d[None, :]
                                                     - zwt[:, None])


class Cell:
    """One configuration under one traffic file, built from the seed.
    ``control``: the program's own f32 path (f32 state, no f64
    escalation) with the configuration's control audit threshold, in
    place of the stated f64."""

    def __init__(self, config, params, seed, device, control=False):
        from mpp_tpu_torch.driver import alm
        from mpp_tpu_torch.ops import eos
        if (config["satfunc"], config["density"]) != \
                ("smooth_brooks_corey_bz3", "TGDPB01"):
            raise ValueError("the reference has smooth_brooks_corey_bz3 "
                             "and TGDPB01 only")
        self.alm = alm
        self.device = torch.device(device)
        self.dt = float(config["dtime_s"])
        ncol, nz = int(config["ncol"]), int(config["nlevgrnd"])
        self.dz, self.zi = layering(config)
        rng = np.random.default_rng(seed)
        self.soils = draw_soils(rng, ncol, nz, config["soils"])
        self.area = np.ones(ncol)
        self.forcing = traffic.ColumnForcing(
            params["traffic"], rng, ncol, nz, self.soils["hksat"][:, -1],
            self.device)
        self.day_steps = self.forcing.day_steps
        self.kinds = self.forcing.kinds
        g = config["guarantees"]
        self.audit_limit = float(g["max_abs_mass_error_col_kg"])
        self.seepage = bool(config["include_seepage_bc"])
        dtype = getattr(torch, config["control"]["dtype"] if control
                        else config["dtype"])
        self.prob = alm.alm_vsfm_initialize(
            **self.soils, dz=np.broadcast_to(self.dz, (ncol, nz)),
            area=self.area,
            P0=hydrostatic(rng, ncol, self.dz, config["water_table_m"]),
            satfunc_type=config["satfunc"],
            density_type=getattr(eos, "DENSITY_" + config["density"]),
            include_seepage_bc=config["include_seepage_bc"],
            device=self.device, dtype=dtype, escalate_f64=not control)
        if control:
            self.prob.audit_threshold_kg = float(
                config["control"]["audit_threshold_kg"])
        self.P0 = self.prob.P.clone()
        # the columns the reference follows: a seeded draw, a share of
        # them from the storm's columns where there is a storm
        check = params["check"]
        K = min(int(check["columns"]), ncol)
        storm = self.forcing.storm_cols.cpu().numpy()
        ns = min(storm.size, K // 4)
        pick = rng.choice(storm, size=ns, replace=False) if ns else \
            np.zeros(0, np.int64)
        rest = np.setdiff1d(np.arange(ncol), pick)
        cols = np.sort(np.concatenate(
            [pick, rng.choice(rest, size=K - ns, replace=False)]))
        self.cols_np = cols
        self.cols = torch.as_tensor(cols, device=self.device)
        self.check_steps = int(check["steps"])
        self.records, self.kept, self.ok_dev = [], [], []

    def _solve(self, k):
        f = self.forcing
        return self.alm.alm_vsfm_solve(
            self.prob, self.dt, qflx_infl=f.qflx_infl[k],
            qflx_tran_veg=f.qflx_tran_veg[k], rootr=f.rootr)

    def warm(self):
        """One step of each kind, then back to the initial state."""
        for kind in dict.fromkeys(self.kinds):
            self.prob.P = self.P0
            self._solve(self.kinds.index(kind))
        self.prob.P = self.P0
        self._sync()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def step(self, i):
        """Step i of the replayed days; waits for it.  Returns its
        counters; a step that raises is a failed one."""
        k = i % self.day_steps
        if k == 0:
            self.prob.P = self.P0
        try:
            out = self._solve(k)
        except RuntimeError as e:
            rec = dict(k=k, kind=self.kinds[k], ok=False, error=str(e))
            self.records.append(rec)
            self.kept.append(None)
            self._sync()
            return rec
        c = self.cols
        self.kept.append({key: out[key][c] for key in
                          ("soilp", "h2osoi_liq", "smp_l", "zwt",
                           "qflx_seepage")})
        self.ok_dev.append((len(self.records), (out["reason"] > 0).all()))
        self._sync()
        rec = dict(k=k, kind=self.kinds[k], attempts=out["attempts"],
                   newton_iters=out["newton_iters"],
                   host_syncs=out["host_round_trips_per_step"],
                   audit_kg=out["abs_mass_error_col"],
                   ok=out["abs_mass_error_col"] < self.audit_limit)
        self.records.append(rec)
        return rec

    def settle(self):
        """Fold the device-side guarantee (every column converged) into
        the step records; returns the number of failed steps."""
        if self.ok_dev:
            flags = torch.stack([f for _, f in self.ok_dev]).cpu().numpy()
            for (i, _), good in zip(self.ok_dev, flags):
                self.records[i]["ok"] = bool(self.records[i]["ok"] and good)
            self.ok_dev = []
        return sum(not r["ok"] for r in self.records)

    def release(self):
        """Drop the program's state (the reference runs after it)."""
        self.prob = None

    def judge(self, rng):
        """The reference's comparison of a seeded sample of the steps run
        (the one of most Newton iterations and one of each kind among
        them): the largest pressure gap [Pa], the reference's audit of the
        program's states [kg], and the largest gap of the CLM unpack from
        the reference's unpack of the same states (share of its largest
        magnitude)."""
        done = [i for i, r in enumerate(self.records) if "error" not in r]
        if not done:
            return None
        pick = [max(done, key=lambda i: self.records[i]["newton_iters"])]
        for kind in dict.fromkeys(self.records[i]["kind"] for i in done):
            if not any(self.records[i]["kind"] == kind for i in pick):
                pick.append(next(i for i in done
                                 if self.records[i]["kind"] == kind))
        rest = [i for i in done if i not in pick]
        extra = max(0, self.check_steps - len(pick))
        pick += list(rng.choice(rest, size=min(extra, len(rest)),
                                replace=False))
        dev = self.device
        f64 = lambda t: t.to(torch.float64)
        P0 = f64(self.P0[self.cols])
        prev, new, outs, src = [], [], [], []
        f = self.forcing
        area_c = torch.as_tensor(self.area[self.cols_np], device=dev)
        for i in sorted(int(x) for x in pick):
            k = self.records[i]["k"]
            prev.append(P0 if k == 0 or self.kept[i - 1] is None
                        else f64(self.kept[i - 1]["soilp"]))
            new.append(f64(self.kept[i]["soilp"]))
            outs.append(self.kept[i])
            src.append(ref.sources_kg(f.qflx_infl[k][self.cols],
                                      f.qflx_tran_veg[k][self.cols],
                                      f.rootr[self.cols], area_c))
        n = len(prev)
        soils = {key: np.tile(v[self.cols_np], (n, 1))
                 for key, v in self.soils.items()}
        area = np.tile(self.area[self.cols_np], n)
        system = ref.column_system(soils, self.dz, area, dev, self.seepage)
        P_prev, P_prog = torch.cat(prev), torch.cat(new)
        src = torch.cat(src)
        P_ref, conv, _ = ref.solve(system, P_prev, src, self.dt)
        area_t = torch.as_tensor(area, device=dev)
        zi = torch.as_tensor(self.zi, device=dev).expand(area.size, -1)
        unpacked = ref.unpack(system, P_prog, area_t, zi)
        unpack_gap = 0.0
        for key, want in unpacked.items():
            got = f64(torch.cat([o[key] for o in outs]))
            scale = float(want.abs().max())
            gap = float((got.reshape(want.shape) - want).abs().max())
            unpack_gap = max(unpack_gap, gap / scale if scale > 0 else gap)
        return {
            "p_gap_pa": float((P_prog - P_ref).abs().max()),
            "mass_err_kg": float(ref.audit_kg(system, P_prev, P_prog, src,
                                              self.dt).max()),
            "unpack_rel": unpack_gap,
            "ref_unconverged": int((~conv).sum()),
        }

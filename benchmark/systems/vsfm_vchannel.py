"""MPP's V-catchment problem through the port's compiled VSFM stepper:
``problems/vsfm_vchannel.run_vsfm_vchannel_problem(nz, use_compiled=True,
linear_solver=<plan>)`` in set-up, ``soe.step_dt`` a step.

The standalone driver is the caller: it steps the reference's schedule
(``steps`` of ``dtime_s``), waits for each step, and replays the schedule
from the initial state through ``mpp.restart`` (VSFMMPPRestart).
"""
from __future__ import annotations

import numpy as np
import torch

from reference import vsfm, vsfm_vchannel as ref


class Cell:
    """One plan of the problem.  The seed draws which steps the reference
    follows; the problem itself is the reference's, the same for every
    seed.  ``control``: this configuration's control, the reference's own
    solve in f32, stands in the program's answers when they are judged
    (the program has no f32 path for this problem)."""

    def __init__(self, config, params, seed, device, control=False):
        from mpp_tpu_torch.batched import ilu_gmres
        from mpp_tpu_torch.problems import vsfm_vchannel as vch
        if (config["nx"], config["ny"], config["satfunc"],
                config["density"], config["dtype"]) != \
                (ref.NX, ref.NY, "van_genuchten", "TGDPB01", "float64"):
            raise ValueError("the problem is MPP's 20 x 10 V-catchment in "
                             "f64: only nz, dt and the steps vary")
        self.ilu_gmres = ilu_gmres
        self.device = torch.device(device)
        self.nz = int(config["nz"])
        self.dt = float(config["dtime_s"])
        self.dtype = config["dtype"]
        self.day_steps = int(config["steps"])
        self.kinds = [f"step{k + 1}" for k in range(self.day_steps)]
        plan = params["traffic"]["linear_solver"]
        self.mpp = vch.run_vsfm_vchannel_problem(
            nz=self.nz, dtime=self.dt, nstep=0, use_compiled=True,
            linear_solver=plan, device=self.device)
        self.comp = self.mpp.soe.step_dt.__self__
        self.ic = ref.initial_pressure(self.nz)
        self.restart = int(config["gmres_restart"])
        self.control = control
        self.check_steps = int(params["check"]["steps"])
        self.records, self.kept = [], []
        self._bad = 0

    def sparsity(self):
        """(rows, stored values) of the system's matrix, from the
        reference's topology: a diagonal and two values a connection."""
        up, _, _ = ref.connections(self.nz)
        n = ref.NX * ref.NY * self.nz
        return n, n + 2 * up.size

    def krylov_shape(self):
        """(systems, rows, restart) of the GMRES solves."""
        return 1, ref.NX * ref.NY * self.nz, self.restart

    def warm(self):
        """One pass of the schedule, then back to the initial state."""
        for k in range(self.day_steps):
            if k == 0:
                self.mpp.restart(self.ic)
            self.mpp.soe.step_dt(self.dt, k + 1)
        self.mpp.restart(self.ic)
        self._bad = self.comp.gmres_unconverged()

    def step(self, i):
        """Step i of the replayed schedule; waits for it (the stepper
        brings the state back to the host).  Returns its counters."""
        k = i % self.day_steps
        soe, comp = self.mpp.soe, self.comp
        if k == 0:
            self.mpp.restart(self.ic)
        its0, syncs0 = soe.cumulative_newton_iterations, comp.host_syncs
        calls0 = dict(self.ilu_gmres.CARD_CALLS)
        ok, reason = soe.step_dt(self.dt, k + 1)
        rec = dict(k=k, kind=self.kinds[k],
                   newton_iters=soe.cumulative_newton_iterations - its0,
                   host_syncs=comp.host_syncs - syncs0,
                   arnoldi_steps=(self.ilu_gmres.CARD_CALLS["arnoldi"]
                                  - calls0["arnoldi"]))
        # every GMRES solve converged (a cumulative count on the stepper)
        bad = comp.gmres_unconverged()
        rec["ok"] = bool(ok) and bad == self._bad
        self._bad = bad
        self.records.append(rec)
        self.kept.append(np.array(soe.soln, np.float64))
        return rec

    def settle(self):
        return sum(not r["ok"] for r in self.records)

    def release(self):
        self.mpp = self.comp = None

    def _sample(self, rng):
        """Steps the reference follows: one of each step of the schedule
        (the first pass that has it, or a seeded one), the one of most
        Newton iterations, seeded ones up to ``check.steps``."""
        done = list(range(len(self.records)))
        if not done:
            return []
        pick = {max(done, key=lambda i: self.records[i]["newton_iters"])}
        for k in range(self.day_steps):
            have = [i for i in done if self.records[i]["k"] == k]
            if have:
                pick.add(int(rng.choice(have)))
        rest = [i for i in done if i not in pick]
        extra = max(0, self.check_steps - len(pick))
        pick |= {int(i) for i in rng.choice(rest, size=min(extra, len(rest)),
                                           replace=False)}
        return sorted(pick)

    def _prev(self, i):
        return self.ic if self.records[i]["k"] == 0 else self.kept[i - 1]

    def judge(self, rng):
        """The largest gap [Pa] between the program's pressures and the
        reference's f64 solve of the same step from the same state, over
        the sampled steps.  With ``control`` the reference's solve in f32
        (30 iterations at most: f32 stalls at its rounding floor) stands in
        the program's place."""
        control = self.control
        steps = self._sample(rng)
        if not steps:
            return None
        system = ref.system(self.nz, self.device)
        system32 = system.to(torch.float32) if control else None
        gap, unconverged = 0.0, 0
        for i in steps:
            P_prev = torch.as_tensor(self._prev(i), device=self.device)[None]
            P_ref, conv, _ = vsfm.newton(system, P_prev, self.dt,
                                         torch.zeros_like(P_prev),
                                         chunk=1000)
            if control:
                got = vsfm.newton(system32, P_prev.float(), self.dt,
                                  torch.zeros_like(P_prev).float(),
                                  chunk=1000, max_it=30)[0][0].double()
            else:
                got = torch.as_tensor(self.kept[i], device=self.device)
            gap = max(gap, float((got - P_ref[0]).abs().max()))
            unconverged += int((~conv).sum())
        return {"p_gap_pa": gap, "ref_unconverged": unconverged}

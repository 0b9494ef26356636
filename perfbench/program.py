"""The system under test, driven through its public entries only.

The only module of the benchmark that imports the port (``repro_torch``):
it builds the run of a configuration (``make_run``, or ``make_fleet_run``
with the router the configuration names), the batch's policies, and the
arrival streams the benchmark hands it, and runs a calibration-stage batch
through ``run_keyed_batch`` with ``record_decisions=True``. The policy kind
(``repro_torch.core.<policy>``), the name of its parameter and the router
(``repro_torch.sim.<router>``) are found by the names in the traffic and
configuration files. Outputs come back as plain tensors in the reference's
terms (``[R, C, ...]``).
"""
from __future__ import annotations

from typing import Optional

import torch

BELIEF = ("mu_a", "mu_b", "lam_a", "lam_b", "sig_a", "sig_b")
PRIORS = ("mu_shape", "mu_rate", "lam_shape", "lam_rate", "sig_shape",
          "sig_rate", "delta", "nu")


class Program:
    """The run of one configuration and the traffic's policy kind on
    ``device``, cut to ``steps`` steps (the configuration's horizon by
    default)."""

    def __init__(self, config: dict, traffic, device,
                 steps: Optional[int] = None, grid: torch.Tensor = None):
        import repro_torch.core as core
        import repro_torch.sim as sim

        self.device = torch.device(device)
        self.config = config
        self.kind = getattr(core, traffic.policy)
        self.theta = traffic.theta
        dt = float(config["dt"])
        hours = (config["horizon_hours"] if steps is None
                 else float(steps) * dt)
        base = dict(arrival_rate=float(config["arrival_rate"]),
                    horizon_hours=hours, dt=dt,
                    max_slots=int(config["max_slots"]),
                    max_arrivals=int(config["max_arrivals"]),
                    d_points=int(config["d_points"]),
                    agg_refresh_steps=int(config["agg_refresh_steps"]),
                    priors=core.PopulationPriors(**{
                        k: float(config["priors"][k]) for k in PRIORS}))
        # one grid tensor on the device for every run built from it: the
        # kernels derive its interpolation once
        self.grid = grid if grid is not None else torch.tensor(
            config["grid"]["points"], dtype=torch.float32, device=self.device)
        self.fleet = "capacities" in config
        if self.fleet:
            self.capacities = tuple(float(c) for c in config["capacities"])
            fcfg = sim.make_fleet_config(self.capacities, **base)
            self.run = sim.make_fleet_run(
                fcfg, self.grid, self.kind,
                router=getattr(sim, config["router"])(),
                record_decisions=True, device=self.device)
        else:
            self.capacities = (float(config["capacity"]),)
            cfg = sim.make_config(capacity=self.capacities[0], **base)
            self.run = sim.make_run(cfg, self.grid, self.kind,
                                    record_decisions=True,
                                    device=self.device)

    def policy(self, thetas: torch.Tensor):
        """One policy a run: [R] values of the traffic's parameter (rho for
        SECOND; the threshold, a fleet's total, for ZEROTH)."""
        from repro_torch.core import fleet_policy, make_policy

        if self.fleet:
            return fleet_policy(self.kind, capacities=self.capacities,
                                device=self.device, **{self.theta: thetas})
        return make_policy(self.kind, capacity=self.capacities[0],
                           device=self.device, **{self.theta: thetas})

    def stream(self, s: dict):
        """The port's ``ArrivalStream`` of a batch's streams ([R, T, A]
        leaves, ``n`` [R, T])."""
        from repro_torch.core import DeploymentParams, GammaBelief
        from repro_torch.sim import ArrivalStream

        bel = GammaBelief(*(s[f] for f in BELIEF))
        # outside the mixture modes the second component is the prior
        prior = GammaBelief(*(torch.full_like(s["mu_a"], float(
            self.config["priors"][k])) for k in PRIORS[:6]))
        return ArrivalStream(
            params=DeploymentParams(lam=s["lam"], mu=s["mu"], sig=s["sig"]),
            c0=s["c0"], bel=bel, bel_alt=prior,
            n_arrivals=s["n"].to(torch.int32))

    def run_batch(self, seeds, thetas, streams: dict) -> dict:
        """One batch: run r on ``seeds[r]`` with ``thetas[r]`` and stream
        r. Returns the outputs as [R, C, ...] tensors on the device."""
        from repro_torch.sim import run_keyed_batch

        out = run_keyed_batch(self.run, list(seeds), self.policy(thetas),
                              streams=self.stream(streams),
                              devices=[self.device])
        if self.fleet:
            m, accept, assign = out
            pc = m.per_cluster
            res = {f: getattr(pc, f) for f in
                   ("total_requests", "failed_requests", "slot_overflow",
                    "n_departed", "alive_end")}
            res["arrivals_accepted"] = pc.arrivals_accepted
            res["arrivals_rejected"] = pc.arrivals_rejected
            res["utilization"] = pc.utilization
            res["fleet_utilization"] = m.utilization
            res["util_trace"] = pc.util_trace
            res["fail_trace"] = pc.fail_trace
            res["rejected_by_all"] = m.rejected_by_all
            res["accept"] = accept
            res["assign"] = assign
            return res
        m, accept = out
        res = {f: getattr(m, f)[:, None] for f in
               ("total_requests", "failed_requests", "arrivals_accepted",
                "arrivals_rejected", "slot_overflow", "n_departed",
                "alive_end", "utilization")}
        res["util_trace"] = m.util_trace[:, None]
        res["fail_trace"] = m.fail_trace[:, None]
        res["accept"] = accept[:, :, None]
        return res

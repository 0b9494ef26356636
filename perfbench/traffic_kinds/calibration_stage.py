"""Traffic kind ``calibration_stage``: batches of a calibration stage.

A traffic file of this kind (``perfbench/traffic/<name>.json``) gives the
stage: the policy kind (``policy``, the system's name for it, such as
``SECOND``), the name of the policy's parameter (``theta``: ``rho`` or
``threshold``), its candidate values ``thetas`` (float32 numbers), and the
seeds a candidate is run on (``seeds_per_theta``). A batch holds every
(theta, seed) pair, theta-major, as the system's calibration flattens its
grid: run ``t * seeds + r`` is theta ``t`` on run seed ``r``, and the runs
of one seed share its arrival stream whatever their theta (common random
numbers). Batch ``b`` of seed ``s`` takes its stream generator's seed and
its run seeds from ``numpy.random.SeedSequence([s, b])``; the streams are
drawn on the device from the configuration's priors (Table 1):

  * arrivals a step ~ Poisson(rate dt), capped at ``max_arrivals``;
  * each arrival's (lam, mu, sig) ~ Gamma(shape) / rate, C0 ~ 1 +
    Poisson(sig);
  * its prior belief is the population prior after observing C0 (a size
    observation: sig_a + C0 - 1, sig_b + 1).
"""
from __future__ import annotations

import numpy as np
import torch

F32 = torch.float32


class CalibrationStage:
    """Batches of one calibration stage of ``traffic`` for ``config``."""

    def __init__(self, config: dict, traffic: dict, device):
        self.config = config
        self.device = torch.device(device)
        self.policy = traffic["policy"]
        self.theta = traffic["theta"]
        self.thetas = [float(np.float32(x)) for x in traffic["thetas"]]
        self.per_theta = int(traffic["seeds_per_theta"])
        self.runs = len(self.thetas) * self.per_theta
        self.clusters = len(config.get("capacities", [0]))
        self.steps = int(round(config["horizon_hours"] / config["dt"]))

    def batch(self, seed: int, batch: int, steps: int = None):
        """(run seeds [R], thetas [R] float32 tensor, streams [R, T, A]) of
        one batch: every theta on the batch's seeds and streams."""
        steps = self.steps if steps is None else steps
        ss = np.random.SeedSequence([int(seed), int(batch)])
        words = [int(w >> np.uint64(1)) for w in
                 ss.generate_state(1 + self.per_theta, np.uint64)]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(words[0])
        cfg, p = self.config, self.config["priors"]
        a_max = int(cfg["max_arrivals"])
        shape = (self.per_theta, steps, a_max)
        full = lambda shp, v: torch.full(shp, float(v), dtype=F32,
                                         device=self.device)
        rate = full(shape[:2], cfg["arrival_rate"] * cfg["dt"])
        n = torch.clamp(torch.poisson(rate, generator=gen), max=a_max)
        gamma = lambda k: torch._standard_gamma(full(shape, p[k]),
                                                generator=gen)
        lam = gamma("lam_shape") / p["lam_rate"]
        mu = gamma("mu_shape") / p["mu_rate"]
        sig = gamma("sig_shape") / p["sig_rate"]
        c0 = 1.0 + torch.poisson(sig, generator=gen)
        s = {"n": n.to(torch.int32), "lam": lam, "mu": mu, "sig": sig,
             "c0": c0, "mu_a": full(shape, p["mu_shape"]),
             "mu_b": full(shape, p["mu_rate"]),
             "lam_a": full(shape, p["lam_shape"]),
             "lam_b": full(shape, p["lam_rate"]),
             "sig_a": full(shape, p["sig_shape"]) + (c0 - 1.0),
             "sig_b": full(shape, p["sig_rate"]) + 1.0}
        seeds, n_t = words[1:], len(self.thetas)
        thetas = torch.tensor(self.thetas, dtype=F32, device=self.device)
        return (seeds * n_t, thetas.repeat_interleave(self.per_theta),
                {k: v.repeat((n_t,) + (1,) * (v.ndim - 1))
                 for k, v in s.items()})

    def work(self) -> int:
        """Cluster-steps a batch simulates."""
        return self.runs * self.clusters * self.steps


def make(config: dict, traffic: dict, device) -> CalibrationStage:
    return CalibrationStage(config, traffic, device)

"""What decides ``correct``: the window's runs judged by the plain reference.

After the window, a sample of the runs it completed, drawn from the seed
(``judged_per_theta`` runs of every theta, each from a batch and a seed
drawn uniformly), is replayed by ``reference.sim.simulate`` in float64 on
the system's own decisions and routes. The numbers compared, each against
the cell's limit:

  * ``flip_share``: the share of the judged decisions that lie on the other
    side of the policy's rule as the reference computes it;
  * ``route_gap`` (a fleet): how far the load fraction of the cluster the
    router chose lies above the least one;
  * ``count_gap``: the largest relative difference of the integer outputs
    (each step's active cores and failed requests, requests, failures,
    accepted, rejected, overflow, departed, alive at the end, rejected by
    all): exact, limit 0;
  * ``util_gap``: the largest relative difference of a utilization (the
    system accumulates core-hours in float32).

The widest relative margin of a decision on the other side,
``decision_gap``, is reported beside them and not compared: the system's
float32 curves lose digits to the cancellation of lgamma(a + p) -
lgamma(a) for slots with many observed core deaths, so a sound run's
widest margin comes near the control's (PERF.md).
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import sim as ref

COUNTS = ref.FIELDS


def judged_runs(seed: int, n_batches: int, n_thetas: int, per_theta: int,
                judged_per_theta: int) -> list:
    """[(batch, run)] of the sample, drawn from the seed."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x6A75]))
    out = []
    for t in range(n_thetas):
        for _ in range(judged_per_theta):
            b = int(rng.integers(n_batches))
            r = int(rng.integers(per_theta))
            out.append((b, t * per_theta + r))
    return out


def gather(traffic, seed: int, outputs: list, picks: list, device):
    """The judged runs' inputs and the system's outputs: (seeds, thetas,
    streams [k, T, A], outputs [k, ...])."""
    by_batch = {}
    for b, r in picks:
        by_batch.setdefault(b, []).append(r)
    seeds, thetas, streams, outs = [], [], [], []
    for b, runs in sorted(by_batch.items()):
        s_b, th_b, st_b = traffic.batch(seed, b)
        idx = torch.tensor(runs, device=device)
        seeds += [s_b[r] for r in runs]
        thetas.append(th_b[idx])
        streams.append({f: v[idx] for f, v in st_b.items()})
        outs.append({f: (v[idx.to(v.device)] if torch.is_tensor(v) else v)
                     for f, v in outputs[b].items()})
    cat = lambda xs: {f: torch.cat([x[f] for x in xs]) for f in xs[0]
                      if xs[0][f] is not None}
    return seeds, torch.cat(thetas), cat(streams), cat(outs)


def readings(out: dict, judge: dict, fleet: bool) -> dict:
    """The numbers compared, from the system's (or the control's) outputs
    and the judge's replay of them."""
    rel = lambda a, b: float(torch.max(torch.abs(a.double() - b.double())
                                       / torch.clamp(torch.abs(b.double()),
                                                     min=1.0)))
    count = max(rel(out[f], judge[f]) for f in
                COUNTS + ("util_trace", "fail_trace"))
    if fleet:
        count = max(count, rel(out["rejected_by_all"],
                               judge["rejected_by_all"]))
    util = float(torch.max(torch.abs(out["utilization"].double()
                                     - judge["utilization"])
                           / torch.clamp(judge["utilization"], min=1e-12)))
    res = {"flip_share": judge["flips"] / max(judge["decisions"], 1)}
    if fleet:
        res["route_gap"] = judge["route_gap"]
    res["count_gap"] = count
    res["util_gap"] = util
    return res


def judge(setting, kind: str, seeds, thetas, streams: dict, out: dict,
          device) -> dict:
    """The reference's float64 replay of ``out``'s decisions."""
    forced = {"accept": out["accept"].to(device)}
    if out.get("assign") is not None:
        forced["assign"] = out["assign"].to(device)
    return ref.simulate(setting, streams, seeds, kind, thetas, forced=forced,
                        dtype=torch.float64, device=device)


def verdict(values: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): each number within its limit."""
    rows = [(k, v, limits[k]) for k, v in values.items()]
    ok = all(v is not None and np.isfinite(v) and v <= lim
             for _, v, lim in rows)
    return ok, rows

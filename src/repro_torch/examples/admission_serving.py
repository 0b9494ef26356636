"""The integrated story: the paper's admission controller gating elastic
model-serving jobs on a cluster of accelerators.

Jobs (deployments) are serving fleets; their chip usage scales
stochastically (replica scale-outs). A cluster under the baseline threshold
policy must hold large idle reserves; the second-moment policy admits more
jobs at the same scale-out SLA. Also demonstrates the §7 variance-based
pricing rule: labeled workloads are cheaper for the user and better for
utilization (Prop. 4).

The first section closes the loop live: a continuous-batching
``ServeEngine`` (reduced llama3.2-1b, weights from a seed) sits behind the
online ``OnlineAdmissionEngine``; jobs the policy admits submit their
inference requests into the shared decode loop, rejected jobs never touch
it.

    python -m repro_torch.examples.admission_serving [--smoke] [--device cpu]

The port's counterpart of the JAX package's
``examples/admission_serving.py``, on ``--device`` (the card by default).
The admission engine's rho is the tuned operating point of
``BENCH_quick.json`` (or ``$REPRO_BENCH_JSON``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import (AZURE_PRIORS, SECOND, belief_from_prior, geometric_grid,
                    make_policy)
from ..core.belief import apply_pseudo_observations
from ..core.moments import MomentCurves, moment_curves
from ..core.pricing import mixture_moments, payment, variance_estimate
from ..core.processes import sample_params, sample_pseudo_observations
from ..sim import MIX_LABELED, MIX_UNLABELED, SimConfig, make_run, split_seeds
from . import parse_args


def utilization(prior_mode, rho, *, smoke: bool, device, seed=0):
    """Mean utilization of 3 runs of the second moment policy (Def. 4's
    heuristic) with two job types, 5 observations of each."""
    days = 30 if smoke else 120
    cfg = SimConfig(capacity=1_000.0, arrival_rate=0.05,
                    horizon_hours=days * 24.0, dt=24.0, max_slots=256,
                    max_arrivals=4, priors=AZURE_PRIORS,
                    prior_mode=prior_mode, n_pseudo_obs=5)
    grid = geometric_grid(cfg.dt, cfg.horizon_hours * 3, 24)
    pol = make_policy(SECOND, rho=rho, capacity=cfg.capacity, marginal=True)
    run = make_run(cfg, grid, SECOND, device=device)
    m = run(split_seeds(seed, 3), pol)
    return float(m.utilization.mean())


def serve_live(*, smoke: bool, device, seed=0):
    """Gate a real decode loop end to end: the online admission engine
    decides which jobs may enter the continuous-batching ServeEngine."""
    from ..models import build_model, get_config, reduced_config
    from ..serve import (Arrival, OnlineAdmissionEngine, Request,
                         ServeEngine, default_policy_param)

    n_ticks = 4 if smoke else 12
    cfg = SimConfig(capacity=64.0, arrival_rate=0.2,
                    horizon_hours=n_ticks * 12.0, dt=12.0, max_slots=32,
                    max_arrivals=4, priors=AZURE_PRIORS)
    grid = geometric_grid(cfg.dt, cfg.horizon_hours * 3, 16)
    rho = default_policy_param("second", cfg.capacity)
    adm = OnlineAdmissionEngine(
        cfg, grid, SECOND, make_policy(SECOND, rho=rho,
                                       capacity=cfg.capacity),
        device=device)

    mcfg = reduced_config(get_config("llama3.2-1b"))
    model = build_model(mcfg)
    params = model.init(torch.Generator().manual_seed(seed), device=device)
    srv = ServeEngine(model, params, max_batch=4, max_seq=48)

    rng = np.random.default_rng(seed)
    tick_gen, job_gen = (torch.Generator(device=adm.device).manual_seed(s)
                         for s in split_seeds(seed, 2))
    admitted = rejected = tokens = rid = 0
    for _ in range(n_ticks):
        adm.tick(gen=tick_gen)
        n_new = int(rng.poisson(cfg.arrival_rate * cfg.dt))
        futs = [adm.submit(Arrival.draw(job_gen, cfg))
                for _ in range(min(n_new, cfg.max_arrivals))]
        adm.flush()
        for fut in futs:
            if fut.result():
                admitted += 1
                prompt = rng.integers(2, mcfg.vocab, 5).astype(np.int32)
                srv.submit(Request(rid=rid, prompt=prompt, max_new_tokens=6))
                rid += 1
            else:
                rejected += 1
        tokens += sum(len(r.out_tokens) for r in srv.run_until_drained())
    m = adm.metrics()
    print(f"{n_ticks} windows: admitted={admitted} rejected={rejected} "
          f"decode_tokens={tokens}")
    print(f"cluster util={float(m.utilization):.3f} "
          f"scaleout_failures={int(m.failed_requests)}"
          f"/{int(m.total_requests)}")


def section7_fees(types, obs) -> tuple[float, float]:
    """§7's hourly fees of a user with two job types of 4 cores each,
    ``types`` (``DeploymentParams`` [2]) and their pseudo observations
    ``obs`` (``PseudoObservations`` [2], on the same device): the mean fee
    labeled (each type priced by its own posterior variance) and the fee
    unlabeled (priced by the two types' mixture)."""
    device = types.lam.device
    grid = geometric_grid(24.0, 8760.0, 24, device=device)
    prior = belief_from_prior(AZURE_PRIORS, (2,), device=device)
    bels = apply_pseudo_observations(prior, obs, AZURE_PRIORS)
    cores = torch.tensor([4.0, 4.0], device=device)
    per_type = moment_curves(bels, cores, grid, AZURE_PRIORS)
    mix = mixture_moments((0.5, 0.5), per_type)

    var_labeled = variance_estimate(per_type)        # [2]
    var_mix = variance_estimate(MomentCurves(mix.EL[None], mix.VL[None]))[0]
    pay_labeled = 0.5 * (payment(cores[0], var_labeled[0])
                         + payment(cores[1], var_labeled[1]))
    pay_mix = payment(cores[0], var_mix)
    return float(pay_labeled), float(pay_mix)


def main(argv=None):
    args = parse_args(__doc__, argv)
    print("== live: online admission gating a ServeEngine decode loop ==")
    serve_live(smoke=args.smoke, device=args.device)

    print("\n== admission control for an elastic serving fleet ==")
    u_lab = utilization(MIX_LABELED, 0.15, smoke=args.smoke,
                        device=args.device)
    u_unl = utilization(MIX_UNLABELED, 0.15, smoke=args.smoke,
                        device=args.device)
    print(f"second-moment policy, labeled job types:   util={u_lab:.3f}")
    print(f"second-moment policy, unlabeled (mixture): util={u_unl:.3f}")

    print("\n== §7 variance-based pricing: why users label ==")
    gen = torch.Generator(device=args.device).manual_seed(1)
    types = sample_params(gen, AZURE_PRIORS, (2,))
    obs = sample_pseudo_observations(gen, types, AZURE_PRIORS, 5)
    pay_labeled, pay_mix = section7_fees(types, obs)
    print(f"avg hourly fee labeled:  {pay_labeled:.2f}")
    print(f"hourly fee unlabeled:    {pay_mix:.2f}")
    print("labeling is the dominant strategy (Prop. 4): "
          f"{pay_labeled <= pay_mix + 1e-6}")


if __name__ == "__main__":
    main()

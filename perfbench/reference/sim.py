"""Plain reference of the admission simulator (paper §2, §4, §5.2), in torch.

One step of dt hours over a fixed slot table, for each table (a cluster of a
run; a fleet run has one table a cluster):

  1. events: each alive core dies w.p. 1 - exp(-mu dt) (binomial thinning),
     the deployment shuts down w.p. 1 - exp(-delta mu dt), it asks for
     Poisson(lam mu^nu dt) scale-outs of 1 + Poisson(sig) cores each;
  2. deaths, then scale-outs granted against the capacity in slot order
     while they fit (a request that does not fit fails whole);
  3. conjugate belief updates from what was observed;
  4. the step's arrivals: routed by the fleet's router (a fleet), then
     admitted first come first served by the policy against the maintained
     aggregate curves, and placed, the i-th accepted in the i-th free slot.

The aggregate curves of a table are recomputed from its alive slots every
``refresh`` steps, before the step's events, and between refreshes each
placed arrival's curves are added to them (at most as many as there are free
slots, in arrival order). The policy's rule is found by its name, the
system's, in ``policies/<name>.py`` (``ZEROTH``, ``SECOND``), a fleet's
router in ``routers/<name>.py``; every policy admits only if util + c0 fits
the capacity.

The events of table i are drawn with torch's own samplers from the
generator of that table, in the order binomial, bernoulli, poisson, poisson
a step, on float32 rows computed as the system states them: a run's first
table draws from a generator seeded with the run's seed, table c > 0 from
one seeded with ``seed_word(seed, c)``. Given the same decisions the events
are then the same as the system's, so the reference can follow a run's
decisions (``forced``) and judge each one by its own arithmetic.

``simulate(..., forced=outputs)`` is the judge: it takes the decisions and
routes given, and reports by how much each one lies on the wrong side of
its own rule. ``forced=None`` runs free, making its own decisions: in
bfloat16 that is the control put in the system's place.
"""
from __future__ import annotations

import functools
import importlib.util
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from .curves import curves

F32 = torch.float32
AGG_BLOCK = 8192        # alive rows a block of the aggregate's sum
FIELDS = ("total_requests", "failed_requests", "arrivals_accepted",
          "arrivals_rejected", "slot_overflow", "n_departed", "alive_end")


class Setting(NamedTuple):
    """What a configuration fixes, as plain numbers."""

    capacities: tuple       # per cluster (one for a single cluster)
    slots: int              # per cluster
    arrivals: int           # at most a step (fleet-wide)
    steps: int
    dt: float
    refresh: int
    grid: tuple             # horizon grid, hours
    nd: int                 # D-term checkpoints
    priors: dict            # Table 1: shapes, rates, delta, nu
    router: Optional[str]   # a fleet's router, by the system's name


def setting(config: dict, steps: Optional[int] = None) -> Setting:
    """The ``Setting`` of a configuration file's dict; ``steps`` cuts the
    horizon shorter."""
    caps = tuple(float(c) for c in config.get("capacities",
                                               [config["capacity"]]))
    n = int(round(config["horizon_hours"] / config["dt"]))
    return Setting(capacities=caps, slots=int(config["max_slots"]),
                   arrivals=int(config["max_arrivals"]),
                   steps=n if steps is None else int(steps),
                   dt=float(config["dt"]),
                   refresh=int(config["agg_refresh_steps"]),
                   grid=tuple(config["grid"]["points"]),
                   nd=int(config["d_points"]), priors=config["priors"],
                   router=config.get("router"))


@functools.lru_cache(maxsize=None)
def named(folder: str, name: str):
    """The module ``<folder>/<name>.py`` beside this file: a policy's rule
    (``policies``) or a router (``routers``), found by name."""
    path = Path(__file__).resolve().parent / folder / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"perfbench: no reference for {folder} {name!r}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_reference_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def seed_word(seed: int, c: int) -> int:
    """Seed of table c > 0 of a run: the first 64-bit word of
    ``numpy.random.SeedSequence([seed, c])`` shifted right by one bit."""
    word = np.random.SeedSequence([int(seed), int(c)]).generate_state(
        1, np.uint64)[0]
    return int(word >> np.uint64(1))


def generators(seeds, n_clusters: int, device) -> list:
    """One generator a table, run-major."""
    out = []
    for s in seeds:
        for c in range(n_clusters):
            g = torch.Generator(device=device)
            g.manual_seed(int(s) if c == 0 else seed_word(s, c))
            out.append(g)
    return out


def draw_events(gens, lam, mu, sig, cores, alive, p: dict, dt: float):
    """One step's events of every table ([n, S] float32 rows), table i's
    from ``gens[i]`` on its own row."""
    rows = lambda fn, *xs: torch.stack(
        [fn(*(x[i] for x in xs), g) for i, g in enumerate(gens)])
    alive_f = alive.to(F32)
    n = cores.to(F32) * alive_f
    p_die = -torch.expm1(-mu * dt)
    deaths = rows(lambda c, q, g: torch.binomial(c, q, generator=g), n, p_die)
    delta, nu = p["delta"], p["nu"]
    p_spont = -torch.expm1(-delta * mu * dt)
    spont = rows(lambda q, g: torch.bernoulli(q, generator=g),
                 p_spont).to(torch.bool)
    # on the CPU an element's rounding of a power depends on its place in
    # the tensor, so take it row by row there, as one row alone is taken
    mu_nu = (mu ** nu if mu.device.type != "cpu"
             else rows(lambda m, g: m ** nu, mu))
    poisson = lambda r, g: torch.poisson(r, generator=g)
    n_so = rows(poisson, lam * mu_nu * dt * alive_f)
    extra = rows(poisson, n_so * sig)
    return deaths, spont, n_so, n_so + extra


class _Tables(NamedTuple):
    alive: torch.Tensor
    cores: torch.Tensor
    lam: torch.Tensor
    mu: torch.Tensor
    sig: torch.Tensor
    bel: tuple


def _prior_belief(p: dict, shape, fdt, device) -> tuple:
    full = lambda v: torch.full(shape, float(v), dtype=fdt, device=device)
    return (full(p["mu_shape"]), full(p["mu_rate"]), full(p["lam_shape"]),
            full(p["lam_rate"]), full(p["sig_shape"]), full(p["sig_rate"]))


def _aggregate(tab: _Tables, st: Setting, grid, fdt):
    """Sum of the alive slots' curves of each table: [n, N]."""
    n_tab = tab.alive.shape[0]
    el = torch.zeros(n_tab, len(st.grid), dtype=fdt, device=grid.device)
    vl = torch.zeros_like(el)
    alive = tab.alive.nonzero(as_tuple=True)
    for i in range(0, alive[0].numel(), AGG_BLOCK):
        rows = tuple(x[i:i + AGG_BLOCK] for x in alive)
        bel = tuple(x[rows] for x in tab.bel)
        e, v = curves(bel, tab.cores[rows], grid, st.priors["nu"],
                      st.priors["delta"], st.nd)
        el.index_add_(0, rows[0], e.to(fdt))
        vl.index_add_(0, rows[0], v.to(fdt))
    return el, vl


def _decide(rule, agg_el, agg_vl, util, cel, cvl, c0, valid, cap, theta,
            forced, room):
    """First come first served admission of a table's candidates ([n, A]);
    returns (accept, agg_el, agg_vl, gap [n], wrong count)."""
    n, a_max = c0.shape
    gap = torch.zeros(n, dtype=torch.float64, device=c0.device)
    wrong_n = torch.zeros((), dtype=torch.int64, device=c0.device)
    accepts, states = [], [(agg_el, agg_vl)]
    for i in range(a_max):
        ci = c0[:, i]
        fits = util + ci <= cap
        el = vl = None
        if rule.CURVES:
            el, vl = agg_el + cel[:, i], agg_vl + cvl[:, i]
        ok, v = rule.rule(util, ci, theta, cap, el, vl)
        ref = ok & fits & valid[:, i]
        acc = ref if forced is None else forced[:, i]
        wrong = acc != ref
        exact = ~valid[:, i] | ~fits
        if v is None:
            g = wrong.to(torch.float64)
        else:
            g = torch.where(exact, torch.ones_like(gap),
                            torch.abs(v).to(torch.float64)) * wrong
        gap = torch.maximum(gap, g)
        wrong_n = wrong_n + wrong.sum()
        if rule.CURVES:
            agg_el = torch.where(acc[:, None], agg_el + cel[:, i], agg_el)
            agg_vl = torch.where(acc[:, None], agg_vl + cvl[:, i], agg_vl)
            states.append((agg_el, agg_vl))
        util = torch.where(acc, util + ci, util)
        accepts.append(acc)
    accept = torch.stack(accepts, dim=-1)
    if rule.CURVES:
        # the aggregate keeps only the accepted arrivals that find a slot
        k = torch.sum(torch.cumsum(accept.to(torch.int64), -1)
                      <= room[:, None], -1)
        at = k[:, None, None].expand(n, 1, agg_el.shape[-1])
        agg_el, agg_vl = (torch.stack(x, dim=-2).gather(-2, at).squeeze(-2)
                          for x in zip(*states))
    return accept, agg_el, agg_vl, gap, wrong_n


def _place(tab: _Tables, accept, new: dict):
    """The i-th accepted arrival into the i-th free slot; returns (tables,
    accepted arrivals that found a slot, overflow count [n])."""
    free = ~tab.alive
    rank = torch.cumsum(free.to(torch.int64), -1)
    acc = accept.to(torch.int64)
    ordinal = torch.cumsum(acc, -1) * acc
    placed_arrival = accept & (ordinal <= rank[:, -1:])
    overflow = torch.sum(accept & ~placed_arrival, dim=-1)
    hit = (free[:, None, :] & (rank[:, None, :] == ordinal[:, :, None])
           & accept[:, :, None])
    placed = torch.any(hit, dim=-2)
    arange = torch.arange(accept.shape[-1], device=accept.device)
    src = torch.sum(hit.to(torch.int64) * arange[:, None], dim=-2)
    merge = lambda old, x: torch.where(placed, torch.gather(
        x.to(old.dtype), -1, src), old)
    tab = _Tables(alive=tab.alive | placed,
                  cores=merge(tab.cores, new["c0"]),
                  lam=merge(tab.lam, new["lam"]), mu=merge(tab.mu, new["mu"]),
                  sig=merge(tab.sig, new["sig"]),
                  bel=tuple(merge(o, x) for o, x in zip(tab.bel, new["bel"])))
    return tab, placed_arrival, overflow


def simulate(st: Setting, streams: dict, seeds, kind: str, theta, *,
             forced: Optional[dict] = None, dtype=torch.float64,
             device="cpu") -> dict:
    """Run (``forced=None``) or judge k runs.

    ``streams``: ``lam``, ``mu``, ``sig``, ``c0`` and the six belief fields
    (``mu_a`` ... ``sig_b``) [k, T, A] float32, ``n`` [k, T] arrivals;
    ``seeds`` k run seeds; ``kind`` the policy's name; ``theta`` [k] its
    parameter (rho for SECOND, the fleet-total threshold for ZEROTH).
    ``forced``: the system's ``accept`` [k, T, C, A] and, for a fleet,
    ``assign`` [k, T, A].

    Returns the outputs in the system's terms (``accept``, ``assign``,
    ``util_trace`` and ``fail_trace`` [k, C, T], ``core_hours`` and each of
    ``FIELDS`` [k, C], ``rejected_by_all`` [k]) and the judge's readings:
    ``decision_gap`` (the widest relative margin by which a decision lies on
    the wrong side of the rule; 1 for an exact rule broken; and by run,
    ``gap_by_run``), ``decisions`` and ``flips`` (decisions on the wrong
    side), and ``route_gap`` (a fleet: how far the chosen cluster's load
    fraction lies above that of the router's own pick).
    """
    device = torch.device(device)
    fdt = cdt = dtype
    p = st.priors
    k = len(seeds)
    n_c = len(st.capacities)
    n_tab, s_n, a_n, t_n = k * n_c, st.slots, st.arrivals, st.steps
    caps = torch.tensor(st.capacities, dtype=torch.float64, device=device)
    cap_t = caps.repeat(k).to(cdt)                              # [n]
    theta = torch.as_tensor(theta, dtype=torch.float64, device=device)
    share = caps / caps.sum()
    rule = named("policies", kind)
    router = named("routers", st.router) if n_c > 1 else None
    part = share if rule.SPLIT else torch.ones_like(share)
    theta_t = (theta[:, None] * part[None, :]).reshape(-1).to(fdt)
    grid = torch.tensor(st.grid, dtype=torch.float64, device=device).to(fdt)
    gens = generators(seeds, n_c, device)
    zeros = lambda dt_=F32: torch.zeros(n_tab, s_n, dtype=dt_, device=device)
    tab = _Tables(alive=torch.zeros(n_tab, s_n, dtype=torch.bool,
                                    device=device),
                  cores=zeros(cdt), lam=zeros(), mu=zeros() + 1.0,
                  sig=zeros(), bel=_prior_belief(p, (n_tab, s_n), fdt, device))
    acc_n = {f: torch.zeros(n_tab, dtype=torch.float64, device=device)
             for f in FIELDS if f != "alive_end"}
    core_hours = torch.zeros(n_tab, dtype=cdt, device=device)
    rej_all = torch.zeros(k, dtype=torch.float64, device=device)
    n_el = len(st.grid)
    agg_el = torch.zeros(n_tab, n_el, dtype=fdt, device=device)
    agg_vl = torch.zeros_like(agg_el)
    util_tr, fail_tr, accepts, assigns = [], [], [], []
    gap = torch.zeros(n_tab, dtype=torch.float64, device=device)
    route_gap = torch.zeros(k, dtype=torch.float64, device=device)
    wrong = torch.zeros((), dtype=torch.int64, device=device)
    arange_a = torch.arange(a_n, device=device)
    arange_c = torch.arange(n_c, device=device)
    dt, nu = st.dt, p["nu"]
    for t in range(t_n):
        if t % st.refresh == 0 and rule.CURVES:
            agg_el, agg_vl = _aggregate(tab, st, grid, fdt)
        # 1-3: events, deaths, grants, belief updates
        d_ev, spont, n_so, so_cores = draw_events(
            gens, tab.lam, tab.mu, tab.sig, tab.cores, tab.alive, p, dt)
        alive_f = tab.alive.to(cdt)
        deaths = torch.minimum(d_ev.to(cdt), tab.cores) * alive_f
        exposure = tab.cores * dt * alive_f
        cores = torch.where(spont & tab.alive, torch.zeros_like(tab.cores),
                            tab.cores - deaths)
        alive = tab.alive & (cores > 0.0)
        departed = torch.sum(tab.alive & ~alive, dim=-1)
        alive_f = alive.to(cdt)
        req = so_cores.to(cdt) * alive_f
        n_req = n_so.to(cdt) * alive_f
        util = torch.sum(cores * alive_f, dim=-1)
        grant = (util[:, None] + torch.cumsum(req, -1)) <= cap_t[:, None]
        cores = cores + torch.where(grant, req, torch.zeros_like(req))
        failed = torch.sum(torch.where(grant, torch.zeros_like(n_req), n_req),
                           dim=-1)
        util = torch.sum(cores * alive_f, dim=-1)
        mu_a, mu_b, lam_a, lam_b, sig_a, sig_b = tab.bel
        mu_a = mu_a + deaths.to(fdt)
        mu_b = mu_b + exposure.to(fdt)
        e_mu_nu = torch.exp(torch.lgamma(mu_a + nu) - torch.lgamma(mu_a)
                            - nu * torch.log(mu_b))
        n_req_f = n_req.to(fdt)
        bel = (mu_a, mu_b, lam_a + n_req_f,
               lam_b + e_mu_nu * (dt * alive_f).to(fdt),
               sig_a + (req.to(fdt) - n_req_f), sig_b + n_req_f)
        tab = tab._replace(alive=alive, cores=cores, bel=bel)

        # 4: the step's arrivals
        valid = arange_a < streams["n"][:, t, None].to(device)     # [k, A]
        step = {f: streams[f][:, t].to(device)
                for f in ("lam", "mu", "sig", "c0", "mu_a", "mu_b", "lam_a",
                          "lam_b", "sig_a", "sig_b")}
        c0 = step["c0"].to(cdt)
        if rule.CURVES:
            rows = tuple(step[f].reshape(-1).to(fdt) for f in
                         ("mu_a", "mu_b", "lam_a", "lam_b", "sig_a", "sig_b"))
            e, v = curves(rows, step["c0"].reshape(-1).to(fdt), grid, nu,
                          p["delta"], st.nd)
            cel = e.view(k, 1, a_n, n_el).expand(k, n_c, a_n, n_el)
            cvl = v.view(k, 1, a_n, n_el).expand(k, n_c, a_n, n_el)
            cel, cvl = (x.reshape(n_tab, a_n, n_el) for x in (cel, cvl))
        else:
            cel = cvl = None
        if n_c > 1:
            u = util.view(k, n_c)
            picks = []
            for i in range(a_n):
                frac = u.to(fdt) / caps.to(fdt)
                ref_c = router.pick(frac)
                use_c = ref_c if forced is None else forced["assign"][:, t, i]
                ok_c = use_c < n_c
                chosen = frac.gather(-1, torch.clamp(use_c, max=n_c - 1)[:, None])
                least = frac.gather(-1, ref_c[:, None])[:, 0]
                g = torch.where(ok_c, (chosen[:, 0] - least).to(
                    torch.float64), torch.ones_like(route_gap))
                route_gap = torch.maximum(route_gap, g * valid[:, i])
                u = u + torch.where((arange_c == use_c[:, None])
                                    & valid[:, i, None], c0[:, i, None],
                                    torch.zeros_like(u))
                picks.append(use_c)
            assign = torch.stack(picks, dim=-1)                   # [k, A]
            rej_all = rej_all + torch.sum(valid & (assign >= n_c), -1)
            mask = valid[:, None, :] & (assign[:, None, :]
                                        == arange_c[None, :, None])
            assigns.append(assign)
        else:
            mask = valid[:, None, :]
        mask = mask.reshape(n_tab, a_n)
        c0_t = c0[:, None, :].expand(k, n_c, a_n).reshape(n_tab, a_n)
        f_t = (None if forced is None
               else forced["accept"][:, t].reshape(n_tab, a_n).to(device))
        room = torch.sum(~tab.alive, dim=-1)
        accept, agg_el, agg_vl, g, w = _decide(
            rule, agg_el, agg_vl, util, cel, cvl, c0_t, mask, cap_t, theta_t,
            f_t, room)
        gap = torch.maximum(gap, g)
        wrong = wrong + w
        new = {f: step[f][:, None, :].expand(k, n_c, a_n).reshape(n_tab, a_n)
               for f in ("lam", "mu", "sig", "c0")}
        new["bel"] = tuple(step[f][:, None, :].expand(k, n_c, a_n).reshape(
            n_tab, a_n) for f in ("mu_a", "mu_b", "lam_a", "lam_b", "sig_a",
                                  "sig_b"))
        tab, _, overflow = _place(tab, accept, new)
        n_acc = torch.sum(accept, dim=-1).to(torch.float64)
        util_end = torch.sum(tab.cores * tab.alive.to(cdt), dim=-1)
        core_hours = core_hours + util_end * dt
        acc_n["total_requests"] += torch.sum(n_req, dim=-1).to(torch.float64)
        acc_n["failed_requests"] += failed.to(torch.float64)
        acc_n["arrivals_accepted"] += n_acc
        acc_n["arrivals_rejected"] += torch.sum(mask, dim=-1) - n_acc
        acc_n["slot_overflow"] += overflow.to(torch.float64)
        acc_n["n_departed"] += departed.to(torch.float64)
        util_tr.append(util_end)
        fail_tr.append(failed)
        accepts.append(accept.view(k, n_c, a_n))
    out = {f: x.view(k, n_c) for f, x in acc_n.items()}
    out["alive_end"] = tab.alive.sum(-1).to(torch.float64).view(k, n_c)
    out["core_hours"] = core_hours.to(torch.float64).view(k, n_c)
    out["utilization"] = out["core_hours"] / (t_n * dt * caps)
    out["util_trace"] = torch.stack(util_tr, -1).to(torch.float64).view(
        k, n_c, t_n)
    out["fail_trace"] = torch.stack(fail_tr, -1).to(torch.float64).view(
        k, n_c, t_n)
    out["accept"] = torch.stack(accepts, dim=1)                  # [k, T, C, A]
    out["assign"] = torch.stack(assigns, dim=1) if assigns else None
    out["rejected_by_all"] = rej_all
    out["decision_gap"] = float(gap.max()) if n_tab else 0.0
    out["gap_by_run"] = gap.view(k, n_c).amax(-1).tolist()
    out["route_gap"] = float(route_gap.max()) if n_c > 1 else None
    out["flips"] = int(wrong)
    out["decisions"] = int(streams["n"].clamp(max=a_n).sum())
    return out

"""The benchmark's run of one cell: set-up, the window, the trace, the check.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``,
``workloads/<cell>.json`` (its configuration and traffic names, the set-up
and trace lengths, the check's sample and limits), ``configs/<config>.json``,
``traffic/<traffic>.json``, the generator of the traffic's ``kind`` in
``traffic_kinds/<kind>.py`` (a ``make(config, traffic, device)``), and one
reader ``metrics/<metric>.py`` a metric, each a ``read(ctx)`` that returns a
number or ``None`` (nothing to read). The program's policy and router, and
the reference's rules for them, are found by the names the traffic and
configuration files give (``program.py``, ``reference/sim.py``).

A run (``run_cell``):

  1. set-up: builds the system's run of the configuration, and runs one
     warm-up batch of the cell's own shape for ``warm_steps`` steps, which
     builds and loads the kernels;
  2. with ``--trace 1``: one batch of ``trace_steps`` steps under the
     profiler;
  3. the window: calibration-stage batches back to back, each drawn from
     the seed and waited for, until ``seconds`` have passed; no batch
     starts after that;
  4. the peak device memory, then the reference's judgement of a sample of
     the window's runs (``check.py``), the metrics, and last the check that
     nothing loaded in the process is JAX or its package.
"""
from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

PB = Path(__file__).resolve().parent
ROOT = PB.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_BATCH, TRACE_BATCH = 2 ** 40, 2 ** 40 + 1


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(name: str) -> SimpleNamespace:
    """A cell's entry, files and metrics, found by name."""
    bench = _json(ROOT / "BENCHMARK.json")
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if not entries:
        raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json")
    w = entries[0]
    cell = _json(PB / "workloads" / f"{name}.json")
    if (cell["config"], cell["traffic"]) != (w["config"], w["traffic"]):
        raise SystemExit(f"perfbench: {name}'s file and BENCHMARK.json name "
                         "different configurations or traffic")
    applies = lambda m: name in m["workloads"] if "workloads" in m else True
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in e2e_names)]
    return SimpleNamespace(
        name=name, entry=w, cell=cell,
        config=_json(PB / "configs" / f"{w['config']}.json"),
        traffic=_json(PB / "traffic" / f"{w['traffic']}.json"),
        end_to_end=e2e, per_layer=per_layer)


def _module(folder: str, name: str):
    """The module ``<folder>/<name>.py`` of the benchmark."""
    path = PB / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The module of ``metrics/<metric>.py``, with its ``read``."""
    return _module("metrics", metric)


def traffic_for(spec, device):
    """The generator of the cell's traffic, by the traffic file's kind."""
    kind = _module("traffic_kinds", spec.traffic["kind"])
    return kind.make(spec.config, spec.traffic, device)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def refuse_forbidden():
    """Ends the run, with no result, if JAX or its package was loaded."""
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"perfbench: modules loaded that must not be: {bad}")


def _sync(device):
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def run_cell(spec, seed: int, seconds: float, trace: bool, *, device="cuda",
             t0: float = None, log=None, program_cls=None) -> dict:
    """One run of the cell; returns the result line's dict."""
    from . import check
    from .reference.sim import setting as ref_setting
    from .trace import busy_us, idle_gaps, profile, top_device_ops

    if program_cls is None:
        from .program import Program as program_cls
    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    device = torch.device(device)
    sync = _sync(device)
    cfg, cell = spec.config, spec.cell
    traffic = traffic_for(spec, device)
    metrics = spec.end_to_end if not trace else spec.per_layer
    readers = {m["name"]: reader(m["name"]) for m in metrics}

    # 1. set-up
    program = program_cls(cfg, traffic, device)
    warm_steps = int(cell["warm_steps"])
    warm = program_cls(cfg, traffic, device, steps=warm_steps,
                       grid=program.grid)
    warm.run_batch(*traffic.batch(seed, WARM_BATCH, steps=warm_steps))
    sync()
    log(f"perfbench: {spec.name} set up in {time.perf_counter() - t0:.2f} s")

    # 2. the traced stretch
    tr = None
    if trace:
        steps = int(cell["trace_steps"])
        inputs = traffic.batch(seed, TRACE_BATCH, steps=steps)
        traced = program_cls(cfg, traffic, device, steps=steps,
                             grid=program.grid)
        tr = profile(lambda: traced.run_batch(*inputs), steps, sync)
        del traced
        log(f"perfbench: traced {steps} steps in {tr.window_s:.2f} s, "
            f"{len(tr.kernels)} kernels")

    # 3. the window
    t_start = time.perf_counter()
    setup_s = t_start - t0
    outputs, spans = [], []
    b = 0
    while True:
        t_b = time.perf_counter()
        out = program.run_batch(*traffic.batch(seed, b))
        sync()
        t_e = time.perf_counter()
        outputs.append(out)
        spans.append((t_b, t_e))
        b += 1
        if t_e - t_start >= seconds:
            break
    log(f"perfbench: window {len(spans)} batches in "
        f"{spans[-1][1] - t_start:.2f} s: "
        + " ".join(f"{e - b:.2f}" for b, e in spans))
    alive = torch.cat([o["alive_end"].float().flatten() for o in outputs])
    util = torch.cat([o["utilization"].float().flatten() for o in outputs])
    log(f"perfbench: window's runs at their end: alive slots "
        f"{float(alive.mean()) / int(cfg['max_slots']):.4f} of the table "
        f"(most {float(alive.max()) / int(cfg['max_slots']):.4f}), "
        f"utilization {float(util.mean()):.4f} "
        f"({float(util.min()):.4f}-{float(util.max()):.4f})")

    # 4. memory, the check, the metrics, imports
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    del program, warm
    if device.type == "cuda":
        torch.cuda.empty_cache()
    st = ref_setting(cfg)
    picks = check.judged_runs(seed, len(outputs), len(traffic.thetas),
                              traffic.per_theta, int(cell["judged_per_theta"]))
    seeds_j, thetas_j, streams_j, out_j = check.gather(
        traffic, seed, outputs, picks, device)
    t_c = time.perf_counter()
    judged = check.judge(st, traffic.policy, seeds_j, thetas_j, streams_j,
                         out_j, device)
    values = check.readings(out_j, judged, traffic.clusters > 1)
    correct, rows = check.verdict(values, cell["limits"])
    log(f"perfbench: judged {len(picks)} runs, {judged['decisions']} "
        f"decisions ({judged['flips']} on the other side) in "
        f"{time.perf_counter() - t_c:.2f} s")

    ctx = SimpleNamespace(setup_s=setup_s, spans=spans,
                          work=traffic.work(), trace=tr, config=cfg,
                          traffic=traffic, cell=cell)
    result_metrics = {}
    for m in metrics:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            result_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct),
              "attempted": traffic.runs * len(outputs),
              "failed": 0 if correct else len(picks),
              "metrics": result_metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = busy_us(tr) / 1e6
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": top_device_ops(tr),
                               "idle_gaps": idle_gaps(tr)}
    result["judged"] = {
        "decisions": judged["decisions"], "flips": judged["flips"],
        "decision_gap": judged["decision_gap"],
        "gap_by_theta": [[float(th), g] for th, g in
                         zip(thetas_j.tolist(), judged["gap_by_run"])]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    refuse_forbidden()
    for k, v, lim in rows:
        log(f"check {k} {v!r} limit {lim!r}")
    return result

"""Kernel and algorithm microbenchmarks.

  * The continuous O(N) moment curves (``core.moments.moment_curves``, the
    plain PyTorch lane) against the paper's 5 x 600-step discrete cascade
    (``moment_curves_discrete``), at D = 1,024 deployments and N = 48
    horizon points; on the card also the CUDA row kernel
    (``kernels.moment_curves.ops.moment_curves_kernel``) at that shape.
  * The fused aggregate (``aggregate_moment_curves``: a masked block sum,
    no [D, N] intermediate) against the per-slot curves summed outside; on
    the card also the CUDA aggregate kernel
    (``ops.aggregate_moment_curves_kernel``).
  * The simulator's steps/s at the ``quick`` preset's shapes (its horizon
    cut to 96 steps), SECOND: an aggregation ablation, the per-slot
    aggregate recomputed every step (``AGG_REFERENCE``, refresh 1) against
    the fused aggregate refreshed on the blocked schedule (``AGG_FUSED``);
    on the card also ``AGG_KERNEL``, the port's default backend. The lanes
    share everything else, the candidates' row kernel included.
  * Causal GQA prefill attention (B = 1, S = 1,024, H 8 / KVH 2, Dh 128,
    bf16): the plain ``flash_attention_ref`` and, on the card, the CUDA
    ``flash_attention``.

On ``device="cpu"`` only the plain rows run; on the card every CUDA row
runs beside its plain row, and a kernel that fails to build or to launch
raises. Every clock stops after a synchronise: a row times the work, not
its launch.

PyTorch counterpart of the JAX package's ``benchmarks/kernels_bench.py``,
whose interpret-mode Pallas row the CUDA rows replace:

    python -m repro_torch.benchmarks.run --only kernels
"""
from __future__ import annotations

import time

import torch

from ..core import (AZURE_PRIORS, SECOND, belief_from_prior, geometric_grid,
                    make_policy)
from ..core.moments import (MomentCurves, aggregate_moment_curves,
                            moment_curves, moment_curves_discrete)
from ..device import resolve_device
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import flash_attention_ref
from ..kernels.moment_curves.ops import (aggregate_moment_curves_kernel,
                                         moment_curves_kernel)
from ..sim import AGG_FUSED, AGG_KERNEL, AGG_REFERENCE, make_run
from .common import SCALES, csv_row, grid_for, sim_config

D, N, ND = 1024, 48, 32
ATTN_SHAPE = dict(b=1, s=1024, h=8, kvh=2, dh=128)
CASCADE_HOURS = (24.0, 168.0, 720.0, 8760.0, 26280.0)
#: ``measure``'s outputs of the rows that have a CUDA row: the CUDA row's
#: output is ``name + "_cuda"``
KERNEL_OUTPUTS = ("curves", "aggregate", "attention")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timeit(fn, *args, device, n=5):
    """Microseconds a call: one warm-up call, then ``n`` calls between two
    synchronises."""
    out = fn(*args)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    _sync(device)
    return (time.perf_counter() - t0) / n * 1e6, out


def _max_abs(a, b) -> float:
    if isinstance(a, MomentCurves):
        return max(_max_abs(a.EL, b.EL), _max_abs(a.VL, b.VL))
    return float((a.float() - b.float()).abs().max())


def _sim_loop_rows(device, n_steps: int = 96, reps: int = 5) -> list:
    """Steps/s of the ``quick`` preset's loop cut to ``n_steps`` steps,
    SECOND, for each aggregation backend: the best of ``reps`` runs, each
    ending in its metrics' copy to the host."""
    scale = SCALES["quick"]
    base = sim_config(scale, horizon_hours=n_steps * scale.dt)
    grid = grid_for(scale, base)
    pol = make_policy(SECOND, rho=0.1, capacity=base.capacity)

    def steps_per_sec(cfg):
        run_fn = make_run(cfg, grid, SECOND, device=device)
        float(run_fn(0, pol).utilization)              # warm-up
        best = float("inf")
        for i in range(reps):
            t0 = time.perf_counter()
            float(run_fn(1 + i, pol).utilization)
            best = min(best, time.perf_counter() - t0)
        return cfg.n_steps / best

    sps_ref = steps_per_sec(base._replace(agg_backend=AGG_REFERENCE,
                                          agg_refresh_steps=1))
    rows = [csv_row("sim/quick_loop_per_slot_recompute", 1e6 / sps_ref,
                    f"steps_per_s={sps_ref:.1f} agg=reference refresh=1 "
                    "(aggregation ablation baseline)")]
    backends = [("fused", AGG_FUSED)]
    if device.type == "cuda":
        backends.append(("kernel", AGG_KERNEL))
    for tag, backend in backends:
        sps = steps_per_sec(base._replace(agg_backend=backend))
        rows.append(csv_row(
            f"sim/quick_loop_{tag}_aggregate", 1e6 / sps,
            f"steps_per_s={sps:.1f} agg={tag} "
            f"refresh={base.agg_refresh_steps} "
            f"speedup_vs_per_slot_recompute={sps / sps_ref:.2f}x"))
    return rows


def measure(seed: int = 0, device="cuda") -> tuple[list, dict]:
    """(rows, outputs): ``outputs`` holds what the rows computed, by
    ``KERNEL_OUTPUTS``' names (the CUDA rows' with ``_cuda``, on the card
    only), and the per-slot curves summed outside (``"per_slot_sum"``)."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    rows, out = [], {}
    bel = belief_from_prior(AZURE_PRIORS, (D,), device=device)
    cores = torch.full((D,), 5.0, device=device)
    grid = geometric_grid(6.0, 3 * 365 * 24.0, N, device=device)
    curves = lambda: moment_curves(bel, cores, grid, AZURE_PRIORS,
                                   d_points=ND)

    us_cont, out["curves"] = _timeit(curves, device=device)
    rows.append(csv_row("kernels/moment_curves_continuous_torch", us_cont,
                        f"D={D} N={N} curves_per_s={D / (us_cont / 1e6):.3g}"))

    # the paper's cascade: 5 horizons x 600 uniform steps
    us_disc, _ = _timeit(lambda: [
        moment_curves_discrete(bel, cores, 600, h / 600, AZURE_PRIORS)
        for h in CASCADE_HOURS], device=device, n=2)
    rows.append(csv_row("kernels/moment_curves_paper_cascade", us_disc,
                        f"D={D} 5x600steps speedup_vs_continuous="
                        f"{us_disc / us_cont:.1f}x"))

    if cuda:
        us_kern, out["curves_cuda"] = _timeit(
            lambda: moment_curves_kernel(bel, cores, grid, AZURE_PRIORS,
                                         d_points=ND), device=device)
        rows.append(csv_row(
            "kernels/moment_curves_cuda", us_kern,
            f"D={D} N={N} curves_per_s={D / (us_kern / 1e6):.3g}"
            f" speedup_vs_torch={us_cont / us_kern:.1f}x"
            f" max_abs_err={_max_abs(out['curves_cuda'], out['curves']):.3e}"))

    # the fused aggregate: a masked sum over the alive slots, against the
    # per-slot curves summed outside
    gen = torch.Generator(device=device).manual_seed(seed)
    alive = torch.rand(D, generator=gen, device=device) < 0.5
    mask = alive.float()[:, None]
    us_ref_agg, out["per_slot_sum"] = _timeit(
        lambda: MomentCurves(*(torch.sum(x * mask, 0) for x in curves())),
        device=device)
    us_fus_agg, out["aggregate"] = _timeit(
        lambda: aggregate_moment_curves(bel, cores, alive, grid,
                                        AZURE_PRIORS, d_points=ND),
        device=device)
    rows.append(csv_row("kernels/aggregate_moment_curves_fused", us_fus_agg,
                        f"D={D} N={N} vs_per_slot_reference="
                        f"{us_ref_agg / us_fus_agg:.2f}x"))
    if cuda:
        us_kagg, out["aggregate_cuda"] = _timeit(
            lambda: aggregate_moment_curves_kernel(bel, cores, alive, grid,
                                                   AZURE_PRIORS,
                                                   d_points=ND),
            device=device)
        rows.append(csv_row(
            "kernels/aggregate_moment_curves_cuda", us_kagg,
            f"D={D} N={N} vs_fused_torch={us_fus_agg / us_kagg:.2f}x"
            f" vs_per_slot_reference={us_ref_agg / us_kagg:.2f}x"
            " max_abs_err="
            f"{_max_abs(out['aggregate_cuda'], out['aggregate']):.3e}"))

    rows.extend(_sim_loop_rows(device))

    b, s, h, kvh, dh = (ATTN_SHAPE[k] for k in ("b", "s", "h", "kvh", "dh"))
    randn = lambda *shape: torch.randn(
        shape, generator=gen, device=device).to(torch.bfloat16)
    q, k, v = randn(b, s, h, dh), randn(b, s, kvh, dh), randn(b, s, kvh, dh)
    flops = 4 * b * h * s * s * dh / 2
    us_ref, out["attention"] = _timeit(
        lambda: flash_attention_ref(q, k, v, causal=True), device=device, n=3)
    rows.append(csv_row("kernels/attention_ref", us_ref,
                        f"s={s} gflops={flops / 1e9:.1f} device={device.type}"
                        f" gflops_s={flops / (us_ref / 1e6) / 1e9:.1f}"))
    if cuda:
        us_fa, out["attention_cuda"] = _timeit(
            lambda: flash_attention(q, k, v, causal=True), device=device,
            n=20)
        rows.append(csv_row(
            "kernels/attention_cuda", us_fa,
            f"s={s} gflops={flops / 1e9:.1f}"
            f" gflops_s={flops / (us_fa / 1e6) / 1e9:.1f}"
            f" speedup_vs_ref={us_ref / us_fa:.1f}x"
            " max_abs_err="
            f"{_max_abs(out['attention_cuda'], out['attention']):.3e}"))
    return rows, out


def run(scale_name: str = "tiny", seed: int = 0, device="cuda") -> list:
    """The rows (the shapes are fixed: ``scale_name`` is the CLI's)."""
    return measure(seed, device)[0]


if __name__ == "__main__":
    for r in run():
        print(r)

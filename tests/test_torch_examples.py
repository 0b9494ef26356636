"""The port's examples (``repro_torch.examples``) on the CPU.

* ``admission_serving``'s §7 fees on the JAX example's own drawn types and
  pseudo observations (``PRNGKey(1)``) equal the JAX example's fees to
  float32 tolerance.
* Each example's ``main(["--smoke", "--device", "cpu"])`` runs and prints
  its lines, with no NaN or infinity, and what the JAX script states as
  true holds (labeling is the dominant strategy; one trace record a
  decision). The draws differ between the packages, so the printed numbers
  are not compared.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AZURE_PRIORS as J_PRIORS
from repro.core import belief_from_prior as j_belief_from_prior
from repro.core import geometric_grid as j_geometric_grid
from repro.core.belief import apply_pseudo_observations as j_apply_obs
from repro.core.moments import MomentCurves as JMomentCurves
from repro.core.moments import moment_curves as j_moment_curves
from repro.core.pricing import mixture_moments as j_mixture
from repro.core.pricing import payment as j_payment
from repro.core.pricing import variance_estimate as j_variance
from repro.core.processes import sample_params as j_sample_params
from repro.core.processes import sample_pseudo_observations as j_sample_obs
from repro_torch import bridge
from repro_torch.examples import (admission_serving, calibrate_policy,
                                  drift_recalibration, quickstart, serve_lm,
                                  telemetry_dashboard, trace_scenarios)
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

FEE_RTOL = 2e-6     # float32: a few ulps through lgamma, exp and a peak


def _jax_example_fees():
    """The JAX example's §7 section (``examples/admission_serving.py``),
    on its own draws: (types, observations, labeled fee, unlabeled fee)."""
    key = jax.random.PRNGKey(1)
    grid = j_geometric_grid(24.0, 8760.0, 24)
    prior = j_belief_from_prior(J_PRIORS, (2,))
    types = j_sample_params(key, J_PRIORS, (2,))
    obs = j_sample_obs(key, types, J_PRIORS, 5)
    bels = j_apply_obs(prior, obs, J_PRIORS)
    cores = jnp.asarray([4.0, 4.0])
    per_type = j_moment_curves(bels, cores, grid, J_PRIORS)
    mix = j_mixture(jnp.asarray([0.5, 0.5]), per_type)
    var_labeled = j_variance(per_type)
    var_mix = j_variance(JMomentCurves(mix.EL[None], mix.VL[None]))[0]
    pay_labeled = 0.5 * (j_payment(cores[0], var_labeled[0])
                         + j_payment(cores[1], var_labeled[1]))
    pay_mix = j_payment(cores[0], var_mix)
    return types, obs, float(pay_labeled), float(pay_mix)


def test_section7_fees_equal_the_jax_examples():
    types, obs, want_labeled, want_mix = _jax_example_fees()
    to_port = lambda tree: bridge.from_reference(jax.tree.map(np.asarray,
                                                              tree))
    got_labeled, got_mix = admission_serving.section7_fees(to_port(types),
                                                           to_port(obs))
    np.testing.assert_allclose(got_labeled, want_labeled, rtol=FEE_RTOL)
    np.testing.assert_allclose(got_mix, want_mix, rtol=FEE_RTOL)
    assert (got_labeled <= got_mix) == (want_labeled <= want_mix)


EXAMPLES = {
    "quickstart": (quickstart, ("zeroth(baseline)", "second(paper)",
                                "second-moment policy lifts")),
    "admission_serving": (admission_serving, (
        "windows: admitted=", "cluster util=", "labeled job types:",
        "unlabeled (mixture):", "avg hourly fee labeled:",
        "labeling is the dominant strategy (Prop. 4): True")),
    "calibrate_policy": (calibrate_policy, (
        "calibrated rho=", "flash_crowd: stationary-tuned",
        "agg_refresh[tiny]", "agg_refresh[quick]", "agg_refresh[full]")),
    "telemetry_dashboard": (telemetry_dashboard, (
        "live metrics at http://127.0.0.1:", "-- mid-run scrape",
        "repro_admission_requests_total", "== decisions", "== engine ==",
        "decision latency p50=", "== decision trace")),
    "trace_scenarios": (trace_scenarios, (
        "fit round-trip on", "baseline     utilization=",
        "flash_crowd  utilization=", "info pseudo(k=5)",
        "ingested", "real-trace replay")),
    "drift_recalibration": (drift_recalibration, (
        "== 1. streaming prior fit", "4 windows merged:",
        "null: threshold=", "drift_step :", "after 8 scrapes:",
        "triggered within oracle CI")),
    "serve_lm": (serve_lm, ("served 4 requests / 24 tokens", "req0: ")),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_with_smoke_on_the_cpu(name, capsys):
    module, lines = EXAMPLES[name]
    module.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    for line in lines:
        assert line in out, (line, out)
    assert not re.search(r"\b(nan|inf|infinity)\b", out, re.IGNORECASE), out
    if name == "telemetry_dashboard":
        m = re.search(r"requests=(\d+)", out)
        assert f"== decision trace ({m[1]} records)" in out
    if name == "drift_recalibration":
        # the merged window fit is the batch fit (printed to 4 digits)
        merged = re.search(r"merged:\s+(mu=\(.*)", out)[1]
        batch = re.search(r"batch:\s+(mu=\(.*)", out)[1]
        assert merged == batch


def test_examples_run_as_python_m(tmp_path):
    """``python -m repro_torch.examples.quickstart --smoke --device cpu``
    in a process of its own, with JAX and the JAX package unimportable."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import runpy, sys\n"
            "for name in ('jax', 'jaxlib', 'repro', 'flax'):\n"
            "    sys.modules[name] = None\n"
            "sys.argv = ['quickstart', '--smoke', '--device', 'cpu']\n"
            "runpy.run_module('repro_torch.examples.quickstart',"
            " run_name='__main__', alter_sys=True)\n")
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "second-moment policy lifts utilization" in out.stdout

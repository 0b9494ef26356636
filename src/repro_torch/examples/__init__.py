"""The JAX package's example scripts (``examples/``) on the port, one
module each, run as ``python -m repro_torch.examples.<name>``:
``quickstart``, ``admission_serving``, ``calibrate_policy``,
``telemetry_dashboard``, ``trace_scenarios``, ``drift_recalibration``,
``serve_lm`` and ``train_lm``.

Each runs on ``--device`` (the card unless the caller passes ``cpu``);
``--smoke`` selects the JAX script's ``REPRO_SMOKE=1`` sizes.
"""
from __future__ import annotations

import argparse


def parse_args(doc: str, argv=None) -> argparse.Namespace:
    """An example's command line: ``--device`` and ``--smoke``."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the example runs (default: the card)")
    ap.add_argument("--smoke", action="store_true",
                    help="the JAX script's REPRO_SMOKE=1 sizes: seconds")
    return ap.parse_args(argv)

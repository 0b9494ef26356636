"""The port's Cortez/Azure ingestion against the JAX package's: the
checked-in Azure sample and hand-written files through both
``ingest_cortez_csv``s give equal traces (every column bit for bit) and
equal diagnostics, under the header and the positional schema, with
malformed rows, re-bucketing, C0 folding, caps and an explicit horizon;
then the sample through ``fit_priors(source="observed")`` (equal at 1e-12)
and ``TraceArrivalSource`` into one short run."""
import os

import jax
import numpy as np
import pytest

from repro import traces as RT
from repro_torch import bridge
from repro_torch import traces as PT
from repro_torch.core import SECOND, geometric_grid, make_policy
from repro_torch.sim import PSEUDO, make_config, make_run
from torch_lockstep import one_cpu_thread  # noqa: F401  (autouse)

FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                       "azure_cortez_sample.csv")
HEADER = ("vmid", "subscriptionid", "deploymentid", "vmcreated", "vmdeleted",
          "maxcpu", "avgcpu", "p95maxcpu", "vmcategory", "vmcorecountbucket",
          "vmmemorybucket")


def _write(path, rows, header=HEADER):
    import csv

    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        if header is not None:
            w.writerow(header)
        w.writerows(rows)
    return str(path)


def _vm(vmid, dep, created, deleted, cores):
    return [vmid, "sub-x", dep, str(created),
            "" if deleted is None else str(deleted), "50.0", "25.0", "45.0",
            "Unknown", str(cores), "4"]


def _malformed_rows():
    return [
        _vm("v1", "d1", 0, 7200, 2),
        _vm("v2", "d1", 3600, None, 4),
        _vm("v3", "d2", 1800, 900, 1),          # deleted before created
        _vm("v4", "d2", "abc", 9000, 1),        # unparsable
        _vm("v5", "", 100, 200, 1),             # no deployment
        _vm("v6", "d3", 5400, 10800, ">24"),    # open bucket
        _vm("v7", "d3", -60, 600, 1),           # negative time
        _vm("v8", "d4", 9000, 18000, "0"),      # no cores
        ["v9", "sub-x", "d4"],                  # short row
        _vm("v10", "d4", 9000, 36000, 8),
        _vm("v11", "d4", 12600, 14400, 2),
    ]


def _assert_same(got, want):
    (gt, gd), (wt, wd) = got, want
    PT.validate_trace(gt)
    assert gd == wd
    g = bridge.to_numpy(gt)
    for (path, x), y in zip(jax.tree_util.tree_leaves_with_path(tuple(g)),
                            jax.tree.leaves(tuple(wt))):
        np.testing.assert_array_equal(x, np.asarray(y),
                                      err_msg=jax.tree_util.keystr(path))


CASES = {
    "sample": dict(),
    "sample_rebucket": dict(rebucket_dt_hours=6.0),
    "sample_c0_window": dict(rebucket_dt_hours=1.0, c0_window_hours=12.0),
    "sample_capped": dict(max_deployments=7, max_events=2,
                          horizon_hours=100.0),
    "sample_minutes": dict(schema=RT.CortezSchema(time_unit_seconds=60.0)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_matches_reference(case):
    kw = CASES[case]
    pkw = dict(kw)
    if "schema" in pkw:
        pkw["schema"] = PT.CortezSchema(*pkw["schema"])
    _assert_same(PT.ingest_cortez_csv(FIXTURE, device="cpu", **pkw),
                 RT.ingest_cortez_csv(FIXTURE, **kw))


@pytest.mark.parametrize("header", [True, False], ids=["header",
                                                       "positional"])
@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_malformed_rows_match_reference(tmp_path, header, scale):
    path = _write(tmp_path / "vms.csv", _malformed_rows(),
                  HEADER if header else None)
    schema = dict() if header else dict(schema=RT.AZURE_2017_POSITIONAL)
    pschema = dict() if header else dict(schema=PT.AZURE_2017_POSITIONAL)
    got = PT.ingest_cortez_csv(path, open_bucket_scale=scale, device="cpu",
                               **pschema)
    want = RT.ingest_cortez_csv(path, open_bucket_scale=scale, **schema)
    _assert_same(got, want)
    assert got[1]["n_malformed"] == 6


def test_refusals_match_reference(tmp_path):
    empty = _write(tmp_path / "empty.csv", [], header=None)
    bad = _write(tmp_path / "bad.csv", [_vm("v", "d", "x", 1, 1)])
    for path, match in ((empty, "empty"), (bad, "no well-formed")):
        with pytest.raises(ValueError, match=match):
            RT.ingest_cortez_csv(path)
        with pytest.raises(ValueError, match=match):
            PT.ingest_cortez_csv(path, device="cpu")
    missing = PT.CortezSchema(cores="nope")
    with pytest.raises(ValueError, match="not found in header"):
        PT.ingest_cortez_csv(FIXTURE, schema=missing, device="cpu")
    for cell in ("4", " 8 ", ">24"):
        assert PT.parse_core_bucket(cell, 1.5) == RT.parse_core_bucket(cell,
                                                                       1.5)


def test_sample_fits_and_replays():
    """The sample through ``fit_priors(source="observed")`` (equal to the
    JAX package's fit) and ``TraceArrivalSource`` into a short run under
    the observed §6 beliefs."""
    trace, _ = PT.ingest_cortez_csv(FIXTURE, rebucket_dt_hours=6.0,
                                    device="cpu")
    jtrace, _ = RT.ingest_cortez_csv(FIXTURE, rebucket_dt_hours=6.0)
    assert not PT.has_latents(trace)
    got, gd = PT.fit_priors(trace, source="observed")
    want, wd = RT.fit_priors(jtrace, source="observed")
    np.testing.assert_allclose(tuple(got), tuple(want), rtol=1e-12)
    assert gd.get("degenerate") == wd.get("degenerate")
    horizon = float(trace.horizon_hours)
    cfg = make_config(capacity=400.0, arrival_rate=0.1,
                      horizon_hours=24.0 * max(int(horizon // 24.0), 1),
                      dt=24.0, max_slots=64, max_arrivals=8, d_points=8,
                      prior_mode=PSEUDO, n_pseudo_obs=1, priors=got)
    source = PT.TraceArrivalSource(trace)
    assert source.pseudo_source == "observed"
    m = make_run(cfg, geometric_grid(24.0, 3 * cfg.horizon_hours, 8,
                                     device="cpu"), SECOND,
                 arrival_source=source, device="cpu")(
        0, make_policy(SECOND, rho=0.1, capacity=cfg.capacity))
    assert 0.0 < float(m.utilization) <= 1.0
    assert float(m.arrivals_accepted + m.arrivals_rejected) == float(
        PT.n_deployments(trace) - source.n_dropped(cfg))

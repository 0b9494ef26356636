"""Live metrics export: host histograms + Prometheus text + /metrics HTTP.

The port's copy of the JAX package's ``obs/export.py`` (it holds no JAX):
the same snapshot dict renders to the same text. Three dependency-free
pieces (stdlib only — no ``prometheus_client``):

  * ``HostHistogram`` — a fixed-bucket streaming histogram for host-side
    latencies/sizes (decision latency, flush batch size): O(1) observe,
    cumulative bucket counts, and p50/p99 estimates by linear interpolation
    within the landing bucket.
  * ``render_prometheus(metrics)`` — render a list of ``Metric`` families to
    the Prometheus text exposition format (version 0.0.4): ``# HELP`` /
    ``# TYPE`` headers, ``{label="v"}`` samples, and for histograms the
    cumulative ``_bucket{le=...}`` series plus ``_sum``/``_count``.
  * ``MetricsServer`` — a ``ThreadingHTTPServer`` on a daemon thread serving
    ``GET /metrics`` from a caller-provided ``render_fn`` (anything else is
    404). ``port=0`` binds an ephemeral port, exposed as ``.port``.

``snapshot_to_prometheus`` maps the online engine's ``metrics_snapshot()``
dict (see ``repro_torch.serve.admission``) onto ``repro_admission_*``
metric families; the admission daemon serves it under ``--metrics-port``.
"""
from __future__ import annotations

import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, NamedTuple, Sequence

from .log import get_logger

log = get_logger(__name__)


def log_buckets(lo: float, hi: float, n: int) -> tuple:
    """``n`` log-spaced bucket upper bounds from ``lo`` to ``hi``."""
    ratio = (hi / lo) ** (1.0 / (n - 1))
    return tuple(lo * ratio ** i for i in range(n))


#: default latency buckets: 10µs .. 10s
LATENCY_BUCKETS_S = log_buckets(1e-5, 10.0, 19)


class HostHistogram:
    """Fixed-bucket streaming histogram (host side, not thread-safe —
    callers serialize through their own lock)."""

    def __init__(self, buckets: Sequence[float] = LATENCY_BUCKETS_S):
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError("histogram buckets must be sorted")
        self.counts = [0] * (len(self.buckets) + 1)  # +1: the +Inf bucket
        self.total = 0
        self.sum = 0.0

    def observe(self, value: float) -> None:
        value = float(value)
        # linear scan: bucket counts are small and observe is not the hot
        # path's inner loop (one call per flush / per decision batch)
        idx = len(self.buckets)
        for i, edge in enumerate(self.buckets):
            if value <= edge:
                idx = i
                break
        self.counts[idx] += 1
        self.total += 1
        self.sum += value

    def percentile(self, p: float) -> float:
        """Estimate the ``p``-quantile (0..1) by linear interpolation inside
        the landing bucket; 0.0 when empty."""
        if self.total == 0:
            return 0.0
        target = p * self.total
        cum = 0
        lo = 0.0
        for i, edge in enumerate(self.buckets):
            prev = cum
            cum += self.counts[i]
            if cum >= target:
                frac = (target - prev) / max(self.counts[i], 1)
                return lo + frac * (edge - lo)
            lo = edge
        return self.buckets[-1] if self.buckets else 0.0

    def snapshot(self) -> "HostHistogram":
        """A detached copy (callers hold their lock only for this)."""
        h = HostHistogram(self.buckets)
        h.counts = list(self.counts)
        h.total = self.total
        h.sum = self.sum
        return h


class Metric(NamedTuple):
    """One Prometheus metric family: samples are ``(labels_dict, value)``
    pairs; a histogram family's values are ``HostHistogram`` instances."""

    name: str
    mtype: str          # "counter" | "gauge" | "histogram"
    help: str
    samples: list


def _fmt_value(v: float) -> str:
    v = float(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", r"\\").replace('"', r"\"")
                     .replace("\n", r"\n"))
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def render_prometheus(metrics: Sequence[Metric]) -> str:
    """Render metric families to the Prometheus text exposition format."""
    out = []
    for m in metrics:
        if m.mtype not in ("counter", "gauge", "histogram"):
            raise ValueError(f"unknown metric type {m.mtype!r}")
        out.append(f"# HELP {m.name} {m.help}")
        out.append(f"# TYPE {m.name} {m.mtype}")
        for labels, value in m.samples:
            if m.mtype != "histogram":
                out.append(f"{m.name}{_fmt_labels(labels)} "
                           f"{_fmt_value(value)}")
                continue
            hist: HostHistogram = value
            cum = 0
            for edge, count in zip(hist.buckets, hist.counts):
                cum += count
                lab = dict(labels, le=_fmt_value(edge))
                out.append(f"{m.name}_bucket{_fmt_labels(lab)} {cum}")
            lab = dict(labels, le="+Inf")
            out.append(f"{m.name}_bucket{_fmt_labels(lab)} {hist.total}")
            out.append(f"{m.name}_sum{_fmt_labels(labels)} "
                       f"{_fmt_value(hist.sum)}")
            out.append(f"{m.name}_count{_fmt_labels(labels)} {hist.total}")
    return "\n".join(out) + "\n"


def snapshot_to_prometheus(snap: dict) -> str:
    """Render an engine ``metrics_snapshot()`` dict as Prometheus text.

    Device-side telemetry counters become ``repro_admission_*`` counters and
    the occupancy/staleness histograms become gauges per bin; the host-side
    engine histograms (decision latency, flush batch size) are exposed as
    native Prometheus histograms plus queue-depth / pump-idle gauges.
    """
    mets: list[Metric] = []

    def counter(name, help_, value, **labels):
        mets.append(Metric(f"repro_admission_{name}", "counter", help_,
                           [(labels, value)]))

    def gauge(name, help_, samples):
        mets.append(Metric(f"repro_admission_{name}", "gauge", help_,
                           samples))

    eng = snap.get("engine", {})
    counter("requests_total", "Admission requests decided",
            eng.get("n_requests", 0))
    counter("flushes_total", "Micro-batch flushes", eng.get("n_flushes", 0))
    counter("refreshes_total", "Full aggregate refreshes",
            eng.get("n_refreshes", 0))
    counter("ticks_total", "Engine dt-window ticks", eng.get("n_ticks", 0))
    counter("deadline_misses_total",
            "Decisions whose submit->decision latency exceeded the flush SLO",
            eng.get("deadline_misses", 0))
    gauge("queue_depth", "Pending requests in the micro-batch queue",
          [({}, eng.get("queue_depth", 0))])
    gauge("pump_idle_fraction", "Fraction of pump loop time spent idle",
          [({}, eng.get("pump_idle_fraction", 0.0))])
    gauge("shard_count", "Devices the slot table is sharded over",
          [({}, eng.get("n_shards", 1))])
    gauge("flush_slo_seconds",
          "Configured decision-latency SLO (0 = caller-driven flushing)",
          [({}, eng.get("flush_slo_ms", 0.0) / 1e3)])
    for hname, help_ in (("decision_latency_seconds",
                          "submit->decision latency"),
                         ("flush_batch_size", "Decisions per flush")):
        hist = eng.get(hname)
        if isinstance(hist, HostHistogram):
            mets.append(Metric(f"repro_admission_{hname}", "histogram",
                               help_, [({}, hist)]))

    tel = snap.get("telemetry")
    if tel:
        counter("admitted_total", "Deployments admitted", tel["n_admit"])
        counter("rejected_total", "Rejected: physically did not fit",
                tel["n_reject_capacity"], reason="capacity")
        counter("rejected_total", "Rejected: moment condition",
                tel["n_reject_policy"], reason="policy")
        counter("windows_total", "Simulated dt windows", tel["n_windows"])
        counter("observed_departures_total", "Deployments departed",
                tel["obs"]["departed"])
        gauge("occupancy_window_count",
              "Windows by occupancy fraction bin (device histogram)",
              [({"bin": i}, v) for i, v in enumerate(tel["occupancy_hist"])])
        gauge("decision_staleness_count",
              "Decisions by aggregate staleness (windows since refresh)",
              [({"bin": i}, v) for i, v in enumerate(tel["staleness_hist"])])
        pc = tel.get("per_cluster")
        if pc:
            gauge("cluster_routed_count", "Candidates routed per cluster",
                  [({"cluster": c}, v)
                   for c, v in enumerate(pc["n_routed"])])
            gauge("cluster_admitted_count", "Admissions per cluster",
                  [({"cluster": c}, v)
                   for c, v in enumerate(pc["n_admit"])])
    return render_prometheus(mets)


class MetricsServer:
    """``GET /metrics`` over stdlib HTTP, rendered by ``render_fn``.

    The server runs on a daemon thread (``ThreadingHTTPServer``, so a slow
    scraper cannot wedge a second one); ``render_fn`` must therefore be
    thread-safe — the engine's ``metrics_snapshot`` is. ``port=0`` binds an
    ephemeral port; read ``.port`` after construction.
    """

    def __init__(self, render_fn: Callable[[], str], port: int = 0,
                 host: str = "127.0.0.1"):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802  (stdlib API name)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                try:
                    body = render_fn().encode()
                except Exception as exc:  # surface render bugs to the scraper
                    self.send_error(500, explain=str(exc))
                    server.log_exc = exc
                    return
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                log.debug("metrics http: " + fmt, *args)

        self.log_exc = None
        self._httpd = ThreadingHTTPServer((host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="repro-metrics", daemon=True)
        self._thread.start()
        log.info("metrics server listening on %s:%d", host, self.port)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)

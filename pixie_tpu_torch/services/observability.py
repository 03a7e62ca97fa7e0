"""Service observability: metrics registry + healthz/statusz/metrics HTTP.

A port of the JAX package's ``services/observability.py`` (reference
parity: the prometheus-cpp registry every C++ service carries,
``src/common/metrics/metrics.h:27``, and the shared Go service handlers
of ``src/shared/services/``). Metric kinds: ``counter`` (monotonic),
``gauge`` and ``histogram`` (fixed buckets; cumulative
``_bucket{le=...}`` + ``_sum``/``_count`` exposition). The
query-lifecycle tracer (``exec/trace.py``), the bus
(``services/busstats.py``), the tracker and the broker record here.

``ObservabilityServer`` serves ``/healthz``, ``/statusz``, ``/version``,
``/metrics``, ``/debug/queryz``, ``/debug/tablez``, ``/debug/cachez``,
``/debug/busz``, ``/debug/tracez[/<id>]`` (the telemetry's cluster
trace view), ``/debug/pprof`` and ``/debug/flamez`` (the profiler's
folded stacks) and ``/debug/programz`` (the program registry) over
stdlib http.server. An endpoint whose source is not wired answers 404.
"""

from __future__ import annotations

import bisect
import http.server
import json
import threading
from dataclasses import dataclass, field

#: Prometheus client default latency buckets (seconds).
DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


@dataclass
class _Metric:
    name: str
    kind: str  # "counter" | "gauge" | "histogram"
    help: str
    values: dict = field(default_factory=dict)  # labels tuple -> value
    # histogram only: ascending finite upper bounds (le); +Inf implicit.
    buckets: tuple = ()


def _esc_label(v) -> str:
    """Exposition-format label-value escaping."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _esc_help(v) -> str:
    """HELP text escaping (the format escapes backslash + newline only;
    quotes are legal in HELP)."""
    return str(v).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_bound(b: float) -> str:
    """Bucket bound rendering: 0.005 -> '0.005', 1.0 -> '1'."""
    return format(b, "g")


class MetricsRegistry:
    """Process-wide named counters/gauges/histograms with label support."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()
        self._collectors: list = []  # callables run at render time

    def counter(self, name: str, help: str = "") -> "Counter":
        with self._lock:
            m = self._metrics.setdefault(name, _Metric(name, "counter", help))
        return Counter(m, self._lock)

    def gauge(self, name: str, help: str = "") -> "Gauge":
        with self._lock:
            m = self._metrics.setdefault(name, _Metric(name, "gauge", help))
        return Gauge(m, self._lock)

    def histogram(self, name: str, help: str = "",
                  buckets=DEFAULT_BUCKETS) -> "Histogram":
        bk = tuple(sorted(float(b) for b in buckets))
        with self._lock:
            m = self._metrics.setdefault(
                name, _Metric(name, "histogram", help, buckets=bk)
            )
        return Histogram(m, self._lock)

    def register_collector(self, fn) -> None:
        """``fn(registry)`` runs before each render — pull-style metrics
        (table stats, cache bytes) refresh here."""
        self._collectors.append(fn)

    def values(self, name: str) -> dict:
        """Snapshot of a counter/gauge's per-label-set values
        ({labels tuple: value}; {} for unknown names or histograms —
        those go through ``histogram_state``/``quantiles``)."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None or m.kind == "histogram":
                return {}
            return dict(m.values)

    def render(self) -> str:
        # A raising collector must not 500 the whole scrape: count it
        # and keep rendering the rest (prometheus-cpp Collect contract).
        failed = []
        for fn in list(self._collectors):
            try:
                fn(self)
            except Exception:
                failed.append(getattr(fn, "__name__", repr(fn)))
        if failed:
            c = self.counter(
                "pixie_collector_errors_total",
                "Metric collector callbacks that raised during a render",
            )
            for name in failed:
                c.labels(collector=name).inc()

        lines = []
        with self._lock:
            for m in sorted(self._metrics.values(), key=lambda m: m.name):
                if m.help:
                    lines.append(f"# HELP {m.name} {_esc_help(m.help)}")
                lines.append(f"# TYPE {m.name} {m.kind}")
                if m.kind == "histogram":
                    self._render_histogram(m, lines)
                    continue
                for labels, v in sorted(m.values.items()):
                    if labels:
                        lbl = ",".join(
                            f'{k}="{_esc_label(val)}"' for k, val in labels
                        )
                        lines.append(f"{m.name}{{{lbl}}} {v}")
                    else:
                        lines.append(f"{m.name} {v}")
        return "\n".join(lines) + "\n"

    @staticmethod
    def _render_histogram(m: _Metric, lines: list) -> None:
        for labels, st in sorted(m.values.items()):
            base = ",".join(
                f'{k}="{_esc_label(val)}"' for k, val in labels
            )

            def series(name, extra=""):
                lbl = ",".join(x for x in (base, extra) if x)
                return f"{name}{{{lbl}}}" if lbl else name

            cum = 0
            for b, c in zip(m.buckets, st["counts"]):
                cum += c
                lines.append(
                    f'{series(m.name + "_bucket", f_le(b))} {cum}'
                )
            cum += st["counts"][-1]
            lines.append(f'{series(m.name + "_bucket", LE_INF)} {cum}')
            lines.append(f'{series(m.name + "_sum")} {st["sum"]}')
            lines.append(f'{series(m.name + "_count")} {st["count"]}')

    def histogram_state(self, name: str, **labels):
        """Raw cumulative state of a histogram metric, summed across
        matching label sets: ``(bounds, counts, count, sum)`` with
        ``counts`` carrying the implicit +Inf slot last, or None when
        the metric is missing. Callers that want PER-RUN quantiles
        snapshot this before and after and interpolate over the delta
        (``delta_quantiles``) — the histograms themselves are
        process-lifetime cumulative."""
        want = set(labels.items())
        with self._lock:
            m = self._metrics.get(name)
            if m is None or m.kind != "histogram":
                return None
            counts = [0] * (len(m.buckets) + 1)
            total = 0
            sum_ = 0.0
            for lbls, st in m.values.items():
                if want and not want <= set(lbls):
                    continue
                for i, c in enumerate(st["counts"]):
                    counts[i] += c
                total += st["count"]
                sum_ += st["sum"]
            return (m.buckets, counts, total, sum_)

    def quantiles(self, name: str, qs=(0.5, 0.95, 0.99), **labels):
        """Approximate quantiles of a histogram metric from its buckets
        (prometheus ``histogram_quantile`` linear interpolation; the
        +Inf bucket clamps to the highest finite bound). Label kwargs
        filter; observations are summed across all matching label sets.
        Returns {q: value} or None when the metric is missing/empty."""
        st = self.histogram_state(name, **labels)
        if st is None:
            return None
        bounds, counts, total, _sum = st
        if total == 0 or not bounds:
            # Zero observations (or a bucketless histogram, where every
            # observation lands in +Inf and no finite interpolation
            # exists): there IS no quantile — None, never a made-up 0.0.
            return None
        return _interpolate_quantiles(bounds, counts, total, qs)


def delta_quantiles(before, after, qs=(0.5, 0.95, 0.99)):
    """Quantiles of the observations recorded BETWEEN two
    ``MetricsRegistry.histogram_state`` snapshots (bucket-count
    subtraction + the shared interpolation). Returns {q: value} or None
    when either snapshot is missing or nothing was observed in between
    — the load tester's per-run latency report
    (``services/load_tester.py``)."""
    if before is None or after is None:
        return None
    bounds, counts_b, total_b, _ = before
    _bounds_a, counts_a, total_a, _ = after
    total = total_a - total_b
    if total <= 0 or not bounds or len(counts_a) != len(counts_b):
        return None
    counts = [a - b for a, b in zip(counts_a, counts_b)]
    if any(c < 0 for c in counts):
        return None  # metric reset between snapshots
    return _interpolate_quantiles(bounds, counts, total, qs)


def _interpolate_quantiles(bounds, counts, total, qs) -> dict:
    """histogram_quantile linear interpolation over cumulative bucket
    counts (the +Inf bucket clamps to the highest finite bound). One
    shared implementation for both quantile surfaces — callers
    guarantee ``total > 0`` and non-empty ``bounds``."""
    out = {}
    for q in qs:
        rank = q * total
        cum = 0.0
        val = bounds[-1]
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                if i >= len(bounds):  # +Inf bucket
                    val = bounds[-1]
                else:
                    lo = bounds[i - 1] if i > 0 else 0.0
                    val = lo + (bounds[i] - lo) * max(rank - cum, 0.0) / c
                break
            cum += c
        out[q] = val
    return out


def f_le(b: float) -> str:
    """le="..." label fragment for one finite bucket bound."""
    return f'le="{_fmt_bound(b)}"'


LE_INF = 'le="+Inf"'


class _Bound:
    def __init__(self, metric: _Metric, lock, labels=()):
        self._m = metric
        self._lock = lock
        self._labels = tuple(sorted(labels))

    def labels(self, **kw):
        return type(self)(self._m, self._lock, tuple(kw.items()))

    def value(self) -> float:
        """Current scalar value for this label set (0.0 if never set) —
        counters/gauges only; histograms keep structured state."""
        with self._lock:
            v = self._m.values.get(self._labels, 0.0)
        return v if isinstance(v, float) else 0.0


class Counter(_Bound):
    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(
                f"counter {self._m.name} cannot decrease (inc {v}); "
                "Prometheus counters are monotonic — use a gauge"
            )
        with self._lock:
            self._m.values[self._labels] = (
                self._m.values.get(self._labels, 0.0) + v
            )


class Gauge(_Bound):
    def set(self, v: float) -> None:
        with self._lock:
            self._m.values[self._labels] = float(v)

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._m.values[self._labels] = (
                self._m.values.get(self._labels, 0.0) + v
            )

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)


class Histogram(_Bound):
    def quantiles(self, qs=(0.5, 0.95, 0.99)):
        """Approximate quantiles for THIS bound label set (all label
        sets when unbound). Returns {q: value} or None on a
        zero-observation histogram — callers never special-case an
        empty distribution, they get None, not a crash or a fake 0."""
        with self._lock:
            st = self._m.values.get(self._labels)
            bounds = self._m.buckets
            if st is not None:
                counts = list(st["counts"])
                total = st["count"]
            elif not self._labels:
                # Unbound handle: aggregate across every label set.
                counts = [0] * (len(bounds) + 1)
                total = 0
                for s in self._m.values.values():
                    for i, c in enumerate(s["counts"]):
                        counts[i] += c
                    total += s["count"]
            else:
                return None
        if total == 0 or not bounds:
            return None
        return _interpolate_quantiles(bounds, counts, total, qs)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            st = self._m.values.get(self._labels)
            if st is None:
                st = self._m.values[self._labels] = {
                    "counts": [0] * (len(self._m.buckets) + 1),
                    "sum": 0.0,
                    "count": 0,
                }
            # le semantics: an observation equal to a bound counts in
            # that bound's bucket (bisect_left finds the first bound
            # >= v); past the last bound -> the implicit +Inf slot.
            st["counts"][bisect.bisect_left(self._m.buckets, v)] += 1
            st["sum"] += v
            st["count"] += 1


#: Default process registry (metrics.h GetMetricsRegistry analog).
default_registry = MetricsRegistry()


def default_counter(name: str, help: str = "") -> Counter:
    """Bound counter on the process-wide default registry. Registration
    is idempotent and binding is cheap — call at the increment site, no
    per-caller lazy-cache dance needed."""
    return default_registry.counter(name, help)


class ObservabilityServer:
    """healthz / statusz / metrics / debug endpoints for one service
    process. Wire a ``tracer`` (``exec.trace.Tracer``, e.g.
    ``engine.tracer``) to serve ``/debug/queryz`` — the in-flight +
    recent query-trace listing."""

    def __init__(self, registry: MetricsRegistry | None = None,
                 statusz_fn=None, health_fn=None, tracer=None,
                 trace_view=None, programs=None, tablez_fn=None,
                 cachez_fn=None, profilez_fn=None, busz_fn=None):
        self.registry = registry or default_registry
        self.statusz_fn = statusz_fn  # () -> dict
        self.health_fn = health_fn  # () -> (bool, str)
        self.tracer = tracer  # exec.trace.Tracer | None
        # services.telemetry.ClusterTraceView | None: /debug/tracez — the
        # cluster-stitched distributed-trace view.
        self.trace_view = trace_view
        # exec.programs.ProgramRegistry | None: /debug/programz — the
        # program registry (compile wall time, hit counts).
        self.programs = programs
        # () -> dict | None: /debug/tablez — the storage-tier freshness
        # snapshot (an agent serves its TableStore.freshness(); a broker
        # the tracker's cluster merge).
        self.tablez_fn = tablez_fn
        # () -> dict | None: /debug/cachez — the result cache (and an
        # agent's materialized views).
        self.cachez_fn = cachez_fn
        # (agent_id=None, tenant=None, script_hash=None) -> profile
        # summary rows ({stack, count, qid, script_hash, tenant, phase}):
        # /debug/pprof (collapsed format) and /debug/flamez (static HTML
        # flamegraph). An agent serves its own profiler's summary; a
        # broker the tracker's cluster merge plus its own samples.
        self.profilez_fn = profilez_fn
        # () -> dict | None: /debug/busz — the transport-tier snapshot.
        self.busz_fn = busz_fn
        self._httpd = None

    def handle(self, path: str) -> tuple[int, str, str]:
        """(status, content_type, body) — transport-independent core.
        ``path`` may carry a query string (``/debug/pprof?seconds=5``);
        endpoints that take no parameters ignore it."""
        path, _, query = path.partition("?")
        if path in ("/debug/pprof", "/debug/flamez"):
            return self._handle_profile(path, query)
        if path == "/healthz":
            ok, msg = (True, "ok") if self.health_fn is None else self.health_fn()
            return (200 if ok else 503, "text/plain", msg + "\n")
        if path == "/statusz":
            from ..config import all_flags
            from ..version import version_info

            status = {
                "version": version_info(),
                "flags": {k: v for k, (v, _) in all_flags().items()},
            }
            if self.statusz_fn is not None:
                status.update(self.statusz_fn())
            return (200, "application/json", json.dumps(status, indent=1))
        if path == "/version":
            from ..version import version_info

            return (200, "application/json", json.dumps(version_info()))
        if path == "/metrics":
            return (200, "text/plain; version=0.0.4", self.registry.render())
        if path == "/debug/queryz":
            if self.tracer is None:
                return (404, "text/plain", "no tracer wired\n")
            body = json.dumps(
                {
                    "in_flight": self.tracer.in_flight(),
                    "recent": self.tracer.recent(),
                },
                indent=1,
                default=str,
            )
            return (200, "application/json", body)
        for route, fn, missing in (
            ("/debug/tablez", self.tablez_fn, "no table stats wired\n"),
            ("/debug/cachez", self.cachez_fn, "no result cache wired\n"),
            ("/debug/busz", self.busz_fn, "no bus stats wired\n"),
            ("/debug/programz",
             self.programs.programz if self.programs is not None else None,
             "no program registry wired\n"),
        ):
            if path == route:
                if fn is None:
                    return (404, "text/plain", missing)
                return (200, "application/json",
                        json.dumps(fn(), indent=1, default=str))
        if path == "/debug/tracez" or path.startswith("/debug/tracez/"):
            if self.trace_view is None:
                return (404, "text/plain", "no trace view wired\n")
            tid = path[len("/debug/tracez/"):] if "/tracez/" in path else ""
            if tid:
                tr = self.trace_view.get(tid)
                if tr is None:
                    return (404, "text/plain", f"no trace {tid}\n")
                body = json.dumps(tr, indent=1, default=str)
            else:
                body = json.dumps(
                    self.trace_view.tracez(), indent=1, default=str
                )
            return (200, "application/json", body)
        return (404, "text/plain", "not found\n")

    def _handle_profile(self, path: str, query: str) -> tuple[int, str, str]:
        """/debug/pprof (flamegraph collapsed text) and /debug/flamez
        (static HTML flamegraph) over the wired profile source.

        Parameters: ``agent``/``tenant``/``script`` filter the merged
        summary; ``seconds=N`` (pprof) windows it — two cumulative
        snapshots N seconds apart, per-stack growth between them —
        instead of the since-start totals."""
        if self.profilez_fn is None:
            return (404, "text/plain", "no profiler wired\n")
        import time
        import urllib.parse

        from .telemetry import (
            collapsed_text, counts_delta, flame_html, profile_counts,
        )

        params = urllib.parse.parse_qs(query)

        def one(name):
            vals = params.get(name)
            return vals[0] if vals else None

        agent, tenant, script = one("agent"), one("tenant"), one("script")

        def counts():
            return profile_counts(self.profilez_fn(
                agent_id=agent, tenant=tenant, script_hash=script
            ))

        before = counts()
        if path == "/debug/flamez":
            label = " ".join(
                f"{k}={v}" for k, v in
                (("agent", agent), ("tenant", tenant), ("script", script))
                if v
            )
            title = "pixie cpu flame" + (f" [{label}]" if label else "")
            return (200, "text/html", flame_html(before, title=title))
        try:
            seconds = float(one("seconds") or 0)
        except ValueError:
            seconds = 0.0
        if seconds > 0:
            # Windowed profile: cumulative counts are monotonic, so the
            # delta between two snapshots is exactly the window's
            # samples. The wait is capped (it blocks one server thread).
            time.sleep(min(seconds, 60.0))
            before = counts_delta(before, counts())
        return (200, "text/plain", collapsed_text(before))

    def start(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Serve on a background thread; returns the bound port."""
        obs = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib casing)
                code, ctype, body = obs.handle(self.path)
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *a):  # silence per-request stderr noise
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        t = threading.Thread(
            target=self._httpd.serve_forever, name="observability", daemon=True
        )
        t.start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def engine_collector(engine):
    """Collector exporting an engine's table + device-cache stats
    (table_metrics.h / pem_manager.h:63 node-memory gauges analog). The
    card's allocator gauges come from the device-memory monitor
    (``exec/programs.py``), which every engine installs."""

    def collect(reg: MetricsRegistry) -> None:
        import time as _time

        from ..config import get_flag
        from ..table_store.device_cache import total_resident_bytes

        g_rows = reg.gauge("pixie_table_rows", "Rows resident per table")
        # tier label: "hot" = ring bytes, "cold" = encoded cold-store
        # bytes. Untiered tables report only tier="hot" (their whole
        # ring), so sum-over-tiers is always total resident bytes.
        g_bytes = reg.gauge(
            "pixie_table_bytes", "Bytes resident per table and tier"
        )
        g_demote = reg.gauge(
            "pixie_cold_demotions_total",
            "Windows demoted hot->cold per table (pxtier)",
        )
        g_evict = reg.gauge(
            "pixie_cold_evictions_total",
            "Cold windows evicted (true expiry) per table",
        )
        g_decode = reg.gauge(
            "pixie_cold_decode_seconds_total",
            "Seconds spent decoding cold windows per table",
        )
        g_rows_t = reg.gauge(
            "pixie_table_rows_total", "Rows ever appended per table"
        )
        g_bytes_t = reg.gauge(
            "pixie_table_bytes_total", "Bytes ever appended per table"
        )
        g_exp_t = reg.gauge(
            "pixie_table_expired_bytes_total",
            "Bytes dropped by ring expiry per table",
        )
        g_lag = reg.gauge(
            "pixie_table_watermark_lag_seconds",
            "Now minus the max event-time watermark per table "
            "(ingest staleness; absent without a time index)",
        )
        now_ns = _time.time_ns()
        for name, t in engine.tables.items():
            if t is None:
                continue
            st = t.stats()
            g_rows.labels(table=name).set(st.num_rows)
            if getattr(t, "_tier", None) is not None:
                g_bytes.labels(table=name, tier="hot").set(st.hot_bytes)
                g_bytes.labels(table=name, tier="cold").set(st.cold_bytes)
                g_demote.labels(table=name).set(st.demotions)
                g_evict.labels(table=name).set(st.evictions)
                g_decode.labels(table=name).set(
                    round(st.decode_seconds, 6)
                )
            else:
                g_bytes.labels(table=name, tier="hot").set(st.bytes)
            g_rows_t.labels(table=name).set(st.rows_added)
            g_bytes_t.labels(table=name).set(st.bytes_added)
            g_exp_t.labels(table=name).set(st.bytes_expired)
            if st.watermark >= 0:
                g_lag.labels(table=name).set(
                    round((now_ns - st.watermark) / 1e9, 3)
                )
        reg.gauge(
            "pixie_device_cache_bytes",
            "Device-resident window bytes (all tables)",
        ).set(total_resident_bytes())
        # Window-prefetch pipeline (exec/pipeline.py) lifetime totals.
        pt = engine.pipeline_totals
        reg.gauge(
            "pixie_pipeline_depth",
            "Configured window-prefetch depth (1 = serial)",
        ).set(engine.pipeline_depth or get_flag("pipeline_depth"))
        reg.gauge(
            "pixie_pipeline_windows_total",
            "Windows executed through the window pipeline",
        ).set(pt["windows"])
        reg.gauge(
            "pixie_pipeline_stage_seconds_total",
            "Prefetch-thread seconds spent staging windows",
        ).set(round(pt["stage_secs"], 6))
        reg.gauge(
            "pixie_pipeline_stall_seconds_total",
            "Query-thread seconds stalled waiting for a window",
        ).set(round(pt["stall_secs"], 6))

    return collect

"""Query load tester: concurrency sweep against a broker.

Reference parity: the vizier query load tester
(``src/vizier/utils/loadtester``) — N concurrent clients, M queries
each, latency percentiles and error counts. Works against an in-process
``QueryBroker`` or a remote broker over the netbus (``RemoteBus`` + the
``broker.execute`` topic).

CLI:

    python -m pixie_tpu_torch.services.load_tester --concurrency 1,2,4 \\
        [--broker HOST:PORT | --local [--device cpu]] [--script q.pxl] \\
        [--per-worker N]

runs the same offered load at each client-thread count N and reports
qps + p50/p95/p99 per N — client-side latencies plus the per-run
quantiles from the serving process's own ``pixie_query_duration_seconds``
histogram deltas. Flat qps from 1 -> N client threads means the serving
path serializes; scaling qps is the concurrency unlock, measured.

A port of the JAX package's ``services/load_tester.py``. ``--local``
builds a port ``Engine`` on the CUDA card unless ``--device cpu`` (or
``PIXIE_TPU_TORCH_DEVICE=cpu``) names the CPU; without a card it exits
with the engine's error. The CPU-sample and histogram deltas read the
port's ``ingest/profiler.py`` and ``services/observability.py``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class LoadReport:
    queries: int = 0
    errors: int = 0
    partials: int = 0  # queries that returned with partial=True
    # Queries shed at admission before any dispatch (the structured
    # "admission-shed" refusal: deadline lapsed while queued). Counted
    # separately from errors_by_type so tenancy gates can assert "the
    # victim tenant shed ZERO queries" directly.
    sheds: int = 0
    errors_by_type: dict = field(default_factory=dict)
    latencies_s: list = field(default_factory=list)
    # Worst result staleness any query of the run reported
    # (freshness_lag_ms: the same number the agents fold into the
    # __queries__ column — worst scanned-table watermark lag at execute
    # time). A staleness regression (ingest stalling under load, a PEM
    # falling behind) shows up here even when latency holds.
    max_freshness_lag_ms: float = 0.0
    wall_s: float = 0.0
    # Per-run view through the SERVER's pixie_query_duration_seconds
    # histogram (the tracer records every finished query there): the
    # concurrency-bench axis — what the serving process itself measured
    # between this run's start and end, vs the client-side latencies
    # above which include bus round trips. None when the histogram is
    # not in this process (remote broker) or saw no observations.
    hist_quantiles_s: dict | None = None
    hist_count: int = 0
    # Repeat-mode only: result-cache disposition counts over the run
    # ({"hit": 37, "miss": 1, ...} from the broker reply's ``cache``
    # key / the engine trace). Empty outside --repeat-script runs.
    cache_counts: dict = field(default_factory=dict)
    # Per-tenant CPU-seconds burned during the run, from the serving
    # process's pixie_cpu_samples_total{tenant} counter deltas scaled
    # by the profiler's sampling period (ingest/profiler.py) — the
    # tenancy gate's "the noisy tenant's burn is VISIBLE" assertion
    # next to qps/p99. Empty when self-profiling is off or the
    # profiler runs in another process (remote broker).
    cpu_seconds_by_tenant: dict = field(default_factory=dict)
    # Transport-tier view of the run: p99 dispatcher lag through the
    # serving process's pixie_bus_dispatch_lag_seconds histogram
    # (delta-bracketed like hist_quantiles_s) and the worst
    # pixie_bus_queue_high_water gauge across topic classes. Queueing
    # INSIDE the bus — a subscriber falling behind the offered load —
    # shows up here before it widens the end-to-end latency columns.
    # None/0 when the bus runs in another process or bus_telemetry is
    # off.
    bus_lag_p99_ms: float | None = None
    bus_queue_high_water: int = 0

    @property
    def failure_rate(self) -> float:
        return self.errors / self.queries if self.queries else 0.0

    @property
    def cache_hit_rate(self) -> float:
        """hit + view over all queries that reported a disposition
        (a "view" answer IS a repeat served from sketch state)."""
        total = sum(self.cache_counts.values())
        if not total:
            return 0.0
        served = (self.cache_counts.get("hit", 0)
                  + self.cache_counts.get("view", 0))
        return served / total

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile: ceil(p/100 * N)-th smallest."""
        if not self.latencies_s:
            return float("nan")
        import math

        xs = sorted(self.latencies_s)
        i = max(math.ceil(p / 100.0 * len(xs)) - 1, 0)
        return xs[min(i, len(xs) - 1)]

    def to_dict(self) -> dict:
        out = {
            "queries": self.queries,
            "errors": self.errors,
            "failure_rate": round(self.failure_rate, 4),
            "errors_by_type": dict(self.errors_by_type),
            "partials": self.partials,
            "sheds": self.sheds,
            "qps": (
                round(self.queries / self.wall_s, 2) if self.wall_s else 0.0
            ),
            "p50_ms": round(self.percentile(50) * 1e3, 2),
            "p95_ms": round(self.percentile(95) * 1e3, 2),
            "p99_ms": round(self.percentile(99) * 1e3, 2),
            "max_freshness_lag_ms": round(self.max_freshness_lag_ms, 1),
            "wall_s": round(self.wall_s, 2),
        }
        if self.hist_quantiles_s is not None:
            out["hist_count"] = self.hist_count
            for q, v in sorted(self.hist_quantiles_s.items()):
                out[f"hist_p{int(q * 100)}_ms"] = round(v * 1e3, 2)
        if self.cache_counts:
            out["cache_counts"] = dict(self.cache_counts)
            out["cache_hit_rate"] = round(self.cache_hit_rate, 4)
        if self.cpu_seconds_by_tenant:
            out["cpu_seconds_by_tenant"] = dict(self.cpu_seconds_by_tenant)
        if self.bus_lag_p99_ms is not None:
            out["bus_lag_p99_ms"] = round(self.bus_lag_p99_ms, 3)
        if self.bus_queue_high_water:
            out["bus_queue_high_water"] = self.bus_queue_high_water
        return out


@dataclass
class TenantStream:
    """One tenant's offered load in a mixed-tenant run: ``workers``
    concurrent clients each firing ``per_worker`` queries of ``query``
    under this tenant/priority/deadline."""

    tenant: str
    query: str
    workers: int = 1
    per_worker: int = 10
    priority: int = 0
    deadline_ms: float | None = None
    timeout_s: float = 30.0


def _worker_loop(execute, query: str, per_worker: int, timeout_s: float,
                 report: LoadReport, lock: threading.Lock,
                 exec_kw: dict | None = None,
                 until: threading.Event | None = None) -> None:
    """Shared per-worker query loop for the plain and mixed modes:
    ``per_worker`` queries, and more until ``until`` is set when one is
    given."""
    kw = exec_kw or {}
    fired = 0
    while fired < per_worker or (until is not None and not until.is_set()):
        fired += 1
        t0 = time.perf_counter()
        err = None
        shed = False
        partial = False
        fresh_ms = 0.0
        try:
            res = execute(query, timeout_s, **kw)
            partial = bool(isinstance(res, dict) and res.get("partial"))
            # Broker replies carry the staleness as a dict key;
            # api.ScriptResults (a dict of TABLES) as an attribute.
            v = res.get("freshness_lag_ms") if isinstance(res, dict) else None
            if v is None:
                v = getattr(res, "freshness_lag_ms", None)
            fresh_ms = float(v or 0.0)
        except Exception as e:
            err = type(e).__name__
            # The admission scheduler's structured deadline shed (never
            # dispatched) is a distinct outcome from a failure.
            shed = "admission-shed" in str(e)
        dt = time.perf_counter() - t0
        with lock:
            report.queries += 1
            if err is None:
                report.latencies_s.append(dt)
                report.max_freshness_lag_ms = max(
                    report.max_freshness_lag_ms, fresh_ms
                )
                if partial:
                    report.partials += 1
            else:
                report.errors += 1
                if shed:
                    report.sheds += 1
                report.errors_by_type[err] = (
                    report.errors_by_type.get(err, 0) + 1
                )


def _hist_snapshot():
    from .observability import default_registry

    return default_registry.histogram_state("pixie_query_duration_seconds")


def _bus_hist_snapshot():
    from .observability import default_registry

    return default_registry.histogram_state(
        "pixie_bus_dispatch_lag_seconds"
    )


def _attach_bus_delta(report: LoadReport, before) -> None:
    """Transport-tier bracket: this run's dispatcher-lag p99 (delta
    over the cumulative bus histogram, all topic classes) and the worst
    queue high-water gauge. The gauge is monotonic per process, so no
    before-snapshot — the end value IS the worst ever seen, which is
    the number the capacity question ("did anything queue?") needs."""
    from .observability import default_registry, delta_quantiles

    after = _bus_hist_snapshot()
    if after is not None:
        if before is None:
            bounds, counts, _total, _sum = after
            before = (bounds, [0] * len(counts), 0, 0.0)
        q = delta_quantiles(before, after)
        if q:
            report.bus_lag_p99_ms = q.get(0.99, 0.0) * 1e3
    hw = default_registry.values("pixie_bus_queue_high_water")
    if hw:
        report.bus_queue_high_water = int(max(hw.values()))


def _cpu_samples_snapshot(tenants) -> dict:
    """{tenant: cumulative pixie_cpu_samples_total value} for the run's
    tenants (resolved through the registered set, like every label)."""
    from .observability import default_counter
    from .tenancy import resolve_tenant

    counter = default_counter(
        "pixie_cpu_samples_total",
        "Profiler stack samples attributed to each tenant "
        "(samples * sampling period = CPU-seconds)",
    )
    out: dict = {}
    for raw in tenants:
        tenant = resolve_tenant(raw, count_unknown=False)
        out[tenant] = counter.labels(tenant=tenant).value()
    return out


def _attach_cpu_delta(report: LoadReport, before: dict, after: dict) -> None:
    """Per-tenant CPU-seconds for the run: counter delta scaled by the
    profiler's sampling period (count * period = CPU-seconds)."""
    from ..ingest.profiler import PerfProfilerConnector

    period = PerfProfilerConnector.default_sampling_period_s
    for tenant, v in after.items():
        d = v - before.get(tenant, 0.0)
        if d > 0:
            report.cpu_seconds_by_tenant[tenant] = round(d * period, 3)


def _attach_hist_delta(report: LoadReport, before, after) -> None:
    from .observability import delta_quantiles

    if before is None and after is not None:
        # The histogram registers lazily on the FIRST finished query —
        # a missing before-snapshot in a fresh process means zero
        # observations, not "no data": synthesize the empty state so
        # the first run still reports its quantiles.
        bounds, counts, _total, _sum = after
        before = (bounds, [0] * len(counts), 0, 0.0)
    report.hist_quantiles_s = delta_quantiles(before, after)
    if before is not None and after is not None:
        report.hist_count = after[2] - before[2]


def run_load(
    execute,
    query: str,
    workers: int = 4,
    per_worker: int = 10,
    timeout_s: float = 30.0,
    tenant: str | None = None,
    priority: int = 0,
    deadline_ms: float | None = None,
) -> LoadReport:
    """Fire ``workers * per_worker`` queries through ``execute``.

    ``execute(query, timeout_s, **tenancy_kw)`` is any callable that
    raises on failure — ``broker_executor`` / ``remote_executor`` below
    adapt the two broker surfaces to it. The optional tenancy kwargs
    scope every query of the run to one tenant/priority/deadline.
    """
    report = LoadReport()
    lock = threading.Lock()
    kw: dict = {}
    if tenant is not None:
        kw["tenant"] = tenant
    if priority:
        kw["priority"] = priority
    if deadline_ms is not None:
        kw["deadline_ms"] = deadline_ms

    # Snapshot the server-side latency histogram around the run so the
    # report carries per-run quantiles from the SERVING process's own
    # measurement (delta interpolation over cumulative buckets). Same
    # bracket for the profiler's per-tenant CPU counter: the delta is
    # this run's attributed burn.
    hist_before = _hist_snapshot()
    bus_before = _bus_hist_snapshot()
    cpu_before = _cpu_samples_snapshot([tenant] if tenant else [])
    t_start = time.perf_counter()
    threads = [
        threading.Thread(target=_worker_loop, args=(
            execute, query, per_worker, timeout_s, report, lock, kw,
        ))
        for _ in range(workers)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    report.wall_s = time.perf_counter() - t_start
    _attach_hist_delta(report, hist_before, _hist_snapshot())
    _attach_bus_delta(report, bus_before)
    _attach_cpu_delta(
        report, cpu_before,
        _cpu_samples_snapshot([tenant] if tenant else []),
    )
    return report


def run_mixed_load(execute, streams, until=None) -> dict:
    """Mixed-tenant mode: run every :class:`TenantStream` CONCURRENTLY
    against one broker and report a ``LoadReport`` per stream — the
    measurement seam for the p99-isolation contract (a saturating noisy
    tenant queues behind its own backlog; the victim tenant's latency
    distribution and shed count must hold at its solo baseline).

    ``until`` (a ``threading.Event``; the port's addition) keeps every
    worker firing past its ``per_worker`` count until it is set: the
    chaos soak holds its load open for the whole fault schedule.
    """
    # One report PER STREAM: two streams may share a tenant (same
    # tenant at different priorities/deadlines) and their latency
    # distributions must not silently merge — duplicates get a
    # positional suffix ("dash", "dash#1", ...).
    keys, seen = [], {}
    for s in streams:
        n = seen.get(s.tenant, 0)
        seen[s.tenant] = n + 1
        keys.append(s.tenant if n == 0 else f"{s.tenant}#{n}")
    reports = {k: LoadReport() for k in keys}
    locks = {k: threading.Lock() for k in keys}
    threads = []
    for key, s in zip(keys, streams):
        kw = {"tenant": s.tenant, "priority": s.priority,
              "deadline_ms": s.deadline_ms}
        threads.extend(
            threading.Thread(target=_worker_loop, args=(
                execute, s.query, s.per_worker, s.timeout_s,
                reports[key], locks[key], kw, until,
            ))
            for _ in range(s.workers)
        )
    tenants = sorted({s.tenant for s in streams if s.tenant})
    cpu_before = _cpu_samples_snapshot(tenants)
    bus_before = _bus_hist_snapshot()
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    cpu_after = _cpu_samples_snapshot(tenants)
    from .tenancy import resolve_tenant

    for key, s in zip(keys, streams):
        reports[key].wall_s = wall
        # Per-TENANT burn, not per-stream: two streams sharing a tenant
        # ("dash", "dash#1") each report the tenant's total — the CPU
        # counter only carries the tenant label, and splitting it would
        # fake a precision the sampler doesn't have.
        own = resolve_tenant(s.tenant, count_unknown=False)
        _attach_cpu_delta(
            reports[key],
            {own: cpu_before.get(own, 0.0)},
            {own: cpu_after.get(own, 0.0)},
        )
        # The bus is shared across streams: every report carries the
        # run's WHOLE transport view (per-stream attribution would need
        # a tenant label the bus histogram deliberately doesn't carry).
        _attach_bus_delta(reports[key], bus_before)
    return reports


def run_concurrency_sweep(
    execute,
    query: str,
    concurrencies=(1, 2, 4),
    per_worker: int = 10,
    timeout_s: float = 30.0,
    warmup: int = 1,
    **tenancy_kw,
) -> dict:
    """The ``--concurrency`` axis: the same per-worker offered load at
    each client-thread count N, sequentially, against one engine/broker.
    Returns {N: LoadReport}. ``warmup`` queries run first (uncounted) so
    sweep point 1 doesn't pay the first query's setup (plan compile,
    kernel build, first staging) that later points then amortize — the
    N=1 row is the serial baseline the scaling rows are read against."""
    for _ in range(max(0, int(warmup))):
        try:
            execute(query, timeout_s)
        except Exception:
            break  # the measured runs will report the failure mode
    out = {}
    for n in concurrencies:
        out[int(n)] = run_load(
            execute, query, workers=int(n), per_worker=per_worker,
            timeout_s=timeout_s, **tenancy_kw,
        )
    return out


def run_repeat_load(
    execute,
    query: str,
    qps: float = 10.0,
    count: int = 50,
    timeout_s: float = 30.0,
    status_fn=None,
    **tenancy_kw,
) -> LoadReport:
    """The ``--repeat-script`` axis: ONE client firing the SAME script
    ``count`` times at a fixed ``qps`` — the dashboard-refresh shape the
    result cache exists for. Each reply's cache disposition (broker
    reply ``cache`` key, or ``status_fn(res)`` for executors that don't
    carry one) is tallied into ``report.cache_counts``; latencies and
    the serving-histogram delta are recorded exactly like ``run_load``,
    so two runs of this under cache-on/cache-off flags are directly
    comparable (``run_repeat_ab``)."""
    report = LoadReport()
    kw = {k: v for k, v in tenancy_kw.items() if v is not None}
    interval = 1.0 / qps if qps > 0 else 0.0
    hist_before = _hist_snapshot()
    t_start = time.perf_counter()
    next_t = t_start
    for _ in range(max(1, int(count))):
        # Fixed-rate pacing on the SCHEDULE, not the completion: a slow
        # query eats into the next slot instead of silently lowering
        # the offered rate (open-loop load, the dashboard's behavior).
        if interval:
            now = time.perf_counter()
            if now < next_t:
                time.sleep(next_t - now)
            next_t += interval
        t0 = time.perf_counter()
        err = None
        status = ""
        fresh_ms = 0.0
        partial = False
        try:
            res = execute(query, timeout_s, **kw)
            partial = bool(isinstance(res, dict) and res.get("partial"))
            if status_fn is not None:
                status = status_fn(res) or ""
            elif isinstance(res, dict):
                status = res.get("cache", "") or ""
            v = res.get("freshness_lag_ms") if isinstance(res, dict) else None
            if v is None:
                v = getattr(res, "freshness_lag_ms", None)
            fresh_ms = float(v or 0.0)
        except Exception as e:
            err = type(e).__name__
        dt = time.perf_counter() - t0
        report.queries += 1
        if err is None:
            report.latencies_s.append(dt)
            report.max_freshness_lag_ms = max(
                report.max_freshness_lag_ms, fresh_ms
            )
            report.cache_counts[status] = (
                report.cache_counts.get(status, 0) + 1
            )
            if partial:
                report.partials += 1
        else:
            report.errors += 1
            report.errors_by_type[err] = (
                report.errors_by_type.get(err, 0) + 1
            )
    report.wall_s = time.perf_counter() - t_start
    _attach_hist_delta(report, hist_before, _hist_snapshot())
    return report


def run_repeat_ab(
    execute,
    query: str,
    qps: float = 10.0,
    count: int = 50,
    timeout_s: float = 30.0,
    cache_mb: int = 64,
    status_fn=None,
    **tenancy_kw,
) -> dict:
    """Cache-off vs cache-on A/B of the same repeated script against
    one IN-PROCESS engine/broker (the flag overrides only reach this
    process — a remote broker keeps its own configuration; use a plain
    ``run_repeat_load`` there and read the hit rate). Returns
    ``{"cache_off": LoadReport, "cache_on": LoadReport}`` — each phase
    carries its own serving-histogram delta, so cache_on's p50/p99
    against cache_off's IS the repeat-serving speedup, measured where
    the queries were served."""
    from ..config import override_flag

    with override_flag("result_cache_mb", 0), \
            override_flag("view_auto_min_runs", 0):
        off = run_repeat_load(
            execute, query, qps=qps, count=count, timeout_s=timeout_s,
            status_fn=status_fn, **tenancy_kw,
        )
    with override_flag("result_cache_mb", int(cache_mb)):
        on = run_repeat_load(
            execute, query, qps=qps, count=count, timeout_s=timeout_s,
            status_fn=status_fn, **tenancy_kw,
        )
    return {"cache_off": off, "cache_on": on}


def broker_executor(broker):
    """Adapter for an in-process QueryBroker."""

    def execute(query, timeout_s, **kw):
        kw = {k: v for k, v in kw.items() if v is not None}
        return broker.execute_script(query, timeout_s=timeout_s, **kw)

    return execute


def remote_executor(host: str, port: int):
    """Adapter for a served broker over the netbus (one shared conn)."""
    from .netbus import RemoteBus

    bus = RemoteBus(host, port)

    def execute(query, timeout_s, **kw):
        req = {"query": query, "timeout_s": timeout_s}
        req.update((k, v) for k, v in kw.items() if v is not None)
        res = bus.request(
            "broker.execute", req, timeout_s=timeout_s + 5,
        )
        if not res.get("ok"):
            raise RuntimeError(res.get("error", "unknown broker error"))
        return res

    execute.close = bus.close  # type: ignore[attr-defined]
    return execute


# -- CLI ----------------------------------------------------------------------

_LOCAL_QUERY = (
    "import px\n"
    "df = px.DataFrame(table='http_events')\n"
    "df = df.groupby('service').agg(\n"
    "    n=('latency_ns', px.count), mean=('latency_ns', px.mean))\n"
    "px.display(df, 'out')\n"
)


def resolve_device(device=None):
    """The device of an entry point's engines: ``device`` when given,
    else ``PIXIE_TPU_TORCH_DEVICE``, else the CUDA card (raises without
    one)."""
    from ..deploy import env_device
    from ..exec.engine import resolve_device as _resolve

    return _resolve(device) if device is not None else env_device()


def local_executor(rows: int = 200_000, window_rows: int = 1 << 15,
                   seed: int = 7, device=None):
    """In-process single-engine executor over a seeded synthetic table
    (the ``--local`` mode: measures the ENGINE's concurrency, no
    broker/bus in the path). The engine runs on ``device``
    (:func:`resolve_device`)."""
    import numpy as np

    from ..exec.engine import Engine

    rng = np.random.default_rng(seed)
    engine = Engine(window_rows=window_rows, device=resolve_device(device))
    engine.append_data("http_events", {
        "time_": np.arange(rows, dtype=np.int64),
        "latency_ns": rng.integers(1_000, 1_000_000, rows),
        "service": [f"svc-{i % 8}" for i in range(rows)],
    })

    def execute(query, timeout_s, **kw):
        return engine.execute_query(query)

    execute.engine = engine  # type: ignore[attr-defined]
    return execute


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m pixie_tpu_torch.services.load_tester",
        description=(
            "Concurrency load sweep: N client threads against one "
            "engine/broker, qps + p50/p95/p99 per N (client-side and "
            "serving-histogram deltas)."
        ),
    )
    ap.add_argument("--broker", metavar="HOST:PORT",
                    help="remote broker over the netbus")
    ap.add_argument("--local", action="store_true",
                    help="in-process engine over a synthetic table")
    ap.add_argument("--script", help=".pxl file (default: a groupby "
                                     "over the local synthetic table)")
    ap.add_argument("--concurrency", default="1,2,4",
                    help="comma-separated client-thread counts")
    ap.add_argument("--repeat-script", action="store_true",
                    help="repeat mode: fire --script (or the local "
                         "default) at a fixed --qps from one client and "
                         "report the cache hit rate plus a cache-on/off "
                         "p50/p99 A/B (in-process modes only)")
    ap.add_argument("--qps", type=float, default=10.0,
                    help="repeat-mode offered rate")
    ap.add_argument("--count", type=int, default=50,
                    help="repeat-mode queries per phase")
    ap.add_argument("--cache-mb", type=int, default=64,
                    help="repeat-mode cache budget for the ON phase")
    ap.add_argument("--per-worker", type=int, default=10)
    ap.add_argument("--timeout-s", type=float, default=30.0)
    ap.add_argument("--rows", type=int, default=200_000,
                    help="--local synthetic table size")
    ap.add_argument("--device", default=None,
                    help="--local engine's device: cuda (default) or cpu; "
                         "also $PIXIE_TPU_TORCH_DEVICE")
    ap.add_argument("--tenant", default=None)
    ap.add_argument("--priority", type=int, default=0)
    ap.add_argument("--deadline-ms", type=float, default=None)
    args = ap.parse_args(argv)

    if bool(args.broker) == bool(args.local):
        ap.error("exactly one of --broker or --local is required")
    if args.device is not None and not args.local:
        ap.error("--device applies to --local (a remote broker's agents "
                 "own their devices)")
    if args.local and (
        args.tenant is not None or args.priority
        or args.deadline_ms is not None
    ):
        # The local executor calls the engine directly — no broker, no
        # admission path. Silently dropping these would print
        # tenancy-shaped numbers that never exercised tenancy.
        ap.error("--tenant/--priority/--deadline-ms require --broker "
                 "(the local engine has no admission path)")
    if args.script:
        with open(args.script) as f:
            query = f.read()
    else:
        if not args.local:
            ap.error("--script is required with --broker")
        query = _LOCAL_QUERY
    try:
        concurrencies = [
            int(c) for c in str(args.concurrency).split(",") if c.strip()
        ]
    except ValueError:
        ap.error(f"bad --concurrency {args.concurrency!r}")
    if args.local:
        try:
            execute = local_executor(rows=args.rows, device=args.device)
        except (RuntimeError, ValueError) as e:  # no card, bad device
            print(f"error: {e} (--device cpu or PIXIE_TPU_TORCH_DEVICE=cpu "
                  "runs it on the CPU)",
                  file=sys.stderr)
            return 1
    else:
        host, _, port = args.broker.rpartition(":")
        execute = remote_executor(host or "127.0.0.1", int(port))
    try:
        if args.repeat_script:
            status_fn = None
            if args.local:
                # The engine returns bare result tables; the trace
                # carries the disposition of the query just served.
                eng = execute.engine  # type: ignore[attr-defined]
                status_fn = lambda res: (  # noqa: E731
                    getattr(eng.tracer.last(), "cache", "")
                )
            if args.broker:
                # Flag overrides don't cross the bus: measure the
                # remote broker AS CONFIGURED, hit rate included.
                rep = run_repeat_load(
                    execute, query, qps=args.qps, count=args.count,
                    timeout_s=args.timeout_s, tenant=args.tenant,
                    priority=args.priority or None,
                    deadline_ms=args.deadline_ms,
                )
                print(json.dumps({"configured": rep.to_dict()}, indent=2))
                return 0 if rep.errors == 0 else 1
            ab = run_repeat_ab(
                execute, query, qps=args.qps, count=args.count,
                timeout_s=args.timeout_s, cache_mb=args.cache_mb,
                status_fn=status_fn,
            )
            out = {k: r.to_dict() for k, r in ab.items()}
            off_p50 = ab["cache_off"].percentile(50)
            on_p50 = ab["cache_on"].percentile(50)
            if on_p50 and off_p50 == off_p50 and on_p50 == on_p50:
                out["p50_speedup"] = round(off_p50 / on_p50, 2)
            print(json.dumps(out, indent=2))
            return 0 if all(r.errors == 0 for r in ab.values()) else 1
        reports = run_concurrency_sweep(
            execute, query, concurrencies=concurrencies,
            per_worker=args.per_worker, timeout_s=args.timeout_s,
            tenant=args.tenant, priority=args.priority,
            deadline_ms=args.deadline_ms,
        )
        print(json.dumps(
            {str(n): r.to_dict() for n, r in reports.items()}, indent=2
        ))
        return 0 if all(r.errors == 0 for r in reports.values()) else 1
    finally:
        close = getattr(execute, "close", None)
        if close is not None:
            close()


if __name__ == "__main__":
    raise SystemExit(main())

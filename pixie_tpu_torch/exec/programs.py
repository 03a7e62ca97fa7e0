"""Device-tier observability: the program registry and device memory.

A port of the JAX package's ``exec/programs.py``. Eager PyTorch has no
XLA executable to own, so the registry records what the port really
compiles and reuses:

- ``fragment_update`` / ``fragment_finalize``: one record per fragment
  bind (``exec/fragment.py`` ``compile_fragment``), keyed by the chain's
  structural key and the input schema (its shape signature). The bind's
  wall time is the record's compile time; a later bind of the same key
  (a repeated plan) is a hit.
- ``join_single_shot`` / ``join_probe_sorted`` / ``join_probe_radix``:
  one record per device join driver shape (``exec/joins.py``), keyed as
  the JAX drivers' programs are (bucketed shapes, capacity, how). Eager
  drivers compile nothing, so their compile time is 0; each dispatch
  after the first is a hit.
- ``cuda_library`` / ``native_library``: one record per ``nvcc`` library
  (``ops/cuda_lib.py``) and per ``g++`` library (``native/``). The
  compile time is the build's wall time, 0 when the ``.so`` was already
  built; a kernel's hits are its launches (``cuda_lib.count_launch``).

Each ``ProgramRecord`` holds compile and hit counters; the XLA
``cost_analysis`` and ``memory_analysis`` fields stay None, as the JAX
record leaves them on a backend without them. Program ids are stable
content hashes, so the records of one program in several processes
merge in ``px/program_cost``.

Surfaces: ``pixie_program_cache_{hits,misses,evictions}_total`` counters
and the ``pixie_compile_seconds`` histogram on the default metrics
registry, ``/debug/programz`` (``services/observability.py``) and the
``__programs__`` telemetry table (``services/telemetry.py`` drains
:meth:`ProgramRegistry.rows` per finished trace).

**DeviceMemoryMonitor** brackets every ``execute_plan``
(:meth:`query_begin` / :meth:`query_end`) and stamps the query's peak
into ``QueryResourceUsage.device_peak_bytes``: the torch allocator's
high-water mark on the engine's card, reset when the first open query on
that card begins. A lone query gets its own peak. Queries that overlap
on one card (several engines in one process) each get the peak of the
busy period they ran in: an upper bound on their own, never an under-
count, and no query's reset clears another's peak. A CPU engine gets
None. ``pixie_device_memory_bytes{device,kind}`` gauges refresh at every
``/metrics`` scrape.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import time

from ..config import get_flag

#: ``pixie_compile_seconds`` buckets: a fragment binds in well under a
#: millisecond to tens of ms, an nvcc library builds in seconds.
COMPILE_BUCKETS = (
    0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
    30.0, 60.0, 300.0,
)

#: torch allocator counters exported per card as
#: ``pixie_device_memory_bytes{device,kind}`` (the JAX package's kinds
#: where the allocator has one).
_MEM_KINDS = (
    ("bytes_in_use", "allocated_bytes.all.current"),
    ("peak_bytes_in_use", "allocated_bytes.all.peak"),
    ("bytes_reserved", "reserved_bytes.all.current"),
)


def _program_id(kind: str, key, sig) -> str:
    """Stable 64-bit id of a (kind, key, signature): the same program
    has the same id in every process."""
    return hashlib.blake2b(
        repr((kind, key, sig)).encode(), digest_size=8
    ).hexdigest()


class ProgramRecord:
    """One tracked program: a (program key, shape signature) pair and
    everything observed about it."""

    __slots__ = (
        "program_id", "kind", "label", "sig_repr", "plan_hash", "compiles",
        "hits", "compile_s_total", "compile_s_last", "flops",
        "bytes_accessed", "argument_bytes", "output_bytes", "temp_bytes",
        "peak_bytes", "created_ns", "last_used_ns", "seq",
    )

    def __init__(self, program_id: str, kind: str, label: str,
                 sig_repr: str, plan_hash: str = ""):
        self.program_id = program_id
        self.kind = kind
        self.label = label
        self.sig_repr = sig_repr
        self.plan_hash = plan_hash
        self.compiles = 0
        self.hits = 0
        self.compile_s_total = 0.0
        self.compile_s_last = 0.0
        # XLA analyses in the JAX record; eager PyTorch has none.
        self.flops = None
        self.bytes_accessed = None
        self.argument_bytes = None
        self.output_bytes = None
        self.temp_bytes = None
        self.peak_bytes = None
        self.created_ns = time.time_ns()
        self.last_used_ns = self.created_ns
        self.seq = 0  # registry change sequence (telemetry drain)

    def to_dict(self) -> dict:
        """The /debug/programz row."""
        return {
            "program_id": self.program_id,
            "kind": self.kind,
            "label": self.label,
            "shape": self.sig_repr,
            "plan_hash": self.plan_hash,
            "cached": False,
            "compiles": self.compiles,
            "hits": self.hits,
            "compile_ms": round(self.compile_s_total * 1e3, 3),
            "compile_ms_last": round(self.compile_s_last * 1e3, 3),
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "argument_bytes": self.argument_bytes,
            "output_bytes": self.output_bytes,
            "temp_bytes": self.temp_bytes,
            "peak_bytes": self.peak_bytes,
            "created_ns": self.created_ns,
            "last_used_ns": self.last_used_ns,
        }


class ProgramRegistry:
    """Bounded LRU of :class:`ProgramRecord`. Thread-safe."""

    def __init__(self, metrics_registry=None, size: int | None = None):
        self._metrics_registry = metrics_registry
        self._size = size  # None = read program_registry_size per miss
        self._lock = threading.Lock()
        self._records: dict = {}  # (kind, key, sig) -> ProgramRecord
        self._seq = 0
        self._metrics: dict | None = None
        # LRU-evicted records, keyed by program_id (counters kept):
        # rows() still drains an evicted record's final state, and a
        # re-created record resumes these counters, so the stream per
        # program_id stays monotonic. Bounded FIFO at 4x the size.
        self._evicted: dict = {}
        # Hits batch here and flush to the shared counter every
        # _HIT_FLUSH hits and at every surface read: a kernel launch is a
        # hit, and a round trip through the metrics registry's lock per
        # launch would sit on every wrapper's host path.
        self._pending_hits = 0

    def enabled(self) -> bool:
        return self._max_size() > 0

    def _max_size(self) -> int:
        if self._size is not None:
            return int(self._size)
        return int(get_flag("program_registry_size"))

    # -- metrics -------------------------------------------------------------
    def _m(self) -> dict:
        if self._metrics is not None:
            return self._metrics
        with self._lock:
            if self._metrics is not None:
                return self._metrics
            if self._metrics_registry is None:
                from ..services.observability import default_registry

                self._metrics_registry = default_registry
            reg = self._metrics_registry
            # Flush the batched hits at every /metrics render, so a
            # scrape never under-reports by the batch remainder.
            reg.register_collector(self._flush_hits_collector)
            self._metrics = {
                "hits": reg.counter(
                    "pixie_program_cache_hits_total",
                    "Tracked program uses served by an earlier compile "
                    "(a repeated fragment bind, join dispatch or kernel "
                    "launch)",
                ),
                "misses": reg.counter(
                    "pixie_program_cache_misses_total",
                    "Tracked programs compiled (first bind of a fragment "
                    "key, first join driver shape, library build)",
                ),
                "evictions": reg.counter(
                    "pixie_program_cache_evictions_total",
                    "Program records LRU-evicted from the registry",
                ),
                "compile": reg.histogram(
                    "pixie_compile_seconds",
                    "Compile wall time per tracked program (fragment "
                    "bind, library build)",
                    buckets=COMPILE_BUCKETS,
                ),
            }
        return self._metrics

    #: Batched hits flush to the shared counter at this granularity.
    _HIT_FLUSH = 64

    def _flush_hits_locked(self) -> int:
        """Caller holds self._lock; returns the count to add OUTSIDE."""
        flush, self._pending_hits = self._pending_hits, 0
        return flush

    def _flush_hits(self, flush: int) -> None:
        if flush:
            self._m()["hits"].inc(flush)

    def _flush_hits_collector(self, _reg) -> None:
        """Metrics-render collector: drain the batched hit count."""
        with self._lock:
            flush = self._flush_hits_locked()
        if flush:
            self._metrics["hits"].inc(flush)

    # -- recording -----------------------------------------------------------
    def observe(self, kind: str, key, label: str = "", sig=(),
                sig_repr: str = "", compile_s: float = 0.0) -> bool:
        """One use of a program: the first use of (kind, key, sig) is a
        compile of ``compile_s`` seconds, every later one a hit. Returns
        whether it was a hit. No-op (False) while the registry is off."""
        if not self.enabled():
            return False
        full = (kind, key, sig)
        with self._lock:
            rec = self._records.get(full)
            flush = self._hit_locked(rec) if rec is not None else 0
        if rec is not None:
            self._flush_hits(flush)
            return True
        self._record_compile(kind, key, label, sig, sig_repr, compile_s)
        return False

    def record_build(self, kind: str, name: str, compile_s: float) -> None:
        """A library ``name`` built in ``compile_s`` seconds (0 when its
        ``.so`` was already built): a new record, or one more compile of
        a rebuilt library. A load of an already-recorded library adds
        nothing."""
        if not self.enabled():
            return
        with self._lock:
            rec = self._records.get((kind, name, ()))
        if rec is None or compile_s > 0:
            self._record_compile(kind, name, name, (), "", compile_s)

    def hit(self, kind: str, key, label: str = "") -> None:
        """One use of an already-compiled program (a kernel launch, on
        the wrapper's host path: one dict lookup under the lock). A
        record evicted since its compile comes back with no compile."""
        full = (kind, key, ())
        evicted = 0
        with self._lock:
            rec = self._records.get(full)
            if rec is None:
                if not self.enabled():
                    return
                rec = self._new_record_locked(kind, key, label, (), "")
                evicted = self._insert_locked(full, rec)
            flush = self._hit_locked(rec)
        self._flush_hits(flush)
        if evicted:
            self._m()["evictions"].inc(evicted)

    def _hit_locked(self, rec: ProgramRecord) -> int:
        """Count one hit; returns the batched hits to flush (0 until the
        batch is full)."""
        rec.hits += 1
        rec.last_used_ns = time.time_ns()
        self._seq += 1
        rec.seq = self._seq
        self._pending_hits += 1
        if self._pending_hits >= self._HIT_FLUSH:
            return self._flush_hits_locked()
        return 0

    def _new_record_locked(self, kind, key, label, sig, sig_repr):
        pid = _program_id(kind, key, sig)
        rec = ProgramRecord(pid, kind, label, sig_repr)
        base = self._evicted.pop(pid, None)
        if base is not None:
            # Resume the evicted incarnation's counters so the telemetry
            # stream stays monotonic per program_id.
            rec.compiles = base.compiles
            rec.hits = base.hits
            rec.compile_s_total = base.compile_s_total
        return rec

    def _record_compile(self, kind, key, label, sig, sig_repr,
                        compile_s: float) -> None:
        full = (kind, key, sig)
        with self._lock:
            rec = self._records.get(full)
            if rec is None:
                rec = self._new_record_locked(kind, key, label, sig, sig_repr)
            rec.compiles += 1
            rec.compile_s_last = compile_s
            rec.compile_s_total += compile_s
            rec.last_used_ns = time.time_ns()
            self._seq += 1
            rec.seq = self._seq
            evicted = self._insert_locked(full, rec)
        m = self._m()
        m["misses"].inc()
        m["compile"].observe(compile_s)
        if evicted:
            m["evictions"].inc(evicted)

    def _insert_locked(self, full, rec: ProgramRecord) -> int:
        """Insert ``rec`` and evict least-recently-used records over the
        size. Returns the count evicted."""
        self._records[full] = rec
        evicted = 0
        max_size = max(self._max_size(), 1)
        while len(self._records) > max_size:
            lru = min(
                self._records, key=lambda k: self._records[k].last_used_ns
            )
            gone = self._records.pop(lru)
            # Keep the counters and bump the seq so the next drain emits
            # the final row.
            self._seq += 1
            gone.seq = self._seq
            self._evicted[gone.program_id] = gone
            evicted += 1
        while len(self._evicted) > 4 * max_size:
            self._evicted.pop(next(iter(self._evicted)))
        return evicted

    # -- surfaces ------------------------------------------------------------
    def programz(self) -> dict:
        """The /debug/programz body: every record, most recent first."""
        with self._lock:
            recs = [r.to_dict() for r in self._records.values()]
            flush = self._flush_hits_locked()
        self._flush_hits(flush)
        recs.sort(key=lambda r: r["last_used_ns"], reverse=True)
        return {
            "programs": recs,
            "count": len(recs),
            "hits": sum(r["hits"] for r in recs),
            "compiles": sum(r["compiles"] for r in recs),
            "compile_ms": round(sum(r["compile_ms"] for r in recs), 3),
        }

    def rows(self, since_seq: int) -> tuple:
        """(new_cursor, rows): one ``__programs__`` row per record that
        changed since ``since_seq`` (cumulative counters; the latest row
        per program_id is its current state). Each telemetry collector
        keeps its own cursor, so N agents in one process each fold the
        full program history into their own table."""
        rows = []
        with self._lock:
            flush = self._flush_hits_locked()
            cursor = self._seq
            for rec in itertools.chain(
                self._records.values(), self._evicted.values()
            ):
                if rec.seq > since_seq:
                    rows.append({
                        "program_id": rec.program_id,
                        "kind": rec.kind,
                        "label": rec.label,
                        "compiles": rec.compiles,
                        "hits": rec.hits,
                        "compile_ms": rec.compile_s_total * 1e3,
                        "flops": 0.0,
                        "bytes_accessed": 0.0,
                        "argument_bytes": 0,
                        "temp_bytes": 0,
                        "peak_bytes": 0,
                        "last_used_ns": rec.last_used_ns,
                    })
        self._flush_hits(flush)
        return cursor, rows

    def stats(self) -> dict:
        with self._lock:
            return {
                "programs": len(self._records),
                "hits": sum(r.hits for r in self._records.values()),
                "compiles": sum(
                    r.compiles for r in self._records.values()
                ),
            }

    def clear(self) -> None:
        """Forget every live record (evicted counters are kept)."""
        with self._lock:
            self._records.clear()


def schema_signature(relation) -> tuple:
    """A fragment bind's shape signature: its input columns and types."""
    return tuple((n, dt.name) for n, dt in relation.items())


def schema_repr(sig: tuple) -> str:
    """Compact human form of a schema signature for programz."""
    parts = [f"{n}:{t}" for n, t in sig[:8]]
    if len(sig) > 8:
        parts.append("...")
    return ",".join(parts)


class DeviceMemoryMonitor:
    """The card's allocator: gauges and per-query peaks.

    ``query_begin(device)`` resets the allocator's peak on ``device``
    when no other query is open there; ``query_end`` reads the peak.
    With ``device_memory_poll_s`` > 0 a poll thread also samples the
    bytes in use into every open query's peak, as the JAX monitor does.
    A CPU device has no allocator statistics: its bracket returns None.

    A device-resident result (``exec/engine.py`` ``DeviceResult``) holds
    its bytes here (``hold``) until it is read back or dropped
    (``release``). A query's peak leaves out the bytes that results of
    earlier queries held when it began: they are not its own. (Should
    such a result be released while the query runs, and the peak come
    after that, the peak reads low by at most those bytes.)
    """

    def __init__(self, metrics_registry=None):
        self._metrics_registry = metrics_registry
        self._lock = threading.Lock()
        self._open: list[dict] = []  # live per-query peak tokens
        self._held: dict[int, tuple] = {}  # hold key -> (device, bytes)
        self._next_hold = 0
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._collector_installed = False

    # -- snapshots -----------------------------------------------------------
    @staticmethod
    def snapshot() -> dict:
        """{card label: {kind: bytes}} for every card this process has
        initialised; empty without one."""
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return {}
        out: dict = {}
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if stats:
                out[f"cuda:{i}"] = {
                    kind: int(stats.get(key, 0)) for kind, key in _MEM_KINDS
                }
        return out

    # -- device-resident results ---------------------------------------------
    def hold(self, device, nbytes: int) -> int:
        """Record ``nbytes`` held on ``device`` by a result that may
        outlive its query; returns the key ``release`` takes."""
        with self._lock:
            self._next_hold += 1
            key = self._next_hold
            self._held[key] = (device, int(nbytes))
        return key

    def release(self, key: int) -> None:
        with self._lock:
            self._held.pop(key, None)

    def held_bytes(self, device) -> int:
        """Bytes held on ``device`` by unreleased results."""
        with self._lock:
            return self._held_locked(device)

    def _held_locked(self, device) -> int:
        return sum(n for d, n in self._held.values() if d == device)

    # -- per-query peak attribution (engine execute_plan brackets) -----------
    def query_begin(self, device) -> dict | None:
        """Open a query's bracket on ``device`` (None for a CPU one)."""
        if device.type != "cuda":
            return None
        import torch

        with self._lock:
            if not any(t["device"] == device for t in self._open):
                torch.cuda.reset_peak_memory_stats(device)
            token = {"device": device,
                     "peak": torch.cuda.memory_allocated(device),
                     "carried": self._held_locked(device)}
            self._open.append(token)
        return token

    def query_end(self, token: dict | None) -> int | None:
        """The allocator's high-water bytes over the busy period the
        query ran in, less the bytes earlier queries' results held when
        it began (None for a CPU bracket)."""
        if token is None:
            return None
        import torch

        with self._lock:
            # Remove by identity: two open tokens may be ==-equal.
            self._open = [t for t in self._open if t is not token]
            peak = max(token["peak"],
                       torch.cuda.max_memory_allocated(token["device"]))
            return peak - token["carried"]

    # -- gauges + poll loop --------------------------------------------------
    def install_collector(self) -> None:
        """Refresh ``pixie_device_memory_bytes`` at every /metrics
        render (idempotent)."""
        if self._collector_installed:
            return
        if self._metrics_registry is None:
            from ..services.observability import default_registry

            self._metrics_registry = default_registry
        self._metrics_registry.register_collector(self._collect)
        self._collector_installed = True

    def _collect(self, reg) -> None:
        g = reg.gauge(
            "pixie_device_memory_bytes",
            "torch.cuda.memory_stats() snapshot per initialised card "
            "(a process without one emits nothing)",
        )
        for dev, stats in self.snapshot().items():
            for kind, v in stats.items():
                g.labels(device=dev, kind=kind).set(v)

    def start(self, poll_s: float | None = None) -> None:
        """Start the background poller (no-op when the period is <= 0
        or it is already running)."""
        period = (
            float(get_flag("device_memory_poll_s"))
            if poll_s is None else float(poll_s)
        )
        if period <= 0 or self._thread is not None:
            return
        self._stop.clear()

        def run():
            import torch

            while not self._stop.wait(period):
                with self._lock:
                    for token in self._open:
                        used = torch.cuda.memory_allocated(token["device"])
                        token["peak"] = max(token["peak"], used)

        self._thread = threading.Thread(
            target=run, name="device-memory-poll", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=2.0)


_DEFAULT_REGISTRY: ProgramRegistry | None = None
_DEFAULT_MONITOR: DeviceMemoryMonitor | None = None
_DEFAULT_LOCK = threading.Lock()


def default_program_registry() -> ProgramRegistry:
    """The process-wide program registry."""
    global _DEFAULT_REGISTRY
    with _DEFAULT_LOCK:
        if _DEFAULT_REGISTRY is None:
            _DEFAULT_REGISTRY = ProgramRegistry()
        return _DEFAULT_REGISTRY


def default_device_monitor() -> DeviceMemoryMonitor:
    """The process-wide device-memory monitor (one /metrics collector,
    per-query peak tracking shared across engines)."""
    global _DEFAULT_MONITOR
    with _DEFAULT_LOCK:
        if _DEFAULT_MONITOR is None:
            _DEFAULT_MONITOR = DeviceMemoryMonitor()
            _DEFAULT_MONITOR.install_collector()
        return _DEFAULT_MONITOR

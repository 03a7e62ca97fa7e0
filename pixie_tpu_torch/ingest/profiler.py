"""Self-sampling perf profiler connector with query/tenant attribution.

A port of the JAX package's ``ingest/profiler.py``: the same folded
stacks, stack ids and summary rows, over the port's thread attribution
registry (``exec/threadmap.py``).

Reference parity: the continuous profiler
(``src/stirling/source_connectors/perf_profiler/
perf_profiler_connector.h`` — eBPF stack sampling folded into the
``stack_traces.beta`` table). Without eBPF in scope (SURVEY.md §7 stage
7), the TPU-side analog samples THIS process's Python threads via
``sys._current_frames`` at the sampling period and folds identical
stacks into (stack_trace, count) rows — the same ``;``-joined
flamegraph-folded encoding the reference emits, queryable by the shipped
``px/perf_flamegraph`` script.

Profiling tier: each sample also reads the thread attribution
registry (``exec/threadmap.py``) so folded stacks land in the
``__stacks__`` telemetry ring WITH {qid, script_hash, tenant, phase}
columns — queryable via ``px/query_cpu`` / ``px/tenant_cpu`` — and
per-tenant CPU burn is counted in ``pixie_cpu_samples_total{tenant}``.
Active connectors register in a module-level set so the owning agent
can ship cumulative folded-stack summaries in heartbeats
(:func:`profile_summary`), which ``AgentTracker`` merges cluster-wide
for ``/debug/pprof`` and ``/debug/flamez``.

The sample path takes NO locks on the per-thread
read (threadmap entries are immutable dicts read GIL-atomically), no
device syncs — a 100Hz sampler that blocks is a profiler-shaped
outage.
"""

from __future__ import annotations

import hashlib
import os
import sys
import threading
import time

from ..exec import threadmap
from ..utils.upid import UPID
from .core import SourceConnector
from .schemas import STACK_TRACES_RELATION, STACKS_RELATION

#: Root marker frame appended when a stack exceeded the fold depth.
#: Without it, a 70-deep stack truncated to 64 frames folds to the SAME
#: key as a genuinely-64-deep stack with that prefix — two different
#: code paths aliased into one flame box.
TRUNCATED_MARKER = "...[truncated]"

#: Active connectors (registered in init(), removed in stop()) — the
#: per-process roster :func:`profile_summary` merges for heartbeats.
_ACTIVE: list["PerfProfilerConnector"] = []
_ACTIVE_LOCK = threading.Lock()


def _fold_stack(frame, max_depth: int = 64) -> str:
    """Flamegraph-folded stack string: outermost;...;innermost."""
    parts: list[str] = []
    while frame is not None and len(parts) < max_depth:
        code = frame.f_code
        parts.append(f"{os.path.basename(code.co_filename)}:{code.co_name}")
        frame = frame.f_back
    if frame is not None:
        # Deeper than max_depth: mark the truncation at the ROOT (this
        # list is innermost-first; reversal puts the marker first).
        parts.append(TRUNCATED_MARKER)
    return ";".join(reversed(parts))


def stack_id(folded: str) -> int:
    """Stable 63-bit content hash of a folded stack: bounded memory on
    long-lived PEMs (no per-stack id table), stable across agents and
    restarts."""
    return int.from_bytes(
        hashlib.blake2b(folded.encode(), digest_size=8).digest(), "big"
    ) >> 1


class PerfProfilerConnector(SourceConnector):
    """Sample all Python threads; publish attributed folded stacks."""

    name = "perf_profiler"
    tables = [
        ("stack_traces.beta", STACK_TRACES_RELATION),
        ("__stacks__", STACKS_RELATION),
    ]
    default_sampling_period_s = 0.01  # 100Hz, the reference's default rate
    default_push_period_s = 1.0

    def __init__(
        self,
        pod: str = "default/self",
        asid: int = 0,
        agent_id: str | None = None,
        **kw,
    ):
        super().__init__(**kw)
        self.pod = pod
        #: Stamped into __stacks__ rows and used to filter
        #: profile_summary() when several agents share one process
        #: (tests, single-node deploys) — without it their samples
        #: would double-count in every heartbeat.
        self.agent_id = agent_id if agent_id is not None else pod
        self.upid = UPID(asid=asid, pid=os.getpid(), start_ts=0)
        # (folded, qid, script_hash, tenant, phase) -> sample count.
        self._counts: dict[tuple, int] = {}
        # Cumulative since start (drained counts fold in here), bounded
        # by the profile_summary_stacks flag — the heartbeat export.
        self._summary: dict[tuple, int] = {}
        self._lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------
    def init(self) -> None:
        super().init()
        with _ACTIVE_LOCK:
            if self not in _ACTIVE:
                _ACTIVE.append(self)

    def stop(self) -> None:
        with _ACTIVE_LOCK:
            if self in _ACTIVE:
                _ACTIVE.remove(self)
        super().stop()

    # -- sampling ------------------------------------------------------------
    def sample(self) -> None:
        """One sampling tick: fold every live thread's current stack.
        Stacks accumulate in a sweep-local dict and merge under ONE
        lock acquisition — at 100Hz on a many-thread agent, a lock
        round trip per stack was measurable churn against the drain
        in ``transfer_data``. Attribution reads are lock-free (one
        GIL-atomic dict get per thread)."""
        me = threading.get_ident()
        sweep: dict[tuple, int] = {}
        tenant_sweep: dict[str, int] = {}
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue  # the collector thread observing itself is noise
            folded = _fold_stack(frame)
            if not folded:
                continue
            attr = threadmap.attribution(threadmap.lookup(tid))
            key = (folded, *attr)
            sweep[key] = sweep.get(key, 0) + 1
            tenant_sweep[attr[2]] = tenant_sweep.get(attr[2], 0) + 1
        if not sweep:
            return
        with self._lock:
            for key, n in sweep.items():
                self._counts[key] = self._counts.get(key, 0) + n
        self._count_tenants(tenant_sweep)

    def _count_tenants(self, tenant_sweep: dict[str, int]) -> None:
        # Raw attribution strings fold through the registered-tenant
        # resolver before labeling (bounded series cardinality; the
        # metrics-naming lint contract). count_unknown=False: an
        # unattributed sample is not an unknown-tenant *query*.
        from ..services.observability import default_counter
        from ..services.tenancy import resolve_tenant

        counter = default_counter(
            "pixie_cpu_samples_total",
            "Profiler stack samples attributed to each tenant "
            "(samples * sampling period = CPU-seconds)",
        )
        for raw, n in tenant_sweep.items():
            tenant = resolve_tenant(raw or None, count_unknown=False)
            counter.labels(tenant=tenant).inc(n)

    # -- drain ---------------------------------------------------------------
    def transfer_data(self, ctx, data_tables) -> None:
        # The collector calls transfer_data on the sampling cadence; fold
        # a sample each call and drain the accumulated counts every call —
        # the DataTable buffers until the push period fires (the BPF map
        # drain analog).
        self.sample()
        from ..config import get_flag

        cap = max(int(get_flag("profile_summary_stacks")), 16)
        with self._lock:
            if not self._counts:
                return
            items = list(self._counts.items())
            self._counts.clear()
            for key, n in items:
                self._summary[key] = self._summary.get(key, 0) + n
            if len(self._summary) > cap:
                # Keep the hottest stacks; cold tails age out. Counts
                # stay monotonic for survivors (diff-safe).
                keep = sorted(
                    self._summary.items(), key=lambda kv: -kv[1]
                )[:cap]
                self._summary = dict(keep)
        now = time.time_ns()
        # Attributed rows -> the __stacks__ telemetry ring.
        n = len(items)
        data_tables["__stacks__"].append({
            "time_": [now] * n,
            "agent_id": [self.agent_id] * n,
            "stack_trace_id": [stack_id(k[0]) for k, _ in items],
            "stack_trace": [k[0] for k, _ in items],
            "count": [c for _, c in items],
            "qid": [k[1] for k, _ in items],
            "script_hash": [k[2] for k, _ in items],
            "tenant": [k[3] for k, _ in items],
            "phase": [k[4] for k, _ in items],
        })
        # Legacy anonymous aggregate (px/perf_flamegraph compatibility):
        # collapse the attribution dimensions back out.
        agg: dict[str, int] = {}
        for key, c in items:
            agg[key[0]] = agg.get(key[0], 0) + c
        stacks = list(agg)
        m = len(stacks)
        data_tables["stack_traces.beta"].append({
            "time_": [now] * m,
            "upid": [self.upid.value()] * m,
            "stack_trace_id": [stack_id(s) for s in stacks],
            "stack_trace": stacks,
            "count": [agg[s] for s in stacks],
            "pod": [self.pod] * m,
        })

    # -- export --------------------------------------------------------------
    def summary_items(self) -> list[tuple[tuple, int]]:
        """Cumulative (key, count) pairs: drained summary + pending
        counts, so callers see samples taken since the last push too."""
        with self._lock:
            merged = dict(self._summary)
            for key, n in self._counts.items():
                merged[key] = merged.get(key, 0) + n
        return list(merged.items())


def profile_summary(
    agent_id: str | None = None, top: int = 64
) -> list[dict]:
    """Merged cumulative folded-stack summary across this process's
    active profilers (filtered to one agent when ``agent_id`` is given)
    — the payload agents ship in heartbeats. Rows:
    ``{stack, count, qid, script_hash, tenant, phase}``, hottest first,
    bounded to ``top`` (0 = unbounded)."""
    with _ACTIVE_LOCK:
        conns = list(_ACTIVE)
    merged: dict[tuple, int] = {}
    for c in conns:
        if agent_id is not None and c.agent_id != agent_id:
            continue
        for key, n in c.summary_items():
            merged[key] = merged.get(key, 0) + n
    rows = [
        {
            "stack": k[0],
            "count": n,
            "qid": k[1],
            "script_hash": k[2],
            "tenant": k[3],
            "phase": k[4],
        }
        for k, n in merged.items()
    ]
    rows.sort(key=lambda r: (-r["count"], r["stack"]))
    return rows[:top] if top else rows

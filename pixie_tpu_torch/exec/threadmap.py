"""Cross-thread attribution registry for the continuous profiler.

The perf profiler (``ingest/profiler.py``) samples every live thread's
stack at 100Hz via ``sys._current_frames``. By itself a folded stack is
anonymous — it says *what* code is running but not *for whom*. This
module is the "whom": a process-wide map of thread-id → attribution
entry, updated at the points where work changes identity:

- ``Engine.execute_query`` / ``Engine.execute_plan`` bind the
  executing ``QueryTrace`` (phase ``host``) from the trace's start to
  its end (``QueryTrace.open_scope``, the ``pixie.query`` region);
- ``QueryBroker.execute_script`` binds the distributed trace around
  planning + dispatch (phase ``host``);
- ``tracectx.bound`` registers the ambient context envelope, so bus
  handler threads carry at least the trace id;
- the stage timers (``exec/stream.py`` ``_timed``,
  ``FragmentStats.timed``) set the phase of each stage interval:
  ``stage`` for ``read``/``stage``/``decode``, ``device_dispatch`` for
  ``compute`` (the fold's launches), ``host`` for ``finalize`` and
  ``materialize``; a span (``compile``, the broker's ``dispatch``) sets
  ``host``;
- ``WindowPipeline`` binds the creator's entry on its prefetch thread
  (phase ``stage``) and sets phase ``stall`` around the consumer's
  waits.

The engine's binds, the stage timers, the spans and the pipeline go
through ``exec/trace.py``'s ``region``, which also puts the interval
into a running ``torch.profiler`` trace.

Concurrency contract: entries are IMMUTABLE dicts and every mutation
replaces the whole value (``_entries[tid] = new_dict``), so the sampler
can read ``_entries.get(tid)`` with **no lock** — a single GIL-atomic
dict lookup per sampled thread. That matters: the sampler runs at 100Hz
and must never synchronize (see ``PXLINT_HOT_REGIONS``); attribution
reads race benignly (a sample lands on the old or the new entry, never
a torn one).

Binding is token-based (save/restore, like ``contextvars``): nested
binds compose, and exceptional exits restore the outer entry.

A copy of the JAX package's ``exec/threadmap.py``; its profiler
(``ingest/profiler.py``) reads the attribution.
"""

from __future__ import annotations

import contextlib
import threading

#: thread-id -> immutable attribution entry.  Entry keys:
#:   "trace"  QueryTrace (live reference — qid/tenant stamped after
#:            begin_query are picked up at sample time automatically)
#:   "ctx"    trace-context envelope dict (bus handlers)
#:   "phase"  "" | "host" | "device_dispatch" | "stall" | "stage"
_entries: dict[int, dict] = {}


class _Token:
    """Save/restore handle returned by :func:`bind` / :func:`set_phase`."""

    __slots__ = ("tid", "prev")

    def __init__(self, tid: int, prev):
        self.tid = tid
        self.prev = prev


def bind(trace=None, ctx=None, phase: str = "", base: dict | None = None):
    """Register the calling thread's attribution; returns a token for
    :func:`unbind`. ``base`` seeds the entry from another thread's entry
    (pipeline prefetch threads inherit their creator's identity); the
    explicit ``trace``/``ctx``/``phase`` arguments override it."""
    tid = threading.get_ident()
    prev = _entries.get(tid)
    entry = dict(base) if base else {}
    if trace is not None:
        entry["trace"] = trace
    if ctx is not None:
        entry["ctx"] = ctx
    if phase or "phase" not in entry:
        entry["phase"] = phase
    _entries[tid] = entry
    return _Token(tid, prev)


def unbind(token) -> None:
    """Restore the entry that was live before the matching :func:`bind`."""
    if token is None:
        return
    if token.prev is None:
        _entries.pop(token.tid, None)
    else:
        _entries[token.tid] = token.prev


def set_phase(phase: str):
    """Replace the calling thread's phase; returns a token for
    :func:`restore`, or ``None`` when the thread has no entry (one dict
    get on unattributed threads — the hot-path fast exit)."""
    tid = threading.get_ident()
    prev = _entries.get(tid)
    if prev is None:
        return None
    _entries[tid] = {**prev, "phase": phase}
    return _Token(tid, prev)


def restore(token) -> None:
    """Undo a :func:`set_phase` (no-op on the ``None`` fast-exit token)."""
    if token is not None:
        _entries[token.tid] = token.prev


@contextlib.contextmanager
def attributed(trace=None, ctx=None, phase: str = "", base: dict | None = None):
    """Context-manager form of :func:`bind`/:func:`unbind`."""
    token = bind(trace=trace, ctx=ctx, phase=phase, base=base)
    try:
        yield
    finally:
        unbind(token)


def current_entry() -> dict | None:
    """The calling thread's live entry (for cross-thread inheritance)."""
    return _entries.get(threading.get_ident())


def lookup(tid: int) -> dict | None:
    """Sampler-side read: the entry for ``tid``, lock-free."""
    return _entries.get(tid)


def attribution(entry) -> tuple[str, str, str, str]:
    """Resolve an entry to ``(qid, script_hash, tenant, phase)`` strings.

    Reads qid/tenant off the live ``QueryTrace`` reference so values
    stamped after ``begin_query`` (the broker assigns qid + tenant a few
    lines later) are visible to samples taken any time after."""
    if not entry:
        return ("", "", "", "")
    trace = entry.get("trace")
    qid = script_hash = tenant = ""
    if trace is not None:
        qid = getattr(trace, "qid", "") or ""
        script_hash = getattr(trace, "script_hash", "") or ""
        tenant = getattr(trace, "tenant", "") or ""
    if not qid:
        ctx = entry.get("ctx")
        if isinstance(ctx, dict):
            qid = ctx.get("trace_id", "") or ""
    return (qid, script_hash, tenant, entry.get("phase", "") or "")


def clear() -> None:
    """Drop all entries (test isolation)."""
    _entries.clear()

"""Distributed trace-context propagation (the W3C traceparent analog).

One distributed query is ONE trace: the broker's dispatch span is the
parent of every agent-side fragment/merge span. The context that makes
that stitching possible is a tiny envelope — ``{"trace_id", "span_id"}``
— carried two ways:

- **in-band**: ``attach(msg, ctx)`` stamps the envelope into a bus
  message under ``_trace_ctx`` (wire-codec friendly: a dict of two hex
  strings), and ``extract(msg)`` validates + reads it back;
- **ambient**: the bus subscription dispatchers (``services/msgbus.py``,
  ``services/netbus.py``) bind an extracted context around each handler
  invocation via a ``contextvars.ContextVar``, so anything the handler
  does — including ``Engine.execute_plan`` beginning a query trace —
  inherits the distributed parent without explicit plumbing, and
  ``MessageBus.publish`` re-stamps it onto nested publishes (a data
  agent's bridge chunks carry its fragment context to the merge agent).

``Tracer.begin_query`` defaults its ``parent_ctx`` to ``current()``, so
a fragment executed inside a bus handler automatically parents under
the broker's dispatch span. Contexts are validated (32-hex trace id,
16-hex span id) — a malformed envelope is ignored, never raised.

A copy of the JAX package's ``exec/tracectx.py``.
"""

from __future__ import annotations

import contextlib
import contextvars

#: Message key the envelope rides under (dict of two hex strings; the
#: wire codec carries it unchanged across the netbus).
TRACE_CTX_KEY = "_trace_ctx"

_current: contextvars.ContextVar = contextvars.ContextVar(
    "pixie_trace_ctx", default=None
)


def _is_hex(s, n: int) -> bool:
    if not isinstance(s, str) or len(s) != n:
        return False
    try:
        int(s, 16)
    except ValueError:
        return False
    return True


def valid(ctx) -> bool:
    """True when ``ctx`` is a well-formed context envelope."""
    return (
        isinstance(ctx, dict)
        and _is_hex(ctx.get("trace_id"), 32)
        and _is_hex(ctx.get("span_id"), 16)
    )


def make(trace_id: str, span_id: str) -> dict:
    return {"trace_id": trace_id, "span_id": span_id}


def current() -> dict | None:
    """The ambient context bound by the enclosing bus dispatch (None
    outside any distributed trace)."""
    return _current.get()


@contextlib.contextmanager
def bound(ctx):
    """Bind ``ctx`` as the ambient context for the dynamic extent of the
    block (token-reset on exit, so dispatcher threads never leak a stale
    context into the next message). ``None``/invalid binds nothing.

    Also registers the context in the profiler's thread attribution map
    (``exec/threadmap.py``) so CPU samples taken inside a bus handler
    carry at least the distributed trace id."""
    from . import threadmap

    ctx = ctx if valid(ctx) else None
    token = _current.set(ctx)
    tm_token = threadmap.bind(ctx=ctx) if ctx is not None else None
    try:
        yield
    finally:
        threadmap.unbind(tm_token)
        _current.reset(token)


def attach(msg: dict, ctx=None) -> dict:
    """Return ``msg`` with the context envelope stamped in (a copy when
    stamping — publishers share message dicts across retries). ``ctx``
    defaults to the ambient context; an existing envelope is preserved
    (the originator's stamp wins over relay ambience)."""
    if TRACE_CTX_KEY in msg:
        return msg
    ctx = ctx if ctx is not None else current()
    if not valid(ctx):
        return msg
    return {**msg, TRACE_CTX_KEY: dict(ctx)}


def extract(msg) -> dict | None:
    """Read a validated context envelope out of a bus message."""
    ctx = msg.get(TRACE_CTX_KEY) if isinstance(msg, dict) else None
    return dict(ctx) if valid(ctx) else None

"""Dynamic tracer: deploy tracepoints as runtime-registered connectors.

Reference parity: ``src/stirling/source_connectors/dynamic_tracer/
dynamic_tracer.h:48`` ``CompileProgram`` — a TracepointDeployment
compiles through dwarvifier (argument layout) + code_gen (BCC C) and
attaches kernel uprobes that stream records into a brand-new table.

Here the instrumentation surface is **in-process Python callables**
(this runtime's "symbols"). A ``TraceTargetRegistry`` maps
symbol names to patchable attributes; attaching wraps the callable so
every call records (time, upid, captured args/ret/latency) into a
lock-guarded ring that the connector's ``transfer_data`` drains into the
deployment's table — the same connector lifecycle every other source
uses (``ingest/core.py``), so the collector loop, push thresholds, and
schema publication all apply unchanged. A copy of the JAX package's
``ingest/dynamic.py``: ``transfer_data`` builds host numpy columns, and
the engine's append stages them to the card like any other source's.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from dataclasses import dataclass

import numpy as np

from ..trace.spec import TracepointDeployment
from ..types.dtypes import DataType
from ..utils.upid import UPID
from .core import SourceConnector


class TraceError(Exception):
    pass


def native_probe_plan(binary_path: str, function: str) -> dict:
    """Capture plan for probing a native function: the dwarvifier step
    (reference ``dynamic_tracer/.../dwarvifier.h`` — resolve a probed
    function's argument names/types/sizes/frame offsets from DWARF so a
    tracepoint knows what to read where). Raises TraceError when the
    binary has no debug info or the function is unknown.

    Returns ``{"function", "address", "args": {name: {"type", "size",
    "frame_offset"}}}`` — what an instrumentation backend (or an
    operator inspecting a probe target) needs.
    """
    from ..utils.dwarf import DwarfError, DwarfReader

    try:
        reader = DwarfReader(binary_path)
    except DwarfError as e:
        raise TraceError(str(e)) from None
    except (OSError, ValueError, struct.error, IndexError) as e:
        # Missing file / truncated or corrupt ELF: same contract.
        raise TraceError(f"{binary_path}: {e}") from None
    fn = reader.functions.get(function)
    if fn is None:
        raise TraceError(
            f"no DWARF subprogram {function!r} in {binary_path} "
            f"(known: {sorted(reader.functions)[:12]})"
        )
    return {
        "function": fn.name,
        "address": fn.low_pc,
        "args": {
            a.name: {
                "type": a.type_name,
                "size": a.byte_size,
                "frame_offset": a.frame_offset,
            }
            for a in fn.args
        },
    }


@dataclass
class _Target:
    owner: object
    attr: str

    @property
    def fn(self):
        return getattr(self.owner, self.attr)


class TraceTargetRegistry:
    """symbol -> patchable callable (the ELF/DWARF symbol table analog)."""

    def __init__(self):
        self._targets: dict[str, _Target] = {}

    def register(self, symbol: str, owner, attr: str) -> None:
        if not callable(getattr(owner, attr, None)):
            raise TraceError(f"{symbol!r}: {attr!r} is not callable")
        self._targets[symbol] = _Target(owner, attr)

    def resolve(self, symbol: str) -> _Target:
        if symbol not in self._targets:
            raise TraceError(
                f"no traceable target registered for symbol {symbol!r}"
            )
        return self._targets[symbol]

    def symbols(self) -> list[str]:
        return sorted(self._targets)


def _cast(value, dtype: DataType):
    try:
        if dtype == DataType.STRING:
            return str(value)
        if dtype == DataType.FLOAT64:
            return float(value)
        if dtype == DataType.BOOLEAN:
            return bool(value)
        return int(value)  # INT64 / TIME64NS
    except (TypeError, ValueError):
        return "" if dtype == DataType.STRING else 0


class DynamicTraceConnector(SourceConnector):
    """A deployed tracepoint: wraps the target callable, buffers records.

    ``init()`` attaches (patches the registered attribute), ``stop()``
    detaches and restores the original callable.
    """

    default_sampling_period_s = 0.05

    def __init__(self, deployment: TracepointDeployment,
                 registry: TraceTargetRegistry, asid: int = 0, **kw):
        super().__init__(**kw)
        self.deployment = deployment
        self.name = f"dynamic:{deployment.name}"
        self.relation = deployment.relation()
        self.tables = [(deployment.table_name, self.relation)]
        self._registry = registry
        self._asid = asid
        self._upid = UPID(asid=asid, pid=os.getpid() & 0xFFFFFFFF,
                          start_ts=int(time.monotonic_ns() & (2**63 - 1)))
        self._lock = threading.Lock()
        self._ring: list[tuple] = []
        self._max_ring = 1 << 16
        self._target = None
        self._orig = None
        self._wrapped = None

    # -- attach / detach ----------------------------------------------------
    def init(self) -> None:
        self._target = self._registry.resolve(self.deployment.probe.target)
        self._orig = self._target.fn
        outputs = self.deployment.probe.outputs
        orig = self._orig
        upid = self._upid
        ring, lock, max_ring = self._ring, self._lock, self._max_ring
        # Argument layout resolution (the dwarvifier analog): bind call
        # args against the target's signature so named captures see
        # applied defaults.
        import inspect

        try:
            sig = inspect.signature(orig)
        except (TypeError, ValueError):
            sig = None

        def pick(expr, args, kwargs):
            if expr.startswith("arg") and expr[3:].isdigit():
                i = int(expr[3:])
                return args[i] if i < len(args) else 0
            if sig is not None:
                try:
                    ba = sig.bind(*args, **kwargs)
                    ba.apply_defaults()
                    if expr in ba.arguments:
                        return ba.arguments[expr]
                except TypeError:
                    pass
            return kwargs.get(expr, 0)

        # The inner callable lives in a mutable cell so a tracepoint can
        # be spliced out of a wrapper CHAIN (two tracepoints on one
        # symbol) without un-wrapping the others.
        holder = [orig]

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter_ns()
            ret = holder[0](*args, **kwargs)
            t1 = time.perf_counter_ns()
            row = [time.time_ns(), upid.hi, upid.lo]
            for _col, te in outputs:
                if te.kind == "latency":
                    row.append(_cast(t1 - t0, te.dtype))
                elif te.kind == "ret":
                    row.append(_cast(ret, te.dtype))
                else:  # arg
                    row.append(_cast(pick(te.expr, args, kwargs), te.dtype))
            with lock:
                ring.append(tuple(row))
                if len(ring) > max_ring:
                    del ring[: len(ring) - max_ring]
            return ret

        wrapped._pxt_holder = holder
        self._wrapped = wrapped
        setattr(self._target.owner, self._target.attr, wrapped)
        super().init()

    def stop(self) -> None:
        if self._target is not None and self._wrapped is not None:
            cur = getattr(self._target.owner, self._target.attr)
            if cur is self._wrapped:
                setattr(
                    self._target.owner, self._target.attr,
                    self._wrapped._pxt_holder[0],
                )
            else:
                # We are somewhere inside a wrapper chain: splice our
                # layer out by pointing the enclosing wrapper's cell at
                # our inner callable.
                w = cur
                while getattr(w, "_pxt_holder", None) is not None:
                    if w._pxt_holder[0] is self._wrapped:
                        w._pxt_holder[0] = self._wrapped._pxt_holder[0]
                        break
                    w = w._pxt_holder[0]
            self._target = None
            self._orig = None
            self._wrapped = None
        super().stop()

    # -- collection ---------------------------------------------------------
    def transfer_data(self, ctx, data_tables: dict) -> None:
        with self._lock:
            rows, self._ring[:] = list(self._ring), []
        if not rows:
            return
        cols = list(zip(*rows))
        records = {
            "time_": np.asarray(cols[0], dtype=np.int64),
            "upid": np.stack(
                [
                    np.asarray(cols[1], dtype=np.uint64),
                    np.asarray(cols[2], dtype=np.uint64),
                ],
                axis=1,
            ),
        }
        for i, (col, te) in enumerate(self.deployment.probe.outputs):
            vals = cols[3 + i]
            if te.dtype == DataType.STRING:
                records[col] = np.asarray(vals, dtype=object)
            elif te.dtype == DataType.FLOAT64:
                records[col] = np.asarray(vals, dtype=np.float64)
            elif te.dtype == DataType.BOOLEAN:
                records[col] = np.asarray(vals, dtype=bool)
            else:
                records[col] = np.asarray(vals, dtype=np.int64)
        data_tables[self.deployment.table_name].append(records)


def compile_program(deployment: TracepointDeployment,
                    registry: TraceTargetRegistry,
                    asid: int = 0) -> DynamicTraceConnector:
    """dynamic_tracer.h:48 CompileProgram analog: validate the target
    resolves and produce the attachable connector."""
    registry.resolve(deployment.probe.target)  # fail fast (FAILED state)
    return DynamicTraceConnector(deployment, registry, asid=asid)

"""Pipelined window executor: overlap staging with device compute.

A port of the JAX package's ``exec/pipeline.py``. The serial window loop
stages window N (host read, pad, copy) and only then folds it, so the
host idles while the device computes and the device idles while the
host stages. This module runs the staging generator on a background
*prefetch thread* while the consumer folds, with a bounded number of
windows in flight.

Design:

- The producer thread pulls from the staged-window generator (which
  does all the staging work; for resident windows that work is about
  nothing and the prefetcher is a cheap hand-off) and enqueues items.
- A semaphore with ``depth`` permits bounds the windows in flight: the
  producer takes a permit *before* staging the next window; the
  consumer gives it back only after it has folded that window.
  ``depth=1`` runs no thread at all (the serial executor).
- An error raised while staging is captured and raised again in the
  consumer with its original traceback: a staging failure is the
  query's failure, never a hang.
- ``close()`` can be called more than once and *always* joins the
  prefetch thread and drops staged windows that were never consumed;
  every consumer wraps its loop in try/finally so cancellation, limits
  and fold errors never leak a thread.

On CUDA the producer stages into pinned buffers and copies on the
device's copy stream, recording an event per window
(``types/batch.py`` ``stage_planes``); the consumer makes its stream
wait on that event (``handoff``) before it folds. The pipeline itself
only moves Python objects between the threads and never fences the
device.

A tiered table's cold windows decode inside the staging generator, so
under a pipeline the decode runs on the prefetch thread and overlaps
the fold. The decode meter is thread-local (``table_store/coldstore.py``
``take_decode_meter``): the generator takes it after each window and
charges it to the query's ``decode_s`` / ``decode_bytes``.

Counters: ``windows``, ``stage_secs`` (producer time spent staging) and
``stall_secs`` (consumer time blocked waiting for a window). Both
intervals are ``exec/trace.py`` regions: the prefetch thread carries
its creator's threadmap entry in phase ``stage`` (``pixie.stage``
ranges), the consumer's waits are phase ``stall`` (``pixie.stall``).
"""

from __future__ import annotations

import queue
import threading
import time

from . import threadmap
from .trace import region

#: Poll period for interruptible blocking waits (slot acquire / queue
#: get). Bounds how long cancellation or teardown can lag, not
#: throughput: steady-state hand-offs never hit the timeout.
_POLL_S = 0.05

#: Hot regions of the per-window execution path, registered for the
#: ``host-sync-hot-path`` lint (``analysis/lint.py``): a host sync inside
#: any of these runs once per window and serializes the prefetch overlap
#: this module exists to provide. Entries are "path-suffix:qualname-glob";
#: the lint reads this assignment statically. The port's counterparts of
#: the JAX package's window path, windowed join drivers and telemetry
#: fold (its CPU-only native fold has none).
PXLINT_HOT_REGIONS = (
    "exec/pipeline.py:WindowPipeline*",
    "exec/engine.py:Engine._fold_agg_state",
    "exec/engine.py:Engine._staged_windows*",
    "exec/engine.py:Engine._host_windows",
    "exec/engine.py:Engine._stage_host",
    "exec/engine.py:Engine._stage",
    # Windowed device-join drivers: their per-window loops ride the same
    # prefetch pipeline.
    "exec/joins.py:_join_device_windowed*",
    # Telemetry fold (services/telemetry.py): runs in Tracer.end_query on
    # the query thread after the query ends; it must stay host-list
    # arithmetic, or the next query waits behind it.
    "services/telemetry.py:TelemetryCollector*",
    "services/telemetry.py:ClusterTraceView*",
    "services/telemetry.py:TableStatsCollector*",
)


class DeadlineEvent:
    """Event-like cancel handle that also trips at an absolute
    wall-clock deadline (``time.time()`` seconds).

    The cancel handle is polled at every window boundary (on both sides
    of the pipeline, and every ``_POLL_S`` while blocked), so wrapping a
    query's cancel event in one of these makes an expired deadline
    abort the query between windows."""

    __slots__ = ("_event", "deadline_unix_s")

    def __init__(self, event, deadline_unix_s: float):
        self._event = event
        self.deadline_unix_s = float(deadline_unix_s)

    def set(self) -> None:
        self._event.set()

    def is_set(self) -> bool:
        return self._event.is_set() or self.deadline_exceeded()

    def deadline_exceeded(self) -> bool:
        return time.time() >= self.deadline_unix_s


class WindowPipeline:
    """Bounded-depth prefetch over a staged-window generator.

    Iterate it exactly once; call :meth:`close` when done (iteration
    wrapped in try/finally). ``cancel`` is an optional
    ``threading.Event``-like object polled on both sides; when set,
    iteration raises ``QueryCancelled``.
    """

    def __init__(self, gen, depth: int, cancel=None):
        self._gen = gen
        self.depth = max(1, int(depth))
        self._cancel = cancel
        self.windows = 0
        self.stage_secs = 0.0
        self.stall_secs = 0.0
        self._slots = threading.Semaphore(self.depth)
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._iterated = False
        # The creator's attribution (its query), for the prefetch thread.
        self._entry = threadmap.current_entry()

    # -- consumer side -------------------------------------------------------
    def __iter__(self):
        if self._iterated:
            raise RuntimeError("WindowPipeline is single-use")
        self._iterated = True
        if self.depth <= 1:
            # Serial mode: no thread, no queue; the cancel handle is
            # still polled per window.
            for item in self._gen:
                self._check_cancel()
                self.windows += 1
                yield item
            return
        self._thread = threading.Thread(
            target=self._produce, name="pixie-window-prefetch", daemon=True
        )
        self._thread.start()
        try:
            while True:
                self._check_cancel()
                t0 = time.perf_counter()
                with region("stall", "stall"):
                    kind, val = self._get()
                self.stall_secs += time.perf_counter() - t0
                if kind == "done":
                    return
                if kind == "error":
                    # The staging failure, original traceback intact.
                    raise val
                self._check_cancel()
                self.windows += 1
                yield val
                val = None  # drop the window's refs before freeing the slot
                self._slots.release()
        finally:
            self.close()

    def _get(self):
        while True:
            try:
                return self._q.get(timeout=_POLL_S)
            except queue.Empty:
                self._check_cancel()
                t = self._thread
                if (t is None or not t.is_alive()) and self._q.empty():
                    # The producer always enqueues a terminal item, so
                    # this means the thread was killed: fail, don't hang.
                    raise RuntimeError("window prefetch thread died")

    def _check_cancel(self):
        if self._cancel is not None and self._cancel.is_set():
            from .stream import QueryCancelled

            raise QueryCancelled("query cancelled")

    def counters(self) -> dict:
        """{depth, windows, stage_secs, stall_secs}, what
        ``Engine._note_pipeline`` folds into the query's stats."""
        return {
            "depth": self.depth,
            "windows": self.windows,
            "stage_secs": self.stage_secs,
            "stall_secs": self.stall_secs,
        }

    def close(self) -> None:
        """Stop the producer, join its thread, drop staged windows.

        Can be called more than once; safe on partly consumed, cancelled
        and failed pipelines. After close() returns no prefetch thread
        is alive and no staged window is referenced by the pipeline.
        """
        self._stop.set()
        # A producer blocked on a full pipeline (a consumer that stopped
        # early at a limit) wakes now instead of at its next poll.
        self._slots.release()
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        gen, self._gen = self._gen, iter(())
        close = getattr(gen, "close", None)
        if close is not None:
            close()

    # -- producer side -------------------------------------------------------
    def _produce(self):
        token = threadmap.bind(base=self._entry, phase="stage")
        try:
            while True:
                if not self._acquire_slot():
                    return  # the consumer closed the pipeline
                self._check_cancel()
                t0 = time.perf_counter()
                try:
                    with region("stage", "stage"):
                        item = next(self._gen)
                except StopIteration:
                    self._put(("done", None))
                    return
                self.stage_secs += time.perf_counter() - t0
                if not self._put(("item", item)):
                    return
        except BaseException as e:  # noqa: BLE001 - relayed, not swallowed
            self._put(("error", e))
        finally:
            threadmap.unbind(token)

    def _acquire_slot(self) -> bool:
        while not self._stop.is_set():
            if self._slots.acquire(timeout=_POLL_S):
                return not self._stop.is_set()
        return False

    def _put(self, item) -> bool:
        # The queue is unbounded (the slot semaphore bounds windows in
        # flight), so put never blocks; after stop, late items are
        # discarded.
        if self._stop.is_set():
            return False
        self._q.put(item)
        return True

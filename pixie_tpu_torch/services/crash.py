"""Fatal-signal and crash handling for deployed roles.

Reference parity: ``src/common/signal/signal_action.h`` (Envoy-style
SignalAction: install handlers for fatal signals, dump a backtrace,
invoke registered FatalErrorHandlers) and ``fatal_handler.h``
(FatalErrorHandlerInterface). The Python analog rests on
``faulthandler`` for the hard faults (SIGSEGV/SIGBUS/SIGFPE/SIGILL/
SIGABRT dump every thread's stack, even with the GIL wedged) and on
``sys.excepthook``/``threading.excepthook`` for uncaught exceptions;
both paths run the registered fatal handlers (last-gasp flushes) and
leave a timestamped crash log next to the process.
"""

from __future__ import annotations

import datetime
import faulthandler
import io
import os
import signal
import sys
import threading
import traceback
from typing import Callable, Optional

_lock = threading.Lock()
_fatal_handlers: list = []
_crash_file: Optional[io.TextIOWrapper] = None
_installed = False


def register_fatal_handler(fn: Callable[[], None]) -> None:
    """SignalAction::RegisterFatalErrorHandler analog: ``fn`` runs (best
    effort, exceptions swallowed) on uncaught exceptions and graceful
    SIGTERM teardown. Hard faults dump stacks only — arbitrary Python
    can't run on a corrupted interpreter, matching the reference's
    signal-safety constraints."""
    with _lock:
        _fatal_handlers.append(fn)


def run_fatal_handlers() -> None:
    """Public last-gasp trigger for roles that own their SIGTERM
    teardown (deploy._wait_forever) — runs every registered handler,
    best effort."""
    _run_fatal_handlers()


def _run_fatal_handlers() -> None:
    with _lock:
        handlers = list(_fatal_handlers)
    for fn in handlers:
        try:
            fn()
        except Exception:
            pass


def _stamp(kind: str) -> str:
    now = datetime.datetime.now(datetime.timezone.utc).isoformat()
    return f"=== pixie_tpu_torch crash [{kind}] pid={os.getpid()} at {now} ===\n"


def install(
    crash_log_path: Optional[str] = None,
    role: str = "",
    sigterm_exits: bool = True,
) -> None:
    """Install the process-wide crash machinery (idempotent).

    - faulthandler on a crash-log file (+ stderr) for hard faults
    - excepthooks recording uncaught exceptions and running fatal
      handlers
    - a SIGTERM handler that runs fatal handlers then exits 0 (the
    clean k8s teardown path the reference services share)
    """
    global _crash_file, _installed
    if _installed:
        return
    _installed = True

    path = crash_log_path or os.environ.get(
        "PIXIE_TPU_CRASH_LOG", f"crash_{role or 'process'}.log"
    )
    try:
        _crash_file = open(path, "a", buffering=1)
    except OSError:
        _crash_file = None
    # faulthandler accepts ONE file: prefer the log (stderr may be gone
    # under a supervisor); it dumps all thread stacks on hard faults.
    faulthandler.enable(file=_crash_file or sys.stderr, all_threads=True)

    prev_except = sys.excepthook

    def excepthook(tp, val, tb):
        if _crash_file is not None:
            _crash_file.write(_stamp("uncaught-exception"))
            traceback.print_exception(tp, val, tb, file=_crash_file)
        _run_fatal_handlers()
        prev_except(tp, val, tb)

    sys.excepthook = excepthook

    prev_thread_except = threading.excepthook

    def thread_excepthook(args):
        if _crash_file is not None:
            _crash_file.write(
                _stamp(f"thread-exception:{args.thread.name if args.thread else '?'}")
            )
            traceback.print_exception(
                args.exc_type, args.exc_value, args.exc_traceback,
                file=_crash_file,
            )
        _run_fatal_handlers()
        prev_thread_except(args)

    threading.excepthook = thread_excepthook

    if sigterm_exits:

        def on_sigterm(signum, frame):
            if _crash_file is not None:
                _crash_file.write(_stamp("sigterm"))
            _run_fatal_handlers()
            sys.exit(0)

        try:
            signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:
            pass  # non-main thread (tests): faulthandler still active



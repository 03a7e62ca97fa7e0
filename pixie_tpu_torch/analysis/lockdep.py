"""lockdep: opt-in runtime lock-order validation (Linux lockdep analog).

A port of the JAX package's ``analysis/lockdep.py`` (pure ``threading``;
nothing in it touches a tensor). It catches at run time the orders a
static reading cannot see: locks in containers (a streaming merge's
``merge_lock``), bare ``.acquire()`` calls, duck-typed receivers, and
cross-instance order inversions.

- ``enable()`` patches ``threading.Lock/RLock/Condition`` so every lock
  created afterwards is a thin wrapper that maintains a per-thread
  held-stack and a process-wide observed acquisition-order graph
  (edges: "held A when acquiring B", with the stack pair that first
  observed each edge).
- The FIRST blocking acquisition that would close a cycle in that graph
  raises :class:`LockOrderError` carrying both stack pairs — the
  would-deadlock is reported on the thread that would have completed
  it, before anything actually deadlocks. A non-reentrant lock
  re-acquired by its holder raises immediately too.
- ``RLock`` reentrancy is modeled (a re-acquire by the holder bumps a
  count, no edge); ``Condition.wait`` is modeled through the
  ``_release_save``/``_acquire_restore`` protocol the real Condition
  calls on its lock — while a thread waits, the condition's lock is
  NOT in its held set, and the wake-up re-acquire runs the normal
  edge/cycle bookkeeping (a wait-window inversion is still caught).
  ``queue.Queue`` (the window pipeline's prefetch handoff) builds its
  Conditions over a patched lock and takes this path.
- Violations are ALSO recorded on ``state().violations``: product code
  that swallows exceptions (bus handlers) cannot swallow the verdict.

Enable with the ``lockdep`` flag (env ``PIXIE_TPU_LOCKDEP=1``), which
``python -m pixie_tpu_torch.deploy`` honours before a role builds its
engine. Off by default: ``threading.Lock`` stays the raw C type, zero
overhead.

Scope notes: only locks CREATED while enabled are tracked (module-level
locks born at import time stay raw, such as the kernels' launch-count
lock in ``ops/cuda_lib.py``);
identity is per lock instance, so the graph never invents
cross-instance aliasing, at the cost of only catching inversions
between the instances a run actually exercised. Only one lockdep may
patch ``threading`` at a time in a process.
"""

from __future__ import annotations

import sys
import threading

__all__ = [
    "LockOrderError",
    "LockDep",
    "enable",
    "disable",
    "enabled",
    "state",
    "active",
]

_REAL_LOCK = threading.Lock
_REAL_RLOCK = threading.RLock
_REAL_CONDITION = threading.Condition


class LockOrderError(RuntimeError):
    """An acquisition would close a cycle in the observed lock-order
    graph (or re-acquire a held non-reentrant lock): a schedule exists
    in which the involved threads deadlock."""


def _stack(skip: int = 2, limit: int = 10) -> tuple:
    """Cheap stack capture: (filename, lineno, function) frames, no
    formatting (runs on every tracked acquire)."""
    try:
        f = sys._getframe(skip)
    except ValueError:
        return ()
    out = []
    while f is not None and len(out) < limit:
        co = f.f_code
        out.append((co.co_filename, f.f_lineno, co.co_name))
        f = f.f_back
    return tuple(out)


def _fmt_stack(stack: tuple, indent: str = "    ") -> str:
    return "\n".join(
        f"{indent}{fn}:{ln} in {fname}" for fn, ln, fname in stack
    ) or f"{indent}<no frames>"


class _Held:
    __slots__ = ("serial", "name", "count", "stack")

    def __init__(self, serial, name, stack):
        self.serial = serial
        self.name = name
        self.count = 1
        self.stack = stack


class LockDep:
    """Process-wide observed-order graph + per-thread held stacks."""

    def __init__(self):
        self._guard = _REAL_LOCK()  # protects the graph, never wrapped
        self._tls = threading.local()
        self._all_held: dict = {}  # ident -> held list (introspection)
        self._serial = 0
        # (held serial, acquired serial) -> {"held_stack", "acq_stack",
        # "held_name", "acq_name"} — first observation wins.
        self.edges: dict = {}
        self._adj: dict = {}  # serial -> set(serial)
        self.violations: list = []  # LockOrderError instances, in order
        self.tracked_locks = 0

    # -- wiring ---------------------------------------------------------------
    def new_serial(self, kind: str) -> tuple:
        with self._guard:
            self._serial += 1
            self.tracked_locks += 1
            serial = self._serial
        site = next(
            (
                (fn, ln)
                for fn, ln, _f in _stack(skip=3, limit=6)
                if "lockdep" not in fn and "threading" not in fn
                and "queue.py" not in fn
            ),
            ("?", 0),
        )
        return serial, f"{kind}#{serial}@{site[0].rsplit('/', 1)[-1]}:{site[1]}"

    def _held_list(self) -> list:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
            self._all_held[threading.get_ident()] = held
        return held

    def held(self, ident: int | None = None) -> list:
        """[(name, count)] snapshot of a thread's held locks (defaults
        to the calling thread) — test introspection."""
        if ident is None:
            held = self._held_list()
        else:
            held = self._all_held.get(ident, [])
        return [(h.name, h.count) for h in list(held)]

    # -- acquisition bookkeeping ----------------------------------------------
    def before_acquire(self, lock, blocking: bool) -> str:
        """Cycle check BEFORE the real (possibly blocking) acquire, so
        a would-deadlock raises instead of deadlocking. Returns the
        bookkeeping action for ``after_acquire``."""
        held = self._held_list()
        entry = next(
            (h for h in held if h.serial == lock._dep_serial), None
        )
        if entry is not None:
            if lock._dep_reentrant:
                return "reent"
            if not blocking:
                # A trylock probe of a lock this thread holds is legal
                # on a raw Lock (returns False) — never a deadlock.
                return "new"
            err = LockOrderError(
                f"self-deadlock: non-reentrant {lock._dep_name} "
                f"re-acquired by its holder\n"
                f"  first acquired at:\n{_fmt_stack(entry.stack)}\n"
                f"  re-acquired at:\n{_fmt_stack(_stack(3))}"
            )
            self.violations.append(err)
            raise err
        if not blocking or not held:
            return "new"  # trylocks can't deadlock; no held = no edge
        acq_stack = _stack(3)
        with self._guard:
            for h in held:
                key = (h.serial, lock._dep_serial)
                if key in self.edges:
                    continue
                cycle = self._find_path(lock._dep_serial, h.serial)
                if cycle is not None:
                    err = self._violation(h, lock, acq_stack, cycle)
                    self.violations.append(err)
                    raise err
                self.edges[key] = {
                    "held_name": h.name,
                    "acq_name": lock._dep_name,
                    "held_stack": h.stack,
                    "acq_stack": acq_stack,
                }
                self._adj.setdefault(h.serial, set()).add(
                    lock._dep_serial
                )
        return "new"

    def after_acquire(self, lock, action: str) -> None:
        held = self._held_list()
        if action == "reent":
            for h in held:
                if h.serial == lock._dep_serial:
                    h.count += 1
                    return
        held.append(_Held(lock._dep_serial, lock._dep_name, _stack(3)))

    def on_release(self, lock) -> None:
        held = self._held_list()
        for i in range(len(held) - 1, -1, -1):
            if held[i].serial == lock._dep_serial:
                held[i].count -= 1
                if held[i].count <= 0:
                    del held[i]
                return
        # Released by a non-holder thread (legal for a raw Lock used as
        # a signal/handoff): the ACQUIRER's entry must not stay behind
        # — a stale entry would poison every later acquisition by that
        # thread with false edges and a false self-deadlock on its next
        # legitimate acquire. Best-effort cross-thread removal (GIL-
        # atomic list ops; the owner is blocked or gone, it cannot be
        # mid-acquire of this same serial).
        with self._guard:
            # Snapshot: _held_list registers new threads' lists in
            # _all_held without the guard (hot path) — iterating the
            # live dict could see it change size mid-iteration.
            for other in list(self._all_held.values()):
                for i in range(len(other) - 1, -1, -1):
                    if other[i].serial == lock._dep_serial:
                        other[i].count -= 1
                        if other[i].count <= 0:
                            del other[i]
                        return

    def wait_release(self, lock) -> int:
        """Condition.wait released the lock: drop it from the held set
        for the whole wait window. Returns the stashed recursion count
        for the wake-up restore."""
        held = self._held_list()
        for i in range(len(held) - 1, -1, -1):
            if held[i].serial == lock._dep_serial:
                count = held[i].count
                del held[i]
                return count
        return 1

    # -- lock factories -------------------------------------------------------
    # Also test-facing: unit tests validate a PRIVATE LockDep without
    # patching threading (so they can seed violations even while a
    # global lockdep — a PIXIE_TPU_LOCKDEP run — watches the process).
    def make_lock(self):
        return _DepLock(self, _REAL_LOCK(), "Lock")

    def make_rlock(self):
        return _DepRLock(self, _REAL_RLOCK(), "RLock")

    def make_condition(self, lock=None):
        if lock is None:
            lock = self.make_rlock()
        return _REAL_CONDITION(lock)

    # -- graph ----------------------------------------------------------------
    def _find_path(self, src: int, dst: int):
        """Edge path src -> ... -> dst in the observed graph (caller
        holds ``_guard``), or None."""
        if src == dst:
            return []
        parent: dict = {src: None}
        frontier = [src]
        while frontier:
            nxt = []
            for u in frontier:
                for v in self._adj.get(u, ()):
                    if v in parent:
                        continue
                    parent[v] = u
                    if v == dst:
                        path = [v]
                        while parent[path[-1]] is not None:
                            path.append(parent[path[-1]])
                        path.reverse()
                        return [
                            (path[i], path[i + 1])
                            for i in range(len(path) - 1)
                        ]
                    nxt.append(v)
            frontier = nxt
        return None

    def _violation(self, held_entry, lock, acq_stack, cycle_edges):
        lines = [
            f"lock-order cycle closed: acquiring {lock._dep_name} while "
            f"holding {held_entry.name}, but the observed graph already "
            f"orders {lock._dep_name} before {held_entry.name}:",
            f"  this thread holds {held_entry.name}, acquired at:",
            _fmt_stack(held_entry.stack),
            f"  and is acquiring {lock._dep_name} at:",
            _fmt_stack(acq_stack),
        ]
        for a, b in cycle_edges:
            ev = self.edges[(a, b)]
            lines.append(
                f"  prior observation {ev['held_name']} -> "
                f"{ev['acq_name']}: held at:"
            )
            lines.append(_fmt_stack(ev["held_stack"]))
            lines.append("    while acquiring at:")
            lines.append(_fmt_stack(ev["acq_stack"]))
        return LockOrderError("\n".join(lines))


# -- threading wrappers -------------------------------------------------------

class _DepLockBase:
    _dep_reentrant = False

    def __init__(self, state: LockDep, inner, kind: str):
        self._dep_state = state
        self._inner = inner
        self._dep_serial, self._dep_name = state.new_serial(kind)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        action = self._dep_state.before_acquire(self, blocking)
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._dep_state.after_acquire(self, action)
        return ok

    def release(self):
        self._dep_state.on_release(self)
        self._inner.release()

    def __enter__(self):
        return self.acquire()

    def __exit__(self, *exc):
        self.release()

    def __repr__(self):
        return f"<{type(self).__name__} {self._dep_name} of {self._inner!r}>"

    def _at_fork_reinit(self):
        """A module imported while enabled may register its lock with
        ``os.register_at_fork`` (``concurrent.futures.thread`` does, at
        import): the child's reinit reaches the raw lock. The JAX
        package's wrapper lacks this, and such an import fails there."""
        self._inner._at_fork_reinit()

    # Condition protocol: the real threading.Condition lifts these off
    # its lock when present — which is exactly where wait()'s
    # release/re-acquire becomes visible to the dependency tracker.
    def _is_owned(self):
        inner_owned = getattr(self._inner, "_is_owned", None)
        if inner_owned is not None:
            return inner_owned()
        return any(
            h.serial == self._dep_serial
            for h in self._dep_state._held_list()
        )

    def _release_save(self):
        count = self._dep_state.wait_release(self)
        inner_save = getattr(self._inner, "_release_save", None)
        if inner_save is not None:
            return (inner_save(), count)
        self._inner.release()
        return (None, count)

    def _acquire_restore(self, saved):
        inner_saved, count = saved
        inner_restore = getattr(self._inner, "_acquire_restore", None)
        # A wake-up re-acquire that closes a cycle must still COMPLETE
        # the restore before raising: Condition.wait calls this from a
        # finally block and the caller's `with cond:` will release —
        # raising with the lock un-reacquired would corrupt lock state
        # on top of reporting the violation (it is already recorded on
        # ``violations`` either way).
        try:
            action = self._dep_state.before_acquire(self, blocking=True)
            pending = None
        except LockOrderError as e:
            action, pending = "new", e
        if inner_restore is not None:
            inner_restore(inner_saved)
        else:
            self._inner.acquire()
        self._dep_state.after_acquire(self, action)
        if count > 1:
            for h in self._dep_state._held_list():
                if h.serial == self._dep_serial:
                    h.count = count
                    break
        if pending is not None:
            raise pending


class _DepLock(_DepLockBase):
    _dep_reentrant = False

    def locked(self):
        return self._inner.locked()


class _DepRLock(_DepLockBase):
    _dep_reentrant = True


_STATE: LockDep | None = None


def _make_lock():
    return _STATE.make_lock()


def _make_rlock():
    return _STATE.make_rlock()


def _make_condition(lock=None):
    return _STATE.make_condition(lock)


# -- enable / disable ---------------------------------------------------------

def enable() -> LockDep:
    """Patch ``threading.Lock/RLock/Condition``; locks created from now
    on are order-tracked. Idempotent; returns the active state."""
    global _STATE
    if _STATE is not None:
        return _STATE
    _STATE = LockDep()
    threading.Lock = _make_lock
    threading.RLock = _make_rlock
    threading.Condition = _make_condition
    return _STATE


def disable() -> LockDep | None:
    """Restore the raw lock types. Locks created while enabled keep
    their (now inert-ish) wrappers — bookkeeping on them continues
    against the final state object, which is returned for inspection."""
    global _STATE
    threading.Lock = _REAL_LOCK
    threading.RLock = _REAL_RLOCK
    threading.Condition = _REAL_CONDITION
    st, _STATE = _STATE, None
    return st


def enabled() -> bool:
    return _STATE is not None


def state() -> LockDep | None:
    return _STATE


class active:
    """``with lockdep.active() as dep:`` — scoped enable for tests."""

    def __enter__(self) -> LockDep:
        self._was = enabled()
        return enable()

    def __exit__(self, *exc):
        if not self._was:
            disable()

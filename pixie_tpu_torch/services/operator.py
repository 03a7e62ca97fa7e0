"""Deployment operator: reconcile desired roles against live processes.

Reference parity: the Pixie operator (``src/operator/controllers``: a
controller loop that reconciles a Vizier spec, deploys components,
watches their health and recovers failed ones). There is no k8s API
here, so the reconciliation target is the process level: the deploy
roles of ``pixie_tpu_torch.deploy`` (broker, pem, kelvin), kept at their
desired replica counts with crash restarts and exponential backoff.

A port of the JAX package's ``services/operator.py``. A role's default
command is ``python -m pixie_tpu_torch.deploy <role>``; its children
inherit the operator's environment (``PIXIE_TPU_TORCH_DEVICE`` among it,
so each role runs on the device the operator was given) but never the
operator's spec variable.
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time
from dataclasses import dataclass, field


def _terminate_and_reap(proc, timeout_s: float = 5.0) -> None:
    """SIGTERM then wait — an unreaped child stays a zombie, which reads
    as alive to liveness probes."""
    if proc is None or proc.poll() is not None:
        return
    proc.terminate()
    try:
        proc.wait(timeout=timeout_s)
    except Exception:
        proc.kill()
        try:
            proc.wait(timeout=timeout_s)
        except Exception:
            pass


@dataclass(frozen=True)
class RoleSpec:
    """Desired state for one role (the Vizier CR spec analog)."""

    name: str
    replicas: int = 1
    #: Command argv; None = the in-repo deploy role entrypoint.
    command: tuple | None = None
    env: tuple = ()  # ((key, value), ...) extra environment

    def argv(self) -> list:
        if self.command is not None:
            return list(self.command)
        return [sys.executable, "-m", "pixie_tpu_torch.deploy", self.name]


@dataclass
class _Instance:
    proc: object = None
    restarts: int = 0
    backoff_until: float = 0.0
    last_exit: int | None = None
    started_at: float = 0.0


class Reconciler:
    """One reconcile loop over {role -> RoleSpec}.

    ``reconcile()`` is a single pass (the controller's Reconcile());
    ``run_as_thread`` re-runs it on an interval. Replica reductions
    terminate the highest indices first; crashed instances restart with
    exponential backoff capped at ``max_backoff_s``.
    """

    def __init__(self, specs: dict | None = None,
                 check_interval_s: float = 1.0,
                 base_backoff_s: float = 0.5, max_backoff_s: float = 30.0,
                 healthy_reset_s: float = 600.0, spawn=None):
        self.specs: dict[str, RoleSpec] = dict(specs or {})
        self.check_interval_s = check_interval_s
        self.base_backoff_s = base_backoff_s
        self.max_backoff_s = max_backoff_s
        # A crash after this much healthy running resets the backoff
        # ladder (the k8s CrashLoopBackOff reset the docstring's parity
        # claim implies) — otherwise a once-a-day crasher escalates to
        # worst-case recovery latency forever.
        self.healthy_reset_s = healthy_reset_s
        self._spawn = spawn or self._spawn_subprocess
        self._instances: dict[tuple, _Instance] = {}  # (role, idx)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self.events: list[tuple] = []  # (ts, kind, role, idx)

    @staticmethod
    def _spawn_subprocess(spec: RoleSpec, idx: int):
        import os

        env = dict(os.environ)
        # Children must never inherit the operator spec — a spec that
        # (mis)lists the operator role would otherwise fork-bomb.
        env.pop("PIXIE_TPU_OPERATOR_SPEC", None)
        env.update(dict(spec.env))
        env["PIXIE_TPU_REPLICA_INDEX"] = str(idx)
        return subprocess.Popen(
            spec.argv(), env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )

    def apply(self, specs: dict) -> None:
        """Replace the desired state (CR update); the next reconcile
        converges to it."""
        with self._lock:
            self.specs = dict(specs)

    _MAX_EVENTS = 1000

    def _record(self, kind: str, role: str, idx: int) -> None:
        self.events.append((time.time(), kind, role, idx))
        if len(self.events) > self._MAX_EVENTS:
            del self.events[: len(self.events) - self._MAX_EVENTS]

    def _backoff(self, inst, now: float) -> None:
        inst.backoff_until = now + min(
            self.base_backoff_s * (2 ** min(inst.restarts, 16)),
            self.max_backoff_s,
        )

    def reconcile(self) -> None:
        now = time.monotonic()
        to_reap, to_spawn = [], []
        with self._lock:
            desired = {
                (r, i)
                for r, spec in self.specs.items()
                for i in range(max(spec.replicas, 0))
            }
            # Scale down / removed roles: terminate extras (reaping
            # happens OUTSIDE the lock — SIGTERM-ignoring children must
            # not stall status()/apply() callers).
            for key in [k for k in self._instances if k not in desired]:
                inst = self._instances.pop(key)
                to_reap.append(inst.proc)
                self._record("terminated", *key)
            # Decide which instances need (re)spawning; the fork+exec
            # itself also happens OUTSIDE the lock.
            for key in sorted(desired):
                role, idx = key
                inst = self._instances.setdefault(key, _Instance())
                alive = inst.proc is not None and inst.proc.poll() is None
                if alive:
                    continue
                if inst.proc is not None:
                    # Record the crash ONCE; the dead Popen is dropped so
                    # backoff passes don't re-record it. A crash after a
                    # long healthy run resets the backoff ladder.
                    inst.last_exit = inst.proc.returncode
                    inst.proc = None
                    if (inst.started_at
                            and now - inst.started_at > self.healthy_reset_s):
                        inst.restarts = 0
                    self._record("crashed", role, idx)
                if now < inst.backoff_until:
                    continue
                # Claim the slot so a concurrent reconcile can't double-
                # spawn; the real backoff replaces this after the spawn.
                inst.backoff_until = now + 3600.0
                to_spawn.append((key, self.specs[role]))
        spawned = []
        for key, spec in to_spawn:
            try:
                spawned.append((key, self._spawn(spec, key[1])))
            except Exception:
                spawned.append((key, None))
        with self._lock:
            for key, proc in spawned:
                inst = self._instances.get(key)
                if inst is None:  # scaled away while spawning
                    if proc is not None:
                        to_reap.append(proc)
                    continue
                if proc is None:
                    # Bad command/spec: count it, back off — a silent
                    # hot retry loop would hide the misconfiguration.
                    inst.restarts += 1
                    self._record("spawn_failed", *key)
                    self._backoff(inst, now)
                    continue
                inst.proc = proc
                inst.started_at = now
                first = inst.restarts == 0 and inst.last_exit is None
                self._record("started" if first else "restarted", *key)
                if not first:
                    inst.restarts += 1
                self._backoff(inst, now)
        for proc in to_reap:
            _terminate_and_reap(proc)

    def status(self) -> list:
        """Per-instance health (the operator's status subresource)."""
        with self._lock:
            out = []
            for (role, idx), inst in sorted(self._instances.items()):
                alive = inst.proc is not None and inst.proc.poll() is None
                out.append({
                    "role": role, "replica": idx, "alive": alive,
                    "pid": getattr(inst.proc, "pid", None),
                    "restarts": inst.restarts,
                    "last_exit": inst.last_exit,
                })
            return out

    # -- lifecycle -----------------------------------------------------------
    def run_as_thread(self) -> threading.Thread:
        self._thread = threading.Thread(
            target=self._loop, name="operator", daemon=True
        )
        self._thread.start()
        return self._thread

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.reconcile()
            self._stop.wait(self.check_interval_s)

    def stop(self, terminate: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if terminate:
            with self._lock:
                procs = [inst.proc for inst in self._instances.values()]
            for proc in procs:
                _terminate_and_reap(proc)


def specs_from_config(cfg: dict) -> dict:
    """{role: replicas|{replicas, command, env}} -> {role: RoleSpec}.

    Raises ValueError with a readable message on malformed entries (a
    bare 'role:' line parses to None; replicas must be ints)."""
    out = {}
    for role, v in cfg.items():
        if isinstance(v, bool) or not isinstance(v, (int, dict)):
            raise ValueError(
                f"operator spec: role {role!r} must map to an int replica "
                f"count or a mapping, got {type(v).__name__}"
            )
        if isinstance(v, int):
            out[role] = RoleSpec(name=role, replicas=v)
        else:
            try:
                replicas = int(v.get("replicas", 1))
            except (TypeError, ValueError):
                raise ValueError(
                    f"operator spec: role {role!r} replicas must be an "
                    f"int, got {v.get('replicas')!r}"
                ) from None
            out[role] = RoleSpec(
                name=role,
                replicas=replicas,
                command=tuple(v["command"]) if v.get("command") else None,
                env=tuple((k, str(val)) for k, val in
                          (v.get("env") or {}).items()),
            )
    return out

"""Cron ScriptRunner: periodically execute stored PxL scripts.

Reference parity: the query broker's cron ``ScriptRunner``
(``src/vizier/services/query_broker/script_runner/script_runner.go:62``):
it keeps a store-backed set of cron scripts, reconciles updates against a
source of truth by checksum (``:441-480`` CompareScriptState), and runs
each script on its configured frequency through the normal query path,
shipping results to the script's export sinks (OTel plugins).

Here the runner executes through any target exposing
``execute_script(query, ...)`` (QueryBroker) or ``execute_query`` (a bare
Engine), persists scripts in a Datastore, and exposes an explicit
``tick(now_s)`` so services drive it from their own loop (tests never
sleep); ``run_forever`` is the thread wrapper.
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

from ..utils.datastore import MemoryDatastore

_PREFIX = "cron_script/"


@dataclass
class CronScript:
    script_id: str
    pxl: str
    frequency_s: float
    enabled: bool = True

    @property
    def checksum(self) -> str:
        return hashlib.sha256(
            f"{self.pxl}\x00{self.frequency_s}\x00{self.enabled}".encode()
        ).hexdigest()[:16]

    def to_bytes(self) -> bytes:
        return json.dumps(
            {
                "script_id": self.script_id,
                "pxl": self.pxl,
                "frequency_s": self.frequency_s,
                "enabled": self.enabled,
            }
        ).encode()

    @classmethod
    def from_bytes(cls, b: bytes) -> "CronScript":
        return cls(**json.loads(b.decode()))


@dataclass
class RunRecord:
    script_id: str
    started_s: float
    ok: bool
    error: str = ""
    row_counts: dict = field(default_factory=dict)


class ScriptRunner:
    """Store-backed cron script executor."""

    def __init__(self, target, store=None, on_result=None):
        self.target = target
        self.store = store if store is not None else MemoryDatastore()
        self.on_result = on_result  # callable(script, outputs) or None
        self._next_due: dict[str, float] = {}
        self._lock = threading.Lock()
        self.history: list[RunRecord] = []
        self._stop = threading.Event()

    # -- script management (the cloud source-of-truth surface) -------------
    def upsert(self, script: CronScript) -> None:
        self.store.set(_PREFIX + script.script_id, script.to_bytes())
        with self._lock:
            self._next_due.setdefault(script.script_id, 0.0)

    def delete(self, script_id: str) -> None:
        self.store.delete(_PREFIX + script_id)
        with self._lock:
            self._next_due.pop(script_id, None)

    def scripts(self) -> dict[str, CronScript]:
        return {
            k[len(_PREFIX):]: CronScript.from_bytes(v)
            for k, v in self.store.get_with_prefix(_PREFIX)
        }

    def compare_state(self, truth: dict[str, CronScript]) -> None:
        """Reconcile the stored set against a source of truth by checksum
        (script_runner.go:441-480 CompareScriptState)."""
        have = self.scripts()
        for sid, s in truth.items():
            if sid not in have or have[sid].checksum != s.checksum:
                self.upsert(s)
        for sid in list(have):
            if sid not in truth:
                self.delete(sid)

    # -- execution ---------------------------------------------------------
    def tick(self, now_s: Optional[float] = None) -> list[RunRecord]:
        """Run every due script once; returns records for this tick."""
        now = time.time() if now_s is None else now_s
        ran = []
        for sid, script in sorted(self.scripts().items()):
            if not script.enabled:
                continue
            with self._lock:
                due = self._next_due.get(sid, 0.0)
                if now < due:
                    continue
                self._next_due[sid] = now + script.frequency_s
            rec = self._run_one(script, now)
            ran.append(rec)
            self.history.append(rec)
        del self.history[:-200]  # bounded history
        return ran

    def _run_one(self, script: CronScript, now: float) -> RunRecord:
        try:
            if hasattr(self.target, "execute_script"):
                result = self.target.execute_script(script.pxl)
                outputs = result["tables"]  # broker result envelope
            else:
                outputs = self.target.execute_query(script.pxl)
            if self.on_result is not None:
                self.on_result(script, outputs)
            counts = {
                k: getattr(v, "length", None)
                for k, v in outputs.items()
                if isinstance(k, str)
            }
            return RunRecord(script.script_id, now, True, row_counts=counts)
        except Exception as e:  # a broken script must not kill the loop
            return RunRecord(script.script_id, now, False, error=repr(e)[:300])

    def run_forever(self, poll_s: float = 1.0) -> threading.Thread:
        def loop():
            while not self._stop.wait(poll_s):
                self.tick()

        t = threading.Thread(target=loop, name="cron-script-runner", daemon=True)
        t.start()
        return t

    def stop(self) -> None:
        self._stop.set()

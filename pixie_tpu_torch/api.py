"""Python API client (the pxapi analog).

Reference parity: ``src/api/go/pxapi/client.go:41-54``
(``Client.ExecuteScript`` streaming results into per-table record
handlers) and the Python client under ``src/api/python``. The transport
is the framed-TCP netbus to a served broker; results arrive as
HostBatches and are surfaced row-wise through handlers or as pydicts.

    import pixie_tpu_torch.api as pxapi

    client = pxapi.Client("127.0.0.1", 6100)
    for table, rows in client.execute_script(pxl).items():
        ...

    # or streaming-handler style:
    class Printer(pxapi.TableRecordHandler):
        def handle_record(self, record): print(record)
    client.execute_script(pxl, handler_factory=lambda t: Printer())

A port of the JAX package's ``api.py``. Under broker HA
(``services/broker_ha.py``) ``resolve_leader`` names the current leader,
idempotent requests are retried through a failover window, and a lost
``execute_script`` reply raises a structured error naming the leader to
resubmit to (never retried).
"""

from __future__ import annotations

from typing import Callable, Optional

#: Control-plane requests that are safe to retry on a BusTimeout: pure
#: reads with no side effects. broker.execute is deliberately NOT here
#: — re-running a script blind could double-execute mutations; it
#: re-resolves the leader and surfaces a structured error instead.
_IDEMPOTENT_TOPICS = frozenset({
    "broker.scripts", "broker.schemas", "broker.agents",
    "broker.debug_queries", "broker.profile", "broker.leader",
})


class ScriptExecutionError(RuntimeError):
    pass


class ScriptResults(dict):
    """``{table: pydict-of-columns}`` plus the distributed-execution
    metadata as attributes — plain-dict compatible for existing callers.

    - ``partial``: True when >=1 planned data agent was lost and the
      tables cover only the survivors (graceful degradation)
    - ``missing_agents``: the lost agents' ids
    - ``qid`` / ``agent_stats``: execution identity + per-agent timings
    - ``predicted_cost``: pxbound's plan-time resource envelope
      (``bytes_staged_hi``/``rows_in_hi``/...; None entries =
      sketch-less, unbounded) — the broker's admission-control signal;
      compare with the observed usage in ``agent_stats``
    """

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.partial = False
        self.missing_agents: list = []
        self.missing_reasons: dict = {}
        # Why a partial result stopped early: "deadline" | "cancelled"
        # | None (agent loss keeps the per-agent missing_reasons only).
        self.interrupted: str | None = None
        self.qid = None
        self.agent_stats: dict = {}
        self.predicted_cost: dict | None = None
        # Resolved tenant the broker admitted the query under
        # (services/tenancy.py; "shared" for unscoped callers).
        self.tenant: str | None = None
        # Result staleness (storage-tier observability): worst scanned-
        # table watermark lag across agents at execute time, ms. 0 =
        # fresh or no time-indexed scan; None from pre-freshness brokers.
        self.freshness_lag_ms: float | None = None


class TableRecordHandler:
    """Row-wise consumer of one output table (pxapi TableRecordHandler)."""

    def handle_init(self, table_name: str, relation) -> None:  # noqa: B027
        pass

    def handle_record(self, record: dict) -> None:
        raise NotImplementedError

    def handle_done(self, table_name: str) -> None:  # noqa: B027
        pass


class Client:
    """Executes PxL scripts against a served broker."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6100,
                 connect_timeout_s: float = 10.0):
        from .services.netbus import RemoteBus

        self._bus = RemoteBus(host, port, connect_timeout_s=connect_timeout_s)

    def close(self) -> None:
        self._bus.close()

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- introspection -------------------------------------------------------
    def list_scripts(self) -> list[str]:
        return self._request("broker.scripts", {})["scripts"]

    def debug_queries(self, limit: int = 50) -> dict:
        """Recent distributed-query traces from the broker — status,
        duration, and per-agent resource usage (bytes staged, device ms,
        wire bytes). The `px debug queries` surface."""
        res = self._request("broker.debug_queries", {"limit": limit})
        return {"in_flight": res.get("in_flight", []),
                "queries": res.get("queries", [])}

    def profile(
        self,
        agent: str | None = None,
        tenant: str | None = None,
        script: str | None = None,
        limit: int = 64,
    ) -> dict:
        """Cluster-merged folded-stack CPU profile from the broker
        (agents' heartbeat summaries + the broker's own sampler) —
        the `px profile` surface. Returns {"agents": [...], "stacks":
        [{stack, count, qid, script_hash, tenant, phase}, ...]} with
        optional agent / tenant / script-hash filters."""
        res = self._request("broker.profile", {
            "agent": agent or "", "tenant": tenant or "",
            "script": script or "", "limit": limit,
        })
        return {"agents": res.get("agents", []),
                "stacks": res.get("stacks", [])}

    def cancel_query(self, qid: str) -> bool:
        """Cooperatively cancel a running one-shot query (`px cancel`):
        the broker stops its agents at their next window boundary and
        the original caller receives a partial result with reason
        "cancelled". Returns whether a registered query was found."""
        return bool(
            self._request("broker.cancel", {"qid": qid}).get("cancelled")
        )

    def schemas(self) -> dict:
        return self._request("broker.schemas", {})["schemas"]

    def agents(self) -> list[dict]:
        return self._request("broker.agents", {})["agents"]

    def agents_status(self) -> dict:
        """Like :meth:`agents` but returns the full reply, including
        ``broker`` — WHICH broker replica answered (broker HA; empty on
        a plain single-broker deploy). The `px agents` surface."""
        res = self._request("broker.agents", {})
        return {"agents": res.get("agents", []),
                "broker": res.get("broker", "")}

    def resolve_leader(self, timeout_s: float = 2.0) -> dict:
        """Current broker-HA leader as every replica last saw it:
        ``{"broker": id, "epoch": n, "role": ..., "answered_by": id}``.
        Raises on a non-HA deploy (nobody serves ``broker.leader``)."""
        return self._request("broker.leader", {}, timeout_s=timeout_s)

    # -- execution -----------------------------------------------------------
    def execute_script(
        self,
        pxl: str,
        timeout_s: float = 30.0,
        max_output_rows: int = 10_000,
        handler_factory: Optional[Callable[[str], TableRecordHandler]] = None,
        require_complete: Optional[bool] = None,
        tenant: Optional[str] = None,
        priority: Optional[int] = None,
        deadline_ms: Optional[float] = None,
    ):
        """Run a script; returns a ``ScriptResults``
        ({table: pydict-of-columns} with partial/missing_agents/qid/
        agent_stats attributes).

        With ``handler_factory``, each output table's rows additionally
        stream through a ``TableRecordHandler`` (the pxapi consumption
        model); the return value is unchanged. ``require_complete=True``
        fails instead of returning partial results when a data agent is
        lost mid-query.

        Multi-tenant scheduling: ``tenant`` scopes admission to that
        registered tenant's budget share (unknown names fold into the
        shared tenant), ``priority`` (higher first) and ``deadline_ms``
        order the broker's admission queue; a query past its deadline
        is shed while queued or returns ``partial`` with
        ``missing_reasons`` values ``"deadline"`` once dispatched.
        """
        req = {"query": pxl, "timeout_s": timeout_s,
               "max_output_rows": max_output_rows}
        if require_complete is not None:
            req["require_complete"] = bool(require_complete)
        if tenant is not None:
            req["tenant"] = str(tenant)
        if priority is not None:
            req["priority"] = int(priority)
        if deadline_ms is not None:
            req["deadline_ms"] = float(deadline_ms)
        from .services.msgbus import BusTimeout

        try:
            res = self._request(
                "broker.execute", req, timeout_s=timeout_s + 5,
            )
        except BusTimeout as e:
            # NEVER blind-retried: execute is non-idempotent (duplicate
            # compute, mutations). Re-resolve the leader so the
            # structured error tells the caller where to resubmit.
            leader = ""
            try:
                info = self.resolve_leader()
                leader = str(info.get("broker", ""))
            except Exception:
                pass
            hint = (
                f" (current leader: {leader}; resubmit to it)"
                if leader else
                " (no broker leader answered; the cluster may be "
                "mid-failover)"
            )
            raise ScriptExecutionError(
                f"execute_script got no reply and was not retried "
                f"(non-idempotent){hint}: {e}"
            ) from e
        out = ScriptResults()
        out.partial = bool(res.get("partial"))
        out.missing_agents = list(res.get("missing_agents", []))
        out.missing_reasons = dict(res.get("missing_reasons", {}))
        out.interrupted = res.get("interrupted")
        out.qid = res.get("qid")
        out.agent_stats = dict(res.get("agent_stats", {}))
        out.predicted_cost = res.get("predicted_cost")
        out.tenant = res.get("tenant")
        out.freshness_lag_ms = res.get("freshness_lag_ms")
        for name, hb in sorted(res["tables"].items()):
            d = hb.to_pydict()
            out[name] = d
            if handler_factory is not None:
                h = handler_factory(name)
                h.handle_init(name, hb.relation)
                cols = list(d)
                for i in range(hb.length):
                    h.handle_record(
                        {c: _py(d[c][i]) for c in cols}
                    )
                h.handle_done(name)
        return out

    def stream_script(
        self,
        pxl: str,
        on_update: Callable[[dict], None],
        poll_interval_s: float = 0.25,
        require_complete: Optional[bool] = None,
    ) -> "StreamSubscription":
        """Subscribe to a live query (the reference's StreamResults /
        live-view flow): ``on_update`` receives
        {table, rows: pydict, seq, mode} as the cluster's tables grow —
        mode "append" carries only new rows, "replace" the full updated
        aggregate — until ``.cancel()``. Errors arrive as {error};
        a data agent lost mid-stream arrives as a
        {stream_degraded, partial, missing_agents} update (or as
        {error}, with ``require_complete=True``).
        """
        import uuid as _uuid

        topic = f"client.stream.{_uuid.uuid4().hex[:12]}"

        def _relay(msg):
            if "batch" in msg:
                hb = msg["batch"]
                on_update({
                    "table": msg.get("table"),
                    "rows": hb.to_pydict(),
                    "seq": msg.get("seq"),
                    "mode": msg.get("mode"),
                })
            else:
                on_update(msg)

        req = {"query": pxl, "update_topic": topic,
               "poll_interval_s": poll_interval_s}
        if require_complete is not None:
            req["require_complete"] = bool(require_complete)
        sub = self._bus.subscribe(topic, _relay)
        try:
            res = self._request("broker.execute_stream", req)
        except Exception:
            sub.unsubscribe()
            raise
        return StreamSubscription(self, res["qid"], sub)

    def _request(self, topic: str, msg: dict, timeout_s: float = 10.0) -> dict:
        import random as _random
        import time as _time

        from .config import get_flag
        from .services.msgbus import BusTimeout

        if get_flag("bus_secret") and "token" not in msg:
            from .services.auth import sign_token

            msg = {**msg, "token": sign_token(get_flag("bus_secret"), "api")}
        # Idempotent control-plane reads retry through a broker
        # failover window (capped exponential backoff + jitter);
        # anything else gets exactly one attempt.
        retries = (
            int(get_flag("client_request_retries"))
            if topic in _IDEMPOTENT_TOPICS else 0
        )
        base_s = max(float(get_flag("client_retry_backoff_ms")), 1.0) / 1e3
        attempt = 0
        while True:
            try:
                res = self._bus.request(topic, msg, timeout_s=timeout_s)
                break
            except BusTimeout:
                if attempt >= retries:
                    raise
                from .services.observability import default_counter

                default_counter(
                    "pixie_client_retries_total",
                    "Idempotent api.Client requests retried on BusTimeout",
                ).inc()
                backoff = min(base_s * (2 ** attempt), 2.0)
                _time.sleep(backoff * (1.0 + 0.25 * _random.random()))
                attempt += 1
        if not res.get("ok"):
            raise ScriptExecutionError(res.get("error", "unknown error"))
        return res


class StreamSubscription:
    """Client handle for a live query; ``cancel()`` ends it everywhere."""

    def __init__(self, client: Client, qid: str, sub):
        self.qid = qid
        self._client = client
        self._sub = sub

    def cancel(self) -> None:
        try:
            self._client._request("broker.stream_cancel", {"qid": self.qid})
        finally:
            if self._sub is not None:
                self._sub.unsubscribe()
                self._sub = None


def _py(v):
    return v.item() if hasattr(v, "item") else v

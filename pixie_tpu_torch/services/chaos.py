"""Chaos soak: faults x tenancy x staleness x concurrency x broker-kill.

Each resilience layer in this repo has its own gate (fault seeds,
tenancy isolation, staleness floors, backpressure) — this module
exercises them TOGETHER, the way a real incident does: a mixed-tenant
load runs against an N-agent, M-broker-replica cluster while a seeded
fault schedule drops/delays/duplicates bus traffic, partitions agents,
kills data agents mid-query, and crashes the leader broker outright
(``BrokerReplica.kill`` — a standby takes over within one lease
window).

The soak's contract, asserted by :func:`run_chaos_soak`:

- **Zero lost queries.** Every submitted query resolves — complete,
  ``partial`` (with a reason), a structured admission shed/refusal, or
  a failover retry that lands on the next leader. No hangs, no reply
  that never comes (a per-query ledger audits every outcome).
- **Zero leaked threads.** The cluster tears down to its pre-soak
  thread count: forwarder waits, failover adopters, lease watchers and
  agent heartbeats all exit.
- **Isolation holds under fire.** The victim tenant's p99 during the
  chaos phase stays within the tenancy bound (1.25x its solo baseline,
  plus a small absolute floor for sub-100ms baselines) while the noisy
  tenant saturates and the fault schedule runs.

CLI::

    python -m pixie_tpu_torch.services.chaos --agents 16 --brokers 2 --seed 0
    python -m pixie_tpu_torch.services.chaos --agents 128 --brokers 3 --full

A (seed, topology) pair replays the same fault schedule — the RNG is
the injector's, and the kill points are wall-clock offsets into the
load phase, so outcome COUNTS may vary slightly across machines but
the exercised paths do not.

A port of the JAX package's ``services/chaos.py``. Every agent owns a
port ``Engine`` on the CUDA card unless ``device="cpu"`` (``--device
cpu``, or ``PIXIE_TPU_TORCH_DEVICE=cpu``) names the CPU; without a card
the soak raises before it builds anything.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from .broker_ha import BrokerReplica
from .faults import FaultInjector
from .load_tester import (
    TenantStream,
    resolve_device,
    run_load,
    run_mixed_load,
)
from .msgbus import BusTimeout, MessageBus

VICTIM_QUERY = (
    "import px\n"
    "df = px.DataFrame(table='http_events')\n"
    "df = df.groupby('service').agg(\n"
    "    n=('latency_ns', px.count), mean=('latency_ns', px.mean))\n"
    "px.display(df, 'out')\n"
)

NOISY_QUERY = (
    "import px\n"
    "df = px.DataFrame(table='http_events')\n"
    "df = df.groupby(['service', 'resp_status']).agg(\n"
    "    n=('latency_ns', px.count), mean=('latency_ns', px.mean))\n"
    "px.display(df, 'out')\n"
)

#: Seconds the load stays open after the new leader has taken over:
#: queries submitted into the first lease intervals of its reign.
SETTLE_S = 0.5

# Outcomes that count as "resolved" for the zero-lost-queries gate:
# structured refusals the platform ISSUED on purpose. Anything else in
# an error reply is a lost query.
_REFUSALS = ("admission-shed", "admission-reject", "BrokerOverloaded",
             "cancelled")


class _Ledger:
    """Per-query outcome audit, independent of LoadReport aggregation:
    the zero-lost gate needs the error MESSAGES (to tell a structured
    refusal from a genuine loss), which LoadReport folds into type
    names."""

    def __init__(self):
        self.lock = threading.Lock()
        self.submitted = 0
        self.outcomes: dict[str, int] = {}
        self.lost: list[str] = []
        self.failover_retries = 0

    def record(self, outcome: str, detail: str = "") -> None:
        with self.lock:
            self.submitted += 1
            self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
            if outcome == "lost":
                self.lost.append(detail[:200])

    def snapshot(self) -> dict:
        with self.lock:
            return {
                "submitted": self.submitted,
                "outcomes": dict(self.outcomes),
                "lost": list(self.lost),
                "failover_retries": self.failover_retries,
            }


def failover_executor(bus, ledger: _Ledger | None = None,
                      max_attempts: int = 6, backoff_s: float = 0.15):
    """``run_load``-shaped executor that discovers the leader implicitly
    (only the leader subscribes ``broker.execute``) and retries through
    a failover window: a :class:`BusTimeout` during takeover means "no
    broker answered" — the request was not executed, so resubmitting a
    read-only script to the next leader is safe."""

    def execute(query, timeout_s, **kw):
        req = {"query": query, "timeout_s": timeout_s}
        req.update((k, v) for k, v in kw.items() if v is not None)
        last: Exception | None = None
        for attempt in range(max_attempts):
            try:
                res = bus.request(
                    "broker.execute", req, timeout_s=timeout_s + 5,
                )
            except BusTimeout as e:
                last = e
                if ledger is not None:
                    with ledger.lock:
                        ledger.failover_retries += 1
                time.sleep(backoff_s * (attempt + 1))
                continue
            if not res.get("ok"):
                err = str(res.get("error", "unknown broker error"))
                if ledger is not None:
                    resolved = any(m in err for m in _REFUSALS)
                    ledger.record("refused" if resolved else "lost", err)
                raise RuntimeError(err)
            if ledger is not None:
                ledger.record("partial" if res.get("partial") else "ok")
            return res
        if ledger is not None:
            ledger.record("lost", f"no broker answered: {last}")
        raise last  # type: ignore[misc]

    return execute


@dataclass
class ChaosReport:
    agents: int = 0
    brokers: int = 0
    seed: int = 0
    wall_s: float = 0.0
    baseline_p99_ms: float = 0.0
    victim_p99_ms: float = 0.0
    victim_p99_bound_ms: float = 0.0
    isolation_ok: bool = True
    ledger: dict = field(default_factory=dict)
    lost: list = field(default_factory=list)
    faults_fired: int = 0
    leader_kills: int = 0
    failovers: int = 0
    agent_kills: int = 0
    partitions_healed: int = 0
    threads_before: int = 0
    threads_after: int = 0
    thread_leak: bool = False
    streams: dict = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return (
            not self.lost and not self.thread_leak and self.isolation_ok
            and (self.leader_kills == 0 or self.failovers > 0)
        )

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "agents": self.agents,
            "brokers": self.brokers,
            "seed": self.seed,
            "wall_s": round(self.wall_s, 2),
            "baseline_p99_ms": round(self.baseline_p99_ms, 2),
            "victim_p99_ms": round(self.victim_p99_ms, 2),
            "victim_p99_bound_ms": round(self.victim_p99_bound_ms, 2),
            "isolation_ok": self.isolation_ok,
            "ledger": self.ledger,
            "lost": self.lost,
            "faults_fired": self.faults_fired,
            "leader_kills": self.leader_kills,
            "failovers": self.failovers,
            "agent_kills": self.agent_kills,
            "partitions_healed": self.partitions_healed,
            "threads_before": self.threads_before,
            "threads_after": self.threads_after,
            "thread_leak": self.thread_leak,
            "streams": self.streams,
        }


def _current_leader(replicas):
    for r in replicas:
        if not r._dead and r.role == "leader":
            return r
    return None


def _wait_for(pred, timeout_s: float, interval_s: float = 0.05) -> bool:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval_s)
    return pred()


def run_chaos_soak(
    n_agents: int = 32,
    n_brokers: int = 2,
    seed: int = 0,
    rows: int = 400,
    per_worker: int = 4,
    noisy_workers: int = 2,
    timeout_s: float = 20.0,
    kill_leader: bool = True,
    p99_floor_s: float = 2.0,
    device=None,
) -> ChaosReport:
    """Build the cluster, run the soak, tear down, audit. See module
    docstring for the asserted contract. Every agent's engine runs on
    ``device`` (``load_tester.resolve_device``: the CUDA card unless
    the CPU is named)."""
    import numpy as np

    from ..config import override_flag
    from ..exec.engine import Engine
    from .agent import KelvinAgent, PEMAgent

    dev = resolve_device(device)

    report = ChaosReport(agents=n_agents, brokers=n_brokers, seed=seed)
    report.threads_before = threading.active_count()
    t0 = time.perf_counter()

    with override_flag("broker_lease_interval_s", 0.1), \
            override_flag("broker_lease_expiry_s", 0.5), \
            override_flag("broker_reconcile_wait_s", 0.4), \
            override_flag("broker_reattach_timeout_s", 8.0):
        bus = MessageBus()
        inj = FaultInjector(seed)
        tracker_kw = dict(expiry_s=60.0, check_interval_s=60.0,
                          flap_threshold=3, flap_window_s=60.0,
                          quarantine_s=1.0)
        replicas = [
            BrokerReplica(bus, f"broker-{i}", tracker_kw=tracker_kw,
                          leader=(i == 0))
            for i in range(n_brokers)
        ]
        n_kelvin = max(1, n_agents // 16)
        agents = []
        rng = np.random.default_rng(seed)
        for i in range(n_agents - n_kelvin):
            pem = PEMAgent(bus, f"pem-{i}", engine=Engine(device=dev),
                           heartbeat_interval_s=5.0)
            n = max(rows // 4, 64) if i % 7 == 0 else rows
            pem.engine.append_data("http_events", {
                # Wall-clock-anchored timestamps: the freshness column
                # reports real watermark lag, not epoch-zero nonsense.
                "time_": np.int64(time.time_ns())
                + np.arange(n, dtype=np.int64),
                "latency_ns": rng.integers(1_000, 1_000_000, n),
                "resp_status": rng.choice(
                    np.array([200, 200, 200, 500], dtype=np.int64), n
                ),
                "service": [f"svc-{j % 8}" for j in range(n)],
            })
            agents.append(pem.start())
        for i in range(n_kelvin):
            agents.append(
                KelvinAgent(
                    bus, f"kelvin-{i}", engine=Engine(device=dev),
                    heartbeat_interval_s=5.0,
                ).start()
            )
        leader = replicas[0]
        if not _wait_for(
            lambda: len(leader.tracker.agent_ids()) == len(agents)
            and "http_events" in leader.tracker.schemas(),
            timeout_s=15.0,
        ):
            raise RuntimeError(
                "chaos cluster never converged: "
                f"{len(leader.tracker.agent_ids())}/{len(agents)} agents"
            )

        ledger = _Ledger()
        execute = failover_executor(bus, ledger)

        # Warm-up (uncounted, ledger-free executor): both phases then
        # run with the plan memos hot and the kernels built, so the
        # baseline/chaos p99 comparison measures the cluster, not the
        # first query's setup.
        warm = failover_executor(bus)
        for q in (VICTIM_QUERY, NOISY_QUERY):
            try:
                warm(q, timeout_s)
            except Exception:
                pass  # the measured phases will report the failure mode

        # Phase A: the victim's SOLO baseline on the healthy cluster —
        # the denominator of the isolation bound.
        base = run_load(
            execute, VICTIM_QUERY, workers=2, per_worker=per_worker,
            timeout_s=timeout_s, tenant="dash",
        )
        report.baseline_p99_ms = base.percentile(99) * 1e3

        # Phase B: mixed tenants + the fault schedule. Background noise
        # rules are low-probability and count-capped so retries absorb
        # them (an exhausted dispatch retry would read as a lost query
        # — that's the AGENT-kill path's job to exercise, attributably).
        bus.fault_injector = inj
        inj.drop("agent.*.ack", prob=0.05, count=10)
        inj.delay("agent.*.bridge", 0.05, prob=0.1, count=30)
        inj.duplicate("agent.*.execute", prob=0.05, count=10)

        stop = threading.Event()
        # The mixed load stays open until the schedule has run: the JAX
        # soak fires a fixed count per worker, which a faster engine
        # finishes before the leader kill 1.6 s in (no failover would
        # be exercised). Each worker fires its count, then more until
        # the schedule has closed the load.
        load_open = threading.Event()

        def _chaos_driver():
            try:
                _schedule()
            finally:
                load_open.set()

        def _schedule():
            # Wall-clock offsets into the load phase; each step bails
            # if the load finished first.
            if stop.wait(0.5):
                return
            # Partition one mid-fleet PEM from the control plane, heal
            # shortly after: in-window queries go partial/expired or
            # ride retries, NOTHING hangs.
            inj.partition("pem-3", "broker")
            if stop.wait(0.6):
                report.partitions_healed += inj.heal()
                return
            report.partitions_healed += inj.heal()
            # Kill a data agent outright mid-query: force-expired so
            # failure detection is deterministic.
            victim_agent = next(
                (a for a in agents if a.agent_id == "pem-5"), None
            )
            lead = _current_leader(replicas)
            if victim_agent is not None and lead is not None:
                victim_agent.stop()
                lead.tracker.force_expire(
                    victim_agent.agent_id, reason="chaos kill"
                )
                report.agent_kills += 1
            if stop.wait(0.5):
                return
            # The headline event: crash the leader with queries in
            # flight. A standby claims the next epoch within one lease
            # window and adopts the mirror.
            if kill_leader:
                lead = _current_leader(replicas)
                if lead is not None and len(replicas) > 1:
                    lead.kill()
                    report.leader_kills += 1
                    _wait_for(
                        lambda: _current_leader(replicas) not in (None, lead),
                        timeout_s=5.0,
                    )
                    stop.wait(SETTLE_S)

        driver = threading.Thread(
            target=_chaos_driver, daemon=True, name="chaos-driver"
        )
        streams = [
            TenantStream(tenant="dash", query=VICTIM_QUERY, workers=2,
                         per_worker=per_worker * 2, priority=1,
                         timeout_s=timeout_s),
            TenantStream(tenant="batch", query=NOISY_QUERY,
                         workers=noisy_workers,
                         per_worker=per_worker * 2,
                         timeout_s=timeout_s),
        ]
        # The budget is the isolation MECHANISM, so it must be sized to
        # the workload, not generous: the batch tenant's quarter-share
        # should admit roughly ONE of its queries at a time (predicted
        # staged bytes scale with total fleet rows), so its burst
        # QUEUES behind its own share instead of either saturating the
        # core (budget too big) or being hard-rejected at the door
        # before any pressure exists (budget too small).
        budget_mb = max(4.0, 6.0 * (n_agents / 32.0) * (rows / 400.0))
        with override_flag("admission_tenant_weights", "dash:3,batch:1"), \
                override_flag("admission_bytes_budget_mb", budget_mb), \
                override_flag("admission_queue_s", 10.0):
            driver.start()
            reports = run_mixed_load(execute, streams, until=load_open)
        stop.set()
        driver.join(timeout=10.0)
        inj.heal()

        report.victim_p99_ms = reports["dash"].percentile(99) * 1e3
        # The tenancy multiplier plus an absolute floor: one failover
        # window (lease expiry + reconcile + a retry ladder) can land
        # whole on a tail query, which would swamp a sub-100ms baseline
        # under a bare 1.25x. The floor absorbs exactly that; the check
        # still catches isolation COLLAPSE (victim p99 at timeout
        # scale). The precise 1.25x bound is the tenancy tests' own.
        bound_s = 1.25 * (report.baseline_p99_ms / 1e3) + p99_floor_s
        report.victim_p99_bound_ms = bound_s * 1e3
        report.isolation_ok = (
            report.victim_p99_ms <= report.victim_p99_bound_ms
        )
        report.streams = {k: r.to_dict() for k, r in reports.items()}
        report.faults_fired = inj.fired()
        report.failovers = sum(r.failovers for r in replicas)
        report.ledger = ledger.snapshot()
        report.lost = report.ledger["lost"]

        # Teardown, then audit the thread count: every lease watcher,
        # forwarder wait, failover adopter and heartbeat must exit.
        bus.fault_injector = None
        for a in agents:
            a.stop()
        for r in replicas:
            if not r._dead:
                r.close()
        bus.close()
    settled = _wait_for(
        lambda: threading.active_count() <= report.threads_before + 1,
        timeout_s=12.0, interval_s=0.2,
    )
    report.threads_after = threading.active_count()
    report.thread_leak = not settled
    report.wall_s = time.perf_counter() - t0
    return report


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    ap = argparse.ArgumentParser(
        prog="python -m pixie_tpu_torch.services.chaos",
        description=(
            "Combined chaos soak: mixed-tenant load against an N-agent "
            "M-broker cluster under a seeded fault schedule including a "
            "leader-broker kill. Exit 0 iff zero lost queries, zero "
            "leaked threads, and the victim tenant's p99 held its "
            "isolation bound."
        ),
    )
    ap.add_argument("--agents", type=int, default=32)
    ap.add_argument("--brokers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=400)
    ap.add_argument("--per-worker", type=int, default=4)
    ap.add_argument("--no-leader-kill", action="store_true",
                    help="skip the leader-crash event (agent faults "
                         "and partitions only)")
    ap.add_argument("--full", action="store_true",
                    help="the long soak: more offered load per worker")
    ap.add_argument("--device", default=None,
                    help="the agents' device: cuda (default) or cpu; "
                         "also $PIXIE_TPU_TORCH_DEVICE")
    args = ap.parse_args(argv)

    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:  # no card, bad device
        print(f"error: {e} (--device cpu or PIXIE_TPU_TORCH_DEVICE=cpu "
              "runs it on the CPU)",
              file=sys.stderr)
        return 1

    report = run_chaos_soak(
        n_agents=args.agents,
        n_brokers=args.brokers,
        seed=args.seed,
        rows=args.rows,
        per_worker=args.per_worker * (3 if args.full else 1),
        kill_leader=not args.no_leader_kill,
        device=args.device,
    )
    print(json.dumps(report.to_dict(), indent=2))
    return 0 if report.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

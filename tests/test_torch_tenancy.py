"""Tenant-aware overload protection on the port against the JAX package.

The cases of ``tests/test_tenancy.py``, one counterpart each:

- the tenancy model (``services/tenancy.py``: weights, shares, the
  bounded resolve) and the admission scheduler (``_Admission`` in
  ``services/query_broker.py``: per-tenant shares, priority then
  earliest deadline, event-driven wakeups, deadline shedding, cancel)
  run on both packages, and the two runs' observations (weights, shares,
  admission orders, diagnostic codes, counters) must be equal;
- the load tester's tenancy keyword arguments, on both packages;
- the tenants end to end on a port cluster of CPU engines (two PEMs and
  a Kelvin on one in-process bus): the tenant threads to the trace and
  to ``__queries__``, a queued query past its deadline is shed without
  dispatch, ``cancel_query`` reaches a queued query, a running fragment
  and a running merge, and the served front door is capped per tenant.
  The answers are held to a JAX engine over the same rows;
- the p99 isolation gate, ``slow`` as its JAX counterpart is.

The cluster fixture waits until EVERY PEM's tables are in the tracker
(``distributed_state().pems``), not for the union of schemas: a PEM
whose registration has not landed is left out of the next plan, the race
behind the JAX ``test_cancel_*`` flakes.
"""

from __future__ import annotations

import threading
import time
import types

import numpy as np
import pytest

import pixie_tpu.services.load_tester as jax_load_tester
import pixie_tpu.services.observability as jax_obs
import pixie_tpu.services.query_broker as jax_qb
import pixie_tpu.services.tenancy as jax_tenancy
import pixie_tpu_torch.services.load_tester as port_load_tester
import pixie_tpu_torch.services.observability as port_obs
import pixie_tpu_torch.services.query_broker as port_qb
import pixie_tpu_torch.services.tenancy as port_tenancy
from pixie_tpu import config as jax_config
from pixie_tpu.exec.engine import Engine as JaxEngine
from pixie_tpu_torch.config import override_flag
from pixie_tpu_torch import config as port_config
from pixie_tpu_torch.exec.engine import Engine
from pixie_tpu_torch.services import (
    AgentTracker,
    KelvinAgent,
    MessageBus,
    PEMAgent,
    QueryBroker,
)
from pixie_tpu_torch.services.query_broker import AdmissionError
from pixie_tpu_torch.services.tenancy import DEFAULT_TENANT

PKGS = {
    "port": types.SimpleNamespace(
        tenancy=port_tenancy, qb=port_qb, obs=port_obs,
        config=port_config, load_tester=port_load_tester,
    ),
    "jax": types.SimpleNamespace(
        tenancy=jax_tenancy, qb=jax_qb, obs=jax_obs,
        config=jax_config, load_tester=jax_load_tester,
    ),
}

FAST = dict(heartbeat_interval_s=30.0)

VICTIM_Q = (
    "import px\n"
    "df = px.DataFrame(table='http_events')\n"
    "df = df.groupby('service').agg(\n"
    "    n=('latency_ns', px.count), mean=('latency_ns', px.mean))\n"
    "px.display(df, 'out')\n"
)

# Merge-free (filter and limit stay on the data agents), so the
# isolation gate measures the scheduler, not merge compute.
NOISY_CHEAP_Q = (
    "import px\n"
    "df = px.DataFrame(table='noise_events')\n"
    "df = df[df.latency_ns < 0]\n"
    "df = df.head(5)\n"
    "px.display(df, 'out')\n"
)


def _pred(n):
    return {"bytes_staged_hi": int(n), "origin": "sketch", "safety": 2.0}


def _both(fn):
    return {name: fn(p) for name, p in PKGS.items()}


class TestTenancyModel:
    def test_weights_parse_and_default_tenant(self):
        def run(p):
            D = p.tenancy.DEFAULT_TENANT
            with p.config.override_flag("admission_tenant_weights",
                                        "dash:4, batch:1"):
                w = dict(p.tenancy.tenant_weights())
            assert w == {"dash": 4.0, "batch": 1.0, D: 1.0}
            with p.config.override_flag("admission_tenant_weights", ""):
                empty = dict(p.tenancy.tenant_weights())
                shares = p.tenancy.tenant_shares(600.0)
            assert empty == {D: 1.0}
            assert shares == {D: 600.0}
            return w, empty, shares

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_malformed_entries_are_tolerated(self):
        def run(p):
            with p.config.override_flag(
                "admission_tenant_weights", "a:x, :3, b, c:-2, ,d:2"
            ):
                w = dict(p.tenancy.tenant_weights())
            assert w["a"] == 1.0  # bad weight -> 1
            assert w["b"] == 1.0  # missing weight -> 1
            assert w["c"] == 0.0  # negative clamps to 0 (registered, off)
            assert w["d"] == 2.0
            assert p.tenancy.DEFAULT_TENANT in w
            return w

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_shares_partition_budget(self):
        def run(p):
            D = p.tenancy.DEFAULT_TENANT
            with p.config.override_flag("admission_tenant_weights", "a:3,b:1"):
                shares = p.tenancy.tenant_shares(1000.0)
            assert shares == {"a": 600.0, "b": 200.0, D: 200.0}
            assert sum(shares.values()) == pytest.approx(1000.0)
            return shares

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_weights_memoized_per_spec(self):
        def run(p):
            with p.config.override_flag("admission_tenant_weights", "a:2,b:1"):
                w1 = p.tenancy.tenant_weights()
                assert p.tenancy.tenant_weights() is w1
            with p.config.override_flag("admission_tenant_weights", "a:3"):
                w2 = p.tenancy.tenant_weights()
                assert w2 is not w1 and w2["a"] == 3.0
            return dict(w1), dict(w2)

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_resolve_folds_unknown_into_shared_and_counts(self):
        def run(p):
            D = p.tenancy.DEFAULT_TENANT
            c = p.obs.default_counter("pixie_admission_unknown_tenant_total")
            seen = []
            with p.config.override_flag("admission_tenant_weights", "dash:2"):
                before = c.value()
                seen.append(p.tenancy.resolve_tenant("dash"))
                seen.append(p.tenancy.resolve_tenant(None))
                seen.append(p.tenancy.resolve_tenant(""))
                assert c.value() == before  # known or empty: not unknown
                seen.append(p.tenancy.resolve_tenant("rando-123"))
                assert c.value() == before + 1
            assert seen == ["dash", D, D, D]
            return seen

        got = _both(run)
        assert got["port"] == got["jax"]


class TestAdmissionScheduler:
    """Each case runs on both packages' ``_Admission``; the observed
    admission orders, codes and counters must be equal."""

    def test_over_share_tenant_queues_behind_itself_only(self):
        def run(p):
            adm = p.qb._Admission()
            with p.config.override_flag("admission_tenant_weights", "a:1,b:1"), \
                    p.config.override_flag("admission_bytes_budget_mb", 3.0), \
                    p.config.override_flag("admission_queue_s", 10.0):
                adm.admit("a1", _pred(900 << 10), tenant="a")
                order = []

                def a2():
                    adm.admit("a2", _pred(900 << 10), tenant="a")
                    order.append("a2")

                t = threading.Thread(target=a2)
                t.start()
                time.sleep(0.1)
                assert order == []  # a2 queued behind a's own in-flight
                t0 = time.perf_counter()
                adm.admit("b1", _pred(900 << 10), tenant="b")
                assert time.perf_counter() - t0 < 0.5
                assert order == []
                adm.release("a1")
                t.join(5.0)
                assert order == ["a2"]
                flight = sorted(adm.in_flight())
                assert flight == ["a2", "b1"]
                adm.release("a2")
                adm.release("b1")
            return order, flight

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_reject_predicted_over_tenant_share(self):
        def run(p):
            adm = p.qb._Admission()
            with p.config.override_flag("admission_tenant_weights", "a:1,b:1"), \
                    p.config.override_flag("admission_bytes_budget_mb", 3.0):
                with pytest.raises(p.qb.AdmissionError) as ei:
                    adm.admit("q", _pred(2 << 20), tenant="a")  # share 1MB
            assert ei.value.diagnostic.code == "admission-reject"
            assert "share" in str(ei.value)
            assert adm.in_flight() == {}
            return ei.value.diagnostic.code, str(ei.value)

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_wait_queue_orders_priority_then_deadline(self):
        def run(p):
            adm = p.qb._Admission()
            order = []
            with p.config.override_flag("admission_bytes_budget_mb", 1.0), \
                    p.config.override_flag("admission_queue_s", 15.0):
                adm.admit("hold", _pred(900 << 10))
                now = time.monotonic()

                def waiter(qid, priority, deadline):
                    adm.admit("q" + qid, _pred(900 << 10),
                              priority=priority, deadline=deadline)
                    order.append(qid)
                    adm.release("q" + qid)

                specs = [("late-lowpri", 0, now + 60.0),
                         ("early-lowpri", 0, now + 30.0),
                         ("hipri", 5, None)]
                threads = []
                for qid, pri, dl in specs:
                    t = threading.Thread(target=waiter, args=(qid, pri, dl))
                    t.start()
                    threads.append(t)
                    time.sleep(0.05)  # deterministic arrival order
                head = adm.queued()[0]["qid"]
                assert head == "qhipri"
                adm.release("hold")
                for t in threads:
                    t.join(10.0)
            assert order == ["hipri", "early-lowpri", "late-lowpri"]
            return head, order

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_queued_deadline_lapse_sheds_with_structured_diag(self):
        def run(p):
            adm = p.qb._Admission()
            shed_c = p.obs.default_counter("pixie_admission_shed_total").labels(
                tenant=p.tenancy.DEFAULT_TENANT
            )
            before = shed_c.value()
            with p.config.override_flag("admission_bytes_budget_mb", 1.0), \
                    p.config.override_flag("admission_queue_s", 30.0):
                adm.admit("hold", _pred(900 << 10))
                t0 = time.perf_counter()
                with pytest.raises(p.qb.AdmissionError) as ei:
                    adm.admit("q2", _pred(900 << 10),
                              deadline=time.monotonic() + 0.15)
                waited = time.perf_counter() - t0
            assert ei.value.diagnostic.code == "admission-shed"
            assert 0.1 < waited < 5.0  # shed at the deadline, not queue_s
            assert shed_c.value() == before + 1
            assert list(adm.in_flight()) == ["hold"]
            assert adm.queued() == []
            return ei.value.diagnostic.code, shed_c.value() - before

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_release_wakes_waiter_immediately(self):
        def run(p):
            adm = p.qb._Admission()
            admitted_at = {}
            with p.config.override_flag("admission_bytes_budget_mb", 1.0), \
                    p.config.override_flag("admission_queue_s", 20.0):
                adm.admit("q1", _pred(900 << 10))

                def second():
                    adm.admit("q2", _pred(900 << 10))
                    admitted_at["t"] = time.perf_counter()

                t = threading.Thread(target=second)
                t.start()
                time.sleep(0.2)  # q2 is parked on its event
                released_at = time.perf_counter()
                adm.release("q1")
                t.join(5.0)
            latency = admitted_at["t"] - released_at
            assert latency < 0.05, f"release->admit took {latency:.3f}s"
            return sorted(adm.in_flight())

        got = _both(run)
        assert got["port"] == got["jax"] == ["q2"]

    def test_shed_unblocks_lower_priority_waiters(self):
        def run(p):
            adm = p.qb._Admission()
            admitted_at = {}
            with p.config.override_flag("admission_tenant_weights", "a:1,b:1"), \
                    p.config.override_flag("admission_bytes_budget_mb", 3.0), \
                    p.config.override_flag("admission_queue_s", 20.0):
                adm.admit("a1", _pred(900 << 10), tenant="a")

                def high():
                    with pytest.raises(p.qb.AdmissionError) as ei:
                        adm.admit("aH", _pred(900 << 10), tenant="a",
                                  priority=5,
                                  deadline=time.monotonic() + 0.3)
                    admitted_at["shed_code"] = ei.value.diagnostic.code
                    admitted_at["shed_t"] = time.perf_counter()

                def low():
                    adm.admit("bL", _pred(900 << 10), tenant="b")
                    admitted_at["bL"] = time.perf_counter()

                th = threading.Thread(target=high)
                th.start()
                time.sleep(0.05)  # aH queued (a's share full), priority 5
                tl = threading.Thread(target=low)
                tl.start()
                time.sleep(0.1)
                # bL fits b's empty share but yields to the waiting
                # priority-5 class (strict priority).
                blocked = "bL" not in admitted_at
                assert blocked
                th.join(5.0)
                tl.join(5.0)
                assert admitted_at.get("shed_code") == "admission-shed"
                assert "bL" in admitted_at, "bL never admitted"
                latency = admitted_at["bL"] - admitted_at["shed_t"]
                assert latency < 2.0, f"shed->admit took {latency:.3f}s"
                adm.release("a1")
                adm.release("bL")
            return blocked, admitted_at["shed_code"]

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_same_tenant_small_queries_do_not_starve_blocked_big(self):
        def run(p):
            adm = p.qb._Admission()
            order = []
            with p.config.override_flag("admission_bytes_budget_mb", 1.0), \
                    p.config.override_flag("admission_queue_s", 20.0):
                adm.admit("b0", _pred(500 << 10))

                def waiter(qid, pred_kb):
                    adm.admit(qid, _pred(pred_kb << 10))
                    order.append(qid)

                big = threading.Thread(target=waiter, args=("big", 800))
                big.start()
                time.sleep(0.1)  # big queued (0.5 + 0.8 > 1MB)
                small = threading.Thread(target=waiter, args=("small", 400))
                small.start()
                time.sleep(0.2)
                # small fits the free budget but queues behind its
                # tenant's blocked head.
                assert order == []
                adm.release("b0")
                big.join(5.0)
                assert order == ["big"]
                adm.release("big")
                small.join(5.0)
                assert order == ["big", "small"]
                adm.release("small")
            return order

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_holddown_armed_mid_sleep_still_wakes_waiter(self):
        def run(p):
            adm = p.qb._Admission()
            admitted_at = {}
            with p.config.override_flag("admission_bytes_budget_mb", 1.0), \
                    p.config.override_flag("admission_queue_s", 20.0), \
                    p.config.override_flag("admission_priority_holddown_ms",
                                           100.0):
                adm.admit("hi", _pred(900 << 10), priority=5)

                def low():
                    adm.admit("lo", _pred(900 << 10))
                    admitted_at["t"] = time.perf_counter()

                t = threading.Thread(target=low)
                t.start()
                time.sleep(0.2)  # lo parked, no hold armed yet
                released_at = time.perf_counter()
                adm.release("hi")  # arms the priority-5 hold-down
                t.join(10.0)
                assert "t" in admitted_at, "lo never admitted"
                latency = admitted_at["t"] - released_at
                # Within about one hold window of the lapse, not at the
                # 20 s queue timeout.
                assert latency < 2.0, f"release->admit took {latency:.3f}s"
                flight = sorted(adm.in_flight())
                adm.release("lo")
            return flight

        got = _both(run)
        assert got["port"] == got["jax"] == ["lo"]

    def test_cancel_removes_queued_waiter(self):
        def run(p):
            adm = p.qb._Admission()
            caught = {}
            with p.config.override_flag("admission_bytes_budget_mb", 1.0), \
                    p.config.override_flag("admission_queue_s", 20.0):
                adm.admit("hold", _pred(900 << 10))

                def second():
                    try:
                        adm.admit("q2", _pred(900 << 10))
                    except p.qb.AdmissionError as e:
                        caught["diag"] = e.diagnostic
                        caught["t"] = time.perf_counter()

                t = threading.Thread(target=second)
                t.start()
                time.sleep(0.2)  # q2 parked
                unknown = adm.cancel("unknown")
                assert unknown is False
                t0 = time.perf_counter()
                assert adm.cancel("q2") is True
                t.join(5.0)
                assert caught.get("diag") is not None, "q2 admitted"
                assert caught["diag"].code == "admission-cancelled"
                assert caught["t"] - t0 < 2.0  # event-driven
                assert adm.queued() == []
                again = adm.cancel("q2")
                assert again is False
                adm.release("hold")
            return unknown, caught["diag"].code, again

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_queued_counter_and_tenant_accounting(self):
        def run(p):
            adm = p.qb._Admission()
            with p.config.override_flag("admission_tenant_weights", "a:1"), \
                    p.config.override_flag("admission_bytes_budget_mb", 2.0), \
                    p.config.override_flag("admission_queue_s", 10.0):
                queued_c = p.obs.default_counter(
                    "pixie_admission_queued_total"
                ).labels(tenant="a")
                before = queued_c.value()
                adm.admit("a1", _pred(900 << 10), tenant="a")
                assert queued_c.value() == before  # sailed through

                def second():
                    adm.admit("a2", _pred(900 << 10), tenant="a")

                t = threading.Thread(target=second)
                t.start()
                time.sleep(0.1)
                assert queued_c.value() == before + 1
                by_tenant = adm.in_flight_by_tenant()
                assert by_tenant == {"a": 900 << 10}
                adm.release("a1")
                t.join(5.0)
                adm.release("a2")
            return queued_c.value() - before, by_tenant

        got = _both(run)
        assert got["port"] == got["jax"]


# -- tenants end to end on a port cluster --------------------------------------

def _wait_for(pred, timeout_s: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout_s
    while not pred():
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.01)
    return True


def _cluster_rows(n_pems, rows, noise_rows):
    """Each PEM's rows, drawn in turn from one seeded generator."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n_pems):
        http = {
            "time_": np.arange(rows, dtype=np.int64),
            "latency_ns": rng.integers(1000, 1_000_000, rows),
            "resp_status": rng.choice(np.array([200, 200, 404, 500]), rows),
            "service": [f"svc-{j % 4}" for j in range(rows)],
        }
        noise = {
            "time_": np.arange(noise_rows, dtype=np.int64),
            "latency_ns": rng.integers(1000, 1_000_000, noise_rows),
            "service": [f"noise-{j % 2}" for j in range(noise_rows)],
        }
        out.append((http, noise))
    return out


def _mk_cluster(n_pems=2, rows=6000, noise_rows=400):
    bus = MessageBus()
    tracker = AgentTracker(bus, expiry_s=60.0, check_interval_s=60.0)
    data = _cluster_rows(n_pems, rows, noise_rows)
    pems = []
    for i, (http, noise) in enumerate(data):
        pem = PEMAgent(bus, f"pem-{i}", engine=Engine(device="cpu"), **FAST)
        # Appended before start: the first registration carries both
        # tables and their sketch stats.
        pem.append_data("http_events", http)
        pem.append_data("noise_events", noise)
        pems.append(pem.start())
    kelvin = KelvinAgent(bus, "kelvin-0", engine=Engine(device="cpu"),
                         **FAST).start()
    # Every PEM's two tables, and the Kelvin, in the tracker.
    assert _wait_for(lambda: (
        sum(a.has_table("http_events") and a.has_table("noise_events")
            for a in tracker.distributed_state().pems) == n_pems
        and tracker.distributed_state().kelvins
        and tracker.table_stats()
    ))
    broker = QueryBroker(bus, tracker)
    return bus, tracker, pems, kelvin, broker, data


def _close_cluster(bus, tracker, pems, kelvin, broker):
    broker.close()
    for a in pems + [kelvin]:
        a.stop()
    tracker.close()
    bus.close()


@pytest.fixture(scope="class")
def cluster():
    bus, tracker, pems, kelvin, broker, data = _mk_cluster()
    yield bus, tracker, pems, kelvin, broker, data
    _close_cluster(bus, tracker, pems, kelvin, broker)


def _predicted_bytes(broker, query):
    """Plan-time predicted staged bytes of one warm run (admission
    off)."""
    broker.execute_script(query, timeout_s=30)
    pred = broker.tracer.recent()[0].get("predicted") or {}
    pb = pred.get("bytes_staged_hi")
    assert pb, f"no predicted cost for query (sketches missing?): {pred}"
    return int(pb)


def _victim_answer(batch) -> list:
    d = batch.to_pydict()
    o = np.argsort(np.asarray(d["service"]).astype(str))
    return [(str(d["service"][i]), int(d["n"][i]), float(d["mean"][i]))
            for i in o]


def _jax_victim_answer(data) -> list:
    """VICTIM_Q on one JAX engine holding every PEM's rows."""
    eng = JaxEngine(window_rows=1 << 12)
    for http, _ in data:
        eng.append_data("http_events", http)
    return _victim_answer(eng.execute_query(VICTIM_Q)["out"])


class TestTenantEndToEnd:
    def test_tenant_threads_to_trace_result_and_telemetry(self, cluster):
        bus, tracker, pems, kelvin, broker, data = cluster
        with override_flag("admission_tenant_weights", "dash:2"):
            res = broker.execute_script(VICTIM_Q, timeout_s=30, tenant="dash")
            assert res["tenant"] == "dash"
            row = broker.tracer.recent()[0]
            assert row["tenant"] == "dash"
            # Agents stamped the dispatch envelope's tenant onto their
            # fragment traces: per-agent __queries__ rows carry it.
            def tenants():
                return list(pems[0].engine.tables["__queries__"].read_all()
                            .to_pydict()["tenant"])

            assert _wait_for(lambda: "dash" in tenants(), 5.0), tenants()
            # An unregistered tenant folds into the shared one.
            res2 = broker.execute_script(VICTIM_Q, timeout_s=30,
                                         tenant="not-registered")
            assert res2["tenant"] == DEFAULT_TENANT
        got = _victim_answer(res["tables"]["out"])
        want = _jax_victim_answer(data)
        assert [g[:2] for g in got] == [w[:2] for w in want]
        np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want],
                                   rtol=1e-5)
        assert _victim_answer(res2["tables"]["out"]) == got

    def test_queued_deadline_shed_never_dispatches(self, cluster):
        """A queued query whose deadline lapses is shed without dispatch:
        a structured diagnostic and no agent execution."""
        bus, tracker, pems, kelvin, broker, _ = cluster
        pred = _predicted_bytes(broker, VICTIM_Q)
        budget_mb = (pred * 1.5) / (1 << 20)
        executes = []
        subs = [bus.subscribe(f"agent.{p.agent_id}.execute", executes.append)
                for p in pems]
        try:
            with override_flag("admission_bytes_budget_mb", budget_mb), \
                    override_flag("admission_queue_s", 30.0):
                broker.admission.admit("blocker", _pred(pred))
                t0 = time.perf_counter()
                with pytest.raises(AdmissionError) as ei:
                    broker.execute_script(VICTIM_Q, timeout_s=30,
                                          deadline_ms=200.0)
                waited = time.perf_counter() - t0
                broker.admission.release("blocker")
            assert ei.value.diagnostic.code == "admission-shed"
            assert waited < 5.0  # shed at its deadline, not queue_s
            time.sleep(0.1)  # a dispatch would have landed by now
            assert executes == []
        finally:
            for s in subs:
                s.unsubscribe()

    def test_cancel_query_reaches_admission_queued_query(self, cluster):
        """``cancel_query`` of a qid still waiting for admission cancels
        it at the queue: True, an ``admission-cancelled`` error for the
        caller, no agent execution."""
        bus, tracker, pems, kelvin, broker, _ = cluster
        pred = _predicted_bytes(broker, VICTIM_Q)
        budget_mb = (pred * 1.5) / (1 << 20)
        executes = []
        subs = [bus.subscribe(f"agent.{p.agent_id}.execute", executes.append)
                for p in pems]
        out = {}
        try:
            with override_flag("admission_bytes_budget_mb", budget_mb), \
                    override_flag("admission_queue_s", 30.0):
                broker.admission.admit("blocker", _pred(pred))

                def run():
                    try:
                        broker.execute_script(VICTIM_Q, timeout_s=60)
                        out["res"] = "admitted"
                    except AdmissionError as e:
                        out["diag"] = e.diagnostic

                t = threading.Thread(target=run)
                t.start()
                qid = None
                deadline = time.time() + 5
                while time.time() < deadline and qid is None:
                    qid = next((q["qid"] for q in broker.admission.queued()),
                               None)
                    time.sleep(0.01)
                assert qid, "query never queued"
                assert broker.cancel_query(qid) is True
                t.join(10.0)
                assert not t.is_alive()
                broker.admission.release("blocker")
            assert out.get("diag") is not None, out
            assert out["diag"].code == "admission-cancelled"
            time.sleep(0.1)
            assert executes == []
        finally:
            for s in subs:
                s.unsubscribe()

    def test_served_front_door_is_per_tenant(self, cluster):
        """``broker.execute`` workers are capped per tenant: a noisy
        tenant whose requests are all parked in admission cannot hold
        the front door, and a victim tenant's request completes."""
        bus, tracker, pems, kelvin, broker, _ = cluster
        pred = _predicted_bytes(broker, VICTIM_Q)
        budget_mb = (pred * 20) / (1 << 20)
        weights = "victim:17,noisy:1.5,shared:1.5"
        broker.serve()
        replies: dict = {}
        subs = []

        def _ask(key, tenant):
            topic = f"client.test.{key}"
            subs.append(bus.subscribe(
                topic, lambda m, _k=key: replies.setdefault(_k, m)))
            bus.publish("broker.execute", {
                "query": VICTIM_Q, "timeout_s": 30.0, "tenant": tenant,
                "_reply_to": topic,
            })

        try:
            with override_flag("broker_execute_threads", 2), \
                    override_flag("admission_tenant_weights", weights), \
                    override_flag("admission_bytes_budget_mb", budget_mb), \
                    override_flag("admission_queue_s", 30.0):
                broker.admission.admit("noisy-blocker", _pred(pred),
                                       tenant="noisy")
                for i in range(4):  # 2 park in admission, 2 backlog
                    _ask(f"noisy-{i}", "noisy")
                t0 = time.perf_counter()
                _ask("victim", "victim")
                assert _wait_for(lambda: "victim" in replies, 10.0)
                waited = time.perf_counter() - t0
                assert replies["victim"].get("ok") is True, replies["victim"]
                assert waited < 8.0, f"victim waited {waited:.1f}s"
                assert not any(k.startswith("noisy") for k in replies)
                broker.admission.release("noisy-blocker")
                assert _wait_for(lambda: len(replies) == 5, 20.0)
            assert len(replies) == 5, sorted(replies)
            assert all(m.get("ok") for m in replies.values())
        finally:
            for s in subs:
                s.unsubscribe()

    def test_served_front_door_backlog_bounds_and_expires(self, cluster):
        """A tenant's backlog past cap x 8 gets an immediate error; a
        backlogged request whose own timeout lapsed before a worker freed
        is dropped with an error and dispatches nothing. An unknown
        served tenant counts once."""
        bus, tracker, pems, kelvin, broker, _ = cluster
        pred = _predicted_bytes(broker, VICTIM_Q)
        broker.serve()
        replies: dict = {}
        subs = []
        executes = []
        subs.extend(bus.subscribe(f"agent.{p.agent_id}.execute",
                                  executes.append) for p in pems)

        def _ask(key, timeout_s):
            topic = f"client.fdtest.{key}"
            subs.append(bus.subscribe(
                topic, lambda m, _k=key: replies.setdefault(_k, m)))
            bus.publish("broker.execute", {
                "query": VICTIM_Q, "timeout_s": timeout_s,
                "tenant": "unknown-tenant-string", "_reply_to": topic,
            })

        unknown_c = port_obs.default_counter(
            "pixie_admission_unknown_tenant_total")
        before_unknown = unknown_c.value()
        try:
            with override_flag("broker_execute_threads", 1), \
                    override_flag("admission_tenant_weights", "x:1"), \
                    override_flag("admission_bytes_budget_mb",
                                  (pred * 2 * 1.2) / (1 << 20)), \
                    override_flag("admission_queue_s", 30.0):
                broker.admission.admit("blocker", _pred(pred))
                n_before = len(executes)
                _ask("head", 30.0)  # holds the one worker (parked)
                time.sleep(0.2)
                for i in range(8):  # fills the cap x 8 backlog
                    _ask(f"bl-{i}", 0.4)
                _ask("overflow", 30.0)  # past the bound: fails fast
                assert _wait_for(lambda: "overflow" in replies, 5.0)
                ov = replies["overflow"]
                assert ov["ok"] is False, ov
                assert "backlog full" in ov["error"], ov
                # Only the query that reached execute_script (head)
                # counted its unknown tenant.
                assert unknown_c.value() - before_unknown == 1
                time.sleep(0.5)  # the backlogged 0.4 s timeouts lapse
                broker.admission.release("blocker")
                assert _wait_for(lambda: len(replies) == 10, 20.0)
            assert len(replies) == 10, sorted(replies)
            assert replies["head"]["ok"] is True
            for i in range(8):
                r = replies[f"bl-{i}"]
                assert r["ok"] is False and "expired" in r["error"], r
            # Only the head dispatched agent work.
            assert len(executes) - n_before == len(pems), executes
        finally:
            for s in subs:
                s.unsubscribe()

    def test_cancel_query_returns_partial_cancelled(self, cluster):
        bus, tracker, pems, kelvin, broker, _ = cluster
        # Slow every PEM's window staging so the query is mid-flight.
        delay = {"s": 0.15}
        originals = []
        for p in pems:
            eng = p.engine
            orig = eng._staged_windows
            originals.append((eng, orig))

            def slow(stream, stats, cancel, _orig=orig):
                for w in _orig(stream, stats, cancel):
                    time.sleep(delay["s"])
                    yield w

            eng._staged_windows = slow
        out = {}

        def run():
            try:
                out["res"] = broker.execute_script(VICTIM_Q, timeout_s=30)
            except Exception as e:  # noqa: BLE001 - recorded for the assert
                out["err"] = e

        t = threading.Thread(target=run)
        t.start()
        try:
            qid = None
            deadline = time.time() + 5
            while time.time() < deadline and qid is None:
                qid = next((q.get("qid") for q in broker.tracer.in_flight()
                            if q.get("qid")), None)
                time.sleep(0.01)
            assert qid, "query never became visible in flight"
            assert broker.cancel_query(qid) is True
            t.join(10.0)
            assert not t.is_alive()
            res = out.get("res")
            assert res is not None, f"cancel errored: {out.get('err')}"
            assert res["partial"] is True
            assert res["interrupted"] == "cancelled"
            assert set(res["missing_reasons"].values()) == {"cancelled"}
        finally:
            delay["s"] = 0.0
            for eng, orig in originals:
                eng._staged_windows = orig
            t.join(10.0)
        assert broker.cancel_query("nonexistent") is False

    def test_cancel_mid_merge_stops_the_merge(self, cluster):
        """``query.cancel`` reaches a running merge fragment: the Kelvin
        registers its merge's cancel event under the qid, so the fold
        stops at a window boundary."""
        bus, tracker, pems, kelvin, broker, _ = cluster
        eng = kelvin.engine
        orig, wr = eng._staged_windows, eng.window_rows
        windows = {"n": 0}
        in_merge = threading.Event()

        def slow(stream, stats, cancel, _orig=orig):
            for w in _orig(stream, stats, cancel):
                windows["n"] += 1
                in_merge.set()
                time.sleep(0.15)
                yield w

        eng._staged_windows = slow
        eng.window_rows = 1
        out = {}

        def run(key):
            try:
                out[key] = broker.execute_script(VICTIM_Q, timeout_s=30)
            except Exception as e:  # noqa: BLE001 - recorded for the assert
                out[key + "_err"] = e

        # An uncancelled run: how many slowed windows a whole merge folds.
        t = threading.Thread(target=run, args=("full",))
        t.start()
        t.join(30.0)
        try:
            assert not t.is_alive() and "full" in out, out.get("full_err")
            full_windows = windows["n"]
            assert full_windows > 2, "merge never windowed; test moot"
            windows["n"] = 0
            in_merge.clear()
            t = threading.Thread(target=run, args=("cancelled",))
            t.start()
            assert in_merge.wait(15.0), "merge never started"
            qid = None
            deadline = time.time() + 5
            while time.time() < deadline and qid is None:
                qid = next((q.get("qid") for q in broker.tracer.in_flight()
                            if q.get("qid")), None)
                time.sleep(0.01)
            assert qid, "query never became visible in flight"
            assert broker.cancel_query(qid) is True
            t.join(10.0)
            assert not t.is_alive()
            # Time for a merge that ran on to fold its other windows.
            time.sleep(full_windows * 0.15 + 0.5)
            assert windows["n"] < full_windows, (
                f"merge folded all {windows['n']} windows after cancel")
            res = out.get("cancelled")
            assert res is not None, f"err: {out.get('cancelled_err')}"
            assert res["partial"] is True
            assert res["interrupted"] == "cancelled"
        finally:
            eng._staged_windows = orig
            eng.window_rows = wr
            t.join(10.0)


class TestLoadTesterKwargs:
    def test_tenancy_kwargs_forward_independently(self):
        def run(p):
            seen = []

            def execute(query, timeout_s, **kw):
                seen.append(dict(kw))

            p.load_tester.run_load(execute, "q", workers=1, per_worker=1,
                                   deadline_ms=500.0)
            assert seen and seen[0].get("deadline_ms") == 500.0
            assert "tenant" not in seen[0]
            p.load_tester.run_load(execute, "q", workers=1, per_worker=1,
                                   tenant="a", priority=3)
            assert seen[1] == {"tenant": "a", "priority": 3}
            return seen

        got = _both(run)
        assert got["port"] == got["jax"]

    def test_mixed_load_streams_sharing_tenant_stay_separate(self):
        def run(p):
            lt = p.load_tester

            def execute(query, timeout_s, **kw):
                pass

            reports = lt.run_mixed_load(execute, [
                lt.TenantStream(tenant="dash", query="q", workers=1,
                                per_worker=1, priority=5),
                lt.TenantStream(tenant="dash", query="q", workers=1,
                                per_worker=2, priority=0),
            ])
            assert set(reports) == {"dash", "dash#1"}
            assert reports["dash"].queries == 1
            assert reports["dash#1"].queries == 2
            return {k: r.queries for k, r in reports.items()}

        got = _both(run)
        assert got["port"] == got["jax"]


@pytest.fixture(scope="class")
def gate_cluster():
    bus, tracker, pems, kelvin, broker, data = _mk_cluster(
        n_pems=2, rows=8000, noise_rows=300)
    yield bus, tracker, pems, kelvin, broker
    _close_cluster(bus, tracker, pems, kelvin, broker)


@pytest.mark.slow
class TestP99Isolation:
    """The isolation gate, ``slow`` as its JAX counterpart is: with
    tenant ``noisy`` saturating its share and ``victim`` at its solo
    rate, the victim's p99 moves at most 25% from its solo baseline
    (bracketed before and after) and it sheds nothing, while the noisy
    tenant's own p99 rises."""

    def test_noisy_tenant_does_not_move_victim_p99(self, gate_cluster):
        import gc

        from pixie_tpu_torch.services.load_tester import (
            TenantStream, broker_executor, run_load, run_mixed_load,
        )

        bus, tracker, pems, kelvin, broker = gate_cluster
        execute = broker_executor(broker)
        pred_v = _predicted_bytes(broker, VICTIM_Q)
        pred_n = _predicted_bytes(broker, NOISY_CHEAP_Q)
        weight_v = (8.0 * pred_v) / (1.5 * pred_n)
        budget_mb = 1.5 * pred_n * (weight_v + 2.0) / (1 << 20)
        weights = f"victim:{weight_v:.6f},noisy:1"

        def solo_victim():
            r = run_load(execute, VICTIM_Q, workers=1, per_worker=200,
                         tenant="victim", priority=5)
            assert r.errors == 0 and r.sheds == 0
            return r

        def measure():
            with override_flag("admission_tenant_weights", weights), \
                    override_flag("admission_bytes_budget_mb", budget_mb), \
                    override_flag("admission_queue_s", 60.0), \
                    override_flag("admission_priority_holddown_ms", 150.0):
                solo_n = run_load(execute, NOISY_CHEAP_Q, workers=1,
                                  per_worker=10, tenant="noisy")
                solo_before = solo_victim()
                queued = port_obs.default_counter(
                    "pixie_admission_queued_total").labels(tenant="noisy")
                queued_before = queued.value()
                mixed = run_mixed_load(execute, [
                    TenantStream(tenant="victim", query=VICTIM_Q, workers=1,
                                 per_worker=200, priority=5),
                    TenantStream(tenant="noisy", query=NOISY_CHEAP_Q,
                                 workers=8, per_worker=8, priority=0),
                ])
                queued_after = queued.value()
                solo_after = solo_victim()
            return (solo_n, solo_before, mixed, solo_after,
                    queued_before, queued_after)

        gc.collect()
        gc.disable()
        try:
            for attempt in (1, 2):
                (solo_n, solo_before, mixed, solo_after,
                 queued_before, queued_after) = measure()
                ok = (mixed["victim"].percentile(99)
                      <= 1.25 * max(solo_before.percentile(99),
                                    solo_after.percentile(99)))
                if ok or attempt == 2:
                    break
        finally:
            gc.enable()
        victim, noisy = mixed["victim"], mixed["noisy"]
        assert victim.errors == 0, victim.to_dict()
        assert victim.sheds == 0
        p99_solo = max(solo_before.percentile(99), solo_after.percentile(99))
        assert victim.percentile(99) <= 1.25 * p99_solo, (
            victim.to_dict(), noisy.to_dict())
        assert queued_after > queued_before
        assert noisy.queries == 64
        assert noisy.errors == 0 and noisy.sheds == 0, noisy.to_dict()
        assert noisy.percentile(99) >= 1.5 * solo_n.percentile(99)

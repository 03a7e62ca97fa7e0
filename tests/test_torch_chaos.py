"""The chaos soak on the port (``services/chaos.py``) against the JAX
package's.

The JAX ``tests/test_chaos.py`` classes on the port: the ledger, the
failover-retrying executor and the report's gates (each also held to the
JAX module's verdicts on the same inputs), then the soak itself at the
JAX sizes with every agent's engine on the CPU: 8 agents and 2 brokers
with a leader kill, and 6 agents without one. The 32-agent gate is the
one case the JAX file marks slow, and it is marked slow here too.
Without a card and without ``--device cpu`` the CLI exits 1 before it
builds anything.
"""

from __future__ import annotations

import threading

import pytest

import pixie_tpu.services.chaos as jax_chaos
from pixie_tpu.services.msgbus import BusTimeout as JaxBusTimeout
from pixie_tpu_torch.services import chaos
from pixie_tpu_torch.services.chaos import (
    ChaosReport,
    _Ledger,
    failover_executor,
    run_chaos_soak,
)
from pixie_tpu_torch.services.msgbus import BusTimeout

MODS = {"port": (chaos, BusTimeout), "jax": (jax_chaos, JaxBusTimeout)}


class _Bus:
    def __init__(self, script):
        self.script = list(script)
        self.calls = 0

    def request(self, topic, msg, timeout_s=10.0):
        self.calls += 1
        step = self.script.pop(0)
        if isinstance(step, Exception):
            raise step
        return step


def test_queries_equal_jax():
    assert chaos.VICTIM_QUERY == jax_chaos.VICTIM_QUERY
    assert chaos.NOISY_QUERY == jax_chaos.NOISY_QUERY
    assert chaos._REFUSALS == jax_chaos._REFUSALS


class TestLedger:
    def test_records_outcomes_and_lost_details(self):
        led = _Ledger()
        led.record("ok")
        led.record("partial")
        led.record("lost", "AgentLost: merge agent vanished" + "x" * 400)
        snap = led.snapshot()
        assert snap["submitted"] == 3
        assert snap["outcomes"] == {"ok": 1, "partial": 1, "lost": 1}
        assert len(snap["lost"]) == 1 and len(snap["lost"][0]) <= 200

    def test_thread_safe_under_concurrent_records(self):
        led = _Ledger()
        ts = [threading.Thread(
            target=lambda: [led.record("ok") for _ in range(200)])
            for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert led.snapshot()["submitted"] == 800


def _executor_outcome(name: str, script: list, **kw) -> dict:
    """Drive one executor of package ``name`` through a scripted bus:
    its result or exception type, the ledger and the bus calls."""
    mod, timeout_cls = MODS[name]
    steps = [timeout_cls(s.args[0]) if isinstance(s, BusTimeout) else s
             for s in script]
    led = mod._Ledger()
    bus = _Bus(steps)
    ex = mod.failover_executor(bus, led, backoff_s=0.01, **kw)
    try:
        out = ex("import px", 5.0)
    except Exception as e:
        out = type(e).__name__
    return {"out": out, "ledger": led.snapshot(), "calls": bus.calls}


EXECUTOR_CASES = {
    "retries_through_failover_window": ([
        BusTimeout("no responder on 'broker.execute'"),
        BusTimeout("no responder on 'broker.execute'"),
        {"ok": True, "partial": False, "tables": {}}], {}),
    "exhausted_retries_are_lost": ([BusTimeout("down")] * 3,
                                   {"max_attempts": 3}),
    "structured_refusal_is_not_lost": ([
        {"ok": False, "error": "AdmissionError: admission-shed "
                               "(queue past deadline)"}], {}),
    "real_error_is_lost": ([
        {"ok": False, "error": "AgentLost: kelvin-0 un-acked"}], {}),
    "partial_counts_as_partial": ([
        {"ok": True, "partial": True, "tables": {}}], {}),
}


class TestFailoverExecutor:
    @pytest.mark.parametrize("case", sorted(EXECUTOR_CASES))
    def test_executor_equals_jax(self, case):
        script, kw = EXECUTOR_CASES[case]
        port = _executor_outcome("port", script, **kw)
        jax = _executor_outcome("jax", script, **kw)
        if port["out"] == "BusTimeout":
            port["ledger"]["lost"] = [
                m.split(":")[0] for m in port["ledger"]["lost"]]
            jax["ledger"]["lost"] = [
                m.split(":")[0] for m in jax["ledger"]["lost"]]
        assert port == jax

    def test_retries_through_failover_window(self):
        led = _Ledger()
        bus = _Bus([BusTimeout("no responder"), BusTimeout("no responder"),
                    {"ok": True, "partial": False, "tables": {}}])
        res = failover_executor(bus, led, backoff_s=0.01)("import px", 5.0)
        assert res["ok"] and bus.calls == 3
        snap = led.snapshot()
        assert snap["failover_retries"] == 2
        assert snap["outcomes"] == {"ok": 1} and snap["lost"] == []

    def test_exhausted_retries_are_lost(self):
        led = _Ledger()
        bus = _Bus([BusTimeout("down")] * 3)
        ex = failover_executor(bus, led, max_attempts=3, backoff_s=0.01)
        with pytest.raises(BusTimeout):
            ex("import px", 5.0)
        snap = led.snapshot()
        assert snap["outcomes"] == {"lost": 1}
        assert "no broker answered" in snap["lost"][0]

    def test_structured_refusal_is_not_lost(self):
        led = _Ledger()
        bus = _Bus([{"ok": False, "error": "AdmissionError: admission-shed"}])
        with pytest.raises(RuntimeError):
            failover_executor(bus, led)("import px", 5.0)
        assert led.snapshot()["outcomes"] == {"refused": 1}

    def test_real_error_is_lost(self):
        led = _Ledger()
        bus = _Bus([{"ok": False, "error": "AgentLost: kelvin-0 un-acked"}])
        with pytest.raises(RuntimeError):
            failover_executor(bus, led)("import px", 5.0)
        snap = led.snapshot()
        assert snap["outcomes"] == {"lost": 1}
        assert "AgentLost" in snap["lost"][0]

    def test_partial_counts_as_partial(self):
        led = _Ledger()
        bus = _Bus([{"ok": True, "partial": True, "tables": {}}])
        assert failover_executor(bus, led)("import px", 5.0)["partial"]
        assert led.snapshot()["outcomes"] == {"partial": 1}


class TestChaosReport:
    @pytest.mark.parametrize("kw", [
        {"leader_kills": 1, "failovers": 1}, {"lost": ["x"]},
        {"thread_leak": True}, {"isolation_ok": False},
        {"leader_kills": 1, "failovers": 0},
        {"leader_kills": 1, "failovers": 1, "wall_s": 1.234,
         "baseline_p99_ms": 12.345678, "victim_p99_ms": 1.005},
    ])
    def test_report_equals_jax(self, kw):
        port, jax = ChaosReport(**kw), jax_chaos.ChaosReport(**kw)
        assert port.ok == jax.ok
        assert port.to_dict() == jax.to_dict()

    def test_ok_requires_all_gates(self):
        assert ChaosReport(leader_kills=1, failovers=1).ok
        assert ChaosReport(lost=["x"]).ok is False
        assert ChaosReport(thread_leak=True).ok is False
        assert ChaosReport(isolation_ok=False).ok is False
        assert ChaosReport(leader_kills=1, failovers=0).ok is False

    def test_to_dict_round_trips_gates(self):
        d = ChaosReport(leader_kills=1, failovers=1, wall_s=1.234).to_dict()
        assert d["ok"] is True and d["wall_s"] == 1.23
        for key in ("ledger", "lost", "faults_fired", "streams",
                    "victim_p99_ms", "victim_p99_bound_ms"):
            assert key in d


class TestSmallSoak:
    def test_eight_agent_soak_holds_the_contract(self):
        """Faults, tenancy and a leader kill on 8 agents and 2 brokers,
        every engine on the CPU: zero lost, zero leaked threads, the
        failover observed, the isolation bound held."""
        report = run_chaos_soak(n_agents=8, n_brokers=2, seed=0, rows=200,
                                per_worker=2, noisy_workers=1,
                                timeout_s=20.0, device="cpu")
        d = report.to_dict()
        assert report.lost == [], d
        assert not report.thread_leak, d
        assert report.leader_kills == 1 and report.failovers >= 1, d
        assert report.isolation_ok, d
        assert report.agent_kills == 1 and report.partitions_healed == 1, d
        assert report.ledger["submitted"] > 0
        assert sum(report.ledger["outcomes"].values()) == \
            report.ledger["submitted"]
        assert report.faults_fired > 0
        assert sorted(d["streams"]) == ["batch", "dash"]

    def test_soak_without_leader_kill(self):
        report = run_chaos_soak(n_agents=6, n_brokers=2, seed=1, rows=200,
                                per_worker=2, noisy_workers=1,
                                kill_leader=False, device="cpu")
        assert report.leader_kills == 0
        assert report.ok, report.to_dict()


def test_main_without_a_card_exits_non_zero(monkeypatch, capsys):
    import torch

    monkeypatch.delenv("PIXIE_TPU_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = threading.active_count()
    assert chaos.main(["--agents", "4"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert threading.active_count() == before
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_chaos_soak(n_agents=4)


@pytest.mark.slow
class TestSoakGate:
    def test_thirty_two_agent_soak(self):
        report = run_chaos_soak(n_agents=32, n_brokers=2, seed=0,
                                device="cpu")
        assert report.ok, report.to_dict()
